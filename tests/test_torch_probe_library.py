"""The probes' PyTorch yardsticks (``Probe.library``) and P5's window
kernel (``p1``, ``p2``: ``csrc/dcn_probes.cu:row_window_kernel``).

A yardstick is one PyTorch call that computes its probe's function; the
card times it beside the kernel (``chip_smoke.py`` phase 15). Each one is
held here against its probe's plain version (``ops/probes.py``, itself held
against the scripts' Pallas kernels in ``tests/test_torch_probes.py``) on
every input of ``tools/probe_dcn.py``: ``k2`` at both geometries on the
script's input and the two seeded draws, bitwise (one copy of dy);
``p1`` on its three inputs and at every legal start of a (24, 32, 128) and
a (24, 32, 127) x, bitwise (one copy); ``p2`` on its three inputs within
1e-6 of the largest magnitude (one ``sum`` over the windows, in its own
order, where the plain version adds them one by one).

The wrapper picks the window kernel's vector width (``probes.row_windows``):
float4 where every window row of x and of the output starts on 16 bytes
and holds whole float4s, else float. The CPU cases cover that choice; the
``cuda`` cases hold the kernel bitwise (as int32 bits) against its plain
version on the card for ``p1`` at every legal start of both shapes and on
an x that starts off 16 bytes, and ``p2`` on [2, 6), [0, 25) and [5, 5) at
widths 128 and 127.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import probes
from centerfusiondetect3d_tpu_torch.ops.probes import GEOMETRIES, PROBES
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

SEED = 0
P2_RTOL = 1e-6  # p2's yardstick sums its windows in another order
P1_SHAPES = [(24, 32, 128), (24, 32, 127)]
P2_RANGES = [(2, 6), (0, 25), (5, 5)]


def _legal_starts(shape):
    """Every g whose p1 window x[g:g+8, g+1:g+17] lies inside x."""
    return range(min(shape[0] - probes.P5_ROWS,
                     shape[1] - 1 - probes.P5_COLS) + 1)


P1_CASES = [(s, g) for s in P1_SHAPES for g in _legal_starts(s)]


def _seeded(shape, seed, device="cpu"):
    """N(0, 1) float32 with every 7th element -0.0 (a copy keeps its sign,
    a sum from zero does not)."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).to(device)
    x.view(-1)[::7] = -0.0
    return x


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_the_probes_with_one_pytorch_call_have_a_yardstick():
    assert [n for n, p in PROBES.items() if p.library is not None] == [
        "k2", "p1", "p2", "p4"]


@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=["script", "second"])
def test_k2_yardstick_is_its_plain_version_bitwise(geom, case):
    probe = PROBES["k2"]
    inp = probe_dcn.tile_inputs(probe.script, geom, case, SEED, "cpu")
    args = [inp[k] for k in probe.kernel.inputs]
    got = probe.library(*args, geom)
    assert got.is_contiguous()
    assert torch.equal(_bits(got), _bits(probe.plain(*args, geom)))


@pytest.mark.parametrize("index", range(3))
@pytest.mark.parametrize("name", ["p1", "p2"])
def test_p5_yardstick_matches_plain_on_the_tool_inputs(name, index):
    probe = PROBES[name]
    label, args, _ = probe_dcn.p5_cases(name, SEED, "cpu")[index]
    got, want = probe.library(*args), probe.plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    if name == "p1":
        assert torch.equal(_bits(got), _bits(want)), label
    else:
        _, rel = probe_dcn.relative(got, want)
        assert rel <= P2_RTOL, (label, rel)


@pytest.mark.parametrize("shape", P1_SHAPES, ids=str)
def test_p1_yardstick_is_a_bitwise_copy_at_every_start(shape):
    x = _seeded(shape, SEED)
    for g in _legal_starts(shape):
        got = PROBES["p1"].library(x, g)
        assert torch.equal(_bits(got), _bits(probes.probe_p1_plain(x, g))), g


@pytest.mark.parametrize("lo,hi", P2_RANGES)
@pytest.mark.parametrize("width", [128, 127])
def test_p2_yardstick_matches_plain_on_seeded_rows(width, lo, hi):
    x = _seeded((32, width), SEED + lo)
    got = PROBES["p2"].library(x, lo, hi)
    want = probes.probe_p2_plain(x, lo, hi)
    _, rel = probe_dcn.relative(got, want)
    assert rel <= P2_RTOL
    if hi == lo:
        assert torch.equal(_bits(got), _bits(want))  # +0.0 everywhere


@pytest.mark.parametrize("shape,g", P1_CASES)
def test_p1_windows_take_float4_where_every_row_is_aligned(shape, g):
    """(24, 32, 128): every window row starts on 16 bytes. (24, 32, 127):
    only where (g + 1) * 127 is a multiple of 4 (g = 3, 7, 11, 15)."""
    x = torch.zeros(shape)
    out = torch.empty((probes.P5_ROWS, probes.P5_COLS, shape[2]))
    col0 = (g + 1) * shape[2]
    args = probes.row_windows(x, out, col0, g, g + 1)
    vec = 4 if shape[2] % 4 == 0 or (g + 1) % 4 == 0 else 1
    assert args == (shape[1] * shape[2], col0, probes.P5_COLS * shape[2],
                    probes.P5_ROWS, g, g + 1, vec)


def test_windows_of_an_x_off_16_bytes_take_floats():
    flat = torch.zeros(4 + 24 * 32 * 128)
    x = flat[1:1 + 24 * 32 * 128].view(24, 32, 128)
    out = torch.empty((probes.P5_ROWS, probes.P5_COLS, 128))
    assert probes.row_windows(x, out, 4 * 128, 3, 4)[-1] == 1
    aligned = flat[4:].view(24, 32, 128)
    assert probes.row_windows(aligned, out, 4 * 128, 3, 4)[-1] == 4


@pytest.mark.parametrize("width,vec", [(128, 4), (127, 1), (4, 4), (6, 1)])
def test_p2_windows_take_float4_where_the_rows_hold_whole_float4s(width,
                                                                  vec):
    x = torch.zeros((32, width))
    out = torch.empty((probes.P5_ROWS, width))
    assert probes.row_windows(x, out, 0, 0, 25) == (
        width, 0, width, probes.P5_ROWS, 0, 25, vec)


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,g", P1_CASES)
def test_p1_kernel_is_bitwise_its_plain_version_on_card(shape, g):
    dev = _card()
    x = _seeded(shape, SEED + g, dev)
    before = probes.probe_p1.launches
    got = probes.probe_p1(x, g)
    torch.cuda.synchronize()
    assert probes.probe_p1.launches == before + 1
    assert torch.equal(_bits(got), _bits(probes.probe_p1_plain(x, g)))


@pytest.mark.cuda
def test_p1_kernel_on_an_x_off_16_bytes_on_card():
    dev = _card()
    flat = _seeded((1 + 24 * 32 * 128,), SEED, dev)
    x = flat[1:].view(24, 32, 128)
    for g in _legal_starts(x.shape):
        got = probes.probe_p1(x, g)
        assert torch.equal(_bits(got), _bits(probes.probe_p1_plain(x, g))), g


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", P2_RANGES)
@pytest.mark.parametrize("width", [128, 127])
def test_p2_kernel_is_bitwise_its_plain_version_on_card(width, lo, hi):
    dev = _card()
    x = _seeded((32, width), SEED + lo, dev)
    before = probes.probe_p2.launches
    got = probes.probe_p2(x, lo, hi)
    torch.cuda.synchronize()
    assert probes.probe_p2.launches == before + 1
    assert torch.equal(_bits(got), _bits(probes.probe_p2_plain(x, lo, hi)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1", "p2"])
def test_p5_yardstick_matches_plain_on_card(name):
    dev = _card()
    probe = PROBES[name]
    for label, args, _ in probe_dcn.p5_cases(name, SEED, dev):
        _, rel = probe_dcn.relative(probe.library(*args), probe.plain(*args))
        assert rel <= (0.0 if name == "p1" else P2_RTOL), label
