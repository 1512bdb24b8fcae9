"""The redesigned ``kf``/``kg`` and ``p4`` probe kernels (``csrc/
dcn_probes.cu``: ``hat_cols_kernel``, the all-channel hat sampler, and
``contract_kernel``, p4's tensor-core contraction) at the edges of their
designs.

On the CPU the plain versions ``probe_kf_plain`` and ``probe_kg_plain`` are
held against the scripts' ``kf`` and ``kg`` run in interpret mode (the
loader of ``tests/test_torch_probes.py``) at ``probes.RAGGED_GEOMETRY`` (BR,
W, C, O = 5, 9, 24, 6: 45 pixels a tile, three 8-channel vectors a pixel)
on the three inputs of ``tools/probe_dcn.py``. ``scripts/probe_mosaic.py``
fixes ``p4``'s shapes, which ``tests/test_torch_probes.py`` already covers,
so ``probe_p4_plain`` is held at ragged K and N against a float64 numpy
product of the same bf16 tap. The wrappers' choice of channels a thread
(``kf_width``: 2 or 1) is checked over C and skew, with the width they hand
the C entries, each probe's ``Probe.device`` is the one ``__global__``
function that its C entry launches (read from the source), and the
comparison tool takes the three kernels.

The ``cuda`` cases hold both kernels against their plain versions on the
card: ``kf`` and ``kg`` on every input at the two geometries of the probe
path and the ragged one, on an x off 16 bytes (one channel a load where it
is off 4 bytes), at C that holds no whole float4, and on an x that holds
inf where a hat weight is zero (NaN where the plain version has it: 0 *
inf); ``p4`` on the probe path's inputs and at ragged K and N, also on an x
off 16 bytes (2-byte loads); repeats bitwise equal; the ``kf`` entry's
refusal of a width the tensors do not allow, or of an out off 8 bytes; and
``p4``'s yardstick (``Probe.library``, one ``torch.baddbmm``) against its
plain version.

Tolerances, relative to the plain result's largest magnitude: ``SUMS``
(1e-5) for both kernels and the yardstick. ``kf`` sums every term of the
box with the plain version's rounding, but in four runs of rows whose sums
it adds in one fixed order; ``p4``'s products of two
bf16 values are exact in float32 and only the order of its sums differs.
The numpy product is float64 over the same bf16 tap, so the float32 plain
sum is within ``SUMS`` of it too.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_probes import OPERANDS, SEED, _geom_id, _jax_tile, _jnp, _rel

from centerfusiondetect3d_tpu_torch.ops import probes
from centerfusiondetect3d_tpu_torch.ops.probes import (
    GEOMETRIES,
    PROBES,
    RAGGED_GEOMETRY,
    RAGGED_P4,
    SUMS,
)
from centerfusiondetect3d_tpu_torch.tools import compare_kernels as ck
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

ALL_GEOMETRIES = GEOMETRIES + (RAGGED_GEOMETRY,)
# (K, N) of p4 beyond the script's (64, 128): RAGGED_P4; K off 8 (2-byte x
# loads) with N below one 8-column tile; K one 16-deep step with N odd
P4_SHAPES = [RAGGED_P4, (20, 5), (16, 33), (64, 128)]


def _inputs(name, geom, case, device="cpu"):
    probe = PROBES[name]
    inp = probe_dcn.tile_inputs(probe.script, geom, case, SEED, device)
    return [inp[k] for k in probe.kernel.inputs]


def _offset_view(shape, dtype, elements: int, device="cpu"):
    """A contiguous tensor of ``shape`` that starts ``elements`` past a
    16-byte boundary."""
    flat = torch.zeros(elements + int(np.prod(shape)), dtype=dtype,
                       device=device)
    return flat[elements:].view(shape)


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("name", ["kf", "kg"])
def test_plain_matches_jax_interpret_at_the_ragged_geometry(name, case):
    probe, geom = PROBES[name], RAGGED_GEOMETRY
    call, script_result = _jax_tile(name, geom)
    inputs = probe_dcn.tile_inputs(probe.script, geom, case, SEED, "cpu")
    if case == "script":
        want = script_result[0]  # P3's call() returns (out, oracle)
    else:
        order = OPERANDS[probe.script]
        want = call["fn"](*[_jnp(inputs[k]) for k in order])
    got = probe.plain(*[inputs[k] for k in probe.kernel.inputs], geom)
    assert got.shape == (2, geom.h, geom.w, geom.c)
    assert _rel(got.numpy(), want) <= probe.rtol


@pytest.mark.parametrize("k,n", P4_SHAPES, ids=str)
def test_p4_plain_is_the_float64_product_of_its_tap(k, n):
    x, w = probe_dcn.ragged_p4_inputs(SEED, "cpu", (k, n))
    r0, c0 = probes.P4_ROW0, probes.P4_COL0
    win = x[r0:r0 + probes.P5_ROWS, c0:c0 + probes.P5_COLS]
    tap = (win.float() * 2.0).bfloat16().double().numpy()  # exact: x 2
    want = tap.reshape(-1, k) @ w.double().numpy()
    got = probes.probe_p4_plain(x, w)
    assert got.shape == (probes.P5_ROWS, probes.P5_COLS, n)
    assert got.dtype == torch.float32
    assert _rel(got.reshape(-1, n).numpy(), want) <= SUMS


@pytest.mark.parametrize("c,skew,vec", [
    (16, 0, 2), (8, 0, 2), (24, 0, 2), (6, 0, 2), (2, 0, 2), (5, 0, 1),
    (16, 1, 1), (16, 2, 2), (12, 4, 2), (24, 3, 1), (7, 2, 1),
])
def test_kf_takes_two_channels_where_c_and_x_allow_it(c, skew, vec):
    x = _offset_view((2, 36, 44, c), torch.bfloat16, skew)
    assert probes.kf_width(x) == vec


# kf's channels a thread at each geometry on 16 bytes (C = 16, 8, 24), one
# element (2 bytes) off and two (4 bytes) off
KF_WIDTHS = {0: 2, 1: 1, 2: 2}


@pytest.mark.parametrize("skew", sorted(KF_WIDTHS))
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_the_wrappers_hand_the_entries_their_width(geom, skew):
    g = geom
    x = _offset_view((g.batch, g.hp, g.wp, g.c), torch.bfloat16, skew)
    out = torch.empty((g.batch, g.h, g.w, g.c))
    assert probes._kf_args({"x": x}, out) == (KF_WIDTHS[skew],)
    for name in ("kf", "kg"):
        assert probes._SIGNATURES[f"cfd_probe_{name}"] == (
            probes._TILE_ARGS + [probes.ctypes.c_int])


def test_wrappers_run_plain_on_cpu_at_the_ragged_shapes():
    before = probes.launch_counts()
    for name in ("kf", "kg"):
        probe = PROBES[name]
        for case in probe_dcn.CASES:
            args = _inputs(name, RAGGED_GEOMETRY, case)
            assert torch.equal(probe.kernel(*args, geom=RAGGED_GEOMETRY),
                               probe.plain(*args, RAGGED_GEOMETRY))
    args = probe_dcn.ragged_p4_inputs(SEED, "cpu")
    assert [tuple(a.shape) for a in args] == [(16, 32, RAGGED_P4[0]),
                                              RAGGED_P4]
    assert torch.equal(probes.probe_p4(*args), probes.probe_p4_plain(*args))
    assert probes.launch_counts() == before


def test_kf_and_kg_share_the_new_device_function():
    assert PROBES["kf"].device == "hat_cols_kernel"
    assert PROBES["kg"].device == "hat_cols_kernel"
    assert PROBES["p4"].device == "contract_kernel"
    assert PROBES["kf"].library is None and PROBES["kg"].library is None
    assert PROBES["p4"].library is probes.probe_p4_library


_SOURCE = (Path(probes.__file__).resolve().parent.parent / "csrc"
           / probes.SOURCE).read_text()


def _braced(text: str, start: int) -> str:
    """The text of the braces that open first at or after ``start``."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise ValueError("unbalanced braces")


def _entry_body(name: str) -> str:
    """The body of ``cfd_probe_<name>``: written out, or a ``TILE_PROBE`` /
    ``COLS_PROBE`` macro's use (the latter's body is in its definition)."""
    m = re.search(rf"\bcfd_probe_{name}\(", _SOURCE)
    if m:
        return _braced(_SOURCE, m.end())
    m = re.search(rf"^TILE_PROBE\({name}\)", _SOURCE, re.M)
    if m:
        return _braced(_SOURCE, m.end())
    assert re.search(rf"^COLS_PROBE\({name}\)", _SOURCE, re.M), name
    m = re.search(r"#define COLS_PROBE\(name\)", _SOURCE)
    return _braced(_SOURCE, m.end())


def _launched_kernels(body: str, seen=()) -> set:
    """The ``__global__`` functions that ``body`` launches (``<<<``), also
    through the ``launch_*`` helpers it calls."""
    kernels = set(re.findall(r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<", body))
    for helper in set(re.findall(r"\b(launch_\w+)\s*(?:<[^;(]*>)?\(",
                                 body)) - {"launched"} - set(seen):
        m = re.search(rf"^int {helper}\(", _SOURCE, re.M)
        assert m, helper
        kernels |= _launched_kernels(_braced(_SOURCE, m.end()),
                                     (*seen, helper))
    return kernels


@pytest.mark.parametrize("name", sorted(PROBES))
def test_each_entry_launches_the_device_function_its_probe_names(name):
    """``Probe.device`` (the smoke's ``device_function``) is the one
    ``__global__`` function that the probe's C entry reaches."""
    assert _launched_kernels(_entry_body(name)) == {PROBES[name].device}


@pytest.mark.parametrize("name", ["probe_kf", "probe_kg", "probe_p4"])
def test_the_redesigned_probes_are_kernels_of_the_tool(name):
    """The parser takes them (the refusal is the directory's, not the
    kernel's), and their calls on the tool's inputs run the plain versions
    on the CPU; ``p4`` gets P5's inputs with its yardstick beside it."""
    assert name in ck.PROBE_KERNELS
    with pytest.raises(SystemExit, match="inside"):
        ck.main(["--other", ck.ROOT, "--kernel", name])
    short = name[len("probe_"):]
    probe = PROBES[short]
    calls = ck.probe_calls(name, probes, "cpu")
    if short == "p4":
        cases = probe_dcn.p5_cases("p4", ck.SEED, "cpu")
        assert [c[0] for c in calls] == [c[0] for c in cases]
        for (label, this, other, library), (_, args, _) in zip(calls, cases):
            assert library is not None, label
            assert torch.equal(this(), probe.plain(*args)), label
            assert torch.equal(other(), probe.plain(*args)), label
        return
    cases = [(g, c) for g in GEOMETRIES for c in probe_dcn.CASES]
    for (label, this, other, library), (geom, case) in zip(calls, cases,
                                                           strict=True):
        assert label == probe_dcn.tile_label(case, geom)
        assert library is None, label
        want = probe.plain(*_inputs(short, geom, case), geom)
        assert torch.equal(this(), want), label
        assert torch.equal(other(), want), label


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold(got, want, rtol: float = SUMS):
    _, rel = probe_dcn.relative(got, want)
    assert rel <= rtol, rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", ["kf", "kg"])
def test_kf_kernel_matches_plain_on_card(name, geom, case):
    dev = _card()
    probe = PROBES[name]
    args = _inputs(name, geom, case, dev)
    before = probe.kernel.launches
    got = probe.kernel(*args, geom=geom)
    torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    _hold(got, probe.plain(*args, geom), probe.rtol)
    assert torch.equal(probe.kernel(*args, geom=geom), got)  # repeats


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [1, 2, 4])
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_kf_kernel_on_an_x_off_16_bytes_on_card(geom, skew):
    dev = _card()
    x, off = _inputs("kf", geom, "wide", dev)
    skewed = _offset_view(x.shape, x.dtype, skew, dev)
    skewed.copy_(x)
    assert probes.kf_width(skewed) == (1 if skew == 1 else 2)
    got = probes.probe_kf(skewed, off, geom=geom)
    _hold(got, probes.probe_kf_plain(x, off, geom))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 5, 2])
def test_kf_kernel_where_c_holds_no_whole_float4_on_card(c):
    """C = 6 (2 channels a thread, float2 stores), 5 (one a thread, float
    stores), 2 (one pair a pixel)."""
    dev = _card()
    geom = probes.Geometry(br=3, w=7, c=c, o=4)
    for case in probe_dcn.CASES:
        x, off = _inputs("kf", geom, case, dev)
        assert probes.kf_width(x) == (2 if c % 2 == 0 else 1)
        got = probes.probe_kf(x, off, geom=geom)
        _hold(got, probes.probe_kf_plain(x, off, geom))
        assert torch.equal(probes.probe_kf(x, off, geom=geom), got)


def _inf_where_a_weight_is_zero(x, off, geom):
    """x with inf in channel 1 at a place that pixel (0, 0) of tile (0, 0)
    reads at a (gy, gx) of its tile's box whose hat weight is zero."""
    ylo, yhi, xlo, xhi = (int(t[0, 0]) for t in probes.tile_bounds(off,
                                                                   geom))
    dy = float(off[0, 4, 0, 0].clamp(-probes.CLIP, probes.CLIP))
    gy = next(g for g in range(ylo, yhi + 1) if abs(g - dy) >= 1)
    x = x.clone()
    x[0, gy + geom.pad, xlo + geom.pad, 1] = float("inf")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_kf_kernel_gives_nan_where_plain_does_on_card(geom):
    dev = _card()
    x, off = _inputs("kf", geom, "narrow", dev)
    x = _inf_where_a_weight_is_zero(x, off, geom)
    want = probes.probe_kf_plain(x, off, geom)
    assert bool(torch.isnan(want[0, 0, 0, 1]))  # 0 * inf
    got = probes.probe_kf(x, off, geom=geom)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    _hold(got[fin], want[fin])


@pytest.mark.cuda
def test_the_kf_entry_refuses_a_width_the_tensors_do_not_allow():
    dev = _card()
    g = RAGGED_GEOMETRY  # C = 24: 2 a thread allowed, 4 and 8 no kernel
    x, off = _inputs("kf", g, "narrow", dev)
    out = torch.empty((g.batch, g.h, g.w, g.c), device=dev)
    tile = (out.data_ptr(), g.batch, g.n_rb, g.br, g.w, g.c, g.o, g.pad)
    skewed = _offset_view(x.shape, x.dtype, 1, dev)
    for ptr, vec in ((x.data_ptr(), 4), (x.data_ptr(), 8),
                     (x.data_ptr(), 3), (skewed.data_ptr(), 2)):
        for name in ("kf", "kg"):
            with pytest.raises(RuntimeError, match="CUDA error"):
                probes._run(out, f"cfd_probe_{name}", ptr, off.data_ptr(),
                            None, None, *tile, vec)
    # float2 stores: an out off 8 bytes (one float past 16) is refused
    out_skewed = _offset_view(out.shape, out.dtype, 1, dev)
    for name in ("kf", "kg"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            probes._run(out, f"cfd_probe_{name}", x.data_ptr(),
                        off.data_ptr(), None, None, out_skewed.data_ptr(),
                        *tile[1:], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(2))
def test_p4_kernel_matches_plain_on_the_tool_inputs_on_card(index):
    dev = _card()
    _, args, expected = probe_dcn.p5_cases("p4", SEED, dev)[index]
    before = probes.probe_p4.launches
    got = probes.probe_p4(*args)
    torch.cuda.synchronize()
    assert probes.probe_p4.launches == before + 1
    _hold(got, probes.probe_p4_plain(*args))
    if expected is not None:
        assert torch.equal(got, expected)  # 128: exact sums of 2s
    assert torch.equal(probes.probe_p4(*args), got)  # repeats


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("k,n", P4_SHAPES, ids=str)
def test_p4_kernel_at_ragged_k_and_n_on_card(k, n, skew):
    """Padding of K to 16 and masks of N; an x or w one element off 16
    bytes takes 2-byte loads."""
    dev = _card()
    x, w = probe_dcn.ragged_p4_inputs(SEED, dev, (k, n))
    want = probes.probe_p4_plain(x, w)
    if skew:
        xs = _offset_view(x.shape, x.dtype, 1, dev)
        ws = _offset_view(w.shape, w.dtype, 1, dev)
        xs.copy_(x)
        ws.copy_(w)
        x, w = xs, ws
    got = probes.probe_p4(x, w)
    _hold(got, want)
    assert torch.equal(probes.probe_p4(x, w), got)


@pytest.mark.cuda
def test_p4_yardstick_matches_plain_on_card():
    """``torch.baddbmm`` with a float32 result from bf16 operands has a
    CUDA kernel: on the tool's inputs and at the ragged K and N it is
    ``p4``'s function up to the order of its sums."""
    dev = _card()
    cases = [args for _, args, _ in probe_dcn.p5_cases("p4", SEED, dev)]
    cases.append(probe_dcn.ragged_p4_inputs(SEED, dev))
    for args in cases:
        got = probes.probe_p4_library(*args)
        want = probes.probe_p4_plain(*args)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _hold(got, want)
