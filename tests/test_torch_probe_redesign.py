"""The redesigned ``k2`` and ``k5`` probe kernels (``csrc/dcn_probes.cu``:
``broadcast_kernel`` and ``hat_tap_kernel``) at the edges of their designs.

``probes.RAGGED_GEOMETRY`` (BR, W, C, O = 5, 9, 24, 6) has 45 pixels a tile
(no multiple of ``k5``'s 16-pixel blocks), C = 24 (K pads to 32 for the
tensor cores, and the channels take 8-wide vectors) and O = 6 (no float4
for ``k2``, no multiple of ``k5``'s n8 tiles). On the CPU the plain
versions ``probe_k2_plain`` and ``probe_k5_plain`` are held there against
the scripts' ``k2`` and ``k5`` run in interpret mode, with the loader and
the tolerances of ``tests/test_torch_probes.py``, on the three inputs of
``tools/probe_dcn.py``; the wrappers' choice of vector width
(``broadcast_width``, ``k5_width``) and the width they hand the C entries are
checked on tensors on and off 16 bytes.

The ``cuda`` cases hold both kernels against their plain versions on the
card at all three geometries: ``k2`` bitwise as int32 bits, also on an
offset field with -0.0, +-1e30 and +-inf in it; ``k5`` within its
``rtol``, and within ``K5_TAP_RTOL`` (1e-5), far below what one bf16 tap
element rounded the other way would move (about 1e-3): the kernel's
float32 tap is bitwise the plain one, and only the order of the
contraction's sums differs. ``k5`` is also held on an x off 16
bytes (one channel a load) and on an x that holds inf inside a tile's box
where a pixel's hat weight is zero: the plain version gives NaN there (0 *
inf), and so must the kernel (NaN and inf positions equal, finite values
within the ``rtol``). They also check that the C entries refuse a vector
width that the tensors do not allow.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_probes import OPERANDS, SEED, _geom_id, _jax_tile, _jnp, _rel

from centerfusiondetect3d_tpu_torch.ops import probes
from centerfusiondetect3d_tpu_torch.ops.probes import (
    GEOMETRIES,
    PROBES,
    RAGGED_GEOMETRY,
)
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

ALL_GEOMETRIES = GEOMETRIES + (RAGGED_GEOMETRY,)


def _inputs(name, geom, case, device="cpu"):
    probe = PROBES[name]
    inp = probe_dcn.tile_inputs(probe.script, geom, case, SEED, device)
    return [inp[k] for k in probe.kernel.inputs]


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_the_ragged_geometry_meets_every_edge_and_stays_off_the_path():
    g = RAGGED_GEOMETRY
    assert g not in GEOMETRIES
    assert g.br * g.w == 45 and (g.br * g.w) % 16
    assert g.c % 8 == 0 and g.c % 16
    assert g.o % 4 and g.o % 8


@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("name", ["k2", "k5"])
def test_plain_matches_jax_interpret_at_the_ragged_geometry(name, case):
    probe, geom = PROBES[name], RAGGED_GEOMETRY
    call, script_result = _jax_tile(name, geom)
    inputs = probe_dcn.tile_inputs(probe.script, geom, case, SEED, "cpu")
    order = OPERANDS[probe.script]
    if case == "script":
        want = script_result
    else:
        want = call["fn"](*[_jnp(inputs[k]) for k in order])
    got = probe.plain(*[inputs[k] for k in probe.kernel.inputs], geom)
    assert got.shape == (2, geom.h, geom.w, geom.o)
    assert _rel(got.numpy(), want) <= probe.rtol


def _offset_view(shape, dtype, elements: int):
    """A contiguous tensor of ``shape`` that starts ``elements`` past a
    16-byte boundary."""
    flat = torch.zeros(elements + int(np.prod(shape)), dtype=dtype)
    return flat[elements:].view(shape)


@pytest.mark.parametrize("o,skew,vec", [(16, 0, 4), (32, 0, 4), (6, 0, 1),
                                        (16, 1, 1), (16, 4, 4), (4, 0, 4),
                                        (5, 0, 1), (16, 2, 1), (12, 8, 4),
                                        (6, 4, 1)])
def test_k2_stores_float4_where_o_and_out_allow_it(o, skew, vec):
    out = _offset_view((2, 16, 24, o), torch.float32, skew)
    assert probes.broadcast_width(out) == vec


@pytest.mark.parametrize("c,skew,vec", [(16, 0, 8), (8, 0, 8), (24, 0, 8),
                                        (12, 0, 1), (5, 0, 1), (16, 1, 1),
                                        (16, 8, 8)])
def test_k5_loads_eight_channels_where_c_and_x_allow_it(c, skew, vec):
    x = _offset_view((2, 36, 44, c), torch.bfloat16, skew)
    assert probes.k5_width(x) == vec


# (k2's, k5's) width at each geometry on 16 bytes: k2 float4 stores but at
# O = 6, k5 8-channel loads at every C (16, 8, 24)
WIDTHS = {"br8w24c16o16": (4, 8), "br4w40c8o32": (4, 8),
          "br5w9c24o6": (1, 8)}


@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_the_wrappers_hand_the_entries_their_width(geom, skew):
    """The C entries get the widths of ``WIDTHS``; an out or x one element
    off 16 bytes takes one element a store or load."""
    g = geom
    k2, k5 = WIDTHS[_geom_id(g)]
    out = _offset_view((g.batch, g.h, g.w, g.o), torch.float32, skew)
    x = _offset_view((g.batch, g.hp, g.wp, g.c), torch.bfloat16, skew)
    assert probes._broadcast_args({}, out) == ((1 if skew else k2),)
    assert probes._k5_args({"x": x}, out) == ((1 if skew else k5),)


def test_wrappers_run_plain_on_cpu_at_the_ragged_geometry():
    before = probes.launch_counts()
    for name in ("k2", "k5"):
        for case in probe_dcn.CASES:
            args = _inputs(name, RAGGED_GEOMETRY, case)
            probe = PROBES[name]
            assert torch.equal(probe.kernel(*args, geom=RAGGED_GEOMETRY),
                               probe.plain(*args, RAGGED_GEOMETRY))
    assert probes.launch_counts() == before


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold_with_nonfinite(got, want, rtol: float):
    """NaN and inf where want has them (the same infs), the finite values
    within rtol of want's largest finite magnitude (0: bitwise)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    _, rel = probe_dcn.relative(got[fin], want[fin])
    assert rel <= rtol, rel


@pytest.mark.cuda
@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_k2_kernel_is_bitwise_its_plain_version_on_card(geom, case):
    dev = _card()
    (off,) = _inputs("k2", geom, case, dev)
    before = probes.probe_k2.launches
    got = probes.probe_k2(off, geom=geom)
    torch.cuda.synchronize()
    assert probes.probe_k2.launches == before + 1
    assert torch.equal(_bits(got), _bits(probes.probe_k2_plain(off, geom)))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_k2_kernel_copies_signed_zeros_and_large_offsets_on_card(geom):
    dev = _card()
    (off,) = _inputs("k2", geom, "wide", dev)
    for b in range(geom.batch):
        dy = off[b, 4].view(-1)
        dy[::5] = -0.0
        dy[1::7] = 1e30
        dy[2::11] = -1e30
        dy[3::13] = float("inf")
        dy[4::17] = -float("inf")
    got = probes.probe_k2(off, geom=geom)
    want = probes.probe_k2_plain(off, geom)
    assert bool(((want == 0) & torch.signbit(want)).any())
    assert bool((want.abs() > 1e29).any())
    assert torch.equal(_bits(got), _bits(want))


# k5's output against its plain version where the two bf16 taps are equal:
# only the contraction's order of f32 sums differs (K <= 32 exact products).
# One tap element one bf16 ulp off moves an output by about 1e-3, inside the
# probe's rtol (8e-3) but far outside this.
K5_TAP_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_k5_kernel_matches_plain_on_card(geom, case):
    """Within the probe's rtol, and within K5_TAP_RTOL: the kernel's f32
    tap is bitwise the plain one's."""
    dev = _card()
    args = _inputs("k5", geom, case, dev)
    before = probes.probe_k5.launches
    got = probes.probe_k5(*args, geom=geom)
    torch.cuda.synchronize()
    assert probes.probe_k5.launches == before + 1
    _, rel = probe_dcn.relative(got, probes.probe_k5_plain(*args, geom))
    assert rel <= PROBES["k5"].rtol, rel
    assert rel <= K5_TAP_RTOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_k5_kernel_on_an_x_off_16_bytes_on_card(geom):
    dev = _card()
    x, off, mask, w = _inputs("k5", geom, "narrow", dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    skewed = flat[1:].view(x.shape)
    skewed.copy_(x)
    assert probes.k5_width(skewed) == 1
    got = probes.probe_k5(skewed, off, mask, w, geom=geom)
    _, rel = probe_dcn.relative(got, probes.probe_k5_plain(x, off, mask, w,
                                                           geom))
    assert rel <= PROBES["k5"].rtol, rel


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
def test_k5_kernel_gives_nan_where_plain_does_on_card(geom):
    dev = _card()
    x, off, mask, w = _inputs("k5", geom, "narrow", dev)
    x = _inf_where_a_weight_is_zero(x, off, geom)
    want = probes.probe_k5_plain(x, off, mask, w, geom)
    assert bool(torch.isnan(want[0, 0, 0]).all())  # 0 * inf in the tap
    got = probes.probe_k5(x, off, mask, w, geom=geom)
    _hold_with_nonfinite(got, want, PROBES["k5"].rtol)


@pytest.mark.cuda
def test_the_entries_refuse_a_width_the_tensors_do_not_allow():
    dev = _card()
    g = RAGGED_GEOMETRY
    x, off, mask, w = _inputs("k5", g, "narrow", dev)
    out = torch.empty((g.batch, g.h, g.w, g.o), device=dev)
    tile = (out.data_ptr(), g.batch, g.n_rb, g.br, g.w, g.c, g.o, g.pad)
    for vec in (4, 3):  # O = 6 holds no whole float4
        with pytest.raises(RuntimeError, match="CUDA error"):
            probes._run(out, "cfd_probe_k2", None, off.data_ptr(), None,
                        None, *tile, vec)
    skewed = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    for ptr, vec in ((skewed.data_ptr(), 8), (x.data_ptr(), 4)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            probes._run(out, "cfd_probe_k5", ptr, off.data_ptr(),
                        mask.data_ptr(), w.data_ptr(), *tile, vec)
