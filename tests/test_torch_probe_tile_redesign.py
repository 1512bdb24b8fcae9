"""The redesigned broadcast tile probes (``csrc/dcn_probes.cu``:
``hat_channel0_kernel``, the channel-0 hat sampler of ``k4``, ``kd``,
``ke`` and ``kb``, and ``tile_sum_kernel``, the window sums of ``ka``,
``k3``, ``kc`` and ``k1``) at the edges of their designs.

On the CPU the plain versions of the eight are held against the scripts'
kernels run in interpret mode (the loader of ``tests/test_torch_probes.py``)
at ``probes.RAGGED_GEOMETRY`` (BR, W, C, O = 5, 9, 24, 6: 45 pixels a tile,
no whole float4 of O, three 8-channel vectors of x a pixel) on the three
inputs of ``tools/probe_dcn.py``. The width that each of the nine probes
that broadcast a value to O hands its C entry (``broadcast_width``: float4
or float; its cases over O and the skew of ``out`` are
``test_torch_probe_redesign.py``'s) is checked; each of the eight names its
new ``__global__`` function and the old ones are gone from the source (the
comparison tool's cases of the eight are ``test_torch_compare_kernels.py``'s).

The ``cuda`` cases hold each kernel against its plain version on the card
within its ``rtol`` (``ka`` bitwise, the other seven ``SUMS``), at both
geometries of the probe path and the ragged one; float stores into an out
off 16 bytes; O = 6 at the scripts' tile; ``k1`` on an x off 16 bytes (one
channel a load); NaN where the plain version has it (inf in x under a zero
hat weight: 0 * inf), and inf where it has it for the unweighted sums;
repeats bitwise equal; and the entries' refusal of a width the tensors do
not allow, or of a pad below the clip range's CLIP + 1.

Tolerances, relative to the plain result's largest magnitude: each probe's
``Probe.rtol``. The hat sampler sums every term of the box with the plain
version's rounding, in ``kHatSplit`` runs of rows whose sums it adds in
one fixed order; ``k3`` and ``kc`` sum in the plain version's order, ``k1``
in channel order, and ``ka`` counts exactly.
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
    SCRIPT_GEOMETRY,
)
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

ALL_GEOMETRIES = GEOMETRIES + (RAGGED_GEOMETRY,)
HAT = ("k4", "kd", "ke", "kb")
SUMS_OF_WINDOWS = ("ka", "k3", "kc", "k1")
EIGHT = HAT + SUMS_OF_WINDOWS
BROADCAST = EIGHT + ("k2",)
DEVICE = {**{n: "hat_channel0_kernel" for n in HAT},
          **{n: "tile_sum_kernel" for n in SUMS_OF_WINDOWS}}


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


def _hold(got, want, rtol: float):
    """got is want within rtol of its largest magnitude; 0 is bitwise."""
    if rtol == 0:
        assert torch.equal(got, want)
        return
    _, rel = probe_dcn.relative(got, want)
    assert rel <= rtol, rel


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("name", EIGHT)
def test_plain_matches_jax_interpret_at_the_ragged_geometry(name, case):
    probe, geom = PROBES[name], RAGGED_GEOMETRY
    call, script_result = _jax_tile(name, geom)
    inputs = probe_dcn.tile_inputs(probe.script, geom, case, SEED, "cpu")
    if case == "script":
        want = script_result
    else:
        order = OPERANDS[probe.script]
        want = call["fn"](*[_jnp(inputs[k]) for k in order])
    got = probe.plain(*[inputs[k] for k in probe.kernel.inputs], geom)
    assert got.shape == (2, geom.h, geom.w, geom.o)
    assert _rel(got.numpy(), want) <= probe.rtol


# the broadcast width at each geometry on 16 bytes: float4 but at O = 6
WIDTHS = {"br8w24c16o16": 4, "br4w40c8o32": 4, "br5w9c24o6": 1}


@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", BROADCAST)
def test_each_broadcast_wrapper_hands_its_entry_the_width(name, geom):
    """The wrapper's C arguments after the geometry are
    ``broadcast_width(out)``: ``WIDTHS`` on 16 bytes, float one float or
    two off; every tile entry takes that one int more."""
    g = geom
    wrapper = PROBES[name].kernel
    assert wrapper.extra is probes._broadcast_args
    assert probes._SIGNATURES[f"cfd_probe_{name}"] == (
        probes._TILE_ARGS + [probes.ctypes.c_int])
    for skew, vec in ((0, WIDTHS[_geom_id(g)]), (1, 1), (2, 1),
                      (4, WIDTHS[_geom_id(g)])):
        out = _offset_view((g.batch, g.h, g.w, g.o), torch.float32, skew)
        assert wrapper.extra({}, out) == (vec,)


def test_wrappers_run_plain_on_cpu_at_the_ragged_geometry():
    before = probes.launch_counts()
    for name in EIGHT:
        probe = PROBES[name]
        for case in probe_dcn.CASES:
            args = _inputs(name, RAGGED_GEOMETRY, case)
            assert torch.equal(probe.kernel(*args, geom=RAGGED_GEOMETRY),
                               probe.plain(*args, RAGGED_GEOMETRY))
    assert probes.launch_counts() == before


_SOURCE = (Path(probes.__file__).resolve().parent.parent / "csrc"
           / probes.SOURCE).read_text()


@pytest.mark.parametrize("name", EIGHT)
def test_the_eight_name_their_new_device_functions(name):
    """``Probe.device`` is the new kernel (the source-parsing test of
    ``test_torch_probe_sampler_contract.py`` holds it to the entry), and
    the one-block kernels and their helper are gone."""
    assert PROBES[name].device == DEVICE[name]
    assert re.search(rf"__global__ void[^;{{]*\n{DEVICE[name]}\(", _SOURCE)
    for gone in ("hat_sampler_kernel", "hat_sum", "window_sum_kernel"):
        assert not re.search(rf"\b{gone}\b", _SOURCE), gone
    assert PROBES[name].library is None
    assert PROBES[name].rtol == (probes.EXACT if name == "ka"
                                 else probes.SUMS)


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", EIGHT)
def test_kernel_matches_plain_on_card(name, geom, case):
    dev = _card()
    probe = PROBES[name]
    args = _inputs(name, geom, case, dev)
    before = probe.kernel.launches
    got = probe.kernel(*args, geom=geom)
    torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    _hold(got, probe.plain(*args, geom), probe.rtol)
    assert torch.equal(probe.kernel(*args, geom=geom), got)  # repeats


def _tile_args(out, geom, pad):
    g = geom
    return (out.data_ptr(), g.batch, g.n_rb, g.br, g.w, g.c, g.o, pad)


def _entry(name, named, out, geom, vec, pad=None):
    """Calls ``cfd_probe_<name>`` with the given out and width (and pad,
    the geometry's by default)."""
    probes._run(out, f"cfd_probe_{name}",
                *(probes._ptr(named.get(k)) for k in ("x", "off", "mask",
                                                      "w")),
                *_tile_args(out, geom, geom.pad if pad is None else pad),
                vec)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", EIGHT)
def test_float_stores_into_an_out_off_16_bytes_on_card(name, geom):
    """O = 16 or 32 is whole in float4s, but an out one float past 16
    bytes takes float stores; the entry refuses float4 there."""
    dev = _card()
    probe = PROBES[name]
    args = _inputs(name, geom, "wide", dev)
    named = dict(zip(probe.kernel.inputs, args))
    g = geom
    out = _offset_view((g.batch, g.h, g.w, g.o), torch.float32, 1, dev)
    assert probes.broadcast_width(out) == 1
    _entry(name, named, out, g, 1)
    _hold(out, probe.plain(*args, g), probe.rtol)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _entry(name, named, out, g, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EIGHT)
def test_o_6_at_the_scripts_tile_on_card(name):
    """The scripts' 8 x 24 tiles with O = 6: float stores, six a pixel
    over the pixel's lanes."""
    dev = _card()
    geom = probes.Geometry(o=6)
    probe = PROBES[name]
    for case in probe_dcn.CASES:
        args = _inputs(name, geom, case, dev)
        got = probe.kernel(*args, geom=geom)
        assert got.shape[-1] == 6
        _hold(got, probe.plain(*args, geom), probe.rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
def test_k1_on_an_x_off_16_bytes_on_card(geom):
    """k1's entry loads 8 channels where C % 8 == 0 and x lies on 16
    bytes; an x one element off takes one channel a load."""
    dev = _card()
    (x,) = _inputs("k1", geom, "wide", dev)
    want = probes.probe_k1_plain(x, geom)
    skewed = _offset_view(x.shape, x.dtype, 1, dev)
    skewed.copy_(x)
    _hold(probes.probe_k1(skewed, geom=geom), want, PROBES["k1"].rtol)


def _inf_in_x(name, x, off, geom):
    """x with inf in channel 0 at a place that pixel (0, 0) of tile (0, 0)
    reads at a gy of its (cut) box whose hat weight is zero (at gx = xlo;
    ``kb`` at its one column), or, for ``k3`` and ``kc``, at gy = ylo, and
    for ``k1`` in its window."""
    x = x.clone()
    if name == "k1":
        x[0, 3, 2, 0] = float("inf")
        return x
    ylo, yhi, xlo, _ = (int(t[0, 0]) for t in probes.tile_bounds(off, geom))
    gx = 0 if name in ("kb", "k3", "kc") else xlo
    if name in ("k3", "kc"):
        gy = ylo
    else:
        lo, hi = (max(ylo, -2), min(yhi, 2)) if name == "ke" else (ylo, yhi)
        dy = float(off[0, 4, 0, 0].clamp(-probes.CLIP, probes.CLIP))
        gy = next(g for g in range(lo, hi + 1) if abs(g - dy) >= 1)
    x[0, gy + geom.pad, gx + geom.pad, 0] = float("inf")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ALL_GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", ("k4", "kd", "ke", "kb", "k3", "kc", "k1"))
def test_nan_and_inf_where_plain_has_them_on_card(name, geom):
    """The hat sampler keeps every term: 0 * inf is NaN where the plain
    version has it. The unweighted sums carry the inf."""
    dev = _card()
    x, off = (_inputs("k4", geom, "narrow", dev) if name != "k1"
              else (_inputs("k1", geom, "narrow", dev)[0], None))
    x = _inf_in_x(name, x, off, geom)
    args = (x,) if name == "k1" else (x, off)
    want = PROBES[name].plain(*args, geom)
    if name in HAT:
        assert bool(torch.isnan(want[0, 0, 0]).all())  # 0 * inf
    else:
        assert bool(torch.isinf(want).any())
    got = PROBES[name].kernel(*args, geom=geom)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    _hold(got[fin], want[fin], PROBES[name].rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EIGHT)
def test_the_entries_refuse_a_width_the_tensors_do_not_allow(name):
    """O = 6 holds no whole float4; 8 and 3 are no width at all; at the
    scripts' geometry an out one float off 16 bytes takes no float4."""
    dev = _card()
    probe = PROBES[name]
    for geom, skew, widths in ((RAGGED_GEOMETRY, 0, (4, 8, 3)),
                               (SCRIPT_GEOMETRY, 1, (4,))):
        g = geom
        named = dict(zip(probe.kernel.inputs, _inputs(name, g, "narrow",
                                                        dev)))
        out = _offset_view((g.batch, g.h, g.w, g.o), torch.float32, skew,
                           dev)
        for vec in widths:
            with pytest.raises(RuntimeError, match="CUDA error"):
                _entry(name, named, out, g, vec)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EIGHT)
def test_the_entries_refuse_a_pad_below_the_clip_range(name):
    """Every tile kernel reads gy and gx in [-CLIP, CLIP + 1] (the window
    sums load all of that range whatever the offsets), so an entry given a
    pad below CLIP + 1 refuses it, as ``Geometry`` does."""
    dev = _card()
    probe, g = PROBES[name], SCRIPT_GEOMETRY
    named = dict(zip(probe.kernel.inputs, _inputs(name, g, "narrow", dev)))
    out = torch.zeros((g.batch, g.h, g.w, g.o), device=dev)
    # x is laid out for the geometry's pad of 10: a pad of 9 reads inside it
    _entry(name, named, out, g, 1, pad=int(probes.CLIP) + 1)
    for pad in (int(probes.CLIP), 0):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _entry(name, named, out, g, 1, pad=pad)
