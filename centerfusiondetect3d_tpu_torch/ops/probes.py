"""The DCN probe kernels: the toolchain probes of the TPU rounds, on the card.

The probe scripts of the JAX package isolated, one ingredient at a time, what
the clamped shifted-window DCN kernel (K1, ``centerfusiondetect3d_tpu/ops/
pallas_dcn.py:117``) asks of the TPU compiler: window loads at dynamic
starts, an offset field read, tile-wide min/max loop bounds, the
hat-weighted bilinear multiply-add, the tap contraction. Each kernel body of
``scripts/probe_dcn_bisect.py`` (P1: ``k1``...``k5``),
``scripts/probe_dcn_bisect2.py`` (P2: ``ka``...``ke``),
``scripts/probe_dcn_bisect3.py`` (P3: ``kf``, ``kg``) and
``scripts/probe_mosaic.py`` (P5: ``p1``...``p4``) is here a wrapper around a
hand-written CUDA kernel of ``csrc/dcn_probes.cu`` with a plain PyTorch
version beside it. P1's ``k6`` and P5's ``p5`` are K1 itself: they are
:func:`probe_k6` and :func:`probe_p5`, calls of ``ops/dcn.py:dcn_fwd_bf16``
with ``max_offset=8``.

The tile probes (P1-P3) keep the scripts' layouts and their grid: x bf16
(B, HP, WP, C) with HP = n_rb*BR + 2*pad and WP = W + 2*pad; the offset
field float32 (B, 18, n_rb*BR, W), of which channel 4 is dy and channel 5 is
dx; the mask float32 (B, 9, n_rb*BR, W); the taps bf16 (9, C, O); the result
float32 (B, n_rb*BR, W, O), or (B, n_rb*BR, W, C) for ``kf`` and ``kg``. A
tile is one (b, rb) program of the Pallas grid, BR rows by W columns, and its
loop bounds come from the whole tile: with dy and dx clipped to
[-CLIP, CLIP], ylo = floor(min dy) and yhi = floor(max dy) + 1 over the tile,
xlo and xhi likewise, and a loop runs g = lo ... hi inclusive. With
hat(v) = max(0, 1 - |v|), per output pixel (r, c) of tile (b, rb):

- ``k1``: the sum over channels of x[b, rb*BR + 3 + r, 2 + c, :], in
  float32 and rounded to bf16 (``jnp.sum`` of bf16 returns bf16);
- ``k2``: dy itself, not clipped;
- ``k3``: sum over gy in [ylo, yhi] of x[b, gy + pad + r, pad + c, 0]: no
  rb*BR term, so both row blocks read the same rows;
- ``k4`` and ``kd`` (one linearized loop): sum over the tile's box of
  hat(gy - dy) hat(gx - dx) x[b, rb*BR + gy + pad + r, gx + pad + c, 0];
- ``k5``: the ``k4`` sum for every channel, times mask channel 3, rounded
  to bf16 once, contracted with the bf16 taps w[3] in float32;
- ``ka``: (yhi - ylo + 1) (xhi - xlo + 1);
- ``kb``: sum over gy of hat(gy - dy) x[b, gy + pad + r, pad + c, 0] (no
  rb*BR term, no x loop);
- ``kc``: ``k3`` with the rb*BR term;
- ``ke``: ``k4`` with gy cut to [max(ylo, -2), min(yhi, 2)] (its static
  loop over -2 ... 2);
- ``kf``: ``k4`` for every channel with gx cut to [-9, 10] (``GX_RANGE``);
- ``kg``: ``k4`` for every channel, the columns taken modulo WP (a roll).

With dy and dx clipped to +-8, gx stays in [-8, 9], inside ``kf``'s cut,
and with the pad of at least 9 that the geometry requires no column wraps:
``kf`` and ``kg`` compute the same function, as ``k4`` and ``kd`` do, and
each pair shares its plain version and its device code (each probe keeps
its own entry point and launch count).

Every output channel of ``k1``...``k4`` and ``ka``...``ke`` holds the same
value (channel 0 broadcast to O). The P5 probes take their own arrays:
``p1`` x[g:g+rows, g+1:g+1+cols, :]; ``p2`` the sum over i in [lo, hi) of
x[i:i+rows, :]; ``p3`` x + trunc(min x) where max x > 0.5, else 0 (the int32
cast truncates toward zero; a NaN anywhere gives 0, as ``jnp.max`` and
``torch.max`` propagate it); ``p4`` bf16(x[2:10, 1:17, :] * bf16(2))
reshaped to (128, 64) and contracted with w in float32.

Each wrapper checks device, dtype, shape, contiguity and that every window
it reads lies inside x (interpret mode clamps an out-of-range start and the
TPU does not; the wrappers raise). On a CPU tensor it runs the plain version;
on a CUDA tensor it launches its kernel or raises (no fallback), and its
``.launches`` counts the launches. Each wrapper picks its kernel's vector
width from the tensors' shapes and addresses, and the C entry checks the
choice again and refuses a wrong one: the nine probes that broadcast one
value a pixel to O (``k1``...``k4``, ``ka``...``ke``) store float4s where O
is whole in float4s and out lies on 16 bytes (``broadcast_width``); ``p1``
and ``p2`` load and store float4s where every window row allows it
(``row_windows``), ``p3`` where x and out lie on 16 bytes (``p3_width``);
``k5`` loads 8 channels (``k5_width``), ``kf`` and ``kg`` 2 (``kf_width``). ``k1``'s entry picks its own load width (8 channels where
C % 8 == 0 and x lies on 16 bytes), as ``p4``'s does.
``PROBES`` lists the sixteen, each with its yardstick where one PyTorch
call computes its function (``Probe.library``: ``k2``, ``p1``, ``p2``,
``p4``, timed beside the kernel by ``chip_smoke.py``; the port never calls
it).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from . import dcn
from .cuda_build import load_kernel_library

SOURCE = "dcn_probes.cu"
CLIP = 8.0  # the probes clip dy and dx to [-8, 8] before their bounds
KE_ROWS = (-2, 2)  # ke's static gy loop, range(-2, 3)
KF_COLS = (-9, 10)  # kf's GX_RANGE, range(-9, 11)
OPEN = (-(1 << 20), 1 << 20)  # no cut
# P5's fixed windows: p1 and p2 take rows x cols windows, p4 the window at
# (P4_ROW0, P4_COL0) scaled by P4_SCALE
P5_ROWS, P5_COLS = 8, 16
P4_ROW0, P4_COL0, P4_SCALE = 2, 1, 2.0


@dataclass(frozen=True)
class Geometry:
    """The grid and the tile of a P1-P3 probe launch: ``batch`` x ``n_rb``
    tiles of ``br`` rows by ``w`` columns, x with ``c`` channels padded by
    ``pad`` rows and columns on each side, ``o`` output channels."""

    batch: int = 2
    n_rb: int = 2
    br: int = 8
    w: int = 24
    c: int = 16
    o: int = 16
    pad: int = 10

    def __post_init__(self):
        if min(self.batch, self.n_rb, self.br, self.w, self.c, self.o) < 1:
            raise ValueError(f"probe geometry must be positive: {self}")
        # gy and gx lie in [-CLIP, CLIP + 1], so every window lies inside x
        # once the pad covers CLIP + 1 rows and columns
        if self.pad < CLIP + 1:
            raise ValueError(f"pad {self.pad} < {int(CLIP) + 1}: a probe's "
                             "window would leave x")

    @property
    def h(self) -> int:
        return self.n_rb * self.br

    @property
    def hp(self) -> int:
        return self.h + 2 * self.pad

    @property
    def wp(self) -> int:
        return self.w + 2 * self.pad


SCRIPT_GEOMETRY = Geometry()  # the scripts' BR, W, C, O = 8, 24, 16, 16
SECOND_GEOMETRY = Geometry(br=4, w=40, c=8, o=32)
GEOMETRIES = (SCRIPT_GEOMETRY, SECOND_GEOMETRY)
# the edges of the k2, k5 and kf kernels: 45 pixels a tile (no multiple of
# k5's 16), C = 24 (K pads to 32, three 8-channel vectors), O = 6 (no float4
# and no multiple of 8). Not in GEOMETRIES: the probe path's launch counts,
# and with them the ranking, stay as they were; the card tests and
# chip_smoke.py's phase 15 check the kernels there.
RAGGED_GEOMETRY = Geometry(br=5, w=9, c=24, o=6)
# p4's (K, N) at the edges of its kernel: K = 24 pads to 32 (three 8-channel
# loads a pixel); N = 20 fills no 32-column block and no 8-column vector of w
RAGGED_P4 = (24, 20)


# ------------------------------------------------------------ plain versions


def tile_bounds(off, geom: Geometry):
    """(ylo, yhi, xlo, xhi), each an int64 tensor (B, n_rb): floor of the
    min and floor of the max plus 1 of the clipped dy and dx over each tile
    (the scripts' ``bounds``)."""
    g = geom
    d = off[:, 4:6].clamp(-CLIP, CLIP).reshape(g.batch, 2, g.n_rb, g.br, g.w)
    lo = d.amin((3, 4)).floor().long()
    hi = d.amax((3, 4)).floor().long() + 1
    return lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]


def tiles(geom: Geometry, off):
    """(b, rb, rows of the tile, (ylo, yhi, xlo, xhi)) per tile."""
    bounds = [t.tolist() for t in tile_bounds(off, geom)]
    for b in range(geom.batch):
        for rb in range(geom.n_rb):
            rows = slice(rb * geom.br, (rb + 1) * geom.br)
            yield b, rb, rows, tuple(t[b][rb] for t in bounds)


def _broadcast(v, o: int):
    """(B, H, W) -> (B, H, W, o): channel 0 broadcast to the O outputs."""
    return v[..., None].expand(*v.shape, o).contiguous()


def _hat(v):
    return (1.0 - v.abs()).clamp_min(0.0)


def _unweighted_plain(x, off, geom: Geometry, row_block: bool):
    """``k3`` (no row-block term) and ``kc``: sum over the tile's gy range
    of channel 0 of the windows at rows [rb*BR] + gy + pad."""
    g = geom
    out = torch.zeros((g.batch, g.h, g.w), dtype=torch.float32,
                      device=x.device)
    for b, rb, rows, (ylo, yhi, _, _) in tiles(g, off):
        base = rb * g.br if row_block else 0
        for gy in range(ylo, yhi + 1):
            r0 = base + gy + g.pad
            out[b, rows] += x[b, r0:r0 + g.br, g.pad:g.pad + g.w, 0].float()
    return _broadcast(out, g.o)


def _hat_plain(x, off, geom: Geometry, *, channels: int, row_block=True,
               x_loop=True, y_cut=OPEN, x_cut=OPEN):
    """The hat-weighted tile sampler, float32 (B, H, W, channels): per tile
    the sum over gy in [max(ylo, y_cut[0]), min(yhi, y_cut[1])] and gx
    likewise of hat(gy - dy) hat(gx - dx) x[b, [rb*BR] + gy + pad + r,
    gx + pad + c, :channels], in the kernels' order (gy outer, gx inner)
    and at their rounding points: (wy * wx) * x, then the sum. Without the
    x loop (``kb``) the term is wy * x[..., pad + c, :]."""
    g = geom
    dy = off[:, 4].clamp(-CLIP, CLIP)
    dx = off[:, 5].clamp(-CLIP, CLIP)
    out = torch.zeros((g.batch, g.h, g.w, channels), dtype=torch.float32,
                      device=x.device)
    for b, rb, rows, (ylo, yhi, xlo, xhi) in tiles(g, off):
        ty, tx = dy[b, rows], dx[b, rows]
        base = rb * g.br if row_block else 0
        acc = out[b, rows]
        for gy in range(max(ylo, y_cut[0]), min(yhi, y_cut[1]) + 1):
            wy = _hat(gy - ty)
            slab = x[b, base + gy + g.pad:base + gy + g.pad + g.br]
            if not x_loop:
                win = slab[:, g.pad:g.pad + g.w, :channels]
                acc += wy[..., None] * win.float()
                continue
            for gx in range(max(xlo, x_cut[0]), min(xhi, x_cut[1]) + 1):
                wyx = wy * _hat(gx - tx)
                win = slab[:, g.pad + gx:g.pad + gx + g.w, :channels]
                acc += wyx[..., None] * win.float()
    return out


def probe_k1_plain(x, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``k1``: the channel sum of x[b, rb*BR + 3 + r, 2 + c, :] (the
    tiles' windows are contiguous: rows 3 ... 3 + H - 1), rounded to bf16."""
    g = geom
    s = x[:, 3:3 + g.h, 2:2 + g.w].float().sum(-1)
    return _broadcast(s.bfloat16().float(), g.o)


def probe_k2_plain(off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``k2``: dy (offset channel 4, not clipped) broadcast to O."""
    return _broadcast(off[:, 4], geom.o)


def probe_k3_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``k3``: channel 0 summed over the tile's gy range at rows
    gy + pad + r, with no row-block term."""
    return _unweighted_plain(x, off, geom, row_block=False)


def probe_k4_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``k4``: the hat-weighted sample of channel 0 at (dy, dx) over
    the tile's box, broadcast to O."""
    return _broadcast(_hat_plain(x, off, geom, channels=1)[..., 0], geom.o)


def probe_k5_plain(x, off, mask, w, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``k5``: the ``k4`` sample of every channel times mask channel
    3, rounded to bf16 once, contracted with w[3] in float32 (products of
    two bf16 values are exact in float32; written as a broadcast sum, so no
    matrix-product setting can change it)."""
    tap = _hat_plain(x, off, geom, channels=geom.c) * mask[:, 3, ..., None]
    tap = tap.bfloat16().float()
    return (tap[..., None] * w[3].float()).sum(-2)


def probe_ka_plain(off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``ka``: the size of the tile's box, (yhi - ylo + 1) *
    (xhi - xlo + 1), broadcast over the tile and to O."""
    g = geom
    ylo, yhi, xlo, xhi = tile_bounds(off, g)
    n = ((yhi - ylo + 1) * (xhi - xlo + 1)).float()  # (B, n_rb)
    tiles = n[:, :, None, None].expand(g.batch, g.n_rb, g.br, g.w)
    return _broadcast(tiles.reshape(g.batch, g.h, g.w), g.o)


def probe_kb_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``kb``: sum over the tile's gy range of hat(gy - dy) times
    channel 0 at rows gy + pad + r (no row-block term) and columns
    pad + c."""
    out = _hat_plain(x, off, geom, channels=1, row_block=False, x_loop=False)
    return _broadcast(out[..., 0], geom.o)


def probe_kc_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``kc``: ``k3`` with the row-block term rb*BR."""
    return _unweighted_plain(x, off, geom, row_block=True)


def probe_kd_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``kd``: ``k4``'s sum through one loop over i < ny*nx (gy =
    ylo + i // nx, gx = xlo + i % nx): the same terms in the same order."""
    return probe_k4_plain(x, off, geom)


def probe_ke_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``ke``: ``k4`` with gy cut to [-2, 2]."""
    out = _hat_plain(x, off, geom, channels=1, y_cut=KE_ROWS)
    return _broadcast(out[..., 0], geom.o)


def probe_kf_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``kf``: ``k4`` for every channel with gx cut to [-9, 10]."""
    return _hat_plain(x, off, geom, channels=geom.c, x_cut=KF_COLS)


def probe_kg_plain(x, off, geom: Geometry = SCRIPT_GEOMETRY):
    """Plain ``kg``: ``k4`` for every channel, columns modulo WP (no column
    wraps): ``kf``'s function."""
    return probe_kf_plain(x, off, geom)


def probe_p1_plain(x, g: int):
    """Plain ``p1``: x[g:g+8, g+1:g+17, :]."""
    return x[g:g + P5_ROWS, g + 1:g + 1 + P5_COLS].clone()


def probe_p2_plain(x, lo: int, hi: int):
    """Plain ``p2``: x[i:i+8, :] summed over i = lo ... hi - 1 in order."""
    acc = torch.zeros((P5_ROWS, x.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(lo, hi):
        acc += x[i:i + P5_ROWS]
    return acc


# --------------------------------------------- yardsticks: one PyTorch call


def probe_k2_library(off, geom: Geometry = SCRIPT_GEOMETRY):
    """``k2`` as one copy: dy broadcast to O by ``expand(...).contiguous()``."""
    g = geom
    return off[:, 4, ..., None].expand(g.batch, g.h, g.w, g.o).contiguous()


def probe_p1_library(x, g: int):
    """``p1`` as one copy: ``x[g:g+8, g+1:g+17].clone()``."""
    return x[g:g + P5_ROWS, g + 1:g + 1 + P5_COLS].clone()


def probe_p2_library(x, lo: int, hi: int):
    """``p2`` as one reduction: the ``hi - lo`` row windows of
    ``x.unfold(0, 8, 1)`` (views) summed over the window index in one
    ``sum``, in its own order (within 1e-6 of the plain sum)."""
    return x.unfold(0, P5_ROWS, 1)[lo:hi].transpose(1, 2).sum(0)


def probe_p4_library(x, w):
    """``p4`` as one call: ``torch.baddbmm`` of the (8, 16, K) window view
    and w expanded to (8, K, N), alpha 2, beta 0, with a float32 result from
    bf16 operands. On finite x below half of bf16's largest value x * 2 is
    exact in bf16 and 2 * sum in float32, so only the order of the sums
    differs from the plain version. It has a CUDA kernel only (the CPU has
    none)."""
    win = x[P4_ROW0:P4_ROW0 + P5_ROWS, P4_COL0:P4_COL0 + P5_COLS]
    k, n = w.shape
    out = torch.empty((P5_ROWS, P5_COLS, n), dtype=torch.float32,
                      device=x.device)
    return torch.baddbmm(out, win, w.expand(P5_ROWS, k, n), beta=0,
                         alpha=P4_SCALE, out_dtype=torch.float32)


def probe_p3_plain(x):
    """Plain ``p3``: x + trunc(min x) if max x > 0.5, else zeros (the
    float -> int32 cast truncates toward zero). ``max`` propagates NaN, so
    a NaN anywhere gives zeros, as the script's ``jnp.max`` does."""
    lo = x.min().to(torch.int32).float()
    return torch.where(x.max() > 0.5, x + lo, torch.zeros_like(x))


def probe_p4_plain(x, w):
    """Plain ``p4``: bf16(x[2:10, 1:17, :] * bf16(2)) as (128, K), times w
    (K, N) in float32, as (8, 16, N). The product with a ones x and ones w
    of the script is 2 * 64 = 128 (the script asserts 256)."""
    win = x[P4_ROW0:P4_ROW0 + P5_ROWS, P4_COL0:P4_COL0 + P5_COLS]
    tap = (win * torch.tensor(P4_SCALE, dtype=torch.bfloat16)).float()
    out = (tap.reshape(-1, x.shape[2], 1) * w.float()).sum(1)
    return out.reshape(P5_ROWS, P5_COLS, w.shape[1])


# ------------------------------------------------------------------ checks


def _check(t, name: str, shape, dtype):
    if not torch.is_tensor(t):
        raise TypeError(f"probe: {name} must be a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"probe: {name} must be {str(dtype)[6:]}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"probe: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"probe: {name} must be contiguous")


def _device(*tensors) -> torch.device:
    """The tensors' one device: cpu or cuda; anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("probe: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"probe: no kernel for device {dev}")
    return dev


def _check_tile(geom: Geometry, x=None, off=None, mask=None, w=None):
    """Checks a tile probe's tensors against its geometry; returns the
    device."""
    if not isinstance(geom, Geometry):
        raise TypeError(f"probe: geom must be a Geometry, got {type(geom)}")
    g = geom
    given = []
    if x is not None:
        _check(x, "x", (g.batch, g.hp, g.wp, g.c), torch.bfloat16)
        given.append(x)
    if off is not None:
        _check(off, "off", (g.batch, 18, g.h, g.w), torch.float32)
        given.append(off)
    if mask is not None:
        _check(mask, "mask", (g.batch, 9, g.h, g.w), torch.float32)
        given.append(mask)
    if w is not None:
        _check(w, "w", (9, g.c, g.o), torch.bfloat16)
        given.append(w)
    return _device(*given)


# ------------------------------------------------------------ the wrappers

# C entry points: name -> ctypes argument types before the stream
_TILE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
_SIGNATURES = {
    # the tile probes: the tile arguments, then the vector width
    **{f"cfd_probe_{n}": _TILE_ARGS + [ctypes.c_int] for n in (
        "k1", "k2", "k3", "k4", "k5", "ka", "kb", "kc", "kd", "ke", "kf",
        "kg")},
    **{f"cfd_probe_{n}": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
       for n in ("p1", "p2")},
    "cfd_probe_p3": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2,
    "cfd_probe_p4": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_float],
}


def _run(like, name: str, *args) -> None:
    """Builds (once) and calls the C entry point ``name`` on the current
    stream of ``like``'s device; raises on a CUDA error."""
    fn = getattr(load_kernel_library(SOURCE).lib, name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name] + [ctypes.c_void_p]
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def broadcast_width(out) -> int:
    """The store width of the nine probes that broadcast one value a pixel
    to O (``k1``...``k4``, ``ka``...``ke``): 4 (float4) where out (B, H, W,
    O) holds whole float4s a pixel and starts on 16 bytes, else 1."""
    return 4 if out.shape[-1] % 4 == 0 and out.data_ptr() % 16 == 0 else 1


def k5_width(x) -> int:
    """``k5``'s load width: 8 channels (one 16-byte load) where x (B, HP,
    WP, C) holds whole 8-channel vectors a pixel and starts on 16 bytes,
    else 1."""
    return 8 if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 else 1


def kf_width(x) -> int:
    """``kf``'s and ``kg``'s channels a thread: 2 (one 4-byte load) where x
    (B, HP, WP, C) holds whole pairs a pixel and starts on 4 bytes, else 1.
    Two channels a thread beat 8, 4 and 1 on the card."""
    return 2 if x.shape[-1] % 2 == 0 and x.data_ptr() % 4 == 0 else 1


def _broadcast_args(named, out):
    """(vec,) of the entries of the nine broadcast probes."""
    return (broadcast_width(out),)


def _k5_args(named, out):
    """(vec,) of the ``k5`` entry."""
    return (k5_width(named["x"]),)


def _kf_args(named, out):
    """(vec,) of the ``kf`` and ``kg`` entries."""
    return (kf_width(named["x"]),)


def _tile_probe(name: str, plain: Callable, inputs: Tuple[str, ...],
                extra: Callable, all_channels: bool = False):
    """The wrapper of tile probe ``name``: takes ``inputs`` (of x, off,
    mask, w) and the geometry; returns float32 (B, H, W, O), or
    (B, H, W, C) with ``all_channels``. ``extra(named, out)`` gives the C
    arguments after the geometry (the vector width), and is kept as the
    wrapper's ``.extra``."""

    def wrapper(*tensors, geom: Geometry = SCRIPT_GEOMETRY):
        if len(tensors) != len(inputs):
            raise TypeError(f"probe_{name} takes ({', '.join(inputs)}), got "
                            f"{len(tensors)} tensors")
        named = dict(zip(inputs, tensors))
        dev = _check_tile(geom, **named)
        if dev.type == "cpu":
            return plain(*tensors, geom)
        g = geom
        out = torch.empty((g.batch, g.h, g.w, g.c if all_channels else g.o),
                          dtype=torch.float32, device=dev)
        _run(out, f"cfd_probe_{name}",
             *(_ptr(named.get(k)) for k in ("x", "off", "mask", "w")),
             out.data_ptr(), g.batch, g.n_rb, g.br, g.w, g.c, g.o, g.pad,
             *extra(named, out))
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = f"probe_{name}"
    wrapper.__doc__ = (f"The ``{name}`` kernel of ``csrc/{SOURCE}``, as "
                       f":func:`probe_{name}_plain` (which runs instead on "
                       f"CPU tensors). ``probe_{name}.launches`` counts "
                       "launches.")
    wrapper.launches = 0
    wrapper.inputs = inputs
    wrapper.extra = extra
    return wrapper


_XO = ("x", "off")
probe_k1 = _tile_probe("k1", probe_k1_plain, ("x",), _broadcast_args)
probe_k2 = _tile_probe("k2", probe_k2_plain, ("off",), _broadcast_args)
probe_k3 = _tile_probe("k3", probe_k3_plain, _XO, _broadcast_args)
probe_k4 = _tile_probe("k4", probe_k4_plain, _XO, _broadcast_args)
probe_k5 = _tile_probe("k5", probe_k5_plain, ("x", "off", "mask", "w"),
                       _k5_args)
probe_ka = _tile_probe("ka", probe_ka_plain, ("off",), _broadcast_args)
probe_kb = _tile_probe("kb", probe_kb_plain, _XO, _broadcast_args)
probe_kc = _tile_probe("kc", probe_kc_plain, _XO, _broadcast_args)
probe_kd = _tile_probe("kd", probe_kd_plain, _XO, _broadcast_args)
probe_ke = _tile_probe("ke", probe_ke_plain, _XO, _broadcast_args)
probe_kf = _tile_probe("kf", probe_kf_plain, _XO, _kf_args,
                       all_channels=True)
probe_kg = _tile_probe("kg", probe_kg_plain, _XO, _kf_args,
                       all_channels=True)


def row_windows(x, out, col0: int, lo: int, hi: int):
    """The C arguments (row_stride, col0, span, rows, lo, hi, vec) of P5's
    window kernel for out (rows, ...) = the sum over i in [lo, hi) of the
    span = out[0].numel() floats of x that start col0 floats into row i + r
    (x's rows, dim 0, row_stride floats apart). vec is 4 (float4 loads and
    stores) where every such row of x and of out starts on 16 bytes and
    holds whole float4s, else 1."""
    row_stride = math.prod(x.shape[1:])
    rows, span = out.shape[0], math.prod(out.shape[1:])
    aligned = (x.data_ptr() + 4 * col0) % 16 == 0 and out.data_ptr() % 16 == 0
    vec = 4 if aligned and row_stride % 4 == 0 and span % 4 == 0 else 1
    return row_stride, col0, span, rows, lo, hi, vec


def probe_p1(x, g: int):
    """The ``p1`` kernel: x[g:g+8, g+1:g+17, :] of a float32 3-D x, as
    :func:`probe_p1_plain` (which runs instead on CPU tensors)."""
    _check(x, "x", x.shape, torch.float32)
    if x.dim() != 3:
        raise ValueError(f"probe: x must be 3-D, got {tuple(x.shape)}")
    g = int(g)
    if not (0 <= g and g + P5_ROWS <= x.shape[0]
            and g + 1 + P5_COLS <= x.shape[1]):
        raise ValueError(f"probe_p1: start {g} takes a window outside x "
                         f"{tuple(x.shape)}")
    if _device(x).type == "cpu":
        return probe_p1_plain(x, g)
    out = torch.empty((P5_ROWS, P5_COLS, x.shape[2]), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        _run(x, "cfd_probe_p1", x.data_ptr(), out.data_ptr(),
             *row_windows(x, out, (g + 1) * x.shape[2], g, g + 1))
        probe_p1.launches += 1
    return out


def probe_p2(x, lo: int, hi: int):
    """The ``p2`` kernel: the sum of x[i:i+8, :] over lo <= i < hi of a
    float32 2-D x, as :func:`probe_p2_plain` (which runs instead on CPU
    tensors)."""
    _check(x, "x", x.shape, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"probe: x must be 2-D, got {tuple(x.shape)}")
    lo, hi = int(lo), int(hi)
    if not (0 <= lo <= hi and (hi == lo or hi - 1 + P5_ROWS <= x.shape[0])):
        raise ValueError(f"probe_p2: loop [{lo}, {hi}) reads outside x "
                         f"{tuple(x.shape)}")
    if _device(x).type == "cpu":
        return probe_p2_plain(x, lo, hi)
    out = torch.empty((P5_ROWS, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        _run(x, "cfd_probe_p2", x.data_ptr(), out.data_ptr(),
             *row_windows(x, out, 0, lo, hi))
        probe_p2.launches += 1
    return out


def p3_width(x, out) -> int:
    """``p3``'s load and store width: 4 (float4s, the n % 4 tail floats)
    where x and out start on 16 bytes, else 1."""
    return 4 if x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1


def probe_p3(x):
    """The ``p3`` kernel on a float32 x, as :func:`probe_p3_plain` (which
    runs instead on CPU tensors)."""
    _check(x, "x", x.shape, torch.float32)
    if x.numel() == 0:
        raise ValueError("probe_p3: x is empty")
    if _device(x).type == "cpu":
        return probe_p3_plain(x)
    out = torch.empty_like(x)
    _run(x, "cfd_probe_p3", x.data_ptr(), out.data_ptr(), x.numel(),
         p3_width(x, out))
    probe_p3.launches += 1
    return out


def probe_p4(x, w):
    """The ``p4`` kernel: bf16 x (D0, D1, K), bf16 w (K, N) -> float32
    (8, 16, N), as :func:`probe_p4_plain` (which runs instead on CPU
    tensors)."""
    _check(x, "x", x.shape, torch.bfloat16)
    if x.dim() != 3:
        raise ValueError(f"probe: x must be 3-D, got {tuple(x.shape)}")
    if P4_ROW0 + P5_ROWS > x.shape[0] or P4_COL0 + P5_COLS > x.shape[1]:
        raise ValueError(f"probe_p4: the window leaves x {tuple(x.shape)}")
    if w.dim() != 2:
        raise ValueError(f"probe: w must be 2-D, got {tuple(w.shape)}")
    _check(w, "w", (x.shape[2], w.shape[1]), torch.bfloat16)
    if _device(x, w).type == "cpu":
        return probe_p4_plain(x, w)
    out = torch.empty((P5_ROWS, P5_COLS, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        _run(x, "cfd_probe_p4", x.data_ptr(), w.data_ptr(), out.data_ptr(),
             *x.shape, w.shape[1], P4_ROW0, P4_COL0, P5_ROWS, P5_COLS,
             P4_SCALE)
        probe_p4.launches += 1
    return out


probe_p1.launches = 0
probe_p2.launches = 0
probe_p3.launches = 0
probe_p4.launches = 0


def probe_k6(x, offset, mask, weight):
    """K1 at a probe's shape: P1's ``k6`` at (B, C, H, W, O) = (2, 16, 16,
    24, 16) and P5's ``p5`` at (1, 64, 16, 24, 64). ``dcn_fwd_bf16`` with
    ``max_offset=8``, counted in ``dcn_fwd_bf16.launches``; NCHW as
    ``ops/dcn.py`` takes it (``k6``'s NCHW-like offset blocks no longer fit
    K1's NHWC ones)."""
    return dcn.dcn_fwd_bf16(x, offset, mask, weight, None, max_offset=CLIP)


probe_p5 = probe_k6


# ---------------------------------------------------------------- registry


@dataclass(frozen=True)
class Probe:
    """One probe kernel: its wrapper and plain version, the script and the
    name it had there, the line of its body, the function of
    ``csrc/dcn_probes.cu`` that its entry launches (``device``), its
    tolerance relative to the plain result's largest magnitude (0:
    bitwise), and its yardstick: one PyTorch call that computes the same
    function on the same arguments, or None where no single call does (the
    tile probes' loops run over bounds that the offsets set; ``kf`` and
    ``kg`` sample bilinearly, but ``grid_sample`` takes an NCHW x and a
    normalised grid and returns x's dtype, bf16; ``k1`` sums, rounds to bf16
    and broadcasts; ``k5`` masks, rounds and contracts; ``p3`` needs a min,
    a max and a select)."""

    name: str
    kernel: Callable
    plain: Callable
    script: str
    script_name: str
    line: int
    device: str
    rtol: float
    library: Optional[Callable] = None

    @property
    def replaces(self) -> str:
        return f"{self.script}:{self.line}"


_P1, _P2, _P3, _P5 = (f"scripts/{s}.py" for s in (
    "probe_dcn_bisect", "probe_dcn_bisect2", "probe_dcn_bisect3",
    "probe_mosaic"))
# copies, counts and small exact sums are bitwise; float32 sums of bf16
# inputs (and p4's 64 exact products) may differ in order: 1e-5; k5 rounds
# its tap sums to bf16 once, and another order of those sums can flip that
# rounding: two bf16 ulps
EXACT, SUMS, BF16_TAP = 0.0, 1e-5, 8e-3
PROBES: Dict[str, Probe] = {p.name: p for p in (
    Probe("k1", probe_k1, probe_k1_plain, _P1, "k1_4d_dyn_slice", 62,
          "tile_sum_kernel", SUMS),
    Probe("k2", probe_k2, probe_k2_plain, _P1, "k2_field_slice", 71,
          "broadcast_kernel", EXACT, probe_k2_library),
    Probe("k3", probe_k3, probe_k3_plain, _P1, "k3_dyn_fori_1d", 77,
          "tile_sum_kernel", SUMS),
    Probe("k4", probe_k4, probe_k4_plain, _P1, "k4_nested_fori", 93,
          "hat_channel0_kernel", SUMS),
    Probe("k5", probe_k5, probe_k5_plain, _P1, "k5_matmul_reshape", 120,
          "hat_tap_kernel", BF16_TAP),
    Probe("ka", probe_ka, probe_ka_plain, _P2, "ka_nested_trivial", 64,
          "tile_sum_kernel", EXACT),
    Probe("kb", probe_kb, probe_kb_plain, _P2, "kb_hat_slice_1d", 80,
          "hat_channel0_kernel", SUMS),
    Probe("kc", probe_kc, probe_kc_plain, _P2, "kc_pid_slice_1d", 95,
          "tile_sum_kernel", SUMS),
    Probe("kd", probe_kd, probe_kd_plain, _P2, "kd_linearized", 110,
          "hat_channel0_kernel", SUMS),
    Probe("ke", probe_ke, probe_ke_plain, _P2, "ke_static_when_inner_fori",
          131, "hat_channel0_kernel", SUMS),
    Probe("kf", probe_kf, probe_kf_plain, _P3, "kf_static_gx_when", 97,
          "hat_cols_kernel", SUMS),
    Probe("kg", probe_kg, probe_kg_plain, _P3, "kg_dynamic_roll", 117,
          "hat_cols_kernel", SUMS),
    Probe("p1", probe_p1, probe_p1_plain, _P5, "dyn_start_sublane_slice", 45,
          "row_window_kernel", EXACT, probe_p1_library),
    Probe("p2", probe_p2, probe_p2_plain, _P5, "dyn_bound_fori_loop", 68,
          "row_window_kernel", EXACT, probe_p2_library),
    Probe("p3", probe_p3, probe_p3_plain, _P5, "scalar_reduce_plwhen", 98,
          "shift_if_max_kernel", EXACT),
    Probe("p4", probe_p4, probe_p4_plain, _P5, "bf16_slice_mac_matmul", 122,
          "contract_kernel", SUMS, probe_p4_library),
)}
# K1 at the probes' shapes: (script, name there, line); dcn_fwd_bf16's limit
K1_PROBES = {"k6": (_P1, "k6_full_kernel", 132),
             "p5": (_P5, "old_gather_kernel_interpret_false", 150)}
K1_RTOL = 8e-3


def reset_launch_counts() -> None:
    for p in PROBES.values():
        p.kernel.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: p.kernel.launches for name, p in PROBES.items()}
