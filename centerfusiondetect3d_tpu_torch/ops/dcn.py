"""Modulated 3x3 stride-1 deformable convolution (DCNv2), NCHW, with autograd.

The op of every ``DeformConvNode``. ``deform_conv2d`` is the entry point: on
a float32 or float64 CPU tensor it runs the plain PyTorch version,
``deform_conv2d_plain``, and autograd differentiates that; on a CUDA tensor it runs ``DeformConv2dFunction``,
whose forward launches the hand-written kernel ``csrc/dcn_fwd.cu`` (which
replaces the Pallas forward kernels of
``centerfusiondetect3d_tpu/ops/pallas_dcn.py``; its decomposition, shared
with the bf16 forward, is ``csrc/dcn_fwd_common.cuh``: a channels-last x,
pixel tiles of B*H*W, a fixed-order split of the 9*C rows where the tiles
are few, modelled in plain PyTorch by :func:`deform_conv2d_tiled_plain`)
and whose backward launches
the kernels of ``csrc/dcn_bwd.cu`` (which replace the backward of
``deform_conv2d_fast``, ``pallas_dcn.py:409``) around two plain matrix
products, on pixel-major (B, H*W, 9, C) columns and the channels-last copy
of x that the forward made. On the card a kernel launches or the call
raises: nothing falls back to the plain version.

A bfloat16 ``x`` (the mixed-precision model) takes the bf16 kernels: the
forward :func:`dcn_fwd_bf16` (the tensor-core kernel ``csrc/dcn_fwd_bf16.cu``)
and, under autograd, the bf16 instantiations of the ``dcn_bwd.cu`` kernels
(:func:`dcn_im2col_bf16`, :func:`dcn_col2im_bf16`,
:func:`dcn_col2im_coord_bf16`) around two bf16 matrix products. It takes
float32 offset and mask and a bf16 weight and bias, and returns bf16; its
gradients come back in the inputs' dtypes. On the CPU the same Function runs
with the kernels' plain versions, so a bf16 backward there has the card's
decomposition and rounding points. float16 raises everywhere.

Semantics are those of ``centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d``
and of the reference's ``torchvision.ops.deform_conv2d``: offsets in the
torchvision layout (``offset[:, 2k] = dy_k``, ``offset[:, 2k+1] = dx_k``,
taps ``k = 3i + j`` in row-major order), a sigmoided mask, bilinear sampling
in which a corner outside the image contributes zero, no offset clamp.
``max_offset`` clamps dy and dx to ``[-max_offset, max_offset]`` before
sampling, inside the differentiated function, so an offset outside the range
gets a zero gradient; it reproduces the TPU kernels (8 for
``deform_conv2d_pallas`` and ``deform_conv2d_fast``, 1 for
``deform_conv2d_pallas_static``) for tests, and the model leaves it at
``None``.

Every function here, kernel and plain version, takes a row origin
``row0`` (0 by default): offset and mask may hold Ho <= H rows, the
output rows [row0, row0 + Ho) of the op on the whole x, so that a rank of
a height-split layout (``models/layers.py:DeformConvNode``) reads every
row of x and writes its own rows; col2im then takes x's ``height`` and
returns the whole dx. With row0 = 0 and Ho = H it is the op itself.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .cuda_build import load_kernel_library

KERNEL_SOURCE = "dcn_fwd.cu"
BACKWARD_SOURCE = "dcn_bwd.cu"
BF16_SOURCE = "dcn_fwd_bf16.cu"
KERNEL_SOURCES = (KERNEL_SOURCE, BACKWARD_SOURCE, BF16_SOURCE)
# the backward kernels read x channels-last (the copy the forward made),
# their columns pixel-major; tools/compare_kernels.py lays each tree's
# inputs out as that tree's kernels read them
BACKWARD_X_CHANNELS_LAST = True


def _plain_taps(x, offset, mask, max_offset, row0: int = 0):
    """(i, j, tap) for the 9 taps: tap (B, C, Ho*W) = mask * bilinear
    samples of x (B, C, H, W) at the Ho = offset.shape[2] output rows from
    ``row0`` (output row h samples as row row0 + h of the op on the whole
    height)."""
    b, c, h, w = x.shape
    hwo = offset.shape[2] * w
    flat = x.reshape(b, c, h * w)
    off = offset.reshape(b, 9, 2, hwo)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = mask.reshape(b, 9, hwo)
    pos = torch.arange(hwo, device=x.device)
    base_y = (torch.div(pos, w, rounding_mode="floor") + int(row0)).to(
        x.dtype)
    base_x = (pos % w).to(x.dtype)
    for k in range(9):
        i, j = divmod(k, 3)
        py = (base_y + (i - 1)) + off[:, k, 0]
        px = (base_x + (j - 1)) + off[:, k, 1]
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        ly = py - y0
        lx = px - x0
        tap = None
        for cy in (0, 1):
            for cx in (0, 1):
                yy = y0 + cy
                xx = x0 + cx
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
                vals = torch.gather(flat, 2,
                                    idx[:, None, :].expand(b, c, hwo))
                wgt = ((ly if cy else 1 - ly) * (lx if cx else 1 - lx)
                       * valid.to(x.dtype))
                term = vals * wgt[:, None, :]
                tap = term if tap is None else tap + term
        yield i, j, tap * msk[:, k:k + 1]


def deform_conv2d_plain(x, offset, mask, weight, bias=None,
                        max_offset: Optional[float] = None, row0: int = 0):
    """Plain PyTorch DCNv2: flattened-row gathers, then one matmul per tap.

    x (B, C, H, W); offset (B, 18, Ho, W); mask (B, 9, Ho, W); weight
    (O, C, 3, 3); bias (O,) or None. Returns (B, O, Ho, W): output row h is
    row ``row0 + h`` of the op on the whole x (Ho = H and row0 = 0: the
    op itself; a height-sharded node passes its own rows, ``models/
    layers.py``).
    """
    if x.dtype == torch.bfloat16:
        return deform_conv2d_bf16_plain(x, offset, mask, weight, bias,
                                        max_offset, row0)
    b, c, h, w = x.shape
    o = weight.shape[0]
    out = None
    for i, j, tap in _plain_taps(x, offset, mask, max_offset, row0):
        term = torch.matmul(weight[:, :, i, j], tap)  # (B, O, HoW)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, o, offset.shape[2], w)


def deform_conv2d_bf16_plain(x, offset, mask, weight, bias=None,
                             max_offset: Optional[float] = None,
                             row0: int = 0):
    """Plain version of the ``dcn_fwd_bf16`` kernel: bf16 x, weight and
    bias, float32 offset and mask, a bf16 result.

    The float32 taps of :func:`deform_conv2d_plain` from x widened to
    float32, each rounded to bf16 (the rounding of the Pallas kernels
    before their bf16 dot, ``pallas_dcn.py:171``); the bf16 taps and weight
    widened back to float32 and contracted in float32 (a product of two
    bf16 values is exact in float32, so only the order of the sums differs
    from the kernel's tensor cores); the bias added; one rounding to bf16.
    """
    b, c, h, w = x.shape
    o = weight.shape[0]
    wf = weight.float()
    out = None
    for i, j, tap in _plain_taps(x.float(), offset.float(), mask.float(),
                                 max_offset, row0):
        tap = tap.to(torch.bfloat16).float()
        term = torch.matmul(wf[:, :, i, j], tap)  # (B, O, HoW)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()[:, None]
    return out.reshape(b, o, offset.shape[2], w).to(torch.bfloat16)


# The forward kernels' decomposition (csrc/dcn_fwd_common.cuh): a split of
# the groups of input channels where the pixel and output tiles give fewer
# blocks than this (two per SM of an H100's 132)
_FWD_TARGET_BLOCKS = 264
# True runs the forward kernels' in-block overlap variant
# (dcn_fwd_common.cuh: Overlapped) where it fits (not the bf16 256-channel
# tile), for tools/compare_kernels.py --overlap; the bitwise same output
FWD_OVERLAP = False
_VECTOR = {torch.bfloat16: 8, torch.float32: 4}  # channels per 16 bytes


class FwdPlan(NamedTuple):
    """How ``dcn_fwd`` / ``dcn_fwd_bf16`` cut one call: pixel tiles of
    ``tile_p`` pixels of the flattened B*H*W, output tiles of ``tile_o``
    channels, groups of ``group`` input channels (9 * group contraction
    rows, gathered together), ``groups`` of them, walked in ``splits``
    ranges of ``groups_per_split`` whose float32 partials are summed in
    split order."""
    tile_p: int
    tile_o: int
    group: int
    groups: int
    groups_per_split: int
    splits: int


def dcn_fwd_plan(dtype, b: int, c: int, h: int, w: int, o: int) -> FwdPlan:
    """The plan of the forward kernel of ``dtype`` (bf16; anything else is
    the float32 kernel's) for a (B, C, H, W) x and O outputs: the tiles of
    the kernels' engines (bf16: 64 pixels and groups of 32 channels, 128
    pixels where tile_o is 64, groups of 64 where it is 256; float32: 8192
    / tile_o pixels, groups of 16 channels, 32 where tile_o is 256) and,
    where pixel tiles times output tiles are fewer than
    ``_FWD_TARGET_BLOCKS``, as many splits of the groups as reach it, none
    empty."""
    bf16 = dtype == torch.bfloat16
    tile_o = 64 if o <= 64 else 128 if o <= 128 else 256
    if bf16:
        tile_p = 128 if tile_o == 64 else 64
        group = 64 if tile_o == 256 else 32
    else:
        tile_p, group = 8192 // tile_o, 32 if tile_o == 256 else 16
    groups = -(-c // group)
    blocks = -(-(b * h * w) // tile_p) * -(-o // tile_o)
    target = _FWD_TARGET_BLOCKS
    splits = 1 if blocks >= target else min(groups, -(-target // blocks))
    per = -(-groups // splits)
    return FwdPlan(tile_p, tile_o, group, groups, per, -(-groups // per))


def deform_conv2d_tiled_plain(x, offset, mask, weight, bias=None,
                              max_offset: Optional[float] = None,
                              row0: int = 0):
    """Plain model of the forward kernels' decomposition
    (``csrc/dcn_fwd_common.cuh``, :func:`dcn_fwd_plan`): the same function
    as :func:`deform_conv2d_plain` (float32, float64) and
    :func:`deform_conv2d_bf16_plain` (bf16), computed as the kernels cut it.

    x goes channels-last, (B*H*W, C); each pixel tile of the flattened B*H*W
    (tiles straddle images) gathers its taps from 4 corner rows per (pixel,
    tap), weighted by ``mask * wy * wx`` (zero outside the image) and summed
    corner by corner in float32 (float64 for float64 x); bf16 taps are
    rounded once; the 9*C rows (``c*9 + k``, the weight's order) contract in
    the plan's splits, whose partials are summed in split order; then the
    bias and one rounding to x's dtype. Returns (B, O, Ho, W), the
    output rows from ``row0`` (:func:`deform_conv2d_plain`).
    """
    b, c, h, w = x.shape
    o = weight.shape[0]
    ho = offset.shape[2]
    n = b * ho * w
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    plan = dcn_fwd_plan(x.dtype, b, c, ho, w, o)
    xh = x.permute(0, 2, 3, 1).reshape(b * h * w, c).to(acc)
    q, wgt, _ = _plain_corners(offset.to(acc), mask.to(acc), h, w,
                               max_offset, row0)
    images = torch.arange(b, device=x.device)[:, None, None, None] * (h * w)
    rows = (q + images).permute(0, 2, 1, 3).reshape(n, 9, 4)
    wgt = wgt.permute(0, 2, 1, 3).reshape(n, 9, 4)
    wmat = weight.to(acc).reshape(o, 9 * c)
    span = plan.groups_per_split * plan.group
    out = torch.empty((n, o), dtype=acc, device=x.device)
    for p0 in range(0, n, plan.tile_p):
        tile = slice(p0, min(p0 + plan.tile_p, n))
        taps = None
        for corner in range(4):
            term = wgt[tile, :, corner, None] * xh[rows[tile, :, corner]]
            taps = term if taps is None else taps + term
        taps = taps.transpose(1, 2)  # (pixels, C, 9): row c*9 + k
        if x.dtype == torch.bfloat16:
            taps = taps.to(torch.bfloat16).to(acc)
        total = None
        for s in range(plan.splits):
            lo, hi = s * span, min(c, (s + 1) * span)
            part = (taps[:, lo:hi].reshape(taps.shape[0], -1)
                    @ wmat[:, 9 * lo:9 * hi].t())
            total = part if total is None else total + part
        out[tile] = total
    if bias is not None:
        out = out + bias.to(acc)
    return out.view(b, ho, w, o).permute(0, 3, 1, 2).contiguous().to(
        x.dtype)


def dcn_im2col_plain(x, offset, mask, max_offset: Optional[float] = None,
                     row0: int = 0):
    """Plain version of the ``dcn_im2col`` kernel: the modulated sampled
    columns, pixel-major (B, Ho*W, 9, C): ``cols[b, p, k, c]`` is tap k of
    channel c at output pixel p (its row from ``row0``), so that a pixel's
    9*C values (tap-major, channels fastest) are one row of the
    (B*Ho*W, 9C) GEMM operand."""
    taps = [tap for _, _, tap in _plain_taps(x, offset, mask, max_offset,
                                             row0)]
    return torch.stack(taps, dim=1).permute(0, 3, 1, 2).contiguous()


def dcn_col2im_plain(dcols, x, offset, mask,
                     max_offset: Optional[float] = None, row0: int = 0):
    """Plain version of the ``dcn_col2im`` kernel: dx (B, C, H, W) of the
    whole x, the gradient of :func:`dcn_im2col_plain` with respect to x
    for column gradients ``dcols`` (B, Ho*W, 9, C) of the output rows from
    ``row0`` (x only gives the shape: the columns are linear in it)."""
    with torch.enable_grad():
        xs = torch.zeros_like(x).requires_grad_(True)
        cols = dcn_im2col_plain(xs, offset.detach(), mask.detach(),
                                max_offset, row0)
        return torch.autograd.grad(cols, xs, dcols)[0]


def _plain_corners(offset, mask, h, w, max_offset, row0: int = 0):
    """Every (b, k, p, corner) of the sampling as the col2im kernels see it,
    for the Ho = offset.shape[2] output rows from ``row0`` of an x of
    height ``h``: (q, weight, lands), each (B, 9, Ho*W, 4): the corner's
    flat pixel in x's H*W plane (any value where it lies outside),
    ``mask * wy * wx`` in the kernels' order (zero outside), and whether it
    lies in the image with a non-zero weight."""
    b = offset.shape[0]
    hwo = offset.shape[2] * w
    off = offset.reshape(b, 9, 2, hwo)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    pos = torch.arange(hwo, device=offset.device)
    tap = torch.arange(9, device=offset.device)
    row = torch.div(pos, w, rounding_mode="floor")
    base_y = (row[None, :] + int(row0)
              + torch.div(tap, 3, rounding_mode="floor")[:, None]
              - 1).to(offset.dtype)
    base_x = ((pos - row * w)[None, :] + (tap % 3)[:, None] - 1).to(
        offset.dtype)
    py = base_y + off[:, :, 0]
    px = base_x + off[:, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    msk = mask.reshape(b, 9, hwo)
    q, weight, lands = [], [], []
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + cy, x0 + cx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        wgt = (msk * (ly if cy else 1 - ly) * (lx if cx else 1 - lx)
               * inside.to(offset.dtype))
        q.append((yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long())
        weight.append(wgt)
        lands.append(inside & (wgt != 0))
    return (torch.stack(q, -1), torch.stack(weight, -1),
            torch.stack(lands, -1))


def dcn_inverse_map_plain(offset, mask, h: int, w: int,
                          max_offset: Optional[float] = None,
                          row0: int = 0):
    """Plain version of the ``dcn_col2im`` kernels' inverse sampling map:
    (ends, keys, weights) in the kernels' layout, int32, int32 and offset's
    dtype.

    The entries of pixel q of image b of x (height ``h``; segment
    ``bq = b*h*w + q``) are ``[ends[bq-1], ends[bq])`` (from 0 for bq = 0),
    one per tap k and output pixel p (of the Ho = offset.shape[2] output
    rows from ``row0``) whose sample has a corner on q inside the image
    with a non-zero weight ``mask * wy * wx``: the key ``p*9 + k`` (the row
    of the sample's channels in the pixel-major column gradients) in
    increasing order, and the weight.
    """
    b = offset.shape[0]
    hw = h * w
    hwo = offset.shape[2] * w
    q, weight, lands = _plain_corners(offset, mask, h, w, max_offset, row0)
    seg = (torch.arange(b, device=offset.device)[:, None, None, None] * hw
           + q)[lands]
    key = (torch.arange(hwo, device=offset.device)[None, :, None] * 9
           + torch.arange(9, device=offset.device)[:, None, None]).expand(
               b, 9, hwo, 4)[lands]
    order = torch.argsort(seg * (9 * hwo) + key)
    ends = torch.cumsum(torch.bincount(seg, minlength=b * hw), 0)
    return (ends.to(torch.int32), key[order].to(torch.int32),
            weight[lands][order])


def dcn_col2im_gather_plain(dcols, offset, mask, h: int, w: int,
                            max_offset: Optional[float] = None,
                            row0: int = 0):
    """Plain model of the ``dcn_col2im`` kernels' gather: dx (B, C, h, w)
    as the segment sums over :func:`dcn_inverse_map_plain`'s map of
    ``weight * dcols[b, p, k, c]`` (dcols (B, Ho*W, 9, C) of the output
    rows from ``row0``). Sums in float32 (float64 for float64 column
    gradients), one rounding to dcols' dtype."""
    b, _, _, c = dcols.shape
    hw = h * w
    acc = torch.float64 if dcols.dtype == torch.float64 else torch.float32
    ends, keys, weights = dcn_inverse_map_plain(offset, mask, h, w,
                                                max_offset, row0)
    ends, keys = ends.long(), keys.long()
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    seg = torch.repeat_interleave(torch.arange(b * hw, device=dcols.device),
                                  counts)
    bi = torch.div(seg, hw, rounding_mode="floor")
    p = torch.div(keys, 9, rounding_mode="floor")
    k = keys - 9 * p
    g = dcols.to(acc)[bi, p, k]  # (entries, C)
    dx = torch.zeros((b * hw, c), dtype=acc, device=dcols.device)
    dx.index_add_(0, seg, weights.to(acc)[:, None] * g)
    return dx.view(b, h, w, c).permute(0, 3, 1, 2).contiguous().to(
        dcols.dtype)


def dcn_col2im_coord_plain(dcols, x, offset, mask,
                           max_offset: Optional[float] = None,
                           row0: int = 0):
    """Plain version of the ``dcn_col2im_coord`` kernel: (doffset, dmask),
    the gradients of :func:`dcn_im2col_plain` with respect to offset and
    mask for column gradients ``dcols`` (B, Ho*W, 9, C) of the output rows
    from ``row0``."""
    with torch.enable_grad():
        leaves = [offset.detach().requires_grad_(True),
                  mask.detach().requires_grad_(True)]
        cols = dcn_im2col_plain(x.detach(), *leaves, max_offset, row0)
        return tuple(torch.autograd.grad(cols, leaves, dcols))


def deform_conv2d_backward_plain(x, offset, mask, weight, bias, grad_out,
                                 max_offset: Optional[float] = None,
                                 row0: int = 0):
    """Plain backward: (dx, doffset, dmask, dweight, dbias) by autograd of
    :func:`deform_conv2d_plain`; dbias is None when bias is None. The card's
    backward kernels are held against it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, offset, mask, weight)]
        if bias is not None:
            leaves.append(bias.detach().requires_grad_(True))
        out = deform_conv2d_plain(*leaves[:4],
                                  leaves[4] if bias is not None else None,
                                  max_offset=max_offset, row0=row0)
        grads = torch.autograd.grad(out, leaves, grad_out)
    return tuple(grads) + ((None,) if bias is None else ())


def dcn_im2col_bf16_plain(x, offset, mask,
                          max_offset: Optional[float] = None, row0: int = 0):
    """Plain version of the ``dcn_im2col_bf16`` kernel: the float32 columns
    of x widened to float32, each rounded once to bf16 (the taps that
    ``dcn_fwd_bf16`` contracts)."""
    return dcn_im2col_plain(x.float(), offset, mask, max_offset,
                            row0).to(torch.bfloat16)


def dcn_col2im_bf16_plain(dcols, x, offset, mask,
                          max_offset: Optional[float] = None, row0: int = 0):
    """Plain version of the ``dcn_col2im_bf16`` kernel: the float32 dx of
    the widened bf16 column gradients, rounded once to bf16."""
    return dcn_col2im_plain(dcols.float(), x.float(), offset, mask,
                            max_offset, row0).to(torch.bfloat16)


def dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                max_offset: Optional[float] = None,
                                row0: int = 0):
    """Plain version of the ``dcn_col2im_coord_bf16`` kernel: (doffset,
    dmask) in float32 from the widened bf16 column gradients and x."""
    return dcn_col2im_coord_plain(dcols.float(), x.float(), offset, mask,
                                  max_offset, row0)


def deform_conv2d_bf16_backward_plain(x, offset, mask, weight, bias,
                                      grad_out,
                                      max_offset: Optional[float] = None,
                                      row0: int = 0):
    """Plain version of the bf16 backward (:func:`deform_conv2d_backward`
    on a bf16 ``x``): (dx, doffset, dmask, dweight, dbias), dbias None when
    bias is None. The plain bf16 kernels around the two matrix products,
    which run in float32 on the widened bf16 values (a product of two bf16
    values is exact in float32) and are rounded where the card's bf16
    products round: dweight and the column gradients once each."""
    g = grad_out.float()
    cols = dcn_im2col_bf16_plain(x, offset, mask, max_offset, row0).float()
    dweight = weight_gradient(g, cols).to(torch.bfloat16)
    dcols = column_gradients(weight.float(), g).to(torch.bfloat16)
    dx = dcn_col2im_bf16_plain(dcols, x, offset, mask, max_offset, row0)
    doffset, dmask = dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                                 max_offset, row0)
    dbias = (None if bias is None
             else grad_out.float().sum((0, 2, 3)).to(torch.bfloat16))
    return dx, doffset, dmask, dweight, dbias


def deform_conv2d(x, offset, mask, weight, bias=None,
                  max_offset: Optional[float] = None, row0: int = 0):
    """DCNv2 with autograd: the CUDA kernels on the card, the plain version
    on the CPU.

    Same arguments and result as :func:`deform_conv2d_plain`: with offset
    and mask of Ho <= H rows, output row h is row ``row0 + h`` of the op on
    the whole x, and the backward's dx covers the whole x. On CUDA every
    tensor must be contiguous float32 on one device, or bf16 x, weight and
    bias with float32 offset and mask; anything else raises. Without
    autograd every call is one registered operator, ``cfd3d::dcn_fwd`` or
    ``cfd3d::dcn_fwd_bf16``, which picks the kernel or the plain version by
    device when it runs (so a traced or exported graph holds the operator,
    not the choice). Under autograd a float32 (or float64) ``x`` on the CPU
    runs :func:`deform_conv2d_plain`; any other runs ``DeformConv2dFunction``
    (on the CPU with the kernels' plain versions); float16 raises.
    ``deform_conv2d.launches`` counts the float32 forward kernel's
    launches, ``dcn_fwd_bf16.launches`` the bf16 one's; each backward
    kernel's wrapper (``BACKWARD_KERNELS``, ``BACKWARD_KERNELS_BF16``)
    counts its own.
    """
    if x.dtype == torch.float16:
        raise TypeError("deform_conv2d: float16 is not supported; use "
                        "bfloat16 (MIXED_PRECISION) or float32")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"deform_conv2d: no kernel for device {x.device}")
    bf16 = x.dtype == torch.bfloat16
    tensors = (x, offset, mask, weight) + ((bias,) if bias is not None else ())
    row0 = int(row0)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return _forward_op(x)(x, offset, mask, weight, bias, max_offset, row0)
    if x.device.type == "cpu" and not bf16:
        return deform_conv2d_plain(x, offset, mask, weight, bias, max_offset,
                                   row0)
    return DeformConv2dFunction.apply(x, offset, mask, weight, bias,
                                      max_offset, row0)


deform_conv2d.launches = 0


class DeformConv2dFunction(torch.autograd.Function):
    """The forward operator of x's dtype (``cfd3d::dcn_fwd`` or
    ``cfd3d::dcn_fwd_bf16``: the kernel on the card, the plain version on
    the CPU); backward = the ``dcn_bwd.cu`` kernels of that dtype around
    two plain GEMMs, recomputing the columns from the saved inputs.

    The forward reads x channels-last: x itself where it is
    ``torch.channels_last``, else the copy :func:`dcn_fwd_nhwc` makes. The
    Function saves that tensor and the backward kernels read it, so a node
    makes at most one channels-last copy of x for its forward and backward
    together."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset, row0=0):
        xh = dcn_fwd_nhwc(x)
        out = _forward_op(x)(xh, offset, mask, weight, bias, max_offset,
                             row0)
        ctx.save_for_backward(xh, offset, mask, weight)
        ctx.has_bias = bias is not None
        ctx.max_offset = max_offset
        ctx.row0 = row0
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = deform_conv2d_backward(
            x, offset, mask, weight, grad_out, ctx.max_offset,
            need_x=need[0], need_offset=need[1], need_mask=need[2],
            need_weight=need[3], need_bias=ctx.has_bias and need[4],
            row0=ctx.row0)
        return (*grads, None, None)


def deform_conv2d_backward(x, offset, mask, weight, grad_out,
                           max_offset: Optional[float] = None,
                           need_x: bool = True, need_offset: bool = True,
                           need_mask: bool = True, need_weight: bool = True,
                           need_bias: bool = True, row0: int = 0):
    """(dx, doffset, dmask, dweight, dbias) on the card (on CPU tensors the
    kernels' plain versions run); a gradient that is not needed is None and
    costs nothing (dweight alone needs no ``dcn_col2im``/``dcn_col2im_coord``,
    dx alone no ``dcn_im2col``).

    x (B, C, H, W) is read channels-last: ``DeformConv2dFunction`` passes
    the ``torch.channels_last`` copy its forward made; an NCHW x on the card
    gets its copy here, once. dweight = g . cols and dcols = g^T . W are
    plain matrix products (``torch.matmul``), as the JAX package leaves
    them to XLA; the rest are the hand-written kernels, those of x's dtype.
    The columns and column gradients are pixel-major (B, H*W, 9, C), so
    that each product is one GEMM over the B*HW axis, accumulated in
    float32, and col2im and coord read dcols as the GEMM lays it out; in
    bf16 each product is rounded once: dweight and dbias come back bf16
    (the dtypes of the bf16 weight and bias), dx bf16, doffset and dmask
    float32. With ``row0`` (offsets of Ho rows, :func:`deform_conv2d`)
    dx is the whole x's, from this call's output rows alone.
    """
    if x.device.type == "cuda" and (need_weight or need_offset or need_mask):
        x = dcn_fwd_nhwc(x)
    if x.dtype == torch.bfloat16:
        im2col, col2im, coord = (dcn_im2col_bf16, dcn_col2im_bf16,
                                 dcn_col2im_coord_bf16)
    else:
        im2col, col2im, coord = dcn_im2col, dcn_col2im, dcn_col2im_coord
    dx = doffset = dmask = dweight = dbias = None
    if need_weight:
        cols = im2col(x, offset, mask, max_offset, row0)
        dweight = weight_gradient(grad_out, cols)
        del cols
    if need_x or need_offset or need_mask:
        dcols = column_gradients(weight, grad_out)
        if need_x:
            dx = col2im(dcols, offset, mask, max_offset, row0, x.shape[2])
        if need_offset or need_mask:
            doffset, dmask = coord(dcols, x, offset, mask, max_offset, row0)
            doffset = doffset if need_offset else None
            dmask = dmask if need_mask else None
    if need_bias:
        dbias = grad_out.sum((0, 2, 3), dtype=torch.float32).to(
            grad_out.dtype)
    return dx, doffset, dmask, dweight, dbias


def weight_gradient(grad_out, cols):
    """dweight (O, C, 3, 3) from the output gradient (B, O, H, W) and the
    pixel-major columns (B, H*W, 9, C): g . cols, one GEMM over the B*HW
    axis giving (O, 9C) in (k, c) order, laid out as the weight."""
    b, o, h, w = grad_out.shape
    c = cols.shape[-1]
    dw = torch.matmul(_batch_inner_grad(grad_out),
                      cols.reshape(b * h * w, 9 * c))
    return dw.view(o, 3, 3, c).permute(0, 3, 1, 2).contiguous()


def column_gradients(weight, grad_out):
    """dcols (B, H*W, 9, C), pixel-major, of a node with weight
    (O, C, 3, 3) and output gradient (B, O, H, W): g^T . W_kc, one GEMM
    over the B*HW axis that writes the layout directly (W_kc, the weight as
    (O, 9C) in (k, c) order, is a copy of 9*C*O values)."""
    b, o, h, w = grad_out.shape
    c = weight.shape[1]
    w_kc = weight.permute(0, 2, 3, 1).reshape(o, 9 * c)
    return torch.matmul(_batch_inner_grad(grad_out).t(), w_kc).view(
        b, h * w, 9, c)


def _batch_inner_grad(grad_out):
    """(B, O, H, W) -> (O, B*H*W): the GEMM operand over the B*HW axis."""
    b, o, h, w = grad_out.shape
    return grad_out.transpose(0, 1).reshape(o, b * h * w)


def dcn_im2col(x, offset, mask, max_offset: Optional[float] = None,
               row0: int = 0):
    """The ``dcn_im2col`` kernel: pixel-major (B, Ho*W, 9, C) columns of
    the Ho = offset.shape[2] output rows from ``row0``, as
    :func:`dcn_im2col_plain` (which runs instead on CPU tensors). The
    kernel reads x channels-last: a ``torch.channels_last`` x as it is, an
    NCHW one through its copy (:func:`dcn_fwd_nhwc`).
    ``dcn_im2col.launches`` counts launches."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, offset, mask, max_offset, row0)
    cols = _im2col("cfd_dcn_im2col", torch.float32, x, offset, mask,
                   max_offset, row0)
    dcn_im2col.launches += 1
    return cols


def dcn_col2im(dcols, offset, mask, max_offset: Optional[float] = None,
               row0: int = 0, height: Optional[int] = None):
    """The ``dcn_col2im`` kernels: dx (B, C, height, W) from the column
    gradients (B, Ho*W, 9, C) of the output rows from ``row0`` (height:
    x's, offset's Ho by default), a gather through the inverse sampling map
    (:func:`dcn_inverse_map`), as :func:`dcn_col2im_plain` (which runs
    instead on CPU tensors). ``dcn_col2im.launches`` counts calls."""
    if dcols.device.type == "cpu":
        return dcn_col2im_plain(dcols, _like_x(dcols, offset, height), offset,
                                mask, max_offset, row0)
    dx = _col2im("cfd_dcn_col2im", torch.float32, dcols, offset, mask,
                 max_offset, row0, height)
    dcn_col2im.launches += 1
    return dx


def dcn_inverse_map(offset, mask, max_offset: Optional[float] = None,
                    row0: int = 0, height: Optional[int] = None):
    """(ends, keys, weights) of the ``dcn_col2im`` kernels' inverse sampling
    map, as :func:`dcn_inverse_map_plain` (which runs instead on CPU
    tensors); keys and weights cut to the entries used. The map is what the
    col2im wrappers build before their gather; this entry returns it for
    tests and reports. ``dcn_inverse_map.launches`` counts calls."""
    _, _, ho, w = offset.shape
    h = ho if height is None else int(height)
    if offset.device.type == "cpu":
        return dcn_inverse_map_plain(offset, mask, h, w, max_offset, row0)
    _require_cuda(offset)
    _check_offset_mask(offset, mask, max_offset)
    _check_rows(h, ho, row0)
    _, ends, entries, _ = _inverse_map(offset, mask, max_offset, row0, h)
    dcn_inverse_map.launches += 1
    entries = entries[:int(ends[-1])]
    return (ends, entries[:, 0].contiguous(),
            entries[:, 1].contiguous().view(torch.float32))


dcn_inverse_map.launches = 0


def dcn_col2im_coord(dcols, x, offset, mask,
                     max_offset: Optional[float] = None, row0: int = 0):
    """The ``dcn_col2im_coord`` kernel: (doffset (B, 18, Ho, W), dmask
    (B, 9, Ho, W)) from the column gradients (B, Ho*W, 9, C) of the output
    rows from ``row0`` and the saved inputs, x read channels-last as
    :func:`dcn_im2col` reads it; as :func:`dcn_col2im_coord_plain` (which
    runs instead on CPU tensors). ``dcn_col2im_coord.launches`` counts
    launches."""
    if x.device.type == "cpu":
        return dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset,
                                      row0)
    out = _coord("cfd_dcn_col2im_coord", torch.float32, dcols, x, offset,
                 mask, max_offset, row0)
    dcn_col2im_coord.launches += 1
    return out


dcn_im2col.launches = 0
dcn_col2im.launches = 0
dcn_col2im_coord.launches = 0
BACKWARD_KERNELS = {"dcn_im2col": dcn_im2col, "dcn_col2im": dcn_col2im,
                    "dcn_col2im_coord": dcn_col2im_coord}


def dcn_im2col_bf16(x, offset, mask, max_offset: Optional[float] = None,
                    row0: int = 0):
    """The ``dcn_im2col_bf16`` kernel: bf16 columns of a bf16 x, as
    :func:`dcn_im2col` in float32 and :func:`dcn_im2col_bf16_plain` (which
    runs instead on CPU tensors). ``dcn_im2col_bf16.launches`` counts
    launches."""
    if x.device.type == "cpu":
        return dcn_im2col_bf16_plain(x, offset, mask, max_offset, row0)
    cols = _im2col("cfd_dcn_im2col_bf16", torch.bfloat16, x, offset, mask,
                   max_offset, row0)
    dcn_im2col_bf16.launches += 1
    return cols


def dcn_col2im_bf16(dcols, offset, mask, max_offset: Optional[float] = None,
                    row0: int = 0, height: Optional[int] = None):
    """The ``dcn_col2im_bf16`` kernels: bf16 dx (B, C, H, W) from bf16
    column gradients (B, H*W, 9, C), the gather of :func:`dcn_col2im` summed
    in float32 registers and rounded once; as :func:`dcn_col2im_bf16_plain`
    (which runs instead on CPU tensors). ``dcn_col2im_bf16.launches``
    counts calls."""
    if dcols.device.type == "cpu":
        return dcn_col2im_bf16_plain(dcols, _like_x(dcols, offset, height),
                                     offset, mask, max_offset, row0)
    dx = _col2im("cfd_dcn_col2im_bf16", torch.bfloat16, dcols, offset, mask,
                 max_offset, row0, height)
    dcn_col2im_bf16.launches += 1
    return dx


def dcn_col2im_coord_bf16(dcols, x, offset, mask,
                          max_offset: Optional[float] = None, row0: int = 0):
    """The ``dcn_col2im_coord_bf16`` kernel: float32 (doffset, dmask) from
    bf16 column gradients and a bf16 x, as :func:`dcn_col2im_coord_bf16_plain`
    (which runs instead on CPU tensors). ``dcn_col2im_coord_bf16.launches``
    counts launches."""
    if x.device.type == "cpu":
        return dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                           max_offset, row0)
    out = _coord("cfd_dcn_col2im_coord_bf16", torch.bfloat16, dcols, x,
                 offset, mask, max_offset, row0)
    dcn_col2im_coord_bf16.launches += 1
    return out


dcn_im2col_bf16.launches = 0
dcn_col2im_bf16.launches = 0
dcn_col2im_coord_bf16.launches = 0
BACKWARD_KERNELS_BF16 = {"dcn_im2col_bf16": dcn_im2col_bf16,
                         "dcn_col2im_bf16": dcn_col2im_bf16,
                         "dcn_col2im_coord_bf16": dcn_col2im_coord_bf16}


def _im2col(name, dtype, x, offset, mask, max_offset, row0=0):
    """Launches im2col kernel ``name`` on an x of ``dtype`` (read
    channels-last): columns (B, Ho*W, 9, C) of ``dtype``."""
    _require_cuda(x)
    b, c, h, w = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype,
                                 channels_last=True, row0=row0)
    ho = offset.shape[2]
    xh = dcn_fwd_nhwc(x)
    cols = torch.empty((b, ho * w, 9, c), device=x.device, dtype=dtype)
    _run(x, name, xh.data_ptr(), offset.data_ptr(), mask.data_ptr(),
         cols.data_ptr(), b, c, h, w, ho, int(row0), _vec(c, xh, cols),
         _clamp(max_offset))
    return cols


def _vec(c: int, *tensors) -> int:
    """1 where the kernels may move C channels as 16-byte vectors: C a
    multiple of the vector and every tensor 16-byte aligned; else 0 (the
    element-wise path)."""
    return int(c % _VECTOR[tensors[0].dtype] == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


# blocks of the kernels that sort and sum the long segments of col2im's map
# (a sorting block keeps a bitmap of the 9*H*W keys in ``bits``)
_LONG_BLOCKS = 132
# entries of the map per pixel at most: 9 taps x 4 corners
_MAX_ENTRIES = 36
# pixels per block of the map's prefix sum (kScanTile of csrc/dcn_bwd.cu)
_SCAN_TILE = 4096


def _check_offset_mask(offset, mask, max_offset):
    """Checks float32 offset (B, 18, Ho, W) and mask (B, 9, Ho, W) on one
    device, and max_offset; returns (B, Ho, W)."""
    b, _, h, w = _check(offset, "offset", 4)
    if tuple(offset.shape) != (b, 18, h, w):
        raise ValueError(f"offset must be ({b}, 18, {h}, {w}), got "
                         f"{tuple(offset.shape)}")
    if tuple(_check(mask, "mask", 4)) != (b, 9, h, w):
        raise ValueError(f"mask must be ({b}, 9, {h}, {w}), got "
                         f"{tuple(mask.shape)}")
    if mask.device != offset.device:
        raise ValueError("deform_conv2d: all tensors must be on one device")
    if max_offset is not None and not float(max_offset) >= 0:
        raise ValueError(f"max_offset must be >= 0 or None, got {max_offset}")
    return b, h, w


def _inverse_map(offset, mask, max_offset, row0=0, height=None):
    """Launches the map kernels of col2im (count, the prefix sum, fill and
    sort) for the output rows from ``row0`` that offset (B, 18, Ho, W)
    holds, over an x of ``height`` rows (Ho by default); returns (count,
    ends, entries, long_q) on offset's device, int32: count and ends have a
    segment a pixel of x (count one more), entries (36*B*Ho*W, 2) holds
    the map's {key, float32 weight bits} pairs at its start, count[-1] the
    number of segments longer than a warp sorts, listed in long_q."""
    b, _, ho, w = offset.shape
    h = ho if height is None else int(height)
    n = b * h * w
    n_out = b * ho * w
    if _MAX_ENTRIES * max(n, n_out) >= 2 ** 31:
        raise ValueError(f"dcn_col2im: {b}x{h}x{w} pixels overflow the "
                         "map's int32 keys and slots")
    dev = offset.device
    count = torch.empty(n + 1, device=dev, dtype=torch.int32)
    ends = torch.empty(n, device=dev, dtype=torch.int32)
    sums = torch.empty(-(-n // _SCAN_TILE), device=dev, dtype=torch.int32)
    _run(offset, "cfd_dcn_col2im_count", offset.data_ptr(), mask.data_ptr(),
         count.data_ptr(), ends.data_ptr(), sums.data_ptr(), b, h, w, ho,
         int(row0), _clamp(max_offset))
    entries = torch.empty((_MAX_ENTRIES * n_out, 2), device=dev,
                          dtype=torch.int32)
    long_q = torch.empty(n, device=dev, dtype=torch.int32)
    bits = torch.empty(_LONG_BLOCKS * ((9 * ho * w + 31) // 32), device=dev,
                       dtype=torch.int32)
    _run(offset, "cfd_dcn_col2im_fill", offset.data_ptr(), mask.data_ptr(),
         count.data_ptr(), ends.data_ptr(), entries.data_ptr(),
         long_q.data_ptr(), bits.data_ptr(), b, h, w, ho, int(row0),
         _LONG_BLOCKS, _clamp(max_offset))
    return count, ends, entries, long_q


def _col2im(name, dtype, dcols, offset, mask, max_offset, row0=0,
            height=None):
    """Builds the map and launches col2im ``name`` (the gathers) on column
    gradients of ``dtype`` of the output rows from ``row0``: dx
    (B, C, height, W) of ``dtype`` (height Ho by default). The gather reads
    rows of C rounded up to 32 channels, 16-byte aligned: dcols as the GEMM
    wrote it where C is a multiple of 32 (every model node), else a padded
    copy."""
    _require_cuda(dcols)
    b, c, ho, w = _check_columns(dcols, offset, mask, max_offset, dtype)
    h = ho if height is None else int(height)
    _check_rows(h, ho, row0)
    count, ends, entries, long_q = _inverse_map(offset, mask, max_offset,
                                                row0, h)
    if c % 32 or dcols.data_ptr() % 16:
        padded = dcols.new_zeros((b, ho * w, 9, -(-c // 32) * 32))
        padded[..., :c] = dcols
        dcols = padded
    dx = torch.empty((b, c, h, w), device=dcols.device, dtype=dtype)
    _run(dcols, name, dcols.data_ptr(), count.data_ptr(), ends.data_ptr(),
         entries.data_ptr(), long_q.data_ptr(), dx.data_ptr(), b, c, h, w,
         ho, _LONG_BLOCKS)
    return dx


def _coord(name, dtype, dcols, x, offset, mask, max_offset, row0=0):
    """Launches col2im_coord kernel ``name`` on column gradients and x of
    ``dtype`` (x read channels-last): float32 (doffset, dmask)."""
    _require_cuda(x)
    b, c, h, w = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype,
                                 channels_last=True, row0=row0)
    ho = offset.shape[2]
    if _check_columns(dcols, offset, mask, max_offset, dtype) != (b, c, ho,
                                                                   w):
        raise ValueError(f"dcols must be ({b}, {ho * w}, 9, {c}), got "
                         f"{tuple(dcols.shape)}")
    xh = dcn_fwd_nhwc(x)
    doffset = torch.empty_like(offset)
    dmask = torch.empty_like(mask)
    _run(x, name, dcols.data_ptr(), xh.data_ptr(), offset.data_ptr(),
         mask.data_ptr(), doffset.data_ptr(), dmask.data_ptr(), b, c, h, w,
         ho, int(row0), _vec(c, xh, dcols), _clamp(max_offset))
    return doffset, dmask


def _like_x(dcols, offset, height=None):
    """An empty x (B, C, height, W) (height: offset's Ho by default) for
    the plain col2im, which takes only its shape."""
    ho, w = offset.shape[2:]
    return dcols.new_empty((dcols.shape[0], dcols.shape[3],
                            ho if height is None else int(height), w))


def dcn_fwd_bf16(x, offset, mask, weight, bias=None,
                 max_offset: Optional[float] = None, row0: int = 0):
    """The ``dcn_fwd_bf16`` kernel: the DCNv2 forward in bf16 on the tensor
    cores, as :func:`deform_conv2d_bf16_plain` (which runs instead on CPU
    tensors).

    x (B, C, H, W) bf16, contiguous or ``torch.channels_last`` (read as it
    is; an NCHW x gets its channels-last copy, :func:`dcn_fwd_nhwc`);
    offset (B, 18, Ho, W) and mask (B, 9, Ho, W) float32 (Ho = H, or the
    output rows from ``row0``: :func:`deform_conv2d`); weight (O, C, 3, 3)
    bf16; bias (O,) bf16 or None; the rest contiguous, all on one device.
    Returns (B, O, Ho, W) bf16. It records no gradient: under grad mode it
    takes no tensor that requires grad (:func:`deform_conv2d` routes those
    through ``DeformConv2dFunction``). ``dcn_fwd_bf16.launches`` counts
    calls: the copy, the kernel and the reduction of a split are one.
    """
    o = _check_forward(x, offset, mask, weight, bias, max_offset,
                       torch.bfloat16, row0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        raise RuntimeError("deform_conv2d: dcn_fwd_bf16 records no "
                           "gradient; call deform_conv2d")
    if x.device.type == "cpu":
        return deform_conv2d_bf16_plain(x, offset, mask, weight, bias,
                                        max_offset, row0)
    out = _forward("cfd_dcn_fwd_bf16", x, offset, mask, weight, bias, o,
                   max_offset, row0)
    dcn_fwd_bf16.launches += 1
    return out


dcn_fwd_bf16.launches = 0


def _check_forward(x, offset, mask, weight, bias, max_offset,
                   dtype, row0=0) -> int:
    """Checks a forward's arguments: x (contiguous or channels-last), weight
    and bias of ``dtype``, float32 offset and mask, shapes, the rows,
    contiguity and one device; returns O."""
    _, c, _, _ = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype,
                                 channels_last=True, row0=row0)
    o = _check(weight, "weight", 4, dtype)[0]
    if tuple(weight.shape) != (o, c, 3, 3):
        raise ValueError(f"weight must be ({o}, {c}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    tensors = [weight]
    if bias is not None:
        if tuple(_check(bias, "bias", 1, dtype)) != (o,):
            raise ValueError(f"bias must be ({o},), got {tuple(bias.shape)}")
        tensors.append(bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("deform_conv2d: all tensors must be on one device")
    return o


def _launch(x, offset, mask, weight, bias, max_offset, row0=0):
    """The ``dcn_fwd`` kernel, without autograd: under grad mode it takes
    no tensor that requires grad (``DeformConv2dFunction`` calls it, and
    autograd runs a Function's forward with grad mode off)."""
    o = _check_forward(x, offset, mask, weight, bias, max_offset,
                       torch.float32, row0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        raise RuntimeError("deform_conv2d: _launch records no gradient; "
                           "call deform_conv2d")

    out = _forward("cfd_dcn_fwd", x, offset, mask, weight, bias, o,
                   max_offset, row0)
    deform_conv2d.launches += 1
    return out


# The forward kernels as operators (``torch.library``): the CUDA
# implementation launches the kernel (and counts the launch), the CPU one is
# the plain version, so the device is chosen where the operator runs; an
# exported program (``runtime/export.py``) holds these nodes and launches the
# kernels wherever it is loaded with this module imported.


@torch.library.custom_op("cfd3d::dcn_fwd", mutates_args=(),
                         device_types="cuda")
def dcn_fwd_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, bias: Optional[torch.Tensor],
               max_offset: Optional[float], row0: int = 0) -> torch.Tensor:
    """``cfd3d::dcn_fwd``: the ``dcn_fwd`` kernel (:func:`_launch`) on the
    card, :func:`deform_conv2d_plain` on the CPU (float32 or float64).
    ``row0`` has a default, so that a program exported before it existed
    still loads and runs."""
    return _launch(*_kernel_layouts(x, offset, mask, weight, bias),
                   max_offset, row0)


@torch.library.custom_op("cfd3d::dcn_fwd_bf16", mutates_args=(),
                         device_types="cuda")
def dcn_fwd_bf16_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, bias: Optional[torch.Tensor],
                    max_offset: Optional[float],
                    row0: int = 0) -> torch.Tensor:
    """``cfd3d::dcn_fwd_bf16``: the ``dcn_fwd_bf16`` kernel on the card,
    :func:`deform_conv2d_bf16_plain` on the CPU."""
    return dcn_fwd_bf16(*_kernel_layouts(x, offset, mask, weight, bias),
                        max_offset, row0)


def _kernel_layouts(x, offset, mask, weight, bias):
    """The operator's tensors in the layouts the kernels read: x contiguous
    or channels-last as it comes, the rest contiguous (no copy where they
    are). An exported program's tensors on the card need not have the
    strides its tracing saw: one handed the operator a mask that was not
    contiguous."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous()
    return (x, offset.contiguous(), mask.contiguous(), weight.contiguous(),
            None if bias is None else bias.contiguous())


@dcn_fwd_op.register_kernel("cpu")
def _dcn_fwd_cpu(x, offset, mask, weight, bias, max_offset, row0=0):
    return deform_conv2d_plain(x, offset, mask, weight, bias, max_offset,
                               row0)


@dcn_fwd_bf16_op.register_kernel("cpu")
def _dcn_fwd_bf16_cpu(x, offset, mask, weight, bias, max_offset, row0=0):
    # the kernel's wrapper: its argument checks, then the plain version
    return dcn_fwd_bf16(x, offset, mask, weight, bias, max_offset, row0)


@dcn_fwd_op.register_fake
def _dcn_fwd_fake(x, offset, mask, weight, bias, max_offset, row0=0):
    b, _, ho, w = offset.shape
    return x.new_empty((b, weight.shape[0], ho, w))


dcn_fwd_bf16_op.register_fake(_dcn_fwd_fake)


@register_flop_formula([torch.ops.cfd3d.dcn_fwd, torch.ops.cfd3d.dcn_fwd_bf16])
def _dcn_fwd_flops(x_shape, offset_shape, mask_shape, weight_shape, *args,
                   **kwargs) -> int:
    """The contraction's multiply-adds, 2 * B*Ho*W * O * 9C (Ho the
    offset's rows), as ``FlopCounterMode`` counts the plain version's nine
    matmuls."""
    b, c, _, w = x_shape
    return 2 * b * offset_shape[2] * w * weight_shape[0] * 9 * c


def _forward_op(x):
    """The forward operator of x's dtype."""
    return (torch.ops.cfd3d.dcn_fwd_bf16 if x.dtype == torch.bfloat16
            else torch.ops.cfd3d.dcn_fwd)


def dcn_fwd_nhwc(x):
    """x (B, C, H, W) as the forward kernels read it: channels-last
    (``torch.channels_last`` strides). x itself where it is already
    channels-last; else the copy by the ``dcn_fwd_nhwc`` /
    ``dcn_fwd_bf16_nhwc`` kernel of x's dtype (a plain copy on the CPU)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return x
    if x.device.type == "cpu":
        return x.contiguous(memory_format=torch.channels_last)
    _require_cuda(x)
    b, c, h, w = x.shape
    xh = torch.empty_like(x, memory_format=torch.channels_last)
    name = ("cfd_dcn_fwd_bf16_nhwc" if x.dtype == torch.bfloat16
            else "cfd_dcn_fwd_nhwc")
    _run(x, name, x.data_ptr(), xh.data_ptr(), b, c, h * w)
    return xh


def _forward(name, x, offset, mask, weight, bias, o, max_offset, row0=0):
    """Launches forward kernel ``name`` (``cfd_dcn_fwd`` or
    ``cfd_dcn_fwd_bf16``) on checked arguments: one entry point that makes
    x's channels-last copy where x is NCHW (the ``dcn_fwd_nhwc`` kernels),
    runs the kernel on the Ho output rows from ``row0`` and sums the
    float32 partials of :func:`dcn_fwd_plan`'s split."""
    _require_cuda(x)
    b, c, h, w = x.shape
    ho = offset.shape[2]
    plan = dcn_fwd_plan(x.dtype, b, c, ho, w, o)
    xh = (None if x.is_contiguous(memory_format=torch.channels_last)
          else torch.empty_like(x, memory_format=torch.channels_last))
    out = torch.empty((b, o, ho, w), device=x.device, dtype=x.dtype)
    partial = (torch.empty((plan.splits, o, b * ho * w), device=x.device,
                           dtype=torch.float32)
               if plan.splits > 1 else None)
    vec = _vec(c, x if xh is None else xh, weight)
    overlap = int(FWD_OVERLAP and (x.dtype != torch.bfloat16
                                   or plan.tile_o <= 128))
    _run(x, name, x.data_ptr(), xh.data_ptr() if xh is not None else None,
         offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
         bias.data_ptr() if bias is not None else None, out.data_ptr(),
         partial.data_ptr() if partial is not None else None,
         b, c, h, w, ho, int(row0), o, plan.tile_p, plan.tile_o, plan.group,
         plan.splits, vec, overlap, _clamp(max_offset))
    return out


def _check(t, name: str, ndim: int, dtype=torch.float32,
           channels_last: bool = False):
    if t.dtype != dtype:
        raise TypeError(f"deform_conv2d: {name} must be "
                        f"{str(dtype)[6:]}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"deform_conv2d: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not (t.is_contiguous() or channels_last and t.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError(f"deform_conv2d: {name} must be contiguous"
                         + (" or channels-last" if channels_last else ""))
    return t.shape


def _check_sampling(x, offset, mask, max_offset, x_dtype=torch.float32,
                    channels_last: bool = False, row0: int = 0):
    """Checks x (of ``x_dtype``; channels-last too where ``channels_last``)
    against offset and mask (:func:`_check_offset_mask`) and their rows
    from ``row0`` (:func:`_check_rows`); returns (B, C, H, W)."""
    b, c, h, w = _check(x, "x", 4, x_dtype, channels_last)
    ob, ho, ow = _check_offset_mask(offset, mask, max_offset)
    if (ob, ow) != (b, w):
        raise ValueError(f"offset must be ({b}, 18, {h}, {w}), got "
                         f"{tuple(offset.shape)}")
    _check_rows(h, ho, row0)
    if offset.device != x.device:
        raise ValueError("deform_conv2d: all tensors must be on one device")
    return b, c, h, w


def _check_rows(h: int, ho: int, row0: int) -> None:
    """Output rows [row0, row0 + ho) must lie inside x's h rows."""
    if not (0 <= int(row0) and int(row0) + ho <= h and ho > 0):
        raise ValueError(f"deform_conv2d: output rows [{row0}, "
                         f"{int(row0) + ho}) must lie inside x's {h} rows")


def _check_columns(dcols, offset, mask, max_offset, dtype=torch.float32):
    """Checks contiguous (B, H*W, 9, C) column gradients of ``dtype``
    against offset and mask (:func:`_check_offset_mask`); returns
    (B, C, H, W)."""
    if dcols.dtype != dtype:
        raise TypeError(f"deform_conv2d: dcols must be {str(dtype)[6:]}, "
                        f"got {dcols.dtype}")
    if dcols.dim() != 4 or dcols.shape[2] != 9:
        raise ValueError(f"deform_conv2d: dcols must be (B, H*W, 9, C), got "
                         f"{tuple(dcols.shape)}")
    if not dcols.is_contiguous():
        raise ValueError("deform_conv2d: dcols must be contiguous")
    b, hw, _, c = dcols.shape
    if (offset.dim() != 4 or offset.shape[0] != b
            or hw != offset.shape[2] * offset.shape[3]):
        raise ValueError(f"dcols {tuple(dcols.shape)} does not match offset "
                         f"{tuple(offset.shape)}")
    _, h, w = _check_offset_mask(offset, mask, max_offset)
    if offset.device != dcols.device:
        raise ValueError("deform_conv2d: all tensors must be on one device")
    return b, c, h, w


def _require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"deform_conv2d: no kernel for device {t.device}")


def _clamp(max_offset) -> float:
    return -1.0 if max_offset is None else float(max_offset)


# C signatures: pointer arguments, then the int arguments, then the float
# clamp (where the entry point takes one) and the stream
_SIGNATURES = {
    "cfd_dcn_fwd": (KERNEL_SOURCE, 8, 13, 1),
    "cfd_dcn_fwd_nhwc": (KERNEL_SOURCE, 2, 3, 0),
    "cfd_dcn_fwd_bf16": (BF16_SOURCE, 8, 13, 1),
    "cfd_dcn_fwd_bf16_nhwc": (BF16_SOURCE, 2, 3, 0),
    "cfd_dcn_im2col": (BACKWARD_SOURCE, 4, 7, 1),
    "cfd_dcn_col2im_count": (BACKWARD_SOURCE, 5, 5, 1),
    "cfd_dcn_col2im_fill": (BACKWARD_SOURCE, 7, 6, 1),
    "cfd_dcn_col2im": (BACKWARD_SOURCE, 6, 6, 0),
    "cfd_dcn_col2im_coord": (BACKWARD_SOURCE, 6, 7, 1),
    "cfd_dcn_im2col_bf16": (BACKWARD_SOURCE, 4, 7, 1),
    "cfd_dcn_col2im_bf16": (BACKWARD_SOURCE, 6, 6, 0),
    "cfd_dcn_col2im_coord_bf16": (BACKWARD_SOURCE, 6, 7, 1),
}


_ENTRIES = {}  # name -> the loaded ctypes function, argument types set


def _entry(name: str):
    """The C entry point ``name``, built (once) and loaded."""
    fn = _ENTRIES.get(name)
    if fn is None:
        source, n_ptr, n_int, n_float = _SIGNATURES[name]
        fn = getattr(load_kernel_library(source).lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        _ENTRIES[name] = fn
    return fn


def _run(like, name: str, *args) -> None:
    """Calls the C entry point ``name`` on the current stream of ``like``'s
    device; raises on a launch error."""
    fn = _entry(name)
    if like.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(like.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
