"""Modulated 3x3 stride-1 deformable convolution (DCNv2), NCHW, with autograd.

The op of every ``DeformConvNode``. ``deform_conv2d`` is the entry point: on
a float32 or float64 CPU tensor it runs the plain PyTorch version,
``deform_conv2d_plain``, and autograd differentiates that; on a CUDA tensor it runs ``DeformConv2dFunction``,
whose forward launches the hand-written kernel ``csrc/dcn_fwd.cu`` (which
replaces the Pallas forward kernels of
``centerfusiondetect3d_tpu/ops/pallas_dcn.py``) and whose backward launches
the kernels of ``csrc/dcn_bwd.cu`` (which replace the backward of
``deform_conv2d_fast``, ``pallas_dcn.py:409``) around two plain matrix
products. On the card a kernel launches or the call raises: nothing falls
back to the plain version.

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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import load_kernel_library

KERNEL_SOURCE = "dcn_fwd.cu"
BACKWARD_SOURCE = "dcn_bwd.cu"
BF16_SOURCE = "dcn_fwd_bf16.cu"
KERNEL_SOURCES = (KERNEL_SOURCE, BACKWARD_SOURCE, BF16_SOURCE)


def _plain_taps(x, offset, mask, max_offset):
    """(i, j, tap) for the 9 taps: tap (B, C, HW) = mask * bilinear samples."""
    b, c, h, w = x.shape
    hw = h * w
    flat = x.reshape(b, c, hw)
    off = offset.reshape(b, 9, 2, hw)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = mask.reshape(b, 9, hw)
    pos = torch.arange(hw, device=x.device)
    base_y = torch.div(pos, w, rounding_mode="floor").to(x.dtype)
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
                vals = torch.gather(flat, 2, idx[:, None, :].expand(b, c, hw))
                wgt = ((ly if cy else 1 - ly) * (lx if cx else 1 - lx)
                       * valid.to(x.dtype))
                term = vals * wgt[:, None, :]
                tap = term if tap is None else tap + term
        yield i, j, tap * msk[:, k:k + 1]


def deform_conv2d_plain(x, offset, mask, weight, bias=None,
                        max_offset: Optional[float] = None):
    """Plain PyTorch DCNv2: flattened-row gathers, then one matmul per tap.

    x (B, C, H, W); offset (B, 18, H, W); mask (B, 9, H, W); weight
    (O, C, 3, 3); bias (O,) or None. Returns (B, O, H, W).
    """
    if x.dtype == torch.bfloat16:
        return deform_conv2d_bf16_plain(x, offset, mask, weight, bias,
                                        max_offset)
    b, c, h, w = x.shape
    o = weight.shape[0]
    out = None
    for i, j, tap in _plain_taps(x, offset, mask, max_offset):
        term = torch.matmul(weight[:, :, i, j], tap)  # (B, O, HW)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, o, h, w)


def deform_conv2d_bf16_plain(x, offset, mask, weight, bias=None,
                             max_offset: Optional[float] = None):
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
                                 max_offset):
        tap = tap.to(torch.bfloat16).float()
        term = torch.matmul(wf[:, :, i, j], tap)  # (B, O, HW)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()[:, None]
    return out.reshape(b, o, h, w).to(torch.bfloat16)


def dcn_im2col_plain(x, offset, mask, max_offset: Optional[float] = None):
    """Plain version of the ``dcn_im2col`` kernel: the modulated sampled
    columns (B, 9C, H*W), row ``c*9 + k``, the row order of
    ``weight.reshape(O, 9C)``."""
    b, c, h, w = x.shape
    taps = [tap for _, _, tap in _plain_taps(x, offset, mask, max_offset)]
    return torch.stack(taps, dim=2).reshape(b, 9 * c, h * w)


def dcn_col2im_plain(dcols, x, offset, mask,
                     max_offset: Optional[float] = None):
    """Plain version of the ``dcn_col2im`` kernel: dx, the gradient of
    :func:`dcn_im2col_plain` with respect to x for column gradients
    ``dcols`` (x only gives the shape: the columns are linear in it)."""
    with torch.enable_grad():
        xs = torch.zeros_like(x).requires_grad_(True)
        cols = dcn_im2col_plain(xs, offset.detach(), mask.detach(),
                                max_offset)
        return torch.autograd.grad(cols, xs, dcols)[0]


def _plain_corners(offset, mask, h, w, max_offset):
    """Every (b, k, p, corner) of the sampling as the col2im kernels see it:
    (q, weight, lands), each (B, 9, H*W, 4): the corner's flat pixel (any
    value where it lies outside), ``mask * wy * wx`` in the kernels' order
    (zero outside), and whether it lies in the image with a non-zero
    weight."""
    b = offset.shape[0]
    hw = h * w
    off = offset.reshape(b, 9, 2, hw)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    pos = torch.arange(hw, device=offset.device)
    tap = torch.arange(9, device=offset.device)
    row = torch.div(pos, w, rounding_mode="floor")
    base_y = (row[None, :] + torch.div(tap, 3, rounding_mode="floor")[:, None]
              - 1).to(offset.dtype)
    base_x = ((pos - row * w)[None, :] + (tap % 3)[:, None] - 1).to(
        offset.dtype)
    py = base_y + off[:, :, 0]
    px = base_x + off[:, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    msk = mask.reshape(b, 9, hw)
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
                          max_offset: Optional[float] = None):
    """Plain version of the ``dcn_col2im`` kernels' inverse sampling map:
    (ends, keys, weights) in the kernels' layout, int32, int32 and offset's
    dtype.

    The entries of pixel q of image b (segment ``bq = b*H*W + q``) are
    ``[ends[bq-1], ends[bq])`` (from 0 for bq = 0), one per tap k and output
    pixel p whose sample has a corner on q inside the image with a non-zero
    weight ``mask * wy * wx``: the key ``p*9 + k`` (the row of the sample's
    channels in the kernels' transposed columns) in increasing order, and
    the weight.
    """
    b = offset.shape[0]
    hw = h * w
    q, weight, lands = _plain_corners(offset, mask, h, w, max_offset)
    seg = (torch.arange(b, device=offset.device)[:, None, None, None] * hw
           + q)[lands]
    key = (torch.arange(hw, device=offset.device)[None, :, None] * 9
           + torch.arange(9, device=offset.device)[:, None, None]).expand(
               b, 9, hw, 4)[lands]
    order = torch.argsort(seg * (9 * hw) + key)
    ends = torch.cumsum(torch.bincount(seg, minlength=b * hw), 0)
    return (ends.to(torch.int32), key[order].to(torch.int32),
            weight[lands][order])


def dcn_col2im_gather_plain(dcols, offset, mask, h: int, w: int,
                            max_offset: Optional[float] = None):
    """Plain model of the ``dcn_col2im`` kernels' gather: dx (B, C, H, W)
    as the segment sums over :func:`dcn_inverse_map_plain`'s map of
    ``weight * dcols[b, c*9+k, p]``. Sums in float32 (float64 for float64
    column gradients), one rounding to dcols' dtype."""
    b, rows, hw = dcols.shape
    c = rows // 9
    acc = torch.float64 if dcols.dtype == torch.float64 else torch.float32
    ends, keys, weights = dcn_inverse_map_plain(offset, mask, h, w,
                                                max_offset)
    ends, keys = ends.long(), keys.long()
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    seg = torch.repeat_interleave(torch.arange(b * hw, device=dcols.device),
                                  counts)
    bi = torch.div(seg, hw, rounding_mode="floor")
    p = torch.div(keys, 9, rounding_mode="floor")
    k = keys - 9 * p
    g = dcols.to(acc).reshape(b, c, 9, hw)[bi, :, k, p]  # (entries, C)
    dx = torch.zeros((b * hw, c), dtype=acc, device=dcols.device)
    dx.index_add_(0, seg, weights.to(acc)[:, None] * g)
    return dx.view(b, h, w, c).permute(0, 3, 1, 2).contiguous().to(
        dcols.dtype)


def dcn_col2im_coord_plain(dcols, x, offset, mask,
                           max_offset: Optional[float] = None):
    """Plain version of the ``dcn_col2im_coord`` kernel: (doffset, dmask),
    the gradients of :func:`dcn_im2col_plain` with respect to offset and
    mask for column gradients ``dcols``."""
    with torch.enable_grad():
        leaves = [offset.detach().requires_grad_(True),
                  mask.detach().requires_grad_(True)]
        cols = dcn_im2col_plain(x.detach(), *leaves, max_offset)
        return tuple(torch.autograd.grad(cols, leaves, dcols))


def deform_conv2d_backward_plain(x, offset, mask, weight, bias, grad_out,
                                 max_offset: Optional[float] = None):
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
                                  max_offset=max_offset)
        grads = torch.autograd.grad(out, leaves, grad_out)
    return tuple(grads) + ((None,) if bias is None else ())


def dcn_im2col_bf16_plain(x, offset, mask,
                          max_offset: Optional[float] = None):
    """Plain version of the ``dcn_im2col_bf16`` kernel: the float32 columns
    of x widened to float32, each rounded once to bf16 (the taps that
    ``dcn_fwd_bf16`` contracts)."""
    return dcn_im2col_plain(x.float(), offset, mask,
                            max_offset).to(torch.bfloat16)


def dcn_col2im_bf16_plain(dcols, x, offset, mask,
                          max_offset: Optional[float] = None):
    """Plain version of the ``dcn_col2im_bf16`` kernel: the float32 dx of
    the widened bf16 column gradients, rounded once to bf16."""
    return dcn_col2im_plain(dcols.float(), x.float(), offset, mask,
                            max_offset).to(torch.bfloat16)


def dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                max_offset: Optional[float] = None):
    """Plain version of the ``dcn_col2im_coord_bf16`` kernel: (doffset,
    dmask) in float32 from the widened bf16 column gradients and x."""
    return dcn_col2im_coord_plain(dcols.float(), x.float(), offset, mask,
                                  max_offset)


def deform_conv2d_bf16_backward_plain(x, offset, mask, weight, bias,
                                      grad_out,
                                      max_offset: Optional[float] = None):
    """Plain version of the bf16 backward (:func:`deform_conv2d_backward`
    on a bf16 ``x``): (dx, doffset, dmask, dweight, dbias), dbias None when
    bias is None. The plain bf16 kernels around the two matrix products,
    which run in float32 on the widened bf16 values (a product of two bf16
    values is exact in float32) and are rounded where the card's bf16
    products round: dweight and the column gradients once each."""
    b, c, h, w = x.shape
    o = weight.shape[0]
    g = grad_out.float().reshape(b, o, h * w)
    cols = dcn_im2col_bf16_plain(x, offset, mask, max_offset).float()
    dweight = torch.matmul(g, cols.transpose(1, 2)).sum(0)
    dweight = dweight.view(o, c, 3, 3).to(torch.bfloat16)
    dcols = torch.matmul(weight.float().reshape(o, 9 * c).t(),
                         g).to(torch.bfloat16)
    dx = dcn_col2im_bf16_plain(dcols, x, offset, mask, max_offset)
    doffset, dmask = dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                                 max_offset)
    dbias = (None if bias is None
             else grad_out.float().sum((0, 2, 3)).to(torch.bfloat16))
    return dx, doffset, dmask, dweight, dbias


def deform_conv2d(x, offset, mask, weight, bias=None,
                  max_offset: Optional[float] = None):
    """DCNv2 with autograd: the CUDA kernels on the card, the plain version
    on the CPU.

    Same arguments and result as :func:`deform_conv2d_plain`. On CUDA every
    tensor must be contiguous float32 on one device, or bf16 x, weight and
    bias with float32 offset and mask; anything else raises. A float32
    ``x`` on the CPU runs :func:`deform_conv2d_plain` under autograd; a bf16
    ``x`` runs ``DeformConv2dFunction`` on either device (on the CPU with
    the kernels' plain versions); float16 raises.
    ``deform_conv2d.launches`` counts the float32 forward kernel's
    launches, ``dcn_fwd_bf16.launches`` the bf16 one's; each backward
    kernel's wrapper (``BACKWARD_KERNELS``, ``BACKWARD_KERNELS_BF16``)
    counts its own.
    """
    if x.dtype == torch.float16:
        raise TypeError("deform_conv2d: float16 is not supported; use "
                        "bfloat16 (MIXED_PRECISION) or float32")
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu" and not bf16:
        return deform_conv2d_plain(x, offset, mask, weight, bias, max_offset)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"deform_conv2d: no kernel for device {x.device}")
    tensors = (x, offset, mask, weight) + ((bias,) if bias is not None else ())
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        forward = dcn_fwd_bf16 if bf16 else _launch
        return forward(x, offset, mask, weight, bias, max_offset)
    return DeformConv2dFunction.apply(x, offset, mask, weight, bias,
                                      max_offset)


deform_conv2d.launches = 0


class DeformConv2dFunction(torch.autograd.Function):
    """The forward kernel of x's dtype (``dcn_fwd`` or ``dcn_fwd_bf16``);
    backward = the ``dcn_bwd.cu`` kernels of that dtype around two plain
    GEMMs, recomputing the columns from the saved inputs."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset):
        forward = dcn_fwd_bf16 if x.dtype == torch.bfloat16 else _launch
        out = forward(x, offset, mask, weight, bias, max_offset)
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.has_bias = bias is not None
        ctx.max_offset = max_offset
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = deform_conv2d_backward(
            x, offset, mask, weight, grad_out, ctx.max_offset,
            need_x=need[0], need_offset=need[1], need_mask=need[2],
            need_weight=need[3], need_bias=ctx.has_bias and need[4])
        return (*grads, None)


def deform_conv2d_backward(x, offset, mask, weight, grad_out,
                           max_offset: Optional[float] = None,
                           need_x: bool = True, need_offset: bool = True,
                           need_mask: bool = True, need_weight: bool = True,
                           need_bias: bool = True):
    """(dx, doffset, dmask, dweight, dbias) on the card (on CPU tensors the
    kernels' plain versions run); a gradient that is not needed is None and
    costs nothing (dweight alone needs no ``dcn_col2im``/``dcn_col2im_coord``,
    dx alone no ``dcn_im2col``).

    dweight = sum_b g_b . cols_b^T and dcols = W^T . g are plain matrix
    products (``torch.matmul``), as the JAX package leaves them to XLA; the
    rest are the hand-written kernels, those of x's dtype. The columns lie
    (9C, B, HW), so that each product is one GEMM over the B*HW axis,
    accumulated in float32; in bf16 each is rounded once: dweight and dbias
    come back bf16 (the dtypes of the bf16 weight and bias), dx bf16,
    doffset and dmask float32.
    """
    o, c = weight.shape[:2]
    if x.dtype == torch.bfloat16:
        im2col, col2im, coord = (dcn_im2col_bf16, dcn_col2im_bf16,
                                 dcn_col2im_coord_bf16)
    else:
        im2col, col2im, coord = dcn_im2col, dcn_col2im, dcn_col2im_coord
    dx = doffset = dmask = dweight = dbias = None
    if need_weight:
        cols = im2col(x, offset, mask, max_offset)
        dweight = weight_gradient(grad_out, cols).view(o, c, 3, 3)
        del cols
    if need_x or need_offset or need_mask:
        dcols = column_gradients(weight, grad_out)
        if need_x:
            dx = col2im(dcols, offset, mask, max_offset)
        if need_offset or need_mask:
            doffset, dmask = coord(dcols, x, offset, mask, max_offset)
            doffset = doffset if need_offset else None
            dmask = dmask if need_mask else None
    if need_bias:
        dbias = grad_out.sum((0, 2, 3), dtype=torch.float32).to(
            grad_out.dtype)
    return dx, doffset, dmask, dweight, dbias


def weight_gradient(grad_out, cols):
    """dweight = sum_b g_b . cols_b^T, (O, 9C), from the output gradient
    (B, O, H, W) and the columns (B, 9C, H*W): one GEMM over the B*HW axis
    (a view of the kernels' columns, which lie (9C, B, H*W) in memory)."""
    b, o, h, w = grad_out.shape
    return torch.matmul(_batch_inner_grad(grad_out),
                        cols.transpose(0, 1).reshape(-1, b * h * w).t())


def column_gradients(weight, grad_out):
    """dcols = W^T . g, the column gradients (B, 9C, H*W) of a node with
    weight (O, C, 3, 3) and output gradient (B, O, H, W): one GEMM over the
    B*HW axis, lying (9C, B, H*W) in memory."""
    b, o, h, w = grad_out.shape
    dcols = torch.matmul(weight.reshape(o, -1).t(),
                         _batch_inner_grad(grad_out))
    return dcols.view(-1, b, h * w).transpose(0, 1)


def _batch_inner_grad(grad_out):
    """(B, O, H, W) -> (O, B*H*W): the GEMM operand over the B*HW axis."""
    b, o, h, w = grad_out.shape
    return grad_out.transpose(0, 1).reshape(o, b * h * w)


def dcn_im2col(x, offset, mask, max_offset: Optional[float] = None):
    """The ``dcn_im2col`` kernel: (B, 9C, H*W) columns lying (9C, B, H*W)
    in memory, as :func:`dcn_im2col_plain` (which runs instead on CPU
    tensors). ``dcn_im2col.launches`` counts launches."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, offset, mask, max_offset)
    cols = _im2col("cfd_dcn_im2col", torch.float32, x, offset, mask,
                   max_offset)
    dcn_im2col.launches += 1
    return cols


def dcn_col2im(dcols, offset, mask, max_offset: Optional[float] = None):
    """The ``dcn_col2im`` kernels: dx (B, C, H, W) from the column gradients
    (B, 9C, H*W), a gather through the inverse sampling map
    (:func:`dcn_inverse_map`), as :func:`dcn_col2im_plain` (which runs
    instead on CPU tensors). ``dcn_col2im.launches`` counts calls."""
    if dcols.device.type == "cpu":
        return dcn_col2im_plain(dcols, _like_x(dcols, offset), offset, mask,
                                max_offset)
    dx = _col2im("cfd_dcn_col2im", torch.float32, dcols, offset, mask,
                 max_offset)
    dcn_col2im.launches += 1
    return dx


def dcn_inverse_map(offset, mask, max_offset: Optional[float] = None):
    """(ends, keys, weights) of the ``dcn_col2im`` kernels' inverse sampling
    map, as :func:`dcn_inverse_map_plain` (which runs instead on CPU
    tensors); keys and weights cut to the entries used. The map is what the
    col2im wrappers build before their gather; this entry returns it for
    tests and reports. ``dcn_inverse_map.launches`` counts calls."""
    _, _, h, w = offset.shape
    if offset.device.type == "cpu":
        return dcn_inverse_map_plain(offset, mask, h, w, max_offset)
    _require_cuda(offset)
    _check_offset_mask(offset, mask, max_offset)
    _, ends, entries, _ = _inverse_map(offset, mask, max_offset)
    dcn_inverse_map.launches += 1
    entries = entries[:int(ends[-1])]
    return (ends, entries[:, 0].contiguous(),
            entries[:, 1].contiguous().view(torch.float32))


dcn_inverse_map.launches = 0


def dcn_col2im_coord(dcols, x, offset, mask,
                     max_offset: Optional[float] = None):
    """The ``dcn_col2im_coord`` kernel: (doffset (B, 18, H, W), dmask
    (B, 9, H, W)) from the column gradients and the saved inputs, as
    :func:`dcn_col2im_coord_plain` (which runs instead on CPU tensors).
    ``dcn_col2im_coord.launches`` counts launches."""
    if x.device.type == "cpu":
        return dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset)
    out = _coord("cfd_dcn_col2im_coord", torch.float32, dcols, x, offset,
                 mask, max_offset)
    dcn_col2im_coord.launches += 1
    return out


dcn_im2col.launches = 0
dcn_col2im.launches = 0
dcn_col2im_coord.launches = 0
BACKWARD_KERNELS = {"dcn_im2col": dcn_im2col, "dcn_col2im": dcn_col2im,
                    "dcn_col2im_coord": dcn_col2im_coord}


def dcn_im2col_bf16(x, offset, mask, max_offset: Optional[float] = None):
    """The ``dcn_im2col_bf16`` kernel: bf16 columns of a bf16 x, as
    :func:`dcn_im2col` in float32 and :func:`dcn_im2col_bf16_plain` (which
    runs instead on CPU tensors). ``dcn_im2col_bf16.launches`` counts
    launches."""
    if x.device.type == "cpu":
        return dcn_im2col_bf16_plain(x, offset, mask, max_offset)
    cols = _im2col("cfd_dcn_im2col_bf16", torch.bfloat16, x, offset, mask,
                   max_offset)
    dcn_im2col_bf16.launches += 1
    return cols


def dcn_col2im_bf16(dcols, offset, mask, max_offset: Optional[float] = None):
    """The ``dcn_col2im_bf16`` kernels: bf16 dx (B, C, H, W) from bf16
    column gradients (B, 9C, H*W), the gather of :func:`dcn_col2im` summed
    in float32 registers and rounded once; as :func:`dcn_col2im_bf16_plain`
    (which runs instead on CPU tensors). ``dcn_col2im_bf16.launches``
    counts calls."""
    if dcols.device.type == "cpu":
        return dcn_col2im_bf16_plain(dcols, _like_x(dcols, offset), offset,
                                     mask, max_offset)
    dx = _col2im("cfd_dcn_col2im_bf16", torch.bfloat16, dcols, offset, mask,
                 max_offset)
    dcn_col2im_bf16.launches += 1
    return dx


def dcn_col2im_coord_bf16(dcols, x, offset, mask,
                          max_offset: Optional[float] = None):
    """The ``dcn_col2im_coord_bf16`` kernel: float32 (doffset, dmask) from
    bf16 column gradients and a bf16 x, as :func:`dcn_col2im_coord_bf16_plain`
    (which runs instead on CPU tensors). ``dcn_col2im_coord_bf16.launches``
    counts launches."""
    if x.device.type == "cpu":
        return dcn_col2im_coord_bf16_plain(dcols, x, offset, mask,
                                           max_offset)
    out = _coord("cfd_dcn_col2im_coord_bf16", torch.bfloat16, dcols, x,
                 offset, mask, max_offset)
    dcn_col2im_coord_bf16.launches += 1
    return out


dcn_im2col_bf16.launches = 0
dcn_col2im_bf16.launches = 0
dcn_col2im_coord_bf16.launches = 0
BACKWARD_KERNELS_BF16 = {"dcn_im2col_bf16": dcn_im2col_bf16,
                         "dcn_col2im_bf16": dcn_col2im_bf16,
                         "dcn_col2im_coord_bf16": dcn_col2im_coord_bf16}


def _im2col(name, dtype, x, offset, mask, max_offset):
    """Launches im2col kernel ``name`` on an x of ``dtype``: columns
    (B, 9C, H*W) of ``dtype``, lying (9C, B, H*W) in memory."""
    _require_cuda(x)
    b, c, h, w = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype)
    cols = torch.empty((9 * c, b, h * w), device=x.device,
                       dtype=dtype).transpose(0, 1)
    _run(x, name, x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
         cols.data_ptr(), b, c, h, w, *cols.stride()[:2], _clamp(max_offset))
    return cols


# blocks of the kernels that sort and sum the long segments of col2im's map
# (a sorting block keeps a bitmap of the 9*H*W keys in ``bits``)
_LONG_BLOCKS = 132
# entries of the map per pixel at most: 9 taps x 4 corners
_MAX_ENTRIES = 36
# pixels per block of the map's prefix sum (kScanTile of csrc/dcn_bwd.cu)
_SCAN_TILE = 4096


def _check_offset_mask(offset, mask, max_offset):
    """Checks float32 offset (B, 18, H, W) and mask (B, 9, H, W) on one
    device, and max_offset; returns (B, H, W)."""
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


def _inverse_map(offset, mask, max_offset):
    """Launches the map kernels of col2im (count, the prefix sum, fill and
    sort); returns (count, ends, entries, long_q) on offset's device,
    int32: entries (36*B*H*W, 2) holds the map's {key, float32 weight bits}
    pairs at its start, count[-1] the number of segments longer than a warp
    sorts, listed in long_q."""
    b, _, h, w = offset.shape
    n = b * h * w
    if _MAX_ENTRIES * n >= 2 ** 31:
        raise ValueError(f"dcn_col2im: {b}x{h}x{w} pixels overflow the "
                         "map's int32 keys and slots")
    dev = offset.device
    count = torch.empty(n + 1, device=dev, dtype=torch.int32)
    ends = torch.empty(n, device=dev, dtype=torch.int32)
    sums = torch.empty(-(-n // _SCAN_TILE), device=dev, dtype=torch.int32)
    _run(offset, "cfd_dcn_col2im_count", offset.data_ptr(), mask.data_ptr(),
         count.data_ptr(), ends.data_ptr(), sums.data_ptr(), b, h, w,
         _clamp(max_offset))
    entries = torch.empty((_MAX_ENTRIES * n, 2), device=dev,
                          dtype=torch.int32)
    long_q = torch.empty(n, device=dev, dtype=torch.int32)
    bits = torch.empty(_LONG_BLOCKS * ((9 * h * w + 31) // 32), device=dev,
                       dtype=torch.int32)
    _run(offset, "cfd_dcn_col2im_fill", offset.data_ptr(), mask.data_ptr(),
         count.data_ptr(), ends.data_ptr(), entries.data_ptr(),
         long_q.data_ptr(), bits.data_ptr(), b, h, w, _LONG_BLOCKS,
         _clamp(max_offset))
    return count, ends, entries, long_q


def _col2im(name, dtype, dcols, offset, mask, max_offset):
    """Builds the map and launches col2im ``name`` (the transpose of the
    column gradients into a (B, H*W, 9, C rounded up to 32) scratch, then
    the gather) on column gradients of ``dtype``: dx (B, C, H, W) of
    ``dtype``."""
    _require_cuda(dcols)
    b, c, h, w = _check_columns(dcols, offset, mask, max_offset, dtype)
    count, ends, entries, long_q = _inverse_map(offset, mask, max_offset)
    dcols_t = torch.empty((b, h * w, 9, -(-c // 32) * 32),
                          device=dcols.device, dtype=dtype)
    dx = torch.empty((b, c, h, w), device=dcols.device, dtype=dtype)
    _run(dcols, name, dcols.data_ptr(), count.data_ptr(), ends.data_ptr(),
         entries.data_ptr(), long_q.data_ptr(), dcols_t.data_ptr(),
         dx.data_ptr(), b, c, h, w, _LONG_BLOCKS, *dcols.stride()[:2])
    return dx


def _coord(name, dtype, dcols, x, offset, mask, max_offset):
    """Launches col2im_coord kernel ``name`` on column gradients and x of
    ``dtype``: float32 (doffset, dmask)."""
    _require_cuda(x)
    b, c, h, w = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype)
    if _check_columns(dcols, offset, mask, max_offset, dtype) != (b, c, h, w):
        raise ValueError(f"dcols must be ({b}, {9 * c}, {h * w}), got "
                         f"{tuple(dcols.shape)}")
    doffset = torch.empty_like(offset)
    dmask = torch.empty_like(mask)
    _run(x, name, dcols.data_ptr(), x.data_ptr(), offset.data_ptr(),
         mask.data_ptr(), doffset.data_ptr(), dmask.data_ptr(), b, c, h, w,
         *dcols.stride()[:2], _clamp(max_offset))
    return doffset, dmask


def _like_x(dcols, offset):
    """An empty x (B, C, H, W) for the plain col2im, which takes only its
    shape."""
    b, rows, _ = dcols.shape
    return dcols.new_empty((b, rows // 9) + tuple(offset.shape[2:]))


def dcn_fwd_bf16(x, offset, mask, weight, bias=None,
                 max_offset: Optional[float] = None):
    """The ``dcn_fwd_bf16`` kernel: the DCNv2 forward in bf16 on the tensor
    cores, as :func:`deform_conv2d_bf16_plain` (which runs instead on CPU
    tensors).

    x (B, C, H, W) bf16; offset (B, 18, H, W) and mask (B, 9, H, W)
    float32; weight (O, C, 3, 3) bf16; bias (O,) bf16 or None; all
    contiguous on one device. Returns (B, O, H, W) bf16. It records no
    gradient: under grad mode it takes no tensor that requires grad
    (:func:`deform_conv2d` routes those through ``DeformConv2dFunction``).
    ``dcn_fwd_bf16.launches`` counts launches.
    """
    o = _check_forward(x, offset, mask, weight, bias, max_offset,
                       torch.bfloat16)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        raise RuntimeError("deform_conv2d: dcn_fwd_bf16 records no "
                           "gradient; call deform_conv2d")
    if x.device.type == "cpu":
        return deform_conv2d_bf16_plain(x, offset, mask, weight, bias,
                                        max_offset)
    _require_cuda(x)
    b, c, h, w = x.shape
    wt = weight.permute(1, 2, 3, 0).contiguous()  # (C, 3, 3, O)
    out = torch.empty((b, o, h, w), device=x.device, dtype=torch.bfloat16)
    _run(x, "cfd_dcn_fwd_bf16", x.data_ptr(), offset.data_ptr(),
         mask.data_ptr(), wt.data_ptr(),
         bias.data_ptr() if bias is not None else None, out.data_ptr(),
         b, c, h, w, o, _clamp(max_offset))
    dcn_fwd_bf16.launches += 1
    return out


dcn_fwd_bf16.launches = 0


def _check_forward(x, offset, mask, weight, bias, max_offset,
                   dtype) -> int:
    """Checks a forward's arguments: x, weight and bias of ``dtype``,
    float32 offset and mask, shapes, contiguity and one device; returns O."""
    _, c, _, _ = _check_sampling(x, offset, mask, max_offset, x_dtype=dtype)
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


def _launch(x, offset, mask, weight, bias, max_offset):
    """The ``dcn_fwd`` kernel, without autograd: under grad mode it takes
    no tensor that requires grad (``DeformConv2dFunction`` calls it, and
    autograd runs a Function's forward with grad mode off)."""
    o = _check_forward(x, offset, mask, weight, bias, max_offset,
                       torch.float32)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        raise RuntimeError("deform_conv2d: _launch records no gradient; "
                           "call deform_conv2d")

    b, c, h, w = x.shape
    # (O, C, 3, 3) -> (C, 3, 3, O): each chunk's weight rows are contiguous
    wt = weight.permute(1, 2, 3, 0).contiguous()
    out = torch.empty((b, o, h, w), device=x.device, dtype=x.dtype)
    _run(x, "cfd_dcn_fwd", x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
         wt.data_ptr(), bias.data_ptr() if bias is not None else None,
         out.data_ptr(), b, c, h, w, o, _clamp(max_offset))
    deform_conv2d.launches += 1
    return out


def _check(t, name: str, ndim: int, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"deform_conv2d: {name} must be "
                        f"{str(dtype)[6:]}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"deform_conv2d: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"deform_conv2d: {name} must be contiguous")
    return t.shape


def _check_sampling(x, offset, mask, max_offset, x_dtype=torch.float32):
    """Checks x (of ``x_dtype``) against offset and mask
    (:func:`_check_offset_mask`); returns (B, C, H, W)."""
    b, c, h, w = _check(x, "x", 4, x_dtype)
    if _check_offset_mask(offset, mask, max_offset) != (b, h, w):
        raise ValueError(f"offset must be ({b}, 18, {h}, {w}), got "
                         f"{tuple(offset.shape)}")
    if offset.device != x.device:
        raise ValueError("deform_conv2d: all tensors must be on one device")
    return b, c, h, w


def _check_columns(dcols, offset, mask, max_offset, dtype=torch.float32):
    """Checks (B, 9C, H*W) column gradients of ``dtype`` against offset and
    mask (:func:`_check_offset_mask`): any strides over B and the rows (the
    kernels take them), the pixels contiguous; returns (B, C, H, W)."""
    if dcols.dtype != dtype:
        raise TypeError(f"deform_conv2d: dcols must be {str(dtype)[6:]}, "
                        f"got {dcols.dtype}")
    if dcols.dim() != 3:
        raise ValueError(f"deform_conv2d: dcols must be 3-D, got "
                         f"{tuple(dcols.shape)}")
    b, rows, hw = dcols.shape
    if hw > 1 and dcols.stride(2) != 1:
        raise ValueError("deform_conv2d: the pixels of dcols must be "
                         "contiguous")
    if (rows % 9 or offset.dim() != 4 or offset.shape[0] != b
            or hw != offset.shape[2] * offset.shape[3]):
        raise ValueError(f"dcols {tuple(dcols.shape)} does not match offset "
                         f"{tuple(offset.shape)}")
    _, h, w = _check_offset_mask(offset, mask, max_offset)
    if offset.device != dcols.device:
        raise ValueError("deform_conv2d: all tensors must be on one device")
    return b, rows // 9, h, w


def _require_cuda(t) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"deform_conv2d: no kernel for device {t.device}")


def _clamp(max_offset) -> float:
    return -1.0 if max_offset is None else float(max_offset)


# C signatures: pointer arguments, then the int shape arguments, then the
# int64 column strides (stride_b, stride_row), then the float clamp (where
# the entry point takes one) and the stream
_SIGNATURES = {
    "cfd_dcn_fwd": (KERNEL_SOURCE, 6, 5, 0, 1),
    "cfd_dcn_fwd_bf16": (BF16_SOURCE, 6, 5, 0, 1),
    "cfd_dcn_im2col": (BACKWARD_SOURCE, 4, 4, 2, 1),
    "cfd_dcn_col2im_count": (BACKWARD_SOURCE, 5, 3, 0, 1),
    "cfd_dcn_col2im_fill": (BACKWARD_SOURCE, 7, 4, 0, 1),
    "cfd_dcn_col2im": (BACKWARD_SOURCE, 7, 5, 2, 0),
    "cfd_dcn_col2im_coord": (BACKWARD_SOURCE, 6, 4, 2, 1),
    "cfd_dcn_im2col_bf16": (BACKWARD_SOURCE, 4, 4, 2, 1),
    "cfd_dcn_col2im_bf16": (BACKWARD_SOURCE, 7, 5, 2, 0),
    "cfd_dcn_col2im_coord_bf16": (BACKWARD_SOURCE, 6, 4, 2, 1),
}


def _run(like, name: str, *args) -> None:
    """Builds (once) and calls the C entry point ``name`` on the current
    stream of ``like``'s device; raises on a launch error."""
    source, n_ptr, n_int, n_stride, n_float = _SIGNATURES[name]
    fn = getattr(load_kernel_library(source).lib, name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_int64] * n_stride
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
