"""Modulated 3x3 stride-1 deformable convolution (DCNv2), NCHW.

The op of every ``DeformConvNode`` and the one kernel of the serving path.
``deform_conv2d`` is the entry point: on a CPU tensor it runs the plain
PyTorch version, ``deform_conv2d_plain``; on a CUDA tensor it launches the
hand-written CUDA kernel ``csrc/dcn_fwd.cu`` (which replaces the Pallas
kernels of ``centerfusiondetect3d_tpu/ops/pallas_dcn.py``) or raises. It
never falls back from the card to the plain version.

Semantics are those of ``centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d``
and of the reference's ``torchvision.ops.deform_conv2d``: offsets in the
torchvision layout (``offset[:, 2k] = dy_k``, ``offset[:, 2k+1] = dx_k``,
taps ``k = 3i + j`` in row-major order), a sigmoided mask, bilinear sampling
in which a corner outside the image contributes zero, no offset clamp.
``max_offset`` clamps dy and dx to ``[-max_offset, max_offset]`` before
sampling; it reproduces the TPU kernels (8 for ``deform_conv2d_pallas``, 1
for ``deform_conv2d_pallas_static``) for tests, and the serving path leaves
it at ``None``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import load_kernel_library

KERNEL_SOURCE = "dcn_fwd.cu"


def deform_conv2d_plain(x, offset, mask, weight, bias=None,
                        max_offset: Optional[float] = None):
    """Plain PyTorch DCNv2: flattened-row gathers, then one matmul per tap.

    x (B, C, H, W); offset (B, 18, H, W); mask (B, 9, H, W); weight
    (O, C, 3, 3); bias (O,) or None. Returns (B, O, H, W).
    """
    b, c, h, w = x.shape
    o = weight.shape[0]
    hw = h * w
    flat = x.reshape(b, c, hw)
    off = offset.reshape(b, 9, 2, hw)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = mask.reshape(b, 9, hw)
    pos = torch.arange(hw, device=x.device)
    base_y = torch.div(pos, w, rounding_mode="floor").to(x.dtype)
    base_x = (pos % w).to(x.dtype)

    out = None
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
        tap = tap * msk[:, k:k + 1]
        term = torch.matmul(weight[:, :, i, j], tap)  # (B, O, HW)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, o, h, w)


def deform_conv2d(x, offset, mask, weight, bias=None,
                  max_offset: Optional[float] = None):
    """DCNv2 forward: the CUDA kernel on the card, the plain version on CPU.

    Same arguments and result as :func:`deform_conv2d_plain`. On CUDA every
    tensor must be contiguous float32 on one device; anything else raises.
    ``deform_conv2d.launches`` counts the kernel's launches.
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias, max_offset)
    if x.device.type != "cuda":
        raise RuntimeError(f"deform_conv2d: no kernel for device {x.device}")
    return _launch(x, offset, mask, weight, bias, max_offset)


deform_conv2d.launches = 0


def _launch(x, offset, mask, weight, bias, max_offset):
    b, c, h, w = _check(x, "x", 4)
    o = _check(weight, "weight", 4)[0]
    if tuple(weight.shape) != (o, c, 3, 3):
        raise ValueError(f"weight must be ({o}, {c}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if tuple(_check(offset, "offset", 4)) != (b, 18, h, w):
        raise ValueError(f"offset must be ({b}, 18, {h}, {w}), got "
                         f"{tuple(offset.shape)}")
    if tuple(_check(mask, "mask", 4)) != (b, 9, h, w):
        raise ValueError(f"mask must be ({b}, 9, {h}, {w}), got "
                         f"{tuple(mask.shape)}")
    tensors = [offset, mask, weight]
    if bias is not None:
        if tuple(_check(bias, "bias", 1)) != (o,):
            raise ValueError(f"bias must be ({o},), got {tuple(bias.shape)}")
        tensors.append(bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("deform_conv2d: all tensors must be on one device")
    if max_offset is not None and not float(max_offset) >= 0:
        raise ValueError(f"max_offset must be >= 0 or None, got {max_offset}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *tensors]):
        raise RuntimeError("deform_conv2d: the CUDA kernel has no backward "
                           "yet; call it under torch.no_grad()")

    lib = _kernel()
    # (O, C, 3, 3) -> (C, 3, 3, O): each chunk's weight rows are contiguous
    wt = weight.permute(1, 2, 3, 0).contiguous()
    out = torch.empty((b, o, h, w), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cfd_dcn_fwd(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wt.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, c, h, w, o,
            -1.0 if max_offset is None else float(max_offset), stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd kernel launch failed: CUDA error {err}")
    deform_conv2d.launches += 1
    return out


def _check(t, name: str, ndim: int):
    if t.dtype != torch.float32:
        raise TypeError(f"deform_conv2d: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"deform_conv2d: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"deform_conv2d: {name} must be contiguous")
    return t.shape


def _kernel():
    built = load_kernel_library(KERNEL_SOURCE)
    fn = built.lib.cfd_dcn_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    return built.lib
