"""Bilinear affine warp of uint8 HWC frames: a CUDA kernel and its plain
version.

Serving warps each camera frame to the network input
(``runtime/detector.py:_warp_or_crop``). On the CPU that stays
``data/transforms.py:warp_image`` (numpy, bitwise the JAX package's
``cv2.warpAffine``). On the card the decoded frames stay on the device and
:func:`warp_affine` writes the input batch there with
``csrc/warp_affine.cu`` (built by ``ops/cuda_build.py`` at the first
launch): one launch for up to ``MAX_IMAGES`` frames of any sizes into
outputs of one size, each frame with its own matrix. It replaces no TPU
kernel (the JAX package warps on the host with cv2).

:func:`warp_affine_plain` is the kernel's plain version, ``warp_image``'s
arithmetic in torch: the inverse affine in float32 (:func:`inverse_matrices`,
``data/transforms.py:_invert_affine``), each destination pixel's source
point a fused multiply-add along its row, the bilinear weights its
fractions, the two lerps along x and the one along y fused multiply-adds,
rounded half to even and clamped to 0-255; a neighbour outside the image
reads 0. It emulates each fused multiply-add in float64 (exact product,
then two roundings) where the kernel's ``fmaf`` rounds once: the two can
differ by one level in a rare tie, which the smoke and the card tests
count (none seen so far).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, and never goes through numpy.
``warp_affine.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Union

import numpy as np
import torch

from ..data.transforms import _invert_affine
from .cuda_build import load_kernel_library

SOURCE = "warp_affine.cu"
MAX_IMAGES = 64  # images a launch takes (csrc/warp_affine.cu:kMaxImages)
STATUS = {2002: "arguments the kernel does not take"}
_COUNT = threading.Lock()  # launches come from the stream's worker threads


def inverse_matrices(trans) -> np.ndarray:
    """(n, 6) float32: the inverse of each 2x3 forward affine in ``trans``
    ((2, 3) or (n, 2, 3)), as ``warp_image`` computes it."""
    trans = np.asarray(trans, np.float64).reshape(-1, 2, 3)
    return np.stack([_invert_affine(t) for t in trans]).astype(np.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded as ``data/transforms.py:_fma`` rounds: the
    product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def warp_affine_plain(src: torch.Tensor, inv, out_hw) -> torch.Tensor:
    """The plain version: ``src`` (H, W, C) uint8 warped to ``out_hw`` (H, W)
    through the inverse affine ``inv`` (6 float32 values), on src's
    device."""
    if src.dtype != torch.uint8 or src.dim() != 3:
        raise TypeError(f"warp_affine_plain: (H, W, C) uint8, got "
                        f"{src.dtype} {tuple(src.shape)}")
    h, w = src.shape[:2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    m = torch.as_tensor(np.asarray(inv, np.float32).reshape(6),
                        device=src.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=src.device)[None, :]
    ys = torch.arange(out_h, dtype=torch.float32, device=src.device)[:, None]
    sx = _fma(m[0], xs, m[1] * ys + m[2])
    sy = _fma(m[3], xs, m[4] * ys + m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.to(torch.int64), fy.to(torch.int64)

    def neighbour(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = src[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return vals.float() * inside[..., None]

    p00, p01 = neighbour(0, 0), neighbour(0, 1)
    p10, p11 = neighbour(1, 0), neighbour(1, 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return torch.round(_fma(ay, bottom - top, top)).clamp(0, 255).to(
        torch.uint8)


_SIGNATURE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
              + [ctypes.c_void_p] * 2)


def _entry():
    fn = load_kernel_library(SOURCE).lib.cfd_warp_affine
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURE
    return fn


def warp_affine(srcs: Union[torch.Tensor, Sequence[torch.Tensor]], inv,
                out: Union[torch.Tensor, Sequence[torch.Tensor]]):
    """Warps each of ``srcs`` ((H_i, W_i, 3) uint8, or an (n, H, W, 3)
    batch) into the matching image of ``out`` (an (n, OH, OW, 3) uint8
    tensor, or n (OH, OW, 3) ones), ``inv`` the (n, 6) inverse matrices
    (:func:`inverse_matrices`), on the host. On the CPU each image goes
    through :func:`warp_affine_plain`; on the card through
    ``csrc/warp_affine.cu``, one launch per ``MAX_IMAGES`` images, on the
    current stream. Returns ``out``."""
    srcs, outs = list(srcs), list(out)
    inv = np.ascontiguousarray(np.asarray(inv, np.float32).reshape(-1, 6))
    if not (len(srcs) == len(outs) == len(inv)):
        raise ValueError(f"warp_affine: {len(srcs)} images, {len(outs)} "
                         f"outputs, {len(inv)} matrices")
    if not srcs:
        return out
    out_hw = tuple(outs[0].shape[:2])
    device = srcs[0].device
    for t in srcs + outs:
        if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[2] != 3:
            raise TypeError(f"warp_affine: (H, W, 3) uint8 images, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise RuntimeError("warp_affine: images and outputs on one "
                               "device")
    if any(tuple(o.shape[:2]) != out_hw for o in outs):
        raise ValueError("warp_affine: outputs of one size")
    if device.type == "cpu":
        for src, o, m in zip(srcs, outs, inv):
            o.copy_(warp_affine_plain(src, m, out_hw))
        return out
    if device.type != "cuda":
        raise RuntimeError(f"warp_affine: no kernel for device {device}")
    if not all(o.is_contiguous() for o in outs):
        raise ValueError("warp_affine: contiguous outputs")
    if 0 in out_hw:
        return out
    srcs = [s.contiguous() for s in srcs]
    for start in range(0, len(srcs), MAX_IMAGES):
        _launch(srcs[start:start + MAX_IMAGES],
                outs[start:start + MAX_IMAGES],
                inv[start:start + MAX_IMAGES], out_hw)
    return out


def _launch(srcs: List[torch.Tensor], outs: List[torch.Tensor],
            inv: np.ndarray, out_hw) -> None:
    n = len(srcs)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    ints = lambda vals: (ctypes.c_int * n)(*vals)
    inv = np.ascontiguousarray(inv, np.float32)
    device = srcs[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _entry()(ptrs(srcs), ptrs(outs),
                        ints(s.shape[0] for s in srcs),
                        ints(s.shape[1] for s in srcs), n, out_hw[0],
                        out_hw[1], inv.ctypes.data_as(ctypes.c_void_p),
                        stream)
    if code != 0:
        raise RuntimeError(f"warp_affine: "
                           f"{STATUS.get(code, f'CUDA error {code}')}")
    with _COUNT:
        warp_affine.launches += 1


warp_affine.launches = 0
