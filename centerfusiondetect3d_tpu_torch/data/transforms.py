"""Host-side image augmentation and warping.

Re-derivation of the reference augmentation pipeline
(reference src/lib/dataset/generic_dataset.py:326-439,
utils/image.py:112-142): random shift/scale (clipped gaussians) or CornerNet
random crop, horizontal flip with annotation mirroring, affine warp to the
network input, color jitter in random order + PCA lighting, normalization.
Everything is numpy, NHWC float32.

The port's own copy of ``centerfusiondetect3d_tpu/data/transforms.py``, but
for ``warp_image``: the JAX package warps with ``cv2.warpAffine`` (bilinear,
zero border); here the same arithmetic runs in numpy, so that the port does
not depend on opencv. ``transform_input`` warps with its C++ kernel
(``warp_image_native``, ``native/warp.cpp``), which, like cv2, runs without
the interpreter lock; ``warp_image`` is its plain version.
"""

from __future__ import annotations

import numpy as np

from .. import native

# PCA color augmentation basis (CornerNet / reference utils/image.py:122-133)
EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
EIG_VEC = np.array(
    [
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938],
    ],
    np.float32,
)


def get_border(border: int, size: int) -> int:
    i = 1
    while size - border // i <= border // i:
        i *= 2
    return border // i


def sample_augment_params(rng: np.random.RandomState, center, scale, width, height,
                          config):
    """Random center/scale/rotation (generic_dataset.py:326-372)."""
    center = np.array(center, np.float32)
    if config.DATASET.RANDOM_CROP:
        scale_factor = float(rng.choice(np.arange(0.6, 1.4, 0.1)))
        w_border = get_border(128, width)
        h_border = get_border(128, height)
        center[0] = rng.randint(low=w_border, high=width - w_border)
        center[1] = rng.randint(low=h_border, high=height - h_border)
    else:
        sf = config.DATASET.SCALE
        shift = config.DATASET.SHIFT
        scale_factor = float(np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf))
        center[0] += scale * np.clip(rng.randn() * shift, -2 * shift, 2 * shift)
        center[1] += scale * np.clip(rng.randn() * shift, -2 * shift, 2 * shift)

    if rng.random_sample() < config.DATASET.ROTATE:
        rf = config.DATASET.ROTATE
        rotate_factor = float(np.clip(rng.randn() * rf, -2 * rf, 2 * rf))
    else:
        rotate_factor = 0.0
    return center, scale_factor, rotate_factor


def flip_annotations(anns, width: int, heads, radar_pc: bool, vel_trans_mat=None):
    """Mirror annotations for a horizontal flip (generic_dataset.py:374-412).

    Returns NEW ann dicts (with fresh lists/arrays for the mirrored fields);
    the inputs are never written to. This transform OWNS copy-on-write
    purity: the input anns come straight from the shared CocoReader tables
    (get_item passes them uncopied), and this loader lives in ONE persistent
    process — an in-place mirror (what the reference does, flipAnnotations
    generic_dataset.py:387-410) would permanently toggle the shared
    annotations, so every later epoch that does NOT flip this sample would
    pair the original image with mirrored targets. The reference is shielded
    only by its DataLoader worker processes being re-forked each epoch,
    which discards the mutations.
    """
    out = []
    for ann in anns:
        ann = dict(ann)  # shallow copy; mutated fields get fresh objects
        bbox = ann["bbox"]
        ann["bbox"] = [width - bbox[0] - 1 - bbox[2], bbox[1], bbox[2], bbox[3]]
        if "rotation" in heads and "alpha" in ann:
            ann["alpha"] = (
                np.pi - ann["alpha"] if ann["alpha"] > 0 else -np.pi - ann["alpha"]
            )
        if "amodal_offset" in heads and "amodal_center" in ann:
            ac = ann["amodal_center"]
            ann["amodal_center"] = [width - ac[0] - 1, *ac[1:]]
        if radar_pc and "velocity" in ann and vel_trans_mat is not None:
            vel3 = np.asarray(ann["velocity"], np.float32).copy()
            vel3[0] *= -1
            ann["velocity"] = vel3
            vel = np.array([*vel3[:3], 0], np.float32)
            ann["velocity_cam"] = np.dot(np.linalg.inv(vel_trans_mat), vel)
        out.append(ann)
    return out


def color_augment(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """Brightness/contrast/saturation jitter in random order + PCA lighting.

    img: HWC float32 in [0, 1]. Returns HWC float32 (unnormalized).
    """
    def brightness(x, f):
        return x * f

    def contrast(x, f):
        mean = x.mean()
        return (x - mean) * f + mean

    def saturation(x, f):
        gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
        return (x - gray[..., None]) * f + gray[..., None]

    fns = [brightness, contrast, saturation]
    for i in rng.permutation(3):
        f = 1.0 + (rng.random_sample() * 0.8 - 0.4)  # jitter 0.4
        img = fns[i](img, f)

    alpha = rng.normal(size=3).astype(np.float32) * 0.1
    img = img + EIG_VEC @ (EIG_VAL * alpha)
    return np.clip(img, 0.0, None)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine, with cv2's arithmetic (warpAffine
    inverts the matrix it is given: a destination pixel reads the source
    at the inverse's image of it), as 6 float64 values."""
    m = np.asarray(m, np.float64).reshape(-1)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a0, a1, a3, a4 = m[4] * d, m[1] * -d, m[3] * -d, m[0] * d
    return np.array([a0, a1, -a0 * m[2] - a1 * m[5],
                     a3, a4, -a3 * m[2] - a4 * m[5]])


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64."""
    return (np.float64(a) * b + c).astype(np.float32)


def warp_image(img: np.ndarray, trans_mat: np.ndarray, out_wh) -> np.ndarray:
    """Affine warp of a uint8 HWC (or HW) image to (W, H) with bilinear
    interpolation and a zero border: ``cv2.warpAffine(img, trans_mat[:2],
    out_wh, flags=cv2.INTER_LINEAR)`` in numpy, in the arithmetic of cv2's
    warp kernels: the inverse affine in float32, each destination pixel's
    source point a fused multiply-add along its row, the bilinear weight
    its fraction, the two lerps along x then the one along y fused
    multiply-adds in float32, rounded half to even. A neighbour outside the
    image reads 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"warp_image: uint8 images only, got {img.dtype}")
    src = img if img.ndim == 3 else img[..., None]
    h, w = src.shape[:2]
    out_w, out_h = int(out_wh[0]), int(out_wh[1])
    m = _invert_affine(np.asarray(trans_mat)[:2]).astype(np.float32)
    xs = np.arange(out_w, dtype=np.float32)[None, :]
    ys = np.arange(out_h, dtype=np.float32)[:, None]
    sx = _fma(m[0], xs, m[1] * ys + m[2])
    sy = _fma(m[3], xs, m[4] * ys + m[5])
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def neighbour(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return vals.astype(np.float32) * inside[..., None]

    p00, p01 = neighbour(0, 0), neighbour(0, 1)
    p10, p11 = neighbour(1, 0), neighbour(1, 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    out = np.clip(np.rint(_fma(ay, bottom - top, top)), 0, 255).astype(
        np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def warp_image_native(img: np.ndarray, trans_mat: np.ndarray,
                      out_wh) -> np.ndarray:
    """``warp_image`` by the C++ kernel (``native.warp_bilinear``): one call
    without the interpreter lock, bitwise ``warp_image``, its plain
    version."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"warp_image_native: uint8 images only, got "
                        f"{img.dtype}")
    src = np.ascontiguousarray(img if img.ndim == 3 else img[..., None])
    out_w, out_h = int(out_wh[0]), int(out_wh[1])
    out = np.empty((out_h, out_w, src.shape[2]), np.uint8)
    native.warp_bilinear(src, _invert_affine(np.asarray(trans_mat)[:2]), out)
    return out if img.ndim == 3 else out[..., 0]


def transform_input(img, trans_mat, input_hw, mean, std, rng=None, color_aug=False):
    """Warp (the C++ kernel) + (optional color aug) + normalize; returns HWC
    float32."""
    out = warp_image_native(img, trans_mat, (input_hw[1], input_hw[0]))
    out = out.astype(np.float32) / 255.0
    if color_aug and rng is not None:
        out = color_augment(rng, out)
    out = (out - mean) / std
    return out.astype(np.float32)
