"""2D affine transforms for image warping and box/point mapping.

The port's own copy of ``centerfusiondetect3d_tpu/geometry/affine.py``: the
reference's center/scale/rotation 3-point affine construction
(``src/lib/utils/image.py:43-109``) without the cv2 dependency; the 2x3 matrix
comes from a direct 3x3 linear solve. Host-side (numpy).
"""

from __future__ import annotations

import numpy as np


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Third triangle point: b + perpendicular(a - b)."""
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _rotate(point, radian):
    s, c = np.sin(radian), np.cos(radian)
    return np.array(
        [point[0] * c - point[1] * s, point[0] * s + point[1] * c], dtype=np.float32
    )


def solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine matrix mapping the 3 src points onto the 3 dst points."""
    src_h = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)  # (3, 3)
    mat_t = np.linalg.solve(src_h.astype(np.float64), dst.astype(np.float64))  # (3, 2)
    return mat_t.T.astype(np.float64)  # (2, 3), float64 to match cv2 output dtype


def get_affine_transform(
    center, scale, rotate_deg, output_size, shift=(0.0, 0.0), inverse=False
) -> np.ndarray:
    """Affine matrix from (center, scale, rotation) to an output resolution.

    Args:
        center: (2,) source region center in pixels.
        scale: scalar or (2,) source region size.
        rotate_deg: rotation in degrees.
        output_size: (width, height) of the destination image.
        shift: relative shift applied to the center.
        inverse: return the output->source matrix instead.

    Returns:
        (2, 3) float affine matrix.
    """
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    radian = np.pi * rotate_deg / 180.0
    src_dir = _rotate([0.0, src_w * -0.5], radian)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = _third_point(src[0], src[1])
    dst[0] = np.array([dst_w * 0.5, dst_h * 0.5], dtype=np.float32)
    dst[1] = dst_dir + dst[0]
    dst[2] = _third_point(dst[0], dst[1])

    if inverse:
        return solve_affine(dst, src)
    return solve_affine(src, dst)


def apply_affine(points: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a (2, 3) affine matrix to (N, 2) points."""
    mat = np.asarray(mat, dtype=points.dtype)
    return points @ mat[:, :2].T + mat[:, 2]


def stack_inverse_transforms(centers, scales, out_wh) -> np.ndarray:
    """Per-image inverse affines -> one (B, 2, 3) float32 stack.

    One matrix per image, as the reference's postProcess.py:31-43 applies,
    so mixed-size inputs map back to their own original-image frames.
    """
    return np.stack(
        [
            get_affine_transform(
                np.asarray(c, np.float32), s, 0, out_wh, inverse=True
            ).astype(np.float32)
            for c, s in zip(centers, scales)
        ]
    )
