"""Minimal quaternion algebra (w, x, y, z convention).

The port's own copy of ``centerfusiondetect3d_tpu/utils/quaternion.py``
(numpy only), unchanged but for this paragraph.

Replaces the pyquaternion dependency of the reference's eval-format
conversion and converter (reference src/lib/dataset/datasets/
nuscenes.py:416-482, convert_nuScenes.py:167-201). Numpy only.
"""

from __future__ import annotations

import numpy as np


def from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


def multiply(q1, q2) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def rotation_matrix(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def from_rotation_matrix(m) -> np.ndarray:
    """Unit quaternion of a proper rotation matrix (Shepperd's method:
    branch on the largest diagonal combination for numerical stability)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] >= m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def rotate(q, v) -> np.ndarray:
    return rotation_matrix(q) @ np.asarray(v, np.float64)


def inverse(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return conj / np.dot(q, q)


def yaw_from_quaternion(q) -> float:
    """Heading angle of the box x-axis in the global xy plane."""
    v = rotate(q, [1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, q, inverse_: bool = False) -> np.ndarray:
    """4x4 homogeneous transform from rotation q + translation."""
    tm = np.eye(4)
    rot = rotation_matrix(q)
    t = np.asarray(translation, np.float64)
    if inverse_:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm
