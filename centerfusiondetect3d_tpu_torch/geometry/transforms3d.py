"""3D box geometry, projection and rotation-bin decoding.

The port's own copy of what the serving path needs from
``centerfusiondetect3d_tpu/geometry/transforms3d.py`` (reference
``src/lib/utils/pointcloud.py:195-328`` and ``src/lib/utils/ddd.py:8-199``).
The JAX package runs one set of functions on numpy and jax.numpy; here the
device side takes torch tensors, and what the host radar pipeline and the
training target builder call (the ``*_np`` functions and the rotation-bin
encoders) stays numpy so the host keeps numpy's float32 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi

# Corner sign patterns for the canonical (length, height, width) box, in the
# reference corner order (pointcloud.py:276-288).
_X_SIGNS = (0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)
_Y_SIGNS = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0)
_Z_SIGNS = (0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Single-step wrap into [-pi, pi] (the reference's one-shot wrap)."""
    angle = angle - 2 * PI * (angle > PI)
    return angle + 2 * PI * (angle < -PI)


def get_alpha(rotation: torch.Tensor) -> torch.Tensor:
    """Decode the 8-bin rotation vector (..., 8) into the observation angle."""
    use_bin1 = rotation[..., 1] > rotation[..., 5]
    alpha1 = torch.atan2(rotation[..., 2], rotation[..., 3]) - 0.5 * PI
    alpha2 = torch.atan2(rotation[..., 6], rotation[..., 7]) + 0.5 * PI
    return torch.where(use_bin1, alpha1, alpha2)


def alpha_to_yaw(alpha, obj_center_x, img_center_x, focal_length):
    """Observation angle -> yaw: alpha + atan2(x - cx, f), wrapped."""
    yaw = alpha + torch.atan2(obj_center_x - img_center_x, focal_length)
    return wrap_to_pi(yaw)


def get_3d_corners(dim: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """(..., 3) [h, w, l] dims and (...,) yaw -> (..., 8, 3) corners."""
    signs = dim.new_tensor((_X_SIGNS, _Y_SIGNS, _Z_SIGNS))
    x = dim[..., 2:3] * signs[0]
    y = dim[..., 0:1] * signs[1]
    z = dim[..., 1:2] * signs[2]
    c = torch.cos(yaw)[..., None]
    s = torch.sin(yaw)[..., None]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def get_3d_box(dim, location, yaw):
    """3D box corners translated to the object location (ddd.py:8-23)."""
    return get_3d_corners(dim, yaw) + location[..., None, :]


def project_3d_points(points_3d: torch.Tensor,
                      calib: torch.Tensor) -> torch.Tensor:
    """Project (..., N, 3) camera-space points with a (..., 3, 4) calib
    into (..., N, 2) image points."""
    homo = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], -1)
    proj = torch.einsum("...ij,...nj->...ni", calib, homo)
    return proj[..., :2] / proj[..., 2:3]


def project_2d_to_3d(pt_2d, depth, calib):
    """Unproject (..., 2) image points at (..., 1) depth through (..., 3, 4)."""
    z = depth[..., 0] - calib[..., 2, 3]
    x = (pt_2d[..., 0] * depth[..., 0] - calib[..., 0, 3]
         - calib[..., 0, 2] * z) / calib[..., 0, 0]
    y = (pt_2d[..., 1] * depth[..., 0] - calib[..., 1, 3]
         - calib[..., 1, 2] * z) / calib[..., 1, 1]
    return torch.stack([x, y, z], dim=-1)


def img_to_cam_coord(center, alpha, dim, depth, calib):
    """Image-space detections -> camera-space locations and yaws.

    center (B, K, 2), alpha (B, K), dim (B, K, 3), depth (B, K), calib
    (B, 3, 4). Returns locations (B, K, 3), y moved to the box bottom, and
    yaw (B, K) (ddd.py:173-199).
    """
    calib_k = calib[:, None]
    locations = project_2d_to_3d(center, depth[..., None], calib_k)
    zeros = torch.zeros_like(dim[..., 0])
    locations = locations + torch.stack([zeros, dim[..., 0] / 2, zeros], -1)
    yaw = alpha_to_yaw(alpha, center[..., 0], calib_k[..., 0, 2],
                       calib_k[..., 0, 0])
    return locations, yaw


def distance_thresh(calib, center, dim, alpha):
    """Frustum depth-window half-extent per box (pointcloud.py:299-328).

    Keeps the reference's operator precedence, ``max(z) - min(z) / 2``, and
    not ``(max - min) / 2``. calib (B, 3, 4); center (B, K, 2); dim
    (B, K, 3); alpha (B, K).
    """
    cx = calib[:, None, 0, 2]
    f = calib[:, None, 0, 0]
    yaw = alpha_to_yaw(alpha, center[..., 0], cx, f)
    z = get_3d_corners(dim, yaw)[..., 2]
    return z.amax(dim=-1) - z.amin(dim=-1) / 2.0


def get_3d_corners_np(dim: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """numpy ``get_3d_corners``."""
    h, w, l = dim[..., 0:1], dim[..., 1:2], dim[..., 2:3]
    x = l * np.asarray(_X_SIGNS, np.float32)
    y = h * np.asarray(_Y_SIGNS, np.float32)
    z = w * np.asarray(_Z_SIGNS, np.float32)
    c = np.cos(yaw)[..., None]
    s = np.sin(yaw)[..., None]
    return np.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


def get_3d_box_np(dim: np.ndarray, location: np.ndarray,
                  yaw: np.ndarray) -> np.ndarray:
    """numpy ``get_3d_box`` for the host radar pipeline."""
    return get_3d_corners_np(dim, yaw) + location[..., None, :]


def distance_thresh_np(calib, center, dim, alpha) -> np.ndarray:
    """numpy ``distance_thresh`` for the training target builder."""
    cx = calib[:, None, 0, 2]
    f = calib[:, None, 0, 0]
    yaw = alpha + np.arctan2(center[..., 0] - cx, f)
    yaw = yaw - 2 * PI * (yaw > PI)
    yaw = yaw + 2 * PI * (yaw < -PI)
    z = get_3d_corners_np(dim, yaw)[..., 2]
    return z.max(axis=-1) - z.min(axis=-1) / 2.0


def encode_alpha_8bin(alpha: float) -> np.ndarray:
    """A scalar alpha -> the 8-bin rotation target vector."""
    ret = np.array([0, 0, 0, 1, 0, 0, 0, 1], np.float32)
    if alpha < PI / 6.0 or alpha > 5 * PI / 6.0:
        r = alpha - (-0.5 * PI)
        ret[1] = 1
        ret[2], ret[3] = np.sin(r), np.cos(r)
    if alpha > -PI / 6.0 or alpha < -5 * PI / 6.0:
        r = alpha - (0.5 * PI)
        ret[5] = 1
        ret[6], ret[7] = np.sin(r), np.cos(r)
    return ret


def encode_rotbin_rotres(alpha: float):
    """Rotation-bin classification targets and residuals."""
    rotbin = np.zeros(2, np.int64)
    rotres = np.zeros(2, np.float32)
    if alpha < PI / 6.0 or alpha > 5 * PI / 6.0:
        rotbin[0] = 1
        rotres[0] = alpha - (-0.5 * PI)
    if alpha > -PI / 6.0 or alpha < -5 * PI / 6.0:
        rotbin[1] = 1
        rotres[1] = alpha - (0.5 * PI)
    return rotbin, rotres


def project_3d_points_np(points_3d: np.ndarray,
                         calib: np.ndarray) -> np.ndarray:
    """Project (..., N, 3) camera-space points with a (..., 3, 4) calib."""
    ones = np.ones_like(points_3d[..., :1])
    homo = np.concatenate([points_3d, ones], axis=-1)
    proj = np.einsum("...ij,...nj->...ni", calib, homo)
    return proj[..., :2] / proj[..., 2:3]
