"""Affine warps, gaussian targets and 3D box geometry (the port of
``centerfusiondetect3d_tpu/geometry``): torch functions for the device
side, and the ``*_np`` numpy forms that the host pipeline and the
renderers call."""

from .affine import (apply_affine, get_affine_transform, solve_affine,
                     stack_inverse_transforms)
from .gaussian import (draw_gaussian, ellip_gaussian_2d, gaussian_2d,
                       gaussian_radius)
from .transforms3d import (
    alpha_to_yaw,
    distance_thresh,
    distance_thresh_np,
    encode_alpha_8bin,
    encode_rotbin_rotres,
    get_3d_box,
    get_3d_box_np,
    get_3d_corners,
    get_3d_corners_np,
    get_alpha,
    img_to_cam_coord,
    project_2d_to_3d,
    project_3d_points,
    project_3d_points_np,
    wrap_to_pi,
)

__all__ = [
    "get_affine_transform",
    "apply_affine",
    "stack_inverse_transforms",
    "solve_affine",
    "gaussian_radius",
    "gaussian_2d",
    "ellip_gaussian_2d",
    "draw_gaussian",
    "wrap_to_pi",
    "get_alpha",
    "encode_alpha_8bin",
    "encode_rotbin_rotres",
    "alpha_to_yaw",
    "get_3d_corners",
    "get_3d_corners_np",
    "get_3d_box",
    "get_3d_box_np",
    "project_3d_points",
    "project_3d_points_np",
    "project_2d_to_3d",
    "img_to_cam_coord",
    "distance_thresh",
    "distance_thresh_np",
]
