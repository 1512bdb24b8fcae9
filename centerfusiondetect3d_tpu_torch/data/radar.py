"""Host-side radar point-cloud processing (numpy).

The port's own copy of ``centerfusiondetect3d_tpu/data/radar.py``, on the
numpy paths only (the JAX package's optional C++ paint is not used; the
overwrite-ordered paint is the plain loop it falls back to). The reference
radar pipeline (``src/lib/dataset/generic_dataset.py:738-942``,
``datasets/nuscenes.py:131-294``, ``utils/pointcloud.py:17-49``): camera projection
with in-view filtering, depth sorting (nearest drawn last so overwrites win),
pillar/heatmap/points rasterization into the NHWC radar depth map
[d, vel_x, vel_z]. The per-point pillar projection is fully vectorized
(one batched corner projection for all points); only the final overwrite-
ordered paint is a short loop over <= MAX_PC points.

Radar rows follow the nuScenes 18-row layout: rows 0-2 xyz, row 8 vx_comp,
row 9 vy_comp (camera frame: x right, z front after conversion).
"""

from __future__ import annotations

import numpy as np

from ..geometry.gaussian import gaussian_radius
from ..geometry.transforms3d import get_3d_box_np, project_3d_points_np


def map_pointcloud_to_image(points: np.ndarray, cam_intrinsic: np.ndarray,
                            img_shape=(1600, 900)):
    """Project (>=3, N) camera-frame points to the image plane.

    Returns ((3, N_kept) [x, y, depth], keep_mask) - reference
    utils/pointcloud.py:17-49 semantics (border-1 margin, positive depth).
    """
    points = np.asarray(points)
    width, height = img_shape
    depths = points[2, :]

    viewpad = np.eye(4, dtype=np.float32)
    viewpad[:3, :3] = cam_intrinsic
    homo = np.vstack([points[:3], np.ones((1, points.shape[1]), points.dtype)])
    proj = viewpad @ homo
    proj = proj[:3] / np.maximum(proj[2:3], 1e-9)

    mask = (
        (depths > 0)
        & (proj[0] > 1)
        & (proj[0] < width - 1)
        & (proj[1] > 1)
        & (proj[1] < height - 1)
    )
    out = proj[:, mask]
    out[2] = depths[mask]
    return out, mask


def transform_point_cloud(pc_2d: np.ndarray, trans_mat: np.ndarray,
                          img_width: int, img_height: int, filter_out=True):
    """Affine-map 2D points ([x, y, ...] rows) and optionally filter in-view."""
    if pc_2d.shape[1] == 0:
        return pc_2d, np.zeros(0, bool)
    pts = trans_mat[:, :2] @ pc_2d[:2] + trans_mat[:, 2:3]
    if filter_out:
        mask = (
            (pts[0] < img_width) & (0 < pts[0]) & (pts[1] < img_height) & (0 < pts[1])
        )
        return np.concatenate([pts[:, mask], pc_2d[2:, mask]], axis=0), mask
    return np.concatenate([pts, pc_2d[2:]], axis=0), None


def pillar_sizes(pc_3d: np.ndarray, calib: np.ndarray, trans_out: np.ndarray,
                 out_size, pillar_dims):
    """Projected 2D (w, h) of a 3D pillar at each radar point, vectorized.

    pc_3d: (>=3, N) camera-frame points; calib: (3, 4). Returns (2, N).
    (generic_dataset.py:869-942)
    """
    n = pc_3d.shape[1]
    if n == 0:
        return np.zeros((2, 0), np.float32)
    centers = pc_3d[:3].T.reshape(1, n, 3).astype(np.float32)
    dims = np.broadcast_to(np.asarray(pillar_dims, np.float32), (1, n, 3))
    corners = get_3d_box_np(dims, centers, np.zeros((1, n), np.float32))
    calib_k = np.broadcast_to(calib.reshape(1, 1, 3, 4), (1, n, 3, 4))
    pts2d = project_3d_points_np(corners, calib_k)  # (1, N, 8, 2)
    flat = pts2d.reshape(-1, 2).T  # (2, N*8)
    out, _ = transform_point_cloud(flat, trans_out, out_size[1], out_size[0],
                                   filter_out=False)
    box = out.T.reshape(n, 8, 2)
    w = box[..., 0].max(1) - box[..., 0].min(1)
    h = box[..., 1].max(1) - box[..., 1].min(1)
    return np.stack([w, h], axis=0).astype(np.float32)


def empty_depth_map(out_size, max_distance: int, one_hot: bool) -> np.ndarray:
    channels = 3 * max_distance if one_hot else 3
    return np.zeros((*out_size, channels), np.float32)


def draw_pc_heat(depth_map, box, depth, max_dist: int, one_hot: bool, point_row):
    """Paint [d, vx, vz] into an integer box region (nuscenes.py:234-263).

    box: (y1, y2, x1, x2) exclusive-stop ints; point_row: the 18-row column.
    """
    y1, y2, x1, x2 = box
    vx, vz = point_row[8], point_row[9]
    if one_hot:
        # the distance filter is inclusive (<= max_dist), so depth ==
        # max_dist would index channel max_dist and crash mid-epoch
        d_layer = min(int(depth), max_dist - 1)
        depth_map[y1:y2, x1:x2, d_layer] = depth
        depth_map[y1:y2, x1:x2, d_layer + max_dist] = vx
        depth_map[y1:y2, x1:x2, d_layer + 2 * max_dist] = vz
    else:
        depth_map[y1:y2, x1:x2, 0] = depth
        depth_map[y1:y2, x1:x2, 1] = vx
        depth_map[y1:y2, x1:x2, 2] = vz
    return depth_map


def draw_pc_points(depth_map, points_xy, depths, max_dist: int, one_hot: bool,
                   pc_3d):
    """Single-pixel scatter rasterization (nuscenes.py:265-294)."""
    pts = points_xy.astype(np.int32)
    if one_hot:
        # clamp like draw_pc_heat: depth == max_dist passes the inclusive
        # distance filter but channel max_dist does not exist
        d_layer = np.minimum(depths.astype(np.int32), max_dist - 1)
        depth_map[pts[1], pts[0], d_layer] = depths
        depth_map[pts[1], pts[0], d_layer + max_dist] = pc_3d[8]
        depth_map[pts[1], pts[0], d_layer + 2 * max_dist] = pc_3d[9]
    else:
        depth_map[pts[1], pts[0], 0] = depths
        depth_map[pts[1], pts[0], 1] = pc_3d[8]
        depth_map[pts[1], pts[0], 2] = pc_3d[9]
    return depth_map


def _build_boxes(transformed, pc_3d, method, config, trans_out, calib,
                 out_h, out_w) -> np.ndarray:
    """Per-point integer paint rectangles [y1, y2, x1, x2), exclusive stops.

    The shared box arithmetic of the pillars/heatmap ROI methods
    (generic_dataset.py:798-827); the paint itself is applied either on the
    host or on the device (ops/rasterize.py) from the same rows.
    """
    n = transformed.shape[1]
    if method == "pillars":
        pw_ph = pillar_sizes(
            pc_3d, calib, trans_out, (out_h, out_w), config.DATASET.PILLAR_DIMS
        )

    boxes = np.zeros((n, 4), np.int32)
    for i in range(n):
        x, y, depth = transformed[0, i], transformed[1, i], transformed[2, i]
        if method == "pillars":
            box = [
                max(y - pw_ph[1, i], 0.0),  # y1: pillar extends upward
                y,
                max(x - pw_ph[0, i] / 2, 0.0),
                min(x + pw_ph[0, i] / 2, out_w),
            ]
        elif method == "heatmap":
            r = (1.0 / depth) * 250 + 5
            r = max(0, int(gaussian_radius((r, r))))
            xi, yi = int(x), int(y)
            left, right = min(xi, r), min(out_w - xi, r + 1)
            top, bottom = min(yi, r), min(out_h - yi, r + 1)
            box = [yi - top, yi + bottom, xi - left, xi + right]
        else:
            raise ValueError(f"invalid PC_ROI_METHOD {method!r}")
        boxes[i] = np.round(box).astype(np.int32)
    return boxes


def _point_values(transformed, pc_3d) -> np.ndarray:
    """(N, 3) [depth, vx, vz] paint values for each point."""
    n = transformed.shape[1]
    depths = transformed[2, :n].astype(np.float32)
    vels = (pc_3d[8:10, :n].astype(np.float32)
            if pc_3d.shape[0] > 9 else np.zeros((2, n), np.float32))
    return np.stack([depths, vels[0], vels[1]], axis=1)


def process_point_cloud_rows(pc_2d, pc_3d, config, trans_out, calib):
    """Transform the cloud and return the PAINT ROWS instead of painting.

    Returns (transformed pc_2d (3, N'), masked pc_3d, boxes (N', 4) int32,
    values (N', 3) float32): painting values[i] into boxes[i] for
    i = 0..N'-1 in order reproduces ``process_point_cloud``'s depth map
    exactly (ONE_HOT_PC excluded — its per-bucket overwrite history needs
    the host paint). Consumed by the device rasterizer (ops/rasterize.py).
    """
    out_h, out_w = config.MODEL.OUTPUT_SIZE
    transformed, mask = transform_point_cloud(pc_2d, trans_out, out_w, out_h)
    if mask is not None:
        pc_3d = pc_3d[:, mask]
    method = config.DATASET.PC_ROI_METHOD
    if method == "points":
        # single-pixel scatter: a 1x1 box at the truncated coordinate
        # (draw_pc_points' integer cast; last write wins either way)
        pts = transformed[:2].astype(np.int32)
        boxes = np.stack(
            [pts[1], pts[1] + 1, pts[0], pts[0] + 1], axis=1
        ).astype(np.int32)
    else:
        boxes = _build_boxes(transformed, pc_3d, method, config, trans_out,
                             calib, out_h, out_w)
    return transformed, pc_3d, boxes, _point_values(transformed, pc_3d)


def process_point_cloud(pc_2d, pc_3d, config, trans_out, calib):
    """Transform + rasterize the radar cloud (generic_dataset.py:738-828).

    Returns (transformed pc_2d (3, N'), masked pc_3d, depth_map NHWC).
    """
    out_h, out_w = config.MODEL.OUTPUT_SIZE
    transformed, mask = transform_point_cloud(pc_2d, trans_out, out_w, out_h)
    one_hot = bool(config.DATASET.ONE_HOT_PC)
    max_dist = int(config.DATASET.MAX_PC_DIST)
    depth_map = empty_depth_map((out_h, out_w), max_dist, one_hot)

    if mask is not None:
        pc_3d = pc_3d[:, mask]
    n = transformed.shape[1]

    method = config.DATASET.PC_ROI_METHOD
    if method == "points":
        depth_map = draw_pc_points(
            depth_map, transformed[:2], transformed[2], max_dist, one_hot, pc_3d
        )
        return transformed, pc_3d, depth_map

    boxes = _build_boxes(transformed, pc_3d, method, config, trans_out, calib,
                         out_h, out_w)
    depths = transformed[2, :n].astype(np.float32)
    for i in range(n):
        depth_map = draw_pc_heat(
            depth_map, boxes[i], depths[i], max_dist, one_hot, pc_3d[:, i]
        )
    return transformed, pc_3d, depth_map


def paint_rows_host(boxes: np.ndarray, values: np.ndarray,
                    out_size) -> np.ndarray:
    """Paint (N, 4) boxes / (N, 3) values host-side (non-one-hot layout).

    Same overwrite-order semantics as the device rasterizer; used when a
    batch mixes device-paint rows with host rasters (MAX_PC overflow)."""
    depth_map = np.zeros((*out_size, 3), np.float32)
    h, w = out_size
    for (y1, y2, x1, x2), v in zip(boxes, values):
        y1, x1 = max(int(y1), 0), max(int(x1), 0)
        y2, x2 = min(int(y2), h), min(int(x2), w)
        if y2 > y1 and x2 > x1:
            depth_map[y1:y2, x1:x2] = v
    return depth_map


def prepare_radar_points(radar_pc: np.ndarray, img_info: dict, config,
                         trans_out, flipped: bool = False,
                         img_width: int = None, img_height: int = None,
                         return_paint: bool = False):
    """Full per-sample radar prep (nuscenes.py:131-219): distance filter,
    z-offset, projection, depth sort (nearest last unless points-method),
    flip, rasterize, pad to MAX_PC.

    Returns (pc_2d (3, MAX_PC), pc_N, pc_dep NHWC, pc_3d (18, MAX_PC)).

    ``return_paint=True`` (serving fast path, not ONE_HOT_PC): skip the
    host paint and return ``(boxes (MAX_PC, 4) int32, values (MAX_PC, 3)
    float32)`` in place of ``pc_dep`` — the device rasterizer
    (ops/rasterize.py) paints the identical map on-chip from ~10x fewer
    transferred bytes. Padded rows are all-zero (cover nothing).
    """
    radar_pc = np.asarray(radar_pc, np.float32)
    img_width = img_width or img_info["width"]
    img_height = img_height or img_info["height"]

    max_dist = config.DATASET.MAX_PC_DIST
    if max_dist > 0:
        radar_pc = radar_pc[:, radar_pc[2] <= max_dist]
    if config.DATASET.PC_Z_OFFSET != 0:
        radar_pc[1, :] -= config.DATASET.PC_Z_OFFSET

    intr = np.asarray(img_info["camera_intrinsic"], np.float32)
    pc_2d, mask = map_pointcloud_to_image(
        radar_pc, intr, img_shape=(img_width, img_height)
    )
    pc_3d = radar_pc[:, mask]

    order = np.argsort(pc_2d[2, :], kind="stable")
    if not config.DATASET.get("PC_REVERSE", False):
        order = order[::-1]
    pc_2d = pc_2d[:, order]
    pc_3d = pc_3d[:, order]

    if flipped:
        pc_2d[0, :] = img_width - 1 - pc_2d[0, :]
        pc_3d[0, :] *= -1
        pc_3d[8, :] *= -1

    calib = np.asarray(img_info["calib"], np.float32)
    if return_paint:
        if config.DATASET.ONE_HOT_PC:
            raise ValueError("return_paint does not support ONE_HOT_PC "
                             "(per-bucket overwrite history is host-painted)")
        pc_2d, pc_3d, boxes, values = process_point_cloud_rows(
            pc_2d, pc_3d, config, trans_out, calib
        )
    else:
        pc_2d, pc_3d, pc_dep = process_point_cloud(
            pc_2d, pc_3d, config, trans_out, calib
        )
    pc_n = np.int32(pc_2d.shape[1])

    max_pc = config.DATASET.MAX_PC
    n = min(max_pc, pc_2d.shape[1])
    pc_2d_pad = np.zeros((pc_2d.shape[0], max_pc), np.float32)
    pc_2d_pad[:, :n] = pc_2d[:, :n]
    pc_3d_pad = np.zeros((pc_3d.shape[0], max_pc), np.float32)
    pc_3d_pad[:, :n] = pc_3d[:, :n]
    if return_paint:
        boxes_pad = np.zeros((max_pc, 4), np.int32)
        boxes_pad[:n] = boxes[:n]
        values_pad = np.zeros((max_pc, 3), np.float32)
        values_pad[:n] = values[:n]
        return pc_2d_pad, pc_n, (boxes_pad, values_pad), pc_3d_pad
    return pc_2d_pad, pc_n, pc_dep, pc_3d_pad
