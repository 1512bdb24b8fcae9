"""Frustum association of the radar map to the first-stage boxes.

The port of ``centerfusiondetect3d_tpu/ops/frustum.py`` (reference
``getPcFrustumHeatmap``/``cvtPcDepthToHeatmap``,
``src/lib/utils/pointcloud.py:331-481``). For each of the top-K predicted
boxes, in descending score order: crop the radar depth map to the
integer-expanded box, keep the radar pixels whose depth lies inside the
frustum window ``(max(0, d - thr), d + thr)``, take the nearest one, and
paint its ``[depth / max_dist, vel_x, vel_z]`` into a 0.3-scaled rectangle at
the box center; later boxes overwrite earlier ones.

The reference's per-box loop becomes fixed-shape (B, K, H, W) masks: a
masked min picks the nearest pixel and the highest covering box index wins a
pixel. The reference's quirks are kept: Python's negative-index slice
wraparound in the crop and the paint, the extra ``+1`` paint column
(pointcloud.py:478), last-box-wins overwrites, and the operator precedence of
``distance_thresh``.
"""

from __future__ import annotations

import torch

from ..geometry.transforms3d import distance_thresh, get_alpha
from .decode import gather_feature, topk_peaks


def _pyslice_mask(iota, start, stop, size: int):
    """(..., size) mask of python ``a[start:stop]`` per box, negative-index
    wraparound included (pointcloud.py:436,478-481)."""
    s = torch.where(start < 0, (size + start).clamp(min=0), start)
    e = torch.where(stop < 0, (size + stop).clamp(min=0), stop)
    return (iota >= s[..., None]) & (iota < e[..., None])


def frustum_association(pc_dep, depth, bboxes, thresh, max_pc_dist: float):
    """pc_dep (B, 3, H, W) [depth, vel_x, vel_z]; depth (B, K); bboxes
    (B, K, 4) output-plane xyxy; thresh (B, K). Returns (B, 3, H, W)."""
    b, _, height, width = pc_dep.shape
    k = bboxes.shape[1]
    dev = pc_dep.device
    rows = torch.arange(height, device=dev, dtype=torch.int32)
    cols = torch.arange(width, device=dev, dtype=torch.int32)
    d_map = pc_dep[:, 0][:, None]  # (B, 1, H, W)

    x1 = torch.floor(bboxes[..., 0]).int()
    y1 = torch.floor(bboxes[..., 1]).int()
    x2 = torch.ceil(bboxes[..., 2]).int()
    y2 = torch.ceil(bboxes[..., 3]).int()
    crop = (_pyslice_mask(rows, y1, y2 + 1, height)[..., :, None]
            & _pyslice_mask(cols, x1, x2 + 1, width)[..., None, :])

    lo = (depth - thresh).clamp(min=0.0)[..., None, None]
    hi = (depth + thresh)[..., None, None]
    valid = crop & (d_map > 0.0) & (d_map < hi) & (d_map > lo)
    masked = torch.where(valid, d_map, torch.full_like(d_map, float("inf")))
    # first minimal index on ties, as jnp.argmin
    nearest_idx = torch.argmin(masked.reshape(b, k, -1), dim=2)  # (B, K)
    nearest_d = torch.gather(masked.reshape(b, k, -1), 2,
                             nearest_idx[..., None])[..., 0]
    matched = torch.isfinite(nearest_d)

    vel = pc_dep[:, 1:].reshape(b, 2, -1)
    sel_vel = torch.gather(vel, 2, nearest_idx[:, None, :].expand(b, 2, k))
    values = torch.stack([nearest_d / max_pc_dist, sel_vel[:, 0],
                          sel_vel[:, 1]], dim=2)  # (B, K, 3)
    values = torch.where(matched[..., None], values, torch.zeros_like(values))

    # paint rectangle: the 0.3-scaled box at the float center, truncated
    # toward zero as python int(); columns [w_min, w_max + 2) is the
    # reference's extra column
    cx = (bboxes[..., 0] + bboxes[..., 2]) / 2.0
    cy = (bboxes[..., 1] + bboxes[..., 3]) / 2.0
    w_int = 0.3 * (bboxes[..., 2] - bboxes[..., 0])
    h_int = 0.3 * (bboxes[..., 3] - bboxes[..., 1])
    w_min = torch.trunc(cx - w_int / 2.0).int()
    w_max = torch.trunc(cx + w_int / 2.0).int()
    h_min = torch.trunc(cy - h_int / 2.0).int()
    h_max = torch.trunc(cy + h_int / 2.0).int()
    paint = (_pyslice_mask(rows, h_min, h_max + 1, height)[..., :, None]
             & _pyslice_mask(cols, w_min, w_max + 2, width)[..., None, :]
             & matched[..., None, None])  # (B, K, H, W)

    box_ids = torch.arange(k, device=dev, dtype=torch.int32)[:, None, None]
    winner = torch.where(paint, box_ids, -1).amax(dim=1)  # (B, H, W)
    painted = torch.gather(
        values.transpose(1, 2), 2,
        winner.clamp(min=0).reshape(b, 1, -1).expand(b, 3, -1).long())
    painted = painted.reshape(b, 3, height, width)
    return torch.where((winner >= 0)[:, None], painted,
                       torch.zeros_like(painted))


def get_pc_frustum_heatmap(output, pc_dep, calib, k: int,
                           max_pc_dist: float):
    """Frustum heatmap from the first-stage heads (pointcloud.py:331-394).

    output: NCHW first-stage heads — heatmap (before NMS), widthHeight,
    depth (after sigmoid_depth), dimension, rotation. pc_dep (B, 3, H, W);
    calib (B, 3, 4). The reference takes the top-k without NMS here.
    """
    heat = output["heatmap"]
    batch = heat.shape[0]
    _, inds, _, ys, xs = topk_peaks(heat, k)
    xs = xs.float() + 0.5
    ys = ys.float() + 0.5

    depth = gather_feature(output["depth"], inds)[..., 0]
    wh = gather_feature(output["widthHeight"], inds).clamp(min=0.0)
    bboxes = torch.stack([xs - wh[..., 0] / 2, ys - wh[..., 1] / 2,
                          xs + wh[..., 0] / 2, ys + wh[..., 1] / 2], dim=2)
    dimension = gather_feature(output["dimension"], inds)
    alpha = get_alpha(gather_feature(output["rotation"], inds))
    center = torch.stack([(bboxes[..., 0] + bboxes[..., 2]) / 2,
                          (bboxes[..., 1] + bboxes[..., 3]) / 2], dim=2)
    thresh = distance_thresh(calib.reshape(batch, 3, 4), center, dimension,
                             alpha)
    return frustum_association(pc_dep, depth, bboxes, thresh, max_pc_dist)
