"""Post-processing of decoded detections on the device.

The port of ``centerfusiondetect3d_tpu/ops/postprocess.py`` (reference
``src/lib/utils/postProcess.py:13-85``): inverse-affine mapping back to
original-image pixels, 8-bin alpha decoding, unprojection to camera-space 3D
locations and yaws, yaw-aligned velocity and 3D corner boxes, all on static
(B, K) shapes.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry.transforms3d import get_3d_box, get_alpha, img_to_cam_coord


def post_process(y: Dict[str, torch.Tensor], trans_mat, output_size, calibs,
                 is_gt: bool = False) -> Dict[str, torch.Tensor]:
    """Map decoded detections to original-image and camera coordinates.

    trans_mat: (2, 3) shared or (B, 2, 3) per-image inverse affines (output
    plane -> original image); calibs (B, 3, 4); is_gt: the reference's
    ground-truth mode (no amodal shift). Returns a new dict with 1-based
    classIds, centers/bboxes in original-image pixels, alpha, locations,
    yaws, realigned velocity and bboxes3d.
    """
    y = dict(y)
    out_h, out_w = output_size
    ref = y["scores"]
    trans_mat = torch.as_tensor(trans_mat, dtype=torch.float32,
                                device=ref.device)

    def affine(points):  # (B, ..., 2) -> (B, ..., 2)
        if trans_mat.dim() == 2:
            return points @ trans_mat[:, :2].T + trans_mat[:, 2]
        b = points.shape[0]
        flat = points.reshape(b, -1, 2)
        out = (torch.einsum("bkj,bij->bki", flat, trans_mat[:, :, :2])
               + trans_mat[:, None, :, 2])
        return out.reshape(points.shape)

    y["classIds"] = y["classIds"] + 1
    y["centers"] = y["centers"] * ref.new_tensor([out_w, out_h])

    if "bboxes" in y:
        b, k = y["bboxes"].shape[:2]
        y["bboxes"] = affine(y["bboxes"].reshape(b, k, 2, 2)).reshape(b, k, 4)
    if "depth" in y:
        y["depth"] = y["depth"].reshape(y["depth"].shape[0], -1)
    if "rotation" in y:
        y["alpha"] = get_alpha(y.pop("rotation"))

    if {"alpha", "depth", "dimension"} <= set(y):
        if not is_gt and "amodal_offset" in y:
            y["centers"] = affine(y["centers"] + y["amodal_offset"])
        elif not is_gt and "bboxes" in y:
            b, k = y["bboxes"].shape[:2]
            y["centers"] = y["bboxes"].reshape(b, k, 2, 2).mean(dim=2)
        y["locations"], y["yaws"] = img_to_cam_coord(
            y["centers"], y["alpha"], y["dimension"], y["depth"], calibs)

    if not is_gt and {"velocity", "yaws"} <= set(y):
        vel = y["velocity"]
        speed = torch.sqrt(vel[..., 0] ** 2 + vel[..., 2] ** 2)
        y["velocity"] = torch.stack([torch.cos(y["yaws"]) * speed,
                                     vel[..., 1],
                                     -torch.sin(y["yaws"]) * speed], dim=-1)

    if {"dimension", "locations", "yaws"} <= set(y):
        boxes3d = get_3d_box(y["dimension"], y["locations"], y["yaws"])
        valid = (y["dimension"] > 0).all(dim=-1)
        y["bboxes3d"] = torch.where(valid[..., None, None], boxes3d,
                                    torch.zeros_like(boxes3d))
    return y
