"""Training-target builder (host-side, numpy).

The port's own copy of ``centerfusiondetect3d_tpu/data/targets.py``
(reference ``src/lib/dataset/generic_dataset.py:441-708``): fixed-size
(max_objs) arrays for every head, per-layer gaussian heatmaps with the
CornerNet radius (elliptical for clipped amodal centers), 8-bin rotation
targets, and the train-time GT-frustum radar heatmap
(generic_dataset.py:673-687). The maps are NHWC, as the JAX package's items
are; ``data/pipeline.py:to_device`` lays them out NCHW on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..geometry.affine import apply_affine
from ..geometry.gaussian import draw_gaussian, gaussian_radius
from ..geometry.transforms3d import (
    distance_thresh_np,
    encode_alpha_8bin,
    encode_rotbin_rotres,
    get_3d_box_np,
)
from ..losses.generic import SIZE_THRESH


def cvt_pc_depth_to_heatmap(pc_hm, pc_dep, depth, bbox, dist_thresh, max_pc_dist):
    """Host-side frustum association for one GT box (pointcloud.py:397-481).

    pc_hm/pc_dep: (H, W, 3) NHWC [d, vx, vz]. Matches ops/frustum.py semantics
    (clamped crops; asymmetric +1 column on the paint rectangle).
    """
    if np.ndim(depth) > 0:
        depth = np.asarray(depth).reshape(-1)[0]
    height, width = pc_dep.shape[:2]
    cx, cy = (bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0
    x1, y1 = max(int(np.floor(bbox[0])), 0), max(int(np.floor(bbox[1])), 0)
    x2, y2 = int(np.ceil(bbox[2])), int(np.ceil(bbox[3]))
    roi = pc_dep[y1 : y2 + 1, x1 : x2 + 1]
    if roi.size == 0:
        return
    d = roi[..., 0]
    within = (d > 0) & (d < depth + dist_thresh) & (d > max(0.0, depth - dist_thresh))
    if not within.any():
        return
    vals = np.where(within, d, np.inf)
    iy, ix = np.unravel_index(np.argmin(vals), vals.shape)
    dist = d[iy, ix] / max_pc_dist
    vx, vz = roi[iy, ix, 1], roi[iy, ix, 2]

    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    w_min = max(int(cx - 0.3 * w / 2.0), 0)
    w_max = int(cx + 0.3 * w / 2.0)
    h_min = max(int(cy - 0.3 * h / 2.0), 0)
    h_max = int(cy + 0.3 * h / 2.0)
    pc_hm[h_min : h_max + 1, w_min : w_max + 2, 0] = dist
    pc_hm[h_min : h_max + 1, w_min : w_max + 2, 1] = vx
    pc_hm[h_min : h_max + 1, w_min : w_max + 2, 2] = vz


class TargetBuilder:
    """Builds the full per-sample training item from transformed annotations."""

    def __init__(self, config, num_classes: int, max_objs: int,
                 nuscenes_att_range=None):
        self.config = config
        self.num_classes = num_classes
        self.max_objs = max_objs
        self.heads = set(config.heads)
        self.att_range = nuscenes_att_range or {}
        n_layers = len(config.MODEL.PYRAMID_OUT_SIZE)
        self.size_thresh = [SIZE_THRESH[l] for l in range(n_layers)]

    def init_item(self) -> Dict[str, np.ndarray]:
        cfg = self.config
        m = self.max_objs
        item = {}
        for i, (h, w) in enumerate(cfg.MODEL.PYRAMID_OUT_SIZE):
            item[f"heatmap{i}"] = np.zeros((h, w, self.num_classes), np.float32)
        item["classIds"] = np.zeros((m,), np.int64)
        item["mask"] = np.zeros((m,), np.float32)
        item["truncMask"] = np.zeros((m,), np.float32)
        item["widthHeight"] = np.zeros((m, 2), np.float32)
        for head, dim in (("reg", 2), ("dimension", 3), ("amodal_offset", 2)):
            if head in self.heads:
                item[head] = np.zeros((m, dim), np.float32)
        if {"depth", "depth2"} & self.heads:
            item["depth"] = np.zeros((m, 1), np.float32)
        if {"rotation", "rotation2"} & self.heads:
            item["rotbin"] = np.zeros((m, 2), np.int64)
            item["rotres"] = np.zeros((m, 2), np.float32)
        if "nuscenes_att" in self.heads:
            item["nuscenes_att"] = np.zeros((m, 8), np.float32)
            item["nuscenes_att_mask"] = np.zeros((m, 8), np.float32)
        if "velocity" in self.heads:
            item["velocity"] = np.zeros((m, 3), np.float32)
        target = {
            "bboxes": np.zeros((m, 4), np.float32),
            "scores": np.zeros((m,), np.float32),
            "centers": np.zeros((m, 2), np.float32),
            "heatCenters": np.zeros((m, 2), np.float32),
            "bboxes3d": np.zeros((m, 8, 3), np.float32),
        }
        if {"rotation", "rotation2"} & self.heads:
            target["rotation"] = np.zeros((m, 8), np.float32)
        item["target"] = target
        return item

    def transform_bbox(self, bbox_xywh, trans_out) -> np.ndarray:
        """[x, y, w, h] -> clipped output-plane [x1, y1, x2, y2]
        (generic_dataset.py:495-526)."""
        x1, y1 = bbox_xywh[0], bbox_xywh[1]
        x2, y2 = x1 + bbox_xywh[2], y1 + bbox_xywh[3]
        rect = np.array([[x1, y1], [x1, y2], [x2, y2], [x2, y1]], np.float32)
        rect = apply_affine(rect, trans_out)
        oh, ow = self.config.MODEL.OUTPUT_SIZE
        return np.array(
            [
                np.clip(rect[:, 0].min(), 0, ow - 1),
                np.clip(rect[:, 1].min(), 0, oh - 1),
                np.clip(rect[:, 0].max(), 0, ow - 1),
                np.clip(rect[:, 1].max(), 0, oh - 1),
            ],
            np.float32,
        )

    def add_instance(self, item, i: int, class_id: int, bbox, ann: dict,
                     trans_out, scale_factor: float, calib=None, pc_dep=None,
                     pc_hm=None):
        """Write one object's targets (generic_dataset.py:528-687).

        class_id is 0-based; bbox is the transformed output-plane xyxy box.
        """
        cfg = self.config
        height, width = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if height <= 0 or width <= 0:
            return
        center = np.array(
            [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2], np.float32
        )
        out_h, out_w = cfg.MODEL.OUTPUT_SIZE
        item["classIds"][i] = class_id
        item["mask"][i] = 1
        item["truncMask"][i] = ann.get("truncated", 0)

        # pyramid layer by bbox-area fraction
        frac = (height * width) / (out_h * out_w)
        layer = len(self.size_thresh) - 1
        for l in range(len(self.size_thresh)):
            hi = self.size_thresh[l + 1] if l + 1 < len(self.size_thresh) else None
            if hi is None:
                layer = len(self.size_thresh) - 1
            elif self.size_thresh[l] <= frac < hi:
                layer = l
                break
        layer_h, layer_w = cfg.MODEL.PYRAMID_OUT_SIZE[layer]
        h_scale, w_scale = layer_h / out_h, layer_w / out_w
        layer_bh, layer_bw = height * h_scale, width * w_scale

        amodal_center = None
        if "amodal_center" in ann:
            amodal_center = apply_affine(
                np.asarray(ann["amodal_center"], np.float32).reshape(1, 2), trans_out
            ).reshape(2)

        obj_outside = False
        if cfg.DATASET.HEATMAP_REP == "2d" or amodal_center is None:
            heat_center = center * np.array([w_scale, h_scale], np.float32)
        else:  # 3d representation: amodal center, clipped into view
            heat_center = amodal_center.copy()
            clipped = np.array(
                [np.clip(heat_center[0], 0, out_w - 1), np.clip(heat_center[1], 0, out_h - 1)],
                np.float32,
            )
            obj_outside = not np.allclose(clipped, heat_center)
            heat_center = clipped

        if obj_outside:
            # 1-D elliptical heatmap for clipped amodal centers (MonoFlex)
            rx = max(1, int(layer_bw * 0.5))
            ry = max(1, int(layer_bh * 0.5))
            radius = (rx, ry)
        else:
            radius = max(0, int(gaussian_radius((math.ceil(layer_bh), math.ceil(layer_bw)))))
        draw_gaussian(item[f"heatmap{layer}"][..., class_id], heat_center, radius)

        t = item["target"]
        t["bboxes"][i] = bbox
        t["centers"][i] = center
        t["heatCenters"][i] = heat_center

        if "reg" in self.heads:
            item["reg"][i] = center - heat_center
        if "amodal_offset" in self.heads and amodal_center is not None:
            item["amodal_offset"][i] = amodal_center - heat_center
            if cfg.MODEL.NORM_2D:
                item["amodal_offset"][i] /= np.array([out_w, out_h], np.float32)
        if "widthHeight" in item:
            item["widthHeight"][i] = (
                (width / out_w, height / out_h) if cfg.MODEL.NORM_2D else (width, height)
            )
        if "nuscenes_att" in self.heads and ann.get("attributes", 0) > 0:
            att = int(ann["attributes"] - 1)
            item["nuscenes_att"][i][att] = 1
            item["nuscenes_att_mask"][i][self.att_range.get(att, [])] = 1
        if ("velocity" in self.heads and "velocity_cam" in ann
                and min(ann["velocity_cam"]) > -1000):
            item["velocity"][i] = np.asarray(ann["velocity_cam"], np.float32)[:3]
        if "rotation" in self.heads:
            alpha = ann.get("alpha")
            if alpha is not None:
                item["rotbin"][i], item["rotres"][i] = encode_rotbin_rotres(alpha)
                t["rotation"][i] = encode_alpha_8bin(alpha)
            else:
                t["rotation"][i] = encode_alpha_8bin(0.0)
        if "depth" in ann and {"depth", "depth2"} & self.heads:
            item["depth"][i] = ann["depth"] * scale_factor
        if "dimension" in self.heads and "dimension" in ann:
            item["dimension"][i] = ann["dimension"]
        if {"dimension", "location", "yaw"} <= set(ann):
            t["bboxes3d"][i] = get_3d_box_np(
                np.asarray(ann["dimension"], np.float32).reshape(1, 1, 3),
                np.asarray(ann["location"], np.float32).reshape(1, 1, 3),
                np.asarray(ann["yaw"], np.float32).reshape(1, 1),
            )[0, 0]

        # train-time GT-frustum radar heatmap
        if (cfg.DATASET.RADAR_PC and cfg.MODEL.FRUSTUM and pc_dep is not None
                and pc_hm is not None and "dimension" in ann and "alpha" in ann):
            thr = distance_thresh_np(
                np.asarray(calib, np.float32).reshape(1, 3, 4),
                center.reshape(1, 1, 2),
                np.asarray(ann["dimension"], np.float32).reshape(1, 1, 3),
                np.asarray(ann["alpha"], np.float32).reshape(1, 1),
            )[0, 0]
            cvt_pc_depth_to_heatmap(
                pc_hm, pc_dep, ann["depth"], bbox, thr, cfg.DATASET.MAX_PC_DIST
            )

    def build(self, anns: List[dict], class_id_map, trans_out, scale_factor: float,
              calib=None, pc_dep=None) -> Dict[str, np.ndarray]:
        """Full item from a sample's annotations."""
        cfg = self.config
        item = self.init_item()
        pc_hm = None
        if cfg.DATASET.RADAR_PC:
            oh, ow = cfg.MODEL.OUTPUT_SIZE
            pc_hm = np.zeros((oh, ow, 3), np.float32)
        for i, ann in enumerate(anns[: self.max_objs]):
            class_id = int(class_id_map.get(ann["category_id"], ann["category_id"]))
            if class_id > self.num_classes or class_id <= -999:
                continue
            bbox = self.transform_bbox(ann["bbox"], trans_out)
            self.add_instance(
                item, i, class_id - 1, bbox, ann, trans_out, scale_factor,
                calib=calib, pc_dep=pc_dep, pc_hm=pc_hm,
            )
        if pc_hm is not None:
            item["pc_hm"] = pc_hm
        return item
