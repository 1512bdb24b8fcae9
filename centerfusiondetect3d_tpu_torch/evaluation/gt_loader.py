"""Ground-truth loading from raw nuScenes table JSONs (devkit-free).

The port's own copy of ``centerfusiondetect3d_tpu/evaluation/gt_loader.py``
(numpy only), unchanged but for this paragraph.

The reference delegates GT loading to the nuscenes-devkit
(reference src/lib/nuScenes_lib/loaders.py:22-247); this module parses
the raw relational tables (sample.json, sample_annotation.json, scene.json,
ego_pose.json, sample_data.json, attribute.json, category.json, instance.json)
directly: global-frame boxes, finite-difference velocities (the devkit's
box_velocity), ego positions, and scene descriptions for the extreme filter.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from .detection import EvalBox, EvalBoxes

# devkit category -> detection name mapping
_DETECTION_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def _load_table(dataroot: str, version: str, name: str):
    with open(os.path.join(dataroot, version, f"{name}.json")) as f:
        return json.load(f)


class NuScenesTables:
    """Indexed raw nuScenes tables."""

    def __init__(self, dataroot: str, version: str):
        self.sample = _load_table(dataroot, version, "sample")
        self.sample_by_token = {s["token"]: s for s in self.sample}
        self.annotations = _load_table(dataroot, version, "sample_annotation")
        self.ann_by_token = {a["token"]: a for a in self.annotations}
        self.scene = {s["token"]: s for s in _load_table(dataroot, version, "scene")}
        self.category = {
            c["token"]: c for c in _load_table(dataroot, version, "category")
        }
        self.instance = {
            i["token"]: i for i in _load_table(dataroot, version, "instance")
        }
        self.attribute = {
            a["token"]: a for a in _load_table(dataroot, version, "attribute")
        }
        try:
            self.ego_pose = {
                p["token"]: p for p in _load_table(dataroot, version, "ego_pose")
            }
            self.sample_data = _load_table(dataroot, version, "sample_data")
        except FileNotFoundError:
            self.ego_pose, self.sample_data = {}, []

    def scene_description(self, sample_token: str) -> str:
        sample = self.sample_by_token[sample_token]
        return self.scene.get(sample["scene_token"], {}).get("description", "")

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
        """Finite-difference global velocity (devkit box_velocity semantics)."""
        current = self.ann_by_token[ann_token]
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.ann_by_token[current["prev"]] if has_prev else current
        last = self.ann_by_token[current["next"]] if has_next else current
        pos_first = np.asarray(first["translation"], np.float64)
        pos_last = np.asarray(last["translation"], np.float64)
        t_first = 1e-6 * self.sample_by_token[first["sample_token"]]["timestamp"]
        t_last = 1e-6 * self.sample_by_token[last["sample_token"]]["timestamp"]
        if t_last - t_first > max_time_diff or t_last == t_first:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / (t_last - t_first)


def ego_positions_from_tables(tables: NuScenesTables,
                              ref_channel_keyword: str = "LIDAR_TOP"
                              ) -> Dict[str, np.ndarray]:
    """sample_token -> ego xyz, from the keyframe sample_data's ego pose."""
    out: Dict[str, np.ndarray] = {}
    for sd in tables.sample_data:
        if not sd.get("is_key_frame"):
            continue
        if ref_channel_keyword not in sd.get("filename", ""):
            continue
        pose = tables.ego_pose.get(sd["ego_pose_token"])
        if pose is not None:
            out[sd["sample_token"]] = np.asarray(pose["translation"], np.float64)
    return out


def load_gt(dataroot: str, version: str, sample_tokens=None) -> Tuple[
        EvalBoxes, Dict[str, str], Dict[str, np.ndarray], Dict[str, list]]:
    """GT EvalBoxes (+ scene descriptions, ego positions, bike racks) from
    raw tables.

    sample_tokens restricts to an eval split (default: every sample).
    The fourth return maps sample_token -> list of bicycle-rack boxes
    (``static_object.bicycle_rack`` annotations, each a dict with
    translation/size/rotation) for the bike-rack GT filter
    (reference loaders.py:297-329).
    """
    tables = NuScenesTables(dataroot, version)
    tokens = set(sample_tokens) if sample_tokens is not None else {
        s["token"] for s in tables.sample
    }
    # raw tables have no sample->annotations reverse index (that's a devkit
    # convenience); build it from sample_annotation.sample_token
    anns_by_sample: Dict[str, list] = {}
    for a in tables.annotations:
        anns_by_sample.setdefault(a["sample_token"], []).append(a)

    boxes = EvalBoxes()
    descriptions: Dict[str, str] = {}
    bike_racks: Dict[str, list] = {}
    for sample in tables.sample:
        token = sample["token"]
        if token not in tokens:
            continue
        descriptions[token] = tables.scene_description(token)
        sample_boxes = []
        for a in anns_by_sample.get(token, []):
            inst = tables.instance.get(a["instance_token"], {})
            cat = tables.category.get(inst.get("category_token", ""), {})
            if cat.get("name") == "static_object.bicycle_rack":
                bike_racks.setdefault(token, []).append(
                    {"translation": np.asarray(a["translation"], np.float64),
                     "size": np.asarray(a["size"], np.float64),
                     "rotation": np.asarray(a["rotation"], np.float64)}
                )
                continue
            det_name = _DETECTION_MAPPING.get(cat.get("name", ""))
            if det_name is None:
                continue
            attr = ""
            if a.get("attribute_tokens"):
                attr = tables.attribute.get(a["attribute_tokens"][0], {}).get("name", "")
            vel = tables.box_velocity(a["token"])[:2]
            sample_boxes.append(
                EvalBox(
                    sample_token=token,
                    translation=np.asarray(a["translation"], np.float64),
                    size=np.asarray(a["size"], np.float64),
                    rotation=np.asarray(a["rotation"], np.float64),
                    # keep NaN velocities (no prev/next neighbor): the
                    # devkit leaves them NaN so accumulate's cummean EXCLUDES
                    # those matches from vel_err; zeroing them inflates mAVE
                    velocity=vel,
                    detection_name=det_name,
                    attribute_name=attr,
                    num_pts=a.get("num_lidar_pts", -1) + a.get("num_radar_pts", 0),
                )
            )
        boxes.add_boxes(token, sample_boxes)
    ego = ego_positions_from_tables(tables)
    return boxes, descriptions, ego, bike_racks
