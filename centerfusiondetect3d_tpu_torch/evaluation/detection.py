"""nuScenes detection-eval data model and configuration.

The port's own copy of ``centerfusiondetect3d_tpu/evaluation/detection.py``
(numpy only), unchanged but for this paragraph.

Self-contained implementation of the nuScenes detection protocol data types
(without the nuscenes-devkit). Covers what the reference's
modified evaluator uses (reference src/lib/nuScenes_lib/evaluate.py,
loaders.py): EvalBox records with global-frame translation/size/rotation/
velocity, per-class range filtering, and the official metric configuration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

DETECTION_NAMES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
)

ATTRIBUTE_NAMES = (
    "cycle.with_rider", "cycle.without_rider",
    "pedestrian.moving", "pedestrian.standing", "pedestrian.sitting_lying_down",
    "vehicle.moving", "vehicle.parked", "vehicle.stopped", "",
)

# official cvpr-2019 config class ranges (meters)
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50, "construction_vehicle": 50,
    "pedestrian": 40, "motorcycle": 40, "bicycle": 40,
    "traffic_cone": 30, "barrier": 30,
}

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


@dataclass
class DetectionConfig:
    class_range: Dict[str, float] = field(default_factory=lambda: dict(CLASS_RANGE))
    dist_ths: tuple = (0.5, 1.0, 2.0, 4.0)
    dist_th_tp: float = 2.0
    min_recall: float = 0.1
    min_precision: float = 0.1
    max_boxes_per_sample: int = 500
    mean_ap_weight: float = 5.0
    # reference extension: clamp ranges for multi-range eval with a min-dist
    # band (evaluate.py:93-101)
    min_dist: float = 0.0


@dataclass
class EvalBox:
    sample_token: str
    translation: np.ndarray  # (3,) global
    size: np.ndarray  # (3,) w, l, h
    rotation: np.ndarray  # (4,) quaternion w x y z
    velocity: np.ndarray  # (2,) global vx, vy
    detection_name: str = ""
    detection_score: float = -1.0
    attribute_name: str = ""
    ego_translation: np.ndarray = None  # (3,) box center relative to ego
    num_pts: int = -1

    @property
    def ego_dist(self) -> float:
        if self.ego_translation is None:
            return 0.0
        return float(np.hypot(self.ego_translation[0], self.ego_translation[1]))


class EvalBoxes:
    """sample_token -> list of EvalBox."""

    def __init__(self):
        self.boxes: Dict[str, List[EvalBox]] = {}

    def add_boxes(self, sample_token: str, boxes: List[EvalBox]):
        self.boxes.setdefault(sample_token, []).extend(boxes)

    def __getitem__(self, token: str) -> List[EvalBox]:
        return self.boxes.get(token, [])

    @property
    def sample_tokens(self):
        return list(self.boxes.keys())

    @property
    def all(self) -> List[EvalBox]:
        return [b for boxes in self.boxes.values() for b in boxes]

    def __len__(self):
        return len(self.boxes)


def deserialize_results(results: Dict, max_boxes: int = 500) -> EvalBoxes:
    """Parse a submission dict {'results': {token: [records]}} into EvalBoxes."""
    out = EvalBoxes()
    for token, records in results["results"].items():
        assert len(records) <= max_boxes, (
            f"{len(records)} boxes for sample {token} exceeds limit {max_boxes}"
        )
        boxes = [
            EvalBox(
                sample_token=token,
                translation=np.asarray(r["translation"], np.float64),
                size=np.asarray(r["size"], np.float64),
                rotation=np.asarray(r["rotation"], np.float64),
                velocity=np.asarray(r.get("velocity", (0, 0))[:2], np.float64),
                detection_name=r["detection_name"],
                detection_score=float(r.get("detection_score", -1.0)),
                attribute_name=r.get("attribute_name", ""),
            )
            for r in records
        ]
        out.add_boxes(token, boxes)
    return out


def add_ego_translation(boxes: EvalBoxes, ego_positions: Dict[str, np.ndarray]):
    """Fill per-box ego-relative translation from sample -> ego xyz map."""
    for token in boxes.sample_tokens:
        pose = ego_positions.get(token)
        if pose is None:
            continue
        for box in boxes[token]:
            box.ego_translation = box.translation - np.asarray(pose, np.float64)
    return boxes


def _point_in_box(point: np.ndarray, translation, size, rotation) -> bool:
    """Is a global-frame point inside an oriented box (devkit points_in_box)?

    size is (w, l, h); the box frame has x along length, y along width.
    """
    from ..utils import quaternion as quat

    local = quat.rotate(quat.inverse(np.asarray(rotation, np.float64)),
                        np.asarray(point, np.float64)
                        - np.asarray(translation, np.float64))
    w, l, h = np.asarray(size, np.float64)
    return (abs(local[0]) <= l / 2 and abs(local[1]) <= w / 2
            and abs(local[2]) <= h / 2)


def filter_eval_boxes(boxes: EvalBoxes, config: DetectionConfig,
                      scene_filter=None, bike_racks=None) -> EvalBoxes:
    """Range (+ min-dist band, zero-point, bike-rack, scene keyword)
    filtering (loaders.py:248-341).

    bike_racks: sample_token -> list of bicycle-rack box dicts
    (translation/size/rotation). Bicycle/motorcycle boxes whose center lies
    inside any rack are dropped (loaders.py:297-329). The zero-point filter
    only affects GT boxes (predictions carry num_pts = -1).
    """
    out = EvalBoxes()
    for token in boxes.sample_tokens:
        if scene_filter is not None and not scene_filter(token):
            # the reference keeps the sample token with an EMPTY box list
            # (loaders.py:273-279 clears eval_boxes.boxes[token]) so the
            # pred/gt sample sets still line up downstream
            out.add_boxes(token, [])
            continue
        kept = [
            b
            for b in boxes[token]
            if b.detection_name in config.class_range
            # STRICT band on both sides (loaders.py:285-288: ego_dist <
            # max AND ego_dist > min) — a box exactly at min_dist is
            # outside. The lower bound only applies when a band is set:
            # min_dist == 0 is the full-range case, where boxes with
            # unknown ego context (ego_dist 0.0) must not be dropped
            and b.ego_dist < config.class_range[b.detection_name]
            and (config.min_dist <= 0 or b.ego_dist > config.min_dist)
            and b.num_pts != 0
        ]
        racks = (bike_racks or {}).get(token, [])
        if racks:
            kept = [
                b for b in kept
                if b.detection_name not in ("bicycle", "motorcycle")
                or not any(
                    _point_in_box(b.translation, r["translation"], r["size"],
                                  r["rotation"])
                    for r in racks
                )
            ]
        out.add_boxes(token, kept)
    return out
