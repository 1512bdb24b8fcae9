"""nuScenes detection evaluation without the devkit: the port's copy of
``centerfusiondetect3d_tpu/evaluation`` (NDS scoring, the multi-range and
extreme variants, the CLI ``evaluation/cli.py``, KITTI interchange
``evaluation/kitti.py`` and the KITTI label export
``evaluation/kitti_export.py``)."""

from .detection import (
    DetectionConfig,
    EvalBox,
    EvalBoxes,
    DETECTION_NAMES,
    TP_METRICS,
    deserialize_results,
    filter_eval_boxes,
    add_ego_translation,
)
from .algo import accumulate, calc_ap, calc_tp, nd_score
from .evaluate import DetectionEval, evaluate_boxes, RANGE_VARIANTS
from .gt_loader import load_gt, NuScenesTables
from .kitti import (
    box_nuscenes_to_kitti,
    box_kitti_to_nuscenes_lidar,
    parse_label_line,
    box_to_string,
    project_kitti_box_to_image,
    nuscenes_gt_to_kitti,
    kitti_results_to_nuscenes,
)

__all__ = [
    "DetectionConfig",
    "EvalBox",
    "EvalBoxes",
    "DETECTION_NAMES",
    "TP_METRICS",
    "deserialize_results",
    "filter_eval_boxes",
    "add_ego_translation",
    "accumulate",
    "calc_ap",
    "calc_tp",
    "nd_score",
    "DetectionEval",
    "evaluate_boxes",
    "RANGE_VARIANTS",
    "load_gt",
    "NuScenesTables",
    "box_nuscenes_to_kitti",
    "box_kitti_to_nuscenes_lidar",
    "parse_label_line",
    "box_to_string",
    "project_kitti_box_to_image",
    "nuscenes_gt_to_kitti",
    "kitti_results_to_nuscenes",
]
