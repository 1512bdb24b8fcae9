"""nuScenes detection evaluation without the devkit: the port's copy of
``centerfusiondetect3d_tpu/evaluation`` as far as NDS scoring goes (the
KITTI modules and the CLI are not ported)."""

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
]
