"""Detection evaluation orchestrator: AP/TP/NDS, multi-range, extreme scenes.

The port's own copy of ``centerfusiondetect3d_tpu/evaluation/evaluate.py``
(numpy only), unchanged but for this paragraph.

Re-design of the reference's modified nuScenes evaluator
(reference src/lib/nuScenes_lib/evaluate.py:42-531) without the devkit:
evaluates a submission JSON against ground truth over the official distance
thresholds, then repeats for the reference's range bands {0-10, 10-30,
30-50, all} and night/rain ("extreme") scene subsets, writing a
``metrics_summary.json`` per variant.

Ground truth can come from (a) raw nuScenes table JSONs (self-contained
parser, see ``gt_loader``) or (b) any EvalBoxes built programmatically.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from .detection import (
    DetectionConfig,
    EvalBoxes,
    TP_METRICS,
    deserialize_results,
    filter_eval_boxes,
)
from .algo import accumulate, calc_ap, calc_tp, nd_score

# reference multi-range variants (evaluate.py:93-101): max range clamped, and
# a min-dist band of max(0, range - 20)
RANGE_VARIANTS = {"10": 10.0, "30": 30.0, "50": 50.0, "all": None}
# exact comma-separated description segments, as the reference matches them
# (evaluate.py:106-112 key_dict + loaders.py:273-280 set intersection) —
# substring matching would miss 'dark' scenes not containing 'night'
EXTREME_KEYWORDS = ("dark", "very dark", "Night", "Rain", "heavy rain")


def is_extreme_description(description: str) -> bool:
    """True when a scene description names a night/rain condition."""
    segs = {s.strip() for s in description.split(",")}
    return bool(segs & set(EXTREME_KEYWORDS))


def evaluate_boxes(gt_boxes: EvalBoxes, pred_boxes: EvalBoxes,
                   config: Optional[DetectionConfig] = None,
                   return_curves: bool = False) -> Dict:
    """Full metric computation for one (already filtered) box set."""
    config = config or DetectionConfig()
    classes = sorted(config.class_range.keys())

    metric_data = {}
    for cls in classes:
        for dist_th in config.dist_ths:
            metric_data[(cls, dist_th)] = accumulate(gt_boxes, pred_boxes, cls, dist_th)

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp_errors: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        label_aps[cls] = {
            d: calc_ap(metric_data[(cls, d)], config.min_recall, config.min_precision)
            for d in config.dist_ths
        }
        md_tp = metric_data[(cls, config.dist_th_tp)]
        errors = {}
        for m in TP_METRICS:
            if cls in ("traffic_cone",) and m in ("attr_err", "vel_err", "orient_err"):
                errors[m] = np.nan
            elif cls in ("barrier",) and m in ("attr_err", "vel_err"):
                errors[m] = np.nan
            else:
                errors[m] = calc_tp(md_tp, config.min_recall, m)
        label_tp_errors[cls] = errors

    mean_dist_aps = {
        cls: float(np.mean(list(aps.values()))) for cls, aps in label_aps.items()
    }
    mean_ap = float(np.mean(list(mean_dist_aps.values()))) if mean_dist_aps else 0.0
    tp_errors = {
        m: float(np.nanmean([label_tp_errors[c][m] for c in classes]))
        for m in TP_METRICS
    }
    nds = nd_score(mean_ap, tp_errors, config.mean_ap_weight)

    out = {
        "label_aps": {c: {str(k): v for k, v in a.items()} for c, a in label_aps.items()},
        "mean_dist_aps": mean_dist_aps,
        "mean_ap": mean_ap,
        "label_tp_errors": label_tp_errors,
        "tp_errors": tp_errors,
        "nd_score": nds,
    }
    if return_curves:
        # PR + TP curves per (class, dist_th) for rendering (the reference
        # writes PR/TP plots and an mAR.csv - evaluate.py:265-315)
        out["curves"] = {
            f"{cls}:{d}": {
                "recall": md["recall"].tolist(),
                "precision": md["precision"].tolist(),
                "confidence": md["confidence"].tolist(),
            }
            for (cls, d), md in metric_data.items()
        }
        out["max_recall"] = {
            cls: float(metric_data[(cls, config.dist_th_tp)]["max_recall"])
            for cls in classes
        }
    return out


class DetectionEval:
    """Multi-range + extreme-scene evaluation (evaluate.py:42-531)."""

    def __init__(self, gt_boxes: EvalBoxes, results_path: str, output_dir: str,
                 config: Optional[DetectionConfig] = None,
                 sample_scene_description: Optional[Dict[str, str]] = None,
                 bike_racks: Optional[Dict[str, list]] = None,
                 verbose: bool = False):
        self.base_config = config or DetectionConfig()
        self.output_dir = output_dir
        self.verbose = verbose
        self.gt_boxes = gt_boxes
        self.scene_desc = sample_scene_description or {}
        self.bike_racks = bike_racks or {}
        with open(results_path) as f:
            submission = json.load(f)
        self.pred_boxes = deserialize_results(
            submission, self.base_config.max_boxes_per_sample
        )

    def _scene_filter(self, extreme: bool) -> Optional[Callable[[str], bool]]:
        if not extreme:
            return None
        desc = self.scene_desc

        def keep(token: str) -> bool:
            return is_extreme_description(desc.get(token, ""))

        return keep

    def run(self) -> Dict[str, Dict]:
        os.makedirs(self.output_dir, exist_ok=True)
        summaries = {}
        for extreme in (False, True):
            for name, max_range in RANGE_VARIANTS.items():
                cfg = DetectionConfig(
                    class_range=dict(self.base_config.class_range),
                    dist_ths=self.base_config.dist_ths,
                    dist_th_tp=self.base_config.dist_th_tp,
                    min_recall=self.base_config.min_recall,
                    min_precision=self.base_config.min_precision,
                    max_boxes_per_sample=self.base_config.max_boxes_per_sample,
                    mean_ap_weight=self.base_config.mean_ap_weight,
                )
                if max_range is not None:
                    cfg.class_range = {
                        k: min(v, max_range) for k, v in cfg.class_range.items()
                    }
                    cfg.min_dist = max(0.0, max_range - 20.0)
                scene_filter = self._scene_filter(extreme)
                gt_f = filter_eval_boxes(self.gt_boxes, cfg, scene_filter,
                                         bike_racks=self.bike_racks)
                pred_f = filter_eval_boxes(self.pred_boxes, cfg, scene_filter,
                                           bike_racks=self.bike_racks)
                full = name == "all" and not extreme
                metrics = evaluate_boxes(gt_f, pred_f, cfg, return_curves=full)

                variant = f"range_{name}{'_extreme' if extreme else ''}"
                out_dir = os.path.join(self.output_dir, variant)
                os.makedirs(out_dir, exist_ok=True)
                curves = metrics.pop("curves", None)
                max_recall = metrics.pop("max_recall", None)
                with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
                    json.dump(_jsonable(metrics), f, indent=2)
                if curves is not None:
                    with open(os.path.join(out_dir, "pr_curves.json"), "w") as f:
                        json.dump(_jsonable(curves), f)
                if max_recall is not None:
                    # mAR.csv analogue (reference evaluate.py writes mAR.csv)
                    with open(os.path.join(out_dir, "mAR.csv"), "w") as f:
                        f.write("class,max_recall\n")
                        for cls, r in max_recall.items():
                            f.write(f"{cls},{r:.4f}\n")
                summaries[variant] = metrics
                if self.verbose:
                    print(f"{variant}: mAP={metrics['mean_ap']:.4f} "
                          f"NDS={metrics['nd_score']:.4f}")
        return summaries


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return float(x)
    if isinstance(x, float) and np.isnan(x):
        return None
    return x
