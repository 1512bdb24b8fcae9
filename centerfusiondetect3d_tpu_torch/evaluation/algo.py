"""Core nuScenes detection metrics: matching, AP, TP errors, NDS.

The port's own copy of ``centerfusiondetect3d_tpu/evaluation/algo.py``
(numpy only), unchanged but for this paragraph.

Self-contained re-implementation of the official accumulation algorithm as
used by the reference (reference src/lib/nuScenes_lib/algo.py:21-207):
greedy center-distance matching sorted by confidence, 101-point interpolated
precision, TP metric curves averaged over the achieved recall range, and the
nuScenes detection score.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils import quaternion as quat
from .detection import EvalBoxes, TP_METRICS

N_REC = 101  # recall interpolation points


def center_distance(a, b) -> float:
    return float(np.hypot(a.translation[0] - b.translation[0],
                          a.translation[1] - b.translation[1]))


def velocity_l2(gt, pred) -> float:
    return float(np.linalg.norm(np.asarray(pred.velocity) - np.asarray(gt.velocity)))


def scale_iou(gt, pred) -> float:
    """IoU of aligned, centered boxes (pure size comparison)."""
    mins = np.minimum(gt.size, pred.size)
    inter = np.prod(mins)
    union = np.prod(gt.size) + np.prod(pred.size) - inter
    return float(inter / union)


def yaw_diff(gt, pred, period: float = 2 * np.pi) -> float:
    yg = quat.yaw_from_quaternion(gt.rotation)
    yp = quat.yaw_from_quaternion(pred.rotation)
    d = (yg - yp) % period
    if d > period / 2:
        d = period - d
    return float(abs(d))


def attr_acc(gt, pred) -> float:
    if gt.attribute_name == "":
        return np.nan
    return float(gt.attribute_name == pred.attribute_name)


def cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit semantics)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(float))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals > 0)


def accumulate(gt_boxes: EvalBoxes, pred_boxes: EvalBoxes, class_name: str,
               dist_th: float) -> Dict:
    """Match predictions to GT for one class/threshold; return metric curves."""
    npos = sum(1 for b in gt_boxes.all if b.detection_name == class_name)
    if npos == 0:
        return {"recall": np.linspace(0, 1, N_REC), "precision": np.zeros(N_REC),
                "confidence": np.zeros(N_REC), "npos": 0, "max_recall": 0.0,
                **{m: np.ones(N_REC) for m in TP_METRICS}}

    preds: List = [
        b for b in pred_boxes.all if b.detection_name == class_name
    ]
    # descending by (score, insertion index) — on exact score ties the
    # LATER box is matched first, like the reference's
    # ``sorted((v, i) ...)[::-1]`` (algo.py:74); a stable descending sort
    # would flip tie order and change which GT each tied box greedily takes
    order = [i for (v, i) in
             sorted((b.detection_score, i) for i, b in enumerate(preds))][::-1]
    preds = [preds[i] for i in order]

    taken = set()
    tp, fp, conf = [], [], []
    match_data = {m: [] for m in TP_METRICS}
    match_data["conf"] = []

    for pred in preds:
        best_dist, best_idx = np.inf, None
        for i, gt in enumerate(gt_boxes[pred.sample_token]):
            if gt.detection_name == class_name and (pred.sample_token, i) not in taken:
                d = center_distance(gt, pred)
                if d < best_dist:
                    best_dist, best_idx = d, i

        if best_idx is not None and best_dist < dist_th:
            taken.add((pred.sample_token, best_idx))
            tp.append(1)
            fp.append(0)
            conf.append(pred.detection_score)
            gt = gt_boxes[pred.sample_token][best_idx]
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match_data["trans_err"].append(center_distance(gt, pred))
            match_data["vel_err"].append(velocity_l2(gt, pred))
            match_data["scale_err"].append(1.0 - scale_iou(gt, pred))
            match_data["orient_err"].append(yaw_diff(gt, pred, period))
            acc = attr_acc(gt, pred)
            match_data["attr_err"].append(np.nan if np.isnan(acc) else 1.0 - acc)
            match_data["conf"].append(pred.detection_score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(pred.detection_score)

    if len(match_data["trans_err"]) == 0:
        return {"recall": np.linspace(0, 1, N_REC), "precision": np.zeros(N_REC),
                "confidence": np.zeros(N_REC), "npos": npos, "max_recall": 0.0,
                **{m: np.ones(N_REC) for m in TP_METRICS}}

    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.array(conf)

    prec = tp / (tp + fp)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_REC)
    precision = np.interp(rec_interp, rec, prec, right=0)
    confidence = np.interp(rec_interp, rec, conf, right=0)

    out = {"recall": rec_interp, "precision": precision, "confidence": confidence,
           "npos": npos,
           # exact achieved recall (reference algo.py:160-166 'Recall'
           # record, the mAR.csv source) — not the interpolated curve end
           "max_recall": float(rec[-1])}
    match_conf = np.array(match_data["conf"])
    for m in TP_METRICS:
        vals = cummean(np.array(match_data[m]))
        # map the TP-error curve onto the confidence axis (devkit semantics:
        # edge extrapolation on both sides)
        out[m] = np.interp(confidence[::-1], match_conf[::-1], vals[::-1])[::-1]
    return out


def calc_ap(md: Dict, min_recall: float, min_precision: float) -> float:
    """Normalized AP over the operating region (devkit semantics)."""
    prec = md["precision"].copy()
    prec = prec[round(100 * min_recall) + 1 :]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: Dict, min_recall: float, metric: str) -> float:
    """Mean TP error over [min_recall, max achieved recall]."""
    first = round(100 * min_recall) + 1
    # last achieved recall index: where confidence > 0
    nonzero = np.nonzero(md["confidence"])[0]
    if len(nonzero) == 0:
        return 1.0
    last = nonzero.max() + 1
    if last <= first:
        return 1.0
    return float(np.mean(md[metric][first:last]))


def nd_score(mean_ap: float, tp_errors: Dict[str, float],
             mean_ap_weight: float = 5.0) -> float:
    """NDS = (w*mAP + sum(1 - min(1, err))) / (w + n_tp)."""
    total = mean_ap_weight * mean_ap
    for m in TP_METRICS:
        total += max(1.0 - min(1.0, tp_errors[m]), 0.0)
    return total / (mean_ap_weight + len(TP_METRICS))
