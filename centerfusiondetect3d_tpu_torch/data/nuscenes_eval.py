"""Detections -> nuScenes submission JSON -> native evaluation.

The port's own copy of ``centerfusiondetect3d_tpu/data/nuscenes_eval.py``
(numpy only), unchanged but for this paragraph.

Re-design of the reference's eval-side conversion and scoring entry
(reference src/lib/dataset/datasets/nuscenes.py:416-626): camera-frame
detections become global-frame submission records (quaternion composition
pose_rot * cs_rot * yaw_cam instead of the devkit Box dance), attributes are
arg-maxed within the class's attribute group, velocities rotated to the
global frame, and per-sample results truncated to the top-500 by score. The
official scorer subprocess is replaced by the in-repo devkit-free evaluator
(evaluation/ package).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..utils import quaternion as quat


def detections_to_results(processed: Dict[str, np.ndarray], img_ids,
                          conf_thresh: float = -1.0) -> Dict[int, List[dict]]:
    """Post-processed batch tensors -> per-image detection item lists.

    Mirrors the reference ProgressBar accumulation + merge filter
    (progressBar.py:116-139, detector.py:428-468): keep score > thresh and
    positive dimensions.
    """
    results: Dict[int, List[dict]] = {}
    scores = np.asarray(processed["scores"])
    dims = np.asarray(processed["dimension"])
    classes = np.asarray(processed["classIds"], np.float64)
    locations = np.asarray(processed["locations"])
    yaws = np.asarray(processed["yaws"], np.float64)
    extras = [("bboxes" if key == "bboxes" else key,
               "bbox" if key == "bboxes" else key,
               np.asarray(processed[key]))
              for key in ("bboxes", "nuscenes_att", "velocity")
              if key in processed]
    # vectorized keep filter + bulk scalar conversion: the per-item numpy
    # scalar extraction loop costs ~10 ms/batch on a 1-core serving host
    keep = (scores > conf_thresh) & (dims > 0).all(axis=-1)
    b, _ = scores.shape
    for bi in range(b):
        (kis,) = np.nonzero(keep[bi])
        items = []
        for ki in kis.tolist():
            item = {
                "class": float(classes[bi, ki]),
                "score": float(scores[bi, ki]),
                "dimension": dims[bi, ki],
                "location": locations[bi, ki],
                "yaw": float(yaws[bi, ki]),
            }
            for _, out_key, arr in extras:
                item[out_key] = arr[bi, ki]
            items.append(item)
        results[int(img_ids[bi])] = items
    return results


def convert_coco_format(results: Dict[int, List[dict]]) -> List[dict]:
    """2D detections -> COCO results list (nuscenes.py:393-414)."""
    detections = []
    for image_id, items in results.items():
        for item in items:
            if "bbox" not in item:
                continue
            bbox = np.asarray(item["bbox"], np.float64)
            detections.append(
                {
                    "image_id": int(image_id),
                    "category_id": int(item["class"]),
                    "bbox": [
                        round(float(bbox[0]), 2),
                        round(float(bbox[1]), 2),
                        round(float(bbox[2] - bbox[0]), 2),
                        round(float(bbox[3] - bbox[1]), 2),
                    ],
                    "score": round(float(item["score"]), 2),
                }
            )
    return detections


def eval_format_item(item: dict, image_info: dict, class_names, cycles,
                     pedestrians, vehicles, id_to_attribute) -> dict:
    """One detection -> one submission record (nuscenes.py:416-482)."""
    trans_matrix = np.array(image_info["trans_matrix"], np.float64)
    velocity_mat = np.array(image_info["velocity_trans_matrix"], np.float64)

    class_name = class_names[int(item["class"] - 1)]
    score = float(item["score"])
    dim = np.asarray(item["dimension"], np.float64)  # (h, w, l)
    size = dim[[1, 2, 0]].tolist()  # (w, l, h)
    location = np.asarray(item["location"], np.float64).copy()
    location[1] -= size[2]  # bottom -> center height convention
    translation = trans_matrix @ np.array([*location, 1.0])

    # orientation: global = pose_rot * cs_rot * R_y(yaw)
    rot_cam = quat.from_axis_angle([0.0, 1.0, 0.0], float(item["yaw"]))
    q = quat.multiply(np.asarray(image_info["cs_record_rot"], np.float64), rot_cam)
    q = quat.multiply(np.asarray(image_info["pose_record_rot"], np.float64), q)

    att = ""
    if "nuscenes_att" in item:
        natt = np.asarray(item["nuscenes_att"])
        if class_name in cycles:
            att = id_to_attribute[int(np.argmax(natt[0:2])) + 1]
        elif class_name in pedestrians:
            att = id_to_attribute[int(np.argmax(natt[2:5])) + 3]
        elif class_name in vehicles:
            att = id_to_attribute[int(np.argmax(natt[5:8])) + 6]

    vel = np.zeros(3) if "velocity" not in item else np.asarray(item["velocity"])
    if vel.shape[0] == 2:
        # already a global (vx, vy) — passthrough (nuscenes.py:455-456)
        vel_global = np.asarray(vel, np.float64)
    else:
        vel_global = velocity_mat @ np.array([*vel[:3], 0.0], np.float64)

    return {
        "sample_token": image_info["sample_token"],
        "translation": translation[:3].tolist(),
        "size": size,
        "rotation": q.tolist(),
        "velocity": vel_global[:2].tolist(),
        "detection_name": class_name,
        "attribute_name": att,
        "detection_score": score,
        "tracking_name": class_name,
        "tracking_score": score,
        "tracking_id": 1,
        "sensor_id": image_info["sensor_id"],
        "det_id": -1,
    }


def convert_eval_format(results: Dict[int, List[dict]], dataset) -> dict:
    """Per-image detections -> submission dict (nuscenes.py:484-557)."""
    ret = {
        "meta": {
            "use_camera": True,
            "use_lidar": False,
            "use_radar": bool(dataset.config.DATASET.RADAR_PC),
            "use_map": False,
            "use_external": False,
        },
        "results": {},
    }
    for image_id in dataset.images:
        if image_id not in results:
            continue
        info = dataset.coco.load_imgs(image_id)[0]
        records = [
            eval_format_item(
                item, info, dataset.class_name, dataset.cycles,
                dataset.pedestrians, dataset.vehicles, dataset.id_to_attribute,
            )
            for item in results[image_id]
        ]
        ret["results"].setdefault(info["sample_token"], []).extend(records)

    # per-sample top-500 by score
    for token, records in ret["results"].items():
        records.sort(key=lambda r: -r["detection_score"])
        ret["results"][token] = records[:500]
    return ret


def run_eval(results: Dict[int, List[dict]], dataset, save_dir: str,
             verbose: bool = False):
    """Write submission json + run the native evaluator when GT is available.

    Returns (submission_path, summaries or None).
    """
    split = dataset.config.DATASET.VAL_SPLIT
    os.makedirs(save_dir, exist_ok=True)
    sub = convert_eval_format(results, dataset)
    sub_path = os.path.join(save_dir, f"results_nuscenes_det_{split}.json")
    with open(sub_path, "w") as f:
        json.dump(sub, f)
    if split == "test":
        return sub_path, None

    version = dataset.SPLITS.get(split, "v1.0-trainval")
    dataroot = dataset.img_dir
    if not os.path.isdir(os.path.join(dataroot, version)):
        return sub_path, None  # raw tables unavailable: submission only

    from ..evaluation import DetectionEval, add_ego_translation, load_gt

    tokens = {
        dataset.coco.load_imgs(i)[0]["sample_token"] for i in dataset.images
    }
    gt_boxes, descriptions, ego, bike_racks = load_gt(dataroot, version, tokens)
    add_ego_translation(gt_boxes, ego)

    output_dir = os.path.join(save_dir, f"nuscenes_eval_det_output_{split}")
    ev = DetectionEval(
        gt_boxes, sub_path, output_dir,
        sample_scene_description=descriptions, bike_racks=bike_racks,
        verbose=verbose,
    )
    # predictions need ego-relative distances too
    ev.pred_boxes = add_ego_translation(ev.pred_boxes, ego)
    summaries = ev.run()
    return sub_path, summaries
