"""KITTI-format label files of detections.

The port of ``centerfusiondetect3d_tpu/evaluation/kitti_export.py``
(reference ``src/lib/nuScenes_lib/utils_kitti.py`` and
``export_kitti.py``): one KITTI label file per image from the per-image
detection dicts (camera-frame location, dimension and yaw, alpha, 2D box,
score).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

# nuScenes detection names -> KITTI type names
KITTI_TYPES = {
    "car": "Car",
    "truck": "Truck",
    "bus": "Truck",
    "trailer": "Truck",
    "construction_vehicle": "Misc",
    "pedestrian": "Pedestrian",
    "motorcycle": "Cyclist",
    "bicycle": "Cyclist",
    "traffic_cone": "Misc",
    "barrier": "Misc",
}


def detection_to_kitti_line(item: dict, class_names) -> str:
    """One detection -> one KITTI label line: type truncated occluded alpha
    bbox(4) dimensions(h w l) location(x y z) rotation_y score."""
    name = class_names[int(item["class"] - 1)]
    ktype = KITTI_TYPES.get(name, "Misc")
    h, w, l = [float(v) for v in np.asarray(item["dimension"])]
    x, y, z = [float(v) for v in np.asarray(item["location"])]
    yaw = float(item["yaw"])
    bbox = [float(v) for v in np.asarray(item.get("bbox", [0, 0, 0, 0]))]
    alpha = float(item.get("alpha", yaw - np.arctan2(x, z)))
    return (f"{ktype} 0.00 0 {alpha:.2f} "
            f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} "
            f"{x:.2f} {y:.2f} {z:.2f} {yaw:.2f} {item['score']:.4f}")


def export_kitti(results: Dict[int, List[dict]], out_dir: str, class_names,
                 conf_thresh: float = 0.0) -> int:
    """Writes results[img_id] to ``out_dir/{img_id:06d}.txt``; returns the
    number of files."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for img_id, items in results.items():
        lines = [detection_to_kitti_line(it, class_names) for it in items
                 if it["score"] >= conf_thresh]
        with open(os.path.join(out_dir, f"{int(img_id):06d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        n += 1
    return n
