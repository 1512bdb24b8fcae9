"""Post-processed detection tensors -> per-image result items (host).

The port's own copy of ``detections_to_results`` from
``centerfusiondetect3d_tpu/data/nuscenes_eval.py``; the submission and
evaluation parts of that module wait for the evaluation slice.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


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
