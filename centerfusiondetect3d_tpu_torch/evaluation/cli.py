"""Standalone evaluation CLI.

The port of ``centerfusiondetect3d_tpu/evaluation/cli.py`` (reference
``src/lib/nuScenes_lib/evaluate.py``'s CLI, run from
``nuscenes.py:573-585``)::

    python -m centerfusiondetect3d_tpu_torch.evaluation.cli results.json \\
        --output_dir out/ --eval_set mini_val --dataroot data/nuscenes \\
        --version v1.0-mini

It reads the ground truth of the submission's samples from the raw
nuScenes tables (no devkit), runs the multi-range and extreme-scene
evaluation and writes a ``metrics_summary.json`` per variant; it returns
the summaries by variant. Host numpy only: no device is used.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="nuScenes detection evaluation")
    p.add_argument("result_path", help="submission results json")
    p.add_argument("--output_dir", default="nuscenes_eval_output")
    p.add_argument("--eval_set", default="val",
                   help="split name (the ground truth is restricted to the "
                        "submission's samples)")
    p.add_argument("--dataroot", default="data/nuscenes")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--plot_examples", type=int, default=0,
                   help="unused (no map renders)")
    p.add_argument("--render_curves", type=int, default=0,
                   help="write PR curve data json")
    args = p.parse_args(argv)

    from . import DetectionEval, add_ego_translation, load_gt

    with open(args.result_path) as f:
        submission = json.load(f)
    tokens = set(submission["results"].keys())
    gt_boxes, descriptions, ego, bike_racks = load_gt(
        args.dataroot, args.version, tokens)
    add_ego_translation(gt_boxes, ego)
    ev = DetectionEval(gt_boxes, args.result_path, args.output_dir,
                       sample_scene_description=descriptions,
                       bike_racks=bike_racks, verbose=bool(args.verbose))
    ev.pred_boxes = add_ego_translation(ev.pred_boxes, ego)
    summaries = ev.run()
    if args.verbose:
        m = summaries.get("range_all", {})
        print(f"mAP: {m.get('mean_ap', 0):.4f}  "
              f"NDS: {m.get('nd_score', 0):.4f}")
    return summaries


if __name__ == "__main__":
    main()
