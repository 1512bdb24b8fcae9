"""Single-camera inference CLI of the port: an image, a folder, a video or
the webcam.

The port of ``centerfusiondetect3d_tpu/inference.py`` (reference
``src/inference.py:21-157``)::

    python -m centerfusiondetect3d_tpu_torch.inference --input PATH|webcam
        [--cfg configs/X.yaml] [--load model.pt] [--device cuda|cpu]
        [--stream] [--save-dir DIR] [--show-attention] [--conf-thresh 0.3]
        [KEY VALUE ...]

It serves each frame with ``runtime/detector.py:Detector`` (on the CUDA
card unless ``--device`` names another device; never a silent CPU
fallback), prints the stage times, and returns the detections by frame
name. ``--load`` reads a reference ``.pt`` checkpoint
(``training/checkpoint.py``; the port has no orbax format); without it the
model keeps its own initialization. ``--stream`` pipelines the frames
through ``Detector.run_stream``. ``--save-dir`` writes ``<stem>_det.jpg``
(the boxes above ``--conf-thresh`` drawn on the decoded frame, divided by
its decode scale) and ``results.json``; ``--show-attention`` adds
``<stem>_att_<map>.jpg`` overlays of the depth and radar maps. One
difference from the JAX CLI: with ``--stream`` and ``--save-dir`` the port
streams and writes ``results.json`` alone (streamed results carry no host
frames to draw on), where the JAX CLI falls back to the serial path.
Reading video and writing images needs opencv (``data/image_io.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .config import default_config, finalize_config, update_config
from .data import image_io
from .data.dataset import NuScenesDataset
from .runtime.detector import Detector
from .training.checkpoint import (CHECKPOINT_SUFFIXES, load_torch_file,
                                  load_weights)
from .utils.visualize import normalize_depthmaps

IMAGE_EXT = {".jpg", ".jpeg", ".png", ".webp"}
VIDEO_EXT = {".mp4", ".mov", ".avi", ".mkv"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CenterFusionDetect3D inference "
                                            "(PyTorch)")
    p.add_argument("--cfg", default=None, help="yaml config file")
    p.add_argument("--input", required=True,
                   help="image file, folder of images, video file, or "
                        "'webcam'")
    p.add_argument("--load", default="",
                   help="reference .pt checkpoint to load")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--save-dir", default="",
                   help="save annotated frames + results.json")
    p.add_argument("--show-attention", action="store_true",
                   help="save depth/attention-map overlays next to the "
                        "frames")
    p.add_argument("--conf-thresh", type=float, default=0.3)
    p.add_argument("--stream", action="store_true",
                   help="pipeline the frames through Detector.run_stream "
                        "(with --save-dir: results.json only)")
    p.add_argument("opts", nargs="*", default=[])
    return p.parse_args(argv)


def iter_frames(source: str):
    """(name, frame) pairs: a path for an image or each image of a folder
    (sorted), decoded BGR arrays for a video or the webcam."""
    if source == "webcam":
        for frame in image_io.video_frames(0):
            yield "webcam", frame
        return
    ext = os.path.splitext(source)[1].lower()
    if os.path.isdir(source):
        for name in sorted(os.listdir(source)):
            if os.path.splitext(name)[1].lower() in IMAGE_EXT:
                yield name, os.path.join(source, name)
    elif ext in VIDEO_EXT:
        for i, frame in enumerate(image_io.video_frames(source)):
            yield f"frame{i:06d}", frame
    else:
        yield os.path.basename(source), source


def draw_detections(img, items, class_names, conf_thresh: float,
                    scale: float = 1.0) -> np.ndarray:
    """A copy of ``img`` with each item above ``conf_thresh`` boxed and
    labelled. ``scale``: the factor by which ``img`` was downscaled at
    decode time (``TEST.FAST_DECODE``); detections are in original-image
    coordinates, so boxes are divided by it."""
    out = np.array(img, np.uint8, copy=True)
    for it in items:
        if it["score"] < conf_thresh or "bbox" not in it:
            continue
        box = [int(v / scale) for v in it["bbox"]]
        cls = class_names[int(it["class"] - 1)]
        image_io.draw_box(out, box, f"{cls} {it['score']:.2f}")
    return out


def _jsonable(items):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in it.items()} for it in items]


def _host_image(img) -> np.ndarray:
    return img.cpu().numpy() if isinstance(img, torch.Tensor) else img


def load_detector(args) -> Detector:
    config = update_config(default_config(), args.cfg, args.opts)
    config = finalize_config(config, NuScenesDataset.num_categories,
                             NuScenesDataset.default_resolution)
    detector = Detector(config, device=args.device)
    if args.load:
        if not args.load.endswith(CHECKPOINT_SUFFIXES):
            raise SystemExit(f"inference: --load takes a reference .pt "
                             f"checkpoint, not {args.load}")
        rep = load_weights(detector.model,
                           load_torch_file(args.load)["state_dict"])
        print(f"loaded {args.load}: {len(rep['loaded'])} keys loaded, "
              f"{len(rep['missing'])} missing")
    return detector


def main(argv=None):
    args = parse_args(argv)
    detector = load_detector(args)
    all_results = {}
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    if args.stream:
        names = []

        def frames():
            for name, frame in iter_frames(args.input):
                names.append(name)
                yield [frame], None, None

        n = 0
        for ret in detector.run_stream(frames()):
            all_results[names[n]] = _jsonable(ret["results"][0])
            n += 1
        stats = detector.stage_stats()
        print(f"processed {n} frames (streamed) | "
              + " ".join(f"{k} {v:.1f}ms" for k, v in sorted(stats.items())))
    else:
        n = 0
        for name, frame in iter_frames(args.input):
            ret = detector.run(frame)
            items = ret["results"][0]
            all_results[name] = _jsonable(items)
            n += 1
            if args.save_dir:
                _save_frame(args, name, ret, items)
        print(f"processed {n} frames | " + detector.timer.report())
    if args.save_dir:
        with open(os.path.join(args.save_dir, "results.json"), "w") as f:
            json.dump(all_results, f)
    return all_results


def _save_frame(args, name: str, ret, items) -> None:
    """``<stem>_det.jpg`` of one served frame (the frame ``run`` decoded,
    not a second decode) and, with ``--show-attention``, its overlays."""
    img = _host_image(ret["images"][0])
    vis = draw_detections(img, items, NuScenesDataset.class_name,
                          args.conf_thresh, scale=ret["decode_scales"][0])
    stem = os.path.splitext(name)[0]
    image_io.write_image(os.path.join(args.save_dir, f"{stem}_det.jpg"), vis)
    if args.show_attention:
        maps = normalize_depthmaps({k: v.float().cpu().numpy()
                                    for k, v in ret["extras"].items()})
        for key, m in maps.items():
            image_io.write_image(
                os.path.join(args.save_dir, f"{stem}_att_{key}.jpg"),
                image_io.attention_overlay(img, m[0]))


if __name__ == "__main__":
    main()
