"""nuScenes scene demo: a 3x2 mosaic of the six cameras beside a
bird's-eye view, per sample.

The port of ``centerfusiondetect3d_tpu/demo.py`` (reference
``src/demo.py:15-83``, ``datasets/nuscenes.py:633-1067``)::

    python -m centerfusiondetect3d_tpu_torch.demo [--cfg configs/X.yaml]
        [--split mini_val] [--load model.pt] [--device cuda|cpu]
        [--save-dir DIR] [--save-video out.mp4] [--max-samples N]
        [--show-attention] [--conf-thresh 0.3] [KEY VALUE ...]

It walks a converter-format split grouped by ``sample_token`` (up to six
cameras a sample), serves each sample as one batch through
``runtime/detector.py:Detector.run`` (on the CUDA card unless ``--device``
names another device; the dataset decodes its JPEGs on the same device),
draws each camera's 3D boxes above ``--conf-thresh`` and the model's radar
heatmap (``render_camera``), tiles the cameras into a 3x2 mosaic, draws
the bird's-eye view with the radar points and boxes of every camera in the
front camera's frame (``render_bev``), and prints the detections per camera
with the stage times of ``Detector.timer`` and ``Detector.stage_stats``.
``--save-dir`` writes ``<sample_token>.jpg`` per sample (and, with
``--show-attention`` and one camera a sample, the depth and radar maps'
overlays), ``--save-video`` an mp4 of the frames. Returns the per-sample
results.

Differences from the JAX demo: ``--load`` takes a reference ``.pt``
checkpoint (``training/checkpoint.py``; the port has no orbax format) and
refuses a directory; a video writer that cannot open raises, where the JAX
demo writes nothing without a word. Drawing and writing need opencv
(``data/image_io.py:opencv``).
"""

from __future__ import annotations

import argparse
import os
import warnings
from collections import defaultdict
from typing import Dict, List

import numpy as np

from .config import default_config, finalize_config, update_config
from .data import image_io
from .data.dataset import NuScenesDataset
from .geometry.transforms3d import get_3d_box_np, project_3d_points_np
from .runtime.detector import Detector
from .training.checkpoint import (CHECKPOINT_SUFFIXES, load_torch_file,
                                  load_weights)
from .utils.visualize import draw_box_3d, normalize_depthmaps

BEV_SIZE = 500
BEV_RANGE = 60.0
TILE_WH = (400, 224)  # one camera's tile of the 3x2 mosaic
BEV_PANEL = 448  # the bird's-eye view's side beside the mosaic


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CenterFusionDetect3D demo "
                                            "(PyTorch)")
    p.add_argument("--cfg", default=None, help="yaml config file")
    p.add_argument("--split", default="mini_val")
    p.add_argument("--load", default="",
                   help="reference .pt checkpoint to load")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--save-dir", default="", help="save mosaic frames")
    p.add_argument("--save-video", default="",
                   help="write the mosaic stream to an mp4")
    p.add_argument("--max-samples", type=int, default=0, help="0 = all")
    p.add_argument("--show-attention", action="store_true",
                   help="save per-head depth/attention overlays (one camera "
                        "a sample only, like the reference showAttention, "
                        "generic_dataset.py:1208-1237)")
    p.add_argument("--conf-thresh", type=float, default=0.3)
    p.add_argument("opts", nargs="*", default=[])
    return p.parse_args(argv)


def render_camera(img, items, calib, conf_thresh: float):
    """A copy of ``img`` with the 3D box of each item above ``conf_thresh``
    that lies in front of the camera, projected through ``calib``."""
    out = img.copy()
    for it in items:
        if it["score"] < conf_thresh:
            continue
        corners = get_3d_box_np(np.asarray(it["dimension"]).reshape(1, 1, 3),
                                np.asarray(it["location"]).reshape(1, 1, 3),
                                np.asarray(it["yaw"]).reshape(1, 1))
        if corners[..., 2].min() > 0:
            pts = project_3d_points_np(
                corners.astype(np.float32),
                calib.reshape(1, 1, 3, 4).astype(np.float32))[0, 0]
            draw_box_3d(out, pts, color=(0, 255, 0))
    return out


def render_bev(items_by_cam: Dict[int, List[dict]], radar_pcs,
               conf_thresh: float, infos: List[dict] = None):
    """The bird's-eye view: the ego at the centre, range rings, radar
    points and detection rectangles.

    Detections and radar points arrive in each camera's own frame. Where
    ``infos`` carry the converter's per-image ``trans_matrix``
    (camera -> global), every other camera's boxes and points are moved
    into the front camera's frame (the reference converts to global before
    its devkit render, nuscenes.py:420-430); without them each camera is
    drawn in its own frame."""
    cv2 = image_io.opencv("drawing the bird's-eye view")
    canvas = np.full((BEV_SIZE, BEV_SIZE, 3), 30, np.uint8)
    scale = BEV_SIZE / (2 * BEV_RANGE)

    def to_px(x, z):
        # the ego at the centre: rear cameras give negative z
        return int(BEV_SIZE / 2 + x * scale), int(BEV_SIZE / 2 - z * scale)

    def cam_to_front(ci: int):
        if (not infos or ci >= len(infos)
                or "trans_matrix" not in infos[0]
                or "trans_matrix" not in infos[ci]):
            return None
        t0 = np.array(infos[0]["trans_matrix"], np.float64)
        tc = np.array(infos[ci]["trans_matrix"], np.float64)
        return np.linalg.inv(t0) @ tc

    for r in (10, 30, 50):
        cv2.circle(canvas, to_px(0, 0), int(r * scale), (60, 60, 60), 1)
    for ci, pc in enumerate(radar_pcs or []):
        if pc is None:
            continue
        m = cam_to_front(ci)
        xyz = pc[:3].astype(np.float64)
        if m is not None and ci > 0:
            xyz = m[:3, :3] @ xyz + m[:3, 3:4]
        for i in range(xyz.shape[1]):
            x, z = xyz[0, i], xyz[2, i]
            if abs(x) < BEV_RANGE and abs(z) < BEV_RANGE:
                cv2.circle(canvas, to_px(x, z), 2, (255, 180, 60), -1)
    for ci, items in items_by_cam.items():
        m = cam_to_front(int(ci))
        for it in items:
            if it["score"] < conf_thresh:
                continue
            loc = np.asarray(it["location"], np.float64)
            yaw = float(it["yaw"])
            if m is not None and int(ci) > 0:
                loc = m[:3, :3] @ loc + m[:3, 3]
                # the heading (cos yaw, 0, -sin yaw) through the rotation
                v = m[:3, :3] @ np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
                yaw = float(-np.arctan2(v[2], v[0]))
            x, z = float(loc[0]), float(loc[2])
            if abs(x) > BEV_RANGE or abs(z) > BEV_RANGE:
                continue
            h, w, l = it["dimension"]
            box = cv2.boxPoints((to_px(x, z), (l * scale, w * scale),
                                 -np.degrees(yaw)))
            cv2.polylines(canvas, [box.astype(np.int32)], True, (80, 220, 80),
                          1)
    return canvas


def mosaic_frame(frames, results, infos, radars, pc_hm,
                 conf_thresh: float) -> np.ndarray:
    """One sample's output frame: the cameras' renders with the radar
    heatmap blended in (drawPcHeatmap, logger.py:140-310), 400x224 each in
    a 3x2 mosaic, beside the 448x448 bird's-eye view. ``pc_hm`` is the
    model's (B, 1, H, W) radar heatmap on the host, or None."""
    cv2 = image_io.opencv("drawing the demo's mosaic")
    tiles = []
    for ci in range(min(6, len(frames))):
        calib = np.array(infos[ci]["calib"], np.float32)
        vis = render_camera(frames[ci], results.get(ci, []), calib,
                            conf_thresh)
        if pc_hm is not None:
            hm = pc_hm[ci, 0]
            hm = (hm / max(hm.max(), 1e-6) * 255).astype(np.uint8)
            hm = cv2.applyColorMap(
                cv2.resize(hm, (vis.shape[1], vis.shape[0])),
                cv2.COLORMAP_JET)
            vis = cv2.addWeighted(vis, 0.8, hm, 0.2, 0)
        tiles.append(cv2.resize(vis, TILE_WH))
    while len(tiles) < 6:
        tiles.append(np.zeros((TILE_WH[1], TILE_WH[0], 3), np.uint8))
    mosaic = np.vstack([np.hstack(tiles[:3]), np.hstack(tiles[3:6])])
    bev = render_bev(results, radars, conf_thresh, infos)
    return np.hstack([mosaic, cv2.resize(bev, (BEV_PANEL, BEV_PANEL))])


def group_samples(ds) -> Dict[str, List[int]]:
    """The dataset's image ids by ``sample_token``, in dataset order."""
    groups: Dict[str, List[int]] = defaultdict(list)
    for img_id in ds.images:
        groups[ds.coco.load_imgs(img_id)[0]["sample_token"]].append(img_id)
    return groups


def load_demo(args):
    """(config, dataset, detector, samples, cameras a sample) of ``args``."""
    config = update_config(default_config(), args.cfg, args.opts)
    config = finalize_config(config, NuScenesDataset.num_categories,
                             NuScenesDataset.default_resolution)
    config.defrost()
    config.DATASET.VAL_SPLIT = args.split
    config.freeze()
    if args.load and not args.load.endswith(CHECKPOINT_SUFFIXES):
        raise SystemExit(f"demo: --load takes a reference .pt checkpoint, "
                         f"not {args.load}")
    detector = Detector(config, device=args.device)
    ds = NuScenesDataset(config, args.split, device=detector.device)
    if args.load:
        rep = load_weights(detector.model,
                           load_torch_file(args.load)["state_dict"])
        print(f"loaded {args.load}: {len(rep['loaded'])} keys loaded, "
              f"{len(rep['missing'])} missing")
    groups = group_samples(ds)
    return config, ds, detector, groups, max(len(v) for v in groups.values())


def open_video(path: str, frame: np.ndarray):
    """An mp4 writer for frames shaped as ``frame``; raises where opencv
    cannot open one."""
    cv2 = image_io.opencv("writing the demo's video")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 2.0,
                             (frame.shape[1], frame.shape[0]))
    if not writer.isOpened():
        raise OSError(f"demo: cannot open a video writer for {path}")
    return writer


def main(argv=None):
    """Runs the demo; returns ``{sample_token: {camera: [items]}}``."""
    args = parse_args(argv)
    config, ds, detector, groups, n_cams = load_demo(args)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
    writer = None
    out = {}
    try:
        for si, (token, img_ids) in enumerate(groups.items()):
            if args.max_samples and si >= args.max_samples:
                break
            infos = [ds.coco.load_imgs(i)[0] for i in img_ids]
            frames = [ds.load_image(info) for info in infos]
            radars = ([ds.load_radar(info) for info in infos]
                      if config.DATASET.RADAR_PC else None)
            while len(frames) < n_cams:  # one batch shape for every sample
                frames.append(np.zeros_like(frames[0]))
                infos.append(infos[0])
                if radars is not None:
                    radars.append(np.zeros((18, 0), np.float32))
            ret = detector.run(frames, infos, radars)
            out[token] = ret["results"]
            pc_hm = ret["extras"].get("pc_hm")
            if pc_hm is not None:
                pc_hm = pc_hm.float().cpu().numpy()
            frame = mosaic_frame(frames, ret["results"], infos, radars, pc_hm,
                                 args.conf_thresh)
            if args.save_dir:
                image_io.write_image(os.path.join(args.save_dir,
                                                  f"{token}.jpg"), frame)
                if args.show_attention:
                    _save_attention(args, token, ret, frames[0], n_cams, si)
            if args.save_video:
                if writer is None:
                    writer = open_video(args.save_video, frame)
                writer.write(frame)
            stats = detector.stage_stats(reset=True)
            print(f"[{si}] {token}: "
                  + " | ".join(f"{k} {len(v)}"
                               for k, v in ret["results"].items())
                  + " | " + detector.timer.report() + " | "
                  + " ".join(f"{k} {v:.1f}ms" for k, v in sorted(
                      stats.items())))
    finally:
        if writer is not None:
            writer.release()
    return out


def _save_attention(args, token: str, ret, frame, n_cams: int, si: int):
    """``<token>_att_<map>.jpg`` overlays of the depth and radar maps; the
    reference warns and skips for samples of several cameras
    (generic_dataset.py:1222-1226)."""
    if n_cams > 1:
        if si == 0:
            warnings.warn("Visualization of attention map currently not "
                          "supported for multiple camera images.")
        return
    maps = normalize_depthmaps({k: v.float().cpu().numpy()
                                for k, v in ret["extras"].items()})
    for key, m in maps.items():
        image_io.write_image(
            os.path.join(args.save_dir, f"{token}_att_{key}.jpg"),
            image_io.attention_overlay(frame, m[0]))


if __name__ == "__main__":
    main()
