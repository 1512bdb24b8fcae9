"""Serving engine: multi-camera frames + radar -> 3D detections.

The port of ``centerfusiondetect3d_tpu/runtime/detector.py:Detector``
(reference ``src/lib/detector.py:21-645``). ``run(images, img_infos,
radar_pcs)`` drives load -> pre-process (host affine warp or crop, radar box
rows) -> process (normalize, device radar paint, model forward, decode and
post-process on the card) -> merge (host result items), with per-stage
timers that wait for the device.

The model computes in the precision the config asks for: with
``MIXED_PRECISION True`` (the default) in bfloat16 with float32 parameters,
through the bf16 DCN kernel (``ops/dcn.py:dcn_fwd_bf16``); normalization,
the radar paint, the frustum association, decode and post-process stay
float32 either way.

Not ported yet: image-file decoding, ``run_stream``, flip and multi-scale
test-time augmentation. Frames are passed as decoded BGR uint8 arrays.
"""

from __future__ import annotations

import time as _time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import ConfigNode
from ..data.nuscenes_eval import detections_to_results
from ..data.radar import paint_rows_host, prepare_radar_points
from ..data.transforms import warp_image
from ..geometry.affine import get_affine_transform, stack_inverse_transforms
from ..models.detector import build_model
from ..ops.decode import fusion_decode
from ..ops.postprocess import post_process
from ..ops.rasterize import paint_rects_device_batch
from ..utils.device import resolve_device
from ..utils.observability import StageTimer

# nuScenes image normalization (the JAX package's NuScenesDataset.mean/std)
MEAN = (0.40789654, 0.44719302, 0.47026115)
STD = (0.28863828, 0.27408164, 0.27809835)


def _warp_or_crop(img: np.ndarray, trans: np.ndarray, in_h: int, in_w: int):
    """Apply a 2x3 affine to an HWC image.

    An integer translation (the standard nuScenes serving geometry: a
    1600x900 frame decoded at 800x450 leaves a 1-row vertical crop) is an
    exact copy of a window, done here with a slice. Any other affine goes to
    ``data/transforms.py:warp_image`` (``cv2.warpAffine``'s bilinear warp
    with a zero border, in numpy).
    """
    a = np.asarray(trans, np.float64)
    tx, ty = a[0, 2], a[1, 2]
    if (abs(a[0, 0] - 1) < 1e-9 and abs(a[1, 1] - 1) < 1e-9
            and abs(a[0, 1]) < 1e-12 and abs(a[1, 0]) < 1e-12
            and abs(tx - round(tx)) < 1e-9 and abs(ty - round(ty)) < 1e-9):
        txi, tyi = int(round(tx)), int(round(ty))
        sh, sw = img.shape[:2]
        # dst[y, x] = src[y - ty, x - tx]; valid dst rows: ty <= y < sh + ty
        y0, y1 = max(0, tyi), min(in_h, sh + tyi)
        x0, x1 = max(0, txi), min(in_w, sw + txi)
        if y1 <= y0 or x1 <= x0:
            return np.zeros((in_h, in_w, 3), img.dtype)
        if (y0, y1, x0, x1) == (0, in_h, 0, in_w):
            return np.ascontiguousarray(img[-tyi:in_h - tyi, -txi:in_w - txi])
        out = np.zeros((in_h, in_w, 3), img.dtype)
        out[y0:y1, x0:x1] = img[y0 - tyi:y1 - tyi, x0 - txi:x1 - txi]
        return out
    return warp_image(img, a, (in_w, in_h))


class Detector:
    def __init__(self, config: ConfigNode,
                 state_dict: Optional[Mapping[str, object]] = None,
                 device=None):
        """config: a finalized config; state_dict: reference-named weights
        (tensors or numpy arrays), loaded strictly, or None for the model's
        own initialization; device: the CUDA card unless given."""
        if config.TEST.FLIP_TEST or tuple(config.TEST.MULTI_SCALE or ()):
            raise NotImplementedError(
                "flip and multi-scale test-time augmentation are not ported")
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config)
        if state_dict is not None:
            self.model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) if not isinstance(
                    v, torch.Tensor) else v for k, v in state_dict.items()},
                strict=True)
        self.model.to(self.device).eval()
        self.timer = StageTimer(self.device)
        self.mean = torch.tensor(MEAN, device=self.device).view(1, 3, 1, 1)
        self.std = torch.tensor(STD, device=self.device).view(1, 3, 1, 1)
        self._stage_sec: Dict[str, float] = defaultdict(float)
        self._stage_n: Dict[str, int] = defaultdict(int)

    def _acc_stage(self, name: str, dt: float, n: int = 1):
        self._stage_sec[name] += dt
        self._stage_n[name] += n

    def stage_stats(self, reset: bool = False) -> Dict[str, float]:
        """Accumulated host stage cost, ms per call (warp and rasterize per
        image, the others per batch)."""
        out = {k: 1e3 * self._stage_sec[k] / max(1, self._stage_n[k])
               for k in self._stage_sec}
        if reset:
            self._stage_sec.clear()
            self._stage_n.clear()
        return out

    # ---------------------------------------------------------------- stages
    def load_data(self, images) -> List[np.ndarray]:
        """ndarray or list of ndarrays -> list of HWC uint8 (BGR) frames."""
        if isinstance(images, np.ndarray):
            images = [images]
        out = []
        for im in images:
            if isinstance(im, str):
                raise NotImplementedError(
                    "decoding image files is not ported yet; pass decoded "
                    "BGR uint8 arrays")
            out.append(np.asarray(im))
        return out

    def pre_process(self, images: List[np.ndarray], img_infos=None,
                    radar_pcs=None):
        """Warp each frame to the input size on the host (frames stay uint8:
        normalization runs on the card) and turn its radar points into paint
        rows (or a host raster). Returns (batch of numpy arrays, metas)."""
        cfg = self.config
        in_h, in_w = cfg.MODEL.INPUT_SIZE
        out_h, out_w = cfg.MODEL.OUTPUT_SIZE
        batch_imgs, batch_pc, calibs, metas = [], [], [], []
        for i, img in enumerate(images):
            info = (img_infos[i] if img_infos else {}) or {}
            h = float(info.get("height", img.shape[0]))
            w = float(info.get("width", img.shape[1]))
            center = np.array([w / 2.0, h / 2.0], np.float32)
            scale = max(h, w) * 1.0
            trans_in = get_affine_transform(center, scale, 0, (in_w, in_h))
            trans_out = get_affine_transform(center, scale, 0, (out_w, out_h))
            tw = _time.perf_counter()
            batch_imgs.append(_warp_or_crop(img, trans_in, in_h, in_w))
            self._acc_stage("warp", _time.perf_counter() - tw)
            calib = np.array(
                info.get("calib", [[1200.0, 0, w / 2, 0], [0, 1200.0, h / 2, 0],
                                   [0, 0, 1, 0]]), np.float32)
            calibs.append(calib)
            metas.append({"center": center, "scale": scale,
                          "width": int(round(w)), "height": int(round(h))})

            if cfg.DATASET.RADAR_PC:
                radar = None if radar_pcs is None else radar_pcs[i]
                if radar is None:
                    radar = np.zeros((18, 0), np.float32)
                info_full = dict(info)
                info_full.setdefault("width", int(round(w)))
                info_full.setdefault("height", int(round(h)))
                info_full.setdefault("calib", calib.tolist())
                info_full.setdefault("camera_intrinsic",
                                     calib[:3, :3].tolist())
                # device paint from compact rows, except for one-hot layouts
                # and when the camera has more points than MAX_PC rows
                use_rows = (bool(cfg.TEST.get("DEVICE_RASTERIZE", True))
                            and not cfg.DATASET.ONE_HOT_PC)
                tr = _time.perf_counter()
                _, pc_n, payload, _ = prepare_radar_points(
                    radar, info_full, cfg, trans_out, False, w, h,
                    return_paint=use_rows)
                if use_rows and int(pc_n) > int(cfg.DATASET.MAX_PC):
                    _, _, payload, _ = prepare_radar_points(
                        radar, info_full, cfg, trans_out, False, w, h)
                self._acc_stage("rasterize", _time.perf_counter() - tr)
                batch_pc.append(payload)

        batch = {"image": np.stack(batch_imgs), "calib": np.stack(calibs)}
        if batch_pc:
            if all(isinstance(p, tuple) for p in batch_pc):
                batch["pc_boxes"] = np.stack([p[0] for p in batch_pc])
                batch["pc_values"] = np.stack([p[1] for p in batch_pc])
            else:  # some camera overflowed MAX_PC: host rasters for all
                batch["pc_dep"] = np.stack([
                    paint_rows_host(p[0], p[1], cfg.MODEL.OUTPUT_SIZE)
                    if isinstance(p, tuple) else p for p in batch_pc])
        return batch, metas

    def _forward(self, image, pc_dep, calib, trans_inv):
        """Normalize, paint the radar map, run the model, decode and
        post-process; every input is a tensor on the device."""
        cfg = self.config
        if isinstance(pc_dep, tuple):
            pc_dep = paint_rects_device_batch(pc_dep[0], pc_dep[1],
                                              cfg.MODEL.OUTPUT_SIZE)
        x = (image.permute(0, 3, 1, 2).float() / 255.0 - self.mean) / self.std
        y = self.model(x, pc_dep, calib)
        dets = fusion_decode([y], cfg.MODEL.OUTPUT_SIZE, k=cfg.MODEL.K,
                             norm2d=cfg.MODEL.NORM_2D)
        processed = post_process(dets, trans_inv, cfg.MODEL.OUTPUT_SIZE,
                                 calib)
        extras = {k: y[k] for k in ("depthMap", "pc_hm") if k in y}
        return processed, extras

    def process(self, batch, metas):
        """Ship the batch to the card and enqueue the forward. Returns device
        tensors; the work may still be running when this returns."""
        t0 = _time.perf_counter()
        oh, ow = self.config.MODEL.OUTPUT_SIZE
        trans_inv = stack_inverse_transforms(
            [m["center"] for m in metas], [m["scale"] for m in metas], (ow, oh))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if "pc_boxes" in batch:
            pc_dep = (dev(batch["pc_boxes"]), dev(batch["pc_values"]))
        elif "pc_dep" in batch:
            pc_dep = dev(batch["pc_dep"]).permute(0, 3, 1, 2).contiguous()
        else:
            pc_dep = None
        with torch.inference_mode():
            out = self._forward(dev(batch["image"]), pc_dep,
                                dev(batch["calib"]), dev(trans_inv))
        self._acc_stage("dispatch", _time.perf_counter() - t0)
        return out

    def merge_outputs(self, processed) -> Dict[int, List[dict]]:
        t0 = _time.perf_counter()
        npx = {k: v.cpu().numpy() for k, v in processed.items()}
        t1 = _time.perf_counter()
        out = detections_to_results(npx, list(range(len(npx["scores"]))),
                                    conf_thresh=-1.0)
        self._acc_stage("fetch", t1 - t0)
        self._acc_stage("merge", _time.perf_counter() - t1)
        return out

    # ------------------------------------------------------------------ run
    def run(self, images, img_infos=None, radar_pcs=None) -> Dict:
        """Frames (one per camera), optional per-frame info dicts (calib,
        camera_intrinsic, width, height) and radar clouds (18, N) -> a dict
        with per-image ``results``, ``metas``, device ``extras``, stage
        ``times`` (seconds, averaged over calls) and the ``images``."""
        t = self.timer
        t.start("load")
        imgs = self.load_data(images)
        t.stop("load")
        t.start("total")
        t.start("preprocess")
        batch, metas = self.pre_process(imgs, img_infos, radar_pcs)
        t.stop("preprocess")
        t.start("net")
        processed, extras = self.process(batch, metas)
        t.stop("net")
        t.start("merge")
        results = self.merge_outputs(processed)
        t.stop("merge")
        t.stop("total")
        return {"results": results, "metas": metas, "extras": extras,
                "times": t.summary(), "images": imgs}
