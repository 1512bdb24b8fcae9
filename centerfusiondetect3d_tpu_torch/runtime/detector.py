"""Serving engine: multi-camera frames + radar -> 3D detections.

The port of ``centerfusiondetect3d_tpu/runtime/detector.py:Detector``
(reference ``src/lib/detector.py:21-645``). ``run(images, img_infos,
radar_pcs)`` drives load (image files or arrays) -> pre-process (affine
warp or crop to the input, radar box rows) -> process (normalize, device
radar paint, model forward, decode and post-process on the card) -> merge
(one packed fetch, host result items), with per-stage timers that wait for
the device. ``run_stream`` pipelines the same stages over an iterable of
batches.

Where the frames live follows the device:

- CPU: files decode with cv2 (``data/image_io.py:load_frame``, with the
  JAX package's ``TEST.FAST_DECODE`` half-resolution decode) and warp with
  ``data/transforms.py:warp_image``, bitwise what the JAX package computes;
- CUDA: JPEG files decode with nvJPEG into device tensors and an ndarray
  frame is uploaded once; the frames never come back to the host. An
  integer translation is a slice of the device tensor; any other affine
  goes through ``ops/warp.py:warp_affine`` (``csrc/warp_affine.cu``), one
  launch for the batch. nvJPEG has no reduced decode, so ``FAST_DECODE``
  decodes in full there and warps with the full affine (decode scale 1), a
  documented difference (``ROADMAP.md``, Queue 3).

The model computes in the precision the config asks for: with
``MIXED_PRECISION True`` (the default) in bfloat16 with float32 parameters,
through the bf16 DCN kernel (``ops/dcn.py:dcn_fwd_bf16``); normalization,
the radar paint, the frustum association, decode and post-process stay
float32 either way. ``TEST.FLIP_TEST`` runs the model on the batch and its
mirror (``ops/tta.py:flip_forward``); ``TEST.MULTI_SCALE`` runs each scale
at a 32-aligned input size with the same ``nn.Module`` and merges the
detections (``_cross_scale_nms``, then the top K).
"""

from __future__ import annotations

import os
import queue
import threading
import time as _time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import ConfigNode
from ..data import image_io
from ..data.nuscenes_eval import detections_to_results
from ..data.radar import paint_rows_host, prepare_radar_points
from ..data.transforms import warp_image
from ..geometry.affine import get_affine_transform, stack_inverse_transforms
from ..models.detector import build_model
from ..ops.decode import fusion_decode
from ..ops.postprocess import post_process
from ..ops.rasterize import paint_rects_device_batch
from ..ops.tta import flip_forward
from ..ops.warp import inverse_matrices, warp_affine
from ..utils.device import resolve_device
from ..utils.observability import StageTimer

# nuScenes image normalization (the JAX package's NuScenesDataset.mean/std)
MEAN = (0.40789654, 0.44719302, 0.47026115)
STD = (0.28863828, 0.27408164, 0.27809835)


def _cross_scale_nms(items: List[dict], dist_thresh: float = 0.4
                     ) -> List[dict]:
    """Greedy BEV centre-distance NMS over score-sorted detection items
    (JAX ``_cross_scale_nms``): a detection whose ground-plane (x, z)
    centre lies within ``dist_thresh`` m of a kept one of the same class is
    a multi-scale duplicate and is dropped. 0.4 m stays below nuScenes'
    tightest matching threshold (0.5 m)."""
    kept: List[dict] = []
    for it in items:
        loc = np.asarray(it["location"], np.float32)
        dup = False
        for kt in kept:
            if kt["class"] != it["class"]:
                continue
            kloc = np.asarray(kt["location"], np.float32)
            if ((loc[0] - kloc[0]) ** 2 + (loc[2] - kloc[2]) ** 2
                    < dist_thresh ** 2):
                dup = True
                break
        if not dup:
            kept.append(it)
    return kept


def _integer_translation(trans):
    """(tx, ty) where the 2x3 affine ``trans`` is an integer translation
    (the standard nuScenes serving geometry: a 1600x900 frame decoded at
    800x450 leaves a 1-row vertical crop), else None."""
    a = np.asarray(trans, np.float64)
    tx, ty = a[0, 2], a[1, 2]
    if (abs(a[0, 0] - 1) < 1e-9 and abs(a[1, 1] - 1) < 1e-9
            and abs(a[0, 1]) < 1e-12 and abs(a[1, 0]) < 1e-12
            and abs(tx - round(tx)) < 1e-9 and abs(ty - round(ty)) < 1e-9):
        return int(round(tx)), int(round(ty))
    return None


def _crop_into(out, img, tx: int, ty: int):
    """out[y, x] = img[y - ty, x - tx] where that lies inside img, else 0:
    bilinear at integer offsets is an exact copy. numpy or torch."""
    in_h, in_w = out.shape[:2]
    sh, sw = img.shape[:2]
    y0, y1 = max(0, ty), min(in_h, sh + ty)
    x0, x1 = max(0, tx), min(in_w, sw + tx)
    if (y0, y1, x0, x1) != (0, in_h, 0, in_w):
        out[:] = 0
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = img[y0 - ty:y1 - ty, x0 - tx:x1 - tx]
    return out


def _warp_or_crop(img: np.ndarray, trans: np.ndarray, in_h: int, in_w: int):
    """Apply a 2x3 affine to an HWC host image: an integer translation as a
    slice, any other affine through ``data/transforms.py:warp_image``
    (``cv2.warpAffine``'s bilinear warp with a zero border, in numpy)."""
    shift = _integer_translation(trans)
    if shift is None:
        return warp_image(img, np.asarray(trans, np.float64), (in_w, in_h))
    return _crop_into(np.empty((in_h, in_w, 3), img.dtype), img, *shift)


def _pack_detections(processed: Dict[str, torch.Tensor]):
    """The (B, K, ...) detection tensors as ONE (B, K, D) float32 tensor, so
    that the fetch is one copy (JAX ``_pack_detections``). Returns
    ``((flat, packable, widths, shapes), rest)``, or ``(None, processed)``
    when fewer than two entries pack. The pack keys off ``scores``, never
    off the key that sorts first."""
    keys = sorted(processed)
    shapes = {k: tuple(processed[k].shape) for k in keys}
    anchor = "scores" if "scores" in shapes else keys[0]
    if len(shapes[anchor]) < 2:
        return None, processed
    b, kk = shapes[anchor][:2]
    packable = [k for k in keys if len(shapes[k]) >= 2
                and shapes[k][:2] == (b, kk)]
    rest = {k: processed[k] for k in keys if k not in packable}
    if len(packable) < 2:
        return None, processed
    widths = [int(np.prod(shapes[k][2:], dtype=np.int64)) or 1
              for k in packable]
    flat = torch.cat([processed[k].to(torch.float32).reshape(b, kk, -1)
                      for k in packable], dim=-1)
    return (flat, packable, widths, shapes), rest


def _unpack_detections(flat: np.ndarray, packed, rest_host
                       ) -> Dict[str, np.ndarray]:
    """The host copy ``flat`` of a pack split back into its entries, with
    the unpacked ``rest_host`` beside them."""
    _, packable, widths, shapes = packed
    out: Dict[str, np.ndarray] = {}
    off = 0
    for k, w in zip(packable, widths):
        out[k] = flat[..., off:off + w].reshape(shapes[k])
        off += w
    out.update(rest_host)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fetch_packed(processed: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A dict of (B, K, ...) device tensors on the host in one copy."""
    packed, rest = _pack_detections(processed)
    rest_host = {k: _host(v) for k, v in rest.items()}
    if packed is None:
        return rest_host
    return _unpack_detections(_host(packed[0]), packed, rest_host)


def derive_stream_defaults(cpu_count: Optional[int] = None) -> Dict[str, int]:
    """``run_stream``'s ``workers``, ``fetch_workers`` and ``prefetch`` from
    the host's core count, as the JAX package derives them: decode workers
    up to 6 with one core left for the consumer, 2-3 fetch threads, one
    prepared batch per worker plus one."""
    n = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    workers = max(1, min(n - 1, 6))
    return {"workers": workers, "fetch_workers": 2 if n <= 2 else 3,
            "prefetch": max(2, workers + 1)}


class Detector:
    def __init__(self, config: ConfigNode,
                 state_dict: Optional[Mapping[str, object]] = None,
                 device=None, model: Optional[torch.nn.Module] = None):
        """config: a finalized config; state_dict: reference-named weights
        (tensors or numpy arrays), loaded strictly, or None for the model's
        own initialization; device: the CUDA card unless given; model: an
        already built module on ``device`` to serve as it is (multi-scale
        shares one module across its input sizes)."""
        self.config = config
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        if model is None:
            model = build_model(config)
            if state_dict is not None:
                model.load_state_dict(
                    {k: torch.as_tensor(np.asarray(v)) if not isinstance(
                        v, torch.Tensor) else v
                     for k, v in state_dict.items()}, strict=True)
            model.to(self.device)
        self.model = model.eval()
        self.timer = StageTimer(self.device)
        self.mean = torch.tensor(MEAN, device=self.device).view(1, 3, 1, 1)
        self.std = torch.tensor(STD, device=self.device).view(1, 3, 1, 1)
        self._scaled: Dict[float, Detector] = {}
        self._stage_sec: Dict[str, float] = defaultdict(float)
        self._stage_n: Dict[str, int] = defaultdict(int)
        self._stage_lock = threading.Lock()  # the stream's threads add too

    def _acc_stage(self, name: str, dt: float, n: int = 1):
        with self._stage_lock:
            self._stage_sec[name] += dt
            self._stage_n[name] += n

    def stage_stats(self, reset: bool = False) -> Dict[str, float]:
        """Accumulated host stage cost, ms per call (decode, warp and
        rasterize per image, the others per batch); summed over the
        stream's threads, so totals can exceed wall time. On the card,
        warp and dispatch are the host's enqueue; decode waits for nvJPEG."""
        with self._stage_lock:
            out = {k: 1e3 * self._stage_sec[k] / max(1, self._stage_n[k])
                   for k in self._stage_sec}
            if reset:
                self._stage_sec.clear()
                self._stage_n.clear()
        return out

    # ---------------------------------------------------------------- stages
    def load_data(self, images, return_scales: bool = False):
        """A path, an ndarray, a tensor, or a list of them -> the list of
        HWC BGR frames: host arrays on the CPU, tensors on the card. Files
        decode through ``data/image_io.py:load_frame`` (``TEST.FAST_DECODE``
        on the CPU); an ndarray is uploaded to the card once.
        ``return_scales`` also returns each frame's decode scale."""
        t0 = _time.perf_counter()
        if isinstance(images, (str, np.ndarray, torch.Tensor)):
            images = [images]
        in_hw = tuple(self.config.MODEL.INPUT_SIZE)
        fast = bool(self.config.TEST.get("FAST_DECODE", True))
        out, scales = [], []
        for im in images:
            s = 1.0
            if isinstance(im, str):
                im, s = image_io.load_frame(im, self.device, in_hw, fast)
            out.append(self._frame(im))
            scales.append(s)
        self._acc_stage("decode", _time.perf_counter() - t0, len(out))
        return (out, scales) if return_scales else out

    def _frame(self, im):
        """A decoded frame where this Detector keeps frames: a tensor on
        the card (an array is uploaded once), an array on the CPU."""
        if self.on_card:
            if not isinstance(im, torch.Tensor):
                im = torch.from_numpy(np.ascontiguousarray(im))
            return im.to(self.device)
        return im.numpy() if isinstance(im, torch.Tensor) else np.asarray(im)

    def pre_process(self, images: List, img_infos=None, radar_pcs=None,
                    decode_scales=None):
        """Warp or crop each frame to the input size (uint8: normalization
        runs on the card; on the card into one device batch, one
        ``warp_affine`` launch for the frames that need a warp) and turn
        its radar points into paint rows (or a host raster). Frames come
        as ``load_data`` gives them (host arrays are uploaded on the
        card). Geometry (centre, scale, calib, metas) refers to the
        original image: ``decode_scales`` compose into the warp. Returns
        (batch, metas)."""
        cfg = self.config
        in_h, in_w = cfg.MODEL.INPUT_SIZE
        out_h, out_w = cfg.MODEL.OUTPUT_SIZE
        images = [self._frame(im) for im in images]
        n = len(images)
        batch_pc, calibs, metas, warps = [], [], [], []
        batch_img = (torch.empty((n, in_h, in_w, 3), dtype=images[0].dtype,
                                 device=self.device) if self.on_card
                     else [None] * n)
        tw = 0.0
        for i, img in enumerate(images):
            ds = float(decode_scales[i]) if decode_scales is not None else 1.0
            info = (img_infos[i] if img_infos else {}) or {}
            # exact source dims from img_info when given; from the decoded
            # shape they are off by up to ds - 1 px for odd source sizes
            h = float(info.get("height", img.shape[0] * ds))
            w = float(info.get("width", img.shape[1] * ds))
            center = np.array([w / 2.0, h / 2.0], np.float32)
            scale = max(h, w) * 1.0
            trans_in = get_affine_transform(center, scale, 0, (in_w, in_h))
            trans_out = get_affine_transform(center, scale, 0, (out_w, out_h))
            # points of the reduced frame map through p_orig = ds * p
            trans_warp = trans_in.copy()
            trans_warp[:, :2] *= ds
            t0 = _time.perf_counter()
            if not self.on_card:
                batch_img[i] = _warp_or_crop(img, trans_warp, in_h, in_w)
            elif _integer_translation(trans_warp) is not None:
                _crop_into(batch_img[i], img, *_integer_translation(
                    trans_warp))
            else:
                warps.append((i, trans_warp))
            tw += _time.perf_counter() - t0
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
        if warps:
            t0 = _time.perf_counter()
            idx = [i for i, _ in warps]
            warp_affine([images[i] for i in idx],
                        inverse_matrices([t for _, t in warps]),
                        [batch_img[i] for i in idx])
            tw += _time.perf_counter() - t0
        self._acc_stage("warp", tw, n)

        batch = {"image": batch_img if self.on_card else np.stack(batch_img),
                 "calib": np.stack(calibs)}
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
        """Normalize, paint the radar map, run the model (on the batch and
        its mirror under ``TEST.FLIP_TEST``), decode and post-process;
        every input is a tensor on the device."""
        cfg = self.config
        if isinstance(pc_dep, tuple):
            pc_dep = paint_rects_device_batch(pc_dep[0], pc_dep[1],
                                              cfg.MODEL.OUTPUT_SIZE)
        x = (image.permute(0, 3, 1, 2).float() / 255.0 - self.mean) / self.std
        if cfg.TEST.FLIP_TEST:
            y = flip_forward(self.model, x, pc_dep, calib)
        else:
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
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
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
        npx = _fetch_packed(processed)  # waits for the device
        return self._merge_fetched(npx, _time.perf_counter() - t0)

    def _merge_fetched(self, npx, fetch_s: float) -> Dict[int, List[dict]]:
        """``run``'s and ``run_stream``'s tail: host detections -> result
        items, with the fetch and merge stages."""
        t1 = _time.perf_counter()
        out = detections_to_results(npx, list(range(len(npx["scores"]))),
                                    conf_thresh=-1.0)
        self._acc_stage("fetch", fetch_s)
        self._acc_stage("merge", _time.perf_counter() - t1)
        return out

    # ------------------------------------------------------- multi-scale TTA
    def _scaled_detector(self, scale: float) -> "Detector":
        """A Detector at ``scale`` times the input size, rounded to a
        multiple of 32, with matching output and pyramid sizes, serving
        this one's module (cached)."""
        if scale not in self._scaled:
            h, w = self.config.MODEL.INPUT_SIZE
            cfg = self.config.clone()
            cfg.defrost()
            cfg.MODEL.INPUT_SIZE = (max(32, int(round(h * scale / 32)) * 32),
                                    max(32, int(round(w * scale / 32)) * 32))
            cfg.MODEL.OUTPUT_SIZE = (cfg.MODEL.INPUT_SIZE[0] // 4,
                                     cfg.MODEL.INPUT_SIZE[1] // 4)
            cfg.MODEL.PYRAMID_OUT_SIZE = (tuple(cfg.MODEL.OUTPUT_SIZE),)
            cfg.TEST.MULTI_SCALE = ()
            cfg.freeze()
            self._scaled[scale] = Detector(cfg, device=self.device,
                                           model=self.model)
        return self._scaled[scale]

    def _merge_scales(self, per_scale_results) -> Dict[int, List[dict]]:
        """Per-scale detections (in original-image and camera coordinates)
        concatenated per image, sorted by score, cross-scale duplicates
        dropped (``_cross_scale_nms``), the top K kept."""
        k = int(self.config.MODEL.K)
        merged: Dict[int, List[dict]] = {}
        for results in per_scale_results:
            for img_id, items in results.items():
                merged.setdefault(img_id, []).extend(items)
        for img_id in merged:
            merged[img_id].sort(key=lambda it: -it["score"])
            merged[img_id] = _cross_scale_nms(merged[img_id])[:k]
        return merged

    # ------------------------------------------------------------- streaming
    def run_stream(self, frames, prefetch: Optional[int] = None,
                   depth: int = 8, workers: Optional[int] = None,
                   fetch_workers: Optional[int] = None):
        """Pipelined ``run`` over an iterable ``frames`` of (images,
        img_infos, radar_pcs) tuples; yields ``run``'s result dict (results,
        metas, extras) per batch, in input order. Serves the input size
        alone (``TEST.MULTI_SCALE`` is ``run``'s, as in the JAX package).

        ``workers`` threads run ``load_data`` and ``pre_process`` up to
        ``prefetch`` batches ahead through a bounded queue; at most ``depth``
        batches are in flight; ``fetch_workers`` threads wait for the
        results (defaults: ``derive_stream_defaults``). On the card each
        worker decodes and warps on its own CUDA stream and records an
        event that the consumer's stream waits on before it reads the
        batch (``record_stream`` tells the caching allocator), and the
        packed detections are copied without blocking into pinned host
        memory, whose event the fetch thread waits on. A producer's error
        is raised here; ``close()`` or ``break`` stops and reaps the
        producer."""
        d = derive_stream_defaults()
        workers = d["workers"] if workers is None else workers
        fetch_workers = (d["fetch_workers"] if fetch_workers is None
                         else fetch_workers)
        prefetch = d["prefetch"] if prefetch is None else prefetch
        pre_q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        end = object()
        err: List[BaseException] = []
        stop = threading.Event()
        local = threading.local()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer is gone."""
            t0 = _time.perf_counter()
            while not stop.is_set():
                try:
                    pre_q.put(item, timeout=0.1)
                    self._acc_stage("put_wait", _time.perf_counter() - t0)
                    return True
                except queue.Full:
                    continue
            return False

        def prep(item):
            images, img_infos, radar_pcs = item
            if not self.on_card:
                imgs, dscales = self.load_data(images, return_scales=True)
                return self.pre_process(imgs, img_infos, radar_pcs,
                                        dscales) + (None,)
            stream = getattr(local, "stream", None)
            if stream is None:
                stream = local.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                imgs, dscales = self.load_data(images, return_scales=True)
                batch, metas = self.pre_process(imgs, img_infos, radar_pcs,
                                                dscales)
                ready = torch.cuda.Event()
                ready.record(stream)
            return batch, metas, ready

        def producer():
            try:
                if workers <= 1:
                    for item in frames:
                        if not put(prep(item)):
                            return
                else:
                    with ThreadPoolExecutor(max_workers=workers) as pool:
                        pending = []
                        for item in frames:
                            if stop.is_set():
                                return
                            pending.append(pool.submit(prep, item))
                            while len(pending) > workers:
                                if not put(pending.pop(0).result()):
                                    return
                        for fut in pending:
                            if not put(fut.result()):
                                return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(end)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="cfd3d-stream-producer")
        thread.start()
        inflight: List = []
        fetchers = ThreadPoolExecutor(max_workers=max(1, fetch_workers),
                                      thread_name_prefix="cfd3d-fetch")
        try:
            while True:
                tg = _time.perf_counter()
                item = pre_q.get()
                self._acc_stage("get_wait", _time.perf_counter() - tg)
                if item is end:
                    break
                batch, metas, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(current)
                processed, extras = self.process(batch, metas)
                tp = _time.perf_counter()
                packed, rest = _pack_detections(processed)
                copy = None if packed is None else self._start_host_copy(
                    packed[0])
                inflight.append(fetchers.submit(
                    self._finalize_stream, packed, copy, rest, extras, metas))
                self._acc_stage("pack", _time.perf_counter() - tp)
                if len(inflight) >= depth:
                    tr = _time.perf_counter()
                    res = inflight.pop(0).result()
                    self._acc_stage("result_wait", _time.perf_counter() - tr)
                    yield res
            for fut in inflight:
                tr = _time.perf_counter()
                res = fut.result()
                self._acc_stage("result_wait", _time.perf_counter() - tr)
                yield res
            if err:
                raise err[0]
        finally:
            # consumer done or gone: release the producer
            stop.set()
            while True:  # drain so that a blocked put() returns at once
                try:
                    pre_q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
            fetchers.shutdown(wait=False, cancel_futures=True)

    def _start_host_copy(self, flat: torch.Tensor):
        """(host tensor, event): on the card a non-blocking copy into pinned
        memory and the event after it (JAX ``_start_host_copy``); on the
        CPU the tensor itself and None."""
        if flat.device.type != "cuda":
            return flat, None
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _finalize_stream(self, packed, copy, rest, extras, metas) -> Dict:
        t0 = _time.perf_counter()
        rest_host = {k: _host(v) for k, v in rest.items()}
        if packed is None:
            npx = rest_host
        else:
            host, done = copy
            if done is not None:
                done.synchronize()
            npx = _unpack_detections(host.numpy(), packed, rest_host)
        results = self._merge_fetched(npx, _time.perf_counter() - t0)
        return {"results": results, "metas": metas, "extras": extras}

    # ------------------------------------------------------------------ run
    def run(self, images, img_infos=None, radar_pcs=None) -> Dict:
        """Frames (one per camera: paths, arrays or tensors), optional
        per-frame info dicts (calib, camera_intrinsic, width, height) and
        radar clouds (18, N) -> a dict with per-image ``results``,
        ``metas``, device ``extras``, stage ``times`` (seconds, averaged
        over calls), the decoded ``images`` and their ``decode_scales``.
        Under ``TEST.MULTI_SCALE`` each scale runs on the same decoded
        frames and the results are merged (``_merge_scales``)."""
        scales = tuple(self.config.TEST.MULTI_SCALE or ())
        self.timer.start("load")
        imgs, dscales = self.load_data(images, return_scales=True)
        self.timer.stop("load")
        if scales:
            per_scale, ret = [], None
            for s in scales:
                det = self if abs(s - 1.0) < 1e-6 else self._scaled_detector(s)
                r = det._run_single(imgs, img_infos, radar_pcs, dscales)
                per_scale.append(r["results"])
                if abs(s - 1.0) < 1e-6 or ret is None:
                    ret = r
            ret["results"] = self._merge_scales(per_scale)
        else:
            ret = self._run_single(imgs, img_infos, radar_pcs, dscales)
        ret["images"] = imgs
        ret["decode_scales"] = dscales
        return ret

    def _run_single(self, imgs: List, img_infos=None, radar_pcs=None,
                    decode_scales=None) -> Dict:
        t = self.timer
        t.start("total")
        t.start("preprocess")
        batch, metas = self.pre_process(imgs, img_infos, radar_pcs,
                                        decode_scales)
        t.stop("preprocess")
        t.start("net")
        processed, extras = self.process(batch, metas)
        t.stop("net")
        t.start("merge")
        results = self.merge_outputs(processed)
        t.stop("merge")
        t.stop("total")
        return {"results": results, "metas": metas, "extras": extras,
                "times": t.summary()}
