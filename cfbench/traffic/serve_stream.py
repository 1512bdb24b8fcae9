"""Closed-loop batched serving through ``Detector.run_stream``.

Traffic: a pool of ``pool_samples`` seeded nuScenes-like samples, each
``cameras`` decoded ``frame_hw`` uint8 frames on the card with their
calibration and, where the configuration fuses radar, a radar cloud of
18-row camera-frame returns (sizes spread over ``radar_points``, the same
set for every seed, in a seeded order). Batch ``i`` is samples ``i *
samples_per_batch ...`` of the pool, cycled; the stream pulls the next
batch as soon as it can (a closed loop), with its own defaults for workers,
prefetch and depth. The stream starts in set-up and serves
``warmup_batches`` before the window opens, so the window sees a full
pipeline.

End-to-end: frames whose detections came back inside the window over its
seconds (``serve_frames_per_s``), and the 95th percentile over those
batches of the time from the stream's pull of a batch from the generator
to its result (``serve_batch_p95_ms``).

Check: for ``check_batches`` batches that came back in the window, drawn
from the seed, what the window's forward produced, kept by forward hooks on
the program's model (its inputs, the output of each stage and the head
maps), against the float32 reference on the same raw frames, radar and
weights. A random network amplifies rounding from layer to layer (bf16
against float32 differs by O(1) at the heads of a seeded DLA-34), so the
reference follows the program stage by stage: each stage (the stem, each
DLA level, each IDA step of the neck, each head tower with its activation)
runs in the reference on the program's own input to it, and its output is
compared with the program's (``backbone_rms``, ``neck_rms``,
``head_rms``: the largest relative RMS gap of one image). What follows the
towers, and the start, the reference works out from the same inputs with
the same float32 arithmetic, so they agree exactly, and one number holds
them (``exact_err``, the largest of): each head's activation against the
reference's of the program's tower output; the normalized image against
the reference's warp of the raw frame; the share of radar-map pixels that
differ from the reference's pillars, and of frustum-heatmap pixels that
differ from the reference's association of the program's first-stage
boxes; the detections that ``run_stream`` returned against the
reference's decode and post-process of the program's head maps.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from cfbench import counting, weights
from cfbench.follow import Capture, rel_rms, stages, tf32_off
from cfbench.harness import Check
from cfbench.reference import inputs as rin
from cfbench.reference import postprocess as rpp
from cfbench.reference.model import (build_reference, round_fp8,
                                     sigmoid_depth)

TRACE_SECONDS = 3.0  # the traced part of a --trace 1 window
DET_FIELDS = (("score", "scores"), ("class", "classIds"),
              ("dimension", "dimension"), ("location", "locations"),
              ("yaw", "yaws"), ("bbox", "bboxes"),
              ("nuscenes_att", "nuscenes_att"), ("velocity", "velocity"))


# ------------------------------------------------------------------ inputs
class Pool:
    """The seeded samples: frames on the device, calibrations, radar."""

    def __init__(self, run, device):
        p = run.params
        self.cams = int(p["cameras"])
        self.spb = int(p["samples_per_batch"])
        self.n = int(p["pool_samples"])
        self.h, self.w = (int(v) for v in p["frame_hw"])
        self.radar = bool(run.config["model"]["middle_fusion"])
        n_frames = self.n * self.cams
        gen = torch.Generator(device=device).manual_seed(run.seed)
        yy = torch.arange(self.h, device=device, dtype=torch.float32)[:, None]
        xx = torch.arange(self.w, device=device, dtype=torch.float32)[None, :]
        self.frames = []
        for i in range(n_frames):
            base = 127 + 60 * torch.sin(xx / (7.0 + i % 13)) * torch.cos(
                yy / (11.0 + i % 7))
            noise = torch.randint(-40, 41, (self.h, self.w, 3), generator=gen,
                                  device=device, dtype=torch.int16)
            self.frames.append((base[..., None] + noise).clamp(0, 255).to(
                torch.uint8))
        fx, fy, cx, cy = (float(v) for v in p["intrinsics"])
        calib = [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]]
        self.info = {"calib": calib,
                     "camera_intrinsic": [r[:3] for r in calib],
                     "width": self.w, "height": self.h}
        rng = np.random.default_rng(run.seed)
        self.clouds = []
        if not self.radar:
            return
        lo, hi = (int(v) for v in p["radar_points"])
        sizes = rng.permutation(np.linspace(lo, hi, n_frames).round()
                                .astype(int))
        for m in sizes:
            pts = np.zeros((18, m), np.float32)
            pts[2] = rng.uniform(2.0, 70.0, m)
            pts[0] = rng.uniform(-0.7, 0.7, m) * pts[2]
            pts[1] = rng.uniform(-0.05, 0.1, m) * pts[2]
            pts[8:10] = rng.standard_normal((2, m))
            self.clouds.append(pts)

    def batch(self, i: int):
        """Batch ``i``: (frames, infos, radar clouds or None), cameras
        sample after sample."""
        idx = [((i * self.spb + s) % self.n) * self.cams + c
               for s in range(self.spb) for c in range(self.cams)]
        return ([self.frames[j] for j in idx], [self.info] * len(idx),
                [self.clouds[j] for j in idx] if self.radar else None)


class Reference:
    """The float32 reference on the card, TF32 off, fed the raw inputs."""

    def __init__(self, run, device, model=None):
        m = run.config["model"]
        self.in_hw = tuple(m["input_size"])
        self.out_hw = (self.in_hw[0] // 4, self.in_hw[1] // 4)
        self.k = int(m["K"])
        self.max_dist = float(m["max_pc_dist"])
        self.middle = bool(m["middle_fusion"])
        self.block = int(run.params.get("reference_block", 6))
        self.model = (build_reference(run.config) if model is None
                      else model).to(device).eval()
        self.device = device

    def inputs(self, frames, infos, clouds):
        """The network's inputs worked out again from the raw batch:
        (normalized images, radar map or None, calib, inverse affines)."""
        warped, radar, calibs, invs = [], [], [], []
        for i, (frame, info) in enumerate(zip(frames, infos)):
            t_in, t_out, t_inv = rin.frame_geometry(
                info["width"], info["height"], self.in_hw, self.out_hw)
            warped.append(rin.warp(frame, t_in, self.in_hw))
            calib = np.asarray(info["calib"], np.float32)
            calibs.append(calib)
            invs.append(t_inv)
            if self.middle:
                radar.append(rin.radar_map(
                    clouds[i], calib, info["width"], info["height"], t_out,
                    self.out_hw, self.max_dist))
        dev = self.device
        pc = (torch.from_numpy(np.stack(radar)).permute(0, 3, 1, 2)
              .contiguous().to(dev) if radar else None)
        return (rin.normalize(torch.stack(warped)), pc,
                torch.from_numpy(np.stack(calibs)).to(dev),
                torch.from_numpy(np.stack(invs)).to(dev))

    @torch.no_grad()
    def forward(self, x, pc, calib, follow=None):
        """Head maps in blocks of ``block`` images; ``follow``: another
        model's first-stage heads whose top-K boxes the association
        takes."""
        out: Dict[str, List[torch.Tensor]] = {}
        for s in range(0, x.shape[0], self.block):
            e = s + self.block
            sub = None if follow is None else {k: v[s:e]
                                               for k, v in follow.items()}
            y = self.model(x[s:e], None if pc is None else pc[s:e],
                           calib[s:e], frustum_from=sub)
            for k, v in y.items():
                out.setdefault(k, []).append(v)
        return {k: torch.cat(v) for k, v in out.items()}


def make_inputs(run, device):
    """Pool, reference and weights (BatchNorm calibrated on the first
    sample by the reference): everything both sides share."""
    with run.setup_part("pool"):
        pool = Pool(run, device)
    with run.setup_part("weights"):
        ref = Reference(run, device)
        state = weights.seeded_state(ref.model, run.seed, device)
        ref.model.load_state_dict(state, strict=False)
        frames, infos, clouds = pool.batch(0)
        n = pool.cams
        x, pc, calib, _ = ref.inputs(frames[:n], infos[:n],
                                     clouds[:n] if clouds else None)
        with tf32_off():
            weights.calibrate(ref.model, x, pc, calib)
        state = {k: v.detach().clone() for k, v in
                 ref.model.state_dict().items()}
    return pool, ref, state


# ------------------------------------------------------------------- loop
def program_config(run):
    from centerfusiondetect3d_tpu_torch.config import load_config

    return load_config(opts=list(run.config["opts"]))


def setup(run):
    from centerfusiondetect3d_tpu_torch.runtime.detector import Detector

    device = run.device
    pool, ref, state = make_inputs(run, device)
    with run.setup_part("build"):
        det = Detector(program_config(run), device=device)
        det.model.load_state_dict(state, strict=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    warm = int(run.params["warmup_batches"])
    rng = np.random.default_rng(run.seed + 1)
    capture = Capture(det.model, stages(ref.model))
    pulled: Dict[int, float] = {}
    stop = threading.Event()

    def batches():
        i = 0
        while not stop.is_set():
            item = pool.batch(i)
            pulled[i] = time.perf_counter()
            yield item
            i += 1

    stream = det.run_stream(batches())
    # the first result comes after every kernel was built and loaded; the
    # batches pulled before it waited for that, so the stream is steady
    # once a batch pulled after it has come back, and ``warmup_batches``
    # more after that
    with run.setup_part("first_result"):
        next(stream)
        first = time.perf_counter()
    done, extra = 1, 0
    with run.setup_part("warmup"):
        while extra < warm:
            next(stream)
            extra += pulled[done] > first or extra > 0
            done += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm = done
    # the batches the check reads: drawn from the seed among the first
    # ``capture_span`` the window will dispatch
    span = int(run.params.get("capture_span", 10))
    first = capture.count + 2
    capture.stage_want = capture.y_want = set(rng.choice(
        np.arange(first, first + span), int(run.params["check_batches"]),
        replace=False).tolist())
    return {"det": det, "pool": pool, "ref": ref, "stream": stream,
            "pulled": pulled, "stop": stop, "capture": capture,
            "warm": warm, "results": {}}


def window(run, st):
    det, stream, cap = st["det"], st["stream"], st["capture"]
    frames_a_batch = st["pool"].spb * st["pool"].cams
    sync = ((lambda: torch.cuda.synchronize(run.device))
            if run.device.type == "cuda" else (lambda: None))
    t_open = run.open_window()
    t_close = t_open + run.seconds
    t_trace = t_open + min(run.seconds, TRACE_SECONDS)
    det.stage_stats(reset=True)
    run.trace.start()
    fwd0 = cap.count
    lat: List[float] = []
    i = st["warm"]
    while True:
        with run.spans.span("serve.next"):
            res = next(stream)
        t = time.perf_counter()
        if run.trace.active and t >= min(t_trace, t_close):
            run.counters.update(kind="serve", units=cap.count - fwd0,
                                images_a_unit=frames_a_batch,
                                stages_ms=det.stage_stats())
            run.trace.stop(sync)
        if t > t_close:
            break
        lat.append(t - st["pulled"][i])
        if i in cap.stage_want:
            st["results"][i] = res["results"]
        i += 1
    st["stop"].set()
    stream.close()
    sync()
    st["done"] = set(range(st["warm"], i))
    p95 = float(np.percentile(np.asarray(lat), 95)) if lat else math.nan
    return {"metrics": {"serve_frames_per_s": len(lat) * frames_a_batch
                        / run.seconds,
                        "serve_batch_p95_ms": 1e3 * p95},
            "attempted": len(lat), "failed": 0,
            "counts": {"batches_in_window": len(lat),
                       "p95_over_batches": len(lat),
                       "frames_a_batch": frames_a_batch}}


def check(run, st) -> List[Check]:
    """The program's captured head maps and returned detections against the
    reference (see the module's docstring)."""
    chosen = [i for i in sorted(st["capture"].kept) if i in st["done"]]
    n = int(run.params["check_batches"])
    kept = {i: st["capture"].kept[i] for i in chosen}
    results = {i: st["results"][i] for i in chosen}
    st["capture"].kept.clear()
    del st["det"], st["stream"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if len(chosen) < n:
        return [Check(name, math.inf, run.limits[name])
                for name in run.limits]
    readings: Dict[str, float] = {}
    for i in chosen:
        frames, infos, clouds = st["pool"].batch(i)
        got = judge(st["ref"], frames, infos, clouds, kept[i], results[i])
        for k, v in got.items():
            readings[k] = max(readings.get(k, 0.0), v)
    return [Check(k, readings[k], float(run.limits[k])) for k in run.limits]


def _f32(a, s=None, e=None):
    """A stage's argument as the reference takes it: tensors in float32
    (images ``s:e`` of the batch), lists of them likewise, the rest as it
    is."""
    if isinstance(a, torch.Tensor):
        return a[s:e].float()
    if isinstance(a, (list, tuple)):
        return [_f32(v, s, e) for v in a]
    return a


ACTIVATION = {"heatmap": lambda t: torch.clamp(torch.sigmoid(t), 1e-4,
                                               1 - 1e-4),
              "depth": sigmoid_depth, "depth2": sigmoid_depth}


@torch.no_grad()
def judge(ref: Reference, frames, infos, clouds, kept, prog_results
          ) -> Dict[str, float]:
    """The numbers of one batch: what the program kept of it (``kept``:
    inputs, stages, head maps) and the detections it returned, against the
    reference."""
    out = {"backbone_rms": 0.0, "neck_rms": 0.0, "head_rms": 0.0}
    exact = []
    prog_y = kept["y"]
    with tf32_off():
        x, pc, calib, inv = ref.inputs(frames, infos, clouds)
        image = kept["inputs"][0]
        exact.append(rel_rms(image, x))
        if ref.middle:
            got = kept["inputs"][1].float()
            exact.append(float(((got - pc).abs() > 1e-6).any(1).sum())
                         / float(((got != 0) | (pc != 0)).any(1).sum()
                                 .clamp(min=1)))
        b = x.shape[0]
        for name, (args, p) in kept["stages"].items():
            module = ref.model.get_submodule(name)
            head = name.startswith("detectHead_0.")
            key = ("head_rms" if head else "backbone_rms"
                   if name.startswith("base.") else "neck_rms")
            first = args[0][0] if isinstance(args[0], list) else args[0]
            if first.shape[0] != b or (head and prog_y[name.split(".")[1]]
                                       .shape[0] != b):
                out[key] = math.inf  # images left out of the stage
                continue
            for s in range(0, b, ref.block):
                e = s + ref.block
                r = module(*_f32(args, s, e))
                if head:  # the tower, then its activation on the
                    # program's own tower output
                    h = name.split(".")[1]
                    gap = rel_rms(p[s:e], r)
                    act = ACTIVATION.get(h, lambda t: t)(p[s:e].float())
                    exact.append(rel_rms(prog_y[h][s:e], act))
                elif isinstance(r, list):  # an IDA step: the levels it made
                    first = args[1] + 1
                    gap = max(rel_rms(pi[s:e], ri) for pi, ri in
                              zip(p[first:args[2]], r[first:args[2]]))
                else:
                    gap = rel_rms(p[s:e], r)
                out[key] = max(out[key], gap)
        if ref.middle:
            want = rpp.frustum_heatmap(prog_y, pc, calib, ref.k,
                                       ref.max_dist)[:, 0:1]
            got = prog_y["pc_hm"].float()
            differ = ((got - want).abs() > 1e-4).sum()
            painted = ((got != 0) | (want != 0)).sum().clamp(min=1)
            exact.append(float(differ) / float(painted))
        det, _ = rpp.decode({k: v.float() for k, v in prog_y.items()}, ref.k)
        post = rpp.post_process(det, inv, ref.out_hw, calib)
        exact.append(_det_err(post, prog_results))
    out["exact_err"] = max(exact)
    return out


def _det_err(post, prog_results) -> float:
    """Largest gap between the program's detections and the reference's
    post-process of the same peaks, each field against max(1, |reference|);
    inf where the detections kept differ in number."""
    keep = (post["dimension"] > 0).all(dim=-1).cpu().numpy()
    host = {k: v.detach().cpu().numpy() for k, v in post.items()}
    worst = 0.0
    for b in range(keep.shape[0]):
        rows = np.nonzero(keep[b])[0]
        items = prog_results.get(b, [])
        if len(items) != len(rows):
            return math.inf
        for item, r in zip(items, rows):
            for key, ref_key in DET_FIELDS:
                if key not in item:
                    continue
                p = np.asarray(item[key], np.float64)
                q = np.asarray(host[ref_key][b, r], np.float64)
                gap = np.abs(p - q) / np.maximum(1.0, np.abs(q))
                worst = max(worst, float(np.max(gap)) if gap.size else 0.0)
    return worst


# ------------------------------------------------------------------ control
def control(run, device) -> Dict[str, float]:
    """The check's numbers with the reference in fp8 (each contraction's
    operands rounded to float8 e4m3) in the program's place, on
    ``check_batches`` batches of the pool."""
    pool, ref, state = make_inputs(run, device)
    lower = Reference(run, device, build_reference(run.config))
    lower.model.load_state_dict(state)
    lower.model.quant.fn = round_fp8
    n = int(run.params["check_batches"])
    cap = Capture(lower.model, stages(lower.model), range(n), range(n))
    readings: Dict[str, float] = {}
    for i in range(n):
        frames, infos, clouds = pool.batch(i)
        with tf32_off(), torch.no_grad():
            x, pc, calib, inv = ref.inputs(frames, infos, clouds)
            lower.block = x.shape[0]  # one forward: the program's batch
            y = lower.forward(x, pc, calib)
            det, _ = rpp.decode(y, ref.k)
            post = rpp.post_process(det, inv, ref.out_hw, calib)
        for k, v in judge(ref, frames, infos, clouds, cap.kept.pop(i),
                          _as_results(post)).items():
            readings[k] = max(readings.get(k, 0.0), v)
    return readings


def _as_results(post) -> Dict[int, List[dict]]:
    """Post-processed detections as ``run_stream`` returns them: per
    image, the detections with positive dimensions, in rank order."""
    host = {k: v.detach().cpu().numpy() for k, v in post.items()}
    keep = (host["dimension"] > 0).all(axis=-1)
    out = {}
    for b in range(keep.shape[0]):
        out[b] = [{key: host[ref_key][b, r] for key, ref_key in DET_FIELDS
                   if ref_key in host} for r in np.nonzero(keep[b])[0]]
    return out


# ------------------------------------------------------------ for metrics
def work(run) -> Dict[str, object]:
    """Forward flops of one batch and its DCN nodes' shapes, counted on
    the reference model on the meta device."""
    m = run.config["model"]
    b = int(run.params["samples_per_batch"]) * int(run.params["cameras"])
    h, w = m["input_size"]
    model = build_reference(run.config).to("meta")
    meta = dict(device="meta")
    x = torch.zeros(b, 3, h, w, **meta)
    pc = torch.zeros(b, 3, h // 4, w // 4, **meta)
    return counting.count_model(model, x, pc, torch.zeros(b, 3, 4, **meta),
                                pc)
