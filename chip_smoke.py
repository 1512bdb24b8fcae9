#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --tiny  # CPU rehearsal, no kernel build

On the card it:

1. prints the torch and CUDA versions and the card's name and power limit,
   builds the DCNv2 kernel from ``csrc/`` with nvcc and prints the build time
   and ptxas' register and spill lines;
2. builds ``Detector`` at the full width of ``configs/Centerfusion_Middle.yaml``
   (DLA-34 with DeformConv nodes, 448x800 input, 6 cameras, K=100, frustum
   middle fusion, device radar paint) with weights from a seed, and runs one
   warm-up ``Detector.run`` on six synthetic 800x450 uint8 frames with radar;
3. holds the kernel against its plain PyTorch version at every distinct DCN
   node shape that run met, at max_offset None, 8 and 1, and times both;
4. runs ``Detector.run`` 5 more times with the launch count set to 0 and
   checks that the kernel ran once per DCN node per run and that the
   detections are finite;
5. runs the model once more with the plain DCN and holds every head against
   the kernel run;
6. prints a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failure raises, so the exit code is not 0 and no result line is printed.
Without a CUDA card and without ``--device cpu --tiny`` it fails. The
rehearsal runs the same path at 64x128 with 2 cameras on the CPU, where the
DCN op is the plain version; its last line is ``{"ok": true, "rehearsal":
"cpu"}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.ops.cuda_build import load_kernel_library
from centerfusiondetect3d_tpu_torch.ops.rasterize import (
    paint_rects_device_batch,
)
from centerfusiondetect3d_tpu_torch.runtime.detector import Detector
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    calibrate_batchnorm,
    seeded_weights,
    synthetic_frames,
)

SEED = 0
TIMED_RUNS = 5
TIMING_REPS = 11
# H100 SXM: fp32 outside the tensor cores, bf16 dense tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain: max |kernel - plain| / max |plain|; both sum 9*C fp32
# products in another order
KERNEL_RTOL = 1e-4
# heads, kernel DCN vs plain DCN: max |a - b| / max |b| per head; the
# per-node difference above passes through the rest of DLA-34
HEADS_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def dcn_inputs(shape, device, seed: int):
    """x N(0,1); offsets N(0, 1.5 px) with 2% pushed to 8-12 px, past both
    clamps and, at the borders, out of the image; a sigmoided mask."""
    b, c, h, w, o = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    offset = 1.5 * randn(b, 18, h, w)
    far = torch.rand(offset.shape, generator=gen, device=device) < 0.02
    mag = 8.0 + 4.0 * torch.rand(offset.shape, generator=gen, device=device)
    offset = torch.where(far, torch.sign(offset) * mag, offset)
    return (randn(b, c, h, w), offset, torch.sigmoid(randn(b, 9, h, w)),
            randn(o, c, 3, 3) / math.sqrt(9 * c), 0.1 * randn(o))


def dcn_bound(shape):
    """Least time on an H100 SXM for one node: the larger of the fp32 (or
    bf16) contraction at peak and each input read / output written once."""
    b, c, h, w, o = shape
    flops = 2.0 * b * h * w * 9 * c * o
    elems = b * c * h * w + b * 27 * h * w + o * c * 9 + o + b * o * h * w
    t_fp32 = max(flops / PEAK_FP32, 4 * elems / PEAK_BYTES)
    t_bf16 = max(flops / PEAK_BF16, 2 * elems / PEAK_BYTES)
    by = "operations" if flops / PEAK_FP32 >= 4 * elems / PEAK_BYTES \
        else "bytes"
    return flops, 4 * elems, 1e3 * t_fp32, by, 1e3 * t_bf16


def time_pair(fn_a, fn_b, reps: int):
    """Median ms of fn_a and fn_b, each timed alone with CUDA events, in
    turns (a, b, b, a, ...) after one warm-up call of each."""
    fn_a(), fn_b()
    times = {0: [], 1: []}
    for i in range(reps):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for which in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a if which == 0 else fn_b)()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


# ------------------------------------------------------------------ phases


def node_shapes(det: Detector, frames):
    """Run det.run once with hooks on every DCN node; returns the per-node
    (B, C, H, W, O) shapes in call order."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(
            tuple(args[0].shape) + (mod.weight.shape[0],)))
        for m in det.model.modules() if isinstance(m, DeformConvNode)]
    try:
        det.run(*frames)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def check_kernel(shapes, device, timed: bool):
    """Kernel (the wrapper on the card) vs plain at each distinct shape and
    max_offset in (None, 8, 1); on the card also their times."""
    rows = []
    for i, shape in enumerate(sorted(set(shapes), key=shapes.index)):
        args = dcn_inputs(shape, device, SEED + i)
        worst = 0.0
        worst_rel = 0.0
        for max_offset in (None, 8.0, 1.0):
            got = dcn.deform_conv2d(*args, max_offset=max_offset)
            want = dcn.deform_conv2d_plain(*args, max_offset=max_offset)
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            if not (math.isfinite(err) and rel <= KERNEL_RTOL):
                raise AssertionError(
                    f"DCN kernel disagrees with the plain version at {shape}, "
                    f"max_offset={max_offset}: max abs err {err:.3e}, "
                    f"relative {rel:.3e} > {KERNEL_RTOL}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        flops, nbytes, bound_ms, bound_by, bf16_ms = dcn_bound(shape)
        row = {"shape": list(shape), "nodes": shapes.count(shape),
               "max_abs_err": worst, "max_rel_err": worst_rel,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bf16_ms": bf16_ms}
        if timed:
            row["ms"], row["plain_ms"] = time_pair(
                lambda: dcn.deform_conv2d(*args),
                lambda: dcn.deform_conv2d_plain(*args), TIMING_REPS)
        rows.append(row)
        log(f"  dcn {shape} x{row['nodes']}: max abs err {worst:.3e} "
            f"(rel {worst_rel:.2e}, limit {KERNEL_RTOL})"
            + (f", kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
               f"ms, bound {bound_ms:.4f} ms ({bound_by}, fp32), "
               f"{bf16_ms:.4f} ms at bf16" if timed else ""))
    return rows


def check_results(ret, n_images: int) -> int:
    results = ret["results"]
    if sorted(results) != list(range(n_images)):
        raise AssertionError(f"results for images {sorted(results)}")
    total = 0
    for img_id, items in results.items():
        if not items:
            raise AssertionError(f"no detections for image {img_id}")
        for it in items:
            vals = [it["score"], it["yaw"], it["class"], *np.ravel(it["bbox"]),
                    *np.ravel(it["location"]), *np.ravel(it["dimension"]),
                    *np.ravel(it["velocity"]), *np.ravel(it["nuscenes_att"])]
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"non-finite detection in image {img_id}")
        total += len(items)
    return total


def check_heads(det: Detector, frames):
    """Every head of one forward with the kernel DCN against the same forward
    with the plain DCN on the same device. The secondary heads of both take
    the kernel run's frustum radar heatmap: it equals the plain run's unless
    a near-tie in the first-stage heatmap reorders the top-K boxes, a
    discrete step outside the DCN, which the report states."""
    model = det.model
    batch, _ = det.pre_process(*frames)
    dev = det.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    image = t(batch["image"]).permute(0, 3, 1, 2).float()
    x = (image / 255.0 - det.mean) / det.std
    pc_dep = paint_rects_device_batch(t(batch["pc_boxes"]),
                                      t(batch["pc_values"]),
                                      det.config.MODEL.OUTPUT_SIZE)
    calib = t(batch["calib"])
    nodes = [m for m in model.modules() if isinstance(m, DeformConvNode)]

    def forward(fn):
        for m in nodes:
            m.dcn_fn = fn
        try:
            with torch.inference_mode():
                feats = model.img2feats(x)
                y = model.detectHead_0.first_stage(feats)
                pc_hm = model.frustum_heatmap(y, pc_dep, calib)
                return feats, y, pc_hm
        finally:
            for m in nodes:
                m.dcn_fn = dcn.deform_conv2d

    feats_k, y_k, pc_k = forward(dcn.deform_conv2d)
    feats_p, y_p, pc_p = forward(dcn.deform_conv2d_plain)
    same_frustum = bool(torch.equal(pc_k, pc_p))
    with torch.inference_mode():
        y_k.update(model.detectHead_0.second_stage(feats_k, pc_k))
        y_p.update(model.detectHead_0.second_stage(feats_p, pc_k))
    worst = {}
    for name in sorted(y_k):
        a, b = y_k[name].float(), y_p[name].float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"head {name}: non-finite kernel output")
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst[name] = rel
        if rel > HEADS_RTOL:
            raise AssertionError(f"head {name}: kernel vs plain DCN differ "
                                 f"by {rel:.3e} relative > {HEADS_RTOL}")
    return worst, same_frustum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="64x128, 2 cameras (the CPU rehearsal)")
    args = ap.parse_args(argv)
    rehearsal = args.device == "cpu"
    if rehearsal and not args.tiny:
        raise SystemExit("chip_smoke: --device cpu runs only with --tiny")
    if not rehearsal and not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available (run on a "
                         "machine with a CUDA card, or rehearse with "
                         "--device cpu --tiny)")
    t_all = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED)

    # 1. environment and kernel build
    t0 = time.perf_counter()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    card = None
    if not rehearsal:
        card = nvidia_smi()
        log(f"card: {card}")
        built = load_kernel_library(dcn.KERNEL_SOURCE)
        log(f"dcn_fwd.cu built with nvcc in {built.build_seconds:.1f} s "
            f"-> {built.path.name}")
        for line in built.ptxas:
            log(f"  ptxas: {line}")
    log(f"phase environment: {time.perf_counter() - t0:.1f} s")

    # 2. the detector at full width, seeded weights, warm-up run
    t0 = time.perf_counter()
    if rehearsal:
        opts = MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(64, 128)"]
        n_cams, frame_hw = 2, (72, 128)
    else:
        opts, n_cams, frame_hw = MAIN_PATH_OPTS, 6, (450, 800)
    cfg = load_config(opts=opts, num_classes=10)
    det = Detector(cfg, device=args.device)
    seeded_weights(det.model, SEED)
    frames = synthetic_frames(n_cams, *frame_hw, seed=SEED)
    calibrate_batchnorm(det, frames)
    n_nodes = sum(isinstance(m, DeformConvNode) for m in det.model.modules())
    shapes = node_shapes(det, frames)
    if len(shapes) != n_nodes:
        raise AssertionError(f"{len(shapes)} DCN calls, {n_nodes} nodes")
    log(f"detector: {cfg.MODEL.INPUT_SIZE[0]}x{cfg.MODEL.INPUT_SIZE[1]} "
        f"input, {n_cams} cameras of {frame_hw[1]}x{frame_hw[0]}, "
        f"{n_nodes} DCN nodes, K={cfg.MODEL.K}, "
        f"{sum(p.numel() for p in det.model.parameters()) / 1e6:.2f} M params")
    log("DCN node shapes (B, C, H, W, O) in call order: "
        + ", ".join(str(s) for s in shapes))
    log(f"phase build+warm-up: {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain at every distinct node shape
    t0 = time.perf_counter()
    rows = check_kernel(shapes, det.device, timed=not rehearsal)
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 4. the main path through the entry point, counted
    t0 = time.perf_counter()
    det.timer.reset()
    det.stage_stats(reset=True)
    detections = 0
    dcn.deform_conv2d.launches = 0
    for _ in range(TIMED_RUNS):
        ret = det.run(*frames)
        detections += check_results(ret, n_cams)
    launches = dcn.deform_conv2d.launches
    expected = 0 if rehearsal else n_nodes * TIMED_RUNS
    if launches != expected:
        raise AssertionError(f"dcn_fwd launched {launches} times on the main "
                             f"path, expected {expected}")
    times = ret["times"]
    log(f"main path: {TIMED_RUNS} runs, dcn_fwd launches {launches} "
        f"(expected {expected}: {n_nodes} nodes x {TIMED_RUNS} runs on the "
        f"card), {detections} detections, all finite")
    log("  stage ms: " + ", ".join(f"{k} {1e3 * v:.2f}"
                                   for k, v in times.items()))
    log("  host stage ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in det.stage_stats().items()))
    if not rehearsal:
        log(f"  {n_cams / times['total']:.2f} frames/s "
            f"({1e3 * times['total']:.2f} ms per {n_cams}-camera batch, "
            f"load excluded) on {card}")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")

    # 5. every head, kernel DCN vs plain DCN
    t0 = time.perf_counter()
    worst, same_frustum = check_heads(det, frames)
    log(f"heads kernel vs plain DCN: worst relative "
        f"{max(worst.values()):.3e} (limit {HEADS_RTOL}), frustum top-K "
        f"selection identical: {same_frustum}")
    log("  " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    log(f"phase heads: {time.perf_counter() - t0:.1f} s")
    log(f"total wall: {time.perf_counter() - t_all:.1f} s")

    if rehearsal:
        print(json.dumps({"ok": True, "rehearsal": "cpu"}), flush=True)
        return 0
    kernel = {
        "name": "dcn_fwd", "route": "cuda",
        "source": "centerfusiondetect3d_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:117",
        "also_replaces": ["centerfusiondetect3d_tpu/ops/pallas_dcn.py:240"],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per forward of the main path: the sum over its DCN node launches
        "ms": sum(r["ms"] * r["nodes"] for r in rows),
        "plain_ms": sum(r["plain_ms"] * r["nodes"] for r in rows),
        "bound_ms": sum(r["bound_ms"] * r["nodes"] for r in rows),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in rows) else "bytes",
        "library_ms": None,
        "per_node_shape": rows,
    }
    log(card)  # as nvidia-smi --query-gpu=name,power.limit gives it
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
