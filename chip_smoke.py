#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --tiny  # CPU rehearsal, no kernel build

On the card it:

1. prints the torch and CUDA versions and the card's name and power limit,
   builds the DCNv2 kernels from ``csrc/`` (``dcn_fwd.cu``, ``dcn_bwd.cu``,
   ``dcn_fwd_bf16.cu``) with one nvcc each, all in parallel, and prints the
   build time and ptxas' register, shared memory and spill lines;
2. builds ``Detector`` at the full width of ``configs/Centerfusion_Middle.yaml``
   (DLA-34 with DeformConv nodes, 448x800 input, 6 cameras, K=100, frustum
   middle fusion, device radar paint) in float32 (``MIXED_PRECISION False``)
   with weights from a seed, and runs one warm-up ``Detector.run`` on six
   synthetic 800x450 uint8 frames with radar;
3. holds the float32 kernel against its plain PyTorch version at every
   distinct DCN node shape that run met, at max_offset None, 8 and 1, and
   times both;
4. does the same for the bf16 kernel ``dcn_fwd_bf16`` against its plain
   version (``deform_conv2d_bf16_plain``), with its bound on the bf16
   tensor cores and the float32 kernel's time beside it;
5. runs ``Detector.run`` 5 more times with the launch counts set to 0 and
   checks that the kernel ran once per DCN node per run and that the
   detections are finite;
6. runs the model once more with the plain DCN and holds every head against
   the kernel run;
7. serves in bf16 as the shipped configs do (``MIXED_PRECISION True``): a
   second ``Detector`` on the same weights and calibrated BatchNorm, one
   warm-up run, then 5 counted runs that must launch ``dcn_fwd_bf16`` once
   per DCN node per run and ``dcn_fwd`` never; frames/s and stages beside
   the float32 ones;
8. holds every head of the bf16 kernel forward against the bf16 plain-DCN
   forward, within twice the plain bf16 forward's own deviation from the
   float32 forward plus HEADS_RTOL, and prints that bf16-vs-float32
   deviation (not bounded: the weights are seeded, not trained);
9. holds the DCN backward kernels (``csrc/dcn_bwd.cu``: ``dcn_im2col``,
   ``dcn_col2im``, ``dcn_col2im_coord``, around two plain GEMMs) against the
   plain backward (autograd of the plain DCN) at every distinct node shape
   with B=2, at max_offset None, 8 and 1, each kernel also against its own
   plain version, and times the backward, its parts and the plain backward;
10. trains with ``runtime/fit.py:Trainer`` at the same full width in float32:
   ``TRAIN.BATCH_SIZE 26`` in 2 microbatches of 13 (``GRAD_ACCUM 2``) on 52
   synthetic items, ``FREEZE_BACKBONE`` with ``DEFREEZE 0`` and 2 epochs:
   2 frozen steps, then 2 unfrozen ones (after one untimed warm-up step
   that is undone); checks that every loss part is finite, that the
   backbone stays bitwise unchanged through the frozen steps and changes in
   the unfrozen ones, that the heads change in both, and that the kernels
   launched once per DCN node per microbatch (the backward ones only in
   unfrozen steps); reports ms per step, images/s and peak memory; the
   Trainer writes its last epoch's reference ``.pt`` checkpoint into a
   temporary ``OUTPUT_DIR``, which must read back equal to the model;
11. runs one unfrozen train step of B=2 at full width three times on the
   same seeded weights and batch: with the kernel DCN, the plain DCN, and
   the plain DCN in float64; holds each DCN node's in-step backward against
   the plain backward on its own tensors, and every loss part and parameter
   gradient of the kernel step against the float64 step, at the float32
   noise floor the plain step measures;
12. prints a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failure raises, so the exit code is not 0 and no result line is printed.
Without a CUDA card and without ``--device cpu --tiny`` it fails. The
rehearsal runs the same path at 64x128 with 2 cameras (and a training batch
of 4 in 2 microbatches) on the CPU, where the DCN ops are the plain versions
(the bf16 phases included); its last line is
``{"ok": true, "rehearsal": "cpu"}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import stack_items, to_device
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.ops.cuda_build import load_kernel_libraries
from centerfusiondetect3d_tpu_torch.ops.rasterize import (
    paint_rects_device_batch,
)
from centerfusiondetect3d_tpu_torch.runtime.detector import Detector
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    FP32_OPTS,
    MAIN_PATH_OPTS,
    SyntheticTrainingSet,
    calibrate_batchnorm,
    seeded_weights,
    synthetic_frames,
)
from centerfusiondetect3d_tpu_torch.training import make_optimizer, train_step
from centerfusiondetect3d_tpu_torch.training.checkpoint import load_torch_file

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
# the bf16 kernel vs its plain version, the same measure: two bf16 ulps at
# the largest magnitude (the f32 sums differ in order, and a tap or the
# output can round to the neighbouring bf16 value)
BF16_RTOL = 8e-3
# bf16 heads, kernel vs plain DCN: within BF16_HEAD_MULT times the plain
# bf16 forward's own deviation from the float32 forward, plus HEADS_RTOL
BF16_HEAD_MULT = 2
# heads, kernel DCN vs plain DCN: max |a - b| / max |b| per head; the
# per-node difference above passes through the rest of DLA-34
HEADS_RTOL = 1e-3
# backward kernels vs plain backward: max |kernel - plain| / max |plain| per
# gradient tensor; sums over C, B*H*W or 9C in another order, and dx with
# fp32 atomics whose order changes from run to run: the forward's limit
GRAD_RTOL = 1e-4
# one train step, kernel DCN against the float64 plain step: each loss part
# and parameter gradient within NOISE_MULT times the plain float32 step's
# own deviation plus STEP_RTOL (the heads' limit) of the float64 tensor's
# largest magnitude; see step_kernel_vs_plain for why the float32 noise
# floor and not STEP_RTOL alone
STEP_RTOL = 1e-3
NOISE_MULT = 4  # the JAX package's golden train-step test's multiple
BWD_BATCH = 2  # the backward check's batch: the plain autograd must fit
# the training main path: the flagship's batch of 26 (MAIN_PATH_OPTS) in
# microbatches of 13; 2 epochs of 2 steps, the first frozen
TRAIN_OPTS = FP32_OPTS + ["TRAIN.GRAD_ACCUM", "2", "MODEL.DEFREEZE", "0",
                          "TRAIN.EPOCHS", "2"]
TRAIN_ITEMS = 52
BWD_KERNELS = ("dcn_im2col", "dcn_col2im", "dcn_col2im_coord")
GRAD_NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")


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
    """Least time on an H100 SXM for one node: the larger of the fp32
    contraction at peak and each input read / output written once; and the
    bf16 kernel's bound (``dcn_bound_bf16``)."""
    b, c, h, w, o = shape
    flops = 2.0 * b * h * w * 9 * c * o
    elems = b * c * h * w + b * 27 * h * w + o * c * 9 + o + b * o * h * w
    t_fp32 = max(flops / PEAK_FP32, 4 * elems / PEAK_BYTES)
    by = "operations" if flops / PEAK_FP32 >= 4 * elems / PEAK_BYTES \
        else "bytes"
    return flops, 4 * elems, 1e3 * t_fp32, by, dcn_bound_bf16(shape)[2]


def dcn_bound_bf16(shape):
    """The bf16 kernel's least time on an H100 SXM: the larger of the
    contraction at the dense bf16 tensor-core rate (989 TFLOP/s) and the
    bytes at 3.35 TB/s, each read or written once: x, weight, bias and the
    output in bf16, offset and mask in float32. (flops, bytes, ms, by)."""
    b, c, h, w, o = shape
    flops = 2.0 * b * h * w * 9 * c * o
    nbytes = (2 * (b * c * h * w + o * c * 9 + o + b * o * h * w)
              + 4 * b * 27 * h * w)
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return (flops, nbytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


def check_kernel_bf16(shapes, device, timed: bool, fp32_rows):
    """The bf16 kernel (``dcn_fwd_bf16``) vs its plain version at each
    distinct shape and max_offset in (None, 8, 1), on the phase-3 inputs
    rounded to bf16 (offset and mask stay float32); on the card also both
    times, beside the float32 kernel's time from ``fp32_rows``."""
    rows = []
    for i, shape in enumerate(sorted(set(shapes), key=shapes.index)):
        x, offset, mask, weight, bias = dcn_inputs(shape, device, SEED + i)
        args = (x.bfloat16(), offset, mask, weight.bfloat16(),
                bias.bfloat16())
        worst = worst_rel = 0.0
        for max_offset in (None, 8.0, 1.0):
            got = dcn.dcn_fwd_bf16(*args, max_offset=max_offset)
            want = dcn.deform_conv2d_bf16_plain(*args, max_offset=max_offset)
            if got.dtype != torch.bfloat16:
                raise AssertionError(f"dcn_fwd_bf16 returned {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            rel = err / max(float(want.float().abs().max()), 1e-30)
            if not (math.isfinite(err) and rel <= BF16_RTOL):
                raise AssertionError(
                    f"bf16 DCN kernel disagrees with its plain version at "
                    f"{shape}, max_offset={max_offset}: max abs err "
                    f"{err:.3e}, relative {rel:.3e} > {BF16_RTOL}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        flops, nbytes, bound_ms, bound_by = dcn_bound_bf16(shape)
        row = {"shape": list(shape), "nodes": shapes.count(shape),
               "max_abs_err": worst, "max_rel_err": worst_rel,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if timed:
            row["ms"], row["plain_ms"] = time_pair(
                lambda: dcn.dcn_fwd_bf16(*args),
                lambda: dcn.deform_conv2d_bf16_plain(*args), TIMING_REPS)
            row["fp32_ms"] = next(r["ms"] for r in fp32_rows
                                  if r["shape"] == list(shape))
        rows.append(row)
        log(f"  dcn bf16 {shape} x{row['nodes']}: max abs err {worst:.3e} "
            f"(rel {worst_rel:.2e}, limit {BF16_RTOL})"
            + (f", kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
               f"ms, fp32 kernel {row['fp32_ms']:.4f} ms, bound "
               f"{bound_ms:.4f} ms ({bound_by}, bf16 tensor cores)"
               if timed else ""))
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
    x, pc_dep, calib = model_inputs(det, frames)
    feats_k, y_k, pc_k = first_stage(model, dcn.deform_conv2d, x, pc_dep,
                                     calib)
    feats_p, y_p, pc_p = first_stage(model, dcn.deform_conv2d_plain, x,
                                     pc_dep, calib)
    same_frustum = bool(torch.equal(pc_k, pc_p))
    with torch.inference_mode():
        y_k.update(model.detectHead_0.second_stage(feats_k, pc_k))
        y_p.update(model.detectHead_0.second_stage(feats_p, pc_k))
    worst = {}
    for name in sorted(y_k):
        a, b = y_k[name].float(), y_p[name].float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"head {name}: non-finite kernel output")
        rel = rel_err(a, b)
        worst[name] = rel
        if rel > HEADS_RTOL:
            raise AssertionError(f"head {name}: kernel vs plain DCN differ "
                                 f"by {rel:.3e} relative > {HEADS_RTOL}")
    return worst, same_frustum


def model_inputs(det: Detector, frames):
    """The normalized image, painted radar map and calib of one batch on
    the card, as ``Detector._forward`` makes them (float32)."""
    batch, _ = det.pre_process(*frames)
    dev = det.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    image = t(batch["image"]).permute(0, 3, 1, 2).float()
    x = (image / 255.0 - det.mean) / det.std
    pc_dep = paint_rects_device_batch(t(batch["pc_boxes"]),
                                      t(batch["pc_values"]),
                                      det.config.MODEL.OUTPUT_SIZE)
    return x, pc_dep, t(batch["calib"])


def first_stage(model, fn, x, pc_dep, calib):
    """Features, first-stage heads and frustum heatmap of ``model`` with
    ``fn`` as every DCN node's op."""
    nodes = [m for m in model.modules() if isinstance(m, DeformConvNode)]
    for m in nodes:
        m.dcn_fn = fn
    try:
        with torch.inference_mode():
            feats = model.img2feats(x)
            y = model.detectHead_0.first_stage(feats)
            return feats, y, model.frustum_heatmap(y, pc_dep, calib)
    finally:
        for m in nodes:
            m.dcn_fn = dcn.deform_conv2d


def check_heads_bf16(det32: Detector, det16: Detector, frames):
    """Every head of the bf16 model with the bf16 kernel DCN against the
    same model with the bf16 plain DCN, within BF16_HEAD_MULT times the
    plain bf16 forward's own deviation from the float32 forward (the float32
    model with its kernel) plus HEADS_RTOL. All three secondary stages take
    the bf16 kernel run's frustum heatmap. Inside the kernel forward each
    DCN node's output is also held against the plain version on the very
    tensors that node saw (BF16_RTOL): the seeded network amplifies a
    one-ulp difference at a node into a far larger one at the heads.
    Returns per head (kernel vs plain, plain vs float32, kernel vs float32),
    the per-node errors, and whether the three frustum top-K selections
    were identical."""
    x, pc_dep, calib = model_inputs(det32, frames)
    m16, m32 = det16.model, det32.model
    node_rel = []

    def checked(x, offset, mask, weight, bias, max_offset=None):
        out = dcn.deform_conv2d(x, offset, mask, weight, bias, max_offset)
        want = dcn.deform_conv2d_plain(x, offset, mask, weight, bias,
                                       max_offset)
        node_rel.append(rel_err(out.float(), want.float()))
        if not node_rel[-1] <= BF16_RTOL:
            raise AssertionError(
                f"bf16 DCN node {len(node_rel)} at {tuple(x.shape)}: kernel "
                f"vs plain on its own inputs {node_rel[-1]:.3e} > {BF16_RTOL}")
        return out

    feats_k, y_k, pc_k = first_stage(m16, checked, x, pc_dep, calib)
    feats_p, y_p, pc_p = first_stage(m16, dcn.deform_conv2d_plain, x, pc_dep,
                                     calib)
    feats_f, y_f, pc_f = first_stage(m32, dcn.deform_conv2d, x, pc_dep,
                                     calib)
    same_frustum = bool(torch.equal(pc_k, pc_p) and torch.equal(pc_k, pc_f))
    with torch.inference_mode():
        for model, feats, y in ((m16, feats_k, y_k), (m16, feats_p, y_p),
                                (m32, feats_f, y_f)):
            y.update(model.detectHead_0.second_stage(feats, pc_k))
    worst = {}
    for name in sorted(y_k):
        k, p, f = (y[name].float() for y in (y_k, y_p, y_f))
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"bf16 head {name}: non-finite output")
        kp, pf, kf = rel_err(k, p), rel_err(p, f), rel_err(k, f)
        worst[name] = (kp, pf, kf)
        if kp > BF16_HEAD_MULT * pf + HEADS_RTOL:
            raise AssertionError(
                f"bf16 head {name}: kernel vs plain DCN differ by {kp:.3e} "
                f"relative > {BF16_HEAD_MULT} x {pf:.3e} (plain bf16 vs "
                f"float32) + {HEADS_RTOL}")
    return worst, node_rel, same_frustum


def time_one(fn, reps: int) -> float:
    """Median ms of fn with CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bwd_bounds(shape):
    """Least time on an H100 SXM (fp32: 67 TFLOP/s, 3.35 TB/s) of each part
    of one node's backward: (flops, bytes, bound ms, bound_by) per part and
    for the whole backward; each input read and each output written once.
    Flops per column element: im2col 7 (4 products, 3 sums), col2im 8 (4
    products and 4 atomic adds), coord 25 (the sample and its 2 bilinear
    derivatives, 3 multiply-adds); GEMMs 2 x 2*B*O*9C*HW."""
    b, c, h, w, o = shape
    hw = h * w
    cols = 9 * b * c * hw
    x, om, g, wt = b * c * hw, 27 * b * hw, b * o * hw, 9 * c * o
    parts = {
        "dcn_im2col": (7 * cols, 4 * (x + om + cols)),
        "dcn_col2im": (8 * cols, 4 * (cols + om + x)),
        "dcn_col2im_coord": (25 * cols, 4 * (cols + x + om + om)),
        "gemms": (4 * b * o * 9 * c * hw, 4 * (g + cols + wt + wt + cols)),
    }
    parts["backward"] = (sum(f for f, _ in parts.values()),
                         4 * (x + om + wt + g + x + om + wt + o))
    out = {}
    for name, (flops, nbytes) in parts.items():
        t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
        out[name] = (flops, nbytes, 1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def check_backward(shapes, device, timed: bool, micro: int):
    """Backward kernels vs plain at each distinct node shape with B=2 and
    max_offset in (None, 8, 1): the five gradients, and each kernel against
    its own plain version on the same inputs. On the card also the CUDA-event
    medians of the backward, its parts and the plain versions, and of the
    forward and backward kernels at the training microbatch ``micro``."""
    rows = []
    for i, full in enumerate(sorted(set(shapes), key=shapes.index)):
        shape = (BWD_BATCH,) + tuple(full[1:])
        b, c, h, w, o = shape
        x, off, mask, wt, bias = dcn_inputs(shape, device, SEED + 100 + i)
        gen = torch.Generator(device=device).manual_seed(SEED + 200 + i)
        g = torch.randn((b, o, h, w), generator=gen, device=device)
        errs = {k: 0.0 for k in BWD_KERNELS}
        worst = 0.0

        def dcols_of():
            return torch.matmul(wt.reshape(o, 9 * c).t(),
                                g.view(b, o, h * w)).contiguous()

        for max_offset in (None, 8.0, 1.0):
            got = dcn.deform_conv2d_backward(x, off, mask, wt, g, max_offset)
            want = dcn.deform_conv2d_backward_plain(x, off, mask, wt, bias, g,
                                                    max_offset)
            for name, a, ref in zip(GRAD_NAMES, got, want):
                rel = rel_err(a, ref)
                worst = max(worst, rel)
                if not (math.isfinite(rel) and rel <= GRAD_RTOL):
                    raise AssertionError(
                        f"DCN backward {name} disagrees with the plain "
                        f"backward at {shape}, max_offset={max_offset}: "
                        f"relative {rel:.3e} > {GRAD_RTOL}")
            dcols = dcols_of()
            pairs = {
                "dcn_im2col": [(dcn.dcn_im2col(x, off, mask, max_offset),
                                dcn.dcn_im2col_plain(x, off, mask,
                                                     max_offset))],
                "dcn_col2im": [(dcn.dcn_col2im(dcols, off, mask, max_offset),
                                dcn.dcn_col2im_plain(dcols, x, off, mask,
                                                     max_offset))],
                "dcn_col2im_coord": list(zip(
                    dcn.dcn_col2im_coord(dcols, x, off, mask, max_offset),
                    dcn.dcn_col2im_coord_plain(dcols, x, off, mask,
                                               max_offset))),
            }
            for name, items in pairs.items():
                for a, ref in items:
                    rel = rel_err(a, ref)
                    if not (math.isfinite(rel) and rel <= GRAD_RTOL):
                        raise AssertionError(
                            f"{name} disagrees with its plain version at "
                            f"{shape}, max_offset={max_offset}: relative "
                            f"{rel:.3e} > {GRAD_RTOL}")
                    errs[name] = max(errs[name],
                                     float((a - ref).abs().max()))
        bounds = bwd_bounds(shape)
        row = {"shape": list(shape), "nodes": shapes.count(full),
               "max_rel_err": worst, "max_abs_err": errs,
               "bound_ms": {k: v[2] for k, v in bounds.items()},
               "bound_by": {k: v[3] for k, v in bounds.items()},
               "gflop": {k: v[0] / 1e9 for k, v in bounds.items()},
               "mbytes": {k: v[1] / 1e6 for k, v in bounds.items()}}
        if timed:
            dcols = dcols_of()
            cols = dcn.dcn_im2col(x, off, mask)
            ms, plain = {}, {}
            ms["backward"], plain["backward"] = time_pair(
                lambda: dcn.deform_conv2d_backward(x, off, mask, wt, g),
                lambda: dcn.deform_conv2d_backward_plain(
                    x, off, mask, wt, bias, g), TIMING_REPS)
            ms["dcn_im2col"], plain["dcn_im2col"] = time_pair(
                lambda: dcn.dcn_im2col(x, off, mask),
                lambda: dcn.dcn_im2col_plain(x, off, mask), TIMING_REPS)
            ms["dcn_col2im"], plain["dcn_col2im"] = time_pair(
                lambda: dcn.dcn_col2im(dcols, off, mask),
                lambda: dcn.dcn_col2im_plain(dcols, x, off, mask),
                TIMING_REPS)
            ms["dcn_col2im_coord"], plain["dcn_col2im_coord"] = time_pair(
                lambda: dcn.dcn_col2im_coord(dcols, x, off, mask),
                lambda: dcn.dcn_col2im_coord_plain(dcols, x, off, mask),
                TIMING_REPS)
            ms["gemms"] = time_one(lambda: (
                torch.matmul(g.view(b, o, h * w), cols.transpose(1, 2)).sum(0),
                dcols_of()), TIMING_REPS)
            row["ms"], row["plain_ms"] = ms, plain
            # kernel times at the training microbatch, for the step shares
            mshape = (micro,) + tuple(full[1:])
            mx, moff, mmask, mwt, mbias = dcn_inputs(mshape, device, SEED)
            mg = torch.randn((micro, o, h, w), generator=gen, device=device)
            row["micro_ms"] = {
                "forward": time_one(lambda: dcn.deform_conv2d(
                    mx, moff, mmask, mwt, mbias), 5),
                "backward": time_one(lambda: dcn.deform_conv2d_backward(
                    mx, moff, mmask, mwt, mg), 5)}
        rows.append(row)
        log(f"  dcn backward {shape} x{row['nodes']}: max rel err "
            f"{worst:.2e} (limit {GRAD_RTOL}), per kernel abs "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + ("" if not timed else
               "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
               + f"; plain backward {plain['backward']:.4f} ms; bound "
               f"{bounds['backward'][2]:.4f} ms ({bounds['backward'][3]})"
               f"; at B={micro}: forward {row['micro_ms']['forward']:.3f} ms"
               f", backward {row['micro_ms']['backward']:.3f} ms"))
    return rows


def launch_counts():
    return {"dcn_fwd": dcn.deform_conv2d.launches,
            "dcn_fwd_bf16": dcn.dcn_fwd_bf16.launches,
            **{k: f.launches for k, f in dcn.BACKWARD_KERNELS.items()}}


def reset_launch_counts():
    dcn.deform_conv2d.launches = 0
    dcn.dcn_fwd_bf16.launches = 0
    for f in dcn.BACKWARD_KERNELS.values():
        f.launches = 0


def serve_counted(det: Detector, frames, n_cams: int):
    """TIMED_RUNS counted runs of ``det.run``; returns (launch counts,
    detections, the last run's stage times, host stage ms)."""
    det.timer.reset()
    det.stage_stats(reset=True)
    detections = 0
    reset_launch_counts()
    for _ in range(TIMED_RUNS):
        ret = det.run(*frames)
        detections += check_results(ret, n_cams)
    return launch_counts(), detections, ret["times"], det.stage_stats()


def train_main_path(device, rehearsal: bool):
    """Phase 10: the Trainer at full width in float32, counted, writing its
    checkpoints into a temporary OUTPUT_DIR; returns its report."""
    opts = MAIN_PATH_OPTS + TRAIN_OPTS
    n_items = TRAIN_ITEMS
    if rehearsal:
        opts = opts + ["MODEL.INPUT_SIZE", "(64, 128)", "TRAIN.BATCH_SIZE",
                       "4"]
        n_items = 8
    with tempfile.TemporaryDirectory(prefix="cfd_smoke_") as out_dir:
        cfg = load_config(opts=opts + ["OUTPUT_DIR", repr(out_dir)],
                          num_classes=10)
        return _train_main_path(cfg, n_items, device, rehearsal)


def _train_main_path(cfg, n_items, device, rehearsal: bool):
    accum = int(cfg.TRAIN.GRAD_ACCUM)
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    t0 = time.perf_counter()
    ds = SyntheticTrainingSet(cfg, n_items, seed=SEED)
    trainer = Trainer(cfg, ds, device=device)
    trainer.init_state(seed=SEED)
    model = trainer.model
    n_nodes = sum(isinstance(m, DeformConvNode) for m in model.modules())
    # one untimed warm-up step (kernel builds, library handles), undone
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    first = to_device(stack_items([ds.get_item(i)
                                   for i in range(batch_size)]), device)
    train_step(model, make_optimizer(cfg, model), trainer.loss_fn, first, 0.0,
               False, accum)
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    del first, saved
    if not rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    def snapshot():
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    snaps, counts, parts = [snapshot()], [], []

    def on_step(epoch, step, frozen, metrics):
        counts.append(launch_counts())
        snaps.append(snapshot())
        parts.append(metrics)

    trainer.on_step = on_step
    reset_launch_counts()
    trainer.train()
    steps = trainer.steps
    phases = [s["frozen"] for s in steps]
    want_phases = [True] * (n_items // batch_size) + [False] * (
        n_items // batch_size)
    if phases != want_phases:
        raise AssertionError(f"frozen per step {phases}, want {want_phases}")
    for k, metrics in enumerate(parts):
        bad = [n for n, v in metrics.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {k}: non-finite loss parts {bad}")
    backbone_names = {n for n, _ in model.backbone_parameters()}
    for k, frozen in enumerate(phases):
        prev, cur = snaps[k], snaps[k + 1]
        phase = "frozen" if frozen else "unfrozen"
        for name in cur:
            same = torch.equal(prev[name], cur[name])
            backbone = name in backbone_names
            if backbone and frozen and not same:
                raise AssertionError(f"frozen step {k} changed {name}")
            if (not backbone or not frozen) and same:
                raise AssertionError(f"{phase} step {k} left {name} "
                                     "unchanged")
    # launches per step: the float32 forward once per node per microbatch;
    # backward kernels the same, in unfrozen steps only; the bf16 forward
    # never; none on the CPU
    per_node = 0 if rehearsal else n_nodes * accum
    prev = {k: 0 for k in counts[0]}
    for k, (frozen, cur) in enumerate(zip(phases, counts)):
        delta = {n: cur[n] - prev[n] for n in cur}
        want = {n: (per_node if n == "dcn_fwd"
                    or (n in BWD_KERNELS and not frozen) else 0)
                for n in cur}
        if delta != want:
            phase = "frozen" if frozen else "unfrozen"
            raise AssertionError(f"{phase} step {k}: launches {delta}, want "
                                 f"{want}")
        prev = cur
    # the last epoch's checkpoint, read back (reference .pt dict)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "ckpts")
    last_epoch = int(cfg.TRAIN.EPOCHS) - 1
    files = sorted(os.listdir(ckpt_dir))
    if files != sorted([f"model_{last_epoch}.pt", "model_last.pt"]):
        raise AssertionError(f"checkpoints written: {files}")
    ckpt = load_torch_file(os.path.join(ckpt_dir, "model_last.pt"))
    if ckpt["epoch"] != last_epoch or ckpt["optimizer"] is None:
        raise AssertionError(f"checkpoint epoch {ckpt['epoch']}, optimizer "
                             f"{'absent' if ckpt['optimizer'] is None else 'present'}")
    for name, value in model.state_dict().items():
        if not torch.equal(ckpt["state_dict"][name], value.cpu()):
            raise AssertionError(f"checkpoint {name} differs from the model")
    ckpt_mb = os.path.getsize(os.path.join(ckpt_dir, "model_last.pt")) / 1e6
    del ckpt
    ms = {ph: [1e3 * s["seconds"] for s in steps if s["frozen"] == fz]
          for ph, fz in (("frozen", True), ("unfrozen", False))}
    report = {
        "batch": batch_size, "grad_accum": accum, "items": n_items,
        "steps": len(steps), "launches": counts[-1],
        "expected_backward_launches": per_node * phases.count(False),
        "ms_per_step": {k: statistics.mean(v) for k, v in ms.items()},
        "ms_steps": ms,
        "images_per_s": {k: batch_size / (statistics.mean(v) / 1e3)
                         for k, v in ms.items()},
        "setup_s": setup_s,
        "total": [s["total"] for s in steps],
        "checkpoints": files, "checkpoint_mb": ckpt_mb,
    }
    if not rehearsal:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return report


def record_dcn_nodes(model):
    """Route every DCN node through a recorder of what its op sees in a
    train step: inputs, weight, output gradient, and the gradients the op
    returns for x, offset and mask (the weight's and bias's are the
    parameters' own .grad). Returns the list the step fills."""
    records = []

    def make(node):
        def fn(x, offset, mask, weight, bias, max_offset=None):
            xv = x.view_as(x)  # the op's own handle on x: only it feeds dx
            rec = {"node": node, "x": x.detach(), "offset": offset.detach(),
                   "mask": mask.detach(), "weight": weight.detach().clone(),
                   "bias": bias.detach().clone()}
            for name, t in (("dx", xv), ("doffset", offset), ("dmask", mask)):
                t.register_hook(lambda g, name=name: rec.__setitem__(name, g))
            out = dcn.deform_conv2d(xv, offset, mask, weight, bias,
                                    max_offset)
            out.register_hook(lambda g: rec.__setitem__("grad_out", g))
            records.append(rec)
            return out
        return fn

    for m in model.modules():
        if isinstance(m, DeformConvNode):
            m.dcn_fn = make(m)
    return records


def step_kernel_vs_plain(device, rehearsal: bool):
    """Phase 11: one unfrozen B=2 step on the same seeded weights and batch,
    with the kernel DCN (float32), the plain DCN (float32) and the plain
    DCN in float64. Inside the kernel step, each DCN node's backward is held
    against the plain backward on the very tensors it saw (GRAD_RTOL). The
    whole step's loss parts and parameter gradients, kernel against the
    float64 step, are held to NOISE_MULT times the plain float32 step's own
    deviation from it, plus STEP_RTOL: a float32 train step of this seeded
    DLA-34 is chaotic (train-mode BatchNorm over nearly constant channels
    amplifies rounding), so two correct float32 steps differ far more than
    STEP_RTOL (measured up to 1.4x a gradient's largest magnitude)."""
    opts = MAIN_PATH_OPTS + FP32_OPTS + (["MODEL.INPUT_SIZE", "(64, 128)"]
                                         if rehearsal else [])
    cfg = load_config(opts=opts, num_classes=10)
    ds = SyntheticTrainingSet(cfg, BWD_BATCH, seed=SEED + 1)
    host = stack_items([ds.get_item(i) for i in range(BWD_BATCH)])
    runs, records = {}, []
    for tag, fn, dtype in (("kernel", dcn.deform_conv2d, torch.float32),
                           ("plain", dcn.deform_conv2d_plain, torch.float32),
                           ("plain64", dcn.deform_conv2d_plain,
                            torch.float64)):
        model = build_model(cfg)
        seeded_weights(model, SEED)
        model = model.to(device, dtype)
        if tag == "kernel":
            records = record_dcn_nodes(model)
        else:
            for m in model.modules():
                if isinstance(m, DeformConvNode):
                    m.dcn_fn = fn

        def cast(v):
            return v.to(dtype) if v.is_floating_point() else v

        batch = {k: ({kk: cast(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else cast(v))
                 for k, v in to_device(host, device).items()}
        metrics = train_step(model, make_optimizer(cfg, model),
                             GenericLoss(cfg), batch, float(cfg.TRAIN.LR))
        runs[tag] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.double() for n, p in model.named_parameters()})
        if tag == "kernel":
            node_worst = 0.0
            for rec in records:
                want = dcn.deform_conv2d_backward_plain(
                    rec["x"], rec["offset"], rec["mask"], rec["weight"],
                    rec["bias"], rec["grad_out"])
                got = (rec["dx"], rec["doffset"], rec["dmask"],
                       rec["node"].weight.grad, rec["node"].bias.grad)
                for name, a, ref in zip(GRAD_NAMES, got, want):
                    rel = rel_err(a, ref)
                    node_worst = max(node_worst, rel)
                    if not (math.isfinite(rel) and rel <= GRAD_RTOL):
                        raise AssertionError(
                            f"in-step DCN backward {name} at "
                            f"{tuple(rec['x'].shape)}: relative {rel:.3e} "
                            f"> {GRAD_RTOL} against the plain backward")
            n_nodes = len(records)
            records = []
        del model, batch
    (m_k, g_k), (m_p, g_p), (m_64, g_64) = (runs[t] for t in
                                            ("kernel", "plain", "plain64"))
    worst = {"loss_kernel": 0.0, "loss_plain": 0.0, "grad_kernel": 0.0,
             "grad_plain": 0.0, "ratio": 0.0}

    def held(what, ek, ep, kind):
        worst[f"{kind}_kernel"] = max(worst[f"{kind}_kernel"], ek)
        worst[f"{kind}_plain"] = max(worst[f"{kind}_plain"], ep)
        worst["ratio"] = max(worst["ratio"], ek / max(ep, 1e-30))
        if not (math.isfinite(ek) and ek <= NOISE_MULT * ep + STEP_RTOL):
            raise AssertionError(
                f"{what}: kernel step {ek:.3e} from the float64 step, plain "
                f"float32 step {ep:.3e}; limit {NOISE_MULT} x plain + "
                f"{STEP_RTOL}")

    for k, want in m_64.items():
        scale = max(abs(want), 1e-30)
        held(f"loss {k}", abs(m_k[k] - want) / scale,
             abs(m_p[k] - want) / scale, "loss")
    for name, want in g_64.items():
        base = name[:-len(".bias")]
        if name.endswith(".bias") and base + ".conv_offset_mask.weight" in g_64:
            continue  # exact gradient 0 (train-mode BatchNorm follows)
        held(f"gradient {name}", rel_err(g_k[name], want),
             rel_err(g_p[name], want), "grad")
    return {"nodes_checked": n_nodes, "node_rel": node_worst,
            "tensors": len(g_64), **worst}


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
        t_build = time.perf_counter()
        built = load_kernel_libraries(dcn.KERNEL_SOURCES)
        log(f"built {len(built)} sources with nvcc in parallel in "
            f"{time.perf_counter() - t_build:.1f} s")
        for source, lib in built.items():
            log(f"{source}: nvcc {lib.build_seconds:.1f} s -> {lib.path.name}")
            for line in lib.ptxas:
                log(f"  ptxas: {line}")
    log(f"phase environment: {time.perf_counter() - t0:.1f} s")

    # 2. the float32 detector at full width, seeded weights, warm-up run
    t0 = time.perf_counter()
    if rehearsal:
        opts = MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(64, 128)"]
        n_cams, frame_hw = 2, (72, 128)
    else:
        opts, n_cams, frame_hw = MAIN_PATH_OPTS, 6, (450, 800)
    cfg = load_config(opts=opts + FP32_OPTS, num_classes=10)
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

    # 3. float32 kernel vs plain at every distinct node shape
    t0 = time.perf_counter()
    rows = check_kernel(shapes, det.device, timed=not rehearsal)
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 4. bf16 kernel vs plain at every distinct node shape
    t0 = time.perf_counter()
    rows16 = check_kernel_bf16(shapes, det.device, not rehearsal, rows)
    log(f"phase bf16-kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 5. the float32 main path through the entry point, counted
    t0 = time.perf_counter()
    expected = 0 if rehearsal else n_nodes * TIMED_RUNS
    counts, detections, times, host = serve_counted(det, frames, n_cams)
    launches = counts["dcn_fwd"]
    if counts != {**{k: 0 for k in counts}, "dcn_fwd": expected}:
        raise AssertionError(f"float32 main path launches {counts}, expected "
                             f"dcn_fwd {expected} and no other")
    log(f"main path (float32): {TIMED_RUNS} runs, dcn_fwd launches "
        f"{launches} (expected {expected}: {n_nodes} nodes x {TIMED_RUNS} "
        f"runs on the card), {detections} detections, all finite")
    log("  stage ms: " + ", ".join(f"{k} {1e3 * v:.2f}"
                                   for k, v in times.items()))
    log("  host stage ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host.items()))
    if not rehearsal:
        log(f"  {n_cams / times['total']:.2f} frames/s "
            f"({1e3 * times['total']:.2f} ms per {n_cams}-camera batch, "
            f"load excluded) on {card}")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")

    # 6. every head, kernel DCN vs plain DCN
    t0 = time.perf_counter()
    worst, same_frustum = check_heads(det, frames)
    log(f"heads kernel vs plain DCN: worst relative "
        f"{max(worst.values()):.3e} (limit {HEADS_RTOL}), frustum top-K "
        f"selection identical: {same_frustum}")
    log("  " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    log(f"phase heads: {time.perf_counter() - t0:.1f} s")

    # 7. bf16 serving as the configs ship it, same weights, counted
    t0 = time.perf_counter()
    cfg16 = load_config(opts=opts + ["MIXED_PRECISION", "True"],
                        num_classes=10)
    det16 = Detector(cfg16, state_dict=det.model.state_dict(),
                     device=args.device)
    if det16.model.compute_dtype != torch.bfloat16:
        raise AssertionError("MIXED_PRECISION True built a "
                             f"{det16.model.compute_dtype} model")
    det16.run(*frames)  # warm-up
    counts16, detections16, times16, host16 = serve_counted(det16, frames,
                                                            n_cams)
    launches16 = counts16["dcn_fwd_bf16"]
    if counts16 != {**{k: 0 for k in counts16}, "dcn_fwd_bf16": expected}:
        raise AssertionError(f"bf16 main path launches {counts16}, expected "
                             f"dcn_fwd_bf16 {expected} and no other")
    log(f"main path (bf16): {TIMED_RUNS} runs, dcn_fwd_bf16 launches "
        f"{launches16} (expected {expected}), dcn_fwd launches "
        f"{counts16['dcn_fwd']}, {detections16} detections, all finite")
    log("  stage ms (bf16 / float32): " + ", ".join(
        f"{k} {1e3 * v:.2f} / {1e3 * times[k]:.2f}"
        for k, v in times16.items()))
    log("  host stage ms (bf16): " + ", ".join(
        f"{k} {v:.3f}" for k, v in host16.items()))
    if not rehearsal:
        log(f"  bf16 {n_cams / times16['total']:.2f} frames/s "
            f"({1e3 * times16['total']:.2f} ms per batch) against float32 "
            f"{n_cams / times['total']:.2f} frames/s "
            f"({1e3 * times['total']:.2f} ms) on {card}")
    log(f"phase bf16 main path: {time.perf_counter() - t0:.1f} s")

    # 8. bf16 heads: kernel vs plain, against the plain's own deviation
    t0 = time.perf_counter()
    worst16, node_rel16, same16 = check_heads_bf16(det, det16, frames)
    if len(node_rel16) != n_nodes:
        raise AssertionError(f"{len(node_rel16)} bf16 DCN calls, {n_nodes} "
                             "nodes")
    log(f"bf16 forward: each of the {n_nodes} DCN nodes within "
        f"{max(node_rel16):.3e} of the plain version on its own inputs "
        f"(limit {BF16_RTOL})")
    log(f"bf16 heads, kernel vs plain DCN: worst relative "
        f"{max(v[0] for v in worst16.values()):.3e} (limit per head "
        f"{BF16_HEAD_MULT} x plain bf16 vs float32 + {HEADS_RTOL}); plain "
        f"bf16 vs float32 forward up to "
        f"{max(v[1] for v in worst16.values()):.3e}, kernel bf16 vs float32 "
        f"up to {max(v[2] for v in worst16.values()):.3e} (seeded weights: "
        f"not bounded); frustum top-K selection identical in all three: "
        f"{same16}")
    log("  per head (kernel vs plain, plain vs fp32, kernel vs fp32): "
        + ", ".join(f"{k} {a:.2e}/{b:.2e}/{c:.2e}"
                    for k, (a, b, c) in worst16.items()))
    log(f"phase bf16 heads: {time.perf_counter() - t0:.1f} s")
    serving_launches = launches
    del det, det16
    if not rehearsal:
        torch.cuda.empty_cache()

    # 9. backward kernels vs plain backward at every distinct node shape
    t0 = time.perf_counter()
    micro = (int(MAIN_PATH_OPTS[MAIN_PATH_OPTS.index("TRAIN.BATCH_SIZE") + 1])
             // int(TRAIN_OPTS[TRAIN_OPTS.index("TRAIN.GRAD_ACCUM") + 1]))
    bwd_rows = check_backward(shapes, args.device, timed=not rehearsal,
                              micro=micro)
    log(f"phase backward-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 10. the Trainer at full width in float32, counted
    t0 = time.perf_counter()
    train = train_main_path(args.device, rehearsal)
    log(f"training: batch {train['batch']} in {train['grad_accum']} "
        f"microbatches, {train['steps']} steps ({train['steps'] // 2} frozen, "
        f"{train['steps'] // 2} unfrozen) after 1 untimed warm-up step; "
        f"launches {train['launches']} (backward kernels expected "
        f"{train['expected_backward_launches']} each); losses "
        + ", ".join(f"{v:.4f}" for v in train["total"]) + ", all finite; "
        f"checkpoints {train['checkpoints']} "
        f"({train['checkpoint_mb']:.1f} MB each) read back equal")
    for phase in ("frozen", "unfrozen"):
        log(f"  {phase}: {train['ms_per_step'][phase]:.1f} ms per step ("
            + ", ".join(f"{v:.1f}" for v in train["ms_steps"][phase])
            + f"), {train['images_per_s'][phase]:.2f} images/s"
            + (" on the host CPU (rehearsal)" if rehearsal else f" on {card}"))
    if not rehearsal:
        fwd = sum(r["micro_ms"]["forward"] * r["nodes"] for r in bwd_rows)
        bwd = sum(r["micro_ms"]["backward"] * r["nodes"] for r in bwd_rows)
        accum = train["grad_accum"]
        train["dcn_share"] = {
            "forward_ms_per_step": fwd * accum,
            "backward_ms_per_step": bwd * accum,
            "frozen_forward": fwd * accum / train["ms_per_step"]["frozen"],
            "unfrozen_forward": fwd * accum
            / train["ms_per_step"]["unfrozen"],
            "unfrozen_backward": bwd * accum
            / train["ms_per_step"]["unfrozen"]}
        log(f"  peak memory {train['peak_mem_gb']:.2f} GB; DCN kernels per "
            f"step (node times at B={micro}, x{accum} microbatches): forward "
            f"{fwd * accum:.1f} ms, backward {bwd * accum:.1f} ms = "
            f"{100 * train['dcn_share']['unfrozen_backward']:.1f}% of an "
            f"unfrozen step")
    log(f"phase training: {time.perf_counter() - t0:.1f} s")

    # 11. one unfrozen step, kernel DCN vs plain DCN
    t0 = time.perf_counter()
    step = step_kernel_vs_plain(args.device, rehearsal)
    log(f"train step B={BWD_BATCH}: in-step backward of {step['nodes_checked']}"
        f" DCN nodes within {step['node_rel']:.2e} of the plain backward on "
        f"their own tensors (limit {GRAD_RTOL}); against the float64 plain "
        f"step, the kernel step's loss parts within {step['loss_kernel']:.2e}"
        f" (plain float32 step {step['loss_plain']:.2e}) and its "
        f"{step['tensors']} gradients within {step['grad_kernel']:.2e} "
        f"(plain float32 {step['grad_plain']:.2e}); worst kernel/plain ratio "
        f"{step['ratio']:.2f} (limit {NOISE_MULT} x plain + {STEP_RTOL})")
    log(f"phase step-vs-plain: {time.perf_counter() - t0:.1f} s")
    log(f"total wall: {time.perf_counter() - t_all:.1f} s")

    if rehearsal:
        print(json.dumps({"ok": True, "rehearsal": "cpu"}), flush=True)
        return 0
    kernel = {
        "name": "dcn_fwd", "route": "cuda",
        "source": "centerfusiondetect3d_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:117",
        "also_replaces": ["centerfusiondetect3d_tpu/ops/pallas_dcn.py:240"],
        "launches": serving_launches,
        "training_launches": train["launches"]["dcn_fwd"],
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
    ptxas16 = built[dcn.BF16_SOURCE].ptxas
    kernels = [kernel, {
        "name": "dcn_fwd_bf16", "route": "cuda",
        "source": "centerfusiondetect3d_tpu_torch/csrc/dcn_fwd_bf16.cu",
        "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:117",
        "also_replaces": ["centerfusiondetect3d_tpu/ops/pallas_dcn.py:240",
                          "scripts/probe_dcn_select.py:48",
                          "scripts/probe_dcn_select.py:83"],
        "launches": launches16,
        "max_abs_err": max(r["max_abs_err"] for r in rows16),
        # per bf16 forward of the main path: the sum over its DCN nodes
        "ms": sum(r["ms"] * r["nodes"] for r in rows16),
        "plain_ms": sum(r["plain_ms"] * r["nodes"] for r in rows16),
        "bound_ms": sum(r["bound_ms"] * r["nodes"] for r in rows16),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in rows16) else "bytes",
        "library_ms": None,
        "fp32_ms": sum(r["fp32_ms"] * r["nodes"] for r in rows16),
        "ptxas": ptxas16,
        "per_node_shape": rows16,
    }]
    for name in BWD_KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "centerfusiondetect3d_tpu_torch/csrc/dcn_bwd.cu",
            "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:409",
            "launches": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"][name] for r in bwd_rows),
            # per backward of the model at B=2: sum over its DCN nodes
            "ms": sum(r["ms"][name] * r["nodes"] for r in bwd_rows),
            "plain_ms": sum(r["plain_ms"][name] * r["nodes"]
                            for r in bwd_rows),
            "bound_ms": sum(r["bound_ms"][name] * r["nodes"]
                            for r in bwd_rows),
            "bound_by": "operations" if all(
                r["bound_by"][name] == "operations" for r in bwd_rows)
            else "bytes",
            "library_ms": None,
            "per_node_shape": [
                {"shape": r["shape"], "nodes": r["nodes"],
                 "ms": r["ms"][name], "plain_ms": r["plain_ms"][name],
                 "bound_ms": r["bound_ms"][name],
                 "max_abs_err": r["max_abs_err"][name]} for r in bwd_rows],
        })
    log(json.dumps({"backward_per_node_shape": bwd_rows}))
    log(json.dumps({"training": train, "step_kernel_vs_plain": step}))
    log(card)  # as nvidia-smi --query-gpu=name,power.limit gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
