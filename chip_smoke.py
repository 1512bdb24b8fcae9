#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --tiny  # CPU rehearsal, no kernel build

On the card it:

1. prints the torch and CUDA versions and the card's name and power limit,
   builds the DCNv2 kernels from ``csrc/`` (``dcn_fwd.cu``, ``dcn_bwd.cu``,
   ``dcn_fwd_bf16.cu``; the forward ones share ``dcn_fwd_common.cuh``) with
   one nvcc each, all in parallel, and prints the
   build time and ptxas' register, shared memory and spill lines (with
   ``dcn_probes.cu``, the probe kernels of phase 15);
2. builds ``Detector`` at the full width of ``configs/Centerfusion_Middle.yaml``
   (DLA-34 with DeformConv nodes, 448x800 input, 6 cameras, K=100, frustum
   middle fusion, device radar paint) in float32 (``MIXED_PRECISION False``)
   with weights from a seed, and runs one warm-up ``Detector.run`` on six
   synthetic 800x450 uint8 frames with radar;
3. holds the float32 kernel against its plain PyTorch version at every
   distinct DCN node shape that run met, at max_offset None, 8 and 1, and
   times both: per call (host work included) and, for the kernel, by its
   device time alone, with the device time of its NHWC copy of x apart;
   at the largest shape also on offsets that collapse every tap onto one
   pixel (``collapsed_offsets``);
4. does the same for the bf16 kernel ``dcn_fwd_bf16`` against its plain
   version (``deform_conv2d_bf16_plain``), with its bound on the bf16
   tensor cores and the float32 kernel's times beside it;
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
   ``dcn_col2im`` (a gather through an inverse sampling map),
   ``dcn_col2im_coord``, on pixel-major columns and a channels-last x,
   around two plain GEMMs) against the plain backward (autograd of the
   plain DCN) at every distinct node shape with B=2, at max_offset None, 8
   and 1, each kernel also against its own plain version, and times the
   backward, its parts, the plain backward and, beside ``dcn_im2col``, its
   library yardstick ``grid_sample`` (``sample_grid``); at the training
   microbatch it times the forward, the backward and ``dcn_col2im``, and
   ``dcn_im2col`` and ``dcn_col2im_coord`` per call and by their device
   time alone beside ``grid_sample``'s, holding each of them and the
   forward kernel against their plain versions on the inputs they are
   timed on (max_offset None, 8 and 1, and at the largest shape collapsed
   offsets: the microbatch gives the kernels other pixel tiles and splits
   than the B=2 checks), reports the map's entries per pixel and bytes,
   and at the largest shape checks and times ``dcn_col2im`` on offsets
   that collapse every tap onto one pixel (at B=2 and at the microbatch);
10. trains with ``runtime/fit.py:Trainer`` at the same full width in float32:
   ``TRAIN.BATCH_SIZE 26`` in 2 microbatches of 13 (``GRAD_ACCUM 2``) on 52
   synthetic items, ``FREEZE_BACKBONE`` with ``DEFREEZE 0`` and 2 epochs:
   2 frozen steps, then 2 unfrozen ones (after one untimed warm-up step
   that is undone); checks that every loss part is finite, that the
   backbone stays bitwise unchanged through the frozen steps, that every
   live parameter gets a gradient, that the gradients are not all zero and
   the step moves the live parameters, that the kernels
   launched once per DCN node per microbatch (the backward ones only in
   unfrozen steps), and that parameters, optimizer state and checkpoint
   tensors are float32; reports ms per step, images/s and peak memory
   (per phase); the Trainer writes its last epoch's reference ``.pt``
   checkpoint into a temporary ``OUTPUT_DIR``, which must read back equal
   to the model;
11. runs one unfrozen train step of B=2 at full width with
   ``MODEL.NORM_EVAL True`` on the same seeded weights (BatchNorm at its
   initial statistics) and batch: with the kernel DCN, the plain DCN, and the
   plain DCN in float64 (also on rounded and jittered inputs); holds each
   DCN node's in-step backward against the plain backward on its own
   tensors, and every loss part and parameter gradient of the kernel step
   against the float64 step, within twice its noise in those draws plus a
   floor;
12. holds the bf16 backward kernels (``dcn_im2col_bf16``,
   ``dcn_col2im_bf16``, ``dcn_col2im_coord_bf16``, the bf16 forms of
   ``csrc/dcn_bwd.cu``) each against its plain version, and the whole bf16
   backward against the plain bf16 backward, at every distinct node shape
   with B=2 and max_offset None, 8 and 1, and times them as phase 9 does;
13. trains as in phase 10 in bf16, as the shipped configs do
   (``MIXED_PRECISION True``): the same checks, with ``dcn_fwd_bf16`` and the
   bf16 backward kernels launched and no float32 DCN kernel, and float32
   master parameters, AdamW state and checkpoints;
14. runs phase 11's comparison in bf16: each DCN node's in-step bf16
   backward against the plain bf16 backward on its own tensors, and the
   kernel step against the float64 step at the noise of the plain bf16 step
   and of the float64 draws at bf16's spacing;
15. drives the DCN probe path (``tools/probe_dcn.py``, the port of the
   TPU rounds' probe scripts) with the probe kernels' launch counts set to
   0: each of the sixteen kernels of ``csrc/dcn_probes.cu`` on the
   scripts' inputs and two seeded draws at the scripts' geometry and a
   second one, held against its plain version (``ops/probes.py``), and K1
   at the probes' shapes through ``dcn_fwd_bf16``; every kernel must have
   launched; then ``k2``, ``k5``, ``kf`` and ``kg`` at a ragged geometry
   (45 pixels a tile, C = 24, O = 6) and ``p4`` at a ragged K and N (24,
   20), each against its plain version, outside those counts. Then each
   kernel and its plain version are timed per call on
   each of its inputs at the scripts' geometry, and each kernel by its
   device time alone, beside the bound of those inputs and the launch
   floor (the device time alone of a kernel that does nothing); where one
   PyTorch call computes the probe's function (``Probe.library``: ``k2``,
   ``p1``, ``p2``, ``p4``), that call is timed the same two ways beside it;
16. prints a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failure raises, so the exit code is not 0 and no result line is printed.
Without a CUDA card and without ``--device cpu --tiny`` it fails. The
rehearsal runs the same path at 64x128 with 2 cameras (and a training batch
of 4 in 2 microbatches) on the CPU, where the DCN ops are the plain versions
(the bf16 phases and the probes included); its last line is
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
import torch.nn.functional as F

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import stack_items, to_device
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn, probes
from centerfusiondetect3d_tpu_torch.ops.cuda_build import load_kernel_libraries
from centerfusiondetect3d_tpu_torch.ops.rasterize import (
    paint_rects_device_batch,
)
from centerfusiondetect3d_tpu_torch.runtime.detector import Detector
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    FP32_OPTS,
    MAIN_PATH_OPTS,
    TRAIN_ITEMS,
    TRAIN_OPTS,
    SyntheticTrainingSet,
    calibrate_batchnorm,
    seeded_weights,
    synthetic_frames,
)
from centerfusiondetect3d_tpu_torch.tools import probe_dcn
from centerfusiondetect3d_tpu_torch.training import make_optimizer, train_step
from centerfusiondetect3d_tpu_torch.training.checkpoint import load_torch_file
from centerfusiondetect3d_tpu_torch.utils.observability import (
    DEVICE_LAUNCHES, time_device)

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
# gradient tensor; sums over C, B*H*W, 9C or a pixel's map entries in
# another order: the forward's limit
GRAD_RTOL = 1e-4
# one NORM_EVAL train step, kernel DCN against the float64 plain step: each
# loss part within NOISE_MULT times its noise plus STEP_RTOL (the heads'
# limit), each parameter gradient in L2 within NOISE_MULT times its noise
# plus GRAD_FLOOR; the noise is the largest deviation of the plain step and
# of N_DRAWS + 1 float64 steps on inputs rounded or jittered at the working
# precision (see step_kernel_vs_plain); tests/test_torch_bf16_training.py
# holds the port's bf16 step to JAX's with the same rule and constants
STEP_RTOL = 1e-3
GRAD_FLOOR = 1e-2
NOISE_MULT = 2
N_DRAWS = 2
BWD_BATCH = 2  # the backward check's batch: the plain autograd must fit
BWD_KERNELS = tuple(dcn.BACKWARD_KERNELS)
BWD_KERNELS_BF16 = tuple(dcn.BACKWARD_KERNELS_BF16)
GRAD_NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")
# the bf16 backward kernels against their plain versions on identical
# inputs: BF16_RTOL for the bf16 outputs (columns, dx), GRAD_RTOL for the
# float32 ones (doffset, dmask); the whole bf16 backward against the plain
# bf16 backward, and in the train step, BF16_RTOL for all five gradients:
# the plain version's GEMMs are float32 products of the bf16 values and
# cuBLAS's bf16 GEMMs round their own sums, so a column gradient, dweight or
# dbias may round to the neighbouring bf16 value
BF16_OUTPUTS = {"dcn_im2col_bf16", "dcn_col2im_bf16"}
COL2IM = ("dcn_col2im", "dcn_col2im_bf16")
# the kernels on the sampling front end, timed at the training microbatch
SAMPLING = ("dcn_im2col", "dcn_col2im_coord", "dcn_im2col_bf16",
            "dcn_col2im_coord_bf16")
IM2COL = ("dcn_im2col", "dcn_im2col_bf16")
# col2im's design traffic beside the function's own bytes: its inverse
# sampling map, an 8-byte entry written by the fill, read and written back
# by the sort and read by the gather, and per pixel a count and a segment
# end, each written once and read once
MAP_ENTRY_BYTES = 32
MAP_PIXEL_BYTES = 16


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


def forward_vs_plain(kernel, plain, what: str, limit: float):
    """(max abs err, relative err) of a forward kernel's call against its
    plain version's on the same inputs; raises past ``limit`` or on a dtype
    that differs."""
    got, want = kernel(), plain()
    if got.dtype != want.dtype:
        raise AssertionError(f"{what}: the kernel returned {got.dtype}, the "
                             f"plain version {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    if not (math.isfinite(err) and rel <= limit):
        raise AssertionError(f"{what} disagrees with the plain version: max "
                             f"abs err {err:.3e}, relative {rel:.3e} > "
                             f"{limit}")
    return err, rel


def micro_forward_vs_plain(inputs, collapsed, shape, bf16: bool):
    """The forward kernel of one dtype against its plain version on
    ``inputs`` (x, offset, mask, weight, bias at the training microbatch)
    with max_offset in (None, 8, 1) and, where ``collapsed`` is given, on
    those offsets (KERNEL_RTOL, BF16_RTOL); returns the worst errors."""
    x, offset, mask, weight, bias = inputs
    kernel = dcn.dcn_fwd_bf16 if bf16 else dcn.deform_conv2d
    plain = dcn.deform_conv2d_bf16_plain if bf16 else dcn.deform_conv2d_plain
    name = "dcn_fwd_bf16" if bf16 else "dcn_fwd"
    cases = [(offset, m, "") for m in (None, 8.0, 1.0)]
    if collapsed is not None:
        cases.append((collapsed, None, ", collapsed offsets"))
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0,
             "collapsed": collapsed is not None}
    for off, max_offset, what in cases:
        err, rel = forward_vs_plain(
            lambda: kernel(x, off, mask, weight, bias, max_offset=max_offset),
            lambda: plain(x, off, mask, weight, bias, max_offset=max_offset),
            f"{name} at {tuple(shape)}, max_offset={max_offset}{what}",
            BF16_RTOL if bf16 else KERNEL_RTOL)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_rel_err"] = max(worst["max_rel_err"], rel)
    return worst


def check_forward(shapes, device, timed: bool, bf16: bool, fp32_rows=None):
    """Phases 3 (float32 ``dcn_fwd`` through ``deform_conv2d``) and 4
    (``dcn_fwd_bf16``, on the phase-3 inputs rounded to bf16, offset and
    mask float32): the kernel against its plain version at each distinct
    node shape and max_offset in (None, 8, 1), and at the largest shape on
    collapsed offsets. On the card also their times: one call per event
    pair (host work included), in turns with the plain version; the
    kernel's device time alone (``time_device``: the NHWC copy of x, the
    kernel and a split's reduction) and its NHWC copy's apart; in bf16 the
    float32 kernel's times from ``fp32_rows`` beside them."""
    name = "dcn_fwd_bf16" if bf16 else "dcn_fwd"
    limit = BF16_RTOL if bf16 else KERNEL_RTOL
    plain = dcn.deform_conv2d_bf16_plain if bf16 else dcn.deform_conv2d_plain
    kernel = dcn.dcn_fwd_bf16 if bf16 else dcn.deform_conv2d
    distinct = sorted(set(shapes), key=shapes.index)
    largest = max(distinct, key=lambda s: s[0] * s[2] * s[3] * (s[1] + s[4]))
    rows = []
    for i, shape in enumerate(distinct):
        x, offset, mask, weight, bias = dcn_inputs(shape, device, SEED + i)
        if bf16:
            x, weight, bias = x.bfloat16(), weight.bfloat16(), bias.bfloat16()
        cases = [(offset, m) for m in (None, 8.0, 1.0)]
        if shape == largest:
            cases.append((collapsed_offsets(shape[0], shape[2], shape[3],
                                            device), None))
        worst = worst_rel = 0.0
        for k, (off, max_offset) in enumerate(cases):
            what = (f"{name} at {shape}, max_offset={max_offset}"
                    + (", collapsed offsets" if k == 3 else ""))
            err, rel = forward_vs_plain(
                lambda: kernel(x, off, mask, weight, bias,
                               max_offset=max_offset),
                lambda: plain(x, off, mask, weight, bias,
                              max_offset=max_offset), what, limit)
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        if bf16:
            flops, nbytes, bound_ms, bound_by = dcn_bound_bf16(shape)
        else:
            flops, nbytes, bound_ms, bound_by, bf16_ms = dcn_bound(shape)
        row = {"shape": list(shape), "nodes": shapes.count(shape),
               "max_abs_err": worst, "max_rel_err": worst_rel,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if not bf16:
            row["bound_bf16_ms"] = bf16_ms
        if timed:
            for key, off in (("", offset), ("collapsed_", cases[-1][0])):
                if key and shape != largest:
                    continue
                call = lambda: kernel(x, off, mask, weight, bias)
                row[key + "ms"], row[key + "plain_ms"] = time_pair(
                    call, lambda: plain(x, off, mask, weight, bias),
                    TIMING_REPS)
                row[key + "device_ms"] = time_device(call)
            row["nhwc_copy_device_ms"] = time_device(
                lambda: dcn.dcn_fwd_nhwc(x))
            if bf16:
                fp32 = next(r for r in fp32_rows if r["shape"] == list(shape))
                row["fp32_ms"] = fp32["ms"]
                row["fp32_device_ms"] = fp32["device_ms"]
        rows.append(row)
        log(f"  {name} {shape} x{row['nodes']}: max abs err {worst:.3e} "
            f"(rel {worst_rel:.2e}, limit {limit}"
            + (", collapsed offsets included" if shape == largest else "")
            + ")" + (f", kernel {row['ms']:.4f} ms a call, device "
                     f"{row['device_ms']:.4f} ms (NHWC copy "
                     f"{row['nhwc_copy_device_ms']:.4f}), plain "
                     f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}" + (", bf16 tensor cores" if bf16 else
                                       f", fp32; {bf16_ms:.4f} at bf16")
                     + ")" if timed else ""))
        if timed and shape == largest:
            log(f"    collapsed offsets: kernel {row['collapsed_ms']:.4f} ms "
                f"a call, device {row['collapsed_device_ms']:.4f} ms, plain "
                f"{row['collapsed_plain_ms']:.4f} ms")
        if timed and bf16:
            log(f"    float32 kernel: {row['fp32_ms']:.4f} ms a call, device "
                f"{row['fp32_device_ms']:.4f} ms")
    return rows


def forward_entry(rows, name: str, bf16: bool, launches: int,
                  training_launches: int, ptxas, micro_rows, micro: int):
    """The ``kernels`` line's entry of forward kernel ``name``: times, plain
    times and bounds per forward of the main path (sums over its DCN node
    launches of the per-shape ``rows`` of phase 3 or 4), and its errors
    against the plain version at the training microbatch ``micro`` (the
    backward ``micro_rows`` of phase 9 or 12)."""
    per_forward = lambda key: sum(r[key] * r["nodes"] for r in rows)
    also = ["centerfusiondetect3d_tpu/ops/pallas_dcn.py:240"]
    if bf16:
        also += ["scripts/probe_dcn_select.py:48",
                 "scripts/probe_dcn_select.py:83",
                 "scripts/probe_dcn_bisect.py:132",
                 "scripts/probe_mosaic.py:150"]
    entry = {
        "name": name, "route": "cuda",
        "source": f"centerfusiondetect3d_tpu_torch/csrc/{name}.cu",
        "front_end": "centerfusiondetect3d_tpu_torch/csrc/dcn_fwd_common.cuh",
        "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:117",
        "also_replaces": also,
        "launches": launches,
        "training_launches": training_launches,
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [r["micro_forward"]["max_abs_err"]
                              for r in micro_rows]),
        "micro_batch": micro,
        "micro_per_node_shape": [{"shape": [micro] + r["shape"][1:],
                                  **r["micro_forward"]} for r in micro_rows],
        # per forward of the main path: the sums over its DCN node launches;
        # ms one call per event pair (host work included), device_ms the
        # device time alone (NHWC copy, kernel, a split's reduction)
        "ms": per_forward("ms"),
        "device_ms": per_forward("device_ms"),
        "nhwc_copy_device_ms": per_forward("nhwc_copy_device_ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in rows) else "bytes",
        "library_ms": None,
        "ptxas": ptxas,
        "per_node_shape": rows,
    }
    if bf16:
        entry["fp32_ms"] = per_forward("fp32_ms")
        entry["fp32_device_ms"] = per_forward("fp32_device_ms")
    return entry


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


def bwd_bounds(shape, bf16: bool = False):
    """Least time on an H100 SXM (3.35 TB/s; fp32 67 TFLOP/s, dense bf16
    tensor cores 989 TFLOP/s) of each part of one node's backward: (flops,
    bytes, bound ms, bound_by) per part and for the whole backward; each
    input read and each output written once. Flops per column element:
    im2col 7 (4 products, 3 sums), col2im 8 (4 products, 4 adds), coord 8
    (its 4 corner products and their sums over C; the sample and its
    derivatives follow per (pixel, tap) from the 4 sums), all fp32;
    GEMMs 2 x 2*B*O*9C*HW, fp32 or bf16. In bf16 x, dx, the columns, the
    column gradients, the weight and g are 2 bytes, offset, mask and their
    gradients 4; the whole backward's ops time sums the fp32 kernels' and
    the bf16 GEMMs' times. The bytes are the function's own: col2im's
    inverse sampling map is the design's traffic, not the function's
    (``map_stats``, reported beside the bound as ``map_mbytes``)."""
    b, c, h, w, o = shape
    hw = h * w
    cols = 9 * b * c * hw
    x, om, g, wt = b * c * hw, 27 * b * hw, b * o * hw, 9 * c * o
    e = 2 if bf16 else 4
    gemm_peak = PEAK_BF16 if bf16 else PEAK_FP32
    parts = {
        "im2col": (7 * cols, 0, e * (x + cols) + 4 * om),
        "col2im": (8 * cols, 0, e * (cols + x) + 4 * om),
        "col2im_coord": (8 * cols, 0, e * (cols + x) + 8 * om),
        "gemms": (0, 4 * b * o * 9 * c * hw, e * (g + cols + wt + wt + cols)),
    }
    parts["backward"] = (sum(p[0] for p in parts.values()),
                         parts["gemms"][1],
                         e * (x + wt + g + x + wt + o) + 8 * om)
    out = {}
    for name, (f32_flops, gemm_flops, nbytes) in parts.items():
        t_ops = f32_flops / PEAK_FP32 + gemm_flops / gemm_peak
        t_bytes = nbytes / PEAK_BYTES
        key = name if name in ("gemms", "backward") else (
            "dcn_" + name + ("_bf16" if bf16 else ""))
        out[key] = (f32_flops + gemm_flops, nbytes,
                    1e3 * max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes")
    return out


def map_stats(offset, mask):
    """Entries of col2im's inverse sampling map on these offsets (the
    kernels' map on the card, the plain one on the CPU): their number, the
    mean and the longest segment (entries per pixel), and the map's bytes
    (MAP_ENTRY_BYTES per entry, MAP_PIXEL_BYTES per pixel)."""
    ends = dcn.dcn_inverse_map(offset, mask)[0]
    seg = torch.diff(ends, prepend=ends.new_zeros(1))
    entries, pixels = int(ends[-1]), ends.numel()
    return {"entries": entries, "mean_segment": entries / pixels,
            "longest_segment": int(seg.max()),
            "map_mbytes": (MAP_ENTRY_BYTES * entries
                           + MAP_PIXEL_BYTES * pixels) / 1e6}


def sample_grid(offset, h: int, w: int, dtype):
    """``grid_sample``'s grid (B, 9*H, W, 2) of the 9*H*W sample positions
    of a node (no clamp): tap k of pixel (y, x) samples (y + k // 3 - 1 +
    dy_k, x + k % 3 - 1 + dx_k), at row k*H + y, normalized for
    ``align_corners=True`` (-1 and 1 are the centres of the first and last
    pixels), in ``dtype``."""
    b = offset.shape[0]
    tap = torch.arange(9, device=offset.device)
    ys = (torch.arange(h, device=offset.device)[None, :, None]
          + (tap // 3 - 1)[:, None, None])
    xs = (torch.arange(w, device=offset.device)[None, None, :]
          + (tap % 3 - 1)[:, None, None])
    py = ys + offset[:, 0::2]
    px = xs + offset[:, 1::2]
    grid = torch.stack([2 * px / max(w - 1, 1) - 1,
                        2 * py / max(h - 1, 1) - 1], -1)
    return grid.reshape(b, 9 * h, w, 2).to(dtype)


def grid_sample_call(x, offset):
    """One PyTorch call that samples what ``dcn_im2col`` samples: bilinear
    ``F.grid_sample`` with zero padding at the 9*H*W positions of
    ``sample_grid``. The yardstick of im2col (``library_ms``), never called
    by the port: it takes an NCHW x and returns (B, C, 9*H, W), and it
    omits the mask."""
    xn = x.contiguous()
    grid = sample_grid(offset, x.shape[2], x.shape[3], x.dtype)
    return lambda: F.grid_sample(xn, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def micro_sampling(kernels, plains, inputs, collapsed, shape, bf16: bool):
    """``dcn_im2col`` and ``dcn_col2im_coord`` of one dtype at the training
    microbatch on ``inputs`` (the channels-last x the backward reads,
    offset, mask, the GEMM's column gradients): each against its plain
    version with max_offset in (None, 8, 1) and, where ``collapsed`` is
    given, on those offsets (im2col's columns within BF16_RTOL in bf16, else
    GRAD_RTOL); then each timed per call (medians of TIMING_REPS) and by its
    device time alone (``time_device``), with im2col's yardstick
    ``grid_sample`` beside it. Returns name -> numbers."""
    (n_im2col, im2col), (n_coord, coord) = kernels
    p_im2col, p_coord = plains
    xh, off, mask, dcols = inputs
    cases = [(off, m, "") for m in (None, 8.0, 1.0)]
    if collapsed is not None:
        cases.append((collapsed, None, ", collapsed offsets"))
    calls = {
        n_im2col: (lambda o, m: im2col(xh, o, mask, m),
                   lambda o, m: p_im2col(xh, o, mask, m),
                   BF16_RTOL if bf16 else GRAD_RTOL),
        n_coord: (lambda o, m: coord(dcols, xh, o, mask, m),
                  lambda o, m: p_coord(dcols, xh, o, mask, m), GRAD_RTOL)}
    out = {}
    for name, (kernel, plain, limit) in calls.items():
        worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
        for o, m, what in cases:
            got, want = kernel(o, m), plain(o, m)
            pairs = zip(got, want) if name == n_coord else [(got, want)]
            for a, ref in pairs:
                rel = rel_err(a.float(), ref.float())
                if a.dtype != ref.dtype or not (math.isfinite(rel)
                                                and rel <= limit):
                    raise AssertionError(
                        f"{name} ({a.dtype}) disagrees with its plain "
                        f"version ({ref.dtype}) at {tuple(shape)}, "
                        f"max_offset={m}{what}: relative {rel:.3e} > "
                        f"{limit}")
                worst["max_rel_err"] = max(worst["max_rel_err"], rel)
                worst["max_abs_err"] = max(worst["max_abs_err"], float(
                    (a.float() - ref.float()).abs().max()))
            del got, want
        call = lambda: kernel(off, None)
        out[name] = {**worst, "collapsed": collapsed is not None,
                     "ms": time_one(call, TIMING_REPS),
                     "device_ms": time_device(call)}
    library = grid_sample_call(xh, off)
    out[n_im2col]["library_ms"] = time_one(library, TIMING_REPS)
    out[n_im2col]["library_device_ms"] = time_device(library)
    return out


def collapsed_offsets(b, h, w, device):
    """Offsets that send every tap of every pixel of an image to one point:
    the pixel (h // 2, w // 2) in even images (one corner each: segments of
    9*H*W entries), half a pixel below and right of it in odd ones (four
    such segments)."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    off = torch.empty((b, 18, h, w), device=device)
    for img in range(b):
        shift = 0.5 * (img % 2)
        for k in range(9):
            i, j = divmod(k, 3)
            off[img, 2 * k] = h // 2 + shift - (ys + i - 1)
            off[img, 2 * k + 1] = w // 2 + shift - (xs + j - 1)
    return off


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def col2im_vs_plain(pair, shape, offsets: str, bf16: bool) -> float:
    """Relative error of a col2im call against its plain version on the same
    inputs (``pair`` = (kernel call, plain call)); raises past GRAD_RTOL
    (float32) or BF16_RTOL (bf16)."""
    kernel, plain = pair
    got, want = kernel(), plain()
    rel = rel_err(got.float(), want.float())
    limit = BF16_RTOL if bf16 else GRAD_RTOL
    if got.dtype != want.dtype or not (math.isfinite(rel) and rel <= limit):
        raise AssertionError(
            f"col2im ({got.dtype}) disagrees with its plain version "
            f"({want.dtype}) at {tuple(shape)} on {offsets} offsets: "
            f"relative {rel:.3e} > {limit}")
    return rel


def check_backward(shapes, device, timed: bool, micro: int, bf16: bool):
    """Phases 9 (float32) and 12 (bf16): the backward kernels of one dtype
    (``dcn.BACKWARD_KERNELS`` or ``dcn.BACKWARD_KERNELS_BF16``) at each
    distinct node shape with B=2 and max_offset in (None, 8, 1): the whole
    backward against the plain backward of its dtype (the five gradients,
    each in its input's dtype) and each kernel against its own plain version
    on the same inputs, the column gradients those of the GEMM
    (``dcn.column_gradients``). In bf16, x, weight, bias and the output
    gradient are the same draws rounded to bf16. Each shape reports col2im's
    map on its offsets (``map_stats``); at the largest shape col2im is also
    held against its plain version on offsets that collapse every tap onto
    one pixel. On the card also the CUDA-event medians of the backward, its
    parts and the plain versions, and at the training microbatch ``micro``
    of the forward, the backward and col2im (the collapsed case too), with
    col2im's bound and map there; col2im and the forward kernel are held
    against their plain versions on the inputs they are timed on (the
    forward with max_offset in (None, 8, 1) and at the largest shape on
    collapsed offsets: ``micro_forward_vs_plain``)."""
    if bf16:
        kernels = dcn.BACKWARD_KERNELS_BF16
        plains = (dcn.dcn_im2col_bf16_plain, dcn.dcn_col2im_bf16_plain,
                  dcn.dcn_col2im_coord_bf16_plain)
        backward_plain, whole_rtol = (dcn.deform_conv2d_bf16_backward_plain,
                                      BF16_RTOL)
    else:
        kernels = dcn.BACKWARD_KERNELS
        plains = (dcn.dcn_im2col_plain, dcn.dcn_col2im_plain,
                  dcn.dcn_col2im_coord_plain)
        backward_plain, whole_rtol = dcn.deform_conv2d_backward_plain, GRAD_RTOL
    (n_im2col, im2col), (n_col2im, col2im), (n_coord, coord) = kernels.items()
    p_im2col, p_col2im, p_coord = plains

    def cast(*tensors):
        return tuple(t.bfloat16() for t in tensors) if bf16 else tensors

    def calls(x, off, mask, dcols, max_offset=None):
        """name -> (kernel call, plain call) on the same inputs; the
        kernels read x channels-last, as the backward passes it."""
        xh = dcn.dcn_fwd_nhwc(x)
        return {
            n_im2col: (lambda: im2col(xh, off, mask, max_offset),
                       lambda: p_im2col(x, off, mask, max_offset)),
            n_col2im: (lambda: col2im(dcols, off, mask, max_offset),
                       lambda: p_col2im(dcols, x, off, mask, max_offset)),
            n_coord: (lambda: coord(dcols, xh, off, mask, max_offset),
                      lambda: p_coord(dcols, x, off, mask, max_offset)),
        }

    rows = []
    largest = max(shapes, key=lambda s: s[1] * s[2] * s[3])
    for i, full in enumerate(sorted(set(shapes), key=shapes.index)):
        shape = (BWD_BATCH,) + tuple(full[1:])
        b, c, h, w, o = shape
        x, off, mask, wt, bias = dcn_inputs(shape, device, SEED + 100 + i)
        gen = torch.Generator(device=device).manual_seed(SEED + 200 + i)
        g = torch.randn((b, o, h, w), generator=gen, device=device)
        x, wt, bias, g = cast(x, wt, bias, g)
        errs = {k: 0.0 for k in kernels}
        worst = 0.0
        for max_offset in (None, 8.0, 1.0):
            got = dcn.deform_conv2d_backward(x, off, mask, wt, g, max_offset)
            want = backward_plain(x, off, mask, wt, bias, g, max_offset)
            for name, a, ref in zip(GRAD_NAMES, got, want):
                rel = rel_err(a.float(), ref.float())
                worst = max(worst, rel)
                if a.dtype != ref.dtype or not (math.isfinite(rel)
                                                and rel <= whole_rtol):
                    raise AssertionError(
                        f"DCN backward {name} ({a.dtype}) disagrees with the "
                        f"plain backward ({ref.dtype}) at {shape}, "
                        f"max_offset={max_offset}: relative {rel:.3e} > "
                        f"{whole_rtol}")
            dcols = dcn.column_gradients(wt, g)
            for name, (kernel, plain) in calls(x, off, mask, dcols,
                                               max_offset).items():
                limit = BF16_RTOL if name in BF16_OUTPUTS else GRAD_RTOL
                outs, refs = kernel(), plain()
                if name == n_coord:
                    pairs = list(zip(outs, refs))
                else:
                    pairs = [(outs, refs)]
                for a, ref in pairs:
                    rel = rel_err(a.float(), ref.float())
                    if a.dtype != ref.dtype or not (math.isfinite(rel)
                                                    and rel <= limit):
                        raise AssertionError(
                            f"{name} ({a.dtype}) disagrees with its plain "
                            f"version ({ref.dtype}) at {shape}, max_offset="
                            f"{max_offset}: relative {rel:.3e} > {limit}")
                    errs[name] = max(errs[name], float(
                        (a.float() - ref.float()).abs().max()))
        bounds = bwd_bounds(shape, bf16)
        stats = map_stats(off, mask)
        row = {"shape": list(shape), "nodes": shapes.count(full),
               "max_rel_err": worst, "max_abs_err": errs,
               "map_mbytes": stats["map_mbytes"], "map": stats,
               "bound_ms": {k: v[2] for k, v in bounds.items()},
               "bound_by": {k: v[3] for k, v in bounds.items()},
               "gflop": {k: v[0] / 1e9 for k, v in bounds.items()},
               "mbytes": {k: v[1] / 1e6 for k, v in bounds.items()}}
        if full == largest:
            # every tap onto one pixel: segments of 9*H*W entries (the long
            # sort of csrc/dcn_bwd.cu)
            coff = collapsed_offsets(b, h, w, device)
            rel = col2im_vs_plain(calls(x, coff, mask, dcols)[n_col2im],
                                  shape, "collapsed", bf16)
            row["collapsed"] = {"max_rel_err": rel, **map_stats(coff, mask)}
        if timed:
            dcols = dcn.column_gradients(wt, g)
            cols = im2col(x, off, mask)
            ms, plain = {}, {}
            ms["backward"], plain["backward"] = time_pair(
                lambda: dcn.deform_conv2d_backward(x, off, mask, wt, g),
                lambda: backward_plain(x, off, mask, wt, bias, g),
                TIMING_REPS)
            for name, (kernel, plain_fn) in calls(x, off, mask,
                                                  dcols).items():
                ms[name], plain[name] = time_pair(kernel, plain_fn,
                                                  TIMING_REPS)
            ms["gemms"] = time_one(lambda: (
                dcn.weight_gradient(g, cols), dcn.column_gradients(wt, g)),
                TIMING_REPS)
            row["ms"], row["plain_ms"] = ms, plain
            row["library_ms"] = time_one(grid_sample_call(x, off),
                                         TIMING_REPS)
            # kernel times at the training microbatch, for the step shares
            mshape = (micro,) + tuple(full[1:])
            mx, moff, mmask, mwt, mbias = dcn_inputs(mshape, device, SEED)
            mg = torch.randn((micro, o, h, w), generator=gen, device=device)
            mx, mwt, mbias, mg = cast(mx, mwt, mbias, mg)
            # the forward kernel at the microbatch against its plain
            # version: B sets its pixel tiles and splits (dcn_fwd_plan), so
            # training's calls take other layouts than phases 3 and 4 check
            mcoff = (collapsed_offsets(micro, h, w, device)
                     if full == largest else None)
            row["micro_forward"] = micro_forward_vs_plain(
                (mx, moff, mmask, mwt, mbias), mcoff, mshape, bf16)
            row["micro_ms"] = {
                "forward": time_one(lambda: dcn.deform_conv2d(
                    mx, moff, mmask, mwt, mbias), 5),
                "backward": time_one(lambda: dcn.deform_conv2d_backward(
                    mx, moff, mmask, mwt, mg), 5)}
            mdcols = dcn.column_gradients(mwt, mg)
            row["micro_max_rel_err"] = col2im_vs_plain(
                calls(mx, moff, mmask, mdcols)[n_col2im], mshape, "seeded",
                bf16)
            row["micro_ms"][n_col2im] = time_one(
                lambda: col2im(mdcols, moff, mmask), TIMING_REPS)
            mbounds = bwd_bounds(mshape, bf16)
            row["micro_bound_ms"] = mbounds[n_col2im][2]
            row["micro_map"] = map_stats(moff, mmask)
            row["micro_sampling"] = micro_sampling(
                ((n_im2col, im2col), (n_coord, coord)), (p_im2col, p_coord),
                (dcn.dcn_fwd_nhwc(mx), moff, mmask, mdcols), mcoff, mshape,
                bf16)
            for name in (n_im2col, n_coord):
                row["micro_sampling"][name]["bound_ms"] = mbounds[name][2]
            if full == largest:
                row["collapsed"]["micro_max_rel_err"] = col2im_vs_plain(
                    calls(mx, mcoff, mmask, mdcols)[n_col2im], mshape,
                    "collapsed", bf16)
                row["collapsed"]["micro_ms"] = time_one(
                    lambda: col2im(mdcols, mcoff, mmask), 3)
                row["collapsed"]["micro_map"] = map_stats(mcoff, mmask)
            del mdcols
        rows.append(row)
        log(f"  dcn {'bf16 ' if bf16 else ''}backward {shape} x{row['nodes']}"
            f": max rel err {worst:.2e} (limit {whole_rtol}), per kernel abs "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + ("" if not timed else
               "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
               + "; plain ms " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in plain.items())
               + f"; bound {bounds['backward'][2]:.4f} ms "
               f"({bounds['backward'][3]}); at B={micro}: forward "
               f"{row['micro_ms']['forward']:.3f} ms, backward "
               f"{row['micro_ms']['backward']:.3f} ms, {n_col2im} "
               f"{row['micro_ms'][n_col2im]:.4f} ms (rel err "
               f"{row['micro_max_rel_err']:.2e}), forward kernel vs plain "
               f"rel err {row['micro_forward']['max_rel_err']:.2e} (limit "
               f"{BF16_RTOL if bf16 else KERNEL_RTOL})"
               + f", bound {row['micro_bound_ms']:.4f} ms, map "
               f"{row['micro_map']['map_mbytes']:.1f} MB"))
        if timed:
            for name, v in row["micro_sampling"].items():
                log(f"    {name} at B={micro}: {v['ms']:.4f} ms a call, "
                    f"device {v['device_ms']:.4f} ms, bound "
                    f"{v['bound_ms']:.4f} ms"
                    + (f", grid_sample {v['library_ms']:.4f} ms a call, "
                       f"device {v['library_device_ms']:.4f} ms"
                       if "library_ms" in v else "")
                    + f"; rel err {v['max_rel_err']:.2e} against plain")
        log(f"    {n_col2im} map at B={b}: {stats['mean_segment']:.2f} "
            f"entries per pixel, longest segment {stats['longest_segment']}, "
            f"{stats['map_mbytes']:.2f} MB beside the function's "
            f"{bounds[n_col2im][1] / 1e6:.2f} MB"
            + ("" if "collapsed" not in row else
               f"; collapsed offsets: rel err "
               f"{row['collapsed']['max_rel_err']:.2e}, longest segment "
               f"{row['collapsed']['longest_segment']}"
               + ("" if not timed else
                  f", {row['collapsed']['micro_ms']:.3f} ms at B={micro} "
                  f"(rel err {row['collapsed']['micro_max_rel_err']:.2e})")))
    return rows


def launch_counts():
    return {"dcn_fwd": dcn.deform_conv2d.launches,
            "dcn_fwd_bf16": dcn.dcn_fwd_bf16.launches,
            **{k: f.launches for k, f in dcn.BACKWARD_KERNELS.items()},
            **{k: f.launches for k, f in dcn.BACKWARD_KERNELS_BF16.items()}}


def reset_launch_counts():
    dcn.deform_conv2d.launches = 0
    dcn.dcn_fwd_bf16.launches = 0
    for f in (*dcn.BACKWARD_KERNELS.values(),
              *dcn.BACKWARD_KERNELS_BF16.values()):
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


def train_main_path(device, rehearsal: bool, bf16: bool):
    """Phases 10 (float32) and 13 (bf16, as the configs ship it): the
    Trainer at full width, counted, writing its checkpoints into a
    temporary OUTPUT_DIR; returns its report."""
    opts = MAIN_PATH_OPTS + TRAIN_OPTS + ([] if bf16 else FP32_OPTS)
    n_items = TRAIN_ITEMS
    if rehearsal:
        opts = opts + ["MODEL.INPUT_SIZE", "(64, 128)", "TRAIN.BATCH_SIZE",
                       "4"]
        n_items = 8
    with tempfile.TemporaryDirectory(prefix="cfd_smoke_") as out_dir:
        cfg = load_config(opts=opts + ["OUTPUT_DIR", repr(out_dir)],
                          num_classes=10)
        return _train_main_path(cfg, n_items, device, rehearsal, bf16)


def gradients(model):
    """Per parameter after a step: None when the step gave it no gradient,
    else whether its gradient is non-zero somewhere."""
    return {n: None if p.grad is None else bool(p.grad.ne(0).any())
            for n, p in model.named_parameters()}


def float_dtypes(tensors) -> set:
    """The dtypes of the floating tensors in a (nested) state dict."""
    if isinstance(tensors, dict):
        return set().union(*(float_dtypes(v) for v in tensors.values()))
    if isinstance(tensors, (list, tuple)):
        return set().union(*(float_dtypes(v) for v in tensors))
    if torch.is_tensor(tensors) and tensors.is_floating_point():
        return {tensors.dtype}
    return set()


def _train_main_path(cfg, n_items, device, rehearsal: bool, bf16: bool):
    accum = int(cfg.TRAIN.GRAD_ACCUM)
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    t0 = time.perf_counter()
    ds = SyntheticTrainingSet(cfg, n_items, seed=SEED)
    trainer = Trainer(cfg, ds, device=device)
    trainer.init_state(seed=SEED)
    model = trainer.model
    want_dtype = torch.bfloat16 if bf16 else None
    if model.compute_dtype != want_dtype:
        raise AssertionError(f"MIXED_PRECISION {bool(cfg.MIXED_PRECISION)} "
                             f"built a {model.compute_dtype} model")
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

    snaps, counts, parts, grads = [snapshot()], [], [], []
    peaks = {}  # phase -> the largest peak of its steps (bytes)
    def on_step(epoch, step, frozen, metrics):
        if not rehearsal:
            phase = "frozen" if frozen else "unfrozen"
            peaks[phase] = max(peaks.get(phase, 0),
                               torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        counts.append(launch_counts())
        snaps.append(snapshot())
        parts.append(metrics)
        grads.append(gradients(model))

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
        changed = [n for n in cur if n in backbone_names and frozen
                   and not torch.equal(prev[n], cur[n])]
        if changed:
            raise AssertionError(f"frozen step {k} changed {changed}")
        live = [n for n in cur if n not in backbone_names or not frozen]
        no_grad = [n for n in live if grads[k][n] is None]
        if no_grad:
            raise AssertionError(f"{phase} step {k} gave no gradient to "
                                 f"{no_grad}")
        # in aggregate: non-zero gradients, and the step moved the live
        # parameters
        if not any(grads[k][n] for n in live):
            raise AssertionError(f"{phase} step {k}: every gradient is 0")
        if all(torch.equal(prev[n], cur[n]) for n in live):
            raise AssertionError(f"{phase} step {k} changed no parameter")
    # launches per step: the forward of the model's dtype once per node per
    # microbatch; its backward kernels the same, in unfrozen steps only; no
    # kernel of the other dtype; none on the CPU
    per_node = 0 if rehearsal else n_nodes * accum
    fwd_kernel = "dcn_fwd_bf16" if bf16 else "dcn_fwd"
    bwd_kernels = BWD_KERNELS_BF16 if bf16 else BWD_KERNELS
    prev = {k: 0 for k in counts[0]}
    for k, (frozen, cur) in enumerate(zip(phases, counts)):
        delta = {n: cur[n] - prev[n] for n in cur}
        want = {n: (per_node if n == fwd_kernel
                    or (n in bwd_kernels and not frozen) else 0)
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
    # float32 master parameters, AdamW state and checkpoint tensors, in
    # either precision
    dtypes = {"parameters": float_dtypes(dict(model.named_parameters())),
              "optimizer state": float_dtypes(
                  trainer.optimizer.state_dict()["state"]),
              "checkpoint weights": float_dtypes(ckpt["state_dict"]),
              "checkpoint optimizer": float_dtypes(ckpt["optimizer"])}
    for what, found in dtypes.items():
        if found != {torch.float32}:
            raise AssertionError(f"{what} in {sorted(map(str, found))}, "
                                 "want float32")
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
        "precision": "bf16" if bf16 else "float32",
    }
    if not rehearsal:
        report["peak_mem_gb_by_phase"] = {k: v / 1e9
                                          for k, v in peaks.items()}
        report["peak_mem_gb"] = max(report["peak_mem_gb_by_phase"].values())
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


def step_kernel_vs_plain(device, rehearsal: bool, bf16: bool):
    """Phases 11 (float32) and 14 (bf16): one unfrozen B=2 step with
    ``MODEL.NORM_EVAL True`` on the same seeded weights (BatchNorm at its
    initial statistics) and batch, with the kernel DCN, the plain DCN
    (autograd of ``deform_conv2d_plain``, or of ``deform_conv2d_bf16_plain``
    in a bf16 model), and in float64 with the plain DCN. Inside the kernel step, each
    DCN node's backward is held against the plain backward of its dtype on
    the very tensors it saw (GRAD_RTOL; bf16: ``deform_conv2d_bf16_backward_
    plain``, BF16_RTOL).

    The whole step's loss parts and parameter gradients are held against
    the float64 step: a deviation is relative, to the float64 value for a
    scalar and in the L2 norm for a gradient tensor; each quantity of the
    kernel step lies within NOISE_MULT times its noise plus STEP_RTOL (a
    scalar) or GRAD_FLOOR (a tensor). The noise of a quantity is the largest
    deviation of several draws of the same computation: the plain step, the
    float64 step on the image rounded to the working dtype, and N_DRAWS
    float64 steps with every parameter and the image scaled elementwise by
    1 + u, |u| up to half the working dtype's spacing. With train-mode
    BatchNorm (the main path's) this seeded full-width step is chaotic
    (batch statistics of nearly constant channels): rounding the image to
    bf16 moved the float64 step's gradient norm from 7.07e7 to 7.30e9, and
    no limit there tells a correct backward from a zeroed one. With
    NORM_EVAL, in float32, the limit of every gradient tensor stays below 1
    (asserted), so a gradient that is zeroed, doubled or of the wrong sign
    fails. In bf16 it does not: on these seeded weights the bf16 roundings
    alone move many gradients O(1), in the plain step as in the draws (the
    report's "largest gradient limit"), so the bf16 whole-step limit is
    kept but cannot see such a fault. The sharp bf16 checks are the
    per-node ones here, and the CPU tests of
    ``tests/test_torch_bf16_training.py``, which hold the bf16 step to
    JAX's on weights where it is smooth."""
    opts = MAIN_PATH_OPTS + ([] if bf16 else FP32_OPTS) + [
        "MODEL.NORM_EVAL", "True"] + (
        ["MODEL.INPUT_SIZE", "(64, 128)"] if rehearsal else [])
    cfg = load_config(opts=opts, num_classes=10)
    ds = SyntheticTrainingSet(cfg, BWD_BATCH, seed=SEED + 1)
    host = stack_items([ds.get_item(i) for i in range(BWD_BATCH)])
    work = torch.bfloat16 if bf16 else torch.float32
    plain_fn = dcn.deform_conv2d_bf16_plain if bf16 else dcn.deform_conv2d_plain
    plain_bwd = (dcn.deform_conv2d_bf16_backward_plain if bf16
                 else dcn.deform_conv2d_backward_plain)
    node_rtol = BF16_RTOL if bf16 else GRAD_RTOL

    def on_device(dtype):
        def cast(v):
            return v.to(dtype) if v.is_floating_point() else v
        return {k: ({kk: cast(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else cast(v))
                for k, v in to_device(host, device).items()}

    seeded = build_model(cfg, torch.float64)
    seeded_weights(seeded, SEED)
    state = seeded.state_dict()
    spacing = torch.finfo(work).eps  # relative; half of it rounds

    def jittered(t, gen):
        u = torch.rand(t.shape, generator=gen, dtype=torch.float64)
        return (t.double() * (1 + (u.to(t.device) - 0.5) * spacing)).to(
            t.dtype)

    runs, records, node_worst, n_nodes = {}, [], 0.0, 0
    # (tag, DCN op, model dtype, jitter seed): a bf16 model takes a float32
    # batch and casts it itself; "rounded64" rounds the image to ``work``
    variants = ([("kernel", dcn.deform_conv2d, work, None),
                 ("plain", plain_fn, work, None),
                 ("plain64", dcn.deform_conv2d_plain, torch.float64, None),
                 ("rounded64", dcn.deform_conv2d_plain, torch.float64, None)]
                + [(f"jitter64_{i}", dcn.deform_conv2d_plain, torch.float64,
                    i) for i in range(N_DRAWS)])
    for tag, fn, dtype, seed in variants:
        model = build_model(cfg, dtype)
        batch = on_device(torch.float32 if dtype == work else dtype)
        sd = state
        if tag == "rounded64":
            batch["image"] = batch["image"].to(work).double()
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            sd = {k: jittered(v, gen) if v.is_floating_point()
                  and "running" not in k else v for k, v in state.items()}
            batch["image"] = jittered(batch["image"], gen)
        model.load_state_dict(sd, strict=True)
        model = model.to(device)
        if tag == "kernel":
            records = record_dcn_nodes(model)
        else:
            for m in model.modules():
                if isinstance(m, DeformConvNode):
                    m.dcn_fn = fn
        metrics = train_step(model, make_optimizer(cfg, model),
                             GenericLoss(cfg), batch, float(cfg.TRAIN.LR))
        runs[tag] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.double() for n, p in model.named_parameters()})
        for rec in records:
            want = plain_bwd(rec["x"], rec["offset"], rec["mask"],
                             rec["weight"], rec["bias"], rec["grad_out"])
            got = (rec["dx"], rec["doffset"], rec["dmask"],
                   rec["node"].weight.grad, rec["node"].bias.grad)
            for name, a, ref in zip(GRAD_NAMES, got, want):
                rel = rel_err(a.float(), ref.float())
                node_worst = max(node_worst, rel)
                if not (math.isfinite(rel) and rel <= node_rtol):
                    raise AssertionError(
                        f"in-step DCN backward {name} at "
                        f"{tuple(rec['x'].shape)}: relative {rel:.3e} "
                        f"> {node_rtol} against the plain backward")
        n_nodes += len(records)
        records = []
        del model, batch
    (m_k, g_k), (m_64, g_64) = runs.pop("kernel"), runs.pop("plain64")
    draws = list(runs.values())

    def l2(got, want):
        return float((got - want).norm()) / max(float(want.norm()), 1e-30)

    kinds = {
        "loss": [(f"loss {k}", abs(m_k[k] - want) / max(abs(want), 1e-30),
                  max(abs(m[k] - want) for m, _ in draws)
                  / max(abs(want), 1e-30)) for k, want in m_64.items()],
        "grad": [(f"gradient {n}", l2(g_k[n], want),
                  max(l2(g[n], want) for _, g in draws))
                 for n, want in g_64.items()]}
    out = {"nodes_checked": n_nodes, "node_rel": node_worst,
           "node_rtol": node_rtol, "tensors": len(g_64),
           "plain_dev": {"loss": max(abs(m_p - m_64[k]) / max(abs(m_64[k]),
                                                                1e-30)
                                     for k, m_p in draws[0][0].items()),
                         "grad": max(l2(draws[0][1][n], w)
                                     for n, w in g_64.items())}}
    for kind, rows in kinds.items():
        floor = STEP_RTOL if kind == "loss" else GRAD_FLOOR
        limits = [NOISE_MULT * noise + floor for _, _, noise in rows]
        for (what, dev, noise), limit in zip(rows, limits):
            if not (math.isfinite(dev) and dev <= limit):
                raise AssertionError(
                    f"{what}: kernel step {dev:.3e} from the float64 step, "
                    f"noise {noise:.3e}; limit {NOISE_MULT} x noise + "
                    f"{floor}")
        if kind == "grad" and not bf16 and not max(limits) < 1.0:
            raise AssertionError(
                f"the step is too noisy to see a zeroed gradient: limit "
                f"{max(limits):.3e} for {rows[limits.index(max(limits))][0]}")
        ratio, worst = max((dev / lim, what) for (what, dev, _), lim
                           in zip(rows, limits))
        out[kind] = {"kernel": max(d for _, d, _ in rows),
                     "noise": max(n for _, _, n in rows),
                     "median": (statistics.median(d for _, d, _ in rows),
                                statistics.median(n for _, _, n in rows)),
                     "worst_of_limit": ratio, "worst": worst,
                     "largest_limit": max(limits)}
    return out


def x_footprint(geom, off, *, row_block=True, x_loop=True,
                y_cut=probes.OPEN, x_cut=probes.OPEN) -> int:
    """Elements of x's (B, HP, WP) plane that a tile probe reads on these
    offsets: the union over its tiles of the rows [rb*BR] + gy + pad + r
    and columns gx + pad + c for gy, gx in the tile's (cut) box."""
    g = geom
    seen = torch.zeros((g.batch, g.hp, g.wp), dtype=torch.bool)
    for b, rb, _, (ylo, yhi, xlo, xhi) in probes.tiles(g, off):
        y0, y1 = max(ylo, y_cut[0]), min(yhi, y_cut[1])
        x0, x1 = (max(xlo, x_cut[0]), min(xhi, x_cut[1])) if x_loop \
            else (0, 0)
        if y1 < y0 or x1 < x0:
            continue
        base = (rb * g.br if row_block else 0) + g.pad
        seen[b, base + y0:base + y1 + g.br, g.pad + x0:g.pad + x1 + g.w] = 1
    return int(seen.sum())


def probe_work(name: str, args, geom):
    """(fp32 operations, bf16 tensor-core operations, bytes) that probe
    ``name`` needs on ``args``: each input element it reads counted once
    (only the offset, mask and tap channels and the x windows it reads),
    each output element written once; the loops' trip counts are this
    run's tile bounds. Per hat-weighted term: 4 operations for a hat, 1 for
    wy * wx, then a multiply and an add per channel."""
    if name == "p1":
        x, _ = args
        return 0, 0, 2 * 4 * probes.P5_ROWS * probes.P5_COLS * x.shape[2]
    if name == "p2":
        x, lo, hi = args
        rows = (hi - 1 + probes.P5_ROWS - lo) if hi > lo else 0
        return ((hi - lo) * probes.P5_ROWS * x.shape[1], 0,
                4 * (rows + probes.P5_ROWS) * x.shape[1])
    if name == "p3":
        (x,) = args
        return 3 * x.numel(), 0, 8 * x.numel()
    if name == "p4":
        x, w = args
        k, n = w.shape
        m = probes.P5_ROWS * probes.P5_COLS
        return m * k, 2 * m * k * n, 2 * (m * k + k * n) + 4 * m * n
    g = geom
    pixels = g.batch * g.h * g.w
    out_c = g.c if name in ("kf", "kg") else g.o
    nbytes = 4 * pixels * out_c
    if name == "k1":
        return pixels * g.c, 0, nbytes + 2 * pixels * g.c
    off = args[probes.PROBES[name].kernel.inputs.index("off")].cpu()
    field = 4 * pixels  # one offset channel
    if name == "k2":
        return 0, 0, nbytes + field
    ylo, yhi, xlo, xhi = probes.tile_bounds(off, g)
    y_cut = probes.KE_ROWS if name == "ke" else probes.OPEN
    x_cut = probes.KF_COLS if name == "kf" else probes.OPEN
    ny = (yhi.clamp(max=y_cut[1]) - ylo.clamp(min=y_cut[0]) + 1).clamp(min=0)
    nx = (xhi.clamp(max=x_cut[1]) - xlo.clamp(min=x_cut[0]) + 1).clamp(min=0)
    tile_px = g.br * g.w
    rows_terms = int(ny.sum()) * tile_px  # (gy, pixel) pairs
    terms = int((ny * nx).sum()) * tile_px  # (gy, gx, pixel) triples
    if name == "ka":
        return terms, 0, nbytes + 2 * field
    if name in ("k3", "kc"):
        x0 = x_footprint(g, off, row_block=name == "kc", x_loop=False)
        return rows_terms, 0, nbytes + field + 2 * x0
    if name == "kb":
        x0 = x_footprint(g, off, row_block=False, x_loop=False)
        return 6 * rows_terms, 0, nbytes + field + 2 * x0
    channels = 1 if name in ("k4", "kd", "ke") else g.c
    x_elems = channels * x_footprint(g, off, y_cut=y_cut, x_cut=x_cut)
    fp32 = 4 * rows_terms + terms * (5 + 2 * channels)
    nbytes += 2 * field + 2 * x_elems
    if name != "k5":
        return fp32, 0, nbytes
    # k5: the mask channel, the bf16 rounding of the taps, the w[3] taps
    return (fp32 + pixels * g.c, 2 * pixels * g.c * g.o,
            nbytes + 4 * pixels + 2 * g.c * g.o)


def probe_bound(name: str, args, geom):
    """(bound ms, bound_by, flops, bytes) of probe ``name`` on ``args``:
    fp32 operations at 67 TFLOP/s plus bf16 contraction at 989, against the
    bytes at 3.35 TB/s, on an H100 SXM."""
    fp32, bf16, nbytes = probe_work(name, args, geom)
    t_ops = fp32 / PEAK_FP32 + bf16 / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", fp32 + bf16,
            nbytes)


def probe_timing_cases(name: str, device):
    """(label, kernel call, plain call, library call or None, args) of
    probe ``name`` on each of its inputs at the scripts' geometry, the
    script's own first; the library call is ``Probe.library``'s."""
    probe = probes.PROBES[name]
    geom = probes.SCRIPT_GEOMETRY
    lib = probe.library
    if name in ("p1", "p2", "p3", "p4"):
        return [(label, (lambda a=a: probe.kernel(*a)),
                 (lambda a=a: probe.plain(*a)),
                 None if lib is None else (lambda a=a: lib(*a)), a)
                for label, a, _ in probe_dcn.p5_cases(name, SEED, device)]
    cases = []
    for case in probe_dcn.CASES:
        inp = probe_dcn.tile_inputs(probe.script, geom, case, SEED, device)
        a = [inp[k] for k in probe.kernel.inputs]
        cases.append((case, (lambda a=a: probe.kernel(*a, geom=geom)),
                      (lambda a=a: probe.plain(*a, geom)),
                      None if lib is None else (lambda a=a: lib(*a, geom)),
                      a))
    return cases


def launch_floor_ms() -> float:
    """Device time alone of a kernel that does nothing
    (``torch.cuda._sleep(0)``), per launch: the least a probe kernel can
    take, beside its bound."""
    return time_device(lambda: torch.cuda._sleep(0))


def check_probes(device, timed: bool):
    """Phase 15. The probe path: ``tools/probe_dcn.py:run`` with the probe
    kernels' launch counts set to 0 just before and read just after; it
    holds every probe kernel against its plain version (and K1 at the
    probes' shapes, ``dcn_fwd_bf16``, against its plain version) and every
    probe must pass; on the card each of the sixteen kernels must have
    launched. Then ``k2``, ``k5``, ``kf``, ``kg`` and ``p4`` are held
    against their plain versions at their ragged shapes
    (``check_ragged_probes``), outside those counts. On the card each
    kernel and its plain version are then timed per call, and each kernel
    by its device time alone (``time_device``), on each of its inputs at
    the scripts' geometry, beside the bound of those inputs and the launch
    floor (a kernel that does nothing, timed before and after the probes);
    where ``Probe.library`` is set, that one
    PyTorch call is timed the same two ways and the ratio of the device
    times alone is printed. The headline is the script's own input; a last
    line ranks the kernels (``rank_probes``)."""
    probes.reset_launch_counts()
    lines = []
    results = probe_dcn.run(torch.device(device), SEED, out=lines.append)
    counts = probes.launch_counts()
    for line in lines:
        log(f"  {line}")
    failed = [r.line() for r in results if not r.passed]
    if failed:
        raise AssertionError("probe kernels disagree with their plain "
                             "versions: " + " | ".join(failed))
    if device == "cuda":
        idle = [n for n, c in counts.items() if c == 0]
        if idle:
            raise AssertionError(f"probe kernels never launched: {idle}")
    log(f"probe path: launches {counts}")
    rows = {r.name: {"max_abs_err": r.max_abs_err,
                     "max_rel_err": r.max_rel_err, "cases": r.cases,
                     "launches": counts[r.name], "rtol": r.rtol}
            for r in results if r.name in probes.PROBES}
    for name, rel in check_ragged_probes(device).items():
        rows[name]["ragged_max_rel_err"] = rel
    if not timed:
        return rows
    geom = probes.SCRIPT_GEOMETRY
    floors = [launch_floor_ms()]
    for name, row in rows.items():
        per_case = []
        for label, kernel, plain, library, a in probe_timing_cases(name,
                                                                   device):
            ms, plain_ms = time_pair(kernel, plain, TIMING_REPS)
            bound_ms, bound_by, flops, nbytes = probe_bound(name, a, geom)
            case = {"case": label, "ms": ms, "plain_ms": plain_ms,
                    "device_ms": time_device(kernel), "bound_ms": bound_ms,
                    "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                    "library_ms": None, "library_device_ms": None}
            if library is not None:
                case["library_ms"] = time_one(library, TIMING_REPS)
                case["library_device_ms"] = time_device(library)
                case["device_vs_library"] = (case["device_ms"]
                                             / case["library_device_ms"])
            per_case.append(case)
        row["per_case"] = per_case
    floors.append(launch_floor_ms())
    floor = statistics.mean(floors)
    log(f"  launch floor (torch.cuda._sleep(0), device time alone per "
        f"launch of {DEVICE_LAUNCHES}): {floors[0]:.5f} ms before the "
        f"probes, {floors[1]:.5f} ms after")
    for name, row in rows.items():
        row["launch_floor_ms"] = floor
        head = row["per_case"][0]
        lib = ("" if head["library_device_ms"] is None else
               f", library {head['library_device_ms']:.5f} ms (kernel / "
               f"library {head['device_vs_library']:.2f})")
        log(f"  probe {name}: device time alone {head['device_ms']:.5f} ms "
            f"per launch{lib}, bound {head['bound_ms']:.2e} ms "
            f"({head['bound_by']}), launch floor {floor:.5f} ms; per call "
            f"kernel {head['ms']:.4f} ms, plain {head['plain_ms']:.4f} ms "
            "on the script's input; other inputs " + ", ".join(
                f"{c['case']} {c['device_ms']:.5f}"
                + ("" if c["library_device_ms"] is None else
                   f" (library {c['library_device_ms']:.5f})")
                + f" / per call {c['ms']:.4f} / plain {c['plain_ms']:.3f} ms"
                for c in row["per_case"][1:]))
    log("  probe ranking: " + "; ".join(
        f"{n} " + (f"{rows[n]['device_vs_library']:.2f}x its library, "
                   if rows[n]["device_vs_library"] is not None else "")
        + f"gap {rows[n]['probe_path_gap_ms']:.5f} ms"
        for n in rank_probes(rows)))
    return rows


def check_ragged_probes(device):
    """``k2``, ``k5``, ``kf`` and ``kg`` at ``probes.RAGGED_GEOMETRY``, the
    edges of their kernels (45 pixels a tile, C = 24, O = 6), on
    ``tools/probe_dcn.py``'s three inputs, and ``p4`` at ``probes.RAGGED_P4``
    (K = 24 padded to 32, N = 20 masked), each held against its plain
    version within its ``rtol`` (``k2`` bitwise); raises on a mismatch.
    Called after the probe path's launch counts are read, so these launches
    are not counted there. Returns each kernel's largest relative error."""
    geom = probes.RAGGED_GEOMETRY
    worst = {}
    for name in ("k2", "k5", "kf", "kg", "p4"):
        probe = probes.PROBES[name]
        res = probe_dcn.Result(name, probe.script_name, probe.rtol)
        if name == "p4":
            args = probe_dcn.ragged_p4_inputs(SEED, device)
            res.hold(f"(K, N) = {probes.RAGGED_P4}", probe.kernel(*args),
                     probe.plain(*args), probe.rtol)
            where = f"(K, N) = {probes.RAGGED_P4}"
        else:
            for case in probe_dcn.CASES:
                inp = probe_dcn.tile_inputs(probe.script, geom, case, SEED,
                                            device)
                args = [inp[k] for k in probe.kernel.inputs]
                res.hold(f"{case} at the ragged geometry",
                         probe.kernel(*args, geom=geom),
                         probe.plain(*args, geom), probe.rtol)
            where = f"(BR, W, C, O) = ({geom.br}, {geom.w}, {geom.c}, " \
                    f"{geom.o})"
        log(f"  ragged {where}: {res.line()}")
        if not res.passed:
            raise AssertionError(f"probe {name} disagrees with its plain "
                                 f"version at {where}: "
                                 + "; ".join(res.failures))
        worst[name] = res.max_rel_err
    return worst


def rank_probes(rows):
    """The probe kernels in the order of the port's redesign rule: first
    those slower than their library call (their device times alone summed
    over the timed inputs above the call's summed likewise), by that
    ratio; then the rest by their probe-path gap, the launches on the
    probe path times the mean over the timed inputs of device time alone
    minus bound (a tile probe's launches are its three inputs at two
    geometries, timed at the first). Sets both numbers on each row."""
    for row in rows.values():
        cases = row["per_case"]
        row["probe_path_gap_ms"] = row["launches"] * statistics.mean(
            c["device_ms"] - c["bound_ms"] for c in cases)
        row["device_vs_library"] = None
        if cases[0]["library_device_ms"] is not None:
            row["device_vs_library"] = (
                sum(c["device_ms"] for c in cases)
                / sum(c["library_device_ms"] for c in cases))
    losing = [n for n, r in rows.items()
              if r["device_vs_library"] is not None
              and r["device_vs_library"] > 1]
    return (sorted(losing, key=lambda n: -rows[n]["device_vs_library"])
            + sorted((n for n in rows if n not in losing),
                     key=lambda n: -rows[n]["probe_path_gap_ms"]))


def probe_kernel_entries(rows):
    """The ``kernels`` line's entries of the sixteen probe kernels: launches
    on the probe path, and the script's own input at the scripts' geometry
    for the times and the bound (every input in ``per_case``): per call
    (``ms``, ``plain_ms``, ``library_ms``) and by device time alone
    (``device_ms``, ``library_device_ms``), beside ``launch_floor_ms``;
    ``k2``, ``k5``, ``kf``, ``kg`` and ``p4`` also their largest error at
    their ragged shapes; ``device_function``: the function of
    ``csrc/dcn_probes.cu`` that the probe's entry launches."""
    entries = []
    for name, row in rows.items():
        probe = probes.PROBES[name]
        head = row["per_case"][0]
        entries.append({
            "name": f"probe_{name}", "route": "cuda",
            "source": "centerfusiondetect3d_tpu_torch/csrc/"
                      + probes.SOURCE,
            "replaces": probe.replaces, "path": "tools/probe_dcn.py",
            "device_function": probe.device,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "device_ms": head["device_ms"],
            "library_device_ms": head["library_device_ms"],
            "launch_floor_ms": row["launch_floor_ms"],
            "device_vs_library": row["device_vs_library"],
            "probe_path_gap_ms": row["probe_path_gap_ms"],
            "ragged_max_rel_err": row.get("ragged_max_rel_err"),
            "per_case": row["per_case"],
        })
    return entries


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
        built = load_kernel_libraries(dcn.KERNEL_SOURCES + (probes.SOURCE,))
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
    rows = check_forward(shapes, det.device, not rehearsal, bf16=False)
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 4. bf16 kernel vs plain at every distinct node shape
    t0 = time.perf_counter()
    rows16 = check_forward(shapes, det.device, not rehearsal, bf16=True,
                           fp32_rows=rows)
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
                              micro=micro, bf16=False)
    log(f"phase backward-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 10. the Trainer at full width in float32, counted
    t0 = time.perf_counter()
    train = train_main_path(args.device, rehearsal, bf16=False)
    report_training(train, bwd_rows, micro, card, rehearsal)
    log(f"phase training: {time.perf_counter() - t0:.1f} s")

    # 11. one unfrozen step, kernel DCN vs plain DCN
    t0 = time.perf_counter()
    step = step_kernel_vs_plain(args.device, rehearsal, bf16=False)
    report_step(step, "float32")
    log(f"phase step-vs-plain: {time.perf_counter() - t0:.1f} s")
    if not rehearsal:
        torch.cuda.empty_cache()

    # 12. bf16 backward kernels vs plain at every distinct node shape
    t0 = time.perf_counter()
    bwd_rows16 = check_backward(shapes, args.device, timed=not rehearsal,
                                micro=micro, bf16=True)
    log(f"phase bf16-backward-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 13. the Trainer at full width in bf16, as the configs ship it, counted
    t0 = time.perf_counter()
    train16 = train_main_path(args.device, rehearsal, bf16=True)
    report_training(train16, bwd_rows16, micro, card, rehearsal)
    if not rehearsal:
        log("  bf16 / float32 ms per step: " + ", ".join(
            f"{ph} {train16['ms_per_step'][ph]:.1f} / "
            f"{train['ms_per_step'][ph]:.1f}" for ph in ("frozen", "unfrozen"))
            + f"; peak memory {train16['peak_mem_gb']:.2f} / "
            f"{train['peak_mem_gb']:.2f} GB on {card}")
    log(f"phase bf16 training: {time.perf_counter() - t0:.1f} s")

    # 14. one unfrozen bf16 step, kernel DCN vs plain bf16 DCN
    t0 = time.perf_counter()
    step16 = step_kernel_vs_plain(args.device, rehearsal, bf16=True)
    report_step(step16, "bf16")
    log(f"phase bf16 step-vs-plain: {time.perf_counter() - t0:.1f} s")

    # 15. the DCN probe path, counted; each probe kernel against its plain
    # version, timed
    t0 = time.perf_counter()
    probe_rows = check_probes(args.device, timed=not rehearsal)
    log(f"phase probes: {time.perf_counter() - t0:.1f} s")
    log(f"total wall: {time.perf_counter() - t_all:.1f} s")

    if rehearsal:
        print(json.dumps({"ok": True, "rehearsal": "cpu"}), flush=True)
        return 0
    kernels = [
        forward_entry(rows, "dcn_fwd", False, serving_launches,
                      train["launches"]["dcn_fwd"],
                      built[dcn.KERNEL_SOURCE].ptxas, bwd_rows, micro),
        forward_entry(rows16, "dcn_fwd_bf16", True, launches16,
                      train16["launches"]["dcn_fwd_bf16"],
                      built[dcn.BF16_SOURCE].ptxas, bwd_rows16, micro)]
    for names, rows_b, run in ((BWD_KERNELS, bwd_rows, train),
                               (BWD_KERNELS_BF16, bwd_rows16, train16)):
        for name in names:
            kernels.append(backward_kernel_entry(name, rows_b, run))
    kernels += probe_kernel_entries(probe_rows)
    log(json.dumps({"backward_per_node_shape": bwd_rows,
                    "bf16_backward_per_node_shape": bwd_rows16}))
    log(json.dumps({"training": train, "step_kernel_vs_plain": step,
                    "bf16_training": train16,
                    "bf16_step_kernel_vs_plain": step16}))
    log(card)  # as nvidia-smi --query-gpu=name,power.limit gives it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def backward_kernel_entry(name, rows, train):
    """The ``kernels`` line's entry of backward kernel ``name``: launches in
    the training main path ``train`` of its dtype; times, plain times and
    bounds per backward of the model at B=2 (the sum over its DCN nodes of
    ``rows``, the per-shape rows of phase 9 or 12), and for im2col its
    yardstick ``grid_sample``'s; per unfrozen training step (the node times
    at the microbatch, over the microbatches): for col2im its time, bound
    and map bytes, for im2col and coord their times per call and by device
    time alone, their bounds and errors against plain there (and im2col's
    yardstick); per node shape col2im's map."""
    micro = "micro_sampling"
    entry = {
        "name": name, "route": "cuda",
        "source": "centerfusiondetect3d_tpu_torch/csrc/dcn_bwd.cu",
        "replaces": "centerfusiondetect3d_tpu/ops/pallas_dcn.py:409",
        "launches": train["launches"][name],
        "max_abs_err": max([r["max_abs_err"][name] for r in rows]
                           + [r[micro][name]["max_abs_err"] for r in rows
                              if name in SAMPLING]),
        "ms": sum(r["ms"][name] * r["nodes"] for r in rows),
        "plain_ms": sum(r["plain_ms"][name] * r["nodes"] for r in rows),
        "bound_ms": sum(r["bound_ms"][name] * r["nodes"] for r in rows),
        "bound_by": "operations" if all(
            r["bound_by"][name] == "operations" for r in rows) else "bytes",
        "library_ms": (sum(r["library_ms"] * r["nodes"] for r in rows)
                       if name in IM2COL else None),
        "per_node_shape": [
            {"shape": r["shape"], "nodes": r["nodes"],
             "ms": r["ms"][name], "plain_ms": r["plain_ms"][name],
             "bound_ms": r["bound_ms"][name],
             "max_abs_err": r["max_abs_err"][name],
             **({"library_ms": r["library_ms"]} if name in IM2COL else {}),
             **({micro: r[micro][name]} if name in SAMPLING else {}),
             **({"map": r["map"], "map_mbytes": r["map_mbytes"],
                 "micro_ms": r["micro_ms"][name],
                 "micro_bound_ms": r["micro_bound_ms"],
                 "micro_map": r["micro_map"],
                 "micro_max_rel_err": r["micro_max_rel_err"],
                 **({"collapsed": r["collapsed"]} if "collapsed" in r
                    else {})}
                if name in COL2IM else {})} for r in rows],
    }
    accum = train["grad_accum"]
    per_step = lambda f: accum * sum(f(r) * r["nodes"] for r in rows)
    if name in COL2IM:
        entry["ms_per_unfrozen_step"] = per_step(
            lambda r: r["micro_ms"][name])
        entry["bound_ms_per_unfrozen_step"] = per_step(
            lambda r: r["micro_bound_ms"])
        entry["map_mbytes_per_unfrozen_step"] = per_step(
            lambda r: r["micro_map"]["map_mbytes"])
    if name in SAMPLING:
        keys = ["ms", "device_ms", "bound_ms"] + (
            ["library_ms", "library_device_ms"] if name in IM2COL else [])
        for key in keys:
            entry[f"{key}_per_unfrozen_step"] = per_step(
                lambda r: r[micro][name][key])
        entry["micro_max_rel_err"] = max(r[micro][name]["max_rel_err"]
                                         for r in rows)
    return entry


def report_training(train, bwd_rows, micro: int, card, rehearsal: bool):
    """Logs a training main path's report (phase 10 or 13); on the card
    also adds the DCN kernels' share of a step, from the node times at the
    microbatch ``micro`` of the backward rows of the same dtype."""
    log(f"training ({train['precision']}): batch {train['batch']} in "
        f"{train['grad_accum']} microbatches, {train['steps']} steps "
        f"({train['steps'] // 2} frozen, {train['steps'] // 2} unfrozen) "
        f"after 1 untimed warm-up step; launches {train['launches']} "
        f"(backward kernels expected {train['expected_backward_launches']} "
        "each); losses " + ", ".join(f"{v:.4f}" for v in train["total"])
        + ", all finite; float32 parameters, optimizer state and checkpoint "
        f"tensors; checkpoints {train['checkpoints']} "
        f"({train['checkpoint_mb']:.1f} MB each) read back equal")
    for phase in ("frozen", "unfrozen"):
        log(f"  {phase}: {train['ms_per_step'][phase]:.1f} ms per step ("
            + ", ".join(f"{v:.1f}" for v in train["ms_steps"][phase])
            + f"), {train['images_per_s'][phase]:.2f} images/s"
            + (" on the host CPU (rehearsal)" if rehearsal else f" on {card}"))
    if rehearsal:
        return
    fwd = sum(r["micro_ms"]["forward"] * r["nodes"] for r in bwd_rows)
    bwd = sum(r["micro_ms"]["backward"] * r["nodes"] for r in bwd_rows)
    bf16 = train["precision"] == "bf16"
    col2im = COL2IM[bf16]
    c2i = sum(r["micro_ms"][col2im] * r["nodes"] for r in bwd_rows)
    sampling = SAMPLING[2:] if bf16 else SAMPLING[:2]
    smp = sum(r["micro_sampling"][n]["device_ms"] * r["nodes"]
              for r in bwd_rows for n in sampling)
    accum = train["grad_accum"]
    train["dcn_share"] = {
        "forward_ms_per_step": fwd * accum,
        "backward_ms_per_step": bwd * accum,
        "col2im_ms_per_step": c2i * accum,
        "im2col_coord_device_ms_per_step": smp * accum,
        "frozen_forward": fwd * accum / train["ms_per_step"]["frozen"],
        "unfrozen_forward": fwd * accum / train["ms_per_step"]["unfrozen"],
        "unfrozen_backward": bwd * accum / train["ms_per_step"]["unfrozen"]}
    log(f"  peak memory {train['peak_mem_gb']:.2f} GB (frozen steps "
        f"{train['peak_mem_gb_by_phase']['frozen']:.2f}, unfrozen "
        f"{train['peak_mem_gb_by_phase']['unfrozen']:.2f}); DCN kernels per "
        f"step (node times at B={micro}, x{accum} microbatches): forward "
        f"{fwd * accum:.1f} ms, backward {bwd * accum:.1f} ms = "
        f"{100 * train['dcn_share']['unfrozen_backward']:.1f}% of an "
        f"unfrozen step, of it {col2im} {c2i * accum:.1f} ms, "
        f"{' + '.join(sampling)} {smp * accum:.1f} ms of device time")


def report_step(step, precision: str):
    """Logs phase 11's or 14's comparison of one train step."""
    loss, grad = step["loss"], step["grad"]
    log(f"train step B={BWD_BATCH} ({precision}, NORM_EVAL): in-step backward "
        f"of {step['nodes_checked']} DCN nodes within {step['node_rel']:.2e} "
        f"of the plain backward on their own tensors (limit "
        f"{step['node_rtol']}); against the float64 step, the kernel step's "
        f"loss parts within {loss['kernel']:.2e} (plain {precision} step "
        f"{step['plain_dev']['loss']:.2e}, largest noise {loss['noise']:.2e}"
        f") and its {step['tensors']} gradients within {grad['kernel']:.2e} "
        f"in L2 (plain {step['plain_dev']['grad']:.2e}, largest noise "
        f"{grad['noise']:.2e}); medians kernel/noise: loss parts "
        f"{loss['median'][0]:.2e}/{loss['median'][1]:.2e}, gradients "
        f"{grad['median'][0]:.2e}/{grad['median'][1]:.2e}; worst share of "
        f"its limit: loss parts {loss['worst_of_limit']:.2f} "
        f"({loss['worst']}), gradients {grad['worst_of_limit']:.2f} "
        f"({grad['worst']}); largest gradient limit "
        f"{grad['largest_limit']:.3f} (limit {NOISE_MULT} x noise + "
        f"{STEP_RTOL} or {GRAD_FLOOR})")


if __name__ == "__main__":
    sys.exit(main())
