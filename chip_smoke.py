#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --tiny  # CPU rehearsal, no kernel build

On the card it:

1. prints the torch and CUDA versions and the card's name and power limit,
   whether the CUDA toolkit ships nvJPEG and whether PIL and imageio are
   importable, builds the DCNv2 kernels from ``csrc/`` (``dcn_fwd.cu``,
   ``dcn_bwd.cu``, ``dcn_fwd_bf16.cu``; the forward ones share
   ``dcn_fwd_common.cuh``) with one nvcc each, all in parallel, and prints
   the build time and ptxas' register, shared memory and spill lines (with
   ``dcn_probes.cu``, the probe kernels of phase 15,
   ``jpeg_decode.cu``, the nvJPEG decoder, and ``warp_affine.cu``, the
   device warp of phase 17); then holds the card's decoder
   against cv2's decode of three ``mini_val`` JPEGs (``DECODE_REFERENCE``:
   per-channel and 4x4-cell means within ``DECODE_TOL`` levels;
   ``DECODE_CROPS``: 16x16 crops, each pixel within ``DECODE_PIXEL_TOL``
   and their mean within ``DECODE_PIXEL_MEAN_TOL``), after holding its
   colour kernel (``ycc_to_bgr``) bitwise against its plain version;
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
   launched; then the twelve tile probes at a ragged geometry (45 pixels a
   tile, C = 24, O = 6: no whole float4 of O) and ``p4`` at a ragged K and
   N (24, 20), each against its plain version, outside those counts. The
   tile probes run over the output in ``tile_sum_kernel`` (``k1``, ``k3``,
   ``kc``, ``ka``), ``hat_channel0_kernel`` (``k4``, ``kd``, ``ke``,
   ``kb``), ``broadcast_kernel`` (``k2``), ``hat_tap_kernel`` (``k5``) and
   ``hat_cols_kernel`` (``kf``, ``kg``). Then each
   kernel and its plain version are timed per call on
   each of its inputs at the scripts' geometry, and each kernel by its
   device time alone, beside the bound of those inputs and the launch
   floor (the device time alone of a kernel that does nothing); where one
   PyTorch call computes the probe's function (``Probe.library``: ``k2``,
   ``p1``, ``p2``, ``p4``), that call is timed the same two ways beside it;
   ``p3`` is also held bitwise against its plain version on a ragged
   length, an x off 16 bytes, and NaN and -inf inputs
   (``check_p3_repair``), outside the counts;
16. runs the port's ``main.py`` on the repo's nuScenes-format data
   (``output/campaign_r5/data``, ``DATA_ROOT``) at the campaign's settings
   (``CAMPAIGN_OPTS``: DLA-34 at full width with 16 DeformConv nodes,
   middle fusion, 128x224, K 32, batch 16, bf16) for 2 epochs (the first
   frozen) with a validation and NDS scoring after each, then with ``EVAL
   True`` on the last checkpoint (``main_py_path``): every image is decoded
   on the card (nvJPEG and ``ycc_to_bgr``), a checkpoint is written before
   each validation, each validation launches ``dcn_fwd_bf16`` once per node
   per batch and scores every val image itself (what an earlier one scored
   is cleared first: NDS from its own summaries and its own
   ``metrics_summary.json``), and it prints each validation's mAP and NDS,
   ms per step, decode and warp ms per image, and validation and scoring
   seconds; where the card's machine has cv2, the val images are also
   decoded by the CPU decoder, timed and held pixel by pixel to the
   decoder's limits; last, ``Detector``'s warp of six raw 1600x900 frames
   to serving's 448x800 (``_warp_or_crop``'s non-integer branch) is timed;
17. serves image files as users run it (``serving_files_path``): holds
   the device warp (``ops/warp.py:warp_affine``, ``csrc/warp_affine.cu``,
   built with the others) bitwise against its plain version on six seeded
   1600x900 frames to 448x800, six repo 448x256 JPEGs decoded on the card
   to the same, those with a rotated, scaled and shifted affine and a
   mixed-size batch, and times it on the six raw frames by device time
   alone beside numpy ``warp_image`` on the host, its bound and
   ``grid_sample``; times ``ycc_to_bgr``'s kernel; builds the bf16
   ``Detector`` at full width and holds the batch that its ``load_data``
   and ``pre_process`` write on the card (nvJPEG, device crops, one warp
   launch) against the CPU path's, on six repo JPEG paths and on a batch
   that mixes crops and warps (``check_batch_images``: bitwise on the
   same decoded frames, within the decoders' limits of cv2's decode);
   then, after ``SERVE_WARM`` batches of each, runs ``Detector.run``,
   ``Detector.run_stream`` and ``run_stream`` with one worker in turns,
   ``SERVE_ROUNDS`` times, each on ``SERVE_BATCHES`` batches of six repo
   JPEG paths (cycling the 500) with the counts at 0: one nvJPEG decode
   and one ``ycc_to_bgr`` an image, one ``warp_affine`` and
   ``dcn_fwd_bf16`` once per node a batch and nothing else; every run's
   detections equal the first run's batch by batch and in order (within
   ``DETECTIONS_RTOL`` where not bitwise); frames/s of each with decode,
   warp, dispatch, fetch and the stream's queue waits in ms, and the
   stream's frames/s over run's in each round; then one batch with
   ``TEST.FLIP_TEST``
   (the DCN at twice the batch) and one with ``TEST.MULTI_SCALE`` (0.75,
   1.0, 1.25), on the same module; then ``python -m
   centerfusiondetect3d_tpu_torch.inference`` on a folder of 24 repo JPEGs
   with one checkpoint of the served weights, serial with ``--save-dir``
   and ``--show-attention`` (a drawn frame and two overlays an image) and
   with ``--stream`` (``results.json`` alone), which must write the same
   detections;
18. runs the training run's host side as the JAX package runs it
   (``training_run_path``): (a) the port's converter
   (``data/convert_nuscenes.py``) on a copy of the repo's raw tables and
   samples, whose annotations must equal the committed ones (parsed) and
   whose 1000 radar and lidar ``.bin`` files must equal them bytewise; (b)
   the C++ radar paint and item warp (``native/``, built with g++) bitwise
   their numpy versions; (c) on the train split at the campaign's settings, decoded on
   the card, the first ``LOADER_BATCHES`` batches of the Loader with 4
   threads, prefetch 2 and ``device_prefetch`` 2 bitwise those of one
   thread without prefetch, and the Loader's items/s alone with 1, 2 and 4
   threads; (d) ``tools rehearse --dataroot <the copy> --epochs 2`` in this
   process at the campaign's settings (bf16, ``WORKERS 4``,
   ``TPU.PREFETCH 2``, the first epoch frozen), which must exit 0 with a
   finite NDS in [0, 1], write the JAX run's ``metrics.jsonl`` scalars and
   the summary in ``run_state.json``, log the FLOPs line once, check the
   card's memory once per step, paint, warp and decode once per item built and
   launch ``dcn_fwd_bf16`` and the bf16 backward kernels as often as its
   steps, validation batches and FLOPs report need, each epoch's wall time
   printed beside the sum of its steps'; (e) one epoch with ``TPU.PROFILE
   True`` on 32 train images, whose trace must hold the card's kernels;
   then the forward's cost (``estimate_cost``) at 448x800, B=6, bf16;
19. prints a ``{"kernels": [...]}`` line (``warp_affine`` and
   ``ycc_to_bgr`` beside the DCN and probe kernels) and, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failure raises, so the exit code is not 0 and no result line is printed.
Without a CUDA card and without ``--device cpu --tiny`` it fails. The
rehearsal runs the same path at 64x128 with 2 cameras (and a training batch
of 4 in 2 microbatches) on the CPU, where the DCN ops are the plain versions
(the bf16 phases and the probes included), phase 16 on a handful of
images decoded with cv2 (``TINY_SPLITS``, 64x128), and phase 17 on the
plain warp (held bitwise against numpy ``warp_image`` on 2 frames a
case), cv2's decode, one round of 2 batches and the CLI's ``main`` in
this process with ``--device cpu`` on 4 JPEGs, and phase 18 with the
whole converter and then ``TINY_SPLITS`` of its output at 64x128, decoded
by cv2; its last line is ``{"ok": true, "rehearsal": "cpu"}``.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import glob
import importlib.util
import io
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch import inference as cfd_inference
from centerfusiondetect3d_tpu_torch import main as cfd_main
from centerfusiondetect3d_tpu_torch import native
from centerfusiondetect3d_tpu_torch import tools as cfd_tools
from centerfusiondetect3d_tpu_torch.data import image_io
from centerfusiondetect3d_tpu_torch.data.convert_nuscenes import export_split
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.image_io import read_image
from centerfusiondetect3d_tpu_torch.data.pipeline import (
    Loader, device_prefetch, stack_items, to_device)
from centerfusiondetect3d_tpu_torch.data.transforms import (
    warp_image,
    warp_image_native,
)
from centerfusiondetect3d_tpu_torch.geometry.affine import get_affine_transform
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn, probes, warp
from centerfusiondetect3d_tpu_torch.ops.cuda_build import load_kernel_libraries
from centerfusiondetect3d_tpu_torch.ops.rasterize import (
    paint_rects_device_batch,
)
from centerfusiondetect3d_tpu_torch.runtime.detector import (
    Detector, _warp_or_crop)
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
from centerfusiondetect3d_tpu_torch.training.checkpoint import (
    load_torch_file, save_checkpoint)
from centerfusiondetect3d_tpu_torch.utils.observability import (
    DEVICE_LAUNCHES, DeviceHealthMonitor, estimate_cost, time_device)

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
# the repo's nuScenes-format data (git-tracked), relative to this script
DATA_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "output", "campaign_r5", "data")
# cv2.imread's decode of three mini_val JPEGs (448x256, baseline 4:2:0):
# per BGR channel the mean, then the means of a 4x4 grid of cells (row by
# row, each cell's B, G, R); and in DECODE_CROPS, 16x16 crops of it (top
# row, left column, then its pixels as BGR uint8 row by row, in base64):
# two where the chroma changes most, one at a corner.
# tests/test_torch_image_io.py checks both against cv2. The card's decoder
# must come within DECODE_TOL of each mean, within DECODE_PIXEL_TOL of
# every pixel of the crops and within DECODE_PIXEL_MEAN_TOL on average
# over them: it upsamples and converts as libjpeg does, and only its
# inverse DCT rounds otherwise (PERF.md, PR 16).
DECODE_TOL = 1.0
DECODE_PIXEL_TOL = 4
DECODE_PIXEL_MEAN_TOL = 0.5
CROP = 16
DECODE_REFERENCE = {
    "samples/CAM_FRONT/c1img0.jpg": (
        (124.524, 117.328, 110.52),
        ((159.764, 142.928, 116.782, 159.731, 142.566, 117.236, 159.903,
          142.877, 116.71, 160.077, 142.617, 116.919),
         (139.597, 128.618, 112.019, 138.025, 127.913, 111.851, 137.721,
          127.604, 111.454, 138.901, 128.468, 112.038),
         (94.537, 91.319, 117.856, 89.915, 87.57, 115.846, 105.001, 101.76,
          106.314, 112.159, 108.024, 106.333),
         (99.184, 101.025, 101.654, 99.31, 101.298, 101.868, 99.107, 101.275,
          101.658, 99.447, 101.384, 101.787))),
    "samples/CAM_FRONT/c1img1.jpg": (
        (125.292, 117.925, 110.353),
        ((159.675, 142.829, 116.949, 159.934, 142.764, 117.459, 159.431,
          142.475, 116.809, 159.845, 142.557, 117.541),
         (139.41, 128.741, 111.794, 138.353, 127.33, 111.575, 139.467,
          128.709, 111.909, 136.674, 126.248, 112.2),
         (109.21, 104.933, 109.932, 90.271, 86.754, 114.726, 117.741,
          113.108, 106.895, 97.207, 94.687, 110.22),
         (99.134, 101.41, 101.958, 99.534, 101.426, 101.849, 99.251, 101.159,
          101.889, 99.532, 101.675, 101.937))),
    "samples/CAM_FRONT/c1img2.jpg": (
        (126.506, 117.479, 107.478),
        ((159.619, 142.507, 116.939, 159.755, 142.404, 116.993, 159.806,
          142.636, 117.176, 159.454, 142.803, 116.916),
         (139.575, 128.974, 112.405, 134.833, 105.988, 86.545, 139.177,
          126.244, 109.085, 139.504, 128.997, 111.948),
         (113.37, 109.462, 107.772, 83.961, 77.178, 106.15, 119.013, 111.874,
          103.345, 119.556, 114.711, 106.853),
         (98.963, 101.046, 101.999, 99.215, 101.662, 101.907, 99.304, 101.77,
          101.706, 98.998, 101.417, 101.916))),
}
DECODE_CROPS = {
    "samples/CAM_FRONT/c1img0.jpg": (
        (144, 144, "HhyeHhyeHh2bHB6aHB6aGh+ZHCGUHh+XIB2iHxyaICOLAQZjGBp4Ghx6"
                   "Ghp4Fhh3HhyeHhugHhyeHB2dHB6aHB+ZHiGUHh+XHxqfHxqbISSNAwhl"
                   "GRt5HB58Hx5+HB1/Hh2dHhyeHhqhIBugIB2bIR6ZIx6XIx6ZJhuhJR2a"
                   "JieJBAhgFhh3Fxh6Fxd7FhZ6HB6aHB2dHhqiIBmiIR2bIx6ZIx6ZJRyb"
                   "JhigJRuXJyaGBAleGBp5GBqAGRuBGhmAGCCZGB+aGhqiHBmkHh2dIB6a"
                   "IxudIxqgJBehIxuYIyWDAQhdFRh6FhmBFhmBFBd/GCGWGCCXGBuhGhqi"
                   "HB6bHh6aIRueIxqgJBqiJR2ZJiiGBQteGBt2Ghx7Ghx7GRt6GiKTGiGU"
                   "Gh6bGh2dGh+ZHB+ZHh2dIBueHxieIx+WKiqICQ1cGx1rHh5sICBsIiJw"
                   "HiGUHiGUHB+ZHB6aGh+ZHB+ZHB6bHh2dIBucJCGVKSiEAwRODg5KDAo+"
                   "DQo8Dgo+IhyZIh2YIB2YHR6YGx2ZGx2ZGx2aHRyaJCCdIRyPLCaFFA9U"
                   "ameOdHGHeG+Ed2+AJhqiJhuhIh6cIR+bHR6eGx6eGR+eGx+cIB6ZJCCR"
                   "MCmKFQ5RcW6Hd3R2fHR0f3ZzIhWmIhWmHxqfGxycFxufFhufFB2dFh6a"
                   "GyCaISGTKCWICAZIc3aFdXlue3dsfHZrJhqiJBqiIh6bHyCYGyCaGSGa"
                   "GSGYGSKXFx6NIyaOLSmICglHbXN+bXRneXltg351JyCPJyGOJiSIJCaF"
                   "ICaFICaFICaHICaHJyyHKyyCKid2EhJIbHV/bHVrbnJtb21sEAxTEA1S"
                   "EA5QDxBNDxBMDxBNDw5SDw5SCwpKDw1JEw1GGBU8ZmpvcXlvdnZ2dXJ0"
                   "bWp5bWp6bWl8bWl8bWt3b2l6cWWDcWOFbmKAeWqJd2iHdGh6e3Zzc3Fn"
                   "dGxte3J1dHNldHJodHBrdnBrdnFoeG9remtzeml2fGx3fGx3dGNwfnB2"
                   "eXFqe3RreG5ue3By"),
        (144, 48, "fXtjfHlkf3ZpfHJyc21+FBFCJySHIR+bGh6bGB6dHB6bHB6aHh6aHB6a"
                   "HCCXHCCXfndmfndmf3RsfHF0dG6BFhFEKSSHIR+bGB6dFx6dGh6bHB6a"
                   "Hh6aHh6aHCCXHCCXfXRrfnJsf3JwfG93dm2CGBFEKyOHIh6bGh2dGB2e"
                   "GhyeHByeIBueIBueHh2bHh6afXFxfnByfm9zfG55dmyDGBFEKySFIh+a"
                   "HB2dGhygHBugHhugIRqhIRqgIBydHh2bfW9zfW91fnB2e297dm2CGBJD"
                   "LSWEJB+YHh2bGhyeHhugIBugIRqhIRqhIBueIBydfHFzfHF0fXF3fHB8"
                   "dW6DGBJDKyWEIx+WHh6aGh6bHh2dIBueIRqgIRqgIRydIB2be3Vwe3Vw"
                   "fHR0e3N6dG+EFxNEKyWEIR+WHCCXGh+ZHh+ZIB6ZIR2bIR2bIR2aIB6a"
                   "enhtenhte3dyenN6cm+FFhJGKSSHIR+XHB+ZGCCXHCCWHiCWIR6ZIR2a"
                   "IB6ZHh6aeXtod3toeHZueHN8bWqEFRFMKCGKIh+dHCCdGCCZGx+VHiCW"
                   "IR+aIR+aHh6aHh6aeXtodnxpd3RvcW14bWiHEQtMKSOQIBueGBubFx2a"
                   "GR+WGR2UHByYHh6aHiCdHR+bdHRmdHlqdnJxb2t3enWVDghJMiuaGRSZ"
                   "GRufGh+gHSGeGx2ZHBubHhyeHR2fGxyceXhucnNqfHh3cmx3YV54FhNL"
                   "HxiBJyKjGhyeGR6fHh+fIB+fHxyhHhugGxqfGhubdnNvcm5tdXBvcm1v"
                   "c3B/GhlBLiqDJCGUHSCaFxuYGRmbHxyhIhyjHxmgGxudHR+cdG1weHJz"
                   "fHVyc29qa2xqGRszKipwIySGIieUHSGYHRycIRyhIRqhHhmeHh2bHyKc"
                   "enB2bGFkeXBnhIBubXFeanF0ERVGCAxdGSCBHiKSJCKdIh2eHxmcIRyd"
                   "ISGXHiCWdmpwfnFzfHNpeHRhdHlebHRpY2iBXGCTDhRXHyJzLCuHKiWI"
                   "JyGGLCiIKiuFIiZ/"),
        (0, 0, "qY93qY93qpF3q5J4q5V5rJd4rJh5rZp5rJt6rJt6rpt6rZp5rpl5rZh4"
                   "rZh5q5Z6qY93qY93qpF3qZJ4q5V5rJZ6rJh5rJl4q5p5q5p5rJl4rJl4"
                   "rJd3rJd3rJd4q5Z6qI52qY93qJF3qpN5q5V5q5Z6q5d4q5d4qpl4qZh3"
                   "qpd2qpd2qZZ1qZZ1q5Z3qpV5qI52qY93qJF3qpN5qpV5qpV5qpZ3qpZ3"
                   "qJd2p5Z1qZZ1qJV0qJV0qJV0qpV2qZV2po91p5B2qJF3qZJ4qZR4qpV5"
                   "qZV2qZV2ppR1ppR1ppV0ppV0qJR1qJR1qZV2qZV2po91p5B2qJF3qZJ4"
                   "qJN3qZR4qZV2qZV2ppR1ppR1ppV0p5Z1qZV2qZV2qZV2qZV2ppF2ppF2"
                   "ppF2p5J3qJN3qJN3p5V4p5V4pZN0ppR1p5V2qJZ3qZd4qJZ3qJZ3qJZ3"
                   "ppF2ppF2ppF2ppF2p5J2qJN3ppR3p5V4pZN0ppR1qJZ3qZd4qph5qZd4"
                   "qZd4qJZ3pJJ1pJJ1pJJ1pJJ1pZN2pZN2ppR3ppR3p5V4qJZ5qZd6qph7"
                   "qZp6qJl5p5h4p5h4o5F0o5F0o5F0pJJ1pJJ1pZN2ppR3ppR3p5V4qJZ5"
                   "qZd6q5l8qZp6qZp6qJl5qJl5opBzopBzopBzo5F0pJF2pZJ3pZJ3ppN4"
                   "p5R5qJV6p5d6qJh7qZl8qZl8p5p6qJl5opBzopBzopBzo5F0o5B1pJF2"
                   "pJF2pZJ3ppN4p5R5ppZ5p5d6qJh7pph7ppl5pph7oZJyoZJyoZF0oZF0"
                   "o5B1o5B1o5B1o5B1pZJ3ppN4pZR5ppV6pJZ5pJZ5pJZ5pJZ5opNzopNz"
                   "oZF0oZF0oo90oo90o5B1o5B1pZJ3pZJ3o5J3pJN4opR3o5V4oZZ4o5V4"
                   "oJNzn5JyoZF0oZF0o5B1o5B1o492o492pZF4pZF4o5J3o5J3oZN2oZN2"
                   "oJV3opR3n5Jyn5JyoZF0oZF0oZF0oZF0pJF2opF2pZJ3o5J3o5J3o5N2"
                   "oZN2oZN2n5R2n5R2"),
    ),
    "samples/CAM_FRONT/c1img1.jpg": (
        (144, 80, "e3ttenlrf3lsfnlqfXxocnN3ExBIJCJ7HR+FGhyMGxiTGxeUGxmQGxqO"
                   "GhmRGhmReHpueXltf3hvfnhre3xocnN3Ew9KJiF8HR+DGh2KGhiTGxeU"
                   "GxqOGxuNGhqOGhqQenlvendvf3dwfndue3trcnF6Ew1OJh+AHx6GGxuN"
                   "GxiTHRiTHxuMHxyKHRqNHRqNeXhueXdtfndufnhte3trcnB8EgpQJR2C"
                   "HxyKGxmQHReUHxiRIRuKIRyJHxuMHxqNeXlnenllgHpngHpne3xocnF7"
                   "EgpRJRuFHxmOGxiTHReUHxiRIhuKIhyHIhqMHxqNeHhmenllgHtmgHxk"
                   "fXxncnF6EgtOJRyEHxqNGxiTHRiRHxmOIhuKIhyJIhmOHxmQeXVqe3Vo"
                   "gHlmgHxkfX1lcnR1Eg9HJSB7HR2HGxyMGxyMHRuMHxyKHxqNHxeTHRaV"
                   "e3NsfXRrgndpgXpnf3todHJ4FA5HJSF6HR6GGh2KGxyKGx2JHRyKHRqN"
                   "GxeUGxeVfHNve3FqgXVrg3dtgXhvcmp7Fw9QJB59HBuJGBiMGhyMGh2K"
                   "HB6KGRuLGRqSGBaRfHVsgXhvhXlvgXRsfXFveW2DFgpMLySEHxmKIiCX"
                   "FhaIGxyMHyCQEBCEHyCYGBaRfXprgHxqgHdpfnJofnNvgHSIFQlDJhpy"
                   "IxuGHBeKIRyPIyCUFA+IHhqXFhWTHBuZc3RkeXlngntsg3ptg3hwem93"
                   "HBM7Fw9OLih6JCB/HRh7JB6JIBePJR2aIBmYGRWSdXxvdnpvf3lufnVn"
                   "fHVigHpvbWtxbW2FCww4EBFLLipxJh90LCCKJBaMGg+JIxqTcHhtbnZs"
                   "fHpwgnptfndjeXRffX1xbXFya2+BcHKREQ85FA5JMCR2LSB8KiB9KiWB"
                   "cH1tanZqc3RrfXdsgHhnfnhlfntscXJpaWxwbG55aGh6cW2KGBE8EQ48"
                   "ExU9ChA1b3pqbnhrd3hvfXhvfndof3hnd3JjeXdtendzcm9xeXV6cG12"
                   "b2x8cXGBZmt0aXF4"),
        (144, 176, "IRqTIRiQIBiNIR6FAgZXExppFRZ4GReBGBN8HRxsBw0wa3N6cnR0eXVw"
                   "gnhxgXZuGhOMHhiPHxeMIh+GAAZVFx9sExN3Ew57GBB7HhpsERc6bHR7"
                   "dnh4fXl0gnhxfnNrIyCTHxyPGxeIISCHAQVWFxtsFRJ5GxSDIBWDGhNo"
                   "DhE3am94dnZ2d3RsgHhrh35wGRqKGBiKHRqNIB6IBgleGBpuGxZ5HRN9"
                   "IBV9IhlqDxA2c3WAeXl5enVsf3hpgHhnFxeLGxuRJB+YGBWDAwNdFxhp"
                   "IBt3HhNzHhFtLCFpDg0vcXF9dHJyfHZvhX5tfndkHR2RFxeLHhyTHhyG"
                   "CwxdFxddIB1lJR9mJRthKyNYFBErd3Z/enV3d3FsgHdtgnlrGx+PFhyH"
                   "GRmDISJ9AgdGDxVCCw01DAwwERAyFhMtGxwmcXByfXZ5e3Byf3Nxhnp0"
                   "ExSGIyaSHRyEIyF6FBdOXWSFbnSHbnJ9c3WAc3N5cXFxfHt3d3FygHV4"
                   "gXR2e25sGxmRIByTJByOJh57EQ9KaWuKdXeCbHFwc3Z0dXdxd3hveHZu"
                   "eXRxfXNzf3J0f3NxIBmMHhWJJRuGKyF7EgtEamiFcHB2enx2d3hveXhu"
                   "eHhseXdse3Vue3VwfXRxf3RwKSKDKiGCLiN/LyNvHBRDe3WOcXB0dHFs"
                   "eHVweHVteHZreHdpendpendpfHZrfHVsDgtJEAtIEgtEFxA9GhQtcWx1"
                   "eHVweXdseHVtd3Rsd3Vrd3ZoeXZnenhmfHZpfHZraG55bXN6cnZ7fH5+"
                   "dHRofHxqfHxkd3ZheXZoeHNqdnRqd3Vqd3dleHhmenZrfXZtcXdsc3pr"
                   "c3ZmeHpmenthdHNXf35iendieHRpeHJrdnNrdnRpd3dleHhme3Zte3Zt"
                   "cW5qdnZwdXNpdnNlf3tpgXtog3xrd3FmeHFueHBxdnFwdXNrd3dleHhm"
                   "eXdte3Vud3BtdXBtdnBpeXJpe3JoenJld25kgXdwenBweHBxdnFwd3Rs"
                   "eXZnenhme3dsfHdu"),
        (240, 432, "XmJnXmFmXmFmXmFmXmFmXmBoXWBoW2FoXGFqWmFqW19qXV9qXl5qYF1s"
                   "Yl1sYl1sXWFmXmFmXmFmXmFmXmBoXWBoXV9pWWBpWV9qV2BqWmBrXGBr"
                   "Xl9tXl5sYF1sYl1sXGBlXWFmXmFmX2JnX2FpXWBoXWBoWWFoWF9oV2Bp"
                   "WmFqXGFqXmBrX19rYF5qYl5qW19kXGBlXmFmX2JnX2FpXmFpXWBoW2Fo"
                   "WGBnV2FoWmJpW2NqX2JqYGJqYWBpYl9oW15mXF9nXmBoX2FpX2FpXmFp"
                   "XWFmW2FmWWJmWmNnW2RoXGVpYGRpYGNoYWFnYmBmW15mXF9nXmBoXmBo"
                   "X2FpX2JnXmJnXGJnWmNnW2RnW2RnXGZmYGVmYGRlYWNkYmFjW11nXF5o"
                   "XV9nXmBoXmFmX2JnXmJnXGNmXGVoXGZmXGZmXGdlX2VkYGVkYWNjYWNj"
                   "XF5oXF5oXV9nXV9nXmFmX2JnX2RnX2RnX2dnXGdlXGdlW2ZjX2ZjXmVi"
                   "YWRiYWRiXF9nXF9nXV9nXV9nXmFmX2JnX2RnX2RnXmZmXWVkW2ZkWmVi"
                   "XWRhXWRfYGRfYGRfW15mWV9mW15mXF9kXF9kXWBkXmNmXmNkXWVkXWVk"
                   "WmViWmViXmVgXWRfXmRfYGRfW19kWF5jWl5jWV1iW15jXF9jXWBkXWJj"
                   "XWVkXWVkWmViWmViXmViXWRhXmNhXmNhWV9kWF9iWl5jWV5hW15iXF9j"
                   "XWFiXGFiXmRjXGRjWmVjXGViXmViXWRhXmNhXmNhWWBjWWFhW2BjW2Bh"
                   "XGBhXmBhXWFiXGFiXWJjXGRjXGRjXGRjXmRjXWNiXmNiXWJhWmFkWmJi"
                   "XGFiXWJjYGJjX2FiXWFiXGFiXWJjW2NjXGRjXGRjXmRjXWNiXWFiXWJh"
                   "WWFhWmJhXWNiXmRjYWNkYGJjXWFiW2BhXGFiW2NjW2NjXGRkXmNkXWJj"
                   "XWBkXWFiV2FhWGNhXmRjX2VkYmRlYGJjXWFiWl9gXGFiWmJiW2NjXGRk"
                   "XmNmXWJlXWBkXF9j"),
    ),
    "samples/CAM_FRONT/c1img2.jpg": (
        (144, 192, "GhyCHByAIR56IR56HB1/GBuDGBqGJyB1JA4xUyssbi8afTISfC4RejAU"
                   "dC4Wcy8YGBuDGhyAIR95Ix55HB1/GBuDGBmHJx92JhAzVy0ucTAbgTQU"
                   "gTIRgDIVdC4Wci4XFxqHGBqGHxx/IR19HBuCGBqGGhmHKB92KA4yWSos"
                   "cSwYgjEQgjANhDMSeS8Tdi8UExqHFRuGHhyAHxx/GhuDGBuEHBmHKh91"
                   "Kg82Wywvci0cgTEUgS4PgzESfC8VezEZER2DExyDHB59Hh58GB2AGByC"
                   "HBqEKiBzJwwzVioxbiwhfS4ZfCkTeysUdigXeCwaExyDFRyDHh1/Hx19"
                   "HB1/HByAHxuCLiByJQoxUygxaywkeTEfei8ZezAadS0ceS4eGBqGHBmH"
                   "IxmDJRqAIRuAIRuAJRt/MSFvLBE4UiszYCkibC0ZbS0UcTIWbS8Xby0a"
                   "HBuDHhqDJRqAJxx9Ix18IR56Ix55LiNrJRE0QCMsQRkURBgHRBgASBwE"
                   "RhkERRcFHSF5HCF2ISF1IyFzHSJxGyNwGyNwIyhlFxUzGA8Zh3d4hnNr"
                   "hXZmiXpqiHhsgnRoBwxDBw5ADA1ADQ5BCg9ABhBABRBECxM7FRcpgoGD"
                   "cWxreHJtd3VqdXNofHhzendyb3B0cXFxdnB1d3B3cnJ4cHN7b3KBcnN9"
                   "cm5pgXtwdm1kg3xzeXVqfXtxenFue3NzdnVhenRhfnJmgHRqfHZreXdt"
                   "eXV0enVyioF0fHFjf3Vrf3ZtenVsdHFpfXJ0fXBye3NmfHJogW9ugnBx"
                   "f3NvfXRxe3J1fXJ0eWxkiHlwem1rfHJycm5pcm1qfnJ4fW91d3FkeHFo"
                   "fm5vf25xfHBuenFueHBxenBwhnlxdGdfd2treHJzb25qenZ1em50eW5x"
                   "cnVlc3VpeHFueXJveHVtdnVrdnNudnNrdm5hgHdteHNwamhncnZwbnBq"
                   "enJzem9xbnRjb3RldHJqdnNrdXRqc3VpcnNqdHNpdnJncGxhcXFrbm9r"
                   "bXJpcHNqcWxpe3Rx"),
        (128, 192, "Hww/HQw/HQtAGwtAGwtBGwpDHQhGKAw6OxUhYi0jdDAZeC0Tei8Zdi0X"
                   "ei4XfC4XJSN1IyR0ISR1ISN3ISN3ISJ6IyB8MCVtKxIsWSwocTAbeC4S"
                   "eC8Zdi0Zei4XfC8VHx13Hx12HR13HB13HB13HB14HRt7LCBsKxEvWSwp"
                   "cTAbeC4SeDAYdi0Xei8VfC8VIB2AIB5+Hx6AHR6AHx5+Hx6AHx2BLSJy"
                   "KxAxWSsqcS8ceC4SeDAYdi4WejAUfC8UHhqEHhqDHBuDGhuDHBuCHBuC"
                   "HhqDLCByKxAyVysscS8ceC4SejAWeC4UfDATfDATHRqHHRqHGxuHGxuH"
                   "GxuFGxuFHRqHKyF0KQ8zVysscS8ceC4SejAYeC4UfDATfDATGhqGGhmH"
                   "GBmHGBqGGBuEGhqEHBmGKh91KQ8zVSsscS8deC4SejAYeC4WfDATfDAT"
                   "GhqEGBqGFxqGFxqGGBuEGBuEGhqGKh91KBAzVSsscS8deC0TejAYeC4W"
                   "fC8UfDATGhyCGBuDFxuEFxyDFxyDGBuDGhqEKiBzKBAzVSsscS8deC0T"
                   "ei8ZeC4WfC8UfDATGhyAGB2AFxyCFxyCFxyCGByCGhuDKiFyKBAyVSss"
                   "cS8deC0Tei8ZeC0XfC8UfC8UGhyAGB5/Fx2AFx5/GB5/GB5/GhyCKiFx"
                   "KBAyVSsscS8deC0Tei8ZeC0XfC8VfC8UHByAGh59GB5/Fx5/GB5/Gh1/"
                   "HBuCKiFxKRExVSwqcS8deC0Tei8ZeC0XfC8VfC8UHByAGh1/GB2AGB5/"
                   "GB5/Gh1/HBuCKiFxKRExVysqcS8deC0TejAYeC4WfC8UfC8UHBuCHByA"
                   "GhyCGB2AGB2AGhyAHBuDLCByKRAyVysscS8ceC4SejAYeC4WfC8UfDAT"
                   "HBuDHBuDGhuDGhuDGhuDGhuDHBuDLCByKRAyVysscS8ceC4SejAYeC4U"
                   "fDATfDATHBuDHBuDHhuCHByAGhyCGhuDHBqEKiBzKBAzVSsscS8cei4R"
                   "ezEVeC4UejAUejAU"),
        (0, 432, "pJNyo5Rzo5Rzo5RzpJNypJNypJNypZRzppV0ppV0ppZyppZyqJVyqJVy"
                   "qZdyqZdypJNyo5RzpZRzpZRzpZRzpZRzpZRzppV0ppV0ppV0qJVyp5Rx"
                   "p5RxqJVyqJZxqJZxppJzpZN0qJR1qJR1qJR1qJR1qZZ1qZZ1qZZ1qZZ1"
                   "qZVyqJRxp5Nwp5Nwp5RvqJVwppJzp5N0qZV2qZV2qpZ3qpZ3qpd2q5h3"
                   "q5Z2qpV1qJRxp5NwppJvppJvppJvp5RvppF1qZN3qpR4q5V5rJd4rJd4"
                   "rJd4rZh5rJd3q5Z2q5R0qZJyp5Bwp5Fup5FuqJJvp5J3qJN4q5R6rJZ6"
                   "rJZ6rJd4rZh5rZh5rJd3q5Z2qZR0qZJyqJFxp5Bwp5Bwp5FupZF4ppN4"
                   "qpV6rJd7rJd7rJd7q5d4rJh5qpd2qpd2qJV0qJNzp5JzppFypZBxpZBw"
                   "o5J4pZR6qZV8qpd8qph7qZd6qZd4qZd4qpd2qJd2qZZ1p5N0ppJzpZB0"
                   "pI9zo45yo5N8pJR9p5Z8p5Z7p5d6p5d6ppd3ppd3qJZ3ppd3qJZ3p5V4"
                   "pZN2o5B1oo90oo90pJN+pJR9pZV+pph8pph8pZd6pJd3pZZ2ppd3ppd3"
                   "ppZ5pZR5o5J3oZB2oI53n412opR+o5V+pJZ/pJh8pJh8o5h6opd3o5Z2"
                   "o5Z2pJd3pZd6pJZ6opJ7oJB5no14no14opR+o5V+pJZ/pJh8pJh8o5h6"
                   "oZZ2oJV1o5Z2pJZ5pZd7pZZ8pJN+oZB9oI98n418o5J9pJR9pZV+pZd7"
                   "pZd7pJZ5o5Z2opV1ppd3p5d6qJd8qJZ/ppKApJB/o45/oo1+opF8opJ7"
                   "o5N8o5V5o5V5o5V4opV1pJV1pZZ2ppZ5p5Z8p5V+ppKApI+Ao42Bo42B"
                   "o5B7o5F6o5F6o5J3o5J3o5N2pJV1ppR1ppR3p5V4qJR7p5J9po9/pY5/"
                   "pYyCpYyCopB5oY94oZB2oZB1opF2pZN2pZN2ppR3pZJ3ppJ5ppF7ppF8"
                   "pY99pox+poyApoyA"),
    ),
}
# the campaign's settings (output/campaign_r5/config.yaml) as overrides, its
# absolute paths aside; then this phase's cuts: 2 epochs, the first frozen,
# each validated (the campaign: EPOCHS 0 as written, DEFREEZE 2,
# VAL_INTERVALS 30)
CAMPAIGN_OPTS = [
    "WORKERS", "4", "DATASET.TRAIN_SPLIT", "mini_train",
    "DATASET.VAL_SPLIT", "mini_val", "DATASET.RADAR_PC", "True",
    "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.FRUSTUM", "True",
    "MODEL.DLA.NODE", "DeformConv", "MODEL.FREEZE_BACKBONE", "True",
    "MODEL.K", "32", "MODEL.INPUT_SIZE", "(128, 224)",
    "TRAIN.BATCH_SIZE", "16", "TRAIN.WARM_EPOCHS", "2", "TRAIN.LR_STEP",
    "[55]", "TEST.BATCH_SIZE", "16", "MIXED_PRECISION", "True",
]
MAIN_PY_CUTS = ["TRAIN.EPOCHS", "2", "MODEL.DEFREEZE", "0",
                "TRAIN.VAL_INTERVALS", "1", "TRAIN.SAVE_INTERVALS", "10"]
# the CPU rehearsal's handful of images and its size
TINY_SPLITS = {"mini_train": 8, "mini_val": 4}
# a raw nuScenes camera frame and serving's input, (H, W)
RAW_FRAME = (900, 1600)
SERVE_INPUT = (448, 800)
# phase 16's train run on the card when the Loader built every item on the
# training thread, before WORKERS was read (PERF.md §5): printed beside
# the run's own seconds
SERIAL_LOADER_TRAIN_RUN_S = 24.0
TINY_OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "TRAIN.BATCH_SIZE", "4",
             "TEST.BATCH_SIZE", "4"]


def log(msg: str) -> None:
    print(msg, flush=True)


def decoder_facts():
    """Whether the CUDA toolkit ships nvJPEG, and whether PIL and imageio
    are importable (neither is used: the card decodes with nvJPEG and its
    own colour kernel)."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    libs = sorted(glob.glob(os.path.join(cuda, "lib64", "libnvjpeg.so*")))
    facts = [f"libnvjpeg: {', '.join(map(os.path.basename, libs)) or 'none'}"
             f" in {cuda}/lib64"]
    for name in ("PIL", "imageio"):
        found = importlib.util.find_spec(name) is not None
        facts.append(f"{name} {'importable' if found else 'absent'}")
    return facts


def decode_stats(img: np.ndarray):
    """(per-channel means, 4x4 grid of per-channel cell means, flattened
    row by row) of an HWC image whose sides divide by 4, in float64."""
    h, w, c = img.shape
    a = img.astype(np.float64)
    cells = a.reshape(4, h // 4, 4, w // 4, c).mean((1, 3))
    return a.mean((0, 1)), cells.reshape(4, -1)


def crop_literal(name: str):
    """``DECODE_CROPS[name]`` as ((top, left), (CROP, CROP, 3) uint8)."""
    return [((y, x), np.frombuffer(base64.b64decode(b64), np.uint8).reshape(
        CROP, CROP, 3)) for y, x, b64 in DECODE_CROPS[name]]


def decode_vs_reference(device) -> dict:
    """Decodes the ``DECODE_REFERENCE`` JPEGs on ``device``
    (``data/image_io.py:read_image``); raises unless every mean is within
    ``DECODE_TOL`` of cv2's and the ``DECODE_CROPS`` pixels within
    ``DECODE_PIXEL_TOL`` each and ``DECODE_PIXEL_MEAN_TOL`` on average.
    Returns the largest mean difference, the largest and the mean pixel
    difference, in levels."""
    worst, diffs = 0.0, []
    for name, (means, cells) in DECODE_REFERENCE.items():
        img = read_image(os.path.join(DATA_ROOT, "nuscenes", name), device)
        got_means, got_cells = decode_stats(img)
        diff = max(float(np.abs(got_means - np.array(means)).max()),
                   float(np.abs(got_cells - np.array(cells)).max()))
        if not diff <= DECODE_TOL:
            raise AssertionError(f"decoding {name} on {device}: a mean "
                                 f"{diff:.3f} levels from cv2's (limit "
                                 f"{DECODE_TOL})")
        worst = max(worst, diff)
        for (y, x), want in crop_literal(name):
            got = img[y:y + CROP, x:x + CROP].astype(np.int16)
            diffs.append(np.abs(got - want))
    diffs = np.stack(diffs)
    res = {"mean_levels": worst, "pixel_max": int(diffs.max()),
           "pixel_mean": float(diffs.mean()),
           "pixel_equal": float((diffs == 0).mean())}
    if not (res["pixel_max"] <= DECODE_PIXEL_TOL
            and res["pixel_mean"] <= DECODE_PIXEL_MEAN_TOL):
        raise AssertionError(f"decoding on {device}: the crops' pixels "
                             f"{res['pixel_max']} levels at most and "
                             f"{res['pixel_mean']:.3f} on average from "
                             f"cv2's (limits {DECODE_PIXEL_TOL}, "
                             f"{DECODE_PIXEL_MEAN_TOL})")
    return res


def ycc_kernel_vs_plain(device) -> int:
    """Holds ``ycc_to_bgr``'s kernel bitwise against its plain version on
    the planes nvJPEG decodes from the ``DECODE_REFERENCE`` JPEGs (4:2:0)
    and on the same planes cut to odd sizes, 4:2:2 and grey; returns the
    number of cases. Outside the launch counts."""
    cases = 0
    for name in DECODE_REFERENCE:
        data = np.fromfile(os.path.join(DATA_ROOT, "nuscenes", name), np.uint8)
        y, cb, cr = image_io.decode_planes(data, device, name=name)
        h, w = y.shape
        for planes in ((y, cb, cr),  # 4:2:0 as decoded
                       (y[:h - 3, :w - 5], cb[:(h - 2) // 2, :(w - 4) // 2],
                        cr[:(h - 2) // 2, :(w - 4) // 2]),  # odd sizes
                       (y[::2], cb, cr),  # 4:2:2
                       (y, None, None)):  # grey
            planes = tuple(None if t is None else t.contiguous()
                           for t in planes)
            got = image_io.ycc_to_bgr(*planes).cpu()
            want = image_io.ycc_to_bgr_plain(*(
                None if t is None else t.cpu() for t in planes))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"ycc_to_bgr kernel != plain on {name} "
                                     f"{tuple(planes[0].shape)}: {bad} bytes")
            cases += 1
    return cases


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

    def t(a):  # the image batch is on the card already
        if isinstance(a, torch.Tensor):
            return a.to(dev)
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
    launched. Then the twelve tile probes and ``p4`` are held against
    their plain versions at their ragged shapes
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
    rows["p3"]["repair_cases"] = check_p3_repair(device)
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


# the probes held at their ragged shapes: every tile probe, and p4
RAGGED_PROBES = ("k1", "k2", "k3", "k4", "k5", "ka", "kb", "kc", "kd", "ke",
                 "kf", "kg", "p4")


def check_ragged_probes(device):
    """The twelve tile probes at ``probes.RAGGED_GEOMETRY``, the edges of
    their kernels (45 pixels a tile, C = 24, O = 6: float stores of the
    broadcast), on ``tools/probe_dcn.py``'s three inputs, and ``p4`` at
    ``probes.RAGGED_P4`` (K = 24 padded to 32, N = 20 masked), each held
    against its plain version within its ``rtol`` (``k2`` and ``ka``
    bitwise); raises on a mismatch.
    Called after the probe path's launch counts are read, so these launches
    are not counted there. Returns each kernel's largest relative error."""
    geom = probes.RAGGED_GEOMETRY
    worst = {}
    for name in RAGGED_PROBES:
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


def check_p3_repair(device):
    """``p3`` held bitwise (int32 bits) against its plain version outside
    the probe path's counts: the script's input, a length that is not a
    multiple of 4 (2047), an x off 16 bytes, and a NaN (zeros) and a -inf
    (the saturating int32 cast) among ones. Returns the cases held."""
    ones = torch.ones(2048, device=device)
    ragged = torch.from_numpy(np.random.RandomState(SEED).randn(2048).astype(
        np.float32)).to(device) + 0.7
    nan, minus_inf = ones.clone(), ones.clone()
    nan[700] = float("nan")
    minus_inf[1024] = float("-inf")
    cases = {"script": ones.view(16, 128), "ragged 2047": ragged[:2047],
             "off 16 bytes": ragged[1:], "nan": nan, "-inf": minus_inf}
    for label, x in cases.items():
        got, want = probes.probe_p3(x), probes.probe_p3_plain(x)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"p3 differs from its plain version on "
                                 f"{label}")
        if label == "nan" and bool(got.any()):
            raise AssertionError("p3 on a NaN input is not all zeros")
    log(f"  p3 bitwise against plain on: {', '.join(cases)}")
    return list(cases)


def tiny_root(tmp: str, src: str = None, splits=None) -> str:
    """A DATASET.ROOT in ``tmp`` whose annotation files hold the first
    ``splits`` images of each split (default ``TINY_SPLITS``, the
    rehearsal's handful) of the nuScenes directory ``src`` (default the
    repo's, ``DATA_ROOT``); images, point clouds and tables are links."""
    src = src or os.path.join(DATA_ROOT, "nuscenes")
    dst = os.path.join(tmp, "data", "nuscenes")
    os.makedirs(os.path.join(dst, "annotations"))
    for name in ("samples", "v1.0-mini"):
        os.symlink(os.path.join(src, name), os.path.join(dst, name))
    for name in ("radar_pc", "lidar_pc"):
        os.symlink(os.path.join(src, "annotations", name),
                   os.path.join(dst, "annotations", name))
    for split, n in (splits or TINY_SPLITS).items():
        with open(os.path.join(src, "annotations", f"{split}.json")) as f:
            coco = json.load(f)
        coco["images"] = coco["images"][:n]
        ids = {im["id"] for im in coco["images"]}
        coco["annotations"] = [a for a in coco["annotations"]
                               if a["image_id"] in ids]
        with open(os.path.join(dst, "annotations", f"{split}.json"),
                  "w") as f:
            json.dump(coco, f)
    return os.path.join(tmp, "data")


def split_size(root: str, split: str) -> int:
    with open(os.path.join(root, "nuscenes", "annotations",
                           f"{split}.json")) as f:
        return len(json.load(f)["images"])


SUBMISSION = "results_nuscenes_det_mini_val.json"
EVAL_OUTPUT = "nuscenes_eval_det_output_mini_val"


def scoring_record(trainer) -> dict:
    """What the validation just run by ``trainer`` scored: the images of its
    submission, its ``range_all`` mAP and NDS as ``Trainer.summaries`` holds
    them and the NDS of the ``metrics_summary.json`` it wrote (None where
    it wrote none)."""
    out = trainer.config.OUTPUT_DIR
    rec = {"tokens": None, "map": None, "nds": None, "nds_file": None}
    if os.path.exists(os.path.join(out, SUBMISSION)):
        with open(os.path.join(out, SUBMISSION)) as f:
            rec["tokens"] = sorted(json.load(f)["results"])
    if trainer.summaries is not None:
        rec["map"] = trainer.summaries["range_all"]["mean_ap"]
        rec["nds"] = trainer.summaries["range_all"]["nd_score"]
    summary = os.path.join(out, EVAL_OUTPUT, "range_all",
                           "metrics_summary.json")
    if os.path.exists(summary):
        with open(summary) as f:
            rec["nds_file"] = json.load(f)["nd_score"]
    return rec


def main_py_path(device, rehearsal: bool, card):
    """Phase 16: the port's ``main.py`` on the repo's nuScenes-format data
    (``DATA_ROOT``), as a user runs it: 2 epochs of training at the
    campaign's settings in bf16 (the first frozen), validated with NDS after
    each, then ``EVAL True`` on the last checkpoint. Images are decoded on
    ``device`` (nvJPEG on the card, cv2 in the rehearsal). Checks that every
    train image of each epoch and every val image of each validation went
    through the decoder, that a checkpoint was written before each
    validation, that each validation launched the bf16 DCN forward kernel
    once per node per batch and no other DCN kernel (the first validation
    of each run also decodes its loader's first batch once more and runs
    one more forward: the FLOPs report, ``Trainer.profile``), and that each scored
    every val image itself: the previous submission and summaries are
    cleared before it (``Trainer.val`` logs a scoring failure and goes on),
    and after it its submission holds the val images, the EVAL run's the
    same, and ``Trainer.summaries`` and its ``metrics_summary.json`` give
    one finite NDS in [0, 1]. Returns its report."""
    real_val = Trainer.val
    vals = []

    def counted_val(self, loader=None):
        out = self.config.OUTPUT_DIR
        ckpts = os.path.join(out, "ckpts")
        record = {"ckpts": sorted(os.listdir(ckpts))
                  if os.path.isdir(ckpts) else []}
        # Trainer.val logs a scoring failure and goes on: clear what an
        # earlier validation scored, so that each is read from its own
        if os.path.exists(os.path.join(out, SUBMISSION)):
            os.remove(os.path.join(out, SUBMISSION))
        shutil.rmtree(os.path.join(out, EVAL_OUTPUT), ignore_errors=True)
        self.summaries = None
        record["cost_report"] = not self._cost_reported
        reset_launch_counts()
        decoded = image_io.decode_jpeg.launches
        results = real_val(self, loader)
        record["launches"] = launch_counts()
        record["decoded"] = image_io.decode_jpeg.launches - decoded
        record["results"] = len(results)
        record["seconds"] = self.val_seconds[-1]
        record.update(scoring_record(self))
        vals.append(record)
        return results

    with tempfile.TemporaryDirectory(prefix="cfd_smoke_main_") as tmp:
        root = tiny_root(tmp) if rehearsal else DATA_ROOT
        n_train = split_size(root, "mini_train")
        n_val = split_size(root, "mini_val")
        opts = (["--device", device, "DATASET.ROOT", repr(root + "/"),
                 "OUTPUT_DIR", repr(tmp)] + CAMPAIGN_OPTS + MAIN_PY_CUTS
                + (TINY_OPTS if rehearsal else []))
        Trainer.val = counted_val
        try:
            decoded = image_io.decode_jpeg.launches
            converted = image_io.ycc_to_bgr.launches
            t0 = time.perf_counter()
            trainer = cfd_main.main(opts + ["NAME", "smoke_train"])
            train_s = time.perf_counter() - t0
            decoded_train = image_io.decode_jpeg.launches - decoded
            converted = image_io.ycc_to_bgr.launches - converted
            ckpt = os.path.join(trainer.config.OUTPUT_DIR, "ckpts",
                                "model_last.pt")
            t0 = time.perf_counter()
            ev = cfd_main.main(opts + ["NAME", "smoke_eval", "EVAL", "True",
                                       "MODEL.LOAD_DIR", repr(ckpt)])
            eval_s = time.perf_counter() - t0
        finally:
            Trainer.val = real_val
        cfg = trainer.config
        epochs = int(cfg.TRAIN.EPOCHS)
        n_nodes = sum(isinstance(m, DeformConvNode)
                      for m in trainer.model.modules())
        batches = -(-n_val // int(cfg.TEST.BATCH_SIZE))
        peeked = min(int(cfg.TEST.BATCH_SIZE), n_val)  # the cost report's
        if (not rehearsal
                and decoded_train != epochs * (n_train + n_val) + peeked):
            raise AssertionError(f"the train run decoded {decoded_train} "
                                 f"images on the card, expected {epochs} x "
                                 f"({n_train} + {n_val}) + {peeked}")
        if converted != decoded_train:
            raise AssertionError(f"the train run decoded {decoded_train} "
                                 f"images and launched ycc_to_bgr "
                                 f"{converted} times")
        if len(vals) != epochs + 1:
            raise AssertionError(f"{len(vals)} validations, expected one per "
                                 f"epoch and one EVAL")
        for i, rec in enumerate(vals):
            if rec["results"] != n_val:
                raise AssertionError(f"validation {i} gave results for "
                                     f"{rec['results']} of {n_val} images")
            if rec["tokens"] is None or len(rec["tokens"]) != n_val:
                raise AssertionError(f"validation {i} wrote no submission of "
                                     f"{n_val} val images")
            if rec["tokens"] != vals[0]["tokens"]:
                raise AssertionError(f"validation {i} scored other images "
                                     f"than validation 0")
            nds = rec["nds"]
            if nds is None or not (math.isfinite(nds) and 0.0 <= nds <= 1.0):
                raise AssertionError(f"validation {i} scored no NDS in [0, 1]"
                                     f": {nds}")
            if rec["nds_file"] != nds:
                raise AssertionError(f"validation {i}: metrics_summary.json "
                                     f"says NDS {rec['nds_file']}, the "
                                     f"Trainer {nds}")
            extra = 1 if rec["cost_report"] else 0
            if not rehearsal and rec["decoded"] != n_val + extra * peeked:
                raise AssertionError(f"validation {i} decoded "
                                     f"{rec['decoded']} images on the card, "
                                     f"expected {n_val} + {extra * peeked}")
            want = {**{k: 0 for k in rec["launches"]},
                    "dcn_fwd_bf16": (0 if rehearsal
                                     else n_nodes * (batches + extra))}
            if rec["launches"] != want:
                raise AssertionError(f"validation {i} launched "
                                     f"{rec['launches']}, expected {want}")
        for rec in vals:
            rec["images_scored"] = len(rec.pop("tokens"))
        for epoch, rec in enumerate(vals[:epochs]):
            if f"model_{epoch}.pt" not in rec["ckpts"]:
                raise AssertionError(f"no checkpoint of epoch {epoch} before "
                                     f"its validation: {rec['ckpts']}")
        frozen = [st["frozen"] for st in trainer.steps]
        per_epoch = n_train // int(cfg.TRAIN.BATCH_SIZE)
        if frozen != [True] * per_epoch + [False] * per_epoch:
            raise AssertionError(f"steps frozen {frozen}, expected "
                                 f"{per_epoch} frozen then {per_epoch} not")
        # the decoder and the warp alone, per image, on the val images
        val_ds = ev.dataset_val
        paths = [os.path.join(val_ds.img_dir, val_ds.coco.load_imgs(i)[0][
            "file_name"]) for i in val_ds.images]
        t0 = time.perf_counter()
        imgs = [read_image(path, device) for path in paths]
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
        in_h, in_w = cfg.MODEL.INPUT_SIZE
        h, w = imgs[0].shape[:2]
        trans = get_affine_transform(np.array([w / 2, h / 2], np.float32),
                                     max(h, w), 0, (in_w, in_h))
        t0 = time.perf_counter()
        for img in imgs:
            warp_image(img, trans, (in_w, in_h))
        warp_ms = 1e3 * (time.perf_counter() - t0) / len(imgs)
        cpu_decoder = (None if rehearsal
                       or importlib.util.find_spec("cv2") is None
                       else decode_vs_cpu_decoder(paths, imgs))
    raw_warp_ms = raw_frame_warp_ms(1 if rehearsal else 3)
    steps = {ph: [1e3 * st["seconds"] for st in trainer.steps
                  if st["frozen"] == (ph == "frozen")]
             for ph in ("frozen", "unfrozen")}
    report = {
        "images": {"train": n_train, "val": n_val}, "epochs": epochs,
        "dcn_nodes": n_nodes, "validations": vals,
        "map": [r["map"] for r in vals], "nds": [r["nds"] for r in vals],
        "ms_per_step": {ph: statistics.mean(v) for ph, v in steps.items()},
        "ms_steps": steps, "decode_ms_per_image": decode_ms,
        "warp_ms_per_image": warp_ms, "cpu_decoder": cpu_decoder,
        "raw_frame_warp_ms_per_batch": raw_warp_ms, "train_run_s": train_s,
        "eval_run_s": eval_s, "decoded_train_run": decoded_train,
    }
    where = "" if rehearsal else f" on {card}"
    log(f"main.py: {epochs} epochs on {n_train} train images (batch "
        f"{cfg.TRAIN.BATCH_SIZE}, {cfg.MODEL.INPUT_SIZE[0]}x"
        f"{cfg.MODEL.INPUT_SIZE[1]}, bf16, {n_nodes} DCN nodes), "
        f"validated on {n_val} after each, then EVAL; "
        f"{decoded_train} images decoded in the train run")
    log("  " + ", ".join(
        f"{'EVAL' if i == epochs else f'epoch {i}'} mAP {r['map']:.4f} NDS "
        f"{r['nds']:.4f}" for i, r in enumerate(vals))
        + f" (seeded weights: plumbing and speed only){where}")
    log(f"  ms per train step frozen {report['ms_per_step']['frozen']:.1f}, "
        f"unfrozen {report['ms_per_step']['unfrozen']:.1f}; decode "
        f"{decode_ms:.3f} ms and warp {warp_ms:.3f} ms per image; val "
        + ", ".join(f"{r['seconds']['forward']:.2f} s + scoring "
                    f"{r['seconds']['scoring']:.2f} s" for r in vals)
        + f"; train run {train_s:.1f} s (WORKERS "
        f"{cfg.WORKERS}; the serial Loader's: {SERIAL_LOADER_TRAIN_RUN_S} s),"
        f" EVAL run {eval_s:.1f} s{where}")
    if cpu_decoder is not None:
        log(f"  the val images decoded by the CPU decoder (cv2): "
            f"{cpu_decoder['ms_per_image']:.3f} ms per image; the card's "
            f"decode {cpu_decoder['pixel_max']} levels from it at most, "
            f"{cpu_decoder['pixel_mean']:.4f} on average, "
            f"{100 * cpu_decoder['pixel_equal']:.2f}% of values equal{where}")
    log(f"  Detector's warp of six raw {RAW_FRAME[1]}x{RAW_FRAME[0]} frames "
        f"to {SERVE_INPUT[1]}x{SERVE_INPUT[0]} (_warp_or_crop -> warp_image):"
        f" " + ", ".join(f"{t:.1f}" for t in raw_warp_ms)
        + f" ms a batch{where}")
    return report


def decode_vs_cpu_decoder(paths, imgs) -> dict:
    """The images at ``paths`` through the CPU decoder (cv2) against
    ``imgs``, the card's decode of them: per pixel, held to
    ``DECODE_PIXEL_TOL`` and ``DECODE_PIXEL_MEAN_TOL``; and the CPU
    decoder's time per image."""
    t0 = time.perf_counter()
    refs = [read_image(path, "cpu") for path in paths]
    ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    worst, total, equal, n = 0, 0, 0, 0
    for img, ref in zip(imgs, refs):
        d = np.abs(img.astype(np.int16) - ref)
        worst, total = max(worst, int(d.max())), total + int(d.sum())
        equal, n = equal + int((d == 0).sum()), n + d.size
    res = {"ms_per_image": ms, "pixel_max": worst, "pixel_mean": total / n,
           "pixel_equal": equal / n}
    if not (worst <= DECODE_PIXEL_TOL
            and res["pixel_mean"] <= DECODE_PIXEL_MEAN_TOL):
        raise AssertionError(f"the card's decode of {len(paths)} val images "
                             f"is {worst} levels at most and "
                             f"{res['pixel_mean']:.3f} on average from the "
                             f"CPU decoder's (limits {DECODE_PIXEL_TOL}, "
                             f"{DECODE_PIXEL_MEAN_TOL})")
    return res


def raw_frame_warp_ms(reps: int = 3) -> list:
    """ms for ``Detector``'s warp of six seeded raw ``RAW_FRAME`` camera
    frames to serving's ``SERVE_INPUT``: the scale of 1/2 takes
    ``_warp_or_crop``'s non-integer branch (``warp_image``); one time per
    rep."""
    rng = np.random.default_rng(SEED)
    h, w = RAW_FRAME
    in_h, in_w = SERVE_INPUT
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(6)]
    trans = get_affine_transform(np.array([w / 2, h / 2], np.float32),
                                 max(h, w), 0, (in_w, in_h))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for frame in frames:
            _warp_or_crop(frame, trans, in_h, in_w)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def probe_kernel_entries(rows):
    """The ``kernels`` line's entries of the sixteen probe kernels: launches
    on the probe path, and the script's own input at the scripts' geometry
    for the times and the bound (every input in ``per_case``): per call
    (``ms``, ``plain_ms``, ``library_ms``) and by device time alone
    (``device_ms``, ``library_device_ms``), beside ``launch_floor_ms``;
    the twelve tile probes and ``p4`` also their largest error at their
    ragged shapes; ``device_function``: the function of
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


# ------------------------------------------------- phase 17: serving files
SERVE_BATCH = 6  # cameras a batch
SERVE_BATCHES = 100  # timed batches of each serving mode, cycling the
# repo's 500 JPEGs: far past the stream's fill (prefetch workers + 1 = 7
# batches on an 8-core host, depth 8)
SERVE_WARM = 16  # untimed batches of each mode first, which fill both
SERVE_ROUNDS = 3  # the modes in turns, this many times
# (label, run_stream's arguments, or None for Detector.run)
SERVE_MODES = (("run", None), ("run_stream", {}),
               ("run_stream workers=1", {"workers": 1}))
CLI_IMAGES = 24
TTA_SCALES = "(0.75, 1.0, 1.25)"
DETECTIONS_RTOL = 1e-4  # run_stream vs run, and the two CLI runs, where
# not bitwise: of each quantity's largest magnitude
AUGMENT = {"rotate": 12.5, "scale": 1.17, "shift": (21.25, -9.5)}


def repo_jpegs(n: int = 0):
    """The first n of the repo's 448x256 camera JPEGs, by name (all of
    them for 0)."""
    paths = sorted(glob.glob(os.path.join(DATA_ROOT, "nuscenes", "samples",
                                          "CAM_FRONT", "*.jpg")))
    if len(paths) < max(n, 1):
        raise AssertionError(f"{len(paths)} repo JPEGs under {DATA_ROOT}, "
                             f"{n} needed")
    return paths[:n] if n else paths


def serving_batches(n: int, start: int = 0):
    """n batches of ``SERVE_BATCH`` repo JPEG paths from batch ``start`` on,
    cycling through all of them."""
    paths = repo_jpegs()
    return [[paths[((start + i) * SERVE_BATCH + j) % len(paths)]
             for j in range(SERVE_BATCH)] for i in range(n)]


def raw_frames(n: int):
    """n seeded raw ``RAW_FRAME`` camera frames (those of
    ``raw_frame_warp_ms``)."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, (*RAW_FRAME, 3), dtype=np.uint8)
            for _ in range(n)]


def serving_trans(h: int, w: int, out_hw, rotate=0.0, scale=1.0,
                  shift=(0.0, 0.0)):
    """The serving affine of an h x w frame to ``out_hw`` (H, W), with an
    optional rotation, scale and centre shift as the dataset augments."""
    center = np.array([w / 2 + shift[0], h / 2 + shift[1]], np.float32)
    return get_affine_transform(center, max(h, w) * scale, rotate,
                                (out_hw[1], out_hw[0]))


def warp_cases(device, rehearsal: bool):
    """(label, frames on ``device``, (n, 2, 3) affines, output (H, W)) of
    the warp checks: six raw frames to serving's input (decode scale 1),
    six repo JPEGs decoded on ``device`` to the same, those with a rotated,
    scaled and shifted affine as the dataset's augmentation draws, and a
    mixed-size batch."""
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = 2 if rehearsal else SERVE_BATCH
    raw = [dev(f) for f in raw_frames(n)]
    jpegs = [image_io.load_frame(p, device, SERVE_INPUT, False)[0]
             for p in repo_jpegs(n)]
    jpegs = [j if isinstance(j, torch.Tensor) else dev(j) for j in jpegs]
    rng = np.random.default_rng(SEED + 1)
    mixed = [raw[0], jpegs[0], dev(rng.integers(0, 256, (1600, 900, 3),
                                                dtype=np.uint8)),
             dev(rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))]
    cases = []
    for label, frames, kw in (
            (f"raw {RAW_FRAME[1]}x{RAW_FRAME[0]}", raw, {}),
            ("repo 448x256", jpegs, {}),
            ("repo 448x256 augmented", jpegs, AUGMENT),
            ("mixed sizes", mixed, {})):
        trans = np.stack([serving_trans(*f.shape[:2], SERVE_INPUT, **kw)
                          for f in frames])
        cases.append((label, frames, trans, SERVE_INPUT))
    return cases


def check_warp(device, rehearsal: bool):
    """Holds ``warp_affine`` bitwise against its plain version (on the
    card: the kernel; in the rehearsal the plain version against numpy
    ``warp_image``) on every ``warp_cases`` case; raises on any differing
    byte, counting them. Returns the rows."""
    rows = []
    for label, frames, trans, out_hw in warp_cases(device, rehearsal):
        inv = warp.inverse_matrices(trans)
        out = torch.empty((len(frames), *out_hw, 3), dtype=torch.uint8,
                          device=device)
        warp.warp_affine(frames, inv, out)
        bad = 0
        for i, f in enumerate(frames):
            got = out[i].cpu()
            if rehearsal:
                want = torch.from_numpy(warp_image(
                    f.numpy(), trans[i], (out_hw[1], out_hw[0])))
            else:
                want = warp.warp_affine_plain(f.cpu(), inv[i], out_hw)
            bad += int((got != want).sum())
        if bad:
            raise AssertionError(f"warp_affine on {label}: {bad} bytes "
                                 f"differ from its plain version")
        rows.append({"case": label, "images": len(frames),
                     "sizes": sorted({tuple(f.shape[:2]) for f in frames}),
                     "bytes_differing": bad})
    return rows


WARPED_PIXEL_TOL = DECODE_PIXEL_TOL + 1  # the card's warped decode against
# the CPU's: a bilinear weight sum keeps the decoders' bound, and rounding
# the two sums adds at most one level


def check_batch_images(det: Detector, rehearsal: bool):
    """Holds the ``image`` batch that ``det``'s ``load_data`` and
    ``pre_process`` write (on the card: nvJPEG, crops of the device frames
    and one ``warp_affine`` launch scattered into the batch) against the
    CPU path's (in the rehearsal, the CPU path against itself), on six
    repo JPEG paths and on a batch that mixes crops and warps of paths and
    arrays: bitwise against the CPU's ``pre_process``
    of the same decoded frames, and against the CPU's own decode (cv2,
    ``FAST_DECODE`` False) and ``warp_image`` within ``WARPED_PIXEL_TOL``
    and ``DECODE_PIXEL_MEAN_TOL`` (arrays, which no decoder touches,
    bitwise). Raises on a difference; returns the rows."""
    cfg = det.config.clone()
    if det.on_card:  # the card decodes in full whatever FAST_DECODE says
        cfg.defrost()
        cfg.TEST.FAST_DECODE = False
        cfg.freeze()
    cpu = Detector(cfg, device="cpu", model=det.model)  # pre-processes only
    in_h, in_w = cfg.MODEL.INPUT_SIZE
    # a frame two rows taller than the input maps to it by (0, -1): a crop
    if not np.allclose(serving_trans(in_h + 2, in_w, (in_h, in_w)),
                       [[1, 0, 0], [0, 1, -1]]):
        raise AssertionError("the crop frame's affine is no translation")
    rng = np.random.default_rng(SEED + 2)
    arr = lambda h, w: rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    paths = repo_jpegs(SERVE_BATCH)
    host = lambda im: im.cpu().numpy() if isinstance(im, torch.Tensor) else im
    rows = []
    for label, frames in (
            (f"{SERVE_BATCH} repo JPEG paths", paths),
            ("crops and warps", [arr(in_h + 2, in_w), paths[0],
                                 arr(*RAW_FRAME), paths[1], arr(720, 1280)])):
        warps = warp.warp_affine.launches
        imgs, scales = det.load_data(frames, return_scales=True)
        got = host(det.pre_process(imgs, None, None, scales)[0]["image"])
        launched = warp.warp_affine.launches - warps
        same = cpu.pre_process([host(im) for im in imgs], None, None,
                               scales)[0]["image"]
        bad = int((got != same).sum())
        ref_imgs, ref_scales = cpu.load_data(frames, return_scales=True)
        ref = cpu.pre_process(ref_imgs, None, None, ref_scales)[0]["image"]
        diff = np.abs(got.astype(np.int16) - ref)
        arrays = [i for i, f in enumerate(frames) if not isinstance(f, str)]
        row = {"case": label, "images": len(frames),
               "warp_launches": launched,
               "bytes_differing_same_frames": bad,
               "vs_cpu_decode_max": int(diff.max()),
               "vs_cpu_decode_mean": float(diff.mean()),
               "arrays_differing": int(diff[arrays].sum()) if arrays else 0}
        if (bad or scales != ref_scales or row["arrays_differing"]
                or row["vs_cpu_decode_max"] > WARPED_PIXEL_TOL
                or row["vs_cpu_decode_mean"] > DECODE_PIXEL_MEAN_TOL
                or launched != (0 if rehearsal else 1)):
            raise AssertionError(f"the batch of {label} against the CPU "
                                 f"path's: {row} (scales {scales}, CPU "
                                 f"{ref_scales})")
        rows.append(row)
    return rows


def grid_for(inv, src_hw, out_hw, device):
    """``grid_sample``'s normalized grid (align_corners False) of the
    inverse affines ``inv`` (n, 6) from out_hw to src_hw."""
    h, w = src_hw
    ys, xs = torch.meshgrid(torch.arange(out_hw[0], device=device),
                            torch.arange(out_hw[1], device=device),
                            indexing="ij")
    m = torch.as_tensor(inv, device=device)[:, :, None, None]
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    return torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)


def time_warp(device):
    """The warp of six raw frames to serving's input: the kernel per call
    and by device time alone, its plain version on the card, numpy
    ``warp_image`` on the host (what serving ran before), its bound
    (bytes read and written over 3.35 TB/s) and the yardstick
    ``grid_sample`` (bilinear, zero padding, float NCHW of the frames)."""
    frames = raw_frames(SERVE_BATCH)
    trans = np.stack([serving_trans(*RAW_FRAME, SERVE_INPUT)] * SERVE_BATCH)
    inv = warp.inverse_matrices(trans)
    srcs = [torch.from_numpy(f).to(device) for f in frames]
    out = torch.empty((SERVE_BATCH, *SERVE_INPUT, 3), dtype=torch.uint8,
                      device=device)
    call = lambda: warp.warp_affine(srcs, inv, out)
    plain = lambda: [warp.warp_affine_plain(s, m, SERVE_INPUT)
                     for s, m in zip(srcs, inv)]
    x = torch.stack(srcs).permute(0, 3, 1, 2).float().contiguous()
    grid = grid_for(inv, RAW_FRAME, SERVE_INPUT, device)
    library = lambda: F.grid_sample(x, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=False)
    row = {"frames": f"{SERVE_BATCH} x {RAW_FRAME[1]}x{RAW_FRAME[0]} -> "
                     f"{SERVE_INPUT[1]}x{SERVE_INPUT[0]}",
           "ms": time_one(call, TIMING_REPS), "device_ms": time_device(call),
           "plain_ms": time_one(plain, 3),
           "library_ms": time_one(library, TIMING_REPS),
           "library_device_ms": time_device(library, 20),
           "host_numpy_ms": raw_frame_warp_ms(3)}
    moved = sum(s.numel() for s in srcs) + out.numel()
    row["bound_ms"] = 1e3 * moved / PEAK_BYTES
    row["bytes"] = moved
    lib = library()
    want = torch.stack([torch.from_numpy(warp_image(
        f, trans[0], (SERVE_INPUT[1], SERVE_INPUT[0]))) for f in frames])
    row["library_max_level_diff"] = float((lib.permute(0, 2, 3, 1).cpu()
                                           - want.float()).abs().max())
    return row


def time_ycc(device):
    """``ycc_to_bgr``'s kernel on one repo JPEG's planes (448x256, 4:2:0):
    per call, by device time alone, its plain version on the card, and
    its bound."""
    data = np.fromfile(repo_jpegs(1)[0], np.uint8)
    planes = image_io.decode_planes(data, device)
    call = lambda: image_io.ycc_to_bgr(*planes)
    moved = sum(p.numel() for p in planes) + 3 * planes[0].numel()
    return {"image": "448x256 4:2:0", "ms": time_one(call, TIMING_REPS),
            "device_ms": time_device(call),
            "plain_ms": time_one(lambda: image_io.ycc_to_bgr_plain(*planes),
                                 TIMING_REPS),
            "bound_ms": 1e3 * moved / PEAK_BYTES, "bytes": moved}


def serving_counts():
    return {"decode": image_io.decode_jpeg.launches,
            "ycc_to_bgr": image_io.ycc_to_bgr.launches,
            "warp_affine": warp.warp_affine.launches, **launch_counts()}


def reset_serving_counts():
    image_io.decode_jpeg.launches = 0
    image_io.ycc_to_bgr.launches = 0
    warp.warp_affine.launches = 0
    reset_launch_counts()


def flat_results(results):
    """{img_id: [items]} -> {key: float64 array of every item's value}."""
    out = {}
    for img_id in sorted(results):
        for it in results[img_id]:
            for k, v in it.items():
                out.setdefault(k, []).append(np.ravel(np.asarray(
                    v, np.float64)))
    return {k: np.concatenate(v) for k, v in out.items()}


def same_detections(got, want, what: str) -> bool:
    """Raises unless the two result dicts hold the same images, counts and
    classes, and every value within ``DETECTIONS_RTOL`` of its key's
    largest magnitude; returns whether they are bitwise equal."""
    if ({k: len(v) for k, v in got.items()}
            != {k: len(v) for k, v in want.items()}):
        raise AssertionError(f"{what}: other images or counts")
    a, b = flat_results(got), flat_results(want)
    if sorted(a) != sorted(b) or not np.array_equal(a["class"], b["class"]):
        raise AssertionError(f"{what}: other keys or classes")
    bitwise = True
    for k in a:
        scale = max(float(np.abs(b[k]).max()), 1e-30) if b[k].size else 1.0
        rel = float(np.abs(a[k] - b[k]).max()) / scale if a[k].size else 0.0
        if not rel <= DETECTIONS_RTOL:
            raise AssertionError(f"{what}: {k} off by {rel:.3e} of its "
                                 f"largest magnitude")
        bitwise &= bool(np.array_equal(a[k], b[k]))
    return bitwise


def serving_detector(device, rehearsal: bool, extra=()):
    """The bf16 Detector at the full width of Centerfusion_Middle (the
    rehearsal at 64x128), seeded weights, BatchNorm calibrated on six
    synthetic frames."""
    opts = MAIN_PATH_OPTS + (["MODEL.INPUT_SIZE", "(64, 128)"] if rehearsal
                             else []) + list(extra)
    det = Detector(load_config(opts=opts, num_classes=10), device=device)
    seeded_weights(det.model, SEED)
    calibrate_batchnorm(det, synthetic_frames(
        2 if rehearsal else SERVE_BATCH, *((72, 128) if rehearsal
                                           else (450, 800)), seed=SEED))
    return det


def tta_detector(det: Detector, extra) -> Detector:
    """A Detector of ``det``'s config with ``extra`` overrides, serving
    ``det``'s module (no second copy on the card)."""
    cfg = det.config.clone()
    cfg.defrost()
    cfg.merge_from_list(list(extra))
    cfg.freeze()
    return Detector(cfg, device=det.device, model=det.model)


def node_batches(model):
    """A list that each DCN node's forward appends its batch to, and the
    hooks' handles."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(int(args[0].shape[0])))
        for m in model.modules() if isinstance(m, DeformConvNode)]
    return seen, hooks


def run_cli(args, rehearsal: bool):
    """The inference CLI on ``args``: on the card ``python -m
    centerfusiondetect3d_tpu_torch.inference`` from the checkout, in the
    rehearsal ``inference.main`` with ``--device cpu`` in this process
    (where the hermetic test hides the JAX stack). Returns (seconds, its
    last line of output)."""
    t0 = time.perf_counter()
    if rehearsal:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cfd_inference.main(args + ["--device", "cpu"])
        return time.perf_counter() - t0, out.getvalue().strip().splitlines()[-1]
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "centerfusiondetect3d_tpu_torch.inference",
           *args]
    proc = subprocess.run(cmd, cwd=root, env={**os.environ,
                                              "PYTHONPATH": root},
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"inference CLI {' '.join(args[:6])} ... "
                             f"exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return (time.perf_counter() - t0,
            proc.stdout.strip().splitlines()[-1])


def serving_files_path(device, rehearsal: bool, card):
    """Phase 17: serving image files as users run it. The warp kernel
    against its plain version (bitwise) and timed; the card's serving
    batch against the CPU path's (``check_batch_images``);
    ``Detector.run`` and ``Detector.run_stream`` (with the derived and
    with one worker) in turns on ``SERVE_BATCHES`` batches of six repo
    JPEG paths in bf16, each counted (a decode and a colour conversion per
    image, one warp launch a batch, the bf16 DCN once per node a batch,
    nothing else), their detections against the first run's, frames/s and
    stages; flip and multi-scale
    TTA on one batch each; the inference CLI on a folder, serial and
    streamed. Returns its report."""
    where = "" if rehearsal else f" on {card}"
    report = {"warp_checks": check_warp(device, rehearsal)}
    log(f"warp_affine {'plain vs warp_image' if rehearsal else 'kernel vs plain'}"
        f": bitwise on " + ", ".join(f"{r['case']} ({r['images']} images)"
                                     for r in report["warp_checks"]))
    if not rehearsal:
        report["warp_timing"] = t = time_warp(device)
        log(f"  warp {t['frames']}: kernel {t['device_ms']:.4f} ms by device "
            f"time alone ({t['ms']:.4f} ms a call), bound {t['bound_ms']:.4f} "
            f"ms ({t['bytes'] / 1e6:.1f} MB), plain on the card "
            f"{t['plain_ms']:.2f} ms, numpy warp_image on the host "
            + "/".join(f"{v:.1f}" for v in t["host_numpy_ms"])
            + f" ms, grid_sample {t['library_device_ms']:.4f} ms device "
            f"alone ({t['library_ms']:.4f} a call; up to "
            f"{t['library_max_level_diff']:.2f} levels off){where}")
        report["ycc_timing"] = y = time_ycc(device)
        log(f"  ycc_to_bgr {y['image']}: {y['device_ms']:.5f} ms by device "
            f"time alone ({y['ms']:.4f} a call), bound {y['bound_ms']:.5f} "
            f"ms, plain {y['plain_ms']:.3f} ms{where}")

    det = serving_detector(device, rehearsal)
    report["batch_checks"] = checks = check_batch_images(det, rehearsal)
    for r in checks:
        log(f"the serving batch of {r['case']} ({r['images']} frames, "
            f"{r['warp_launches']} warp launch) against the CPU path's: "
            f"bitwise on the same decoded frames; within "
            f"{r['vs_cpu_decode_max']} levels ({r['vs_cpu_decode_mean']:.4f}"
            f" on average; limits {WARPED_PIXEL_TOL}, "
            f"{DECODE_PIXEL_MEAN_TOL}) of the CPU's cv2 decode and "
            f"warp_image, arrays bitwise{where}")
    n_nodes = sum(isinstance(m, DeformConvNode) for m in det.model.modules())
    n_batches = 2 if rehearsal else SERVE_BATCHES
    n_rounds = 1 if rehearsal else SERVE_ROUNDS
    batches = serving_batches(n_batches, start=SERVE_WARM)

    def serve(kw, items):
        if kw is None:
            return [det.run(b)["results"] for b in items]
        return [r["results"] for r in det.run_stream(
            iter([(b, None, None) for b in items]), **kw)]

    for _, kw in SERVE_MODES:  # warm-up: fills the stream's queue and depth
        serve(kw, serving_batches(2 if rehearsal else SERVE_WARM))
    per_batch = {"decode": SERVE_BATCH, "ycc_to_bgr": SERVE_BATCH,
                 "warp_affine": 1, "dcn_fwd_bf16": n_nodes}
    runs = {label: {"frames_per_s": [], "wall_s": [], "stages": []}
            for label, _ in SERVE_MODES}
    ref, bitwise = None, True
    for k in range(n_rounds):
        for label, kw in SERVE_MODES:
            det.stage_stats(reset=True)
            reset_serving_counts()
            t0 = time.perf_counter()
            results = serve(kw, batches)
            wall = time.perf_counter() - t0
            counts = serving_counts()
            want = {key: 0 for key in counts}
            if not rehearsal:
                want.update({key: v * n_batches
                             for key, v in per_batch.items()})
            if counts != want or len(results) != n_batches:
                raise AssertionError(f"{label} on {n_batches} batches of "
                                     f"JPEG paths gave {len(results)} "
                                     f"results, launched {counts}, "
                                     f"expected {want}")
            if ref is None:  # the first run: finite, then the reference
                ref = results
                runs[label]["detections"] = sum(
                    check_results({"results": r}, SERVE_BATCH)
                    for r in results)
            else:
                bitwise &= all([same_detections(
                    got, exp, f"{label} round {k + 1} batch {i} vs run")
                    for i, (got, exp) in enumerate(zip(results, ref))])
            r = runs[label]
            r["counts"] = counts
            r["frames_per_s"].append(SERVE_BATCH * n_batches / wall)
            r["wall_s"].append(wall)
            r["stages"].append(st := det.stage_stats())
            waits = "".join(f", {w} {st[w]:.2f}" for w in (
                "get_wait", "put_wait", "result_wait") if w in st)
            log(f"round {k + 1} {label} on {n_batches} batches of "
                f"{SERVE_BATCH} repo JPEG paths (bf16, "
                f"{det.config.MODEL.INPUT_SIZE[0]}x"
                f"{det.config.MODEL.INPUT_SIZE[1]}): "
                f"{r['frames_per_s'][-1]:.2f} frames/s ({wall:.2f} s); "
                f"decode {st.get('decode', 0):.3f}, warp "
                f"{st.get('warp', 0):.3f} ms an image, dispatch "
                f"{st.get('dispatch', 0):.2f}, fetch {st.get('fetch', 0):.2f}"
                f"{waits} ms a batch{where}")
    log(f"  launches in each: {runs['run']['counts']}; every mode's "
        f"detections equal the first run's batch by batch and in order "
        f"({'bitwise' if bitwise else f'within {DETECTIONS_RTOL}'}), "
        f"{runs['run']['detections']} detections a run, all finite")
    fps = {label: r["frames_per_s"] for label, r in runs.items()}
    for label in fps:
        runs[label]["median_frames_per_s"] = statistics.median(fps[label])
        if label != "run":
            runs[label]["over_run"] = [
                s / r for s, r in zip(fps[label], fps["run"])]
    log("  frames/s over the rounds in turns: " + "; ".join(
        f"{label} " + " / ".join(f"{v:.2f}" for v in fps[label])
        + (" (" + " / ".join(f"{v:.3f}" for v in runs[label]["over_run"])
           + " of run's in the same round)" if label != "run" else "")
        for label in fps) + where)
    report.update(serving=runs, stream_bitwise=bitwise, dcn_nodes=n_nodes)

    # TTA: flip (the DCN at twice the batch), multi-scale (three sizes)
    tta = {}
    for name, extra, n_launch, node_batch in (
            ("flip", ["TEST.FLIP_TEST", "True"], n_nodes, 2 * SERVE_BATCH),
            ("multi_scale", ["TEST.MULTI_SCALE", TTA_SCALES], 3 * n_nodes,
             SERVE_BATCH)):
        tdet = tta_detector(det, extra)
        seen, hooks = node_batches(det.model)
        reset_serving_counts()
        try:
            ret = tdet.run(batches[0])
        finally:
            for h in hooks:
                h.remove()
        counts = serving_counts()
        if not rehearsal and counts["dcn_fwd_bf16"] != n_launch:
            raise AssertionError(f"{name}: dcn_fwd_bf16 launched "
                                 f"{counts['dcn_fwd_bf16']}, expected "
                                 f"{n_launch}")
        if set(seen) != {node_batch} or len(seen) != n_launch:
            raise AssertionError(f"{name}: DCN node batches {seen}")
        tta[name] = {"detections": check_results(ret, SERVE_BATCH),
                     "dcn_fwd_bf16": counts["dcn_fwd_bf16"],
                     "node_batch": node_batch,
                     "sizes": [list(d.config.MODEL.INPUT_SIZE)
                               for d in tdet._scaled.values()]}
        log(f"{name} TTA on one batch: {tta[name]['detections']} detections, "
            f"all finite; dcn_fwd_bf16 launched {counts['dcn_fwd_bf16']} "
            f"times at batch {node_batch}"
            + (f"; scaled inputs {tta[name]['sizes']}" if tta[name]["sizes"]
               else "") + where)
    report["tta"] = tta

    # the CLI on a folder of repo JPEGs (4 in the rehearsal), serial (with
    # --save-dir) and streamed, on one checkpoint of the served weights
    with tempfile.TemporaryDirectory(prefix="cfd_smoke_cli_") as tmp:
        folder = os.path.join(tmp, "frames")
        os.makedirs(folder)
        for p in repo_jpegs(4 if rehearsal else CLI_IMAGES):
            os.symlink(p, os.path.join(folder, os.path.basename(p)))
        ckpt = save_checkpoint(os.path.join(tmp, "ckpt"), det.model, None, 0)
        del det
        if not rehearsal:
            torch.cuda.empty_cache()
        opts = MAIN_PATH_OPTS + (["MODEL.INPUT_SIZE", "(64, 128)"]
                                 if rehearsal else [])
        cli = {}
        for mode in ("serial", "stream"):
            out = os.path.join(tmp, mode)
            args = (["--input", folder, "--load", ckpt, "--save-dir", out]
                    + (["--stream"] if mode == "stream"
                       else ["--show-attention"]) + opts)
            seconds, last = run_cli(args, rehearsal)
            with open(os.path.join(out, "results.json")) as f:
                results = json.load(f)
            cli[mode] = {"seconds": seconds, "last_line": last,
                         "results": results, "files": sorted(os.listdir(out))}
        names = sorted(os.listdir(folder))
        for mode, r in cli.items():
            if sorted(r["results"]) != names or not all(r["results"].values()):
                raise AssertionError(f"CLI {mode}: results for "
                                     f"{len(r['results'])} of {len(names)}")
        drawn = [f for f in cli["serial"]["files"] if f.endswith("_det.jpg")]
        overlays = [f for f in cli["serial"]["files"] if "_att_" in f]
        if len(drawn) != len(names) or len(overlays) != 2 * len(names):
            raise AssertionError(f"CLI serial --save-dir drew {len(drawn)} "
                                 f"of {len(names)} frames and "
                                 f"{len(overlays)} attention overlays")
        if cli["stream"]["files"] != ["results.json"]:
            raise AssertionError(f"CLI --stream --save-dir wrote "
                                 f"{cli['stream']['files']}")
        cli_bitwise = same_detections(
            {i: cli["stream"]["results"][n] for i, n in enumerate(names)},
            {i: cli["serial"]["results"][n] for i, n in enumerate(names)},
            "CLI --stream vs serial")
    for mode, r in cli.items():
        log(f"inference CLI ({mode}) on {len(names)} repo JPEGs: "
            f"{r['seconds']:.1f} s{where}; {r['last_line'][:160]}")
        del r["results"]
    log(f"  the streamed CLI wrote the serial CLI's detections "
        f"({'bitwise' if cli_bitwise else f'within {DETECTIONS_RTOL}'}); "
        f"the serial one {len(drawn)} _det.jpg frames, {len(overlays)} "
        f"--show-attention overlays (depthMap, pc_hm) and results.json")
    report["cli"] = cli
    report["cli_bitwise"] = cli_bitwise
    return report


# ------------------------------------------------ phase 18: the training run
REHEARSE_EPOCHS = 2
LOADER_BATCHES = 8  # batches held bitwise and timed per thread count
LOADER_THREADS = (1, 2, 4)
PROFILE_SPLITS = {"mini_train": 32, "mini_val": 4}  # the traced epoch's
CONVERTED_SPLITS = ("mini_train", "mini_val")


def check_converter(tmp: str) -> dict:
    """18a: the port's converter on a copy of the repo's raw tables and
    samples: its annotations must equal the committed ones (parsed), and
    every radar and lidar ``.bin`` the committed one bytewise. Returns the
    copy's nuScenes directory and the seconds."""
    src = os.path.join(DATA_ROOT, "nuscenes")
    root = os.path.join(tmp, "converted", "nuscenes")
    for name in ("v1.0-mini", "samples"):
        shutil.copytree(os.path.join(src, name), os.path.join(root, name))
    t0 = time.perf_counter()
    for split in CONVERTED_SPLITS:
        export_split(root, split, verbose=False)
    seconds = time.perf_counter() - t0
    counts = {}
    for split in CONVERTED_SPLITS:
        with open(os.path.join(root, "annotations", f"{split}.json")) as f:
            got = json.load(f)
        with open(os.path.join(src, "annotations", f"{split}.json")) as f:
            want = json.load(f)
        if got != want:
            raise AssertionError(f"the converter's {split}.json differs from "
                                 "the committed one")
        counts[split] = {"images": len(got["images"]),
                         "annotations": len(got["annotations"])}
    n_bins = 0
    for kind in ("radar_pc", "lidar_pc"):
        want_dir = os.path.join(src, "annotations", kind)
        for cam in sorted(os.listdir(want_dir)):
            names = sorted(os.listdir(os.path.join(want_dir, cam)))
            got_names = sorted(os.listdir(os.path.join(
                root, "annotations", kind, cam)))
            if got_names != names:
                raise AssertionError(f"the converter wrote other {kind} "
                                     f"files for {cam}")
            for name in names:
                with open(os.path.join(want_dir, cam, name), "rb") as f, \
                        open(os.path.join(root, "annotations", kind, cam,
                                          name), "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"{kind}/{cam}/{name} differs "
                                             "from the committed file")
                n_bins += 1
    return {"root": root, "seconds": seconds, "splits": counts,
            "bins": n_bins}


def check_native_kernels() -> dict:
    """18b: the C++ host kernels built and held bitwise against their numpy
    versions: the paint on seeded boxes (one-hot and not, past every edge),
    the splats, and the warp (``warp_image``) on seeded 448x256 frames to
    224x128 under the dataset's augmentation (shifted, scaled, rotated,
    flipped); returns the build seconds, the cases and the warp's ms
    against numpy's."""
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    cases = 0
    for h, w, c, n in ((32, 56, 3, 200), (112, 200, 3, 1000),
                       (32, 56, 180, 300)):
        boxes = np.zeros((n, 4), np.int32)
        boxes[:, 0] = rng.integers(-4, h + 2, n)
        boxes[:, 1] = boxes[:, 0] + rng.integers(-1, 12, n)
        boxes[:, 2] = rng.integers(-4, w + 2, n)
        boxes[:, 3] = boxes[:, 2] + rng.integers(-1, 12, n)
        values = rng.standard_normal((n, 3)).astype(np.float32)
        got, want = (np.zeros((h, w, c), np.float32) for _ in range(2))
        if c == 3:
            native.paint_rects(got, boxes, values)
            native.paint_rects_plain(want, boxes, values)
        else:
            layer = rng.integers(0, c // 3, n)
            channels = np.stack([layer, layer + c // 3, layer + 2 * (c // 3)],
                                axis=1)
            native.paint_rects_channels(got, boxes, values, channels)
            native.paint_rects_channels_plain(want, boxes, values, channels)
        if not np.array_equal(got, want):
            raise AssertionError(f"native paint differs from numpy at "
                                 f"{(h, w, c, n)}")
        cases += 1
    centers = np.stack([rng.uniform(-5, 61, 40), rng.uniform(-5, 37, 40)],
                       axis=1).astype(np.float32)
    radii = rng.integers(0, 8, (40, 2)).astype(np.int32)
    got, want = (np.zeros((32, 56), np.float32) for _ in range(2))
    native.splat_gaussians(got, centers, radii)
    native.splat_gaussians_plain(want, centers, radii)
    if not np.array_equal(got, want):
        raise AssertionError("native splat_gaussians differs from plain")
    cases += 1
    warp_s = {"native": 0.0, "numpy": 0.0}
    for i in range(8):
        img = rng.integers(0, 256, (256, 448, 3), dtype=np.uint8)
        center = np.array([224 + rng.uniform(-60, 60),
                           128 + rng.uniform(-40, 40)], np.float32)
        trans = get_affine_transform(center, 448 * rng.uniform(0.6, 1.4),
                                     rng.uniform(-20, 20) if i % 2 else 0.0,
                                     (224, 128))
        if i % 4 == 3:
            img = np.ascontiguousarray(img[:, ::-1])
        t0 = time.perf_counter()
        got = warp_image_native(img, trans, (224, 128))
        t1 = time.perf_counter()
        want = warp_image(img, trans, (224, 128))
        warp_s["native"] += t1 - t0
        warp_s["numpy"] += time.perf_counter() - t1
        if not np.array_equal(got, want):
            raise AssertionError(f"native warp differs from warp_image in "
                                 f"case {i}")
        cases += 1
    return {"build_s": build_s, "cases": cases,
            "warp_ms": {k: 1e3 * v / 8 for k, v in warp_s.items()}}


def _same_batch(got, want, where: str) -> None:
    for key, value in want.items():
        if isinstance(value, dict):
            _same_batch(got[key], value, f"{where}.{key}")
        elif not (got[key].dtype == value.dtype
                  and torch.equal(got[key], value)):
            raise AssertionError(f"{where}.{key} differs from the serial "
                                 "Loader's")


def wait_for_loader_threads(timeout_s: float = 30.0) -> None:
    """An abandoned Loader iterator's threads finish the batch in hand
    before they end: wait for them, so that their items are neither
    counted nor timed with what follows."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith("cfd3d-loader") and t.is_alive()]
        if not alive:
            return
        alive[0].join(timeout=0.1)
    import traceback

    frames = sys._current_frames()
    stacks = "\n".join(
        f"{t.name}:\n" + "".join(traceback.format_stack(frames[t.ident]))
        for t in threading.enumerate() if t.ident in frames)
    raise AssertionError(f"the Loader's threads did not end:\n{stacks}")


def check_loader(root: str, device, rehearsal: bool) -> dict:
    """18c: on the train split of the nuScenes directory ``root`` at the
    campaign's settings, decoded on
    ``device``: the first ``LOADER_BATCHES`` batches of the Loader with 4
    threads, prefetch 2 and ``device_prefetch`` 2 must be bitwise those of
    one thread, no prefetch and ``to_device``; then items/s of the Loader
    alone (host batches) for each of ``LOADER_THREADS``."""
    cfg = load_config(opts=["DATASET.ROOT", repr(os.path.dirname(root) + "/")]
                      + CAMPAIGN_OPTS + (TINY_OPTS if rehearsal else []),
                      num_classes=10)
    ds = NuScenesDataset(cfg, "mini_train", device=device)
    batch = int(cfg.TRAIN.BATCH_SIZE)
    n = min(LOADER_BATCHES, len(ds) // batch)

    def loader(threads, prefetch):
        return Loader(ds, batch, shuffle=True, seed=SEED, augment=True,
                      num_threads=threads, prefetch=prefetch)

    decoded = image_io.decode_jpeg.launches
    threaded = device_prefetch(loader(4, 2), device, size=2)
    got = [next(threaded) for _ in range(n)]
    threaded.close()
    wait_for_loader_threads()
    serial = iter(loader(1, 0))
    for i in range(n):
        _same_batch(got[i], to_device(next(serial), device), f"batch {i}")
    del got
    items_per_s = {}
    for threads in LOADER_THREADS:
        it = iter(loader(threads, 2))
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        items_per_s[threads] = n * batch / (time.perf_counter() - t0)
        it.close()
        wait_for_loader_threads()
    return {"batches_equal": n, "batch": batch,
            "decoded": image_io.decode_jpeg.launches - decoded,
            "items_per_s": items_per_s}


def rehearse_path(root: str, device, rehearsal: bool, out: str) -> dict:
    """18d: ``tools rehearse --dataroot <the converted copy> --epochs 2`` at
    the campaign's settings (bf16, ``WORKERS 4``, ``TPU.PREFETCH 2``, the
    first epoch frozen), in this process: exit 0 with a finite NDS in
    [0, 1]; ``metrics.jsonl`` with ``train/total``, ``lr`` and
    ``epoch_sec`` per epoch and ``val/total``, ``val/mAP``, ``val/NDS``;
    the summary in ``run_state.json``; the FLOPs line once with a positive
    figure; one health check per step; the native paint, the native warp
    and (on the card) one decode per item built; ``dcn_fwd_bf16`` once per node per step,
    validation batch and cost report, the bf16 backward kernels once per
    node per unfrozen step, no other DCN kernel. Each epoch's wall time is
    reported beside the sum of its steps'."""
    argv = ["rehearse", "--dataroot", root, "--out", out, "--epochs",
            str(REHEARSE_EPOCHS), "--device", device,
            *CAMPAIGN_OPTS, "TPU.PREFETCH", "2", "MODEL.DEFREEZE", "0",
            *(TINY_OPTS if rehearsal else [])]
    trainers, checks, lines = [], [], []
    real_train, real_check = Trainer.train, DeviceHealthMonitor.check

    def recorded_train(self):
        trainers.append(self)
        return real_train(self)

    def counted_check(self):
        checks.append(1)
        return real_check(self)

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    trainer_log = logging.getLogger("cfd3d.trainer")
    level, handler = trainer_log.level, Lines()
    trainer_log.setLevel(logging.INFO)
    trainer_log.addHandler(handler)
    Trainer.train, DeviceHealthMonitor.check = recorded_train, counted_check
    paints = native.paint_rects.calls
    warps = native.warp_bilinear.calls
    decoded = image_io.decode_jpeg.launches
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cfd_tools.main(argv)
    finally:
        Trainer.train, DeviceHealthMonitor.check = real_train, real_check
        trainer_log.removeHandler(handler)
        trainer_log.setLevel(level)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    paints = native.paint_rects.calls - paints
    warps = native.warp_bilinear.calls - warps
    decoded = image_io.decode_jpeg.launches - decoded
    if rc != 0 or len(trainers) != 1:
        raise AssertionError(f"rehearse exited {rc} ({len(trainers)} "
                             f"trainers): {said.getvalue()[-2000:]}")
    trainer = trainers[0]
    cfg = trainer.config
    with open(os.path.join(out, "nuscenes_eval_det_output_mini_val",
                           "range_all", "metrics_summary.json")) as f:
        nds = json.load(f)["nd_score"]
    if not (math.isfinite(nds) and 0.0 <= nds <= 1.0):
        raise AssertionError(f"rehearse scored NDS {nds}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    for epoch in range(REHEARSE_EPOCHS):
        keys = set().union(*(e for e in events if e.get("step") == epoch))
        if not {"train/total", "lr", "epoch_sec"} <= keys:
            raise AssertionError(f"metrics.jsonl lacks epoch {epoch}'s "
                                 f"scalars: {sorted(keys)}")
    val_keys = set().union(*(e for e in events if "step" not in e))
    if not {"val/total", "val/mAP", "val/NDS"} <= val_keys:
        raise AssertionError(f"metrics.jsonl lacks validation scalars: "
                             f"{sorted(val_keys)}")
    with open(os.path.join(out, "run_state.json")) as f:
        state = json.load(f)
    if state.get("summary", {}).get("range_all", {}).get("nd_score") != nds:
        raise AssertionError("run_state.json does not hold the summary")
    cost = [line for line in lines if line.startswith("model cost:")]
    gflops = (float(cost[0].split()[2]) if len(cost) == 1 else 0.0)
    if len(cost) != 1 or not gflops > 0:
        raise AssertionError(f"FLOPs lines: {cost}")
    steps = trainer.steps
    if len(checks) != len(steps):
        raise AssertionError(f"{len(checks)} health checks for "
                             f"{len(steps)} steps")
    n_train = len(trainer.dataset_train)
    n_val = len(trainer.dataset_val)
    batch, test_batch = int(cfg.TRAIN.BATCH_SIZE), int(cfg.TEST.BATCH_SIZE)
    per_epoch = n_train // batch
    items = (REHEARSE_EPOCHS * per_epoch * batch + n_val
             + min(test_batch, n_val))
    if paints != items or warps != items:
        raise AssertionError(f"the native paint ran {paints} times and the "
                             f"native warp {warps} for {items} items")
    if not rehearsal and decoded != items:
        raise AssertionError(f"{decoded} decodes for {items} items")
    frozen = [st["frozen"] for st in steps]
    if frozen != [True] * per_epoch + [False] * per_epoch:
        raise AssertionError(f"steps frozen {frozen}")
    n_nodes = sum(isinstance(m, DeformConvNode)
                  for m in trainer.model.modules())
    per_node = 0 if rehearsal else n_nodes
    val_batches = -(-n_val // test_batch)
    want = {k: 0 for k in launches}
    want["dcn_fwd_bf16"] = per_node * (len(steps) + val_batches + 1)
    for name in BWD_KERNELS_BF16:
        want[name] = per_node * per_epoch
    if launches != want:
        raise AssertionError(f"rehearse launched {launches}, expected {want}")
    epoch_sec = [next(e["epoch_sec"] for e in events
                      if e.get("step") == epoch and "epoch_sec" in e)
                 for epoch in range(REHEARSE_EPOCHS)]
    step_sum = [sum(st["seconds"] for st in steps if st["epoch"] == epoch)
                for epoch in range(REHEARSE_EPOCHS)]
    return {"rc": rc, "nds": nds, "wall_s": wall_s, "gflops_per_batch": gflops,
            "images": {"train": n_train, "val": n_val}, "steps": len(steps),
            "health_checks": len(checks), "native_paints": paints,
            "native_warps": warps,
            "decoded": decoded, "launches": launches, "epoch_s": epoch_sec,
            "step_sum_s": step_sum, "val_seconds": trainer.val_seconds,
            "ms_per_step": {ph: statistics.mean(
                1e3 * st["seconds"] for st in steps
                if st["frozen"] == (ph == "frozen"))
                for ph in ("frozen", "unfrozen")}}


def profile_epoch(root: str, device, rehearsal: bool, tmp: str) -> dict:
    """18e: one more epoch with ``TPU.PROFILE True`` (on the first
    ``PROFILE_SPLITS`` train images, no validation) writes a trace; on the
    card the trace holds the card's kernels."""
    small = tiny_root(os.path.join(tmp, "profile_data"),
                      src=root, splits=None if rehearsal else PROFILE_SPLITS)
    out = os.path.join(tmp, "profile_run")
    cfg = load_config(opts=["DATASET.ROOT", repr(small + "/"), "OUTPUT_DIR",
                            repr(out)] + CAMPAIGN_OPTS
                      + ["TRAIN.EPOCHS", "1", "TRAIN.VAL_INTERVALS", "0",
                         "TPU.PROFILE", "True", "TPU.PREFETCH", "2"]
                      + (TINY_OPTS if rehearsal else []), num_classes=10)
    trainer = Trainer(cfg, NuScenesDataset(cfg, "mini_train", device=device),
                      device=device)
    t0 = time.perf_counter()
    trainer.train()
    seconds = time.perf_counter() - t0
    path = os.path.join(out, "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    if not events or (not rehearsal and not kernels):
        raise AssertionError(f"the profile holds {len(events)} events, "
                             f"{kernels} of the card's kernels")
    return {"steps": len(trainer.steps), "seconds": seconds,
            "events": len(events), "kernel_events": kernels,
            "trace_mb": os.path.getsize(path) / 1e6}


def serving_cost(device, rehearsal: bool) -> dict:
    """The forward's cost (``estimate_cost``) at the serving configuration:
    448x800, B=6, bf16 (64x128, B=2 in the rehearsal)."""
    opts = MAIN_PATH_OPTS + (["MODEL.INPUT_SIZE", "(64, 128)"]
                             if rehearsal else [])
    cfg = load_config(opts=opts + ["MIXED_PRECISION", "True"],
                      num_classes=10)
    model = build_model(cfg).to(device)
    seeded_weights(model, SEED)
    b = 2 if rehearsal else SERVE_BATCH
    h, w = cfg.MODEL.INPUT_SIZE
    oh, ow = cfg.MODEL.OUTPUT_SIZE
    gen = torch.Generator().manual_seed(SEED)
    image = torch.randn((b, 3, h, w), generator=gen).to(device)
    pc_dep = torch.rand((b, 3, oh, ow), generator=gen).to(device)
    calib = torch.tensor([[[1266.4, 0, w / 2, 0], [0, 1266.4, h / 2, 0],
                           [0, 0, 1, 0]]]).repeat(b, 1, 1).to(device)
    cost = estimate_cost(model, image, pc_dep, calib)
    return {"input": [b, h, w], "gflops": cost["flops"] / 1e9,
            "gib": cost["bytes_accessed"] / 2 ** 30}


def training_run_path(device, rehearsal: bool, card) -> dict:
    """Phase 18: the training run as the JAX package runs it (a)-(e), and
    the serving forward's cost."""
    where = "" if rehearsal else f" on {card}"
    with tempfile.TemporaryDirectory(prefix="cfd_smoke_run_") as tmp:
        conv = check_converter(tmp)
        log(f"converter: {conv['splits']} and {conv['bins']} point-cloud "
            f"files equal to the committed ones, in {conv['seconds']:.2f} s")
        paint = check_native_kernels()
        log(f"native paint and warp: built in {paint['build_s']:.2f} s, "
            f"bitwise their numpy versions in {paint['cases']} cases; a "
            f"448x256 frame's warp to 224x128 {paint['warp_ms']['native']:.3f}"
            f" ms, numpy {paint['warp_ms']['numpy']:.3f} ms{where}")
        root = conv["root"]
        if rehearsal:
            root = os.path.join(tiny_root(os.path.join(tmp, "tiny"),
                                          src=root), "nuscenes")
        loader = check_loader(root, device, rehearsal)
        log(f"Loader: {loader['batches_equal']} batches of "
            f"{loader['batch']} with 4 threads, prefetch 2 and "
            f"device_prefetch 2 bitwise those of one thread; items/s by "
            f"threads: " + ", ".join(f"{t}: {v:.1f}" for t, v in
                                     loader["items_per_s"].items()) + where)
        reh = rehearse_path(root, device, rehearsal,
                            os.path.join(tmp, "rehearsal"))
        log(f"rehearse: {reh['images']['train']} train / "
            f"{reh['images']['val']} val images, {reh['steps']} steps, NDS "
            f"{reh['nds']:.4f} (seeded weights), {reh['wall_s']:.1f} s; "
            f"{reh['gflops_per_batch']:.2f} GFLOPs per val batch; "
            f"{reh['health_checks']} health checks, {reh['native_paints']} "
            f"native paints, {reh['native_warps']} native warps, "
            f"{reh['decoded']} decodes; launches "
            f"{reh['launches']}")
        log("  epoch wall s / sum of its steps s: " + ", ".join(
            f"{e:.2f} / {s:.2f}" for e, s in zip(reh["epoch_s"],
                                                 reh["step_sum_s"]))
            + f"; ms per step frozen {reh['ms_per_step']['frozen']:.1f}, "
            f"unfrozen {reh['ms_per_step']['unfrozen']:.1f}{where}")
        prof = profile_epoch(conv["root"], device, rehearsal, tmp)
        log(f"TPU.PROFILE: {prof['steps']} steps traced, {prof['events']} "
            f"events ({prof['kernel_events']} kernels), "
            f"{prof['trace_mb']:.1f} MB")
    cost = serving_cost(device, rehearsal)
    log(f"forward cost at {cost['input'][0]}x{cost['input'][1]}x"
        f"{cost['input'][2]} (bf16): {cost['gflops']:.2f} GFLOPs, "
        f"{cost['gib']:.3f} GiB (estimate_cost)")
    return {"converter": {k: v for k, v in conv.items() if k != "root"},
            "native": paint, "loader": loader, "rehearse": reh,
            "profile": prof, "serving_cost": cost}


def warp_kernel_entry(report):
    """The ``kernels`` line's entry of ``warp_affine``: launches on phase
    17's ``run`` over JPEG paths, the warp of six raw frames timed (per
    call, plain on the card, bound, ``grid_sample``), and beside it its
    device time alone and numpy's host time."""
    t = report["warp_timing"]
    return {"name": "warp_affine", "route": "cuda",
            "source": "centerfusiondetect3d_tpu_torch/csrc/" + warp.SOURCE,
            "replaces": "none (cv2.warpAffine on the host, "
                        "centerfusiondetect3d_tpu/runtime/detector.py:90)",
            "path": "Detector.run on image files",
            "launches": report["serving"]["run"]["counts"]["warp_affine"],
            "max_abs_err": 0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "host_numpy_ms": t["host_numpy_ms"], "shape": t["frames"],
            "checks": report["warp_checks"]}


def ycc_kernel_entry(report, cases: int):
    """The ``kernels`` line's entry of ``ycc_to_bgr``'s kernel: launches on
    phase 17's ``run`` over JPEG paths, held bitwise against its plain
    version in ``cases`` cases (phase 1), timed on one repo JPEG."""
    y = report["ycc_timing"]
    return {"name": "ycc_to_bgr", "route": "cuda",
            "source": "centerfusiondetect3d_tpu_torch/csrc/"
                      + image_io.SOURCE,
            "replaces": "none (cv2.imread's colour conversion on the host, "
                        "centerfusiondetect3d_tpu/runtime/detector.py:275)",
            "path": "Detector.run on image files",
            "launches": report["serving"]["run"]["counts"]["ycc_to_bgr"],
            "max_abs_err": 0, "bitwise_cases": cases, "ms": y["ms"],
            "plain_ms": y["plain_ms"], "bound_ms": y["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "device_ms": y["device_ms"], "shape": y["image"]}


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
        log("decoders: " + ", ".join(decoder_facts()))
        built = load_kernel_libraries(dcn.KERNEL_SOURCES
                                      + (probes.SOURCE, image_io.SOURCE,
                                         warp.SOURCE))
        log(f"built {len(built)} sources with nvcc in parallel in "
            f"{time.perf_counter() - t_build:.1f} s")
        for source, lib in built.items():
            log(f"{source}: nvcc {lib.build_seconds:.1f} s -> {lib.path.name}")
            for line in lib.ptxas:
                log(f"  ptxas: {line}")
    n_ycc = 0
    if not rehearsal:
        n_ycc = ycc_kernel_vs_plain(args.device)
        log(f"ycc_to_bgr kernel: bitwise equal to its plain version in "
            f"{n_ycc} cases (4:2:0 as decoded, odd sizes, 4:2:2, grey)")
    decode_err = decode_vs_reference(args.device)
    log(f"image decoder on {args.device}: {len(DECODE_REFERENCE)} mini_val "
        f"JPEGs, per-channel and 4x4-cell means within "
        f"{decode_err['mean_levels']:.3f} levels of cv2's (limit "
        f"{DECODE_TOL}); {sum(map(len, DECODE_CROPS.values()))} 16x16 "
        f"crops: pixels {decode_err['pixel_max']} levels at most (limit "
        f"{DECODE_PIXEL_TOL}), {decode_err['pixel_mean']:.4f} on average "
        f"(limit {DECODE_PIXEL_MEAN_TOL}), "
        f"{100 * decode_err['pixel_equal']:.2f}% equal")
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

    # 16. main.py on the repo's data: train, validate with NDS, EVAL
    t0 = time.perf_counter()
    main_py = main_py_path(args.device, rehearsal, card)
    log(f"phase main.py: {time.perf_counter() - t0:.1f} s")

    # 17. serving image files: the warp kernel, run and run_stream on JPEG
    # paths, counted; flip and multi-scale TTA; the inference CLI
    t0 = time.perf_counter()
    files = serving_files_path(args.device, rehearsal, card)
    log(f"phase serving files: {time.perf_counter() - t0:.1f} s")

    # 18. the training run's host side: the converter, the native paint,
    # the threaded Loader, tools rehearse, TPU.PROFILE
    t0 = time.perf_counter()
    run = training_run_path(args.device, rehearsal, card)
    log(f"phase training run: {time.perf_counter() - t0:.1f} s")
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
    kernels += [warp_kernel_entry(files), ycc_kernel_entry(files, n_ycc)]
    log(json.dumps({"backward_per_node_shape": bwd_rows,
                    "bf16_backward_per_node_shape": bwd_rows16}))
    log(json.dumps({"main_py": main_py, "decode_vs_cv2": decode_err}))
    log(json.dumps({"serving_files": files}))
    log(json.dumps({"training_run": run}))
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
