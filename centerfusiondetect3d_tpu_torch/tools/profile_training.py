"""Where the training step's time goes: ``torch.profiler`` over ``train_step``.

    python -m centerfusiondetect3d_tpu_torch.tools.profile_training
    python -m centerfusiondetect3d_tpu_torch.tools.profile_training \\
        --mixed-precision false        # float32 instead of the config's bf16
    python -m centerfusiondetect3d_tpu_torch.tools.profile_training \\
        --device cpu --tiny            # rehearsal: CPU ops, nothing measured

Builds the training model at the configuration of ``chip_smoke.py``'s
training main path (``runtime/synthetic.py``: ``MAIN_PATH_OPTS`` and
``TRAIN_OPTS``, 448x800, the flagship's batch of 26 in 2 microbatches of 13,
seeded weights, one synthetic batch) in the precision the config says
(``MIXED_PRECISION``, true as shipped: bf16) unless ``--mixed-precision``
overrides it. After one warm-up step of each kind it profiles ``--steps``
frozen steps, then ``--steps`` unfrozen ones, each window on its own, of
``training/state.py:train_step`` as the Trainer calls it (the Trainer's
step timer covers the same call). On the card it prints, per step and
window: the wall time and images/s, the device's busy time (the union of
its kernels' intervals) and idle share, device time by kernel group (the DCN
forward kernels, the DCN backward kernels, convolutions and GEMMs, the rest)
and the top kernels, then the peak memory; ``--trace DIR`` also writes a
Chrome trace of each window under ``DIR/frozen/profile`` and
``DIR/unfrozen/profile``.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import torch

from ..config import load_config
from ..data.pipeline import stack_items, to_device
from ..losses import GenericLoss
from ..models import build_model
from ..runtime.synthetic import (
    MAIN_PATH_OPTS,
    TRAIN_OPTS,
    SyntheticTrainingSet,
    seeded_weights,
)
from ..training import learning_rate, make_optimizer, train_step
from ..utils.observability import device_time_report, trace_profile
from .profile_serving import CONV_KEYS

GROUPS = (
    ("DCN forward (dcn_fwd, dcn_fwd_bf16)", ("dcn_fwd",)),
    ("DCN backward (dcn_im2col; dcn_col2im: its map's count, prefix sum, "
     "fill and sort, transpose and gather; dcn_col2im_coord; float32 and "
     "bf16)", ("dcn_im2col", "dcn_col2im")),
    ("convolution / GEMM (cuDNN, cuBLAS, their layout copies)",
     CONV_KEYS + ("dgrad", "wgrad", "depthwise")),
)
REST = "other (elementwise, BatchNorm, casts, optimizer, reductions, copies)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="64x128, batch 4 (the CPU rehearsal)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default="",
                    help="write Chrome traces under TRACE/{frozen,unfrozen}")
    ap.add_argument("--mixed-precision", choices=("true", "false"),
                    help="override the config's MIXED_PRECISION")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("profile_training: no CUDA device available")
    if not on_card and not args.tiny:
        raise SystemExit("profile_training: --device cpu runs only with "
                         "--tiny")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opts = MAIN_PATH_OPTS + TRAIN_OPTS
    if args.mixed_precision:
        opts += ["MIXED_PRECISION", args.mixed_precision.capitalize()]
    if args.tiny:
        opts += ["MODEL.INPUT_SIZE", "(64, 128)", "TRAIN.BATCH_SIZE", "4"]
    cfg = load_config(opts=opts, num_classes=10)
    device = torch.device(args.device)
    model = build_model(cfg).to(device)
    seeded_weights(model, 0)
    optimizer = make_optimizer(cfg, model)
    loss_fn = GenericLoss(cfg)
    batch_size, accum = int(cfg.TRAIN.BATCH_SIZE), int(cfg.TRAIN.GRAD_ACCUM)
    ds = SyntheticTrainingSet(cfg, batch_size, seed=0)
    batch = to_device(stack_items([ds.get_item(i) for i in range(batch_size)]),
                      device)
    lr = learning_rate(cfg, 0, 0)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for frozen in (True, False):  # warm-up: kernel builds, library handles
        train_step(model, optimizer, loss_fn, batch, lr, frozen, accum)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    precision = ("bf16" if model.compute_dtype == torch.bfloat16
                 else "float32")
    in_h, in_w = cfg.MODEL.INPUT_SIZE
    for phase, frozen in (("frozen", True), ("unfrozen", False)):
        trace = os.path.join(args.trace, phase) if args.trace else None
        with trace_profile(trace, device) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                metrics = train_step(model, optimizer, loss_fn, batch, lr,
                                     frozen, accum)
            sync()
            wall_us = 1e6 * (time.perf_counter() - t0)
        ms = wall_us / 1e3 / args.steps
        print(f"{args.steps} {phase} steps of train_step in {precision}, "
              f"batch {batch_size} in {accum} microbatches at {in_h}x{in_w}: "
              f"wall {ms:.2f} ms per step ({batch_size / ms * 1e3:.2f} "
              f"images/s), last total loss {float(metrics['total']):.4f}")
        if not on_card:
            ops = collections.Counter()
            for evt in prof.key_averages():
                ops[evt.key] += evt.self_cpu_time_total
            print("host ops by self CPU time (ms per step), device time not "
                  "measured: " + ", ".join(
                      f"{k} {v / 1e3 / args.steps:.2f}"
                      for k, v in ops.most_common(args.top)))
            continue
        lines = device_time_report(prof, args.steps, wall_us, GROUPS, REST,
                                   args.top)
        if lines is None:
            print("device time: not measured (the profiler saw no CUDA "
                  "kernel)")
            return 1
        print("\n".join(line.replace("per run", "per step")
                        for line in lines))
    if on_card:
        print(f"peak memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
              f" GB (profiled steps, {precision}) on "
              f"{torch.cuda.get_device_name(device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
