"""Where the serving path's time goes: ``torch.profiler`` over ``Detector.run``.

    python -m centerfusiondetect3d_tpu_torch.tools.profile_serving
    python -m centerfusiondetect3d_tpu_torch.tools.profile_serving \\
        --mixed-precision false        # float32 instead of the config's bf16
    python -m centerfusiondetect3d_tpu_torch.tools.profile_serving \\
        --device cpu --tiny            # rehearsal: CPU ops, nothing measured

Builds the serving detector at the main-path configuration of
``chip_smoke.py`` (``runtime/synthetic.py``: 448x800, 6 cameras, seeded
weights, BatchNorm calibrated on the synthetic batch) in the precision the
config says (``MIXED_PRECISION``, true as shipped: bf16) unless
``--mixed-precision`` overrides it, warms it up, then
profiles ``--runs`` calls of ``Detector.run``. On the card it prints, per
run: the wall time, the device's busy time (the union of its kernels'
intervals) and idle share, device time by kernel group (the DCN kernel,
convolutions and GEMMs, sort/top-k, the rest) and the top kernels by device
time; ``--trace DIR`` also writes a Chrome trace under ``DIR/profile``.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import torch

from ..config import load_config
from ..runtime.detector import Detector
from ..runtime.synthetic import (
    MAIN_PATH_OPTS,
    calibrate_batchnorm,
    seeded_weights,
    synthetic_frames,
)
from ..utils.observability import device_time_report, trace_profile

# substrings of the names of cuDNN's and cuBLAS's kernels and their layout
# copies (kernel names are matched lower-cased)
CONV_KEYS = ("convolve", "conv2d", "cudnn", "gemm", "xmma", "cutlass",
             "winograd", "implicit", "fprop", "nchwtonhwc", "nhwctonchw")
GROUPS = (
    ("dcn_fwd, dcn_fwd_bf16 (hand-written DCNv2: NHWC copy, kernel, "
     "split reduction)", ("dcn_fwd",)),
    ("convolution / GEMM (cuDNN, cuBLAS, their layout copies)", CONV_KEYS),
    ("sort / top-k", ("sort", "radix", "topk")),
)
REST = "other (elementwise, reductions, copies, gathers)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="64x128, 2 cameras (the CPU rehearsal)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace to TRACE/profile/trace.json")
    ap.add_argument("--mixed-precision", choices=("true", "false"),
                    help="override the config's MIXED_PRECISION")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device available")
    if not on_card and not args.tiny:
        raise SystemExit("profile_serving: --device cpu runs only with --tiny")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opts = list(MAIN_PATH_OPTS)
    if args.mixed_precision:
        opts += ["MIXED_PRECISION", args.mixed_precision.capitalize()]
    n_cams, frame_hw = 6, (450, 800)
    if args.tiny:
        opts += ["MODEL.INPUT_SIZE", "(64, 128)"]
        n_cams, frame_hw = 2, (72, 128)
    det = Detector(load_config(opts=opts, num_classes=10), device=args.device)
    seeded_weights(det.model, 0)
    frames = synthetic_frames(n_cams, *frame_hw, seed=0)
    calibrate_batchnorm(det, frames)
    for _ in range(2):
        det.run(*frames)

    det.timer.reset()
    with trace_profile(args.trace, args.device) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            det.run(*frames)
        wall_us = 1e6 * (time.perf_counter() - t0)

    stages = det.timer.summary()
    precision = ("bf16" if det.model.compute_dtype == torch.bfloat16
                 else "float32")
    print(f"{args.runs} runs of Detector.run in {precision}, {n_cams} "
          f"cameras, {frame_hw[1]}x{frame_hw[0]} frames; per run: wall "
          f"{wall_us / 1e3 / args.runs:.2f} ms; stages (ms) "
          + ", ".join(f"{k} {1e3 * v:.2f}" for k, v in stages.items()))
    if not on_card:
        ops = collections.Counter()
        for evt in prof.key_averages():
            ops[evt.key] += evt.self_cpu_time_total
        print("host ops by self CPU time (ms per run), device time not "
              "measured: " + ", ".join(
                  f"{k} {v / 1e3 / args.runs:.2f}"
                  for k, v in ops.most_common(args.top)))
        return 0

    lines = device_time_report(prof, args.runs, wall_us, GROUPS, REST,
                               args.top)
    if lines is None:
        print("device time: not measured (the profiler saw no CUDA kernel)")
        return 1
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
