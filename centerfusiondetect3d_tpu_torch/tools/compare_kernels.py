"""Time DCN kernels of this tree against another checkout's, in turns.

    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel dcn_col2im --kernel dcn_col2im_bf16

OTHER is a directory inside this checkout (for example a git-ignored
``git archive`` of another commit) that holds the port's package. Its
``ops/dcn.py`` is imported beside this tree's as ``cfd_other.ops.dcn``, and
its kernels build from its own sources into its own ``_build/``. Each
``--kernel`` (a DCN kernel wrapper of both trees: ``dcn_fwd``,
``dcn_fwd_bf16``, the three backward kernels of either dtype) runs at every
distinct DCN node shape of the training main path (``runtime/synthetic.py``:
``MAIN_PATH_OPTS`` and ``TRAIN_OPTS``, 448x800, microbatches of 13, the
shapes recorded by hooks in one frozen ``train_step``) on the same seeded
inputs in both trees. The two outputs are held against each other within
1e-4 (float32) or 8e-3 (bf16) relative to the largest magnitude. Then each
kernel is timed with CUDA events in turns (other, this, this, other, ...),
medians of 11 after one warm-up call of each. Prints the card, one
line per kernel and shape, the sums per unfrozen training step (over the
nodes and microbatches), and a JSON line with every number. Card only.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

from ..config import load_config
from ..data.pipeline import stack_items, to_device
from ..losses import GenericLoss
from ..models import DeformConvNode, build_model
from ..ops import dcn
from ..runtime.synthetic import (MAIN_PATH_OPTS, TRAIN_OPTS,
                                 SyntheticTrainingSet, seeded_weights)
from ..training import learning_rate, make_optimizer, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
PACKAGE = "centerfusiondetect3d_tpu_torch"
RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
REPS = 11  # timed calls of each tree per kernel and shape
SEED = 0


def kernel_call(name: str, module, inputs):
    """A no-argument call of kernel ``name`` of ``module`` (an ``ops/dcn.py``)
    on ``inputs``."""
    x, off, mask, wt, bias, dcols = inputs
    if name == "dcn_fwd":
        return lambda: module.deform_conv2d(x, off, mask, wt, bias)
    if name == "dcn_fwd_bf16":
        return lambda: module.dcn_fwd_bf16(x, off, mask, wt, bias)
    fn = getattr(module, name)
    if "im2col" in name:
        return lambda: fn(x, off, mask)
    if "coord" in name:
        return lambda: fn(dcols, x, off, mask)
    return lambda: fn(dcols, off, mask)


def dtype_of(name: str):
    return torch.bfloat16 if name.endswith("_bf16") else torch.float32


KERNELS = ("dcn_fwd", "dcn_fwd_bf16", *dcn.BACKWARD_KERNELS,
           *dcn.BACKWARD_KERNELS_BF16)


def load_other(root: str):
    """``ops/dcn.py`` of the port in the checkout ``root``."""
    pkg = os.path.join(root, PACKAGE)
    for name, path in (("cfd_other", pkg),
                       ("cfd_other.ops", os.path.join(pkg, "ops"))):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return importlib.import_module("cfd_other.ops.dcn")


def training_node_shapes(device):
    """(B, C, H, W, O) of each DCN node call of one frozen training step of
    the main path, in call order, and the number of microbatches."""
    cfg = load_config(opts=MAIN_PATH_OPTS + TRAIN_OPTS, num_classes=10)
    model = build_model(cfg).to(device)
    seeded_weights(model, SEED)
    batch_size, accum = int(cfg.TRAIN.BATCH_SIZE), int(cfg.TRAIN.GRAD_ACCUM)
    ds = SyntheticTrainingSet(cfg, batch_size, seed=SEED)
    batch = to_device(stack_items([ds.get_item(i) for i in range(batch_size)]),
                      device)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(
            tuple(args[0].shape) + (mod.weight.shape[0],)))
        for m in model.modules() if isinstance(m, DeformConvNode)]
    try:
        train_step(model, make_optimizer(cfg, model), GenericLoss(cfg), batch,
                   learning_rate(cfg, 0, 0), True, accum)
    finally:
        for h in hooks:
            h.remove()
    return shapes[:len(shapes) // accum], accum


def node_inputs(shape, dtype, device, seed: int):
    """x, offset, mask, weight, bias and column gradients of one node: x and
    the output gradient N(0, 1), offsets N(0, 1.5 px) with 2% pushed to
    8-12 px, a sigmoided mask, weight 0.05 N(0, 1), bias N(0, 1); x, weight,
    bias and the gradient in ``dtype``, offset and mask float32."""
    b, c, h, w, o = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    x = randn(b, c, h, w)
    off = 1.5 * randn(b, 18, h, w)
    far = torch.rand((b, 18, h, w), generator=gen, device=device) < 0.02
    off = torch.where(far, torch.sign(off) * (8 + 4 * torch.rand(
        (b, 18, h, w), generator=gen, device=device)), off)
    mask = torch.sigmoid(randn(b, 9, h, w))
    wt, bias, g = 0.05 * randn(o, c, 3, 3), randn(o), randn(b, o, h, w)
    x, wt, bias, g = (t.to(dtype) for t in (x, wt, bias, g))
    return x, off, mask, wt, bias, dcn.column_gradients(wt, g)


def rel_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(rel_err(a, b) for a, b in zip(got, want))
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def time_turns(fn_other, fn_this, reps: int):
    """Median ms of each, timed alone with CUDA events in turns (other,
    this, this, other, ...) after one warm-up call of each."""
    fn_other(), fn_this()
    times = ([], [])
    for i in range(reps):
        for which in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_other, fn_this)[which]()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, metavar="DIR",
                    help="another checkout, inside this one")
    ap.add_argument("--kernel", action="append", required=True,
                    choices=KERNELS)
    args = ap.parse_args(argv)
    other_root = os.path.realpath(args.other)
    if (other_root == ROOT
            or os.path.commonpath([ROOT, other_root]) != ROOT
            or not os.path.isdir(os.path.join(other_root, PACKAGE))):
        raise SystemExit(f"compare_kernels: --other must be a directory "
                         f"inside {ROOT} that holds {PACKAGE}/")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device available")
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no reading")
    other = load_other(other_root)
    shapes, accum = training_node_shapes(device)
    torch.cuda.empty_cache()
    report = {"card": card[0] if card else None, "other": args.other,
              "microbatches": accum, "kernels": {}}
    for name in args.kernel:
        dtype, rows = dtype_of(name), []
        for i, shape in enumerate(sorted(set(shapes), key=shapes.index)):
            inputs = node_inputs(shape, dtype, device, SEED + i)
            fn_this = kernel_call(name, dcn, inputs)
            fn_other = kernel_call(name, other, inputs)
            with torch.no_grad():
                rel = rel_err(fn_this(), fn_other())
                if not rel <= RTOL[dtype]:
                    raise SystemExit(
                        f"compare_kernels: {name} of the two trees disagree "
                        f"at {shape}: relative {rel:.3e} > {RTOL[dtype]}")
                ms_other, ms_this = time_turns(fn_other, fn_this, REPS)
            row = {"shape": list(shape), "nodes": shapes.count(shape),
                   "ms": ms_this, "other_ms": ms_other, "max_rel_err": rel}
            rows.append(row)
            print(f"{name} {tuple(shape)} x{row['nodes']}: this {ms_this:.4f}"
                  f" ms, other {ms_other:.4f} ms (rel err {rel:.2e})")
            del inputs, fn_this, fn_other
        per_step = {k: accum * sum(r[k] * r["nodes"] for r in rows)
                    for k in ("ms", "other_ms")}
        print(f"{name} per unfrozen step ({accum} microbatches): this "
              f"{per_step['ms']:.3f} ms, other {per_step['other_ms']:.3f} ms")
        report["kernels"][name] = {"per_node_shape": rows,
                                   "ms_per_unfrozen_step": per_step["ms"],
                                   "other_ms_per_unfrozen_step":
                                       per_step["other_ms"]}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
