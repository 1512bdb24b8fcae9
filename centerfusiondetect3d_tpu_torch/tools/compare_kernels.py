"""Time DCN kernels of this tree against another checkout's, in turns.

    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel dcn_col2im --kernel dcn_col2im_bf16
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel dcn_fwd --kernel dcn_fwd_bf16 \\
        --batch 6                # serving's batch of 6 cameras
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --overlap --kernel dcn_fwd --kernel dcn_fwd_bf16 --batch 6
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel dcn_im2col_bf16 \\
        --kernel dcn_col2im_coord_bf16 --kernel dcn_backward_bf16
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel probe_p1 --kernel probe_p2
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel probe_k2 --kernel probe_k5
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel probe_kf --kernel probe_kg \\
        --kernel probe_p4
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel probe_k4 --kernel probe_kd \\
        --kernel probe_ke --kernel probe_kb --kernel probe_ka \\
        --kernel probe_k3 --kernel probe_kc --kernel probe_k1
    python -m centerfusiondetect3d_tpu_torch.tools.compare_kernels \\
        --other _compare/parent --kernel warp_affine

OTHER is a directory inside this checkout (for example a git-ignored
``git archive`` of another commit) that holds the port's package. Its
``ops/dcn.py`` is imported beside this tree's as ``cfd_other.ops.dcn``, and
its kernels build from its own sources into its own ``_build/``. Each
``--kernel`` (a DCN kernel wrapper of both trees: ``dcn_fwd``,
``dcn_fwd_bf16``, the three backward kernels of either dtype; or
``dcn_backward`` / ``dcn_backward_bf16``, the whole
``deform_conv2d_backward`` of one dtype, its GEMMs and copies included)
runs at every
distinct DCN node shape of the training main path (``runtime/synthetic.py``:
``MAIN_PATH_OPTS`` and ``TRAIN_OPTS``, 448x800, microbatches of 13, the
shapes recorded by hooks in one frozen ``train_step``) on the same seeded
inputs in both trees; ``--batch N`` replaces the microbatch with N (6:
serving's node shapes, one image per camera). Each tree's backward kernel
gets the inputs in that tree's own layouts: x as its backward reads it
(channels-last where the module says ``BACKWARD_X_CHANNELS_LAST``, as its
autograd Function saves it; else NCHW) and the column gradients from its
own ``column_gradients``, all made from the same seeded values. The two
outputs are held against each other in a layout-free form (im2col's
columns through each tree's ``weight_gradient``, as dweight (O, C, 3, 3);
the other outputs as they come) within 1e-4 (float32) or 8e-3 (bf16)
relative to the largest magnitude. The probe kernels (``ops/probes.py``:
the twelve tile probes ``probe_k1``...``probe_k5`` and
``probe_ka``...``probe_kg`` on the three inputs of a tile probe at both of
``probes.GEOMETRIES``, ``probe_p1``, ``probe_p2`` and ``probe_p4`` on P5's
inputs) run instead on
``tools/probe_dcn.py``'s inputs of them, in both trees, whose outputs must
agree within the probe's ``Probe.rtol`` (0: bitwise);
beside them their yardstick (``Probe.library`` of this tree, where there
is one) is timed by its device time alone. ``warp_affine`` (the serving
warp, ``ops/warp.py``; a tree without that module is refused) runs on
``warp_inputs``: six seeded 1600x900 frames and six seeded 448x256 frames
(the repo's JPEG size), each batch to serving's 448x800, in one launch;
the two trees' outputs must be bitwise equal. With ``--overlap`` in place of
``--other`` the other side is this tree's forward kernels in their
in-block overlap variant (``ops/dcn.py:FWD_OVERLAP``; the bf16 kernel's
256-channel tile has none and runs as it is), whose output must equal
the kernels' bitwise. Then each kernel is timed with CUDA events in turns
(other, this, this, other, ...), medians of 11 after one warm-up call of
each, one call per event pair (host work included); then by their
device time alone (one event pair around 200 calls, 40 of a whole
backward, queued behind a sleep of the stream), in turns (other, this,
this, other; the means). Prints the card, one line per kernel and shape, the sums per model forward (over the 16 nodes) and, at
the training microbatch, per unfrozen training step (over the nodes and
microbatches), and a JSON line with every number. Card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..config import load_config
from ..data.pipeline import stack_items, to_device
from ..geometry.affine import get_affine_transform
from ..losses import GenericLoss
from ..models import DeformConvNode, build_model
from ..ops import dcn, probes, warp
from ..runtime.synthetic import (MAIN_PATH_OPTS, TRAIN_OPTS,
                                 SyntheticTrainingSet, seeded_weights)
from ..tools import probe_dcn
from ..training import learning_rate, make_optimizer, train_step
from ..utils.observability import DEVICE_LAUNCHES, time_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.realpath(__file__))))
PACKAGE = "centerfusiondetect3d_tpu_torch"
RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
REPS = 11  # timed calls of each tree per kernel and shape
FORWARD = ("dcn_fwd", "dcn_fwd_bf16")
BACKWARD = ("dcn_backward", "dcn_backward_bf16")
BACKWARD_DEVICE_LAUNCHES = 40  # calls per device-time pair of a backward
SEED = 0


def kernel_call(name: str, module, inputs):
    """(call, layout_free): a no-argument call of kernel ``name`` of
    ``module`` (an ``ops/dcn.py``) on ``inputs`` laid out as that module's
    kernels take them, and the function that puts the call's output in a
    form both trees share."""
    x, off, mask, wt, bias, g = inputs
    same = lambda out: out
    if name == "dcn_fwd":
        return lambda: module.deform_conv2d(x, off, mask, wt, bias), same
    if name == "dcn_fwd_bf16":
        return lambda: module.dcn_fwd_bf16(x, off, mask, wt, bias), same
    if getattr(module, "BACKWARD_X_CHANNELS_LAST", False):
        x = module.dcn_fwd_nhwc(x)
    if name in BACKWARD:
        return (lambda: module.deform_conv2d_backward(x, off, mask, wt, g),
                same)
    fn = getattr(module, name)
    if "im2col" in name:
        return lambda: fn(x, off, mask), lambda cols: module.weight_gradient(
            g, cols).reshape(wt.shape)
    dcols = module.column_gradients(wt, g)
    if "coord" in name:
        return lambda: fn(dcols, x, off, mask), same
    return lambda: fn(dcols, off, mask), same


def overlap_call(fn):
    """fn, run with ``dcn.FWD_OVERLAP`` set: the forward kernels' in-block
    overlap variant."""
    def call():
        dcn.FWD_OVERLAP = True
        try:
            return fn()
        finally:
            dcn.FWD_OVERLAP = False
    return call


def dtype_of(name: str):
    return torch.bfloat16 if name.endswith("_bf16") else torch.float32


KERNELS = ("dcn_fwd", "dcn_fwd_bf16", *dcn.BACKWARD_KERNELS,
           *dcn.BACKWARD_KERNELS_BF16, *BACKWARD)
PROBE_KERNELS = ("probe_k1", "probe_k2", "probe_k3", "probe_k4", "probe_k5",
                 "probe_ka", "probe_kb", "probe_kc", "probe_kd", "probe_ke",
                 "probe_kf", "probe_kg", "probe_p1", "probe_p2", "probe_p3",
                 "probe_p4")
WARP_KERNELS = ("warp_affine",)
WARP_OUT = (448, 800)  # serving's input (H, W)
WARP_SOURCES = ((900, 1600), (256, 448))  # a raw camera frame, a repo JPEG


def warp_inputs(device, n: int = 6):
    """(label, frames, inverse matrices) of ``warp_affine``'s comparison:
    n seeded frames of each of ``WARP_SOURCES``, each batch with serving's
    affine to ``WARP_OUT``."""

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for h, w in WARP_SOURCES:
        frames = [torch.randint(0, 256, (h, w, 3), generator=gen,
                                dtype=torch.uint8).to(device)
                  for _ in range(n)]
        trans = get_affine_transform(np.array([w / 2, h / 2], np.float32),
                                     max(h, w), 0, (WARP_OUT[1], WARP_OUT[0]))
        cases.append((f"{n} x {w}x{h} -> {WARP_OUT[1]}x{WARP_OUT[0]}",
                      frames, warp.inverse_matrices([trans] * n)))
    return cases


def warp_call(module, frames, inv):
    """A no-argument call of ``module``'s (an ``ops/warp.py``)
    ``warp_affine`` on ``frames`` into an output batch of its own."""
    out = torch.empty((len(frames), *WARP_OUT, 3), dtype=torch.uint8,
                      device=frames[0].device)
    return lambda: module.warp_affine(frames, inv, out)


def load_other_warp(root: str):
    """The other tree's ``ops/warp.py``, as ``cfd_other.ops.warp``; exits
    where that tree has none."""
    path = os.path.join(root, PACKAGE, "ops", "warp.py")
    if not os.path.isfile(path):
        raise SystemExit(f"compare_kernels: {root} has no "
                         f"{PACKAGE}/ops/warp.py to compare warp_affine with")
    return importlib.import_module("cfd_other.ops.warp")


def compare_warp(other_warp, device, report) -> None:
    """Adds ``warp_affine``'s entry: per input, both trees' outputs
    bitwise equal (else exit), then each tree per call and by device time
    alone, in turns."""

    rows = []
    for label, frames, inv in warp_inputs(device):
        fn_this, fn_other = (warp_call(warp, frames, inv),
                             warp_call(other_warp, frames, inv))
        got, want = fn_this(), fn_other()
        if not torch.equal(got, want):
            raise SystemExit(f"compare_kernels: warp_affine of the two trees "
                             f"differs on {label}: "
                             f"{int((got != want).sum())} bytes")
        ms_other, ms_this = time_turns(fn_other, fn_this, REPS)
        other_dev, this_dev = device_turns(fn_other, fn_this)
        rows.append({"case": label, "ms": ms_this, "other_ms": ms_other,
                     "device_ms": this_dev, "other_device_ms": other_dev})
        print(f"warp_affine {label}: device alone this {this_dev:.5f} ms, "
              f"other {other_dev:.5f} ms; per call this {ms_this:.4f} ms, "
              f"other {ms_other:.4f} ms (bitwise equal)")
    report["kernels"]["warp_affine"] = {"per_case": rows}


def load_other(root: str):
    """The ``ops`` package of the port in the checkout ``root``, imported
    as ``cfd_other.ops`` (``.dcn``, ``.probes``)."""
    pkg = os.path.join(root, PACKAGE)
    for name, path in (("cfd_other", pkg),
                       ("cfd_other.ops", os.path.join(pkg, "ops"))):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    for name in ("dcn", "probes"):
        importlib.import_module(f"cfd_other.ops.{name}")
    return sys.modules["cfd_other.ops"]


def probe_calls(name: str, other_probes, device):
    """(label, this tree's call, the other's, this tree's yardstick or
    None) of probe kernel ``name`` on each of ``tools/probe_dcn.py``'s
    inputs of it (a tile probe's three inputs at each of ``GEOMETRIES``,
    P5's their own): each tree's wrapper in its ``ops/probes.py``
    (the other's is ``other_probes``, with its own ``Geometry``) on the
    same tensors."""
    short = name[len("probe_"):]
    this, other = probes.PROBES[short], other_probes.PROBES[short]
    lib = this.library
    if short in ("p1", "p2", "p3", "p4"):
        return [(label, (lambda a=a: this.kernel(*a)),
                 (lambda a=a: other.kernel(*a)),
                 None if lib is None else (lambda a=a: lib(*a)))
                for label, a, _ in probe_dcn.p5_cases(short, SEED, device)]
    calls = []
    for geom in probes.GEOMETRIES:
        theirs = other_probes.Geometry(**dataclasses.asdict(geom))
        for case in probe_dcn.CASES:
            inp = probe_dcn.tile_inputs(this.script, geom, case, SEED, device)
            a = [inp[k] for k in this.kernel.inputs]
            calls.append((
                probe_dcn.tile_label(case, geom),
                (lambda a=a, g=geom: this.kernel(*a, geom=g)),
                (lambda a=a, g=theirs: other.kernel(*a, geom=g)),
                None if lib is None else (lambda a=a, g=geom: lib(*a, g))))
    return calls


def hold_probe(got, want, rtol: float, what: str, label: str) -> float:
    """Exits unless got is want within rtol of its largest magnitude (0:
    bitwise); returns the relative error."""
    rel = rel_err(got, want)
    if not (torch.equal(got, want) if rtol == 0 else rel <= rtol):
        raise SystemExit(f"compare_kernels: {what} differ on {label}: "
                         f"relative {rel:.3e}, the probe's rtol {rtol:g} "
                         "(0: bitwise)")
    return rel


def device_turns(fn_other, fn_this, n: int = DEVICE_LAUNCHES):
    """(other, this): the mean device time alone of each (``time_device``
    over n calls), in turns (other, this, this, other)."""
    dev = ([], [])
    for which in (0, 1, 1, 0):
        dev[which].append(time_device((fn_other, fn_this)[which], n))
    return statistics.mean(dev[0]), statistics.mean(dev[1])


def compare_probe(name: str, other_probes, device):
    """The report entry of probe kernel ``name``: per input, both trees'
    outputs within the probe's ``rtol`` (else exit), each tree's time per
    call and by device time alone in turns, and the yardstick's device
    time alone where there is one."""
    short = name[len("probe_"):]
    rtol = probes.PROBES[short].rtol
    rows = []
    for label, fn_this, fn_other, library in probe_calls(
            name, other_probes, device):
        rel = hold_probe(fn_this(), fn_other(), rtol,
                         f"{name} of the two trees", label)
        ms_other, ms_this = time_turns(fn_other, fn_this, REPS)
        other_dev, this_dev = device_turns(fn_other, fn_this)
        row = {"case": label, "ms": ms_this, "other_ms": ms_other,
               "device_ms": this_dev, "other_device_ms": other_dev,
               "max_rel_err": rel, "library_device_ms": None}
        line = (f"{name} {label}: device alone this {this_dev:.5f} ms, "
                f"other {other_dev:.5f} ms")
        if library is not None:
            row["library_device_ms"] = time_device(library)
            line += f", library {row['library_device_ms']:.5f} ms"
        rows.append(row)
        print(f"{line}; per call this {ms_this:.4f} ms, other "
              f"{ms_other:.4f} ms (rel err {rel:.2e}, rtol {rtol:g})")
    return {"per_case": rows}


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


def at_batch(shapes, batch=None):
    """The (B, C, H, W, O) node shapes with B replaced by ``batch`` (as
    they are where ``batch`` is None)."""
    if batch is None:
        return list(shapes)
    return [(batch,) + tuple(s[1:]) for s in shapes]


def node_inputs(shape, dtype, device, seed: int):
    """x, offset, mask, weight, bias and output gradient of one node: x and
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
    return x, off, mask, wt, bias, g


def rel_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(rel_err(a, b) for a, b in zip(got, want)
                   if a is not None)
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


def compare_dcn(names, other, args, device, report) -> None:
    """Adds to ``report`` the entries of DCN kernels ``names`` against
    ``other`` (the other tree's ``ops/dcn.py``, or None with ``--overlap``)
    at the training node shapes (``args.batch``: at that batch)."""
    shapes, accum = training_node_shapes(device)
    micro = shapes[0][0]
    shapes = at_batch(shapes, args.batch)
    batch = shapes[0][0]
    torch.cuda.empty_cache()
    report.update(batch=batch, microbatches=accum)
    for name in names:
        dtype, rows = dtype_of(name), []
        for i, shape in enumerate(sorted(set(shapes), key=shapes.index)):
            inputs = node_inputs(shape, dtype, device, SEED + i)
            fn_this, free_this = kernel_call(name, dcn, inputs)
            fn_other, free_other = ((overlap_call(fn_this), free_this)
                                    if args.overlap
                                    else kernel_call(name, other, inputs))
            with torch.no_grad():
                got, want = free_this(fn_this()), free_other(fn_other())
                rel = rel_err(got, want)
                if args.overlap and not torch.equal(got, want):
                    raise SystemExit(
                        f"compare_kernels: {name} and its overlap variant "
                        f"differ at {shape}: relative {rel:.3e}")
                if not rel <= RTOL[dtype]:
                    raise SystemExit(
                        f"compare_kernels: {name} of the two trees disagree "
                        f"at {shape}: relative {rel:.3e} > {RTOL[dtype]}")
                ms_other, ms_this = time_turns(fn_other, fn_this, REPS)
                row = {"shape": list(shape), "nodes": shapes.count(shape),
                       "ms": ms_this, "other_ms": ms_other,
                       "max_rel_err": rel}
                line = (f"{name} {tuple(shape)} x{row['nodes']}: this "
                        f"{ms_this:.4f} ms, other {ms_other:.4f} ms")
                if args.overlap:
                    row["overlap_variant"] = (dtype != torch.bfloat16
                                              or shape[4] <= 128)
                    if not row["overlap_variant"]:
                        line += " (no overlap variant: the same kernel)"
                row["other_device_ms"], row["device_ms"] = device_turns(
                    fn_other, fn_this, BACKWARD_DEVICE_LAUNCHES
                    if name in BACKWARD else DEVICE_LAUNCHES)
                line += (f"; device alone this {row['device_ms']:.4f} "
                         f"ms, other {row['other_device_ms']:.4f} ms")
            rows.append(row)
            print(f"{line} (rel err {rel:.2e})")
            del inputs, fn_this, fn_other, got, want
            torch.cuda.empty_cache()
        keys = ["ms", "other_ms", "device_ms", "other_device_ms"]
        per_forward = {k: sum(r[k] * r["nodes"] for r in rows) for k in keys}
        entry = {"per_node_shape": rows, "per_forward": per_forward}
        print(f"{name} per forward ({len(shapes)} nodes at B={batch}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in per_forward.items()))
        if batch == micro:
            entry["per_unfrozen_step"] = {
                k: accum * v for k, v in per_forward.items()}
            print(f"{name} per unfrozen step ({accum} microbatches): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              entry["per_unfrozen_step"].items()))
        report["kernels"][name] = entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    other_side = ap.add_mutually_exclusive_group(required=True)
    other_side.add_argument("--other", metavar="DIR",
                            help="another checkout, inside this one")
    other_side.add_argument("--overlap", action="store_true",
                            help="the forward kernels against their "
                                 "in-block overlap variant")
    ap.add_argument("--kernel", action="append", required=True,
                    choices=KERNELS + PROBE_KERNELS + WARP_KERNELS)
    ap.add_argument("--batch", type=int, default=None, metavar="N",
                    help="images per node call (default: the training "
                         "microbatch, 13)")
    args = ap.parse_args(argv)
    if args.batch is not None and args.batch < 1:
        raise SystemExit("compare_kernels: --batch must be >= 1")
    if args.overlap:
        if not set(args.kernel) <= set(FORWARD):
            raise SystemExit("compare_kernels: --overlap takes only the "
                             "forward kernels " + ", ".join(FORWARD))
    else:
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
    other = None if args.overlap else load_other(other_root)
    report = {"card": card[0] if card else None,
              "other": "overlap" if args.overlap else args.other,
              "kernels": {}}
    for name in [k for k in args.kernel if k in PROBE_KERNELS]:
        report["kernels"][name] = compare_probe(name, other.probes, device)
    if "warp_affine" in args.kernel:
        compare_warp(load_other_warp(other_root), device, report)
    names = [k for k in args.kernel
             if k not in PROBE_KERNELS + WARP_KERNELS]
    if names:
        compare_dcn(names, None if other is None else other.dcn, args,
                    device, report)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
