"""Flagship-scale training convergence check on the card.

The port of ``scripts/overfit_tpu.py``: overfit a synthetic nuScenes scene
at the production shape and config (448x800, batch 4, DeformConv nodes,
K 16, bf16 as ``MIXED_PRECISION`` ships) across the DEFREEZE boundary,
then decode the batch in eval mode and check that the GT objects come
back. It proves the card's training path end to end: the frozen and the
unfrozen step (the bf16 DCN forward and backward kernels), the optimizer
across the boundary, eval decode and post-process.

The run: ``make_synthetic_nuscenes(root, n_samples=4, img_wh=(800, 448),
n_objects=3, seed=7)``, the model's own initialisers under
``torch.manual_seed(0)`` (JAX: ``model.init(PRNGKey(0))``), 400 steps of
``training/state.py:train_step`` on the one batch, frozen before
``DEFREEZE = 150`` at lr 2e-4, the full backward after at 5e-5. Asserted as
the script asserts them:

- the loss falls at least 5x;
- the boundary is continuous (the first unfrozen step's loss, computed
  before its update, within max(1, 0.6x) of the last five frozen ones);
- the loss is finite after the boundary and back within 20x of the
  frozen level by the fifth unfrozen step, and descent continues;
- GT recovery: per annotation, a detection of its class with score > 0.25
  and depth within 20 %; hits >= 2 x misses.

Then the trained ``|offset|`` per DCN node (mean / p99 / max, output
pixels), read by forward hooks on each node's offset conv. The DCN is the
exact one (the TPU ``shift`` choice of the script is a TPU workaround).
``--steps``, ``--defreeze`` and ``--img-wh`` exist to run it tiny; their
defaults are the script's. Whether the loss is back within 20x five steps
after the boundary depends on the initial draw (the first unfrozen AdamW
step can push both depth heads into the saturated end of ``1/sigmoid - 1``
for a while): ``--seed`` picks the draw, 0 as the script's ``PRNGKey(0)``.

    python -m centerfusiondetect3d_tpu_torch.tools.overfit [--device cpu]
        [--steps N] [--defreeze N] [--img-wh W H] [--seed N] [KEY VALUE ...]

It runs on the CUDA card unless ``--device`` names another device; exit
code 0 when every assertion holds.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import NuScenesDataset
from ..data.pipeline import stack_items, to_device
from ..data.synthetic import make_synthetic_nuscenes
from ..geometry.affine import get_affine_transform
from ..losses import GenericLoss
from ..models import build_model
from ..models.layers import DeformConvNode
from ..ops.decode import fusion_decode
from ..ops.postprocess import post_process
from ..training import make_optimizer, train_step
from ..utils.device import resolve_device

STEPS = 400
DEFREEZE = 150
LR_FROZEN = 2e-4
LR_UNFROZEN = 5e-5  # the flagship's LR through its DEFREEZE
N_SAMPLES = 4
IMG_WH = (800, 448)
N_OBJECTS = 3
DATA_SEED = 7
INIT_SEED = 0
K = 16
SCORE_MIN = 0.25
DEPTH_RTOL = 0.2
WINDOW = 5  # steps each side of the boundary
OPTS = ["MODEL.DLA.NODE", "DeformConv", "MODEL.K", str(K)]


def overfit_config(root: str, img_wh=IMG_WH, opts=()):
    """The script's config: the data under ``root``, the input at the
    images' size, DeformConv nodes, K 16, everything else default (bf16)."""
    w, h = img_wh
    return load_config(opts=["DATASET.ROOT", repr(root.rstrip("/") + "/"),
                             "MODEL.INPUT_SIZE", f"({h}, {w})"]
                       + OPTS + list(opts), num_classes=10)


def make_batch(cfg, device, n: int = N_SAMPLES):
    """The dataset and the first ``n`` eval items of ``mini_val`` stacked:
    (dataset, the numpy batch, the device batch)."""
    ds = NuScenesDataset(cfg, "mini_val", device=device)
    items = [ds.get_item(i, rng=None) for i in range(n)]
    batch = stack_items([{k: v for k, v in it.items() if k != "meta"}
                         for it in items])
    return ds, batch, to_device(batch, device)


def run_steps(model, cfg, batch, steps: int = STEPS,
              defreeze: int = DEFREEZE,
              on_step: Optional[Callable[[int, bool], None]] = None,
              log: Callable[[str], None] = print) -> List[float]:
    """``steps`` train steps on ``batch``: frozen before ``defreeze`` at
    ``LR_FROZEN``, unfrozen after at ``LR_UNFROZEN``, one AdamW of ``cfg``
    throughout. Returns each step's total loss (computed before its
    update); ``on_step(i, frozen)`` runs after step i."""
    optimizer = make_optimizer(cfg, model)
    loss_fn = GenericLoss(cfg)
    totals = []
    t0 = time.perf_counter()
    for i in range(steps):
        frozen = i < defreeze
        metrics = train_step(model, optimizer, loss_fn, batch,
                             LR_FROZEN if frozen else LR_UNFROZEN, frozen)
        totals.append(metrics["total"].detach())
        if on_step is not None:
            on_step(i, frozen)
        if i % 50 == 0 or i == steps - 1 or i == defreeze:
            tag = " <- DEFREEZE boundary" if i == defreeze else ""
            log(f"step {i:4d}: loss {float(totals[-1]):8.3f} "
                f"({time.perf_counter() - t0:6.1f}s){tag}")
    return [float(t) for t in totals]


def _check(ok, *what) -> None:
    """The script's ``assert``, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def check_losses(losses: List[float], defreeze: int = DEFREEZE) -> Dict:
    """The script's assertions on a loss sequence (AssertionError on a
    failure); returns the figures they read."""
    first, last = losses[0], losses[-1]
    pre_boundary = losses[max(0, defreeze - WINDOW):defreeze]
    post_boundary = losses[defreeze:defreeze + WINDOW]
    _check(last < first / 5, "loss did not fall 5x", first, last)
    rec = {"first": first, "last": last, "ratio": first / max(last, 1e-9)}
    if not pre_boundary or not post_boundary:
        return rec  # the run does not cross the boundary
    pre = float(np.mean(pre_boundary))
    at_boundary = post_boundary[0]
    # (a) forward continuity at the boundary step: same weights, loss
    # computed before the first unfrozen update
    _check(abs(at_boundary - pre) < max(1.0, 0.6 * pre),
           "discontinuous at the boundary", pre, at_boundary)
    # (b) the first unfrozen AdamW update moves every backbone weight by
    # ~lr, and heads overfit against frozen features spike transiently:
    # finiteness and recovery within 20x of the frozen level ...
    _check(np.isfinite(post_boundary).all(), "non-finite", post_boundary)
    _check(post_boundary[-1] < 20 * max(pre, 1.0),
           "no recovery after the boundary", pre, post_boundary)
    # ... and (c) descent continues after the boundary
    _check(last < post_boundary[-1], "no descent after the boundary", last,
           post_boundary)
    rec.update(pre=pre, at_boundary=at_boundary,
               post_max=float(max(post_boundary)),
               post_last=post_boundary[-1])
    return rec


@torch.no_grad()
def eval_detections(model, cfg, batch):
    """Eval-mode forward, ``fusion_decode`` and ``post_process`` with the
    script's inverse affine (center (W/2, H/2), scale W); numpy scores,
    3D locations and 1-based classes, each (B, K)."""
    model.eval()
    outs = model(batch["image"], batch.get("pc_dep"), batch.get("calib"))
    dets = fusion_decode([outs], cfg.MODEL.OUTPUT_SIZE, k=int(cfg.MODEL.K))
    oh, ow = cfg.MODEL.OUTPUT_SIZE
    ih, iw = cfg.MODEL.INPUT_SIZE
    trans = get_affine_transform(np.array([iw / 2.0, ih / 2.0]), float(iw),
                                 0, (ow, oh), inverse=True)
    res = post_process(dets, trans, (oh, ow), batch["calib"])
    return (res["scores"].float().cpu().numpy(),
            res["locations"].float().cpu().numpy(),
            res["classIds"].cpu().numpy())


def gt_recovery(ds, scores, locs, classes):
    """(hits, misses) over the batch's annotations (the script's rule)."""
    hits = misses = 0
    for b in range(scores.shape[0]):
        anns = ds.coco.load_anns(ds.coco.get_ann_ids(ds.images[b]))
        for a in anns:
            ok = any(int(classes[b, k]) == a["category_id"]
                     and scores[b, k] > SCORE_MIN
                     and abs(float(locs[b, k, 2]) - a["depth"])
                     < DEPTH_RTOL * a["depth"]
                     for k in range(scores.shape[1]))
            hits += ok
            misses += not ok
    return hits, misses


@torch.no_grad()
def offset_table(model, batch):
    """[(node name, mean, p99, max of |offset|)] per DeformConv node in
    call order: the 18 offset channels of each node's ``conv_offset_mask``
    output in an eval-mode forward, read by forward hooks."""
    rows, handles = [], []
    for name, module in model.named_modules():
        if isinstance(module, DeformConvNode):
            def hook(mod, inputs, out, name=name):
                off = out[:, :18].float().abs().flatten().cpu().numpy()
                rows.append((name.replace(".", "/"), float(off.mean()),
                             float(np.percentile(off, 99)),
                             float(off.max())))
            handles.append(module.conv_offset_mask.register_forward_hook(hook))
    try:
        model.eval()
        model(batch["image"], batch.get("pc_dep"), batch.get("calib"))
    finally:
        for h in handles:
            h.remove()
    return rows


def run(device=None, steps: int = STEPS, defreeze: int = DEFREEZE, opts=(),
        img_wh=IMG_WH, on_step=None, log: Callable[[str], None] = print,
        seed: int = INIT_SEED) -> Dict:
    """The whole check on ``device``: data, model, the steps, the
    assertions, GT recovery and the offset table; returns the record
    (AssertionError where a check fails)."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="cfd_overfit_") as root:
        make_synthetic_nuscenes(root, n_samples=N_SAMPLES, img_wh=img_wh,
                                n_objects=N_OBJECTS, seed=DATA_SEED)
        cfg = overfit_config(root, img_wh, opts)
        ds, _, batch = make_batch(cfg, device)
        torch.manual_seed(seed)
        model = build_model(cfg).to(device)
        t0 = time.perf_counter()
        losses = run_steps(model, cfg, batch, steps, defreeze, on_step, log)
        seconds = time.perf_counter() - t0
        rec = check_losses(losses, defreeze)
        log(f"loss {rec['first']:.2f} -> {rec['last']:.2f} "
            f"({rec['ratio']:.1f}x) in {seconds:.1f} s")
        if "pre" in rec:
            log(f"defreeze boundary: pre {rec['pre']:.3f} at "
                f"{rec['at_boundary']:.3f} post-max {rec['post_max']:.3f} "
                f"final {rec['last']:.3f}")
        hits, misses = gt_recovery(ds, *eval_detections(model, cfg, batch))
        log(f"GT recovery: {hits} hit / {misses} missed")
        _check(hits >= 2 * misses, "GT not recovered", hits, misses)
        rows = offset_table(model, batch)
    log("trained |offset| per DCN node (mean / p99 / max, output px):")
    for name, m, p99, mx in rows:
        log(f"  {m:6.3f} {p99:6.3f} {mx:6.3f}  {name}")
    return {"losses": losses, "seconds": seconds, "hits": hits,
            "misses": misses, "offsets": rows, **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--defreeze", type=int, default=DEFREEZE)
    ap.add_argument("--seed", type=int, default=INIT_SEED,
                    help="the initial weights' draw (torch.manual_seed)")
    ap.add_argument("--img-wh", type=int, nargs=2, default=IMG_WH,
                    metavar=("W", "H"),
                    help="the synthetic images' size, the model's input")
    ap.add_argument("opts", nargs="*", default=[],
                    help="extra dotted config overrides")
    args = ap.parse_args(argv)
    run(args.device, args.steps, args.defreeze, args.opts,
        img_wh=tuple(args.img_wh), seed=args.seed, log=lambda s: print(s, flush=True))
    print("OVERFIT CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
