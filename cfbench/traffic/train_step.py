"""Closed-loop training through ``training/state.py:train_step``.

Traffic: a pool of ``pool_batches`` seeded batches of ``batch`` items made
on the card in set-up and cycled: textured 448x800 images with bright
object boxes, and the targets of 3 to ``max_objects`` objects an item (the
object counts the same set for every seed, in a seeded order): the class
heatmap with a Gaussian at each centre, the centre index, offset, 2D size,
depth, 3D size, amodal offset, rotation bins and residuals, attributes and
velocity; for a radar configuration also the radar map and the
ground-truth frustum heatmap. One step is ``train_step`` on a batch in
``accum`` microbatches (``TRAIN.GRAD_ACCUM``), with the backbone frozen
where the cell says so, then the host's sync on its loss. The step object
(model, AdamW, loss) is built once; its first three steps run in set-up,
through the window's own call, on three different batches, and the check
follows them.

End-to-end: the images of the steps completed in the window, and the
share of the step in flight at the close that fell inside the window, over
the window's seconds (``train_images_per_s``).

Check: the reference follows the program from its own state, since a
random network amplifies rounding from layer to layer. Step 1: each stage
of the forward on the program's input to it (``fwd_rms``); each stage's
backward on the program's gradient at its output, against the program's
gradient at each stage input and at the head outputs, whose gradient is
the reference loss's (``bwd_rms``); the reference's parameter gradients
against the first gradient as the program's AdamW holds it after one step,
by the norm of each leaf (``grad_err``); at each DCN node's deformable op
of the first microbatch, the reference op's gradients of x, offset, mask
and weight on the program's inputs to the op and its gradient at the op's
output, against the program's (``dcn_bwd_rms``; unfrozen only: a frozen
step runs no DCN backward). Steps 1-3: the loss parts against
the reference loss of the program's head maps (``loss_err``), and each
leaf's change after the three steps against the reference AdamW fed the
program's own gradients (``update_err``). Leaves whose reference gradient
is below a thousandth of the median leaf's are left out of the last two.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from cfbench import counting, weights
from cfbench.follow import (Capture, flat_tensors, rel_rms, stages,
                            tf32_off)
from cfbench.harness import Check
from cfbench.reference import loss as rloss
from cfbench.reference.model import build_reference, round_fp8

TRACE_SECONDS = 6.0
CHECKED_STEPS = 3
MAX_OBJS = 128  # object slots an item
ACT = {"heatmap": lambda t: torch.clamp(torch.sigmoid(t), 1e-4, 1 - 1e-4),
       "depth": lambda t: 1.0 / (torch.sigmoid(t) + 1e-6) - 1.0}
ACT["depth2"] = ACT["depth"]


# ------------------------------------------------------------------ traffic
def make_batches(run, device) -> List[Dict]:
    """The seeded pool: ``pool_batches`` dicts of device tensors."""
    p, m = run.params, run.config["model"]
    b, n_pool = int(p["batch"]), int(p["pool_batches"])
    in_h, in_w = m["input_size"]
    oh, ow = in_h // 4, in_w // 4
    ncls = int(m["heads"]["heatmap"])
    radar = bool(m["middle_fusion"])
    rng = np.random.default_rng(run.seed)
    counts = rng.permutation(np.linspace(3, int(p["max_objects"]),
                                         b * n_pool).round().astype(int))
    gen = torch.Generator(device=device).manual_seed(run.seed)
    yy = torch.arange(oh, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(ow, device=device, dtype=torch.float32)[None, :]
    iy = torch.arange(in_h, device=device, dtype=torch.float32)[:, None]
    ix = torch.arange(in_w, device=device, dtype=torch.float32)[None, :]
    pool = []
    for k in range(n_pool):
        f = lambda *s: np.zeros((b, MAX_OBJS) + s, np.float32)
        cls, mask, cen, wh, reg, dep, dim, amo, vel, rres, att, attm = (
            f(), f(), f(2), f(2), f(2), f(1), f(3), f(2), f(3), f(2), f(8),
            f(8))
        rbin = np.zeros((b, MAX_OBJS, 2), np.int64)
        heat = torch.zeros(b, ncls, oh, ow, device=device)
        image = torch.empty(b, 3, in_h, in_w, device=device)
        pc_dep = torch.zeros(b, 3, oh, ow, device=device) if radar else None
        pc_hm = torch.zeros(b, 3, oh, ow, device=device) if radar else None
        base = 0.4 * torch.sin(ix / 9.0) * torch.cos(iy / 13.0)
        for i in range(b):
            n = int(counts[k * b + i])
            bw = rng.uniform(2, min(48, ow / 3), n)
            bh = rng.uniform(2, min(36, oh / 3), n)
            cx = rng.uniform(bw / 2 + 1, ow - bw / 2 - 1)
            cy = rng.uniform(bh / 2 + 1, oh - bh / 2 - 1)
            c = rng.integers(0, ncls, n)
            alpha = rng.uniform(-np.pi, np.pi, n)
            cls[i, :n], mask[i, :n] = c, 1.0
            cen[i, :n] = np.stack([np.floor(cx), np.floor(cy)], 1)
            reg[i, :n] = np.stack([cx - np.floor(cx), cy - np.floor(cy)], 1)
            wh[i, :n] = np.stack([bw, bh], 1)
            dep[i, :n, 0] = rng.uniform(5.0, 55.0, n)
            dim[i, :n] = np.stack([rng.uniform(1.4, 2.0, n),
                                   rng.uniform(1.6, 2.1, n),
                                   rng.uniform(3.6, 5.0, n)], 1)
            amo[i, :n] = rng.normal(0, 0.5, (n, 2))
            vel[i, :n] = rng.normal(0, 3.0, (n, 3))
            rbin[i, :n, 0] = (alpha < np.pi / 6) | (alpha > 5 * np.pi / 6)
            rbin[i, :n, 1] = (alpha > -np.pi / 6) | (alpha < -5 * np.pi / 6)
            rres[i, :n] = np.stack([alpha + 0.5 * np.pi,
                                    alpha - 0.5 * np.pi], 1)
            a = rng.integers(0, 8, n)
            att[i, np.arange(n), a] = 1.0
            attm[i, :n, :] = 1.0
            img = base + 0.3 * torch.randn(3, in_h, in_w, generator=gen,
                                           device=device)
            sig = np.maximum(np.minimum(bw, bh) / 6.0, 0.8)
            for j in range(n):
                g = torch.exp(-((xx - float(np.floor(cx[j]))) ** 2
                                + (yy - float(np.floor(cy[j]))) ** 2)
                              / (2 * sig[j] ** 2))
                heat[i, c[j]] = torch.maximum(heat[i, c[j]], g)
                x0, x1 = int(4 * (cx[j] - bw[j] / 2)), int(4 * (cx[j] + bw[j] / 2))
                y0, y1 = int(4 * (cy[j] - bh[j] / 2)), int(4 * (cy[j] + bh[j] / 2))
                img[:, y0:y1, x0:x1] = float(c[j]) / ncls - 0.5
                if radar:
                    v = torch.tensor([dep[i, j, 0] / 60.0, vel[i, j, 0],
                                      vel[i, j, 2]], device=device)
                    w3, h3 = max(1, int(0.15 * bw[j])), max(1, int(0.15 * bh[j]))
                    pc_hm[i, :, int(cy[j]) - h3:int(cy[j]) + h3 + 1,
                          int(cx[j]) - w3:int(cx[j]) + w3 + 2] = v[:, None, None]
                    pc_dep[i, 0, int(cy[j]), int(cx[j])] = float(dep[i, j, 0])
            image[i] = img
        t = lambda a: torch.from_numpy(a).to(device)
        batch = {"image": image, "heatmap0": heat, "classIds": t(cls),
                 "mask": t(mask), "widthHeight": t(wh), "reg": t(reg),
                 "depth": t(dep), "dimension": t(dim),
                 "amodal_offset": t(amo), "velocity": t(vel),
                 "rotbin": t(rbin), "rotres": t(rres),
                 "nuscenes_att": t(att), "nuscenes_att_mask": t(attm),
                 "truncMask": t(np.zeros((b, MAX_OBJS), np.float32)),
                 "target": {"heatCenters": t(cen)}}
        if radar:
            fx = 0.79 * in_w
            calib = torch.tensor([[fx, 0, in_w / 2, 0], [0, fx, in_h / 2, 0],
                                  [0, 0, 1, 0]], device=device)
            batch.update(pc_dep=pc_dep, pc_hm=pc_hm,
                         calib=calib.expand(b, 3, 4).contiguous())
        pool.append(batch)
    return pool


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy (``.cpu()`` of a CPU tensor would share its storage)."""
    return t.detach().to("cpu", copy=True)


def _host(a):
    """A kept record with its tensors copied to the host."""
    if isinstance(a, torch.Tensor):
        return _copy(a)
    if isinstance(a, dict):
        return {k: _host(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_host(v) for v in a)
    return a


def _ids(a):
    """The ids of the tensors of a stage's arguments, in the same nesting."""
    if isinstance(a, torch.Tensor):
        return id(a)
    if isinstance(a, (list, tuple)):
        return [_ids(v) for v in a]
    return None


def _freeze_record(rec) -> Dict:
    """A microbatch's stage record on the host, each tensor under the id
    it had on the device (stage arguments share tensors)."""
    out = {"stages": {}, "grads": {}, "tensors": {}}
    for name, (args, o) in rec.get("stages", {}).items():
        out["stages"][name] = (_ids(args), _ids(o),
                               [a if not isinstance(a, (torch.Tensor, list,
                                                        tuple)) else None
                                for a in args])
        for t in flat_tensors(args) + flat_tensors(o):
            if id(t) not in out["tensors"]:
                out["tensors"][id(t)] = _copy(t)
    for k, g in rec.get("grads", {}).items():
        if g is not None:
            out["grads"][k] = _copy(g)
    if "y" in rec:
        out["y"] = _host(rec["y"])
    out["dcn"] = {name: {"in": _host(node["in"]),
                         "grads": _host(node["grads"])}
                  for name, node in rec.get("dcn", {}).items()}
    return out


# ------------------------------------------------------------------- loop
def program_config(run):
    from centerfusiondetect3d_tpu_torch.config import load_config

    return load_config(opts=list(run.config["opts"])
                       + list(run.params.get("opts", [])))


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(run):
    from centerfusiondetect3d_tpu_torch.losses.generic import GenericLoss
    from centerfusiondetect3d_tpu_torch.models.detector import build_model
    from centerfusiondetect3d_tpu_torch.training.state import make_optimizer

    device, p = run.device, run.params
    with run.setup_part("weights"):
        ref = build_reference(run.config).to(device)
        ref.load_state_dict(weights.seeded_state(ref, run.seed, device),
                            strict=False)
        full = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    with run.setup_part("pool"):
        pool = make_batches(run, device)
    with run.setup_part("build"):
        cfg = program_config(run)
        model = build_model(cfg).to(device)
        model.load_state_dict(full, strict=True)
        opt = make_optimizer(cfg, model)
        loss_fn = GenericLoss(cfg)
    accum = int(cfg.TRAIN.GRAD_ACCUM)
    lr = float(cfg.TRAIN.LR)
    frozen = bool(p["frozen"])
    cap = Capture(model, stages(ref), range(accum),
                  range(accum * CHECKED_STEPS), grads=True, dcn_want=[0])
    names = {id(t): n for n, t in model.named_parameters()}
    st = {"model": model, "opt": opt, "loss_fn": loss_fn, "pool": pool,
          "lr": lr, "frozen": frozen, "accum": accum, "ref": ref,
          "p0": {k: _copy(v) for k, v in full.items()}, "steps": [],
          "moments": [], "cap": cap, "i": 0}
    with run.setup_part("checked_steps"):
        for _ in range(CHECKED_STEPS):
            metrics = step(st)
            st["steps"].append({k: float(v) for k, v in metrics.items()})
            st["moments"].append({
                names[id(q)]: _copy(s["exp_avg"])
                for q, s in opt.state.items() if "exp_avg" in s})
        st["p3"] = {n: _copy(q) for n, q in model.named_parameters()}
        st["kept"] = {i: _freeze_record(r) for i, r in cap.kept.items()}
        cap.release()
        st["cap"] = cap = None
        gc.collect()  # the records' tensor hooks hold them in cycles
    with run.setup_part("warmup"):
        for _ in range(int(p["warmup_steps"])):
            float(step(st)["total"])
    _sync(run)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return st


def step(st) -> Dict[str, torch.Tensor]:
    """One step of the program on the next batch of the pool (its own
    ``train_step``, looked up at the call)."""
    from centerfusiondetect3d_tpu_torch.training import state as train_state

    batch = st["pool"][st["i"] % len(st["pool"])]
    st["i"] += 1
    return train_state.train_step(st["model"], st["opt"], st["loss_fn"],
                                  batch, st["lr"], frozen=st["frozen"],
                                  accum_steps=st["accum"])


def window(run, st):
    b = int(run.params["batch"])
    t_open = run.open_window()
    t_close = t_open + run.seconds
    t_trace = t_open + min(run.seconds, TRACE_SECONDS)
    run.trace.start()
    traced, done, failed, t_prev, share = 0, 0, 0, t_open, 0.0
    while True:
        with run.spans.span("train.enqueue"):
            metrics = step(st)
        with run.spans.span("train.sync"):
            total = float(metrics["total"])
        t = time.perf_counter()
        if t > t_close:  # the step in flight at the close: its share
            share = (t_close - t_prev) / (t - t_prev)
            break
        t_prev = t
        done += 1
        failed += not math.isfinite(total)
        if run.trace.active:
            traced += 1
            if t >= t_trace:
                run.counters.update(
                    kind="train", units=traced,
                    enqueue_s=list(run.spans.times["train.enqueue"][-traced:]))
                run.trace.stop(lambda: _sync(run))
    if run.trace.active:
        run.counters.update(kind="train", units=traced,
                            enqueue_s=list(run.spans.times["train.enqueue"]
                                           [-traced:]))
        run.trace.stop(lambda: _sync(run))
    _sync(run)
    return {"metrics": {"train_images_per_s": (done + share) * b
                        / run.seconds},
            "attempted": done, "failed": failed,
            "counts": {"steps_in_window": done, "share_of_the_last": share,
                       "images_a_step": b}}


# ------------------------------------------------------------------- check
def _build(ids, tensors, device, grad: bool):
    """A stage's arguments rebuilt from ids on ``device`` in float32, each
    a leaf that requires grad where ``grad``; returns (args, leaves)."""
    leaves: Dict[int, torch.Tensor] = {}

    def make(i):
        if isinstance(i, list):
            return [make(v) for v in i]
        if i is None:
            return None
        if i not in leaves:
            t = tensors[i].to(device).float()
            leaves[i] = t.requires_grad_(grad and t.is_floating_point())
        return leaves[i]
    return make(ids), leaves


def _stage_grads(module, name, arg_ids, out_ids, consts, tensors,
                 prog_grads, device, bf16: bool):
    """One stage of the reference on the program's input to it, and its
    backward on the program's gradient at its output; ``bf16``: under
    bf16 autocast (the witness of what bf16 arithmetic alone gives).
    Returns (pairs of (reference output, the program's id) for the
    forward gap, {input id: gradient}, {parameter name: gradient})."""
    args, leaves = _build(arg_ids, tensors, device, True)
    args = [a if c is None else c for a, c in zip(args, consts)]
    own = [] if bf16 else list(module.named_parameters())
    dx: Dict[int, torch.Tensor] = {}
    with torch.enable_grad(), torch.autocast(device.type, torch.bfloat16,
                                             enabled=bf16):
        r = module(*args)
        if isinstance(r, list):  # an IDA step: the levels it made
            s, e = args[1] + 1, args[2]
            pairs = list(zip(r[s:e], out_ids[s:e]))
        else:
            pairs = [(r, out_ids)]
        have = [(rt, oid, prog_grads[oid].to(device).to(rt.dtype))
                for rt, oid in pairs if oid in prog_grads]
        if not have:
            return pairs, dx, {}
        # an IDA step makes level k + 1 from level k: the program's
        # gradient at level k holds that path already, so each level is
        # fed its gradient from outside the step alone, and the path
        # inside counts toward level k's gradient
        outs = [rt for rt, _, _ in have]
        total = [g for _, _, g in have]
        g_out = list(total)
        for k in range(len(outs) - 1):
            inner, = torch.autograd.grad(outs[k + 1], outs[k], total[k + 1],
                                         retain_graph=True)
            g_out[k] = total[k] - inner
            dx[have[k][1]] = inner.float()
        want = list(leaves.values()) + [q for _, q in own]
        got = torch.autograd.grad(outs, want, g_out, allow_unused=True)
    for i, g in zip(leaves, got[:len(leaves)]):
        if g is not None:
            dx[i] = dx[i] + g.float() if i in dx else g.float()
    grads = {f"{name}.{n}": g for (n, _), g in zip(own, got[len(leaves):])
             if g is not None}
    return pairs, dx, grads


def follow_step(ref, kept: Dict[int, Dict], batches, weights_: Dict,
                device, detail: bool = False) -> Dict:
    """The reference through the program's first step, stage by stage:
    the forward and backward gaps and its parameter gradients. With
    ``detail`` also ``bwd_by``: for each stage (and ``heads``), the
    largest gap of the program's gradient at its inputs, and that of the
    reference's own under bf16 autocast, each from the float32
    reference's."""
    out = {"fwd_rms": 0.0, "bwd_rms": 0.0, "bwd_by": {}}
    grads: Dict[str, torch.Tensor] = {}
    ref.train()

    def note(label, gap, witness=None):
        out["bwd_rms"] = max(out["bwd_rms"], gap)
        if detail:
            have = out["bwd_by"].setdefault(label, [0.0, None])
            have[0] = max(have[0], gap)
            if witness is not None:
                have[1] = max(have[1] or 0.0, witness)

    for mb, rec in sorted(kept.items()):
        tensors, prog_grads = rec["tensors"], rec["grads"]
        rows = batches[mb]["image"].shape[0]
        if any(tensors[i].shape[0] != rows for i in tensors):
            out["fwd_rms"] = out["bwd_rms"] = math.inf  # rows left out
            continue
        dx: Dict[int, torch.Tensor] = {}
        dx16: Dict[int, torch.Tensor] = {}
        label: Dict[int, str] = {}
        heads: Dict[str, int] = {}
        for name, (arg_ids, out_ids, consts) in rec["stages"].items():
            module = ref.get_submodule(name)
            for i in flat_ids(arg_ids):
                label.setdefault(i, name)
            for i in flat_ids(out_ids):  # a level an IDA step made
                label.setdefault(i, name + ":out")
            pairs, got, g_own = _stage_grads(module, name, arg_ids, out_ids,
                                             consts, tensors, prog_grads,
                                             device, False)
            for rt, oid in pairs:
                out["fwd_rms"] = max(out["fwd_rms"], rel_rms(tensors[oid], rt))
            if name.startswith("detectHead_0."):
                heads[name.split(".")[1]] = out_ids
            for i, g in got.items():
                dx[i] = dx[i] + g if i in dx else g
            for key, g in g_own.items():
                grads[key] = grads[key] + g if key in grads else g
            if detail:
                _, got16, _ = _stage_grads(module, name, arg_ids, out_ids,
                                           consts, tensors, prog_grads,
                                           device, True)
                for i, g in got16.items():
                    dx16[i] = dx16[i] + g if i in dx16 else g
        # the gradient of the reference loss at the program's raw head
        # outputs, against the program's there
        raw = {h: tensors[oid].to(device).float().requires_grad_()
               for h, oid in heads.items() if oid in prog_grads}
        if raw:
            with torch.enable_grad():
                y = {h: ACT.get(h, lambda t: t)(t) for h, t in raw.items()}
                total = rloss.loss(y, batches[mb], weights_)["total"]
                got = torch.autograd.grad(total / len(kept),
                                          list(raw.values()))
            for h, g in zip(raw, got):
                note("heads", rel_rms(prog_grads[heads[h]], g))
        for i, g in dx.items():
            if i in prog_grads:
                note(label.get(i, "-"), rel_rms(prog_grads[i], g),
                     rel_rms(dx16[i], g) if i in dx16 else None)
    out["grads"] = grads
    return out


def flat_ids(a) -> List[int]:
    if isinstance(a, list):
        return [i for v in a for i in flat_ids(v)]
    return [] if a is None else [a]


def follow_dcn(ref, nodes: Dict[str, Dict], device) -> float:
    """The DCN backward alone: at each node's deformable op, the float32
    reference op (``cfbench/reference/model.py``, the node's seeded weight
    and bias) on the program's inputs to the op, differentiated at the
    program's gradient of its output, against the program's gradients of
    x, offset, mask (the largest relative RMS gap of one image) and weight
    (of the whole tensor); the largest over the nodes. inf where a node
    kept no gradient."""
    from cfbench.reference.model import deform_conv2d as ref_dcn

    worst = 0.0
    for name, node in nodes.items():
        g, given = node["grads"], node["in"]
        if "y" not in g or any(k not in g for k in ("x", "offset", "mask",
                                                    "weight")):
            return math.inf
        module = ref.get_submodule(name)
        leaves = [given[k].to(device).float().requires_grad_()
                  for k in ("x", "offset", "mask")]
        w = module.weight.detach().clone().requires_grad_()
        with torch.enable_grad():
            y = ref_dcn(*leaves, w, module.bias.detach(), module.quant)
            got = torch.autograd.grad(y, leaves + [w],
                                      g["y"].to(device).float())
        for k, r in zip(("x", "offset", "mask"), got[:3]):
            worst = max(worst, rel_rms(g[k], r))
        p = g["weight"].to(device).float()
        worst = max(worst, float((p - got[3]).norm()
                                 / got[3].norm().clamp(min=1e-30)))
    return worst


def _microbatch(batch, k: int, n: int):
    out = {}
    for key, v in batch.items():
        out[key] = (_microbatch(v, k, n) if isinstance(v, dict)
                    else v.chunk(n, 0)[k])
    return out


def check(run, st) -> List[Check]:
    device = run.device
    kept = st.pop("kept")
    for key in ("model", "opt", "loss_fn"):
        st.pop(key, None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return [Check(k, v, float(run.limits[k])) for k, v in
            judge(run, st, kept).items() if k in run.limits]


def judge(run, st, kept, detail: bool = False) -> Dict[str, float]:
    """The numbers (see the module's docstring) from what the program kept
    of its first three steps; ``detail``: also ``bwd_by`` (see
    :func:`follow_step`)."""
    device, accum = run.device, st["accum"]
    ref = st["ref"]
    tc = run.config["model"]
    w = {k: float(v) for k, v in tc["loss_weights"].items()}
    pool = st["pool"]
    micro = {i: _microbatch(pool[i // accum], i % accum, accum)
             for i in range(accum * CHECKED_STEPS)}
    with tf32_off():
        ref.load_state_dict({k: v.to(device) for k, v in st["p0"].items()})
        first = {i: r for i, r in kept.items() if i < accum and "stages" in r}
        if len(first) != accum:
            return {k: math.inf for k in run.limits}
        got = follow_step(ref, first, micro, w, device, detail)
        nodes = first[0].get("dcn", {})
        if bool(run.params["frozen"]):
            dcn_bwd = None  # no DCN backward in a frozen step
        elif not nodes or any(
                n["in"]["x"].shape[0] != micro[0]["image"].shape[0]
                for n in nodes.values()):
            dcn_bwd = math.inf  # no node kept, or rows left out
        else:
            dcn_bwd = follow_dcn(ref, nodes, device)
        # loss parts of the checked steps on the program's head maps
        loss_err = 0.0
        for s in range(CHECKED_STEPS):
            sums: Dict[str, float] = {}
            for k in range(accum):
                rec = kept.get(s * accum + k, {})
                if "y" not in rec:
                    return {k: math.inf for k in run.limits}
                y = {h: v.to(device).float() for h, v in rec["y"].items()}
                if y["heatmap"].shape[0] != micro[s * accum + k][
                        "image"].shape[0]:
                    loss_err = math.inf
                    continue
                with torch.no_grad():
                    parts = rloss.loss(y, micro[s * accum + k], w)
                for h, v in parts.items():
                    sums[h] = sums.get(h, 0.0) + float(v) / accum
            for h, v in sums.items():
                prog = st["steps"][s].get(h, math.nan)
                loss_err = max(loss_err, abs(prog - v) / max(abs(v), 1.0))
        # the first gradient as the optimizer holds it, and the change of
        # each leaf over the three steps
        b1 = 0.9
        m = st["moments"]
        g_prog = [{n: (m[t][n] - (b1 * m[t - 1][n] if t else 0)) / (1 - b1)
                   for n in m[t]} for t in range(CHECKED_STEPS)]
        moving = rloss.moving(got["grads"])
        grad_err = rloss.leaf_gap({n: g_prog[0].get(n, torch.zeros(1))
                                   for n in moving}, got["grads"], moving)
        opt = rloss.AdamW(float(tc["train"]["lr"]),
                          float(tc["train"]["weight_decay"]))
        params = {n: st["p0"][n].clone().float() for n in g_prog[0]}
        for t in range(CHECKED_STEPS):
            opt.step(params, {n: g.float() for n, g in g_prog[t].items()})
        d_ref = {n: params[n] - st["p0"][n] for n in params}
        d_prog = {n: st["p3"][n] - st["p0"][n] for n in params}
        upd = [n for n in moving if n in d_ref]
        update_err = rloss.leaf_gap(d_prog, d_ref, upd) if upd else math.inf
    out = {"fwd_rms": got["fwd_rms"], "bwd_rms": got["bwd_rms"],
           "loss_err": loss_err, "grad_err": grad_err,
           "update_err": update_err}
    if dcn_bwd is not None:
        out["dcn_bwd_rms"] = dcn_bwd
    if detail:
        out["bwd_by"] = got["bwd_by"]
    return out


# ------------------------------------------------------------------ control
def control(run, device) -> Dict[str, float]:
    """The check's numbers with the reference in fp8 (e4m3 operands, e5m2
    gradients) and the reference AdamW in the program's place, through the
    cell's three checked steps."""
    p, tc = run.params, run.config["model"]
    accum = int(program_config(run).TRAIN.GRAD_ACCUM)
    ref = build_reference(run.config).to(device)
    ref.load_state_dict(weights.seeded_state(ref, run.seed, device),
                        strict=False)
    p0 = {k: _copy(v) for k, v in ref.state_dict().items()}
    low = build_reference(run.config).to(device)
    low.load_state_dict({k: v.to(device) for k, v in p0.items()})
    low.quant.fn = round_fp8
    low.train()
    frozen = bool(p["frozen"])
    train = {n: q for n, q in low.named_parameters()
             if not (frozen and not n.startswith("detectHead_0."))}
    for n, q in low.named_parameters():
        q.requires_grad_(n in train)
    opt = rloss.AdamW(float(tc["train"]["lr"]),
                      float(tc["train"]["weight_decay"]))
    w = {k: float(v) for k, v in tc["loss_weights"].items()}
    pool = make_batches(run, device)
    cap = Capture(low, stages(low), range(accum), range(accum * CHECKED_STEPS),
                  grads=True, dcn_want=[0])
    st = {"ref": ref, "p0": p0, "pool": pool, "accum": accum, "steps": [],
          "moments": []}
    kept: Dict[int, Dict] = {}
    for s in range(CHECKED_STEPS):
        for q in train.values():
            q.grad = None
        sums: Dict[str, float] = {}
        for k in range(accum):
            mb = _microbatch(pool[s], k, accum)
            y = low(mb["image"], mb.get("pc_dep"), mb.get("calib"),
                    mb.get("pc_hm"))
            parts = rloss.loss(y, mb, w)
            (parts["total"] / accum).backward()
            for h, v in parts.items():
                sums[h] = sums.get(h, 0.0) + float(v.detach()) / accum
        st["steps"].append(sums)
        opt.step({n: q.data for n, q in train.items()},
                 {n: q.grad for n, q in train.items()})
        st["moments"].append({n: _copy(v) for n, v in opt.m.items()})
        kept.update({i: _freeze_record(r) for i, r in cap.kept.items()})
        cap.kept.clear()
    st["p3"] = {n: _copy(q) for n, q in low.named_parameters()}
    cap.release()
    del low, cap
    return judge(run, st, kept)


def readings(run) -> Dict[str, object]:
    """The program's numbers on ``run.seed`` with no window, each stage's
    backward gap beside that of bf16 arithmetic alone (``bwd_by``); for
    ``cfbench/control.py --side program``."""
    st = setup(run)
    kept = st.pop("kept")
    for key in ("model", "opt", "loss_fn"):
        st.pop(key, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(run, st, kept, detail=True)


# ------------------------------------------------------------ for metrics
def work(run) -> Dict[str, object]:
    """A step's work: the forward of each microbatch counted on the
    reference model on the meta device, the training rule of
    ``counting.train_flops``; the DCN nodes' shapes of its forwards and,
    unfrozen, of its backwards."""
    m = run.config["model"]
    accum = int(program_config(run).TRAIN.GRAD_ACCUM)
    b = int(run.params["batch"]) // accum
    h, w = m["input_size"]
    model = build_reference(run.config).to("meta")
    meta = dict(device="meta")
    pc = torch.zeros(b, 3, h // 4, w // 4, **meta)
    fwd = counting.count_model(model, torch.zeros(b, 3, h, w, **meta), pc,
                               torch.zeros(b, 3, 4, **meta), pc)
    frozen = ("base.", "dla_up.", "ida_up.") if run.params["frozen"] else ()
    return {"flops": accum * counting.train_flops(fwd["layers"], frozen),
            "dcn": fwd["dcn"] * accum,
            "dcn_bwd": [] if frozen else fwd["dcn"] * accum}
