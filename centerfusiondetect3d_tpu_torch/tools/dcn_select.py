"""The clamped-DCN select probes, on one input.

The port of three JAX scripts that share one input, the dominant DLA node
at serving shape: (B, H, W, C) = (6, 112, 200, 64), ``RandomState(0)``:
x ``randn``, offsets ``randn * 0.6``, mask ``rand``, weight ``randn * 0.05``
(C -> C), clamp ±1 px.

1. ``probe_dcn_select.py`` (P4 of the TPU kernels): its Pallas select and
   value-accumulation kernels are, on the card, the one hand-written bf16
   forward ``dcn_fwd_bf16`` with ``max_offset=1``. Printed: its error
   relative to the plain clamped bf16 version
   (``deform_conv2d_bf16_plain(max_offset=1)``) and its ms a call.
2. ``probe_dcn_select_xla.py``: :func:`deform_conv2d_select`, a plain
   PyTorch 4-corner select formulation of the clamped DCN (3-way
   ``torch.where`` chains over static windows, a straight-through clamp as
   the script's ``_st_clip``). Printed: its forward error against the
   clamped kernel (float32 ``dcn_fwd``), its gradients against autograd of
   ``deform_conv2d_plain(max_offset=1)`` on a small crop whose offsets lie
   strictly inside the clamp (at the boundary the straight-through and the
   clamp's gradients differ by convention), and its bf16 forward and
   float32 forward+backward ms beside the kernels' (``dcn_fwd_bf16``; the
   ``DeformConv2dFunction`` of ``dcn_fwd`` and the ``dcn_bwd.cu`` kernels).
   The formulation is a yardstick, on no main path.
3. ``probe_pallas_recheck.py``: one ``VERDICT:`` line, the clamped hand
   kernel (``dcn_fwd_bf16``, ``max_offset=1``) against the exact one at the
   same shape, timed in turns, with its error.

On the CPU the plain versions run and no time is printed. Times are CUDA
event times of a call, the median of ``--iters`` after a warm-up.

    python -m centerfusiondetect3d_tpu_torch.tools.dcn_select [--device cpu]
        [--shape B,H,W,C] [--iters N]
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import dcn
from ..utils.device import resolve_device

SHAPE = (6, 112, 200, 64)
MAX_OFFSET = 1.0
CROP = (1, 16, 24, 8)  # the gradient check's (B, H, W, C)
CROP_OFFSET_SCALE = 0.45  # the script's scale of the crop's offsets ...
CROP_OFFSET_MAX = 0.99  # ... held strictly inside the clamp (a few reach it)
BROKEN_RTOL = 0.05  # the recheck's limit on the clamped kernel's error
PAYS = 0.95  # the clamped kernel "pays" below this share of the exact
TURNS = 3  # rounds of the recheck's timing in turns


def probe_inputs(shape=SHAPE, device="cpu"):
    """The scripts' input in the port's layouts: x (B, C, H, W), offset
    (B, 18, H, W), mask (B, 9, H, W), weight (C, C, 3, 3), all float32,
    drawn as the scripts draw them (NHWC, ``RandomState(0)``)."""
    b, h, w, c = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, c).astype(np.float32)
    offset = (rng.randn(b, h, w, 18) * 0.6).astype(np.float32)
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)

    def t(a, perm):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(perm))).to(
            device)

    nchw = (0, 3, 1, 2)
    return (t(x, nchw), t(offset, nchw), t(mask, nchw),
            t(weight, (3, 2, 0, 1)))


def _st_clip(v, lo: float, hi: float):
    """Clamp in the forward, identity in the backward (straight-through)."""
    return v + (v.clamp(lo, hi) - v).detach()


def deform_conv2d_select(x, offset, mask, weight, bias=None,
                         max_offset: float = MAX_OFFSET):
    """4-corner select DCNv2 with a straight-through ±1 clamp (NCHW).

    The bilinear tent is nonzero at exactly the 2x2 integers straddling a
    sample, so each tap selects its four corners from static windows of
    the zero-padded x with 3-way ``torch.where`` chains (first over rows,
    then over columns) and blends them with the fractional weights, as JAX
    ``probe_dcn_select_xla.deform_conv2d_select``: the weights and taps in
    x's dtype, each tap's contraction accumulated in at least float32, one
    rounding at the end. float32 or bf16 x, float32 offset and mask."""
    b, c, h, w = x.shape
    if float(max_offset) != 1.0:
        raise ValueError("the select formulation is specialised to ±1")
    dtype = x.dtype
    acc = torch.promote_types(dtype, torch.float32)
    pad = 3
    xp = F.pad(x, (pad, pad, pad, pad))

    def win(gy, gx):
        return xp[:, :, pad + gy:pad + gy + h, pad + gx:pad + gx + w]

    out = None
    for k in range(9):
        i, j = divmod(k, 3)
        ty = _st_clip(offset[:, 2 * k:2 * k + 1], -1.0, 1.0) + (i - 1)
        tx = _st_clip(offset[:, 2 * k + 1:2 * k + 2], -1.0, 1.0) + (j - 1)
        fy = torch.floor(ty.detach())
        fx = torch.floor(tx.detach())
        ay = (ty - fy).to(dtype)
        ax = (tx - fx).to(dtype)
        ylo, yhi = {}, {}
        for gx in range(j - 2, j + 2):
            v = win(i - 2, gx)
            v = torch.where(fy == i - 1, win(i - 1, gx), v)
            ylo[gx] = torch.where(fy == i, win(i, gx), v)
            v2 = win(i - 1, gx)
            v2 = torch.where(fy == i - 1, win(i, gx), v2)
            yhi[gx] = torch.where(fy == i, win(i + 1, gx), v2)

        def selx(tbl, plus):
            v = tbl[j - 2 + plus]
            v = torch.where(fx == j - 1, tbl[j - 1 + plus], v)
            return torch.where(fx == j, tbl[j + plus], v)

        v00, v01 = selx(ylo, 0), selx(ylo, 1)
        v10, v11 = selx(yhi, 0), selx(yhi, 1)
        tap = ((1 - ay) * ((1 - ax) * v00 + ax * v01)
               + ay * ((1 - ax) * v10 + ax * v11))
        tap = tap * mask[:, k:k + 1].to(dtype)
        term = torch.einsum("bchw,oc->bohw", tap.to(acc),
                            weight[:, :, i, j].to(acc))
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.to(acc)[:, None, None]
    return out.to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (the scripts' measure)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def time_ms(fn: Callable, iters: int) -> float:
    """The median of ``iters`` CUDA-event times of ``fn()`` after three
    untimed calls, in ms."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_select(inputs, timed: bool, iters: int) -> Dict:
    """1: P4's kernel, ``dcn_fwd_bf16`` with ``max_offset=1`` (its plain
    version on the CPU), against the plain clamped bf16 forward."""
    x, offset, mask, weight = inputs
    xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    with torch.no_grad():
        out = dcn.dcn_fwd_bf16(xb, offset, mask, wb, None, MAX_OFFSET)
        ref = dcn.deform_conv2d_bf16_plain(xb, offset, mask, wb, None,
                                           MAX_OFFSET)
        rec = {"rel_err": rel_err(out, ref)}
        if timed:
            rec["ms"] = time_ms(lambda: dcn.dcn_fwd_bf16(
                xb, offset, mask, wb, None, MAX_OFFSET), iters)
    return rec


def _grads(fn, x, offset, mask, weight):
    """d/d(x, offset, mask, weight) of sum(fn(...) ** 2)."""
    args = [t.detach().clone().requires_grad_(True)
            for t in (x, offset, mask, weight)]
    (fn(*args) ** 2).sum().backward()
    return [a.grad for a in args]


def probe_select_xla(inputs, timed: bool, iters: int) -> Dict:
    """2: the select formulation's forward against the clamped kernel, its
    gradients against autograd of the plain clamped DCN on the crop, and
    (timed) its bf16 forward and float32 forward+backward beside the
    kernels'."""
    x, offset, mask, weight = inputs
    with torch.no_grad():
        got = deform_conv2d_select(x, offset, mask, weight)
        want = dcn.deform_conv2d(x, offset, mask, weight, None, MAX_OFFSET)
    rec = {"fwd_rel_err": rel_err(got, want), "grad_rel_err": {}}
    b, h, w, c = CROP
    crop_offset = (offset[:b, :, :h, :w] * CROP_OFFSET_SCALE).clamp(
        -CROP_OFFSET_MAX, CROP_OFFSET_MAX)
    crop = [t.contiguous() for t in (x[:b, :c, :h, :w], crop_offset,
                                     mask[:b, :, :h, :w], weight[:c, :c])]
    ga = _grads(lambda *a: dcn.deform_conv2d_plain(*a, None, MAX_OFFSET),
                *(t.cpu() for t in crop))
    gb = _grads(deform_conv2d_select, *crop)
    for name, a, bb in zip(("dx", "doff", "dmask", "dw"), ga, gb):
        rec["grad_rel_err"][name] = rel_err(bb.cpu(), a)
    if timed:
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        with torch.no_grad():
            rec["select_fwd_bf16_ms"] = time_ms(
                lambda: deform_conv2d_select(xb, offset, mask, wb), iters)
            rec["kernel_fwd_bf16_ms"] = time_ms(
                lambda: dcn.dcn_fwd_bf16(xb, offset, mask, wb, None,
                                         MAX_OFFSET), iters)
        args = [t.detach().clone().requires_grad_(True)
                for t in (x, offset, mask, weight)]

        def fwd_bwd(fn):
            for a in args:
                a.grad = None
            fn(*args).float().square().sum().backward()

        rec["select_fwd_bwd_ms"] = time_ms(
            lambda: fwd_bwd(deform_conv2d_select), iters)
        rec["kernel_fwd_bwd_ms"] = time_ms(
            lambda: fwd_bwd(lambda *a: dcn.deform_conv2d(*a, None,
                                                         MAX_OFFSET)), iters)
    return rec


def recheck(inputs, p4: Dict, timed: bool, iters: int) -> Dict:
    """3: the clamped hand kernel (``p4``, :func:`probe_select`'s record)
    against the exact one at this shape, timed in turns (``TURNS`` rounds
    of clamped, exact, exact, clamped): the verdict, its error and (timed)
    each kernel's ms a round. The clamp pays only where its median is below
    ``PAYS`` of the exact one's and every clamped time below every exact
    time."""
    x, offset, mask, weight = inputs
    err = p4["rel_err"]
    rec = {"rel_err": err}
    if err > BROKEN_RTOL:
        rec["verdict"] = (f"VERDICT: CLAMPED-KERNEL-BROKEN rel_err={err:.2e} "
                          "against the plain clamped DCN; investigate")
        return rec
    if not timed:
        rec["verdict"] = (f"VERDICT: CLAMPED-PLAIN-ONLY (cpu; rel_err="
                          f"{err:.2e} ok). Run on the card for the timing "
                          "verdict.")
        return rec
    xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    clamps = {"clamped": MAX_OFFSET, "exact": None}
    times = {"clamped": [], "exact": []}
    with torch.no_grad():
        for _ in range(TURNS):
            for name in ("clamped", "exact", "exact", "clamped"):
                times[name].append(time_ms(
                    lambda r=clamps[name]: dcn.dcn_fwd_bf16(
                        xb, offset, mask, wb, None, r), iters))
    rec.update(clamped_ms=times["clamped"], exact_ms=times["exact"])
    t_clamped = statistics.median(times["clamped"])
    t_exact = statistics.median(times["exact"])
    b, c, h, w = x.shape
    where = (f"at ({b},{h},{w},{c}), medians of {2 * TURNS} in turns "
             f"({t_clamped / t_exact:.2f}x), rel_err {err:.2e}")
    if (t_clamped < PAYS * t_exact
            and max(times["clamped"]) < min(times["exact"])):
        rec["verdict"] = (f"VERDICT: CLAMP-PAYS {t_clamped:.3f} ms vs exact "
                          f"{t_exact:.3f} ms {where}; a clamped node would "
                          "need its accuracy priced (tools/dcn_parity.py)")
    else:
        rec["verdict"] = (f"VERDICT: CLAMP-DOES-NOT-PAY {t_clamped:.3f} ms vs "
                          f"exact {t_exact:.3f} ms {where}; keep the exact "
                          "DCN")
    return rec


def run(device=None, shape=SHAPE, iters: int = 30, log=print) -> Dict:
    """The three probes on ``device``; returns their records."""
    device = resolve_device(device)
    timed = device.type == "cuda"
    inputs = probe_inputs(shape, device)
    p4 = probe_select(inputs, timed, iters)
    log(f"[select] dcn_fwd_bf16 max_offset=1 rel_err={p4['rel_err']:.2e}"
        + (f", {p4['ms']:.3f} ms/op" if timed else ""))
    xla = probe_select_xla(inputs, timed, iters)
    log(f"[select-plain] fwd rel_err={xla['fwd_rel_err']:.2e} against the "
        "clamped " + ("kernel" if timed else "plain DCN"))
    for name, e in xla["grad_rel_err"].items():
        log(f"[select-plain] grad {name} rel_err={e:.2e}")
    if timed:
        log(f"[select-plain] fwd bf16 {xla['select_fwd_bf16_ms']:.3f} ms, "
            f"kernel {xla['kernel_fwd_bf16_ms']:.3f} ms; fwd+bwd float32 "
            f"{xla['select_fwd_bwd_ms']:.3f} ms, kernels "
            f"{xla['kernel_fwd_bwd_ms']:.3f} ms")
    verdict = recheck(inputs, p4, timed, iters)
    log(verdict["verdict"])
    return {"shape": list(shape), "select": p4, "select_plain": xla,
            "recheck": verdict}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)),
                    help="B,H,W,C")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    run(args.device, shape, args.iters, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
