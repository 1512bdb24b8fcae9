"""What the correctness checks share: the stages the reference follows,
the forward hooks that keep what the program's timed path made of them,
and the comparison.

A seeded DLA-34 amplifies rounding from layer to layer, so the reference
runs each stage on the program's own input to it (the stem, each DLA
level, each IDA step of the neck, each head tower) and its output is
compared with the program's; the stages' module names are the same in the
program and in the reference (``cfbench/reference/model.py``).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def stages(model) -> List[str]:
    """The stages of ``model`` (the reference; the program's names are the
    same) by module name."""
    names = [f"base.{n}" for n, _ in model.base.named_children()]
    names += [f"dla_up.{n}" for n, _ in model.dla_up.named_children()]
    names += ["ida_up"]
    names += [f"detectHead_0.{h}" for h in model.detectHead_0.first
              + model.detectHead_0.secondary]
    return names


def flat_tensors(a) -> List[torch.Tensor]:
    """The tensors of a stage's arguments or output, flattened."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (list, tuple)):
        return [t for v in a for t in flat_tensors(v)]
    return []


class _Tap(torch.autograd.Function):
    """The identity; its backward keeps the gradient that reaches it in
    ``slot[key]``."""

    @staticmethod
    def forward(ctx, t, slot, key):
        ctx.slot, ctx.key = slot, key
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.slot[ctx.key] = g
        return g, None, None


class Capture:
    """Forward hooks on a model; each forward is a batch (serving) or a
    microbatch (training). For the forwards in ``stage_want`` it keeps the
    model's inputs, each stage's inputs and output and, with ``grads``, the
    gradients that reach them (tensor hooks); for those in ``y_want``, the
    model's outputs. For those in ``dcn_want`` it keeps, at each DCN
    node's deformable op (a module's ``dcn_fn``), the op's inputs (x,
    offset, mask, weight, as passed) and the gradients that reach them and
    its output: the op is called through a tap, and ``release`` puts the
    op back. It keeps references: nothing is copied."""

    def __init__(self, model, names, stage_want=(), y_want=(),
                 grads: bool = False, dcn_want=()):
        self.stage_want, self.y_want = set(stage_want), set(y_want)
        self.dcn_want = set(dcn_want)
        self.grads = grads
        self.count = 0
        self.kept: Dict[int, Dict] = {}
        self.rec = None
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]
        for name in names:
            self.handles.append(model.get_submodule(name).register_forward_hook(
                lambda m, a, o, name=name: self._stage(name, a, o)))
        self.ops = []
        if self.dcn_want:
            for name, m in model.named_modules():
                if callable(getattr(m, "dcn_fn", None)):
                    self.ops.append((m, m.dcn_fn))
                    m.dcn_fn = self._tapped(name, m.dcn_fn)

    def release(self):
        """The model as it was: no hooks, each deformable op its own, and
        nothing kept."""
        for h in self.handles:
            h.remove()
        for m, fn in self.ops:
            m.dcn_fn = fn
        self.handles, self.ops = [], []
        self.kept.clear()
        self.rec = None

    def _tapped(self, name, fn):
        def call(x, offset, mask, weight, *rest, **kw):
            rec = self.rec
            if rec is None or self.count not in self.dcn_want:
                return fn(x, offset, mask, weight, *rest, **kw)
            node = rec["dcn"][name] = {"in": {}, "grads": {}}
            args = []
            for key, t in zip(("x", "offset", "mask", "weight"),
                              (x, offset, mask, weight)):
                node["in"][key] = t.detach()
                args.append(_Tap.apply(t, node["grads"], key)
                            if t.requires_grad else t)
            y = fn(*args, *rest, **kw)
            return _Tap.apply(y, node["grads"], "y") if y.requires_grad else y
        return call

    def _pre(self, module, args):
        want = self.count in self.stage_want or self.count in self.dcn_want
        self.rec = ({"inputs": args, "stages": {}, "grads": {}, "dcn": {}}
                    if want else None)

    def _stage(self, name, args, out):
        rec = self.rec
        if rec is None or self.count not in self.stage_want:
            return
        rec["stages"][name] = (args, out)
        if not self.grads:
            return
        for t in flat_tensors(args) + flat_tensors(out):
            if t.requires_grad and id(t) not in rec["grads"]:
                rec["grads"][id(t)] = None

                def keep(g, key=id(t)):
                    rec["grads"][key] = g
                t.register_hook(keep)

    def _post(self, module, args, out):
        if self.rec is not None:
            self.kept.setdefault(self.count, {}).update(self.rec)
        if self.count in self.y_want:
            self.kept.setdefault(self.count, {})["y"] = {
                k: v.detach() for k, v in out.items()
                if isinstance(v, torch.Tensor)}
        self.rec = None
        self.count += 1


def rel_rms(p, r) -> float:
    """Largest over the images of ||p - r|| / ||r|` (p on r's device);
    inf where the shapes differ (images left out)."""
    p = p.detach().to(r.device).float().flatten(1)
    r = r.detach().float().flatten(1)
    if p.shape != r.shape:
        return float("inf")
    return float(((p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)).max())


class tf32_off:
    """float32 contractions in float32 (not TF32) while the reference
    runs; the settings found are put back."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
