"""Plain reference of the training objective and the optimizer.

The CenterNet / CenterFusion loss of one pyramid level (Zhou et al.,
arXiv:1904.07850; Nabati and Qi, arXiv:2011.04841): the CornerNet focal
loss on the class heatmap, masked L1 on the regression heads at the object
centres (depth after its 1/sigmoid - 1 transform), the 2-bin rotation loss
(cross-entropy of each bin, smooth L1 of its sin/cos residual), and the
masked binary cross-entropy of the attributes; weighted and summed. AdamW
(Loshchilov and Hutter, arXiv:1711.05101) with decoupled weight decay. It
imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch

from .postprocess import gather

REGRESSION = ("reg", "widthHeight", "dimension", "amodal_offset", "velocity")


def _guard(n):
    """A count, or 1e7 where it is 0 (the reference implementation's)."""
    return torch.where(n == 0, torch.full_like(n, 1e7), n)


def focal(pred, target, ind, mask, cat):
    neg = (torch.log(1 - pred) * pred ** 2 * (1 - target) ** 4).sum()
    pos_pred = torch.gather(gather(pred, ind), 2, cat[..., None].long())
    pos = (torch.log(pos_pred) * (1 - pos_pred) ** 2 * mask[..., None]).sum()
    n = mask.sum()
    return torch.where(n == 0, -neg, -(pos + neg) / n.clamp(min=1.0))


def l1(out, mask, ind, target):
    pred = gather(out, ind)
    m = mask.to(pred.dtype)
    return (pred * m - target * m).abs().sum() / _guard(m.sum())


def bce(out, mask, ind, target):
    p = gather(out, ind)
    e = p.clamp(min=0) - p * target + torch.log1p(torch.exp(-p.abs()))
    return (mask * e).sum() / _guard(mask.sum())


def _masked_mean(x, m):
    m = m.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _smooth_l1(x):
    a = x.abs()
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def _ce(logits, target, rows):
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, 1, target[:, None].long())[:, 0]
    return _masked_mean(nll, rows)


def rotation(out, mask, ind, rotbin, rotres):
    p = gather(out, ind).reshape(-1, 8)
    tb, tr, m = rotbin.reshape(-1, 2), rotres.reshape(-1, 2), mask.reshape(-1)
    b1, b2 = tb[:, 0].to(p.dtype), tb[:, 1].to(p.dtype)
    loss = (_ce(p[:, 0:2], tb[:, 0], m) + _ce(p[:, 4:6], tb[:, 1], m)
            + _masked_mean(_smooth_l1(p[:, 2] - torch.sin(tr[:, 0])), b1)
            + _masked_mean(_smooth_l1(p[:, 3] - torch.cos(tr[:, 0])), b1)
            + _masked_mean(_smooth_l1(p[:, 6] - torch.sin(tr[:, 1])), b2)
            + _masked_mean(_smooth_l1(p[:, 7] - torch.cos(tr[:, 1])), b2))
    zero = (gather(out, ind) * mask[..., None]).mean()
    return torch.where(mask.sum() == 0, zero, loss)


def loss(y: Dict[str, torch.Tensor], batch: Dict, weights: Dict[str, float]
         ) -> Dict[str, torch.Tensor]:
    """The loss parts of one pyramid level and their weighted ``total``.
    ``y``: the head maps after their activations; ``batch``: the targets
    (``heatmap0``, the (B, M, ...) object arrays, ``target.heatCenters``)."""
    out_h, out_w = y["heatmap"].shape[2:]
    wh = batch["widthHeight"]
    present = (wh[..., 0] * wh[..., 1]) / float(out_h * out_w) > 0
    keep = lambda t: torch.where(present.view(*present.shape, *[1] * (
        t.dim() - 2)), t, torch.zeros_like(t))
    cls = keep(batch["classIds"]).long()
    centre = keep(batch["target"]["heatCenters"]).long()
    ind = centre[..., 1] * out_w + centre[..., 0]
    mask = keep(batch["mask"])
    parts = {"heatmap": focal(y["heatmap"], batch["heatmap0"], ind, mask,
                              cls)}
    for h in ("depth", "depth2"):
        if h in y:
            t = batch["depth"]
            parts[h] = l1(y[h], keep(mask[..., None].expand(t.shape)), ind,
                          keep(t))
    for h in REGRESSION:
        if h in y and h in batch:
            t = batch[h]
            parts[h] = l1(y[h], keep(mask[..., None].expand(t.shape)), ind,
                          keep(t))
    for h in ("rotation", "rotation2"):
        if h in y:
            parts[h] = rotation(y[h], mask, ind, keep(batch["rotbin"]),
                                keep(batch["rotres"]))
    if "nuscenes_att" in y and "nuscenes_att" in batch:
        parts["nuscenes_att"] = bce(y["nuscenes_att"],
                                    keep(batch["nuscenes_att_mask"]), ind,
                                    keep(batch["nuscenes_att"]))
    parts["total"] = sum(parts[k] * weights[k] for k in list(parts))
    return parts


class AdamW:
    """AdamW over named float32 tensors: decoupled weight decay, then the
    bias-corrected Adam step (betas 0.9 / 0.999, eps 1e-8)."""

    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """Updates each parameter that has a gradient, in place."""
        b1, b2 = self.betas
        for name, g in grads.items():
            p = params[name]
            t = self.t[name] = self.t.get(name, 0) + 1
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** t))


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Iterable[str]) -> float:
    """Worst leaf of | ||prog|| - ||ref|| | over max(||ref||, the median
    leaf's ||ref||), over ``names``."""
    names = list(names)
    if not names:
        return math.inf
    rn = {n: float(ref[n].float().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    worst = 0.0
    for n in names:
        pn = float(prog[n].float().norm()) if n in prog else 0.0
        worst = max(worst, abs(pn - rn[n]) / max(rn[n], med, 1e-30))
    return worst


def moving(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose gradient is not nought to rounding: a norm of at
    least a thousandth of the median leaf's."""
    norms = {n: float(g.float().norm()) for n, g in grads.items()}
    if not norms:
        return []
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= 1e-3 * med]
