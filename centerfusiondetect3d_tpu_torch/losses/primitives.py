"""Loss primitives for center-point 3D detection, PyTorch, NCHW head maps.

The port of ``centerfusiondetect3d_tpu/losses/primitives.py`` (reference
``src/lib/model/losses.py:22-387``): CornerNet focal loss, masked L1
regression, weighted BCE, 2-bin rotation loss, aleatoric uncertainty depth
loss, decoupled truncation loss, GIoU 2D and corner-L1 3D decode losses.
Selections are masked sums with count guards, as in the JAX package, so a
batch without targets gives the same numbers there and here. Head maps are
(B, C, H, W); indices, masks and targets are (B, M, ...).

Inside ``global_sums()`` (``GenericLoss`` in training under a process group
of more than one rank) every sum, count and mean is over the global batch,
as the JAX package's are under SPMD ``jit``: each local sum is all-reduced
with the differentiable ``all_reduce`` over the group (the default one, or
a layout's data group), so every rank computes the global loss, and the
all-reduce's backward hands each rank the group's size times its share of
the gradient, which ``DistributedDataParallel``'s average over the ranks
(``parallel/mesh.py:reduce_gradients`` under a layout) turns into the
global loss's gradient.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..geometry.transforms3d import get_3d_box, get_alpha, img_to_cam_coord
from ..ops.decode import gather_feature

_GLOBAL = contextvars.ContextVar("cfd3d_global_sums", default=None)


@contextlib.contextmanager
def global_sums(enabled: bool = True, group=None):
    """Sums, counts and means over every rank's batch (the ranks of
    ``group``, the default group if None) inside the block."""
    token = _GLOBAL.set((group,) if enabled else None)
    try:
        yield
    finally:
        _GLOBAL.reset(token)


def _sum(x):
    """x.sum(), over every rank inside ``global_sums``."""
    total = x.sum()
    over = _GLOBAL.get()
    if over is None:
        return total
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(total) if over[0] is None else all_reduce(
        total, group=over[0])


def _mean(x):
    """x.mean(), over every rank's (equally shaped) x inside
    ``global_sums``."""
    over = _GLOBAL.get()
    if over is None:
        return x.mean()
    import torch.distributed as dist

    return _sum(x) / (x.numel() * dist.get_world_size(over[0]))


def _masked_mean(x, mask):
    """Mean of x over elements where mask is nonzero (broadcasting)."""
    shape = torch.broadcast_shapes(x.shape, mask.shape)
    mask = mask.to(x.dtype).expand(shape)
    return _sum(x.expand(shape) * mask) / _sum(mask).clamp(min=1.0)


def _count_or_big(mask):
    """mask.sum(), or 1e7 where it is 0 (the reference's guard)."""
    n = _sum(mask)
    return torch.where(n == 0, torch.full_like(n, 1e7), n)


def fast_focal_loss(pred, target, ind, mask, cat):
    """CornerNet focal loss (losses.py:181-210).

    pred/target (B, C, H, W); ind/mask/cat (B, M).
    """
    neg_weights = torch.pow(1.0 - target, 4)
    neg_loss = _sum(torch.log(1.0 - pred) * pred.square() * neg_weights)
    pos_pred_pix = gather_feature(pred, ind)  # (B, M, C)
    pos_pred = torch.gather(pos_pred_pix, 2, cat[..., None].long())
    num_pos = _sum(mask)
    pos_loss = _sum(torch.log(pos_pred) * (1.0 - pos_pred).square()
                    * mask[..., None])
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def reg_weighted_l1(output, mask, ind, target, reduction: str = "mean"):
    """Masked L1 regression (losses.py:213-232). mask broadcasts."""
    pred = gather_feature(output, ind)  # (B, M, C)
    mask = mask.to(pred.dtype)
    loss = (pred * mask - target * mask).abs()
    if reduction == "none":
        return loss
    if reduction == "mean":
        return _sum(loss) / _count_or_big(mask)
    if reduction == "sum":
        return _sum(loss)
    raise ValueError(f"unsupported reduction {reduction!r}")


def weighted_bce(output, mask, ind, target):
    """Masked BCE-with-logits (losses.py:235-255)."""
    pred = gather_feature(output, ind)  # (B, M, F)
    bce = (pred.clamp(min=0) - pred * target
           + torch.log1p(torch.exp(-pred.abs())))
    return _sum(mask * bce) / _count_or_big(mask)


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _masked_ce(logits2, target, row_mask):
    """Mean 2-way cross-entropy over rows selected by row_mask."""
    logz = torch.logsumexp(logits2, dim=-1)
    ll = torch.gather(logits2, 1, target[:, None].long())[:, 0]
    return _masked_mean(logz - ll, row_mask)


def bin_rot_loss(output, mask, ind, rotbin, rotres):
    """8-channel 2-bin rotation loss (losses.py:258-328).

    output (B, 8, H, W); mask (B, M); rotbin (B, M, 2) int; rotres (B, M, 2).
    """
    pred = gather_feature(output, ind)  # (B, M, 8)
    no_targets = _sum(mask) == 0
    zero_branch = _mean(pred * mask[..., None])
    p = pred.reshape(-1, 8)
    tb = rotbin.reshape(-1, 2)
    tr = rotres.reshape(-1, 2)
    m = mask.reshape(-1)
    loss_bin1 = _masked_ce(p[:, 0:2], tb[:, 0], m)
    loss_bin2 = _masked_ce(p[:, 4:6], tb[:, 1], m)
    # residuals over rows with the bin set (bins are zero for padded rows)
    b1 = tb[:, 0].to(p.dtype)
    b2 = tb[:, 1].to(p.dtype)
    loss_res = (
        _masked_mean(_smooth_l1(p[:, 2] - torch.sin(tr[:, 0])), b1)
        + _masked_mean(_smooth_l1(p[:, 3] - torch.cos(tr[:, 0])), b1)
        + _masked_mean(_smooth_l1(p[:, 6] - torch.sin(tr[:, 1])), b2)
        + _masked_mean(_smooth_l1(p[:, 7] - torch.cos(tr[:, 1])), b2)
    )
    return torch.where(no_targets, zero_branch,
                       loss_bin1 + loss_bin2 + loss_res)


def uncertainty_depth_loss(output, mask, ind, target, uncertainty):
    """Aleatoric depth loss, ClusterFusion eq. 14 (losses.py:331-361).

    Returns (plain_depth_loss, uncertainty_weighted_loss).
    """
    loss = reg_weighted_l1(output, mask, ind, target, reduction="none")
    sigma_log = gather_feature(uncertainty, ind)  # (B, M, 1)
    weighted = loss * torch.exp(-sigma_log) + sigma_log
    no_targets = _sum(mask) == 0
    u = torch.where(no_targets, _mean(weighted), _masked_mean(weighted, mask))
    d = torch.where(no_targets, _mean(loss), _masked_mean(loss, mask))
    return d, u


def decoupled_loss(output, mask, ind, target, trunc_mask):
    """MonoFlex decoupled offset loss (losses.py:364-386)."""
    loss = reg_weighted_l1(output, mask, ind, target, reduction="none")
    trunc = trunc_mask.to(loss.dtype)
    total = loss * (1.0 - trunc) + torch.log1p(loss * trunc)
    no_targets = _sum(mask) == 0
    return torch.where(no_targets, _mean(total), _masked_mean(total, mask))


def giou_2d(pred, target, mask):
    """1 - GIoU over masked boxes (losses.py:22-78). pred/target (B, K, 4)."""
    eps = 1e-7
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    inter_x = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
    inter_y = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0)
    inter = inter_x * inter_y
    pw, ph = (px2 - px1).clamp(min=0), (py2 - py1).clamp(min=0)
    union = pw * ph + (tx2 - tx1) * (ty2 - ty1) - inter
    iou = inter / torch.where(union == 0, torch.ones_like(union), union)
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    chh = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    convex = cw * chh
    giou = iou - (convex - union) / torch.where(
        convex == 0, torch.ones_like(convex), convex)
    loss = 1.0 - _masked_mean(giou.clamp(-1.0, 1.0), mask)
    return torch.where(_sum(mask) == 0, torch.full_like(loss, eps), loss)


def bbox2d_loss(local_offset, dimension2d, center_int, target, ind, mask):
    """Decode 2D boxes from offset and size maps and score them with GIoU
    (losses.py:81-117)."""
    center = center_int + gather_feature(local_offset, ind)
    dim = gather_feature(dimension2d, ind)
    pred = torch.cat([center - dim / 2, center + dim / 2], dim=2)
    return giou_2d(pred, target, mask)


def bbox3d_loss(output, center_int, trans_mat, calib, target, ind, mask,
                depth_head: str = "depth"):
    """Decode 3D corner boxes from the head maps; L1 on the x/z corners
    (losses.py:120-178)."""
    rotation = gather_feature(output["rotation"], ind)
    depth = gather_feature(output[depth_head], ind)
    dimension = gather_feature(output["dimension"], ind)
    if "amodal_offset" in output:
        amodal = gather_feature(output["amodal_offset"], ind)
    else:
        amodal = torch.zeros_like(center_int)
    trans_mat = torch.as_tensor(trans_mat, dtype=center_int.dtype,
                                device=center_int.device)
    pts = center_int + amodal  # (B, K, 2)
    if trans_mat.dim() == 3:
        # per-sample (B, 2, 3) inverse affines
        center3d = (torch.einsum("bkj,bij->bki", pts, trans_mat[:, :, :2])
                    + trans_mat[:, None, :, 2])
    else:
        center3d = pts @ trans_mat[:, :2].T + trans_mat[:, 2]
    locations, yaws = img_to_cam_coord(center3d, get_alpha(rotation),
                                       dimension, depth[..., 0], calib)
    pred = get_3d_box(dimension, locations, yaws)
    loss = (pred[..., ::2] - target[..., ::2]).abs()
    masked = _masked_mean(loss, mask[..., None, None])
    return torch.where(_sum(mask) == 0, torch.zeros_like(masked), masked)
