"""GenericLoss: the full multi-head training objective, PyTorch.

The port of ``centerfusiondetect3d_tpu/losses/generic.py`` (reference
``src/lib/model/genericLoss.py:18-337``): per-pyramid-layer target
assignment by bbox-area thresholds, focal heatmap loss, (uncertainty) depth
losses, auxiliary lidar/radar depth-map losses, masked L1 regressions (with
the MonoFlex decoupled amodal offset), 2-bin rotation losses, attribute BCE,
and the optional GIoU-2D / corner-3D decode losses. ``outputs`` is a list of
per-layer dicts of NCHW head maps; ``batch`` holds the NCHW ``heatmap{i}``
targets and the (B, M, ...) object arrays of ``data/targets.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.heads import sigmoid_depth
from ..parallel.distributed import is_multiprocess
from ..parallel.mesh import DATA_AXIS, active_layout, whole_rows
from .primitives import (
    bbox2d_loss,
    bbox3d_loss,
    bin_rot_loss,
    decoupled_loss,
    fast_focal_loss,
    global_sums,
    reg_weighted_l1,
    uncertainty_depth_loss,
    weighted_bce,
)

# bbox-area fractions separating pyramid layers (generic_dataset.py:106-109)
SIZE_THRESH = (0.0, 0.0018, 0.0085)

_REGRESSION_HEADS = ("reg", "widthHeight", "dimension", "amodal_offset",
                     "velocity")


def build_layer_masks(width_height, output_size, n_layers: int):
    """(B, M, 2) box sizes -> (B, L, M) layer membership
    (genericLoss.py:304-336)."""
    area = width_height[..., 0] * width_height[..., 1]
    frac = area / float(output_size[0] * output_size[1])
    masks = []
    for i in range(n_layers):
        lo = SIZE_THRESH[i]
        if i + 1 < len(SIZE_THRESH) and i + 1 < n_layers:
            masks.append((frac > lo) & (frac < SIZE_THRESH[i + 1]))
        else:
            masks.append(frac > lo)
    return torch.stack(masks, dim=1)


def _lay(data, lm):
    """Zero the entries of ``data`` outside this layer's objects."""
    m = lm
    while m.dim() < data.dim():
        m = m[..., None]
    return torch.where(m, data, torch.zeros_like(data))


def _expand_mask(batch, like):
    return batch["mask"][..., None].expand(like.shape)


class GenericLoss:
    """Callable loss; the static config is read at construction."""

    def __init__(self, config):
        self.heads = dict(config.heads)
        self.weights = dict(config.weights)
        self.norm2d = bool(config.MODEL.NORM_2D)
        self.output_size = tuple(config.MODEL.OUTPUT_SIZE)
        self.decouple = bool(config.DATASET.DECOUPLE_REP)
        self.uncertainty = bool(config.TRAIN.UNCERTAINTY_LOSS)

    def __call__(self, outputs: List[Dict[str, Any]], batch: Dict[str, Any],
                 train: bool = True):
        """Returns (total, dict of per-head scalars, ``total`` included).

        In training under a process group of more than one rank every part
        is the global batch's, on every rank (``primitives.global_sums``;
        under a layout, over its data group: the spatial and model ranks
        hold the same whole outputs and targets); validation
        (``train=False``) keeps each rank's own."""
        lay = active_layout()
        if lay is not None:
            enabled, group = lay.n_data > 1, lay.group(DATA_AXIS)
            if lay.n_spatial > 1:  # the heatmap targets whole
                batch = dict(batch)
                for i, out in enumerate(outputs):
                    key = f"heatmap{i}"
                    if key in batch:
                        batch[key] = whole_rows(
                            batch[key], out["heatmap"].shape[2], lay)
        else:
            enabled, group = is_multiprocess(), None
        with global_sums(train and enabled, group):
            return self._losses(outputs, batch, train)

    def _losses(self, outputs, batch, train):
        ref = outputs[0]["heatmap"]
        zero = ref.new_zeros(())
        losses: Dict[str, torch.Tensor] = {h: zero for h in self.heads}
        losses["total"] = zero
        for aux in ("lidar_depth", "radar_depth", "bbox2d", "bbox3d"):
            if self.weights.get(aux, 0) > 0:
                losses[aux] = zero
        w = self.weights

        def add(name, value, weight):
            losses[name] = losses[name] + value
            if weight is not None:
                losses["total"] = losses["total"] + value * weight

        n_layers = len(outputs)
        layer_masks = build_layer_masks(batch["widthHeight"],
                                        self.output_size, n_layers)
        for i, output in enumerate(outputs):
            lm = layer_masks[:, i]  # (B, M)
            class_ids = _lay(batch["classIds"], lm).long()
            layer_h, layer_w = output["heatmap"].shape[2:4]
            # [x, y] scale of this layer against the output plane
            scale_xy = ref.new_tensor([layer_w / self.output_size[1],
                                       layer_h / self.output_size[0]])
            centers = _lay(batch["target"]["heatCenters"], lm)
            centers_layer = (centers * scale_xy).long()
            ind = centers_layer[..., 1] * layer_w + centers_layer[..., 0]
            mask = _lay(batch["mask"], lm)

            add("heatmap", fast_focal_loss(output["heatmap"],
                                           batch[f"heatmap{i}"], ind, mask,
                                           class_ids), w["heatmap"])

            for dh in ("depth", "depth2"):
                if dh not in output:
                    continue
                if dh not in losses:
                    losses[dh] = zero
                dmask = _lay(_expand_mask(batch, batch["depth"]), lm)
                dtarget = _lay(batch["depth"], lm)
                if train and self.uncertainty and "uncertainty" in output:
                    unc = output["uncertainty"].clamp(-10, 10)
                    d_loss, u_loss = uncertainty_depth_loss(
                        output[dh], dmask, ind, dtarget, unc)
                    losses["total"] = losses["total"] + u_loss * w["depth"]
                    add(dh, d_loss, None)
                else:
                    add(dh, reg_weighted_l1(output[dh], dmask, ind, dtarget),
                        w["depth"])

            if w.get("lidar_depth", 0) > 0 or w.get("radar_depth", 0) > 0:
                depth_map = (
                    sigmoid_depth(output["depthMap"]) if "depthMap" in output
                    else output["depth2" if "depth2" in output else "depth"])
                for aux, key in (("lidar_depth", "pc_lidar"),
                                 ("radar_depth", "pc_2d")):
                    if w.get(aux, 0) <= 0 or key not in batch:
                        continue
                    pc = batch[key][..., :3]  # (B, N, 3) [x, y, d]
                    pts = (pc[..., :2] * scale_xy).long()
                    pc_ind = pts[..., 1] * layer_w + pts[..., 0]
                    add(aux, reg_weighted_l1(depth_map, pc > 0, pc_ind,
                                             pc[..., 2:]), w[aux])

            reg_heads = list(_REGRESSION_HEADS)
            if self.decouple and "amodal_offset" in output:
                reg_heads.remove("amodal_offset")
                target = batch["amodal_offset"]
                amask = _lay(_expand_mask(batch, target), lm)
                trunc = _lay(batch["truncMask"][..., None].expand(
                    target.shape), lm)
                add("amodal_offset",
                    decoupled_loss(output["amodal_offset"], amask, ind,
                                   _lay(target, lm), trunc),
                    w["amodal_offset"])
            for head in reg_heads:
                if head not in output or head not in batch:
                    continue
                hmask = _lay(_expand_mask(batch, batch[head]), lm)
                add(head, reg_weighted_l1(output[head], hmask, ind,
                                          _lay(batch[head], lm)), w[head])

            for rh in ("rotation", "rotation2"):
                if rh in output:
                    add(rh, bin_rot_loss(output[rh], mask, ind,
                                         _lay(batch["rotbin"], lm),
                                         _lay(batch["rotres"], lm)), w[rh])

            if "nuscenes_att" in output and "nuscenes_att" in batch:
                add("nuscenes_att",
                    weighted_bce(output["nuscenes_att"],
                                 _lay(batch["nuscenes_att_mask"], lm), ind,
                                 _lay(batch["nuscenes_att"], lm)),
                    w["nuscenes_att"])

            if ("bbox2d" in losses and "reg" in output
                    and "widthHeight" in output):
                wh = output["widthHeight"]
                if self.norm2d:
                    wh = torch.sigmoid(wh) * ref.new_tensor(
                        [self.output_size[1], self.output_size[0]]
                    )[None, :, None, None]
                add("bbox2d",
                    bbox2d_loss(output["reg"], wh, centers_layer.to(ref.dtype),
                                _lay(batch["target"]["bboxes"], lm), ind, lm),
                    w["bbox2d"])

            if "bbox3d" in losses:
                depth_head = "depth2" if "depth2" in output else "depth"
                needed = {"rotation", depth_head, "dimension", "amodal_offset"}
                if needed <= set(output) and "trans_mat" in batch:
                    # trans_mat_valid masks hflipped samples (their corner
                    # targets are unflipped)
                    m3 = lm.to(ref.dtype)
                    if "trans_mat_valid" in batch:
                        m3 = m3 * batch["trans_mat_valid"][:, None]
                    add("bbox3d",
                        bbox3d_loss(output, centers_layer.to(ref.dtype),
                                    batch["trans_mat"], batch["calib"],
                                    _lay(batch["target"]["bboxes3d"], lm),
                                    ind, m3, depth_head), w["bbox3d"])

        losses["total"] = losses["total"] / n_layers
        return losses["total"], losses
