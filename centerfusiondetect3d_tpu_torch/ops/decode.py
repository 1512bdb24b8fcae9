"""Peak decoding for center-point detection, NCHW.

The port of ``centerfusiondetect3d_tpu/ops/decode.py`` (reference
``src/lib/model/utils.py:6-128`` and ``src/lib/model/decode.py:10-174``):
3x3 max-pool NMS, a two-stage top-k, and gathers at the peaks. Top-k is
exact and breaks ties by the lower index, as ``jax.lax.top_k`` does: it is a
stable descending sort cut at K, so the port and the JAX package pick the
same peaks among equal scores (NMS leaves many zeros).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def heat_nms(heatmap: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only the local maxima of an NCHW heatmap."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heatmap, kernel, stride=1, padding=pad)
    return torch.where(hmax == heatmap, heatmap, torch.zeros_like(heatmap))


def topk_exact(x: torch.Tensor, k: int):
    """Top-k over the last axis, descending, ties by the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk_peaks(heatmap: torch.Tensor, k: int = 100):
    """Two-stage top-k over an NCHW class heatmap.

    Returns (scores, flat_indices, class_ids, ys, xs), each (B, K);
    flat_indices index the flattened H*W plane.
    """
    batch, nclass, height, width = heatmap.shape
    scores_c, inds_c = topk_exact(heatmap.reshape(batch, nclass, -1), k)
    scores, ind = topk_exact(scores_c.reshape(batch, -1), k)
    class_ids = torch.div(ind, k, rounding_mode="floor")
    flat = torch.gather(inds_c.reshape(batch, -1), 1, ind)
    ys = torch.div(flat, width, rounding_mode="floor")
    xs = flat % width
    return scores, flat, class_ids, ys, xs


def gather_feature(feature: torch.Tensor, flat_indices: torch.Tensor):
    """(B, C, H, W) map, (B, K) flat H*W indices -> (B, K, C)."""
    b, c = feature.shape[:2]
    flat = feature.reshape(b, c, -1)
    idx = flat_indices[:, None, :].expand(b, c, flat_indices.shape[1])
    return torch.gather(flat, 2, idx).transpose(1, 2)


_REGRESSION_HEADS = ("rotation", "dimension", "amodal_offset", "nuscenes_att",
                     "velocity")


def fusion_decode(outputs: Sequence[Dict[str, torch.Tensor]], output_size,
                  k: int = 100, norm2d: bool = False) -> Dict[str, torch.Tensor]:
    """Decode a list of per-layer head dicts (NCHW) into top-K detections.

    Returns scores (B, K), classIds (B, K), centers (B, K, 2) in normalized
    [0, 1] coordinates, bboxes (B, K, 4) in output-plane coordinates, and
    each regression head gathered at the peaks; ``depth2``/``rotation2``
    override their primaries.
    """
    outputs = [o for o in outputs if "heatmap" in o]
    if not outputs:
        return {}

    layer_tops = []
    for out in outputs:
        heat = heat_nms(out["heatmap"])
        height, width = heat.shape[-2:]
        scores_l, inds_l, classes_l, ys_l, xs_l = topk_peaks(heat, k)
        layer_tops.append((scores_l, inds_l, classes_l, ys_l / height,
                           xs_l / width))

    scores_all = torch.cat([t[0] for t in layer_tops], dim=-1)
    scores, indices = topk_exact(scores_all, k)
    classes = torch.gather(torch.cat([t[2] for t in layer_tops], -1), 1,
                           indices)
    ys_final = torch.gather(torch.cat([t[3] for t in layer_tops], -1), 1,
                            indices)
    xs_final = torch.gather(torch.cat([t[4] for t in layer_tops], -1), 1,
                            indices)
    ret = {
        "scores": scores,
        "classIds": classes.float(),
        "centers": torch.stack([xs_final, ys_final], dim=2),
    }

    def concat_layers(name, alias=None):
        pieces = []
        for out, top in zip(outputs, layer_tops):
            key = alias if alias is not None and alias in out else name
            if key in out:
                pieces.append(gather_feature(out[key], top[1]))
        if not pieces:
            return None
        if len(pieces) != len(outputs):
            raise ValueError(f"head '{name}' present in only {len(pieces)} "
                             f"of {len(outputs)} pyramid layers")
        return torch.cat(pieces, dim=1)

    def merge(feat):
        idx = indices[..., None].expand(-1, -1, feat.shape[-1])
        return torch.gather(feat, 1, idx)

    # uncertainty multiplies the merged scores by each layer's confidence at
    # that layer's own top-k rows, as the reference does (decode.py:79-85)
    for out, top in zip(outputs, layer_tops):
        if "uncertainty" in out:
            conf_l = gather_feature(out["uncertainty"], top[1])
            ret["scores"] = ret["scores"] * torch.exp(-torch.exp(conf_l[..., 0]))

    out_h, out_w = output_size
    size_scale = (scores.new_tensor([out_w, out_h]) if norm2d
                  else scores.new_tensor(1.0))

    reg = concat_layers("reg")
    xs = xs_final[..., None] * out_w
    ys = ys_final[..., None] * out_h
    if reg is not None:
        reg_m = merge(reg)
        xs = xs + reg_m[..., 0:1]
        ys = ys + reg_m[..., 1:2]
    else:
        xs = xs + 0.5
        ys = ys + 0.5

    wh = concat_layers("widthHeight")
    if wh is not None:
        wh_m = merge(wh).clamp(min=0.0) * size_scale
        ret["bboxes"] = torch.cat(
            [xs - wh_m[..., 0:1] / 2, ys - wh_m[..., 1:2] / 2,
             xs + wh_m[..., 0:1] / 2, ys + wh_m[..., 1:2] / 2], dim=2)

    depth = concat_layers("depth", alias="depth2")
    if depth is not None:
        ret["depth"] = merge(depth)

    for head in _REGRESSION_HEADS:
        alias = "rotation2" if head == "rotation" else None
        feat = concat_layers(head, alias=alias)
        if feat is not None:
            merged = merge(feat)
            if head == "amodal_offset":
                merged = merged * size_scale
            ret[head] = merged
    return ret
