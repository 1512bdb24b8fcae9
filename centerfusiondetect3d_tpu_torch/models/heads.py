"""CenterNet detection heads and the CenterFusion secondary (radar) heads.

The port of ``centerfusiondetect3d_tpu/models/heads.py`` (reference
``src/lib/model/networks/detectHeads.py:16-191``): per-head towers
3x3 conv -> ReLU -> [1x1 conv -> ReLU]* -> 1x1 conv, named as the reference's
``nn.Sequential`` (``detectHead_0.heatmap.0.weight``, ``.2.weight``, ...);
sigmoid-clamped heatmap with -4.6 bias init; the ``1/sigmoid - 1`` depth
transform; and the middle-fusion secondary heads fed with the image features
concatenated with the radar heatmap. The towers compute in
``compute_dtype`` (``models/layers.py``); outputs are NCHW in at least
float32.

``fuse_towers`` (``MODEL.FUSED_HEAD_TOWERS``, JAX's ``heads.py:116-167``)
runs each stage's ``tower_0`` convs as one conv over their weights
concatenated on the output channels, then each head's tail on its slice of
the channels: the same function, one launch where there were one a head;
the parameters keep their names. A tower conv split over the model axis
(``parallel/mesh.py:shard_params_tp``) gathers its output channels from
the model ranks, in the fused conv too.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, tp_gather

SECONDARY_HEADS = ("velocity", "nuscenes_att", "depth2", "rotation2")


def sigmoid_depth(x):
    """Depth activation 1/sigmoid(x) - 1 (model/utils.py:131-141)."""
    return 1.0 / (torch.sigmoid(x) + 1e-6) - 1.0


def clamp_sigmoid(x):
    """Sigmoid clamped to [1e-4, 1 - 1e-4] (detectHeads.py:21-23)."""
    return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)


def resize_nearest(x, size_hw):
    """Nearest resize of an NCHW map with ``jax.image.resize``'s half-pixel
    index rule, src = floor((dst + 0.5) * in / out)."""
    h, w = x.shape[-2:]
    oh, ow = int(size_hw[0]), int(size_hw[1])
    if (h, w) == (oh, ow):
        return x
    iy = ((torch.arange(oh, device=x.device, dtype=torch.float64) + 0.5)
          * (h / oh)).floor().long().clamp(max=h - 1)
    ix = ((torch.arange(ow, device=x.device, dtype=torch.float64) + 0.5)
          * (w / ow)).floor().long().clamp(max=w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def at_least_f32(x):
    """x in float32, or in its own wider type (float64 reference runs)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def head_tower(cin: int, nout: int, hidden: Sequence[int],
               is_heatmap: bool, compute_dtype=None) -> nn.Sequential:
    dt = compute_dtype
    layers = []
    if hidden:
        layers += [Conv2d(cin, hidden[0], 3, padding=1, compute_dtype=dt),
                   nn.ReLU(inplace=True)]
        for prev, h in zip(hidden[:-1], hidden[1:]):
            layers += [Conv2d(prev, h, 1, compute_dtype=dt),
                       nn.ReLU(inplace=True)]
        cin = hidden[-1]
    out = Conv2d(cin, nout, 1, compute_dtype=dt)
    for conv in layers[::2]:  # the tower's biases start at zero, as in JAX
        nn.init.zeros_(conv.bias)
    nn.init.constant_(out.bias, -4.6 if is_heatmap else 0.0)
    return nn.Sequential(*layers, out)


class DetectHeadSet(nn.Module):
    """All first-stage and (optionally) secondary towers of one pyramid level.

    heads: head name -> output channels; head_conv: head name -> hidden widths
    (the derived config); secondary: the heads fed with radar features;
    compute_dtype: the towers' (``models/layers.py``); fuse_towers: each
    stage's ``tower_0`` as one conv where every head of the stage has one.
    """

    def __init__(self, cin: int, heads: Mapping[str, int],
                 head_conv: Mapping[str, Sequence[int]],
                 secondary: Sequence[str] = (), pc_channels: int = 3,
                 compute_dtype=None, fuse_towers: bool = False):
        super().__init__()
        self.first = [n for n in heads if n not in secondary]
        self.secondary = [n for n in secondary if n in heads]
        self.compute_dtype = compute_dtype
        self.fuse_towers = bool(fuse_towers)
        for name, nout in heads.items():
            width = cin + (pc_channels if name in self.secondary else 0)
            setattr(self, name, head_tower(width, int(nout),
                                           tuple(head_conv.get(name, ())),
                                           "heatmap" in name, compute_dtype))

    def _run_towers(self, feats, names) -> Dict[str, torch.Tensor]:
        """Each head's tower on ``feats``: fused where ``fuse_towers`` is on
        and every head has a hidden conv (JAX's ``_can_fuse``), else one by
        one."""
        towers = [getattr(self, n) for n in names]
        if not (self.fuse_towers and names
                and all(len(t) > 1 for t in towers)):
            return {n: at_least_f32(t(feats)) for n, t in zip(names, towers)}
        firsts = [t[0] for t in towers]
        dt = self.compute_dtype
        weight = torch.cat([c.weight for c in firsts])
        bias = torch.cat([c.bias for c in firsts])
        x = feats
        if dt is not None:
            x, weight, bias = x.to(dt), weight.to(dt), bias.to(dt)
        h = F.conv2d(x, weight, bias, 1, 1)
        if any(c.tp_shards > 1 for c in firsts):
            h = _gathered_heads(h, firsts)
        h = torch.relu(h)
        y, off = {}, 0
        for n, t, c in zip(names, towers, firsts):
            width = c.out_channels
            y[n] = at_least_f32(t[2:](h[:, off:off + width]))
            off += width
        return y

    def first_stage(self, feats) -> Dict[str, torch.Tensor]:
        y = self._run_towers(feats, self.first)
        for name in list(y):
            if "heatmap" in name:
                y[name] = clamp_sigmoid(y[name])
        if "depth" in y:
            y["depthMap"] = y["depth"]
            y["depth"] = sigmoid_depth(y["depth"])
        return y

    def second_stage(self, feats, pc_hm, pc_slice: int = 1):
        """Secondary towers on image features + the resized radar heatmap;
        ``pc_hm_out`` exposes its first ``pc_slice`` channels
        (detectHeads.py:185)."""
        pc_resized = resize_nearest(pc_hm, feats.shape[-2:]).to(feats.dtype)
        sec_feats = torch.cat([feats, pc_resized], dim=1)
        y = self._run_towers(sec_feats, self.secondary)
        if "depth2" in y:
            y["depthMap"] = y["depth2"]
            y["depth2"] = sigmoid_depth(y["depth2"])
        y["pc_hm_out"] = at_least_f32(pc_resized[:, :pc_slice])
        return y


def _gathered_heads(h, convs):
    """The fused ``tower_0`` output of every head whole: the model ranks'
    fused outputs gathered along C (rank m's holds its slice of each split
    head's channels, and each unsplit head whole), then each split head's
    slices put together in rank order."""
    n = max(c.tp_shards for c in convs)
    local = h.shape[1]
    parts = tp_gather(h, n).unflatten(1, (n, local))
    out, off = [], 0
    for c in convs:
        width = c.weight.shape[0]  # this rank's channels of the head
        if c.tp_shards > 1:
            out.append(parts[:, :, off:off + width].flatten(1, 2))
        else:
            out.append(h[:, off:off + width])
        off += width
    return torch.cat(out, dim=1)
