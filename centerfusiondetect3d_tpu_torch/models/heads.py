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
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from .layers import Conv2d

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
    compute_dtype: the towers' (``models/layers.py``).
    """

    def __init__(self, cin: int, heads: Mapping[str, int],
                 head_conv: Mapping[str, Sequence[int]],
                 secondary: Sequence[str] = (), pc_channels: int = 3,
                 compute_dtype=None):
        super().__init__()
        self.first = [n for n in heads if n not in secondary]
        self.secondary = [n for n in secondary if n in heads]
        for name, nout in heads.items():
            width = cin + (pc_channels if name in self.secondary else 0)
            setattr(self, name, head_tower(width, int(nout),
                                           tuple(head_conv.get(name, ())),
                                           "heatmap" in name, compute_dtype))

    def first_stage(self, feats) -> Dict[str, torch.Tensor]:
        y = {n: at_least_f32(getattr(self, n)(feats)) for n in self.first}
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
        y = {n: at_least_f32(getattr(self, n)(sec_feats))
             for n in self.secondary}
        if "depth2" in y:
            y["depthMap"] = y["depth2"]
            y["depth2"] = sigmoid_depth(y["depth2"])
        y["pc_hm_out"] = at_least_f32(pc_resized[:, :pc_slice])
        return y
