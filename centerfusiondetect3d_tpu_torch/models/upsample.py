"""Iterative and hierarchical deep aggregation upsampling (IDAUp, DLAUp).

The port of ``centerfusiondetect3d_tpu/models/upsample.py`` (reference
dla.py:492-559): per level a projection node, a depthwise bilinear
transposed-conv upsample and a merge node after the skip add. Names follow
the reference: ``proj_i``, ``up_i``, ``node_i``, ``ida_i``. Every node and
upsampler computes in ``compute_dtype`` (``models/layers.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from torch import nn

from .layers import NODE_TYPES, bilinear_up


class IDAUp(nn.Module):
    def __init__(self, cout: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], node: str = "DeformConv",
                 compute_dtype=None):
        super().__init__()
        proj_cls, node_cls = NODE_TYPES[node]
        dt = compute_dtype
        for i in range(1, len(in_channels)):
            setattr(self, f"proj_{i}", proj_cls(int(in_channels[i]), cout,
                                                compute_dtype=dt))
            setattr(self, f"up_{i}", bilinear_up(cout, int(up_factors[i]), dt))
            setattr(self, f"node_{i}", node_cls(cout, cout, compute_dtype=dt))

    def forward(self, layers: List, startp: int, endp: int) -> List:
        """Aggregate layers[startp:endp]; returns the updated list."""
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int], node: str = "DeformConv",
                 compute_dtype=None):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array(scales, int)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                (scales[j:] // scales[j]).tolist(), node, compute_dtype))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers: List) -> List:
        """Backbone features -> aggregated pyramid, finest first."""
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            layers = getattr(self, f"ida_{i}")(
                layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out
