"""Aggregation-node variants and the depthwise bilinear upsampler.

The port of ``centerfusiondetect3d_tpu/models/layers.py``. Module and
parameter names follow the reference's state_dict (``src/lib/model/networks/
dla.py:315-524``), so a reference checkpoint loads with
``load_state_dict(strict=True)``: ``Conv`` is ``conv.{0,1}``, ``GlobalConv``
is ``convLeft``/``convRight`` plus ``activation.0``, and ``DeformConv`` is
``weight``/``bias``/``conv_offset_mask`` plus ``activation.0``. BatchNorm is
``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1), which in eval mode is exactly the
JAX package's ``TorchBatchNorm``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.dcn import deform_conv2d


class ConvNode(nn.Module):
    """1x1 conv-BN-ReLU aggregation node (reference ``Conv``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv(x)


class GlobalConvNode(nn.Module):
    """Separable kx1 + 1xk pair, summed, then BN-ReLU (reference
    ``GlobalConv``, dla.py:328-382)."""

    def __init__(self, cin: int, cout: int, k: int = 7):
        super().__init__()
        pad = k // 2
        self.convLeft = nn.Sequential(
            nn.Conv2d(cin, cout, (k, 1), padding=(pad, 0), bias=False),
            nn.Conv2d(cout, cout, (1, k), padding=(0, pad), bias=False))
        self.convRight = nn.Sequential(
            nn.Conv2d(cin, cout, (1, k), padding=(0, pad), bias=False),
            nn.Conv2d(cout, cout, (k, 1), padding=(pad, 0), bias=False))
        self.activation = nn.Sequential(nn.BatchNorm2d(cout),
                                        nn.ReLU(inplace=True))

    def forward(self, x):
        return self.activation(self.convLeft(x) + self.convRight(x))


class DeformConvNode(nn.Module):
    """DCNv2 node (reference ``DeformConv``, dla.py:385-472).

    A 3x3 conv predicts 27 channels: 18 offsets and 9 mask logits, sigmoided.
    The offset conv starts at zero, so a fresh node is a plain 3x3 conv. The
    deformable op is ``dcn_fn``, :func:`ops.dcn.deform_conv2d` (the CUDA
    kernel on the card); a caller may set it to the plain version to compare.
    """

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        bound = 1.0 / np.sqrt(cin * 9)
        nn.init.uniform_(self.weight, -bound, bound)
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1, bias=True)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.activation = nn.Sequential(nn.BatchNorm2d(cout),
                                        nn.ReLU(inplace=True))
        self.dcn_fn = deform_conv2d

    def forward(self, x):
        om = self.conv_offset_mask(x)
        offset = om[:, :18].contiguous()
        mask = torch.sigmoid(om[:, 18:]).contiguous()
        y = self.dcn_fn(x.contiguous(), offset, mask, self.weight, self.bias)
        return self.activation(y)


NODE_TYPES = {
    "DeformConv": (DeformConvNode, DeformConvNode),
    "GlobalConv": (ConvNode, GlobalConvNode),
    "Conv": (ConvNode, ConvNode),
}


def bilinear_kernel(factor: int) -> np.ndarray:
    """2f x 2f bilinear kernel (reference initUpModuleWeights,
    model/utils.py:90-109)."""
    size = 2 * factor
    f = int(np.ceil(size / 2))
    center = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.arange(size)
    k1d = 1 - np.abs(og / f - center)
    return np.outer(k1d, k1d).astype(np.float32)


def bilinear_up(channels: int, factor: int) -> nn.ConvTranspose2d:
    """Depthwise stride-f transposed conv, kernel 2f, padding f//2, with the
    bilinear kernel in every channel (reference dla.py:502-512)."""
    up = nn.ConvTranspose2d(channels, channels, 2 * factor, stride=factor,
                            padding=factor // 2, groups=channels, bias=False)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(bilinear_kernel(factor)).expand_as(
            up.weight))
    return up
