"""ResNet-18/34 backbones, NCHW: an alternative to DLA-34.

The port of ``centerfusiondetect3d_tpu/models/resnet.py``, an extension
over the reference (whose model factory builds DLA only,
``src/lib/model/model.py:12-14``). It gives the six-level pyramid of
``models/dla.py:DLA`` (strides 1 to 32, 16/32/64/128/256/512 channels), so
DLAUp/IDAUp, their 16 DCN nodes and every head serve unchanged behind it:
``MODEL.ARCH resnet_18`` or ``resnet_34``. Conv-BN-ReLU units are
``models/dla.py:conv_bn_relu``'s, with the port's BatchNorm (momentum 0.1,
the JAX package's 0.9) and ``compute_dtype``, so a bf16 model follows the
DLA backbone's precision rules. Module names follow the JAX parameter
paths: ``stem``, ``level1`` and ``layer{stage}_{block}`` with ``conv1``,
``conv2`` and ``downsample``, each a Sequential of conv (0) and BN (1).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .dla import conv_bn_relu

RESNET_SPECS = {
    "18": (2, 2, 2, 2),
    "34": (3, 4, 6, 3),
}
STAGE_CHANNELS = (64, 128, 256, 512)


class ResBlock(nn.Module):
    """The basic block: 3x3 conv-BN-ReLU, 3x3 conv-BN, a 1x1 conv-BN
    projection where the stride or the width changes, ReLU of the sum."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = nn.Sequential(*conv_bn_relu(cin, cout, 3, stride, dt))
        self.conv2 = nn.Sequential(*conv_bn_relu(cout, cout, 3, 1, dt)[:2])
        self.downsample = (nn.Sequential(
            *conv_bn_relu(cin, cout, 1, stride, dt)[:2])
            if stride != 1 or cin != cout else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + residual)


class ResNetBackbone(nn.Module):
    """A 7x7 stem (16 channels, stride 1), a 3x3 stride-2 level (32), then
    four stages of ``RESNET_SPECS[depth]`` blocks whose first block halves
    the resolution; returns the six per-stride features."""

    def __init__(self, depth: str = "18", in_channels: int = 3,
                 compute_dtype=None):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise NotImplementedError(f"resnet_{depth}: no such depth "
                                      f"({', '.join(RESNET_SPECS)})")
        dt = compute_dtype
        self.stem = nn.Sequential(*conv_bn_relu(in_channels, 16, 7,
                                                compute_dtype=dt))
        self.level1 = nn.Sequential(*conv_bn_relu(16, 32, 3, 2, dt))
        self.stages = []
        cin = 32
        for stage, (n_blocks, ch) in enumerate(zip(RESNET_SPECS[depth],
                                                   STAGE_CHANNELS)):
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, ResBlock(cin, ch, 2 if b == 0 else 1,
                                               dt))
                names.append(name)
                cin = ch
            self.stages.append(names)

    def forward(self, x):
        x = self.stem(x)
        feats = [x]
        x = self.level1(x)
        feats.append(x)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats
