"""DLA-34 backbone, NCHW.

The port of ``centerfusiondetect3d_tpu/models/dla.py`` with the plain stem
only (the JAX package's space-to-depth stem is an exact TPU
reparameterisation of the same weights). Hierarchical deep aggregation with
recursive Trees, 1x1 Root merges and BasicBlock residual units; multi-level
trees create no outer ``project`` (the reference deletes it, dla.py:220-223),
and the root residual is off for DLA-34. Names follow the reference
state_dict (``base.level3.tree1.tree2.conv1.weight`` and so on). Every module
computes in its ``compute_dtype`` (``models/layers.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)


def conv_bn_relu(cin: int, cout: int, k: int = 3, stride: int = 1,
                 compute_dtype=None):
    """Conv-BN-ReLU as three Sequential entries (reference ``_make_conv_level``
    and ``base_layer`` numbering)."""
    return [Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                   bias=False, compute_dtype=compute_dtype),
            BatchNorm2d(cout, compute_dtype), nn.ReLU(inplace=True)]


class BasicBlock(nn.Module):
    """3x3-3x3 residual block with an externally supplied residual."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1,
                            bias=False, compute_dtype=dt)
        self.bn1 = BatchNorm2d(cout, dt)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False,
                            compute_dtype=dt)
        self.bn2 = BatchNorm2d(cout, dt)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    """1x1 merge of the tree's children."""

    def __init__(self, cin: int, cout: int, compute_dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False,
                           compute_dtype=compute_dtype)
        self.bn = BatchNorm2d(cout, compute_dtype)

    def forward(self, children: Sequence[torch.Tensor]):
        return F.relu(self.bn(self.conv(torch.cat(list(children), dim=1))))


class Tree(nn.Module):
    """Recursive hierarchical aggregation tree."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        root_dim = root_dim if root_dim else 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride, dt)
            self.tree2 = BasicBlock(cout, cout, 1, dt)
            self.root = Root(root_dim, cout, dt)
            self.project = (nn.Sequential(
                Conv2d(cin, cout, 1, bias=False, compute_dtype=dt),
                BatchNorm2d(cout, dt)) if cin != cout else None)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, compute_dtype=dt)
            self.tree2 = Tree(levels - 1, cout, cout,
                              root_dim=root_dim + cout, compute_dtype=dt)

    def forward(self, x, children: List[torch.Tensor] = None):
        children = [] if children is None else list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None \
                else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1, *children])
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLA(nn.Module):
    """7x7 stem, two conv levels, four aggregation trees; returns the six
    per-stride features (strides 1..32)."""

    def __init__(self, in_channels: int = 3,
                 levels: Sequence[int] = DLA34_LEVELS,
                 channels: Sequence[int] = DLA34_CHANNELS,
                 compute_dtype=None):
        super().__init__()
        ch = channels
        dt = compute_dtype
        self.base_layer = nn.Sequential(*conv_bn_relu(in_channels, ch[0], 7,
                                                      compute_dtype=dt))
        self.level0 = nn.Sequential(*[
            m for i in range(levels[0])
            for m in conv_bn_relu(ch[0], ch[0], compute_dtype=dt)])
        self.level1 = nn.Sequential(*[
            m for i in range(levels[1])
            for m in conv_bn_relu(ch[0] if i == 0 else ch[1], ch[1],
                                  stride=2 if i == 0 else 1,
                                  compute_dtype=dt)])
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False,
                           compute_dtype=dt)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           compute_dtype=dt)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           compute_dtype=dt)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           compute_dtype=dt)

    def forward(self, x):
        x = self.base_layer(x)
        feats = []
        for name in ("level0", "level1", "level2", "level3", "level4",
                     "level5"):
            x = getattr(self, name)(x)
            feats.append(x)
        return feats
