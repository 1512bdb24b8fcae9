"""Seeded weights made on the device in a few large calls, the same for
the program and the reference.

Convolutions are He-normal (a DCN node's offset convolution drawn so that
its offsets are about a pixel, not zero, so that a wrong sampler shows),
BatchNorm scales uniform in [0.5, 1.5), biases N(0, 0.1); the heads' last
biases are those of a car-sized object at ~20 m (heatmap -4.6, depth
-log 20, dimension 1.5/1.6/4.0 m), so the frustum association finds
radar. The bilinear upsamplers keep their fixed kernels. BatchNorm running
statistics are set by :func:`calibrate` from one batch of the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def seeded_state(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of
    ``model`` (the reference; the program has the same names)."""
    params = [(n, p) for n, p in model.named_parameters()]
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    state, off = {}, 0
    for name, p in params:
        n = p.numel()
        z, u = normal[off:off + n].view(p.shape), uniform[off:off + n].view(p.shape)
        off += n
        if ".up_" in name:
            state[name] = p.detach().to(device=device, dtype=torch.float32)
        elif p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            gain = 1.5 if "conv_offset_mask" in name else math.sqrt(2.0)
            state[name] = z * (gain / math.sqrt(fan_in))
        elif name.endswith("weight"):
            state[name] = 0.5 + u
        else:
            state[name] = 0.1 * z
    heads = {}
    for name in state:
        parts = name.split(".")
        if parts[0] == "detectHead_0" and parts[-1] == "bias":
            heads[parts[1]] = max(heads.get(parts[1], 0), int(parts[2]))
    last = lambda h: state[f"detectHead_0.{h}.{heads[h]}.bias"]
    last("heatmap").fill_(-4.6)
    for h in ("depth", "depth2"):
        if h in heads:
            last(h).fill_(-math.log(20.0))
    last("dimension").copy_(torch.tensor([1.5, 1.6, 4.0], device=device))
    return state


@torch.no_grad()
def calibrate(model: torch.nn.Module, *inputs, **kw) -> None:
    """Every BatchNorm's running statistics set to those of one batch:
    ``model`` runs once in train mode with a cumulative average."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    model.train()
    try:
        model(*inputs, **kw)
    finally:
        model.eval()
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = 0.1
