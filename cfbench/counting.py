"""Operations and bytes the benchmark's rooflines and MFU divide by,
counted from shapes, and the card's peaks.

The peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity) at its full 700 W. A kernel's least time is the larger of its
operations at peak and its bytes at peak bandwidth, each input read and
each output written once: it counts the op's work, not that of the kernel
that implements it, so a redesigned kernel does not make it stale.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12  # FLOP/s, dense tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3

Shape = Tuple[int, int, int, int, int]  # (B, C, H, W, O) of a DCN node


def dcn_fwd_bf16(shape: Shape) -> Tuple[float, float, float]:
    """(flops, bytes, least seconds) of one bf16 DCN forward: the 9*C*O
    multiply-adds of each output pixel at the bf16 rate; x, weight, bias
    and the output in bf16, offset and mask in float32."""
    b, c, h, w, o = shape
    flops = 2.0 * b * h * w * 9 * c * o
    nbytes = (2 * (b * c * h * w + o * c * 9 + o + b * o * h * w)
              + 4 * b * 27 * h * w)
    return flops, nbytes, max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def dcn_bwd_bf16(shape: Shape) -> Tuple[float, float, float]:
    """(flops, bytes, least seconds) of one bf16 DCN backward, the whole
    op: its two contractions (the weight gradient and the column
    gradients, 9*C*O multiply-adds an output pixel each) at the bf16 rate;
    bytes: x, the output gradient and the weight read in bf16, offset and
    mask in float32; dx, the weight and bias gradients written in bf16,
    the offset and mask gradients in float32. What a route keeps between
    its kernels (the columns) is its own, not the op's."""
    b, c, h, w, o = shape
    hw = h * w
    flops = 2 * 2.0 * b * hw * 9 * c * o
    x, g, wt, om = b * c * hw, b * o * hw, o * c * 9, 27 * b * hw
    nbytes = 2.0 * (x + g + wt) + 4 * om + 2.0 * (x + wt + o) + 4 * om
    return flops, nbytes, max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def count_model(model, *inputs) -> Dict[str, object]:
    """Forward work of the reference ``model`` (``cfbench/reference/
    model.py``) on ``inputs``, by forward hooks on the ops that carry it:
    every convolution and transposed convolution (input channels per group
    x kernel size multiply-adds an output element; a transposed one, an
    input element), and each DCN node's contraction (9 * C * O a pixel; its
    offset convolution is a convolution). Flops are 2 x multiply-adds.
    Run on the ``meta`` device nothing is computed.

    Returns ``flops`` and ``layers``: (qualified name, flops) in call
    order, and ``dcn``: the nodes' (B, C, H, W, O)."""
    import torch

    from .reference.model import DeformConvNode

    layers: List[Tuple[str, float]] = []
    dcn: List[Shape] = []
    names = {m: n for n, m in model.named_modules()}

    def hook(m, args, out):
        x = args[0]
        if isinstance(m, DeformConvNode):
            b, c, h, w = x.shape
            o = m.weight.shape[0]
            dcn.append((b, c, h, w, o))
            layers.append((names[m] + ".dcn", 2.0 * b * h * w * 9 * c * o))
            return
        if isinstance(m, torch.nn.ConvTranspose2d):
            macs = x.numel() * m.weight[0].numel()
        else:
            macs = out.numel() * m.weight[0].numel()
        layers.append((names[m], 2.0 * macs))

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, DeformConvNode)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return {"flops": sum(f for _, f in layers), "layers": layers,
            "dcn": dcn}


def train_flops(layers, frozen_prefixes=()) -> float:
    """Work of one training step from the forward's ``layers`` (in call
    order): each layer's forward; for a layer with trainable parameters its
    weight gradient (as much again); and its input's gradient (as much
    again) where a trainable layer feeds it. Layers under one of
    ``frozen_prefixes`` train nothing. The network's first layer takes no
    input gradient, nor, with the backbone frozen, does anything that only
    the backbone feeds: the backbone itself and each head's first layer."""
    frozen = tuple(frozen_prefixes)
    head = "detectHead_0."
    backbone_trains = any(not n.startswith(head) and not n.startswith(frozen)
                          for n, _ in layers) if frozen else True
    total = 0.0
    for i, (name, flops) in enumerate(layers):
        total += flops
        if not (frozen and name.startswith(frozen)):
            total += flops
        if name.startswith(head) and name.split(".")[2] != "0":
            needs_dx = True
        else:
            needs_dx = i > 0 and backbone_trains
        if needs_dx:
            total += flops
    return total
