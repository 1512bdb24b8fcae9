"""Aggregation-node variants and the depthwise bilinear upsampler.

The port of ``centerfusiondetect3d_tpu/models/layers.py``. Module and
parameter names follow the reference's state_dict (``src/lib/model/networks/
dla.py:315-524``), so a reference checkpoint loads with
``load_state_dict(strict=True)``: ``Conv`` is ``conv.{0,1}``, ``GlobalConv``
is ``convLeft``/``convRight`` plus ``activation.0``, and ``DeformConv`` is
``weight``/``bias``/``conv_offset_mask`` plus ``activation.0``. BatchNorm is
``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1), which in eval mode is exactly the
JAX package's ``TorchBatchNorm``.

Mixed precision follows the JAX modules' ``dtype`` fields: every module takes
a ``compute_dtype`` (None: the parameters' own dtype). With bfloat16 the
parameters and BatchNorm statistics stay float32 (so the state_dict and
checkpoints do not change), convolutions cast their input, weight and bias
to bf16 and return bf16, BatchNorm normalizes in float32 and returns bf16,
and a DCN node promotes its offset/mask projection to float32 before the
slice and the sigmoid and feeds the DCN bf16 ``x``, weight and bias
(``centerfusiondetect3d_tpu/models/layers.py:66, 88, 226-229, 304-306``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import deform_conv2d
from ..parallel.distributed import is_multiprocess


def _cast(t, dtype):
    return t if dtype is None or t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``: input, weight and bias
    are cast to it and so is the result (the JAX package's
    ``nn.Conv(dtype=...)``); the parameters keep their own dtype."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that normalizes and keeps its statistics in at
    least float32 and returns ``compute_dtype`` (the JAX package's
    ``TorchBatchNorm`` with a ``dtype``).

    In train mode under a process group of more than one rank
    (``parallel/distributed.py``) the batch statistics are those of the
    global batch, as JAX's are under SPMD ``jit``: the per-channel sums and
    counts, then the sums of squared deviations from the global mean, are
    all-reduced with the differentiable ``all_reduce`` (so gradients flow
    through the global statistics); it normalizes by the global mean and
    biased variance and updates the running variance with the unbiased
    global one. One process is ``nn.BatchNorm2d`` itself.
    """

    def __init__(self, num_features: int, compute_dtype=None):
        super().__init__(num_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and is_multiprocess():
            from torch.distributed.nn.functional import all_reduce

            y = self.batch_forward(x, all_reduce)
        else:
            y = super().forward(x)
        return y if dt is None else y.to(dt)

    def batch_forward(self, x, reduce):
        """Train mode on x with statistics from per-channel sums that
        ``reduce`` totals over the ranks (the differentiable ``all_reduce``;
        the identity gives one process's batch statistics by the same
        arithmetic): count and sum, then the squared deviations from the
        mean. Updates the running statistics."""
        c = x.shape[1]
        dims = (0, 2, 3)
        sums = reduce(torch.cat([x.sum(dims),
                                 x.new_full((1,), x.numel() // c)]))
        n = sums[c]
        mean = sums[:c] / n
        centred = x - mean[None, :, None, None]
        var = reduce(centred.square().sum(dims)) / n
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = (y * self.weight[None, :, None, None]
             + self.bias[None, :, None, None])
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            unbiased = var * (n / (n - 1).clamp(min=1))
            self.running_mean.mul_(1 - m).add_(mean.to(
                self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1 - m).add_(unbiased.to(
                self.running_var.dtype), alpha=m)
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as
    :class:`Conv2d` does."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)


class ConvNode(nn.Module):
    """1x1 conv-BN-ReLU aggregation node (reference ``Conv``)."""

    def __init__(self, cin: int, cout: int, compute_dtype=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(cin, cout, 1, bias=False, compute_dtype=compute_dtype),
            BatchNorm2d(cout, compute_dtype), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv(x)


class GlobalConvNode(nn.Module):
    """Separable kx1 + 1xk pair, summed, then BN-ReLU (reference
    ``GlobalConv``, dla.py:328-382)."""

    def __init__(self, cin: int, cout: int, k: int = 7, compute_dtype=None):
        super().__init__()
        pad = k // 2
        dt = compute_dtype
        self.convLeft = nn.Sequential(
            Conv2d(cin, cout, (k, 1), padding=(pad, 0), bias=False,
                   compute_dtype=dt),
            Conv2d(cout, cout, (1, k), padding=(0, pad), bias=False,
                   compute_dtype=dt))
        self.convRight = nn.Sequential(
            Conv2d(cin, cout, (1, k), padding=(0, pad), bias=False,
                   compute_dtype=dt),
            Conv2d(cout, cout, (k, 1), padding=(pad, 0), bias=False,
                   compute_dtype=dt))
        self.activation = nn.Sequential(BatchNorm2d(cout, dt),
                                        nn.ReLU(inplace=True))

    def forward(self, x):
        return self.activation(self.convLeft(x) + self.convRight(x))


class DeformConvNode(nn.Module):
    """DCNv2 node (reference ``DeformConv``, dla.py:385-472).

    A 3x3 conv predicts 27 channels: 18 offsets and 9 mask logits, sigmoided.
    The offset conv starts at zero, so a fresh node is a plain 3x3 conv. The
    deformable op is ``dcn_fn``, :func:`ops.dcn.deform_conv2d` (the CUDA
    kernel on the card, the bf16 one under a bf16 ``compute_dtype``); a
    caller may set it to the plain version to compare.
    """

    def __init__(self, cin: int, cout: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        bound = 1.0 / np.sqrt(cin * 9)
        nn.init.uniform_(self.weight, -bound, bound)
        self.conv_offset_mask = Conv2d(cin, 27, 3, padding=1, bias=True,
                                       compute_dtype=compute_dtype)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.activation = nn.Sequential(BatchNorm2d(cout, compute_dtype),
                                        nn.ReLU(inplace=True))
        self.dcn_fn = deform_conv2d

    def forward(self, x):
        om = self.conv_offset_mask(x)
        # sampling coordinates and mask in at least float32
        om = om.to(torch.promote_types(om.dtype, torch.float32))
        offset = om[:, :18].contiguous()
        mask = torch.sigmoid(om[:, 18:]).contiguous()
        dt = self.compute_dtype
        y = self.dcn_fn(_cast(x, dt).contiguous(), offset, mask,
                        _cast(self.weight, dt), _cast(self.bias, dt))
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


def bilinear_up(channels: int, factor: int,
                compute_dtype=None) -> ConvTranspose2d:
    """Depthwise stride-f transposed conv, kernel 2f, padding f//2, with the
    bilinear kernel in every channel (reference dla.py:502-512)."""
    up = ConvTranspose2d(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False,
                         compute_dtype=compute_dtype)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(bilinear_kernel(factor)).expand_as(
            up.weight))
    return up
