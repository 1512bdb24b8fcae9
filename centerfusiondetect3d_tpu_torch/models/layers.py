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

Under a height-sharded layout (``parallel/mesh.py``: inside ``row_shard``)
each module computes exactly its rank's rows of the unsharded module: a
convolution taller than a row, or strided, takes halo rows from the
neighbouring ranks (``parallel/collectives.py:conv_halo``; zeros at the
image's edges) and pads only W; the transposed upsampler takes one row on
each side and keeps its rows of the result; a DeformConv node gathers its
input's rows and writes its own output rows through the DCN's row origin.
BatchNorm totals over the layout's data and spatial ranks. A conv that
``parallel/mesh.py:shard_params_tp`` split over the model axis gathers its
output channels before the next layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import deform_conv2d
from ..parallel.collectives import conv_halo, gather_channels, transpose_halo
from ..parallel.distributed import is_multiprocess
from ..parallel.mesh import (MODEL_AXIS, STATS_GROUP, active_layout,
                             current_rows)


def _cast(t, dtype):
    return t if dtype is None or t is None else t.to(dtype)


def _operands(module, x):
    """x, weight and bias of a conv module in its ``compute_dtype``."""
    dt = module.compute_dtype
    return _cast(x, dt), _cast(module.weight, dt), _cast(module.bias, dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``: input, weight and bias
    are cast to it and so is the result (the JAX package's
    ``nn.Conv(dtype=...)``); the parameters keep their own dtype.

    On a height-sharded map it reads its halo rows; with ``tp_shards`` > 1
    (``parallel/mesh.py:shard_params_tp``) it holds its model rank's output
    channels and gathers the rest."""

    tp_shards = 1

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        rows = current_rows()
        kh, sh, ph = self.kernel_size[0], self.stride[0], self.padding[0]
        if rows is not None and (kh > 1 or sh > 1):
            if x.shape[2] % sh:
                raise ValueError(f"a stride-{sh} conv on {x.shape[2]} rows a "
                                 "rank: the slices must stay aligned")
            y = self._conv(rows.halo(x, *conv_halo(kh, sh, ph)),
                           (0, self.padding[1]))
        else:
            y = self._conv(x, self.padding)
        return y if self.tp_shards == 1 else tp_gather(y, self.tp_shards)

    def _conv(self, x, padding):
        return F.conv2d(*_operands(self, x), self.stride, padding,
                        self.dilation, self.groups)


def tp_gather(y, shards: int):
    """The output channels of every model rank of the active layout
    (``parallel/collectives.py:gather_channels``)."""
    lay = active_layout()
    if lay is None or lay.n_model != shards:
        raise RuntimeError(f"a conv split {shards} ways over the model axis "
                           "runs only inside its layout (parallel.layout)")
    return gather_channels(y, lay.group(MODEL_AXIS))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that normalizes and keeps its statistics in at
    least float32 and returns ``compute_dtype`` (the JAX package's
    ``TorchBatchNorm`` with a ``dtype``).

    In train mode under a process group of more than one rank
    (``parallel/distributed.py``; under a layout, its data and spatial
    ranks: the model ranks hold copies of the same rows) the batch
    statistics are those of the global batch, as JAX's are under SPMD
    ``jit``: the per-channel sums and
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
        lay = active_layout() if self.training else None
        if lay is not None:
            multi, kw = lay.size(STATS_GROUP) > 1, {}
            if lay.group(STATS_GROUP) is not None:
                kw["group"] = lay.group(STATS_GROUP)
        else:
            multi, kw = self.training and is_multiprocess(), {}
        if multi:
            from torch.distributed.nn.functional import all_reduce

            y = self.batch_forward(x, lambda t: all_reduce(t, **kw))
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
        rows = current_rows()
        if rows is None:
            return self._conv(x, self.padding)
        above, below, first = transpose_halo(
            self.kernel_size[0], self.stride[0], self.padding[0])
        y = self._conv(rows.halo(x, above, below), (0, self.padding[1]))
        return y.narrow(2, first, self.stride[0] * x.shape[2])

    def _conv(self, x, padding):
        return F.conv_transpose2d(*_operands(self, x), self.stride, padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


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
        rows = current_rows()
        # a rank's output rows read every row of x: no offset clamp
        kw = {} if rows is None else {"row0": rows.row0(x.shape[2])}
        if rows is not None:
            x = rows.gather(x)
        y = self.dcn_fn(_cast(x, dt).contiguous(), offset, mask,
                        _cast(self.weight, dt), _cast(self.bias, dt), **kw)
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
