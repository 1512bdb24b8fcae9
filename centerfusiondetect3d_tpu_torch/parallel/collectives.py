"""The collectives of the (data, spatial, model) layout, as autograd
functions.

Each rank of a layout computes the same global loss (``losses/
primitives.py`` totals it over the data group; spatial and model ranks
see the same whole maps). The gradient a rank's backward computes is that
of the sum of every rank's loss: each collective's backward is the exact
adjoint of its forward under that sum (an all-gather's is the reduce-scatter
that sums; a halo copy's sends the halo's gradient back to the rows it came
from and adds it there), and ``parallel/mesh.py:reduce_gradients`` divides
by the world size, so the applied gradient is the loss's own. The spatial
and model ranks' replicated copies of a parameter are summed there too,
which is what makes the sum exact: a rank's backbone gradient covers its own
rows, and its head gradient its share of the world's copies.

The spatial collectives move tensors along H (dim 2 of NCHW) over the
spatial group, the channel gather along C (dim 1) over the model group.
Under gloo a CUDA tensor goes through host memory (``all_gather``,
``flat_all_reduce``); NCCL takes it as it is.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    """Whether the collective takes ``t`` through host memory: a CUDA
    tensor under gloo, whose all-gather wants host tensors."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and dtype on each), in group rank
    order, on ``t``'s device; no gradient."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = [p.to(t.device, non_blocking=False) for p in parts]
    return parts


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` in group rank order; the backward sums the
    gathered gradient over the group and keeps this rank's slice (the
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.size = t.shape[dim]
        return torch.cat(all_gather(t, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return (total.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along ``dim``, with the
    summing adjoint; one rank: ``t``."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    return _GatherDim.apply(t, dim, group)


class _Halo(torch.autograd.Function):
    """``above`` rows of the previous spatial rank, ``t``, ``below`` rows of
    the next one, concatenated along H; zeros past the first and last rank
    (the image's edges). The backward returns each halo's gradient to the
    rank it came from, added to its rows."""

    @staticmethod
    def forward(ctx, t, above, below, group):
        ctx.above, ctx.below, ctx.group = above, below, group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        h = t.shape[2]
        # what this rank sends: its first `below` rows (the previous rank's
        # lower halo) and its last `above` rows (the next rank's upper halo)
        packet = torch.cat([t[:, :, :below], t[:, :, h - above:]], dim=2)
        parts = all_gather(packet, group)
        b, c, _, w = t.shape
        top = (parts[i - 1][:, :, below:] if i > 0
               else t.new_zeros((b, c, above, w)))
        bottom = (parts[i + 1][:, :, :below] if i + 1 < n
                  else t.new_zeros((b, c, below, w)))
        return torch.cat([top, t, bottom], dim=2)

    @staticmethod
    def backward(ctx, grad):
        above, below, group = ctx.above, ctx.below, ctx.group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        h = grad.shape[2] - above - below
        g_top = grad[:, :, :above]
        g_bottom = grad[:, :, above + h:]
        dx = grad[:, :, above:above + h].contiguous().clone()
        # send each halo's gradient back: the previous rank owns the top
        # halo (its last rows), the next rank the bottom one (its first)
        parts = all_gather(torch.cat([g_top, g_bottom], dim=2), group)
        if i + 1 < n and above:
            dx[:, :, h - above:] += parts[i + 1][:, :, :above]
        if i > 0 and below:
            dx[:, :, :below] += parts[i - 1][:, :, above:]
        return dx, None, None, None


class SpatialRows:
    """This rank's rows of a height-sharded map: the ``index``-th of the
    spatial ranks' equal slices of H, exchanged over the spatial ``group``.
    ``models/layers.py`` reads it while a height-sharded forward runs
    (``parallel/mesh.py:Mesh.rows``)."""

    def __init__(self, group, index: int):
        self.group, self.index = group, int(index)

    def row0(self, local_rows: int) -> int:
        """The first row of this rank's slice of a map of ``local_rows``
        rows a rank."""
        return self.index * int(local_rows)

    def halo(self, t: torch.Tensor, above: int, below: int) -> torch.Tensor:
        """``t`` with ``above`` rows before it and ``below`` after it from
        the neighbouring ranks (zeros at the image's edges); the rows
        needed must lie in the neighbours' slices."""
        if above == 0 and below == 0:
            return t
        if max(above, below) > t.shape[2]:
            raise ValueError(
                f"a halo of {max(above, below)} rows needs at least that "
                f"many rows a rank, got {t.shape[2]}: the input height must "
                "be larger, or TPU.MESH_SPATIAL smaller")
        return _Halo.apply(t, int(above), int(below), self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole map along H, every rank's slice in order (the adjoint
        sums over the ranks and keeps this rank's rows)."""
        return gather_dim(t, 2, self.group)


def gather_channels(t: torch.Tensor, group) -> torch.Tensor:
    """The model ranks' output-channel slices of a tensor-parallel conv
    concatenated along C in rank order (:func:`gather_dim`)."""
    return gather_dim(t, 1, group)


def conv_halo(kernel: int, stride: int, padding: int):
    """(above, below): the input rows beyond a slice that a convolution of
    ``kernel`` rows, ``stride`` and zero ``padding`` reads to give exactly
    the slice's output rows (output row i reads rows stride*i - padding
    ... + kernel - 1), for slices whose first row is a multiple of the
    stride."""
    return padding, max(0, kernel - padding - stride)


def transpose_halo(kernel: int, stride: int, padding: int):
    """(above, below, first): the input rows beyond a slice that a
    transposed convolution needs for the slice's output rows, and where
    those rows start in its output on the padded slice (stride * above +
    padding)."""
    above = (kernel - 1 - padding) // stride
    below = (padding - 1) // stride + 1
    return above, below, stride * above + padding


def flat_all_reduce(tensors: Sequence[torch.Tensor], group,
                    scale: float) -> None:
    """``scale`` times the sum over ``group`` of each tensor, in place, in
    one collective over their concatenation."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = _staged(flat, group)
    buf = flat.cpu() if staged else flat
    dist.all_reduce(buf, group=group)
    if staged:
        flat = buf.to(flat.device)
    flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
