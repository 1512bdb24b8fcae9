"""Optimizer and the train step.

The port of ``centerfusiondetect3d_tpu/training/state.py`` (reference
``src/lib/model/modelWithLoss.py:43-77,275-299`` and ``trainer.py:65-69``):
one step = train-mode forward + GenericLoss + backward + one optimizer
update, with the BatchNorm running statistics updated by the forward.

Freezing the backbone (``MODEL.FREEZE_BACKBONE`` up to ``MODEL.DEFREEZE``)
turns ``requires_grad`` off on ``base``, ``dla_up`` and ``ida_up``, as the
reference does (dla.py:618-621): autograd then prunes the whole backbone
backward, DCN nodes included, and the frozen parameters keep ``.grad =
None``, so ``torch.optim`` neither decays them nor ticks their per-parameter
step counts. The JAX package imitates that with ``scale_by_adam_perparam``,
which infers activity from nonzero gradient values; the two agree whenever a
live parameter's gradient is not exactly zero (state.py:57-71 there).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.nn.parallel import DistributedDataParallel

from ..parallel.mesh import gradient_norm, layout, reduce_gradients

WEIGHT_DECAY = 5e-4


def make_optimizer(config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW (weight decay 5e-4) or SGD (momentum 0.9, weight decay 5e-4)
    over every parameter; the Trainer sets the LR of each step."""
    name = config.TRAIN.OPTIMIZER
    params = list(model.parameters())
    lr = float(config.TRAIN.LR)
    if name == "adam":
        return torch.optim.AdamW(params, lr=lr, weight_decay=WEIGHT_DECAY)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=WEIGHT_DECAY)
    raise ValueError(f"unknown optimizer {name!r}")


def set_backbone_frozen(model, frozen: bool) -> None:
    """requires_grad off (frozen) or on for ``base``, ``dla_up``, ``ida_up``."""
    for _, p in _unwrap(model).backbone_parameters():
        p.requires_grad_(not frozen)


def wrap_data_parallel(model, frozen: bool) -> DistributedDataParallel:
    """``model`` in ``DistributedDataParallel`` over the default process
    group for one phase of the run: DDP takes the parameters that require
    grad when it is built, so the backbone is frozen (or not) first and a
    run builds one wrapper per phase, as the JAX package builds one step
    per ``frozen``. Construction broadcasts rank 0's parameters and
    buffers; the BatchNorm statistics are the global batch's on every rank
    (``models/layers.py``), so buffers are not broadcast again."""
    set_backbone_frozen(model, frozen)
    dev = next(model.parameters()).device
    wrapper = DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False)
    wrapper.frozen = bool(frozen)
    return wrapper


def _unwrap(model):
    return model.module if isinstance(model, DistributedDataParallel) else model


def _microbatches(batch, n: int):
    """Split every tensor of a (nested) batch dict on its leading axis."""
    if n == 1:
        return [batch]
    out = [dict() for _ in range(n)]
    for key, value in batch.items():
        parts = (_microbatches(value, n) if isinstance(value, dict)
                 else value.chunk(n, dim=0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


def train_step(model, optimizer, loss_fn, batch: Dict, lr: float,
               frozen: bool = False, accum_steps: int = 1, mesh=None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer update on a device batch (``data/pipeline.py:to_device``).

    ``accum_steps > 1`` (``TRAIN.GRAD_ACCUM``) runs the forward and backward
    over that many sequential microbatches and applies one update with the
    mean gradient, like ``make_train_step`` and the reference's DDP ranks:
    each microbatch normalizes its own loss, and BatchNorm statistics update
    microbatch after microbatch. A batch size that ``accum_steps`` does not
    divide is rejected. Returns the loss parts (``total`` included) averaged
    over the microbatches, and ``grad_norm``, the global norm of the applied
    gradient, as 0-d tensors on the device.

    ``model`` may be a ``wrap_data_parallel`` wrapper built for this
    ``frozen``: each rank then steps on its own batch, the loss parts are
    the global batch's on every rank (``losses/primitives.py``), every
    microbatch but the last runs under ``no_sync`` and the applied gradient
    is that of the global batch.

    ``mesh`` (``parallel/mesh.py``; with a plain module, not a DDP
    wrapper) runs the forwards and losses under that layout, on the rank's
    ``shard_batch`` of its data shard, and applies the gradient that
    ``reduce_gradients`` makes of the ranks' backwards; ``grad_norm``
    counts every model rank's tensor-parallel slices.
    """
    b = batch["image"].shape[0]
    if accum_steps < 1 or b % accum_steps:
        raise ValueError(f"TRAIN.GRAD_ACCUM={accum_steps} must divide the "
                         f"batch size {b}")
    model.train()
    ddp = isinstance(model, DistributedDataParallel)
    if ddp and model.frozen != frozen:
        raise ValueError("train_step: the DistributedDataParallel wrapper "
                         f"was built for frozen={model.frozen}, not {frozen}")
    if ddp and mesh is not None:
        raise ValueError("train_step: a layout's step takes the module, "
                         "not its DistributedDataParallel wrapper")
    set_backbone_frozen(model, frozen)
    optimizer.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    micros = _microbatches(batch, accum_steps)
    for i, micro in enumerate(micros):
        sync = not ddp or i + 1 == len(micros)
        with contextlib.nullcontext() if sync else model.no_sync():
            with layout(mesh):
                outputs = model(micro["image"], micro.get("pc_dep"),
                                micro.get("calib"), micro.get("pc_hm"),
                                train=True)
                total, parts = loss_fn([outputs], micro)
            (total / accum_steps).backward()
        for k, v in parts.items():
            v = v.detach()
            sums[k] = sums[k] + v if k in sums else v
    if mesh is not None:
        reduce_gradients(model, mesh)
    metrics = {k: v / accum_steps for k, v in sums.items()}
    metrics["grad_norm"] = gradient_norm(model, mesh)
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    optimizer.step()
    return metrics
