"""The training loop: the reference Trainer on one CUDA card.

The port of ``centerfusiondetect3d_tpu/runtime/fit.py:Trainer`` (reference
``src/lib/trainer.py:20-127`` and its Lightning callbacks) as far as the
training epochs go: per epoch the frozen-or-not decision of
``MODEL.FREEZE_BACKBONE`` / ``MODEL.DEFREEZE``, the epoch's learning rate in
every parameter group, one ``train_step`` per batch, running-average
meters, a step timer that waits for the device, ``history["train"]``, the
non-finite-loss guard of ``TRAIN.NONFINITE_TOLERANCE``, and checkpoints:
``MODEL.LOAD_DIR`` (a reference ``.pt`` file) is loaded by ``init_state``,
with its epoch and optimizer state under ``TRAIN.RESUME``, and
``training/checkpoint.py:save_checkpoint`` writes ``OUTPUT_DIR/ckpts`` at
every ``TRAIN.SAVE_INTERVALS`` epoch and at the last one.

The model computes in the precision the config asks for
(``MIXED_PRECISION``, true in every shipped config: a bf16 model with float32
parameters, optimizer state and BatchNorm statistics, as the JAX package
trains), and checkpoints hold float32 tensors either way. The Trainer raises
instead of training otherwise than the config says: before the first step,
on a run whose epochs reach a ``TRAIN.VAL_INTERVALS`` epoch (validation is
not ported). Not ported yet (ROADMAP.md, Queue 1): validation,
``MetricsLogger``, ``DeviceHealthMonitor`` and loss plots; the training
profile is ``tools/profile_training.py``.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..data.pipeline import Loader, to_device
from ..losses import GenericLoss
from ..models import build_model
from ..training import learning_rate, make_optimizer, train_step
from ..training.checkpoint import load_torch_file, load_weights, save_checkpoint
from ..utils.device import resolve_device
from ..utils.observability import AverageMeter, StageTimer, ToleranceCounter
from .synthetic import seeded_weights


class Trainer:
    """Builds the model and loss of ``config`` on ``device`` (the CUDA card
    unless the caller names another) and trains it on ``dataset_train``
    (any object with ``__len__`` and ``get_item(index, rng)``).

    ``on_step(epoch, step, frozen, metrics)``, when given, is called after
    every step with the step's metrics as floats. The model follows
    ``MIXED_PRECISION`` through ``build_model(config)``: bf16 compute over
    float32 parameters when it is true.
    """

    def __init__(self, config, dataset_train=None, device=None,
                 logger: Optional[logging.Logger] = None,
                 on_step: Optional[Callable] = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config).to(self.device)
        self.loss_fn = GenericLoss(config)
        self.dataset_train = dataset_train
        self.logger = logger or logging.getLogger("cfd3d.trainer")
        self.on_step = on_step
        self.history: Dict[str, Dict[str, list]] = {"train": {}, "val": {}}
        self.steps: List[dict] = []  # per step: epoch, frozen, seconds, total
        self.start_epoch = 0
        self.optimizer = None
        self.timer = StageTimer(self.device)
        tol = int(config.TRAIN.get("NONFINITE_TOLERANCE", 5))
        self._nonfinite = ToleranceCounter(tol) if tol > 0 else None

    def init_state(self, state_dict=None, seed: Optional[int] = None):
        """Weights from ``state_dict`` (e.g. ``weights.state_dict_from_jax``,
        loaded strictly), else from the ``MODEL.LOAD_DIR`` checkpoint (a
        reference ``.pt``/``.pth`` file, loaded elastically; its loss history
        is taken over), else from ``runtime/synthetic.py:seeded_weights``
        with ``seed`` (``RANDOM_SEED`` by default); then a fresh optimizer.
        Under ``TRAIN.RESUME`` the checkpoint's epoch sets the first epoch
        and its optimizer state is restored, as the JAX package's
        ``Trainer.init_state`` resumes."""
        cfg = self.config
        ckpt = None
        if state_dict is not None:
            self.model.load_state_dict(
                {k: v.to(self.device) for k, v in state_dict.items()},
                strict=True)
        elif cfg.MODEL.LOAD_DIR:
            ckpt = load_torch_file(cfg.MODEL.LOAD_DIR)
            load_weights(self.model, ckpt["state_dict"], self.logger)
            hist = ckpt["history"]
            if hist["train"] or hist["val"]:
                self.history = {"train": dict(hist["train"]),
                                "val": dict(hist["val"])}
            self.logger.info("loaded weights from %s", cfg.MODEL.LOAD_DIR)
        else:
            seeded_weights(self.model, int(cfg.RANDOM_SEED
                                           if seed is None else seed))
        self.optimizer = make_optimizer(cfg, self.model)
        if ckpt is not None and cfg.TRAIN.RESUME:
            if ckpt["epoch"] >= 0:
                self.start_epoch = ckpt["epoch"] + 1
            if ckpt["optimizer"] is not None:
                try:
                    self.optimizer.load_state_dict(ckpt["optimizer"])
                except ValueError as e:  # another optimizer or parameter set
                    self.logger.warning("checkpoint optimizer state does not "
                                        "fit (%s); resuming with a fresh "
                                        "optimizer", e)
            self.logger.info("resuming at epoch %d", self.start_epoch)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info("parameters: %.2fM", n_params / 1e6)

    def train(self):
        cfg = self.config
        if self.optimizer is None:
            self.init_state()
        self._refuse_validation()
        loader = Loader(self.dataset_train, cfg.TRAIN.BATCH_SIZE,
                        shuffle=cfg.TRAIN.SHUFFLE, seed=cfg.RANDOM_SEED,
                        augment=True)
        accum = int(cfg.TRAIN.get("GRAD_ACCUM", 1))
        for epoch in range(self.start_epoch, cfg.TRAIN.EPOCHS):
            frozen = (bool(cfg.MODEL.FREEZE_BACKBONE)
                      and epoch <= cfg.MODEL.DEFREEZE)
            lr = learning_rate(cfg, epoch, self.start_epoch)
            meters = defaultdict(AverageMeter)
            self.timer.reset()
            loader.epoch = epoch
            for i, batch in enumerate(loader):
                batch = to_device(batch, self.device)
                self.timer.start("step")
                metrics = train_step(self.model, self.optimizer, self.loss_fn,
                                     batch, lr, frozen, accum)
                seconds = self.timer.stop("step")
                metrics = {k: float(v) for k, v in metrics.items()}
                for k, v in metrics.items():
                    meters[k].update(v)
                self.steps.append({"epoch": epoch, "frozen": frozen,
                                   "seconds": seconds,
                                   "total": metrics["total"]})
                self._guard_nonfinite(metrics["total"], epoch, i)
                if self.on_step is not None:
                    self.on_step(epoch, i, frozen, metrics)
            self.logger.info(
                "epoch %d lr %.2e frozen %s (%.0f ms/step) %s", epoch, lr,
                frozen, 1e3 * self.timer.meters["step"].avg,
                " ".join(f"{k} {m.avg:.4f}" for k, m in sorted(meters.items())))
            for k, m in meters.items():
                self.history["train"].setdefault(k, []).append(m.avg)
            interval = int(cfg.TRAIN.SAVE_INTERVALS)
            if ((interval > 0 and (epoch + 1) % interval == 0)
                    or epoch + 1 == cfg.TRAIN.EPOCHS):
                path = save_checkpoint(os.path.join(cfg.OUTPUT_DIR, "ckpts"),
                                       self.model, self.optimizer, epoch,
                                       self.history)
                self.logger.info("saved %s", path)
        return self.history

    def _refuse_validation(self):
        """Validation inside the Trainer is not ported: a run whose epochs
        reach a ``TRAIN.VAL_INTERVALS`` epoch raises before its first step
        rather than skip the validation."""
        cfg = self.config
        interval = int(cfg.TRAIN.VAL_INTERVALS)
        if interval <= 0:
            return
        due = [e for e in range(self.start_epoch, int(cfg.TRAIN.EPOCHS))
               if (e + 1) % interval == 0]
        if due:
            raise NotImplementedError(
                f"TRAIN.VAL_INTERVALS={interval} asks for validation after "
                f"epoch {due[0]}, and validation inside the Trainer is not "
                "ported yet; set TRAIN.VAL_INTERVALS to 0 (or past "
                "TRAIN.EPOCHS) to train without it")

    def _guard_nonfinite(self, total: float, epoch: int, step: int):
        """Raise after ``TRAIN.NONFINITE_TOLERANCE`` consecutive non-finite
        losses (the reference's guarded logger, logger.py:463-485)."""
        if self._nonfinite is None:
            return
        if np.isfinite(total):
            self._nonfinite.ok()
            return
        self.logger.warning("non-finite total loss (%s) at epoch %d step %d",
                            total, epoch, step)
        if self._nonfinite.fail():
            raise RuntimeError(
                f"total loss non-finite for {self._nonfinite.tolerance} "
                "consecutive steps - training diverged; restart with a "
                "lower LR")
