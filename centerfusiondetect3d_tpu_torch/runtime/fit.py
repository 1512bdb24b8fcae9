"""The training loop and validation: the reference Trainer on one CUDA card.

The port of ``centerfusiondetect3d_tpu/runtime/fit.py:Trainer`` (reference
``src/lib/trainer.py:20-127`` and its Lightning callbacks), single process:
per epoch the frozen-or-not decision of
``MODEL.FREEZE_BACKBONE`` / ``MODEL.DEFREEZE``, the epoch's learning rate in
every parameter group, one ``train_step`` per batch, running-average
meters, a step timer that waits for the device, ``history["train"]``, the
non-finite-loss guard of ``TRAIN.NONFINITE_TOLERANCE``, and checkpoints:
``MODEL.LOAD_DIR`` (a reference ``.pt`` file) is loaded by ``init_state``,
with its epoch and optimizer state under ``TRAIN.RESUME``, and
``training/checkpoint.py:save_checkpoint`` writes ``OUTPUT_DIR/ckpts`` at
every ``TRAIN.SAVE_INTERVALS`` epoch and at the last one. At every
``TRAIN.VAL_INTERVALS`` epoch it writes a crash-guard checkpoint, then
validates (``val``): an eval-mode forward over ``dataset_val`` (the last,
partial batch included), ``fusion_decode`` and ``post_process`` with each
image's inverse affine from its ``meta``, the loss meters, per-image
results, then ``dataset_val.run_eval`` (the submission JSON and NDS
scoring, ``data/nuscenes_eval.py``) and ``log_valid_result``; under
``TEST.FLIP_TEST`` the forward runs on each batch and its mirror. Scoring is
best-effort as in the JAX package: an exception there is logged, not
raised. ``test`` is ``val``.

The model computes in the precision the config asks for
(``MIXED_PRECISION``, true in every shipped config: a bf16 model with float32
parameters, optimizer state and BatchNorm statistics, as the JAX package
trains), in training and in validation, and checkpoints hold float32
tensors either way. A run that reaches a ``TRAIN.VAL_INTERVALS`` epoch
without a ``dataset_val`` raises before its first step.

One documented difference from the JAX package: under ``TRAIN.RESUME`` a
``.pt`` checkpoint restores the optimizer state too (``init_state``); the
JAX package resumes a ``.pt`` with a fresh optimizer and only the epoch, as
the reference's ``loadModel`` does. The port's ``.pt`` is its only
checkpoint format, and it carries the optimizer.

The host side of a run is the JAX package's: the train ``Loader`` builds
items in ``WORKERS`` threads behind its prefetch queue (``TRAIN.SHUFFLE``
off still augments, with a warning), ``data/pipeline.py:device_prefetch``
moves ``TPU.PREFETCH`` batches ahead of the step (a side stream on the
card), ``TPU.PROFILE`` traces the first epoch into
``OUTPUT_DIR/profile`` (``trace_profile``), ``DeviceHealthMonitor``
checks the card's memory after every step, a progress line is logged ten
times an epoch, ``MetricsLogger`` writes ``OUTPUT_DIR/metrics.jsonl``
(``train/*``, ``lr`` and ``epoch_sec`` per epoch; ``val/*``, ``val/mAP``,
``val/NDS``) and ``run_state.json`` (its summary), and ``plot_history``
ends the run. The first validation logs the forward's cost per batch
(``profile``: ``utils/observability.py:estimate_cost`` on the validation
loader's first batch, ``peek``).

A second documented difference: ``WORKERS 0`` builds the items on the
training thread with no prefetch thread (the reference DataLoader's
``num_workers=0``), where the JAX package runs one thread and a prefetch
thread for 0 and 1. No batch changes, only speed: the eager step needs the
interpreter lock for each of its launches, so on a host-bound step the
Loader's threads slow it more than they save (``PERF.md`` §5, §7).

Not ported yet (ROADMAP.md, Queue 1): the ``DEBUG`` visualizer and
multi-process training and validation; the training profile by kernel is
``tools/profile_training.py``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.nuscenes_eval import detections_to_results
from ..data.pipeline import Loader, device_prefetch, to_device
from ..geometry.affine import stack_inverse_transforms
from ..losses import GenericLoss
from ..models import build_model
from ..ops.decode import fusion_decode
from ..ops.postprocess import post_process
from ..ops.tta import flip_forward
from ..training import learning_rate, make_optimizer, train_step
from ..training.checkpoint import load_torch_file, load_weights, save_checkpoint
from ..utils.device import resolve_device
from ..utils.metrics_logger import MetricsLogger
from ..utils.observability import (
    AverageMeter,
    DeviceHealthMonitor,
    StageTimer,
    ToleranceCounter,
    estimate_cost,
    plot_history,
    trace_profile,
)
from .synthetic import seeded_weights


def loader_threads(workers) -> Dict[str, int]:
    """The ``Loader``'s ``num_threads`` and ``prefetch`` for ``WORKERS``:
    the JAX package's for 1 and more; 0 builds on the calling thread with
    no prefetch thread."""
    workers = int(workers)
    return {"num_threads": max(1, workers), "prefetch": 2 if workers else 0}


class Trainer:
    """Builds the model and loss of ``config`` on ``device`` (the CUDA card
    unless the caller names another), trains it on ``dataset_train`` and
    validates it on ``dataset_val`` (any objects with ``__len__`` and
    ``get_item(index, rng)``; ``dataset_val`` scores through its
    ``run_eval`` and ``log_valid_result`` where it has them).

    ``on_step(epoch, step, frozen, metrics)``, when given, is called after
    every step with the step's metrics as floats. The model follows
    ``MIXED_PRECISION`` through ``build_model(config)``: bf16 compute over
    float32 parameters when it is true.
    """

    def __init__(self, config, dataset_train=None, dataset_val=None,
                 device=None, logger: Optional[logging.Logger] = None,
                 on_step: Optional[Callable] = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(config).to(self.device)
        self.loss_fn = GenericLoss(config)
        self.dataset_train = dataset_train
        self.dataset_val = dataset_val
        self.summaries: Optional[Dict] = None  # the last val's NDS summaries
        self.val_seconds: List[dict] = []  # per val: forward, scoring
        self.logger = logger or logging.getLogger("cfd3d.trainer")
        self.on_step = on_step
        self.history: Dict[str, Dict[str, list]] = {"train": {}, "val": {}}
        self.steps: List[dict] = []  # per step: epoch, frozen, seconds, total
        self.start_epoch = 0
        self.optimizer = None
        self.timer = StageTimer(self.device)
        self.health = DeviceHealthMonitor(logger=self.logger,
                                          device=self.device)
        self._metrics: Optional[MetricsLogger] = None
        self._cost_reported = False
        tol = int(config.TRAIN.get("NONFINITE_TOLERANCE", 5))
        self._nonfinite = ToleranceCounter(tol) if tol > 0 else None

    @property
    def metrics(self) -> MetricsLogger:
        """The run's ``MetricsLogger`` in ``OUTPUT_DIR``, made by the first
        ``train`` or ``val`` (a Trainer that only loads or saves weights
        writes no run files)."""
        if self._metrics is None:
            self._metrics = MetricsLogger(
                self.config.OUTPUT_DIR, resume=bool(self.config.TRAIN.RESUME))
        return self._metrics

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
        self._refuse_validation_without_data()
        loader = Loader(self.dataset_train, cfg.TRAIN.BATCH_SIZE,
                        shuffle=cfg.TRAIN.SHUFFLE, seed=cfg.RANDOM_SEED,
                        augment=True, **loader_threads(cfg.WORKERS))
        if not cfg.TRAIN.SHUFFLE:
            self.logger.warning("TRAIN.SHUFFLE is off: data order is "
                                "sequential but augmentation remains active")
        accum = int(cfg.TRAIN.get("GRAD_ACCUM", 1))
        for epoch in range(self.start_epoch, cfg.TRAIN.EPOCHS):
            frozen = (bool(cfg.MODEL.FREEZE_BACKBONE)
                      and epoch <= cfg.MODEL.DEFREEZE)
            lr = learning_rate(cfg, epoch, self.start_epoch)
            meters = defaultdict(AverageMeter)
            self.timer.reset()
            t_epoch = time.time()
            loader.epoch = epoch
            n_batches = len(loader)
            log_every = max(1, n_batches // 10)
            profiling = bool(cfg.TPU.PROFILE) and epoch == self.start_epoch
            profile = (trace_profile(cfg.OUTPUT_DIR, self.device)
                       if profiling else contextlib.nullcontext())
            batches = device_prefetch(loader, self.device,
                                      size=int(cfg.TPU.PREFETCH))
            # closing: a step that raises releases the Loader's threads
            with profile, contextlib.closing(batches):
                for i, batch in enumerate(batches):
                    self.timer.start("step")
                    metrics = train_step(self.model, self.optimizer,
                                         self.loss_fn, batch, lr, frozen,
                                         accum)
                    seconds = self.timer.stop("step")
                    metrics = {k: float(v) for k, v in metrics.items()}
                    for k, v in metrics.items():
                        meters[k].update(v)
                    self.steps.append({"epoch": epoch, "frozen": frozen,
                                       "seconds": seconds,
                                       "total": metrics["total"]})
                    self._guard_nonfinite(metrics["total"], epoch, i)
                    self.health.check()
                    if self.on_step is not None:
                        self.on_step(epoch, i, frozen, metrics)
                    if (i + 1) % log_every == 0 or i + 1 == n_batches:
                        # per-batch progress line (progressBar.py:25-57)
                        self.logger.info(
                            "epoch %d [%d/%d] total %.4f (%.0f ms/step)",
                            epoch, i + 1, n_batches, meters["total"].avg,
                            self.timer.meters["step"].avg * 1e3)
            self.logger.info(
                "epoch %d lr %.2e frozen %s (%.1fs, %.0f ms/step) %s", epoch,
                lr, frozen, time.time() - t_epoch,
                1e3 * self.timer.meters["step"].avg,
                " ".join(f"{k} {m.avg:.4f}" for k, m in sorted(meters.items())))
            for k, m in meters.items():
                self.history["train"].setdefault(k, []).append(m.avg)
            self.metrics.scalars({k: m.avg for k, m in meters.items()},
                                 step=epoch, prefix="train/")
            self.metrics.scalars({"lr": lr,
                                  "epoch_sec": time.time() - t_epoch},
                                 step=epoch)
            interval = int(cfg.TRAIN.SAVE_INTERVALS)
            if ((interval > 0 and (epoch + 1) % interval == 0)
                    or epoch + 1 == cfg.TRAIN.EPOCHS):
                self._save(epoch)
            if self._validates(epoch):
                # crash guard: persist before validation
                # (modelWithLoss.py:329-341)
                self._save(epoch)
                self.val()
        plot_history(self.history, cfg.OUTPUT_DIR)
        return self.history

    def _save(self, epoch: int) -> str:
        path = save_checkpoint(os.path.join(self.config.OUTPUT_DIR, "ckpts"),
                               self.model, self.optimizer, epoch,
                               self.history)
        self.logger.info("saved %s", path)
        return path

    def _validates(self, epoch: int) -> bool:
        interval = int(self.config.TRAIN.VAL_INTERVALS)
        return interval > 0 and (epoch + 1) % interval == 0

    def _refuse_validation_without_data(self):
        """A run whose epochs reach a ``TRAIN.VAL_INTERVALS`` epoch needs
        ``dataset_val``: without one it raises before its first step rather
        than fail after training."""
        if self.dataset_val is not None:
            return
        due = [e for e in range(self.start_epoch,
                                int(self.config.TRAIN.EPOCHS))
               if self._validates(e)]
        if due:
            raise ValueError(
                f"TRAIN.VAL_INTERVALS={self.config.TRAIN.VAL_INTERVALS} asks "
                f"for validation after epoch {due[0]}, and the Trainer has "
                "no dataset_val; pass one, or set TRAIN.VAL_INTERVALS to 0 "
                "(or past TRAIN.EPOCHS) to train without it")

    # ------------------------------------------------------------- eval
    def _eval_step(self, batch, trans_mat):
        """Eval-mode forward (on the batch and its mirror under
        ``TEST.FLIP_TEST``, ``ops/tta.py:flip_forward``, as the JAX
        package's eval step), decode, post-process and loss of one device
        batch; returns (processed detections, loss, loss parts)."""
        cfg = self.config
        forward = flip_forward if cfg.TEST.FLIP_TEST else (
            lambda model, *args: model(*args))
        outputs = [forward(self.model, batch["image"], batch.get("pc_dep"),
                           batch.get("calib"), batch.get("pc_hm"))]
        dets = fusion_decode(outputs, cfg.MODEL.OUTPUT_SIZE, k=cfg.MODEL.K,
                             norm2d=cfg.MODEL.NORM_2D)
        processed = post_process(dets, trans_mat, cfg.MODEL.OUTPUT_SIZE,
                                 batch["calib"])
        loss, parts = self.loss_fn(outputs, batch, train=False)
        return processed, loss, parts

    def val(self, loader: Optional[Loader] = None) -> Dict[int, list]:
        """Validation and NDS scoring, single process (the JAX package's
        ``Trainer.val`` without its multi-process sharding and ``DEBUG``
        visualizer). The first call logs the forward's cost per batch.
        Returns the per-image results; the scoring summaries land in
        ``summaries``, ``metrics`` gets ``val/*`` and its summary."""
        cfg = self.config
        if loader is None:
            if self.dataset_val is None:
                raise ValueError("Trainer.val needs a dataset_val or a loader")
            loader = Loader(self.dataset_val, cfg.TEST.BATCH_SIZE,
                            shuffle=False, drop_last=False, drop_keys=(),
                            **loader_threads(cfg.WORKERS))
        if self.optimizer is None:
            self.init_state()
        if not self._cost_reported:
            self._cost_reported = True
            self._report_cost(loader)
        t0 = time.perf_counter()
        results: Dict[int, list] = {}
        seen = 0
        meters = defaultdict(AverageMeter)
        oh, ow = cfg.MODEL.OUTPUT_SIZE
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in loader:
                    meta = batch.pop("meta", None)
                    nimg = batch["image"].shape[0]
                    if meta is not None:
                        centers = np.asarray(meta["center"], np.float32)
                        scales = np.asarray(meta["scale"], np.float32)
                    else:
                        h, w = self.dataset_val.default_resolution
                        centers = np.tile(np.array([w / 2, h / 2], np.float32),
                                          (nimg, 1))
                        scales = np.full((nimg,), max(h, w), np.float32)
                    # per-image inverse matrices (postProcess.py:31-43)
                    trans_mat = torch.from_numpy(stack_inverse_transforms(
                        centers, scales, (ow, oh))).to(self.device)
                    processed, loss, parts = self._eval_step(
                        to_device(batch, self.device), trans_mat)
                    meters["total"].update(float(loss))
                    for k, v in parts.items():
                        meters[k].update(float(v))
                    if meta is not None:
                        img_ids = np.asarray(meta["img_id"]).tolist()
                    else:
                        idxs = list(range(seen, seen + nimg))
                        ids = getattr(self.dataset_val, "images", None)
                        img_ids = ([ids[j] for j in idxs] if ids is not None
                                   else idxs)
                    seen += nimg
                    results.update(detections_to_results(
                        {k: v.cpu().numpy() for k, v in processed.items()},
                        img_ids))
        finally:
            self.model.train()
        t1 = time.perf_counter()
        for k, m in meters.items():
            self.history["val"].setdefault(k, []).append(m.avg)
        self.logger.info("val %s", " ".join(
            f"{k} {m.avg:.4f}" for k, m in sorted(meters.items())))
        self.metrics.scalars({k: m.avg for k, m in meters.items()},
                             prefix="val/")
        if self.dataset_val is not None and hasattr(self.dataset_val,
                                                    "run_eval"):
            try:
                _, summaries = self.dataset_val.run_eval(results,
                                                         cfg.OUTPUT_DIR)
                if summaries:
                    self.summaries = summaries
                    self.dataset_val.log_valid_result(self.logger, summaries)
                    best = summaries.get("range_all", {})
                    self.metrics.scalars(
                        {"mAP": best.get("mean_ap", 0.0),
                         "NDS": best.get("nd_score", 0.0)}, prefix="val/")
                    self.metrics.summary({"range_all": best})
            except Exception as e:  # scoring is best-effort, as in JAX
                self.logger.warning("run_eval failed: %s", e)
        self.val_seconds.append({"forward": t1 - t0,
                                 "scoring": time.perf_counter() - t1})
        return results

    def test(self, loader: Optional[Loader] = None) -> Dict[int, list]:
        return self.val(loader)

    def _report_cost(self, loader):
        """The one-time FLOPs report (thop's, trainer.py:112-117) on the
        loader's first batch; best-effort, as in JAX."""
        try:
            first = (loader.peek() if hasattr(loader, "peek")
                     else next(iter(loader)))
            cost = self.profile(first)
        except Exception:  # the report must not stop a validation
            self.logger.warning("model cost report failed", exc_info=True)
            return
        self.logger.info(
            "model cost: %.2f GFLOPs, %.2f GiB accessed (per batch)",
            cost["flops"] / 1e9, cost["bytes_accessed"] / 2 ** 30)

    def profile(self, sample_batch) -> Dict[str, float]:
        """Flops and bytes of one eval-mode forward on the numpy batch
        ``sample_batch`` (``utils/observability.py:estimate_cost``; the JAX
        package's ``Trainer.profile`` asks XLA's cost analysis)."""
        batch = to_device({k: sample_batch[k] for k in
                           ("image", "pc_dep", "calib", "pc_hm")
                           if k in sample_batch}, self.device)
        return estimate_cost(self.model, batch["image"], batch.get("pc_dep"),
                             batch.get("calib"), batch.get("pc_hm"))

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
