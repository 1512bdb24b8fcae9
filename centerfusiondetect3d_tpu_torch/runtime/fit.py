"""The training loop and validation: the reference Trainer on CUDA cards.

The port of ``centerfusiondetect3d_tpu/runtime/fit.py:Trainer`` (reference
``src/lib/trainer.py:20-127`` and its Lightning callbacks): per epoch the
frozen-or-not decision of
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

With ``DEBUG > 0`` each validation renders its first image as the JAX
package's does (``utils/visualize.py:ValVisualizer``): the ground truth, the
predictions, the radar heatmaps and the bird's-eye view, written once per
validation as ``OUTPUT_DIR/viz/e####_*.png``.

Under a process group (``parallel.initialize``; ``main.py`` under
``torch.distributed.run``) each rank trains on its strided shard of the
identically shuffled index stream (``Loader(shard=(rank, world))``) on its
own device, through one ``DistributedDataParallel`` wrapper a frozen phase
(``training/state.py:wrap_data_parallel``); with more than one rank the
BatchNorm statistics and the loss normalisers are the global batch's, so a
step is the JAX package's step on the global batch (``fit.py:162-230``
there) and every rank logs the global loss. ``TPU.MESH_DATA``,
``MESH_SPATIAL`` and ``MESH_MODEL`` lay the ranks out (``parallel/mesh.py``;
their product is the world size). With a spatial or model axis wider than
1 each data group loads one Loader shard (``shard=(data_rank, n_data)``),
its ranks take their rows through ``shard_batch``, the step runs under the
layout without a DDP wrapper and applies the gradient of
``parallel/mesh.py:reduce_gradients``; the parameters stay replicated, as
the JAX Trainer replicates them (``shard_params_tp`` is the dry run's,
``tools/dryrun_multichip.py``). Validation shards the split over the data
axis into padded equal shards (``pad_to_batch``), runs each on its ranks'
devices (under the layout: with its collectives inside the forward), and
merges the fixed-size detections and their image ids with one all-gather a
batch over the data group, so every rank returns the whole results dict
(``fit.py:313-508`` there). Checkpoints,
``metrics.jsonl``, scoring and the loss plots are rank 0's alone;
``ValVisualizer`` and the FLOPs report run only in a single process, as in
JAX; ``DeviceHealthMonitor`` checks each rank's card. The training
profile by kernel is ``tools/profile_training.py``.
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
from ..parallel import distributed as parallel
from ..parallel.mesh import (DATA_AXIS, gather_detections, layout,
                             make_mesh, shard_batch)
from ..training import (learning_rate, make_optimizer, train_step,
                        wrap_data_parallel)
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
        if torch.distributed.is_initialized():
            self.device = parallel.local_device(self.device)
        self.mesh = make_mesh(config.TPU.MESH_DATA, config.TPU.MESH_MODEL,
                              config.TPU.MESH_SPATIAL, self.device)
        self.model = build_model(config).to(self.device)
        self._ddp = None  # the current phase's DistributedDataParallel
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
            self._metrics = (MetricsLogger(
                self.config.OUTPUT_DIR, resume=bool(self.config.TRAIN.RESUME))
                if parallel.is_main_process() else _NoMetrics())
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
        shard = self._data_shard()
        loader = Loader(self.dataset_train, cfg.TRAIN.BATCH_SIZE,
                        shuffle=cfg.TRAIN.SHUFFLE, seed=cfg.RANDOM_SEED,
                        augment=True, shard=shard,
                        **loader_threads(cfg.WORKERS))
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
                    mesh = self._layout()
                    if mesh is not None:
                        batch = shard_batch(batch, mesh)
                    metrics = train_step(self._step_model(frozen),
                                         self.optimizer, self.loss_fn, batch,
                                         lr, frozen, accum, mesh)
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
        if parallel.is_main_process():
            plot_history(self.history, cfg.OUTPUT_DIR)
        return self.history

    def _layout(self):
        """The mesh a step and a validation forward run under: None for
        one process or the data axis alone (DDP's arithmetic)."""
        return None if self.mesh.data_parallel_only else self.mesh

    def _data_shard(self):
        """(data rank, data ranks) of the Loader, or None for one."""
        if self.mesh.n_data == 1:
            return None
        return self.mesh.coords[DATA_AXIS], self.mesh.n_data

    def _step_model(self, frozen: bool):
        """The module a step runs: the model itself in a single process or
        under a layout, else its ``DistributedDataParallel`` wrapper for
        this phase (one a phase; the previous one is let go)."""
        if not torch.distributed.is_initialized() or self._layout():
            return self.model
        if self._ddp is None or self._ddp.frozen != frozen:
            self._ddp = None  # its reducer's hooks go before the next's
            self._ddp = wrap_data_parallel(self.model, frozen)
        return self._ddp

    def _save(self, epoch: int) -> Optional[str]:
        """Rank 0 writes the checkpoint (the unwrapped model's reference
        names); other ranks write nothing."""
        if not parallel.is_main_process():
            return None
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
        batch; returns (processed detections, loss, loss parts, the model's
        radar heatmap or None)."""
        cfg = self.config
        forward = flip_forward if cfg.TEST.FLIP_TEST else (
            lambda model, *args: model(*args))
        mesh = self._layout()
        maps = batch if mesh is None else shard_batch(batch, mesh)
        with layout(mesh):
            outputs = [forward(self.model, maps["image"], maps.get("pc_dep"),
                               maps.get("calib"), maps.get("pc_hm"))]
        dets = fusion_decode(outputs, cfg.MODEL.OUTPUT_SIZE, k=cfg.MODEL.K,
                             norm2d=cfg.MODEL.NORM_2D)
        processed = post_process(dets, trans_mat, cfg.MODEL.OUTPUT_SIZE,
                                 batch["calib"])
        loss, parts = self.loss_fn(outputs, batch, train=False)
        return processed, loss, parts, outputs[-1].get("pc_hm")

    def val(self, loader: Optional[Loader] = None) -> Dict[int, list]:
        """Validation and NDS scoring, with the ``DEBUG > 0`` renders of its
        first image. The first call logs the forward's cost per batch.

        With more than one rank each evaluates its padded shard of the
        split (equal batch counts and sizes everywhere) and one all-gather
        a batch merges the detections with their image ids; pad duplicates
        fold into the id-keyed results, and rank 0 alone scores. Loss
        meters stay each rank's own; renders and the cost report are a
        single process's.
        Returns the per-image results (every rank the whole split's); the
        scoring summaries land in ``summaries``, ``metrics`` gets ``val/*``
        and its summary."""
        cfg = self.config
        multi = self.mesh.n_data > 1  # the split is sharded over the data
        default_loader = loader is None
        if loader is None:
            if self.dataset_val is None:
                raise ValueError("Trainer.val needs a dataset_val or a loader")
            loader = Loader(self.dataset_val, cfg.TEST.BATCH_SIZE,
                            shuffle=False, drop_last=False, drop_keys=(),
                            shard=self._data_shard(),
                            pad_to_batch=multi,
                            **loader_threads(cfg.WORKERS))
        if self.optimizer is None:
            self.init_state()
        if not self._cost_reported and not parallel.is_multiprocess():
            self._cost_reported = True
            self._report_cost(loader)
        t0 = time.perf_counter()
        results: Dict[int, list] = {}
        seen = 0
        meters = defaultdict(AverageMeter)
        oh, ow = cfg.MODEL.OUTPUT_SIZE
        viz = None
        if (int(cfg.DEBUG) > 0 and self.dataset_val is not None
                and not parallel.is_multiprocess()):
            # first-val-image renders (WandbLogger, logger.py:78-171)
            from ..utils.visualize import ValVisualizer

            viz = ValVisualizer(cfg.OUTPUT_DIR, cfg, self.dataset_val)
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
                    processed, loss, parts, pred_pc_hm = self._eval_step(
                        to_device(batch, self.device), trans_mat)
                    meters["total"].update(float(loss))
                    for k, v in parts.items():
                        meters[k].update(float(v))
                    if meta is not None:
                        img_ids = np.asarray(meta["img_id"]).tolist()
                    else:
                        idxs = (self._shard_indices(seen, nimg)
                                if multi and default_loader
                                else list(range(seen, seen + nimg)))
                        ids = getattr(self.dataset_val, "images", None)
                        img_ids = ([ids[j] for j in idxs] if ids is not None
                                   else idxs)
                    seen += nimg
                    dets = {k: v.cpu().numpy() for k, v in processed.items()}
                    if multi:
                        # ids ride with the rows, so the two stay paired
                        dets["_img_ids"] = np.asarray(img_ids, np.int64)
                        dets = gather_detections(dets, self.mesh)
                        img_ids = dets.pop("_img_ids").tolist()
                    results.update(detections_to_results(dets, img_ids))
                    if viz is not None and viz.image is None and meta is not None:
                        _visualize_first(viz, cfg, batch, int(img_ids[0]),
                                         results, pred_pc_hm)
        finally:
            self.model.train()
        if viz is not None:
            viz.save(epoch=len(self.history["val"].get("total", [])))
        t1 = time.perf_counter()
        for k, m in meters.items():
            self.history["val"].setdefault(k, []).append(m.avg)
        self.logger.info("val %s", " ".join(
            f"{k} {m.avg:.4f}" for k, m in sorted(meters.items())))
        self.metrics.scalars({k: m.avg for k, m in meters.items()},
                             prefix="val/")
        if (self.dataset_val is not None
                and hasattr(self.dataset_val, "run_eval")
                and parallel.is_main_process()):
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

    def _shard_indices(self, seen: int, nimg: int) -> List[int]:
        """Dataset indices of this rank's positions ``seen`` .. ``seen +
        nimg`` in the default sharded loader's unshuffled, strided and
        padded index stream (``data/pipeline.py:Loader._indices``), the JAX
        package's formula (``fit.py:412-424``): a rank-local counter would
        repeat across ranks and collapse in the merge."""
        rank, world = self.mesh.coords[DATA_AXIS], self.mesh.n_data
        n = len(self.dataset_val)
        m = -(-n // world)  # the padded shard's length
        return [int((rank + world * ((seen + i) % m)) % n)
                for i in range(nimg)]

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


class _NoMetrics:
    """The metrics logger of a rank other than 0: it writes nothing."""

    def scalars(self, *args, **kwargs):
        pass

    log = alert = summary = scalars


def _visualize_first(viz, cfg, batch, img_id: int, results, pred_pc_hm):
    """Hand ``viz`` the first image of a validation batch (numpy, NHWC): its
    target radar map (``pc_hm``, else the raw depth over
    ``MAX_PC_DIST``), its radar points, its detections and the model's
    radar heatmap."""
    target_hm = batch.get("pc_hm")
    if target_hm is None and batch.get("pc_dep") is not None:
        target_hm = (np.asarray(batch["pc_dep"])[..., :1]
                     / float(cfg.DATASET.MAX_PC_DIST))
    radar_pc = (np.asarray(batch["pc_3d"][0]).T
                if batch.get("pc_3d") is not None else None)
    viz.add_ground_truth(img_id, None if target_hm is None
                         else np.asarray(target_hm[0]))
    viz.add_predictions(img_id, results.get(img_id, []),
                        pc_hm=(None if pred_pc_hm is None
                               else pred_pc_hm[0].float().cpu().numpy()),
                        radar_pc=radar_pc)
