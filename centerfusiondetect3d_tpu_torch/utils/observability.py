"""Observability: run logging, timers, meters, a tolerance counter, the
device-memory guard, the forward's cost, loss plots and the device profile.

The port of ``centerfusiondetect3d_tpu/utils/observability.py`` (reference
``src/lib/utils/utils.py:20-339``, ``logger.py:369-485``,
``trainer.py:100-124``):

- ``create_logger``: the run directory ``<root>/<name>/<timestamp>`` and a
  logger to the console and its ``train.log``;
- ``AverageMeter``, ``StageTimer`` (on a CUDA device ``stop`` first waits
  for the calling thread's current stream, so a stage's time covers its
  device work and not other threads' streams, such as the Loader's decodes
  and ``device_prefetch``'s copies), ``ToleranceCounter``;
- ``DeviceHealthMonitor``: the card's memory in use over its size, which
  raises after ``tolerance`` consecutive readings over the limit (JAX reads
  ``bytes_in_use / bytes_limit``); a no-op on the CPU;
- ``estimate_cost``: flops and bytes of one eval-mode forward, counted from
  the shapes of its convolutions, linear layers and DCN contractions
  (``thop.profile``'s role, ``trainer.py:112-117``);
- ``plot_lr_schedule`` and ``plot_history`` (matplotlib, imported when
  called; without it they plot nothing);
- ``trace_profile`` wraps ``torch.profiler`` (imported when it is entered)
  and ``device_time_report`` reads the card's kernels out of a profile,
  for ``tools/profile_serving.py`` and ``tools/profile_training.py``;
  ``time_device`` times a call by its device time alone, for
  ``chip_smoke.py`` and ``tools/compare_kernels.py``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch


DEVICE_LAUNCHES = 200  # calls per event pair of a device time alone


def create_logger(output_root: str, name: str):
    """(logger, run directory ``<output_root>/<name>/<timestamp>``): a
    logger to the console and to ``train.log`` there."""
    out_dir = os.path.join(output_root, name, time.strftime("%Y-%m-%d-%H-%M"))
    os.makedirs(out_dir, exist_ok=True)
    logger = logging.getLogger(f"cfd3d.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False  # root handlers would print twice
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for handler in (logging.StreamHandler(),
                    logging.FileHandler(os.path.join(out_dir, "train.log"))):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger, out_dir


def time_device(fn, n: int = DEVICE_LAUNCHES) -> float:
    """ms of device time per call of fn on the current CUDA stream: one
    event pair around n calls, enqueued behind a sleep of the stream long
    enough to cover the host's enqueue of all n, so that the calls run back
    to back and the pair brackets device time, not host time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # >= 2 x at <= 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class StageTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self._start: Dict[str, float] = {}

    def start(self, stage: str):
        self._start[stage] = time.perf_counter()

    def stop(self, stage: str) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - self._start.pop(stage)
        self.meters[stage].update(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def report(self) -> str:
        return " | ".join(f"{k} {m.avg * 1e3:.1f}ms"
                          for k, m in self.meters.items())

    def reset(self):
        self.meters.clear()
        self._start.clear()


class ToleranceCounter:
    """N consecutive failures trip the guard (logger.py:463-485)."""

    def __init__(self, tolerance: int = 5):
        self.tolerance = tolerance
        self.count = 0

    def ok(self):
        self.count = 0

    def fail(self) -> bool:
        self.count += 1
        return self.count >= self.tolerance


class DeviceHealthMonitor:
    """The card's memory guard with tolerance semantics (the reference's
    GPU guard, logger.py:369-418): ``check`` reads
    ``torch.cuda.memory_allocated(device)`` over the card's
    ``total_memory``, warns above ``hbm_fraction_limit`` and raises after
    ``tolerance`` consecutive readings above it; a reading below resets the
    count. On a device other than CUDA it does nothing."""

    def __init__(self, hbm_fraction_limit: float = 0.95, tolerance: int = 5,
                 logger: Optional[logging.Logger] = None, device="cpu"):
        self.limit = hbm_fraction_limit
        self.counter = ToleranceCounter(tolerance)
        self.logger = logger or logging.getLogger("cfd3d.health")
        self.device = torch.device(device)

    def check(self):
        if self.device.type != "cuda":
            return
        used = torch.cuda.memory_allocated(self.device)
        total = torch.cuda.get_device_properties(self.device).total_memory
        frac = used / total
        if frac > self.limit:
            self.logger.warning("device memory high: %.1f%% of %.2f GiB",
                                frac * 100, total / 2 ** 30)
            if self.counter.fail():
                raise RuntimeError(
                    f"device memory above {self.limit:.0%} for "
                    f"{self.counter.tolerance} consecutive checks - "
                    "suspending")
        else:
            self.counter.ok()


def estimate_cost(model: torch.nn.Module, *inputs) -> Dict[str, float]:
    """``{"flops", "bytes_accessed"}`` of one eval-mode forward of
    ``model`` on ``inputs`` (run under ``torch.inference_mode``; the model's
    mode is restored).

    Counted by forward hooks from the shapes each op meets, and only for
    the ops that carry the work: every convolution and transposed
    convolution, every linear layer, and the DCN contraction of each
    ``DeformConvNode`` (9 * C * O multiply-adds per output pixel; its
    offset convolution is a convolution). Flops are 2 x multiply-adds
    (bias adds and the DCN's bilinear sampling not counted); bytes are each
    counted op's input, weight, bias and output read or written once, in
    the dtype the op computes in (a ``compute_dtype`` model's bf16), and
    the DCN's float32 offsets and mask. XLA's ``cost_analysis`` (the JAX
    package's figure) counts every HLO op of the fused program instead:
    BatchNorm, activations, casts and the sampling add flops there, and
    fusion removes the bytes of intermediates that never reach memory, so
    the two differ by design (``PERF.md`` states the ratio)."""
    from ..models.layers import DeformConvNode

    totals = {"flops": 0, "bytes_accessed": 0}

    def add(macs: int, nbytes: int):
        totals["flops"] += 2 * int(macs)
        totals["bytes_accessed"] += int(nbytes)

    def params(m):
        return sum(p.numel() for p in (m.weight, m.bias) if p is not None)

    def hook(m, args, out):
        x = args[0]
        size = out.element_size()
        if isinstance(m, DeformConvNode):
            b, c, h, w = x.shape
            o = m.weight.shape[0]
            offsets = b * 27 * h * w  # 18 offsets and 9 mask values a pixel
            wide = torch.promote_types(out.dtype, torch.float32)
            add(b * h * w * 9 * c * o,
                (x.numel() + params(m) + out.numel()) * size
                + offsets * wide.itemsize)
            return
        if isinstance(m, torch.nn.Conv2d):
            macs = out.numel() * m.weight[0].numel()
        elif isinstance(m, torch.nn.ConvTranspose2d):
            macs = x.numel() * m.weight[0].numel()
        else:  # torch.nn.Linear
            macs = x.numel() * m.out_features
        add(macs, (x.numel() + params(m) + out.numel()) * size)

    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear,
             DeformConvNode)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, kinds)]
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        model.train(was_training)
        for handle in handles:
            handle.remove()
    return {k: float(v) for k, v in totals.items()}


def plot_lr_schedule(config, out_path: str, start_epoch: int = 0):
    """[(epoch, learning rate)] over ``TRAIN.EPOCHS``; plotted to
    ``out_path`` where matplotlib is installed (the reference's
    learningRateTest, modelWithLoss.py:364-432)."""
    from ..training.schedule import learning_rate

    epochs = list(range(start_epoch, config.TRAIN.EPOCHS))
    lrs = [learning_rate(config, e, start_epoch) for e in epochs]
    plt = _pyplot()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(epochs, lrs)
        ax.set_yscale("log")
        ax.set_xlabel("epoch")
        ax.set_ylabel("lr")
        ax.set_title(f"{config.TRAIN.LR_SCHEDULER} schedule")
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
    return list(zip(epochs, lrs))


def plot_history(history: Dict[str, Dict[str, list]], out_dir: str):
    """Loss curves per head for train and val into ``out_dir/losses.png``,
    the history into ``out_dir/history.json`` (utils/utils.py:235-322);
    returns the plot's path, or None where matplotlib is missing or there
    is nothing to plot (then neither file is written, as in JAX)."""
    plt = _pyplot()
    if plt is None:
        return None
    heads = sorted({k for split in history.values() for k in split})
    if not heads:
        return None
    n = len(heads)
    cols = min(4, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for i, head in enumerate(heads):
        ax = axes[i // cols][i % cols]
        for split, losses in history.items():
            if head in losses:
                ax.plot(losses[head], label=split)
        ax.set_title(head)
        ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "losses.png")
    fig.savefig(path)
    plt.close(fig)
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f)
    return path


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


@contextlib.contextmanager
def trace_profile(out_dir: Optional[str], device):
    """Profile the enclosed block with ``torch.profiler``: host operators,
    and the card's kernels when ``device`` is a CUDA device. Yields the
    profiler (its ``events()`` are complete after the block); when
    ``out_dir`` is given, writes a Chrome trace to
    ``out_dir/profile/trace.json`` (the JAX package's ``trace_profile``
    writes its device trace under ``out_dir/profile``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if out_dir:
        path = os.path.join(out_dir, "profile")
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time the device
    ran at least one kernel."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_time_report(prof, runs: int, wall_us: float,
                       groups: Sequence[Tuple[str, Sequence[str]]],
                       rest: str, top: int) -> Optional[List[str]]:
    """The card's share of a profiled window of ``runs`` runs that took
    ``wall_us`` on the host clock: per run, device busy time (the union of
    its kernels' intervals), idle share, kernel count, device time by group
    (a kernel joins the first group one of whose keys its lower-cased name
    contains, else ``rest``) and the ``top`` kernels by device time. None
    when the profile holds no CUDA kernel."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    lines = [f"device busy {busy_us / 1e3 / runs:.2f} ms per run, idle share "
             f"{1 - busy_us / wall_us:.3f} of the profiled wall time, "
             f"{len(kernels) / runs:.0f} kernels per run"]
    by_group = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        low = e.name.lower()
        group = next((g for g, keys in groups if any(k in low for k in keys)),
                     rest)
        by_group[group] += dur
        by_name[e.name] += dur
        count[e.name] += 1
    total = sum(by_group.values())
    for group, us in by_group.most_common():
        lines.append(f"  {group}: {us / 1e3 / runs:.2f} ms per run "
                     f"({us / total:.1%} of kernel time)")
    lines.append(f"top {top} kernels by device time (ms per run, launches "
                 "per run):")
    for name, us in by_name.most_common(top):
        lines.append(f"  {us / 1e3 / runs:8.3f}  {count[name] / runs:5.0f}  "
                     f"{name[:110]}")
    return lines
