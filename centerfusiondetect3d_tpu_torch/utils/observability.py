"""Per-stage wall timing with device synchronisation, meters, a tolerance
counter, and the device profile.

The port of ``AverageMeter``, ``StageTimer``, ``ToleranceCounter`` and
``trace_profile`` from ``centerfusiondetect3d_tpu/utils/observability.py``
(reference ``src/lib/utils/utils.py:52-66,324-339`` and
``logger.py:463-485``). PyTorch returns before the card finishes, so on a
CUDA device ``stop`` first waits for the device with
``torch.cuda.synchronize`` and a stage's time covers its device work.
``trace_profile`` wraps ``torch.profiler`` (imported when it is entered) and
``device_time_report`` reads the card's kernels out of a profile, for
``tools/profile_serving.py`` and ``tools/profile_training.py``;
``time_device`` times a call by its device time alone, for ``chip_smoke.py``
and ``tools/compare_kernels.py``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch


DEVICE_LAUNCHES = 200  # calls per event pair of a device time alone


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
            torch.cuda.synchronize(self.device)
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
