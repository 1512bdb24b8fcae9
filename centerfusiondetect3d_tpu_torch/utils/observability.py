"""Per-stage wall timing with device synchronisation, meters, a tolerance
counter.

The port of ``AverageMeter``, ``StageTimer`` and ``ToleranceCounter`` from
``centerfusiondetect3d_tpu/utils/observability.py`` (reference
``src/lib/utils/utils.py:52-66,324-339`` and ``logger.py:463-485``). PyTorch returns before the card
finishes, so on a CUDA device ``stop`` first waits for the device with
``torch.cuda.synchronize`` and a stage's time covers its device work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import torch


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
