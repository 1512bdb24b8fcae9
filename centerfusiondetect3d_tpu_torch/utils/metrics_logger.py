"""Structured run-metrics logging: JSONL events and a run-state file.

The port of ``centerfusiondetect3d_tpu/utils/metrics_logger.py`` (reference
``src/lib/utils/logger.py:35-485``, which logs to wandb): a run appends
events (per-epoch or per-step scalars, alerts) to ``metrics.jsonl`` that
any dashboard can tail, and keeps ``run_state.json`` (its ``run_id``, its
start time and its last ``summary``). With ``resume`` the persisted
``run_id`` is kept.

Where the ``wandb`` package is importable and ``WANDB_PROJECT`` is set,
the events of rank 0 (``torch.distributed.get_rank()`` where a process
group is initialised) are also sent to a wandb run resumed by that id, as
the reference's ``initWandb`` does (logger.py:421-460); without either the
mirror is a no-op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    def __init__(self, output_dir: str, run_id: Optional[str] = None,
                 resume: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.state_path = os.path.join(output_dir, "run_state.json")
        if resume and os.path.exists(self.state_path):
            with open(self.state_path) as f:
                self.run_id = json.load(f).get("run_id", run_id)
        else:
            self.run_id = run_id or time.strftime("%Y%m%d-%H%M%S")
        self._write_state({"run_id": self.run_id, "started": time.time()})
        self._wandb = self._init_wandb()

    def _init_wandb(self):
        """The wandb mirror: needs the package AND an explicit
        ``WANDB_PROJECT`` (an ambient ``WANDB_API_KEY`` alone must not start
        runs); rank 0 only, so that ranks do not interleave one run."""
        if not os.environ.get("WANDB_PROJECT"):
            return None
        if _rank() != 0:
            return None
        try:
            import wandb
        except ImportError:
            return None
        try:
            return wandb.init(project=os.environ["WANDB_PROJECT"],
                              id=self.run_id, resume="allow")
        except Exception:  # the mirror is best-effort, as in JAX
            return None

    def _write_state(self, extra: Dict[str, Any]):
        state = {}
        if os.path.exists(self.state_path):
            try:
                with open(self.state_path) as f:
                    state = json.load(f)
            except (OSError, ValueError):
                state = {}
        state.update(extra)
        # a name of this process's own: another process may write beside it
        tmp = f"{self.state_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.state_path)

    def log(self, kind: str, payload: Dict[str, Any],
            step: Optional[int] = None):
        event = {"ts": time.time(), "run_id": self.run_id, "kind": kind}
        if step is not None:
            event["step"] = step
        event.update(payload)
        with open(self.path, "a") as f:
            f.write(json.dumps(_jsonable(event)) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log(
                    {k: v for k, v in _jsonable(payload).items()
                     if isinstance(v, (int, float))},
                    step=step,
                )
            except Exception:
                pass  # the mirror is best-effort

    def scalars(self, scalars: Dict[str, float], step: Optional[int] = None,
                prefix: str = ""):
        self.log("scalars", {prefix + k: float(v) for k, v in scalars.items()},
                 step)

    def alert(self, message: str, level: str = "warning"):
        self.log("alert", {"level": level, "message": message})

    def summary(self, summary: Dict[str, Any]):
        self._write_state({"summary": _jsonable(summary)})
        if self._wandb is not None:
            try:
                self._wandb.summary.update(_jsonable(summary))
            except Exception:
                pass


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and getattr(x, "size", 2) == 1:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x
