"""Epoch-based learning-rate schedules.

The port's own copy of ``centerfusiondetect3d_tpu/training/schedule.py``, a
re-derivation of the reference's SequentialLR compositions
(``src/lib/model/modelWithLoss.py:57-203``):

- ``StepLR``: 2^(t-W) gradual warmup (Goyal et al.), multi-step 0.1 decay,
  and a defreeze-aware re-warmup that intentionally resets decay accumulated
  during the frozen phase.
- ``CLR``: triangular cyclic LR before the defreeze epoch, triangular2 after,
  with constant 0.1^k segments for LR steps past defreeze.

These are host-side scalar functions of the epoch; the Trainer writes the
result into every parameter group of the optimizer before each step.
"""

from __future__ import annotations

import numpy as np


def _clr_factor(t: float, mode: str, step_size: int = 5,
                base_ratio: float = 1.0 / 15.0) -> float:
    """CyclicLR factor relative to max_lr."""
    cycle = np.floor(1 + t / (2 * step_size))
    x = abs(t / step_size - 2 * cycle + 1)
    scale = 1.0 if mode == "triangular" else 1.0 / (2 ** (cycle - 1))
    return float(base_ratio + (1.0 - base_ratio) * max(0.0, 1.0 - x) * scale)


def learning_rate(config, epoch: int, start_epoch: int = 0) -> float:
    """LR for a given (global) epoch, replicating the reference schedules."""
    lr = float(config.TRAIN.LR)
    steps = tuple(config.TRAIN.LR_STEP)
    defreeze = int(config.MODEL.DEFREEZE)
    sched = config.TRAIN.LR_SCHEDULER

    # resume: fold LR steps already passed into the base LR (modelWithLoss:61-63)
    start_lr = lr
    for s in steps:
        if start_epoch >= s:
            start_lr *= 0.1
    e = epoch - start_epoch  # scheduler-local epoch

    if sched == "CLR":
        local_defreeze = max(defreeze - start_epoch, 0)
        # NOTE (torch-golden-verified): CyclicLR overwrites the optimizer's
        # initial_lr with base_lr = LR/15, so the later ConstantLR segments
        # compute from LR/15, not from the configured LR, and any resume
        # LR-step folding is discarded entirely.
        base = lr / 15.0
        past = [s for s in steps if s > defreeze]
        seg_start = None
        k = 0
        for i, s in enumerate(past):
            if epoch >= s:
                seg_start, k = s, i + 1
        if seg_start is not None:
            return base * (0.1 ** k)
        if e < local_defreeze:
            return lr * _clr_factor(e, "triangular")
        return lr * _clr_factor(e - local_defreeze, "triangular2")

    if sched == "StepLR":
        warm = int(config.TRAIN.WARM_EPOCHS)
        # segment 1: initial warmup
        if warm and e < warm:
            return start_lr * (0.5 ** (warm - e))
        # NOTE (torch-golden-verified): MultiStepLR fires a milestone only at
        # local epochs >= 1, so milestones folded away by a resume (local
        # position <= 0) never decay again - count 0 < m <= t only.
        if defreeze > start_epoch:
            local_defreeze = defreeze - start_epoch
            # segment 2: multi-step decay during the frozen phase
            if e < local_defreeze:
                t = e - warm
                n = sum(
                    1
                    for s in steps
                    if s < defreeze and 0 < (s - start_epoch - warm) <= t
                )
                return start_lr * (0.1 ** n)
            # segment 3: re-warmup right after defreeze (decay resets)
            if warm and e < local_defreeze + warm:
                t = e - local_defreeze
                return start_lr * (0.5 ** (warm - t))
            # segment 4 below with defreeze offset
            t = e - local_defreeze - warm
        else:
            t = e - warm
        n = sum(
            1
            for s in steps
            if s >= defreeze and 0 < (s - warm - max(defreeze, start_epoch)) <= t
        )
        return start_lr * (0.1 ** n)

    raise ValueError(f"unknown LR scheduler {sched!r}")


def schedule_trace(config, epochs=None, start_epoch: int = 0):
    """Per-epoch LR values for the configured schedule (list of floats)."""
    n = int(epochs if epochs is not None else config.TRAIN.EPOCHS)
    return [learning_rate(config, e, start_epoch)
            for e in range(start_epoch, n)]


def main(argv=None):
    """LR-schedule inspector: the reference's ``learningRateTest`` /
    ``debugLearningRate`` standalone (modelWithLoss.py:364-432,
    trainer.py:73-89) — print the per-epoch LR trace and optionally plot it.

        python -m centerfusiondetect3d_tpu_torch.training.schedule \
            [--cfg configs/Centerfusion_Middle.yaml] [--plot lr.png] \
            [--start-epoch N] [KEY VAL ...]

    Dotted overrides alone need no YAML reader. The trace is host
    arithmetic: ``--device`` is accepted as every entry point of the port
    accepts it, and nothing runs on a device.
    """
    import argparse
    import os

    from ..config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--plot", default=None, help="write a PNG of the trace")
    ap.add_argument("--start-epoch", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="accepted and unused: the trace runs on the host")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    cfg = load_config(args.cfg, opts=args.opts, num_classes=10)
    trace = schedule_trace(cfg, start_epoch=args.start_epoch)
    for e, lr in enumerate(trace, start=args.start_epoch):
        print(f"epoch {e:4d}  lr {lr:.3e}")
    if args.plot:
        from ..utils.observability import plot_lr_schedule

        plot_lr_schedule(cfg, args.plot, args.start_epoch)
        print(f"wrote {args.plot}" if os.path.exists(args.plot)
              else "matplotlib is not installed: no plot written")
    return trace


if __name__ == "__main__":  # pragma: no cover
    main()
