"""The control of a cell's correctness check: the plain reference in the
next lower precision in the program's place (fp8 operands for the bf16
configurations), judged by the cell's own check. Each reading has to fail
one of the cell's limits.

    python3 cfbench/control.py --workload <cell> --seed <n> [--seed <m> ...] [--side program]

Prints one JSON line a seed: the readings, the limits and whether the
check would take the control for correct. ``--side program`` reads the
program instead, where the traffic loop can without a window (training:
its three checked steps), with the details of its numbers: the lower
readings that the limits are set from. Runs on the first CUDA card
(``--device cpu``: the tests' small sizes only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: dict, seed: int, device, side: str = "control") -> dict:
    """The traffic loop's control numbers (or, ``side`` "program", the
    program's) for ``workload`` on ``seed`` with the cell's limits, and
    whether every number met its limit."""
    import gc
    import math

    import torch

    from cfbench.harness import Run, _seed_of, load_module

    run = Run(workload, _seed_of(seed), 0.0, False, torch.device(device),
              0.0)
    run.loop = load_module("traffic", workload["loop"])
    got = (run.loop.readings(run) if side == "program"
           else run.loop.control(run, run.device))
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    limits = workload["limits"]
    passed = all(k in got and math.isfinite(got[k]) and got[k] <= limits[k]
                 for k in limits)
    return {"seed": seed, "side": side, "readings": got, "limits": limits,
            "passes": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from cfbench.harness import load_workload

    wl = load_workload(args.workload)
    for seed in args.seed:
        print(json.dumps(readings(wl, seed, args.device, args.side)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
