"""Benchmark of centerfusiondetect3d_tpu_torch: one run of one cell.

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the run's JSON result; earlier
lines record the host, the card and the set-up. The cells, their traffic,
configurations and per-layer metrics are files under ``cfbench/`` found by
name (``cfbench/harness.py``).
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from cfbench.harness import main_run

    return main_run(args.workload, args.seed, args.seconds, bool(args.trace),
                    START)


if __name__ == "__main__":
    sys.exit(main())
