"""Faults planted under a cell's timed path, to see its check catch them.

    python3 cfbench/faults.py --workload <cell> --fault <name> --seed <n> [--seconds <s>]

runs the cell once (on the first CUDA card) with the program broken
underneath and prints the result line: ``correct`` has to come out false.
The faults are those a cell can have:

- ``unchanged``: a training step that returns its state unchanged (the
  optimizer's step does nothing);
- ``half_batch``: half of the batch left out, the rest computed and (in
  training) the mean taken over it, its rows cut to a multiple of the
  step's microbatches; in serving the first half's outputs stand for the
  whole batch;
- ``altered``: an answer altered where it is produced (served scores
  +0.01; a training step's heatmap loss x1.01).

A single card has no exchange between chips to leave out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _half(t, multiple: int = 1):
    return t[: t.shape[0] // 2 // multiple * multiple]


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def planted(fault: str, loop: str):
    """A context in which ``fault`` is planted under the path of the
    traffic loop ``loop``."""
    import torch

    from centerfusiondetect3d_tpu_torch.models import detector as models
    from centerfusiondetect3d_tpu_torch.runtime import detector as serving
    from centerfusiondetect3d_tpu_torch.training import state

    if loop == "serve_stream" and fault == "half_batch":
        forward = models.CenterFusionDLA.forward

        def half(self, image, pc_dep=None, calib=None, pc_hm=None,
                 train=False):
            n = image.shape[0]
            cut = [None if t is None else _half(t) for t in (pc_dep, calib)]
            y = forward(self, _half(image), *cut, pc_hm, train)
            return {k: v.repeat(2, *[1] * (v.dim() - 1))[:n]
                    for k, v in y.items()}
        return _patched(models.CenterFusionDLA, "forward", half)
    if loop == "serve_stream" and fault == "altered":
        post = serving.post_process

        def altered(*a, **kw):
            y = post(*a, **kw)
            y["scores"] = y["scores"] + 0.01
            return y
        return _patched(serving, "post_process", altered)
    if loop == "train_step" and fault == "unchanged":
        return _patched(torch.optim.AdamW, "step",
                        lambda self, *a, **kw: None)
    step = state.train_step
    if loop == "train_step" and fault == "half_batch":
        def half_step(model, opt, loss_fn, batch, *a, **kw):
            m = int(kw.get("accum_steps", 1))
            cut = {k: ({kk: _half(vv, m) for kk, vv in v.items()}
                       if isinstance(v, dict) else _half(v, m))
                   for k, v in batch.items()}
            return step(model, opt, loss_fn, cut, *a, **kw)
        return _patched(state, "train_step", half_step)
    if loop == "train_step" and fault == "altered":
        def altered_step(*a, **kw):
            out = step(*a, **kw)
            out["heatmap"] = out["heatmap"] * 1.01
            return out
        return _patched(state, "train_step", altered_step)
    raise ValueError(f"no fault {fault!r} for the traffic loop {loop!r}")


FAULTS = {"serve_stream": ("half_batch", "altered"),
          "train_step": ("unchanged", "half_batch", "altered")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from cfbench.harness import benchmark_spec, load_workload, run_cell

    wl = load_workload(args.workload)
    wl["spec"] = benchmark_spec()
    with planted(args.fault, wl["loop"]):
        result = run_cell(wl, args.seed, args.seconds, False)
    result.pop("info", None)
    print(json.dumps({"fault": args.fault, "seed": args.seed,
                      "correct": result["correct"],
                      "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
