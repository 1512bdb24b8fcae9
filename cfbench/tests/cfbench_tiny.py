"""Tiny versions of the benchmark's cells for CPU tests: the real workload
and configuration files with the sizes cut so that a run takes seconds."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cfbench import harness  # noqa: E402

E2E = {"serve_stream": ("serve_frames_per_s", "serve_batch_p95_ms"),
       "train_step": ("train_images_per_s",)}
UNITS = {"serve_frames_per_s": "frames/s", "serve_batch_p95_ms": "ms",
         "train_images_per_s": "images/s", "setup_s": "s"}


# the serving loop's other path: the parked serving cell's workload on the
# camera-only configuration
VARIANTS = {"centernet_serve": ("middle_serve_b24", "centernet", {})}
# the cell of BENCHMARK.json, the parked cells (workload files that are
# not cells: middle_serve_b24, middle_train_frozen) and the variant
CELLS = ["middle_serve_b24", "centernet_serve", "centernet_train_b64",
         "middle_train_frozen"]


def load(name: str) -> dict:
    """A cell's workload, or a variant of one (``VARIANTS``)."""
    if name not in VARIANTS:
        return harness.load_workload(name)
    base, config, params = VARIANTS[name]
    wl = harness.load_workload(base)
    wl.update(name=name, config=config,
              config_file=harness.load_json("configs", config))
    wl["params"].update(params)
    if config == "centernet":
        wl["params"].pop("radar_points", None)
    return wl


def tiny(name: str, float32: bool = False) -> dict:
    """Workload ``name`` at 64x128, K 16, with a few small frames or
    items; ``float32``: the program in float32 (MIXED_PRECISION False),
    which the reference matches to rounding."""
    wl = load(name)
    c, p = wl["config_file"], wl["params"]
    extra = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.K", "16"]
    if float32:
        extra += ["MIXED_PRECISION", "False"]
    c["opts"] = c["opts"] + extra
    c["model"].update(input_size=[64, 128], K=16)
    if wl["loop"] == "serve_stream":
        p.update(samples_per_batch=1, cameras=2, frame_hw=[90, 160],
                 pool_samples=2, warmup_batches=2, check_batches=1,
                 reference_block=2, capture_span=2,
                 intrinsics=[126.6, 126.6, 80.0, 45.0])
        if "radar_points" in p:
            p["radar_points"] = [50, 200]
    else:
        p.update(batch=4, pool_batches=3, max_objects=4, warmup_steps=1)
    wl["spec"] = {"end_to_end": [{"name": n, "unit": UNITS[n]} for n in
                                 E2E[wl["loop"]] + ("setup_s",)],
                  "per_layer": []}
    return wl


def run_tiny(name: str, float32: bool = False, seconds: float = 4.0,
             seed: int = 2 ** 33 + 17) -> dict:
    return harness.run_cell(tiny(name, float32), seed, seconds, False,
                            device="cpu")
