"""Where a training run from files spends its time, under each Loader setting.

    python -m centerfusiondetect3d_tpu_torch.tools.profile_train_loader
    python -m centerfusiondetect3d_tpu_torch.tools.profile_train_loader \\
        --variants serial,threads4 --profile --json out.json
    python -m centerfusiondetect3d_tpu_torch.tools.profile_train_loader \\
        --device cpu --tiny --items 8 --steps 2   # rehearsal: nothing measured

Trains the campaign's configuration (``CAMPAIGN_OPTS``: the repo's
nuScenes-format data under ``output/campaign_r5/data``, bf16, 128x224,
batch 16, the first epoch frozen) for ``--epochs`` epochs under each
variant of the host pipeline: ``serial`` (the Loader builds each batch on
the training thread, no device prefetch), ``producer`` (one thread builds
items behind a prefetch queue of 2, ``device_prefetch`` 2), ``threadsN``
(N threads, the same queues: what ``Trainer.train`` runs for ``WORKERS N``)
``threads4-si`` (``threads4`` with the interpreter's switch interval at
0.2 ms instead of 5), ``threads4-devsync`` (``threads4``, each step
waiting for the whole device, as a device-wide synchronize does) and
``serial-numpy`` / ``threads4-numpy`` (the item warp in numpy,
``warp_image``, instead of its C++ kernel: ``transforms.warp_image_native``
is swapped for the run). Each variant starts from the same seeded
weights.

The loop is ``Trainer.train``'s (``Loader`` -> ``device_prefetch`` ->
``training.train_step``), timed at each step: the wait for the next batch,
the host's enqueue of ``train_step``, the step until the training stream
has finished it (a CUDA event on that stream, so that the Loader's decode
streams and the prefetch's copy stream are not waited for), and the device
time between the step's two events. Per item it times the dataset's stages
in the threads that run them (decode, warp and normalise, radar, targets,
the rest), and a probe thread measures how late a 1 ms sleep wakes up: the
wait for the interpreter lock, plus the scheduler's jitter (which
``serial`` shows alone). ``step_alone`` times ``train_step`` on one batch
already on the card (the step's floor with no Loader), ``loader_alone``
the serial and threaded Loaders with no step. ``--profile`` runs one more
epoch of ``serial`` and of the widest threaded variant under
``torch.profiler`` and prints the device's busy time and idle share per
step. ``--json`` writes every number.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import threading
import time

import numpy as np
import torch

from ..config import default_config, finalize_config, update_config
from ..data import dataset as dataset_module
from ..data import transforms
from ..data.dataset import get_dataset
from ..data.pipeline import Loader, device_prefetch, stack_items, to_device
from ..losses import GenericLoss
from ..models import build_model
from ..runtime.synthetic import seeded_weights
from ..training import learning_rate, make_optimizer, train_step
from ..utils.observability import device_time_report, trace_profile

DATA_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "output", "campaign_r5", "data")
# the campaign's settings (output/campaign_r5), as chip_smoke.py runs them
CAMPAIGN_OPTS = [
    "WORKERS", "4", "DATASET.TRAIN_SPLIT", "mini_train",
    "DATASET.VAL_SPLIT", "mini_val", "DATASET.RADAR_PC", "True",
    "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.FRUSTUM", "True",
    "MODEL.DLA.NODE", "DeformConv", "MODEL.FREEZE_BACKBONE", "True",
    "MODEL.K", "32", "MODEL.INPUT_SIZE", "(128, 224)",
    "TRAIN.BATCH_SIZE", "16", "TRAIN.WARM_EPOCHS", "2", "TRAIN.LR_STEP",
    "[55]", "TEST.BATCH_SIZE", "16", "MIXED_PRECISION", "True",
]
TINY_OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "TRAIN.BATCH_SIZE", "4",
             "TEST.BATCH_SIZE", "4"]
# threads, prefetch queue, device_prefetch, the switch interval (None: the
# interpreter's), what a step waits for (the training stream or the whole
# device) and the item warp (the C++ kernel or numpy warp_image)
BASE = {"threads": 4, "prefetch": 2, "device_prefetch": 2, "switch": None,
        "waits_for": "stream", "warp": "native"}
VARIANTS = {
    "serial": {**BASE, "threads": 1, "prefetch": 0, "device_prefetch": 0},
    "producer": {**BASE, "threads": 1},
    "threads2": {**BASE, "threads": 2},
    "threads4": BASE,
    "threads4-si": {**BASE, "switch": 0.0002},
    "threads4-devsync": {**BASE, "waits_for": "device"},
    "serial-numpy": {**BASE, "threads": 1, "prefetch": 0,
                     "device_prefetch": 0, "warp": "numpy"},
    "threads4-numpy": {**BASE, "warp": "numpy"},
}
STAGES = ("decode", "warp", "radar", "targets")


class StageClock:
    """Seconds per dataset stage, summed over the threads that run them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds = collections.Counter()
        self.calls = collections.Counter()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.seconds[name] += dt
                    self.calls[name] += 1
        return timed

    def reset(self):
        with self.lock:
            self.seconds.clear()
            self.calls.clear()

    def per_item_ms(self) -> dict:
        n = max(1, self.calls["item"])
        out = {k: 1e3 * self.seconds[k] / n for k in ("item",) + STAGES}
        out["rest"] = out["item"] - sum(out[k] for k in STAGES)
        out["items"] = self.calls["item"]
        return out


def instrument(ds, clock: StageClock):
    """Times ``ds``'s stages: its image load (the decode), and the
    dataset module's ``transform_input`` (warp, normalise),
    ``prepare_radar_points`` (projection and paint) and its target
    builder's ``build``."""
    ds.get_item = clock.wrap("item", ds.get_item)
    ds.load_image = clock.wrap("decode", ds.load_image)
    ds.builder.build = clock.wrap("targets", ds.builder.build)
    dataset_module.transform_input = clock.wrap(
        "warp", dataset_module.transform_input)
    dataset_module.prepare_radar_points = clock.wrap(
        "radar", dataset_module.prepare_radar_points)


class LockProbe(threading.Thread):
    """Sleeps 1 ms at a time and records how late it wakes: the time to
    take the interpreter lock back, plus the scheduler's jitter."""

    def __init__(self):
        super().__init__(daemon=True, name="cfd3d-lock-probe")
        self.late = []
        self.halt = threading.Event()

    def run(self):
        while not self.halt.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            self.late.append(time.perf_counter() - t0 - 0.001)

    def stop(self) -> dict:
        self.halt.set()
        self.join()
        ms = np.sort(np.asarray(self.late)) * 1e3
        if not len(ms):
            return {}
        return {"mean": float(ms.mean()),
                "p50": float(np.percentile(ms, 50)),
                "p90": float(np.percentile(ms, 90)),
                "p99": float(np.percentile(ms, 99)),
                "max": float(ms[-1]), "samples": int(len(ms))}


def build(args):
    opts = list(CAMPAIGN_OPTS) + ["DATASET.ROOT", repr(args.root + "/"),
                                  "MODEL.DEFREEZE", "0"]
    if args.tiny:
        opts += TINY_OPTS
    config = update_config(default_config(), None, opts)
    dataset_cls = get_dataset(config.DATASET.DATASET)
    config = finalize_config(config, dataset_cls.num_categories,
                             dataset_cls.default_resolution)
    ds = dataset_cls(config, config.DATASET.TRAIN_SPLIT, device=args.device)
    if args.items:
        ds.images = ds.images[:args.items]
    model = build_model(config).to(args.device)
    return config, ds, model


def sync_stream(device):
    """An event on the current stream, to wait for and to time with."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def train_variant(cfg, ds, model, device, spec, epochs: int, steps: int,
                  clock: StageClock, profiled: bool = False):
    """``Trainer.train``'s loop under ``spec`` (a ``VARIANTS`` entry), timed
    per step; returns its record."""
    threads, dprefetch = spec["threads"], spec["device_prefetch"]
    switch, wait_for = spec["switch"], spec["waits_for"]
    seeded_weights(model, 0)
    optimizer = make_optimizer(cfg, model)
    loss_fn = GenericLoss(cfg)
    loader = Loader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=cfg.TRAIN.SHUFFLE,
                    seed=cfg.RANDOM_SEED, num_threads=threads,
                    prefetch=spec["prefetch"], augment=True)
    accum = int(cfg.TRAIN.get("GRAD_ACCUM", 1))
    native_warp = transforms.warp_image_native
    if spec["warp"] == "numpy":
        transforms.warp_image_native = transforms.warp_image
    old_switch = sys.getswitchinterval()
    if switch is not None:
        sys.setswitchinterval(switch)
    clock.reset()
    probe = LockProbe()
    probe.start()
    record = {"spec": spec, "epochs": []}
    try:
        for epoch in range(epochs):
            frozen = (bool(cfg.MODEL.FREEZE_BACKBONE)
                      and epoch <= cfg.MODEL.DEFREEZE)
            lr = learning_rate(cfg, epoch, 0)
            loader.epoch = epoch
            n = min(len(loader), steps) if steps else len(loader)
            rows = []
            profiler = (trace_profile(None, device) if profiled
                        else contextlib.nullcontext())
            t_epoch = time.perf_counter()
            with profiler as prof, contextlib.closing(
                    device_prefetch(loader, device, size=dprefetch)) as it:
                for _ in range(n):
                    t0 = time.perf_counter()
                    batch = next(it)
                    t1 = time.perf_counter()
                    start = sync_stream(device)
                    metrics = train_step(model, optimizer, loss_fn, batch, lr,
                                         frozen, accum)
                    t2 = time.perf_counter()
                    end = sync_stream(device)
                    if end is not None:
                        if wait_for == "device":
                            torch.cuda.synchronize(device)
                        end.synchronize()
                    t3 = time.perf_counter()
                    total = float(metrics["total"])
                    rows.append({
                        "wait_ms": 1e3 * (t1 - t0),
                        "enqueue_ms": 1e3 * (t2 - t1),
                        "step_ms": 1e3 * (t3 - t1),
                        "device_span_ms": (start.elapsed_time(end)
                                           if end is not None else None),
                        "total": total})
            wall = time.perf_counter() - t_epoch
            rec = {"frozen": frozen, "steps": len(rows), "wall_s": wall,
                   "sum_step_s": sum(r["step_ms"] for r in rows) / 1e3,
                   "sum_wait_s": sum(r["wait_ms"] for r in rows) / 1e3}
            for key in ("wait_ms", "enqueue_ms", "step_ms",
                        "device_span_ms"):
                vals = [r[key] for r in rows if r[key] is not None]
                if vals:
                    rec[key] = {"mean": statistics.mean(vals),
                                "median": statistics.median(vals),
                                "max": max(vals)}
            rec["totals"] = [r["total"] for r in rows]
            if profiled and torch.device(device).type == "cuda":
                rec["device"] = device_time_report(prof, len(rows),
                                                   1e6 * wall, (), "all", 3)
            record["epochs"].append(rec)
    finally:
        sys.setswitchinterval(old_switch)
        transforms.warp_image_native = native_warp
        record["lock_probe_late_ms"] = probe.stop()
    record["item_ms"] = clock.per_item_ms()
    return record


def step_alone(cfg, ds, model, device, steps: int):
    """``train_step`` on one batch already on the device, frozen then
    not: the step with no Loader beside it."""
    seeded_weights(model, 0)
    optimizer = make_optimizer(cfg, model)
    loss_fn = GenericLoss(cfg)
    bs = int(cfg.TRAIN.BATCH_SIZE)
    rng = [np.random.RandomState(i) for i in range(bs)]
    batch = to_device(stack_items([
        {k: v for k, v in ds.get_item(i, rng[i]).items() if k != "meta"}
        for i in range(bs)]), device)
    out = {}
    for frozen in (True, False):
        ms = []
        for _ in range(steps):
            t1 = time.perf_counter()
            train_step(model, optimizer, loss_fn, batch, 1e-4, frozen,
                       int(cfg.TRAIN.get("GRAD_ACCUM", 1)))
            end = sync_stream(device)
            if end is not None:
                end.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
        out["frozen" if frozen else "unfrozen"] = {
            "mean": statistics.mean(ms[1:] or ms),
            "median": statistics.median(ms)}
    return out


def loader_alone(cfg, ds, threads: int, prefetch: int, batches: int):
    loader = Loader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=True,
                    seed=cfg.RANDOM_SEED, num_threads=threads,
                    prefetch=prefetch, augment=True)
    n = min(batches, len(loader))
    t0 = time.perf_counter()
    with contextlib.closing(iter(loader)) as it:
        for _ in range(n):
            next(it)
    dt = time.perf_counter() - t0
    return {"threads": threads, "prefetch": prefetch, "batches": n,
            "items_per_s": n * int(cfg.TRAIN.BATCH_SIZE) / dt}


def line(name: str, rec: dict) -> str:
    parts = []
    for i, ep in enumerate(rec["epochs"]):
        tag = "frozen" if ep["frozen"] else "unfrozen"
        dev = ep.get("device_span_ms", {}).get("mean")
        parts.append(
            f"epoch {i} ({tag}) {ep['wall_s']:.2f} s, steps {ep['sum_step_s']:.2f}"
            f" s + wait {ep['sum_wait_s']:.2f} s; a step: wait "
            f"{ep['wait_ms']['mean']:.1f}, enqueue {ep['enqueue_ms']['mean']:.1f}"
            f", done {ep['step_ms']['mean']:.1f}"
            + (f", device span {dev:.1f}" if dev is not None else "")
            + " ms")
    item = rec["item_ms"]
    probe = rec["lock_probe_late_ms"]
    return (f"{name}: " + "; ".join(parts)
            + f"; an item {item['item']:.2f} ms (" + ", ".join(
                f"{k} {item[k]:.2f}" for k in STAGES + ("rest",))
            + f"); 1 ms sleep late by {probe.get('mean', 0):.3f} mean, "
              f"{probe.get('p99', 0):.3f} p99 ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=DATA_ROOT)
    ap.add_argument("--tiny", action="store_true",
                    help="64x128, batch 4 (the CPU rehearsal)")
    ap.add_argument("--items", type=int, default=0,
                    help="use the first ITEMS train images (0: all)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps an epoch at most (0: the whole epoch)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1,
                    help="run the variants this many times, in turns")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_train_loader: no CUDA device available")
    if args.device == "cpu" and not args.tiny:
        raise SystemExit("profile_train_loader: --device cpu runs only with "
                         "--tiny")
    names = [v for v in args.variants.split(",") if v]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"profile_train_loader: unknown variants {unknown}; "
                         f"known: {sorted(VARIANTS)}")
    cfg, ds, model = build(args)
    clock = StageClock()
    instrument(ds, clock)
    device = torch.device(args.device)
    report = {"items": len(ds), "batch": int(cfg.TRAIN.BATCH_SIZE),
              "input": list(cfg.MODEL.INPUT_SIZE), "rounds": []}
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(device)
    warm = step_alone(cfg, ds, model, device, 2)  # kernel builds, handles
    report["step_alone"] = step_alone(cfg, ds, model, device,
                                      args.steps or 10)
    print(f"step alone (a batch on the device): frozen "
          f"{report['step_alone']['frozen']['mean']:.1f}, unfrozen "
          f"{report['step_alone']['unfrozen']['mean']:.1f} ms (warm-up "
          f"{warm['frozen']['mean']:.1f})", flush=True)
    report["loader_alone"] = [loader_alone(cfg, ds, t, p, args.steps or 8)
                              for t, p in ((1, 0), (4, 2))]
    print("loader alone: " + ", ".join(
        f"{r['threads']} threads prefetch {r['prefetch']} "
        f"{r['items_per_s']:.1f} items/s" for r in report["loader_alone"]),
        flush=True)
    for r in range(args.rounds):
        rnd = {}
        for name in names:
            rnd[name] = train_variant(cfg, ds, model, device, VARIANTS[name],
                                      args.epochs, args.steps, clock)
            print(f"round {r} " + line(name, rnd[name]), flush=True)
        report["rounds"].append(rnd)
    if args.profile:
        widest = max((n for n in names if n != "serial"),
                     key=lambda n: VARIANTS[n]["threads"], default=None)
        report["profiled"] = {}
        for name in ["serial"] + ([widest] if widest else []):
            rec = train_variant(cfg, ds, model, device, VARIANTS[name], 1,
                                args.steps, clock, profiled=True)
            report["profiled"][name] = rec
            print("profiled " + line(name, rec), flush=True)
            for dev_line in rec["epochs"][0].get("device") or [
                    "device time: not measured"]:
                print("  " + dev_line.replace("per run", "per step"),
                      flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
