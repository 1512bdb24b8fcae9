"""A tiny training run of the port's ``Trainer`` on the CPU with the JAX
package's host side: threaded Loader, device prefetch, health checks, run
logging, the FLOPs report, loss plots and ``TPU.PROFILE``.

The synthetic raw tables (``data/synthetic.py``) go through the port's
converter into a converter-format set; DLA-34 with Conv nodes at 96x160
trains 2 epochs of 2 steps and validates once. With ``WORKERS 3``,
``TPU.PREFETCH 2`` the run's ``history`` and every step's total equal
those of ``WORKERS 1``, ``TPU.PREFETCH 0`` exactly: threads and prefetch
change no batch; ``WORKERS 0`` builds the items on the training thread. ``metrics.jsonl`` holds the JAX Trainer's event kinds and
keys (``train/*`` and ``lr``, ``epoch_sec`` per epoch; ``val/*``,
``val/mAP``, ``val/NDS``), ``run_state.json`` the summary; the FLOPs line
is logged once with a positive figure; ``health.check`` runs once per
step; the native paint runs once per item built; ``TPU.PROFILE`` writes
``OUTPUT_DIR/profile/trace.json``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading

import pytest
import torch

from centerfusiondetect3d_tpu_torch import native
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.convert_nuscenes import export_split
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_raw_tables)
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer, loader_threads

pytest.importorskip("cv2")  # the CPU's image decoder

torch.set_num_threads(2)

N_TRAIN, N_VAL, BATCH, EPOCHS = 4, 3, 2, 2


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    raw = str(root / "nuscenes")
    make_synthetic_raw_tables(raw, {"mini_train": N_TRAIN, "mini_val": N_VAL})
    for split in ("mini_train", "mini_val"):
        export_split(raw, split, verbose=False)
    return str(root) + "/"


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(data_root, out_dir, workers, prefetch, profile):
    cfg = load_config(opts=[
        "DATASET.ROOT", repr(data_root), "OUTPUT_DIR", repr(str(out_dir)),
        "DATASET.TRAIN_SPLIT", "'mini_train'", "DATASET.VAL_SPLIT",
        "'mini_val'", "MODEL.DLA.NODE", "Conv", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "DATASET.RADAR_PC", "True",
        "MODEL.INPUT_SIZE", "(96, 160)", "DATASET.PILLAR_DIMS",
        "(1.5, 0.6, 0.6)", "TRAIN.BATCH_SIZE", str(BATCH),
        "TEST.BATCH_SIZE", str(BATCH), "MODEL.K", "8", "MIXED_PRECISION",
        "False", "TRAIN.LR", "1e-4", "TRAIN.WARM_EPOCHS", "0",
        "TRAIN.EPOCHS", str(EPOCHS), "TRAIN.VAL_INTERVALS", str(EPOCHS),
        "TRAIN.SAVE_INTERVALS", str(EPOCHS), "TEST.FLIP_TEST", "False",
        "WORKERS", str(workers), "TPU.PREFETCH", str(prefetch),
        "TPU.PROFILE", str(profile)], num_classes=10)
    logger = logging.getLogger(f"cfd3d.test_fit_run.{workers}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.handlers.clear()
    lines = _Lines()
    logger.addHandler(lines)
    loader_threads = []  # the Loader's threads alive at each step

    def on_step(epoch, step, frozen, metrics):
        loader_threads.append(sorted(
            t.name for t in threading.enumerate()
            if t.name.startswith("cfd3d-loader")))

    trainer = Trainer(cfg, NuScenesDataset(cfg, "mini_train", device="cpu"),
                      NuScenesDataset(cfg, "mini_val", device="cpu"),
                      device="cpu", logger=logger, on_step=on_step)
    trainer.loader_threads = loader_threads
    checks = []
    real_check = trainer.health.check
    trainer.health.check = lambda: checks.append(1) or real_check()
    paints = native.paint_rects.calls
    trainer.train()
    return trainer, lines.lines, len(checks), native.paint_rects.calls - paints


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    return {
        "threaded": _run(data_root, tmp_path_factory.mktemp("threaded"), 3, 2,
                         True),
        "serial": _run(data_root, tmp_path_factory.mktemp("serial"), 1, 0,
                       False),
        "workers0": _run(data_root, tmp_path_factory.mktemp("workers0"), 0,
                         0, False),
    }


def test_threads_and_prefetch_change_no_result(runs):
    threaded, serial = runs["threaded"][0], runs["serial"][0]
    assert threaded.history == serial.history
    assert ([(s["epoch"], s["frozen"], s["total"]) for s in threaded.steps]
            == [(s["epoch"], s["frozen"], s["total"]) for s in serial.steps])
    assert len(threaded.steps) == EPOCHS * (N_TRAIN // BATCH)


def test_workers_0_builds_on_the_training_thread(runs):
    """``WORKERS 0`` (the reference DataLoader's ``num_workers=0``): no
    Loader thread and no prefetch thread runs during the steps, and the
    batches are those of the threaded run."""
    assert loader_threads(0) == {"num_threads": 1, "prefetch": 0}
    assert loader_threads(1) == {"num_threads": 1, "prefetch": 2}
    assert loader_threads(4) == {"num_threads": 4, "prefetch": 2}
    workers0, threaded = runs["workers0"][0], runs["threaded"][0]
    assert workers0.history == threaded.history
    assert workers0.loader_threads == [[]] * len(workers0.steps)


def _events(trainer):
    with open(os.path.join(trainer.config.OUTPUT_DIR, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["threaded", "serial", "workers0"])
def test_metrics_jsonl_has_the_jax_events(runs, name):
    trainer = runs[name][0]
    events = _events(trainer)
    assert {e["kind"] for e in events} == {"scalars"}
    assert len({e["run_id"] for e in events}) == 1
    train_keys = {f"train/{k}" for k in trainer.history["train"]}
    assert {"train/total", "train/grad_norm"} <= train_keys
    val_keys = {f"val/{k}" for k in trainer.history["val"]}
    want = []
    for epoch in range(EPOCHS):
        want += [(epoch, train_keys), (epoch, {"lr", "epoch_sec"})]
    want += [(None, val_keys), (None, {"val/mAP", "val/NDS"})]
    got = [(e.get("step"), set(e) - {"ts", "run_id", "kind", "step"})
           for e in events]
    assert got == want
    for epoch in range(EPOCHS):
        assert (events[2 * epoch]["train/total"]
                == trainer.history["train"]["total"][epoch])
        assert events[2 * epoch + 1]["epoch_sec"] > 0
    with open(os.path.join(trainer.config.OUTPUT_DIR,
                           "run_state.json")) as f:
        state = json.load(f)
    assert state["run_id"] == events[0]["run_id"]
    nds = state["summary"]["range_all"]["nd_score"]
    assert 0.0 <= nds <= 1.0 and events[-1]["val/NDS"] == nds


@pytest.mark.parametrize("name", ["threaded", "serial"])
def test_flops_line_health_checks_and_paints(runs, name):
    trainer, lines, checks, paints = runs[name]
    cost = [line for line in lines if line.startswith("model cost:")]
    assert len(cost) == 1, cost
    gflops = float(re.match(r"model cost: ([0-9.]+) GFLOPs", cost[0]).group(1))
    assert gflops > 0
    assert checks == len(trainer.steps) == EPOCHS * (N_TRAIN // BATCH)
    # every item built paints: train items, the val items, the cost report's
    # peeked batch
    assert paints == EPOCHS * N_TRAIN + N_VAL + BATCH
    progress = [line for line in lines if re.match(r"epoch \d+ \[\d+/\d+\]",
                                                   line)]
    assert len(progress) == len(trainer.steps)
    out = trainer.config.OUTPUT_DIR
    assert os.path.exists(os.path.join(out, "history.json"))
    assert os.path.exists(os.path.join(out, "ckpts", "model_last.pt"))


def test_profile_writes_a_trace_of_the_first_epoch(runs):
    out = runs["threaded"][0].config.OUTPUT_DIR
    path = os.path.join(out, "profile", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert not os.path.exists(os.path.join(runs["serial"][0].config.OUTPUT_DIR,
                                           "profile"))
