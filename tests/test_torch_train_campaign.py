"""The port's training campaign (``tools/train_campaign.py``) against the
JAX package's ``scripts/train_campaign.py``.

- Every stage's config (phases 1-4 and the final eval, both scales) equals
  the JAX script's on every key both configs have, the resume checkpoint
  aside (the port's is ``model_last.pt``, JAX's the orbax ``model_last``).
  The JAX script is loaded with importlib, as ``tests/test_campaign.py``
  loads it, and its phase 3/4 edits are applied as its ``main`` applies
  them.
- Each phase's schedule equals JAX's ``schedule_trace`` from the phase's
  first epoch (exactly: the same arithmetic in float64).
- A resumed Trainer steps at the LR of its own config, not at the LR held
  in the restored optimizer's ``param_groups``, from its first step, and
  continues the restored AdamW state (per-parameter step counts).
- The smoke scale on the CPU with Conv nodes (what JAX's
  ``test_campaign.py`` pins, there ``-m slow``): both phases ran, the resume
  started at e1, losses finite, every summary and the report written.
- ``read_summary`` equals JAX's on a written summary and on none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    SyntheticTrainingSet)
from centerfusiondetect3d_tpu_torch.tools import train_campaign
from centerfusiondetect3d_tpu_torch.training import schedule

jax_schedule = pytest.importorskip("centerfusiondetect3d_tpu.training.schedule")
pytest.importorskip("centerfusiondetect3d_tpu.data")

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "train_campaign.py")


@pytest.fixture(scope="module")
def jax_campaign():
    spec = importlib.util.spec_from_file_location("train_campaign_jax",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_phase_cfgs(camp, scale, root, out_dir):
    """The JAX script's stage configs, edited as its ``main`` edits them."""
    args = camp.argparse.Namespace(platform="", opts=[])
    sc = camp.SCALES[scale]
    cfgs = {"phase1": camp.build_cfg(args, sc, root, out_dir, epochs=sc["e1"],
                                     resume=False)[0],
            "phase2": camp.build_cfg(args, sc, root, out_dir, epochs=sc["e2"],
                                     resume=True)[0]}
    if sc["e3"] > sc["e2"]:
        cfg3 = camp.build_cfg(args, sc, root, out_dir, epochs=sc["e3"],
                              resume=True)[0]
        cfg3.defrost()
        cfg3.TRAIN.LR_STEP = (sc["lr_step3"],)
        cfg3.TRAIN.VAL_INTERVALS = 40
        cfgs["phase3"] = cfg3
    if sc["e4"] > sc["e3"]:
        cfg4 = camp.build_cfg(args, sc, root, out_dir, epochs=sc["e4"],
                              resume=True)[0]
        cfg4.defrost()
        cfg4.TRAIN.LR = sc["lr4"]
        cfg4.TRAIN.LR_STEP = (10 * sc["e4"],)
        cfg4.TRAIN.VAL_INTERVALS = sc["e4"] - sc["e3"]
        cfgs["phase4"] = cfg4
    cfgf = camp.build_cfg(args, sc, root, out_dir, epochs=0, resume=False)[0]
    cfgf.defrost()
    cfgf.EVAL = True
    cfgf.MODEL.LOAD_DIR = os.path.join(out_dir, "ckpts", "model_last")
    cfgs["final"] = cfgf
    return cfgs


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = json.loads(json.dumps(v))  # tuples -> lists
    return out


def _port_phase_cfgs(scale, root, out_dir):
    args = train_campaign.parse_args(["--scale", scale])
    sc = train_campaign.SCALES[scale]
    return sc, train_campaign.phase_cfgs(args, sc, root, out_dir)


@pytest.mark.parametrize("scale", sorted(train_campaign.SCALES))
def test_stage_configs_equal_jax(scale, jax_campaign, tmp_path):
    root = str(tmp_path / "data" / "nuscenes")
    out = str(tmp_path / "campaign")
    _, got = _port_phase_cfgs(scale, root, out)
    want = _jax_phase_cfgs(jax_campaign, scale, root, out)
    assert list(got) == list(want)
    for name in want:
        g, w = _flat(got[name].to_dict()), _flat(want[name].to_dict())
        common = set(g) & set(w)
        assert len(common) > 120, (name, len(common))
        for key in sorted(common):
            if key == "MODEL.LOAD_DIR" and w[key]:
                assert g[key] == w[key] + ".pt", name
            else:
                assert g[key] == w[key], (name, key, g[key], w[key])
        assert g["OUTPUT_DIR"] == out
        assert g["TRAIN.RESUME"] == (name not in ("phase1", "final"))


@pytest.mark.parametrize("scale", sorted(train_campaign.SCALES))
def test_phase_schedules_equal_jax(scale, jax_campaign, tmp_path):
    root = str(tmp_path / "data" / "nuscenes")
    out = str(tmp_path / "campaign")
    sc, got = _port_phase_cfgs(scale, root, out)
    want = _jax_phase_cfgs(jax_campaign, scale, root, out)
    for name in got:
        if name == "final":
            continue
        start = train_campaign.phase_start_epoch(sc, name)
        trace = schedule.schedule_trace(got[name], start_epoch=start)
        assert trace == jax_schedule.schedule_trace(want[name],
                                                    start_epoch=start)
        assert len(trace) == int(got[name].TRAIN.EPOCHS) - start > 0


def _tiny_cfg(tmp_path, epochs, lr, resume):
    opts = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
            "MIXED_PRECISION", "False", "DATASET.RADAR_PC", "True",
            "MODEL.FRUSTUM", "True", "MODEL.FUSION_STRATEGY", "'middle'",
            "TRAIN.BATCH_SIZE", "2", "TRAIN.EPOCHS", str(epochs),
            "TRAIN.LR", str(lr), "TRAIN.LR_STEP", "(100,)",
            "TRAIN.WARM_EPOCHS", "0", "MODEL.FREEZE_BACKBONE", "True",
            "MODEL.DEFREEZE", "0", "TRAIN.VAL_INTERVALS", "0",
            "TRAIN.SAVE_INTERVALS", "1", "WORKERS", "0",
            "OUTPUT_DIR", repr(str(tmp_path))]
    if resume:
        opts += ["TRAIN.RESUME", "True", "MODEL.LOAD_DIR",
                 repr(str(tmp_path / "ckpts" / "model_last.pt"))]
    return load_config(opts=opts, num_classes=10)


def test_resume_steps_at_the_new_lr(tmp_path):
    """Phases 3 and 4 change ``TRAIN.LR`` after the resume; the restored
    ``param_groups`` hold the old LR, and every step of the resumed run
    must take the new config's (``train_step`` writes it before
    ``optimizer.step``), with the AdamW state carried over."""
    first = _tiny_cfg(tmp_path, 2, 2.0 ** -10, resume=False)
    items = SyntheticTrainingSet(first, 2, seed=1)
    tr = Trainer(first, items, device="cpu")
    tr.train()
    saved = torch.load(tmp_path / "ckpts" / "model_last.pt",
                       weights_only=False)
    assert saved["epoch"] == 1
    assert {g["lr"] for g in saved["optimizer"]["param_groups"]} == {
        2.0 ** -10}
    steps_before = max(float(s["step"])
                       for s in saved["optimizer"]["state"].values())
    assert steps_before == 2.0

    resumed = _tiny_cfg(tmp_path, 4, 2.0 ** -13, resume=True)
    tr2 = Trainer(resumed, SyntheticTrainingSet(resumed, 2, seed=1),
                  device="cpu")
    tr2.init_state()
    assert tr2.start_epoch == 2
    assert {g["lr"] for g in tr2.optimizer.param_groups} == {2.0 ** -10}
    seen = []
    step = tr2.optimizer.step

    def recording_step(*a, **k):
        seen.append(({g["lr"] for g in tr2.optimizer.param_groups},
                     max(float(s["step"])
                         for s in tr2.optimizer.state.values())))
        return step(*a, **k)

    tr2.optimizer.step = recording_step
    tr2.train()
    want = [schedule.learning_rate(resumed, e, 2) for e in (2, 3)]
    assert want == [2.0 ** -13] * 2
    assert [lrs for lrs, _ in seen] == [{lr} for lr in want]
    # the restored AdamW continues: its step counts were 2 before the
    # first resumed step
    assert [n for _, n in seen] == [2.0, 3.0]


def test_smoke_campaign_mechanics_on_cpu(tmp_path):
    out = tmp_path / "campaign"
    rc = train_campaign.main(["--out", str(out), "--scale", "smoke",
                              "--device", "cpu", "--fresh",
                              "MODEL.DLA.NODE", "Conv"])
    report = json.loads((out / "campaign_report.json").read_text())
    assert rc == 0, report
    assert report["passed"] is True and report["resume_ok"] is True
    sc = train_campaign.SCALES["smoke"]
    assert report["phase2"]["resume_start_epoch"] == sc["e1"]
    assert "phase3" not in report and "phase4" not in report
    for stage in ("baseline", "phase1", "phase2", "final"):
        blob = report[stage] if stage == "baseline" else report[stage]["val"]
        assert blob and "mAP" in blob and "present_class_mAP" in blob
    for name in ("phase1", "phase2"):
        assert math.isfinite(report[name]["train_loss_last"])
        assert report[name]["steps"] == 6  # 12 items, batch 4, 2 epochs
    assert report["val_trajectory_present_class_mAP"].keys() == {
        "epoch_2", "epoch_4"}
    assert report["device"] == "cpu"
    ckpts = sorted(os.listdir(out / "ckpts"))
    assert ckpts == ["model_0.pt", "model_1.pt", "model_2.pt", "model_3.pt",
                     "model_last.pt"]
    assert json.loads((out / "config.json").read_text())["OUTPUT_DIR"] == str(
        out)
    # a rerun skips every stage the report holds
    assert train_campaign.main(["--out", str(out), "--scale", "smoke",
                                "--device", "cpu"]) == 0


def test_data_option_reads_the_tables_and_writes_nothing(tmp_path):
    with pytest.raises(FileNotFoundError, match="annotations"):
        train_campaign.prepare_data(
            train_campaign.parse_args(["--data", str(tmp_path)]),
            train_campaign.SCALES["smoke"], str(tmp_path / "out"))
    committed = os.path.join(os.path.dirname(__file__), "..", "output",
                             "campaign_r5", "data")
    root = train_campaign.prepare_data(
        train_campaign.parse_args(["--data", committed]),
        train_campaign.SCALES["full"], str(tmp_path / "out"))
    assert root == os.path.join(os.path.abspath(committed), "nuscenes")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("present", [True, False])
def test_read_summary_equals_jax(present, jax_campaign, tmp_path):
    assert train_campaign.read_summary(str(tmp_path)) is None
    assert jax_campaign.read_summary(str(tmp_path)) is None
    rng = np.random.RandomState(3)
    classes = ["barrier", "bicycle", "bus", "car", "construction_vehicle",
               "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck"]
    if not present:
        classes = [c for c in classes
                   if c not in train_campaign.CAMPAIGN_CLASSES]
    aps = {c: float(v) for c, v in zip(classes, rng.rand(len(classes)))}
    path = tmp_path / train_campaign.SUMMARY
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"mean_ap": float(np.mean(list(aps.values()))),
                                "nd_score": 0.123, "mean_dist_aps": aps}))
    got = train_campaign.read_summary(str(tmp_path))
    want = jax_campaign.read_summary(str(tmp_path))
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(want[key], float) and math.isnan(want[key]):
            assert math.isnan(got[key]), key
        else:
            assert got[key] == want[key], key
