"""``python -m centerfusiondetect3d_tpu_torch.tools rehearse`` on the CPU:
synthetic raw tables -> converter -> [train] -> validate -> NDS summary,
at the JAX test's scale (``tests/test_rehearse.py``: Conv nodes, no TTA).
Neither case is slow here (~15 s each on the CPU), so neither is marked.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from centerfusiondetect3d_tpu_torch import tools
from centerfusiondetect3d_tpu_torch.training.checkpoint import load_torch_file

pytest.importorskip("cv2")  # the synthetic JPEGs and the CPU's decoder

torch.set_num_threads(2)

SMALL = ["MODEL.DLA.NODE", "Conv", "TEST.FLIP_TEST", "False"]


def _summary(out):
    path = os.path.join(out, "nuscenes_eval_det_output_mini_val",
                        "range_all", "metrics_summary.json")
    with open(path) as f:
        return json.load(f)


def test_rehearse_eval_only_runs_green_and_again(tmp_path, capsys):
    out = str(tmp_path / "rehearsal")
    argv = ["rehearse", "--device", "cpu", "--out", out, "--epochs", "0"]
    assert tools.main(argv + SMALL) == 0
    assert 0.0 <= _summary(out)["nd_score"] <= 1.0
    assert os.path.exists(os.path.join(out, "synthetic_nuscenes",
                                       "annotations", "mini_val.json"))
    assert "converting split mini_val" in capsys.readouterr().out
    # a second run reuses the tables and the converter's output
    assert tools.main(argv + SMALL) == 0
    text = capsys.readouterr().out
    assert "converter output exists for mini_val" in text
    assert "[rehearse] OK" in text


def test_rehearse_training_leg(tmp_path):
    out = str(tmp_path / "rehearsal")
    assert tools.main(["rehearse", "--device", "cpu", "--out", out,
                       "--epochs", "1"] + SMALL) == 0
    assert 0.0 <= _summary(out)["nd_score"] <= 1.0
    ckpt = load_torch_file(os.path.join(out, "ckpts", "model_last.pt"))
    assert ckpt["epoch"] == 0
    assert ckpt["history"]["train"]["total"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"train/total", "lr", "epoch_sec", "val/total", "val/mAP",
            "val/NDS"} <= keys
    with open(os.path.join(out, "run_state.json")) as f:
        assert "range_all" in json.load(f)["summary"]


def test_rehearse_on_given_raw_tables(tmp_path):
    """--dataroot a directory that is not named nuscenes: the run links it
    in from its own directory and converts there."""
    from centerfusiondetect3d_tpu_torch.data.synthetic import (
        make_synthetic_raw_tables)

    raw = str(tmp_path / "raw_tables")
    make_synthetic_raw_tables(raw, {"mini_train": 2, "mini_val": 2})
    out = str(tmp_path / "run")
    assert tools.main(["rehearse", "--device", "cpu", "--dataroot", raw,
                       "--out", out, "--epochs", "0", "MODEL.INPUT_SIZE",
                       "(96, 160)", "TEST.BATCH_SIZE", "2", "MODEL.K", "8",
                       "MIXED_PRECISION", "False", "WORKERS", "2"]
                      + SMALL) == 0
    assert os.path.islink(os.path.join(out, "data", "nuscenes"))
    assert os.path.exists(os.path.join(raw, "annotations", "mini_val.json"))
    assert 0.0 <= _summary(out)["nd_score"] <= 1.0


def test_overrides_after_the_options_are_overrides():
    """The dotted overrides may follow the options (intermixed parsing: a
    plain ``parse_args`` leaves them unrecognized on some Python
    releases)."""
    from centerfusiondetect3d_tpu_torch.tools.rehearse import _parse

    args = _parse(["rehearse", "--out", "o", "--device", "cuda", "WORKERS",
                   "4", "--epochs", "3", "MODEL.K", "32"])
    assert (args.mode, args.src, args.out, args.device, args.epochs) == (
        "rehearse", None, "o", "cuda", 3)
    assert args.opts == ["WORKERS", "4", "MODEL.K", "32"]
    args = _parse(["to-native", "--out", "x", "model.pt"])
    assert (args.src, args.out, args.opts) == ("model.pt", "x", [])


@pytest.mark.parametrize("mode", ["to-torch", "to-native"])
def test_checkpoint_conversion_modes_say_there_is_nothing_to_convert(
        mode, capsys):
    assert tools.main([mode, "model.pt", "--out", "x"]) == 2
    assert ".pt files already" in capsys.readouterr().err
