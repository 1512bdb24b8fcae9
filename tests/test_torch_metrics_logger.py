"""The port's ``utils/metrics_logger.py`` on the JAX package's four cases
(``tests/test_metrics_logger.py``: events and resume, the wandb mirror with
a stub, wandb absent, an API key alone), and the same events as JAX's
logger for the same calls, apart from the time stamps."""

from __future__ import annotations

import json
import sys
import types

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.utils.metrics_logger import MetricsLogger

jax_metrics_logger = pytest.importorskip(
    "centerfusiondetect3d_tpu.utils.metrics_logger")


def _events(path):
    with open(path / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_jsonl_events_and_resume(tmp_path):
    m = MetricsLogger(str(tmp_path))
    m.scalars({"loss": np.float32(1.5)}, step=0, prefix="train/")
    m.alert("too hot")
    m.summary({"NDS": 0.45})
    events = _events(tmp_path)
    assert events[0]["train/loss"] == 1.5 and events[0]["step"] == 0
    assert events[1]["kind"] == "alert"
    with open(tmp_path / "run_state.json") as f:
        assert json.load(f)["summary"] == {"NDS": 0.45}
    # resume keeps the persisted run id (reference logger.py:435-448)
    assert MetricsLogger(str(tmp_path), resume=True).run_id == m.run_id
    assert not list(tmp_path.glob("*.tmp"))


def test_wandb_mirror_with_stub(tmp_path, monkeypatch):
    calls = {"init": [], "log": [], "summary": {}}

    class _Run:
        def __init__(self):
            self.summary = types.SimpleNamespace(
                update=lambda d: calls["summary"].update(d))

        def log(self, payload, step=None):
            calls["log"].append((payload, step))

    stub = types.ModuleType("wandb")

    def _init(**kw):
        calls["init"].append(kw)
        return _Run()

    stub.init = _init
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("WANDB_PROJECT", "unit")
    m = MetricsLogger(str(tmp_path))
    assert calls["init"] == [{"project": "unit", "id": m.run_id,
                              "resume": "allow"}]
    m.scalars({"loss": 2.0, "note": float("nan")}, step=3)
    payload, step = calls["log"][0]
    assert payload["loss"] == 2.0 and step == 3
    m.summary({"NDS": 0.4})
    assert calls["summary"] == {"NDS": 0.4}
    assert (tmp_path / "metrics.jsonl").exists()


def test_wandb_mirror_only_on_rank_zero(tmp_path, monkeypatch):
    stub = types.ModuleType("wandb")

    def _boom(**kw):
        raise AssertionError("wandb.init called on rank 1")

    stub.init = _boom
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("WANDB_PROJECT", "unit")
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert MetricsLogger(str(tmp_path))._wandb is None


def test_wandb_absent_is_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_PROJECT", "unit")
    monkeypatch.setitem(sys.modules, "wandb", None)  # import -> ImportError
    m = MetricsLogger(str(tmp_path))
    assert m._wandb is None
    m.scalars({"x": 1.0})


def test_wandb_not_hijacked_by_api_key_alone(tmp_path, monkeypatch):
    stub = types.ModuleType("wandb")

    def _boom(**kw):
        raise AssertionError("wandb.init called without WANDB_PROJECT")

    stub.init = _boom
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.delenv("WANDB_PROJECT", raising=False)
    monkeypatch.setenv("WANDB_API_KEY", "secret")
    m = MetricsLogger(str(tmp_path))
    assert m._wandb is None
    m.scalars({"loss": 1.0}, step=0)


def test_same_events_and_state_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("WANDB_PROJECT", raising=False)
    loggers = {
        "port": MetricsLogger(str(tmp_path / "port"), run_id="r1"),
        "jax": jax_metrics_logger.MetricsLogger(str(tmp_path / "jax"),
                                                run_id="r1"),
    }
    for m in loggers.values():
        m.scalars({"total": np.float32(2.5), "hm": 0.25}, step=1,
                  prefix="train/")
        m.scalars({"lr": 1e-4, "epoch_sec": 3.5}, step=1)
        m.scalars({"total": np.float64(7.0)}, prefix="val/")
        m.alert("hot", level="error")
        m.log("custom", {"arr": np.arange(3), "nested": {"a": np.int64(2)}},
              step=4)
        m.summary({"range_all": {"nd_score": np.float64(0.3),
                                 "per": [np.float32(1.0)]}})
    events = {}
    for name in loggers:
        events[name] = _events(tmp_path / name)
        for event in events[name]:
            assert event.pop("ts") > 0
    assert events["port"] == events["jax"]
    states = {}
    for name in loggers:
        with open(tmp_path / name / "run_state.json") as f:
            states[name] = json.load(f)
            assert states[name].pop("started") > 0
    assert states["port"] == states["jax"]
