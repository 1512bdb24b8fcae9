"""The harness finds every piece by name, and BENCHMARK.json agrees with
the files under cfbench/."""

import json
import shutil

import pytest

from cfbench_tiny import harness


def spec():
    return harness.benchmark_spec()


def test_every_cell_config_loop_and_metric_is_found_by_name():
    s = spec()
    for cell in s["workloads"]:
        wl = harness.load_workload(cell["name"])
        assert wl["config"] == cell["config"]
        assert hasattr(harness.load_module("traffic", wl["loop"]), "setup")
    for c in s["configs"]:
        assert c["file"] == f"cfbench/configs/{c['name']}.json"
        assert harness.load_json("configs", c["name"])["reduced"] == c["reduced"]
    for m in s["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path,
                                                         monkeypatch):
    bench = tmp_path / "cfbench"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((bench / "workloads" / "middle_serve_b24.json").read_text())
    wl["params"]["samples_per_batch"] = 8
    (bench / "workloads" / "middle_serve_b48.json").write_text(json.dumps(wl))
    (bench / "metrics" / "new_metric.serve.py").write_text(
        "UNIT = 'ms'\n\ndef read(run, summary):\n    return 1.5\n")
    monkeypatch.setattr(harness, "BENCH_DIR", bench)
    assert harness.load_workload("middle_serve_b48")["params"][
        "samples_per_batch"] == 8
    assert harness.load_module("metrics", "new_metric.serve").read(
        None, None) == 1.5


def test_names_outside_the_rule_are_refused():
    for bad in ("../run", "a b", "x/y", ""):
        with pytest.raises(ValueError):
            harness.load_json("workloads", bad)


def test_metrics_listed_only_where_their_end_to_end_metric_is_reported():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    cells = [w["name"] for w in s["workloads"]]
    for m in s["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        chosen = harness.metrics_of(s, cell, [m for m in e2e])
        assert any(m["name"] == "setup_s" for m in chosen["end_to_end"])
        assert len(chosen["end_to_end"]) >= 2 and chosen["per_layer"]


def test_every_cell_has_a_limit_for_each_of_its_numbers():
    for cell in spec()["workloads"]:
        wl = harness.load_workload(cell["name"])
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
