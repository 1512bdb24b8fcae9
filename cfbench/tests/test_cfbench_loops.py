"""Each traffic loop end to end at a tiny size on the CPU: a rehearsal
of a run that reports no device metric. The bf16 program is held to the
cells' limits only at their own sizes on the card; here the numbers have
to be finite and the float32 program (which the reference matches to
rounding) has to come out correct."""

import math
import subprocess
import sys

import pytest

from cfbench_tiny import CELLS, E2E, ROOT, harness, load, run_tiny


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name):
    r = run_tiny(name)
    wl = load(name)
    assert set(r["metrics"]) == set(E2E[wl["loop"]]) | {"setup_s"}
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert r["device"]["memory_peak_bytes"] == 0
    assert "busy_s" not in r["device"] and "breakdown" not in r
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(wl["limits"])
    assert all(math.isfinite(c["value"]) for c in r["checks"].values())


@pytest.mark.parametrize("name", ["centernet_train_b64"])
def test_training_rate_counts_the_share_of_the_last_step(name):
    wl = load(name)
    assert not wl["params"]["frozen"]  # so the DCN backward is checked
    r = run_tiny(name, seconds=3.0)
    counts = r["info"]["counts"]
    assert 0.0 <= counts["share_of_the_last"] <= 1.0
    assert r["metrics"]["train_images_per_s"]["value"] == pytest.approx(
        (counts["steps_in_window"] + counts["share_of_the_last"])
        * counts["images_a_step"] / 3.0)
    assert "dcn_bwd_rms" in r["checks"]


def test_a_run_that_is_not_a_cell_is_refused():
    out = subprocess.run([sys.executable, "cfbench/run.py", "--workload",
                          "middle_serve_b24", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "is not a cell of BENCHMARK.json" in out.stderr


@pytest.mark.parametrize("name", CELLS)
def test_float32_program_is_correct(name):
    r = run_tiny(name, float32=True)
    assert r["correct"], r["checks"]


def test_no_jax_and_no_jax_package_after_a_run():
    code = (
        "import sys; sys.path.insert(0, 'cfbench/tests');"
        "from cfbench_tiny import run_tiny, harness;"
        "run_tiny('middle_serve_b24', seconds=2.0);"
        "print('FORBIDDEN', harness.forbidden_modules());"
        "print('PORT', 'centerfusiondetect3d_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "centerfusiondetect3d_tpu_torch_x",
                        types.ModuleType("x"))
    assert "centerfusiondetect3d_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    assert "jax.numpy" in harness.forbidden_modules()


def test_the_command_refuses_without_a_card():
    cell = harness.benchmark_spec()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "cfbench/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if "no CUDA device" not in out.stderr:
        pytest.skip("a card is present: the refusal is not reachable")
    assert out.returncode != 0 and out.stdout.strip() == ""
