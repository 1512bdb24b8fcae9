"""``tools/profile_train_loader.py`` on the CPU, at the rehearsal's size:
its refusals, and one tiny run of a serial and a threaded variant with the
numpy warp, whose record holds every step, the item stages and the probe,
and which puts the C++ warp back afterwards."""

from __future__ import annotations

import json
import math

import pytest

from centerfusiondetect3d_tpu_torch.data import transforms
from centerfusiondetect3d_tpu_torch.tools import profile_train_loader as ptl


def test_refusals():
    with pytest.raises(SystemExit, match="only with --tiny"):
        ptl.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown variants"):
        ptl.main(["--device", "cpu", "--tiny", "--variants", "serial,bogus"])


def test_variants_name_every_setting():
    for name, spec in ptl.VARIANTS.items():
        assert set(spec) == set(ptl.BASE), name
        assert spec["waits_for"] in ("stream", "device")
        assert spec["warp"] in ("native", "numpy")


def test_tiny_run_records_each_variant(tmp_path):
    native_warp = transforms.warp_image_native
    out = tmp_path / "study.json"
    assert ptl.main(["--device", "cpu", "--tiny", "--items", "8", "--steps",
                     "1", "--epochs", "2", "--variants",
                     "serial,threads4-numpy", "--json", str(out)]) == 0
    assert transforms.warp_image_native is native_warp
    report = json.loads(out.read_text())
    assert report["batch"] == 4 and report["items"] == 8
    (rnd,) = report["rounds"]
    assert set(rnd) == {"serial", "threads4-numpy"}
    for name, rec in rnd.items():
        assert rec["spec"] == ptl.VARIANTS[name]
        assert [ep["frozen"] for ep in rec["epochs"]] == [True, False]
        for ep in rec["epochs"]:
            assert ep["steps"] == 1 and math.isfinite(ep["totals"][0])
            assert ep["wall_s"] >= ep["sum_step_s"] > 0
        assert rec["item_ms"]["items"] >= 4
        assert rec["item_ms"]["warp"] > 0
        assert rec["lock_probe_late_ms"]["samples"] > 0
