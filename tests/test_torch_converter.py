"""The port's nuScenes converter (``data/convert_nuscenes.py``) against the
committed campaign annotations and the JAX package's converter.

On a temporary copy of ``output/campaign_r5/data/nuscenes``'s raw tables
and samples, the port's ``export_split`` of ``mini_train`` and
``mini_val`` must give the committed ``annotations/*.json`` (equal as
parsed JSON: every float the same double) and every radar and lidar
``.bin`` bytewise, and so must the JAX converter on another copy. The
point-cloud readers round-trip ascii and binary radar PCDs and lidar bins
as JAX's do.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.data import convert_nuscenes as port
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    radar_point, write_radar_pcd)

jax_convert = pytest.importorskip(
    "centerfusiondetect3d_tpu.data.convert_nuscenes")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(REPO, "output", "campaign_r5", "data", "nuscenes")
SPLITS = ("mini_train", "mini_val")


def _copy_raw(dst):
    for name in ("v1.0-mini", "samples"):
        shutil.copytree(os.path.join(CAMPAIGN, name), os.path.join(dst, name))
    return dst


def _bins(root):
    out = []
    for kind in ("radar_pc", "lidar_pc"):
        base = os.path.join(root, "annotations", kind)
        for cam in sorted(os.listdir(base)):
            out += [os.path.join(kind, cam, f)
                    for f in sorted(os.listdir(os.path.join(base, cam)))]
    return out


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    roots = {}
    for name, module in (("port", port), ("jax", jax_convert)):
        root = _copy_raw(str(tmp_path_factory.mktemp(name) / "nuscenes"))
        for split in SPLITS:
            module.export_split(root, split, verbose=False)
        roots[name] = root
    return roots


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("against", ["committed", "jax"])
def test_annotations_equal(converted, split, against):
    with open(os.path.join(converted["port"], "annotations",
                           f"{split}.json")) as f:
        got = json.load(f)
    root = CAMPAIGN if against == "committed" else converted[against]
    with open(os.path.join(root, "annotations", f"{split}.json")) as f:
        want = json.load(f)
    assert got == want
    assert len(got["images"]) == {"mini_train": 400, "mini_val": 100}[split]


@pytest.mark.parametrize("against", ["committed", "jax"])
def test_point_cloud_files_bytewise(converted, against):
    root = CAMPAIGN if against == "committed" else converted[against]
    names = _bins(root)
    assert len(names) == 1000
    assert _bins(converted["port"]) == names
    differ = [n for n in names if not filecmp.cmp(
        os.path.join(converted["port"], "annotations", n),
        os.path.join(root, "annotations", n), shallow=False)]
    assert differ == []


def test_scene_splits_match_jax():
    assert port.scene_splits() == jax_convert.scene_splits()


def test_read_radar_pcd_ascii_round_trip(tmp_path):
    rows = [radar_point(2.0, 0.5, 10.0), radar_point(-3.0, 0.2, 22.0, 0, 0),
            radar_point(1.25, -0.75, 33.5, -1.5, 2.25)]
    path = str(tmp_path / "r.pcd")
    write_radar_pcd(path, rows)
    got = port.read_radar_pcd(path)
    assert got.shape == (18, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_convert.read_radar_pcd(path))
    np.testing.assert_allclose(got.T, np.asarray(rows), atol=1e-6)


def test_read_radar_pcd_binary_round_trip(tmp_path):
    fields = ["x", "y", "z", "dyn_prop", "id"]
    rng = np.random.RandomState(0)
    dtype = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                      ("dyn_prop", "i1"), ("id", "u2")])
    data = np.zeros(7, dtype)
    for name in ("x", "y", "z"):
        data[name] = rng.randn(7)
    data["dyn_prop"] = rng.randint(-3, 4, 7)
    data["id"] = rng.randint(0, 500, 7)
    header = "\n".join([
        "VERSION 0.7", "FIELDS " + " ".join(fields), "SIZE 4 4 4 1 2",
        "TYPE F F F I U", "COUNT 1 1 1 1 1", "WIDTH 7", "HEIGHT 1",
        "POINTS 7", "DATA binary"]) + "\n"
    path = str(tmp_path / "b.pcd")
    with open(path, "wb") as f:
        f.write(header.encode() + data.tobytes())
    got = port.read_radar_pcd(path)
    np.testing.assert_array_equal(got, jax_convert.read_radar_pcd(path))
    np.testing.assert_array_equal(got[4], data["id"])


def test_read_lidar_bin_round_trip(tmp_path):
    scan = np.random.RandomState(1).randn(9, 5).astype(np.float32)
    path = str(tmp_path / "l.pcd.bin")
    scan.tofile(path)
    got = port.read_lidar_bin(path)
    np.testing.assert_array_equal(got, scan[:, :4].T)
    np.testing.assert_array_equal(got, jax_convert.read_lidar_bin(path))
