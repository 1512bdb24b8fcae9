"""The port's synthetic generators (``data/synthetic.py``) against the JAX
package's: with the same seeds and sizes, every table is equal and every
written file (JSON tables, JPEGs, radar PCDs, lidar bins, converter-format
pickles) is bytewise the same."""

from __future__ import annotations

import filecmp
import json
import os

import pytest

from centerfusiondetect3d_tpu_torch.data import synthetic as port

jax_synthetic = pytest.importorskip("centerfusiondetect3d_tpu.data.synthetic")
pytest.importorskip("cv2")  # both write their JPEGs with opencv


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_trees(a, b):
    names = _files(a)
    assert names == _files(b)
    assert names
    differ = [n for n in names if not filecmp.cmp(
        os.path.join(a, n), os.path.join(b, n), shallow=False)]
    assert differ == []
    for n in names:
        if n.endswith(".json"):
            with open(os.path.join(a, n)) as f, open(os.path.join(b, n)) as g:
                assert json.load(f) == json.load(g)
    return names


@pytest.mark.parametrize("splits,seed", [
    (None, 3), ({"mini_train": 4, "mini_val": 3}, 3),
    ({"mini_val": 2, "mini_train": 2}, 11)])
def test_raw_tables_match_jax(tmp_path, splits, seed):
    for name, module in (("port", port), ("jax", jax_synthetic)):
        assert module.make_synthetic_raw_tables(
            str(tmp_path / name), splits, seed=seed) == str(tmp_path / name)
    names = _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert "v1.0-mini/sample_annotation.json" in names


@pytest.mark.parametrize("seed,img_wh", [(7, (448, 256)), (2, (320, 192))])
def test_campaign_tables_match_jax(tmp_path, seed, img_wh):
    splits = {"mini_train": 10, "mini_val": 4}
    for name, module in (("port", port), ("jax", jax_synthetic)):
        module.make_campaign_tables(str(tmp_path / name), splits, seed=seed,
                                    img_wh=img_wh)
    names = _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sum(n.endswith(".jpg") for n in names) == 14


def test_converter_format_set_matches_jax(tmp_path):
    kw = dict(n_samples=3, img_wh=(96, 64), n_objects=2, n_radar=12, seed=4)
    got = port.make_synthetic_nuscenes(str(tmp_path / "port"), **kw)
    want = jax_synthetic.make_synthetic_nuscenes(str(tmp_path / "jax"), **kw)
    assert got == str(tmp_path / "port" / "nuscenes")
    assert want == str(tmp_path / "jax" / "nuscenes")
    _same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_radar_pcd_writer_matches_jax(tmp_path):
    rows = [port.radar_point(1.0, 2.0, 3.0), port.radar_point(-4.5, 0.25,
                                                              17.0, 0, 0)]
    port.write_radar_pcd(str(tmp_path / "a.pcd"), rows)
    jax_synthetic.write_radar_pcd(str(tmp_path / "b.pcd"), rows)
    assert filecmp.cmp(tmp_path / "a.pcd", tmp_path / "b.pcd", shallow=False)
