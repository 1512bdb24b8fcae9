"""The port's KITTI interchange (``evaluation/kitti.py``,
``evaluation/kitti_export.py``) against the JAX package's.

- every function on seeded boxes, quaternions and calibrations: equal
  (both are the same float64 numpy arithmetic) and the label strings
  identical;
- ``nuscenes_gt_to_kitti`` on the same synthetic raw tables
  (``data/synthetic.py:make_synthetic_raw_tables``, every split the
  generator writes): the same tokens, and every label, calib, velodyne and
  ImageSets file bytewise JAX's;
- ``kitti_results_to_nuscenes`` on those files: the same submission, and
  its boxes back on the ground truth's global boxes (within the labels'
  two decimals);
- ``render_kitti``'s images bitwise JAX's, 3D and 2D;
- ``export_kitti`` of detection items: the same files.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_raw_tables)
from centerfusiondetect3d_tpu_torch.evaluation import kitti, kitti_export
from centerfusiondetect3d_tpu_torch.utils import quaternion as quat

jax_kitti = pytest.importorskip("centerfusiondetect3d_tpu.evaluation.kitti")
jax_export = pytest.importorskip(
    "centerfusiondetect3d_tpu.evaluation.kitti_export")
pytest.importorskip("cv2")

CLASS_NAMES = ["car", "truck", "bus", "trailer", "construction_vehicle",
               "pedestrian", "motorcycle", "bicycle", "traffic_cone",
               "barrier"]
SPLITS = {"mini_train": 3, "mini_val": 4}


def _boxes(seed, n=20):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        q = rng.randn(4)
        yield (rng.randn(3) * 10, rng.uniform(0.5, 5, 3), q / np.linalg.norm(q),
               rng.randn(4), rng.randn(3))


def _rot(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


def test_box_transforms_match_jax():
    rng = np.random.RandomState(0)
    for center, wlh, q, _, _ in _boxes(1):
        vc_q, vc_t = _rot(rng), rng.randn(3)
        for r0 in (None, _rot(rng)):
            got = kitti.box_nuscenes_to_kitti(center, wlh, q, vc_q, vc_t, r0)
            want = jax_kitti.box_nuscenes_to_kitti(center, wlh, q, vc_q,
                                                   vc_t, r0)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            back = kitti.box_kitti_to_nuscenes_lidar(*got, vc_q, vc_t, r0)
            for a, b in zip(back, jax_kitti.box_kitti_to_nuscenes_lidar(
                    *want, vc_q, vc_t, r0)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(back[0], center, atol=1e-9)
            np.testing.assert_array_equal(
                kitti.box_corners_camera(*got),
                jax_kitti.box_corners_camera(*want))
            assert kitti.yaw_camera_from_quat(got[2]) == \
                jax_kitti.yaw_camera_from_quat(want[2])


def test_projection_and_label_lines_match_jax():
    rng = np.random.RandomState(2)
    p2 = np.zeros((3, 4))
    p2[:3, :3] = [[800.0, 0, 640.0], [0, 800.0, 360.0], [0, 0, 1]]
    n_boxes = 0
    for center, wlh, q, bbox, _ in _boxes(3, 40):
        center = center + [0, 0, 12]
        for imsize in ((1280, 720), (200, 100)):
            got = kitti.project_kitti_box_to_image(center, wlh, q, p2, imsize)
            assert got == jax_kitti.project_kitti_box_to_image(
                center, wlh, q, p2, imsize)
            n_boxes += got is not None
        kw = dict(bbox_2d=tuple(bbox * 100), truncation=float(rng.rand()),
                  occlusion=int(rng.randint(0, 3)), alpha=float(rng.randn()))
        for score in (float("nan"), float(rng.rand())):
            line = kitti.box_to_string("car", center, wlh, 0.3, score=score,
                                       **kw)
            assert line == jax_kitti.box_to_string("car", center, wlh, 0.3,
                                                   score=score, **kw)
            got, want = (kitti.parse_label_line(line),
                         jax_kitti.parse_label_line(line))
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]))
    assert n_boxes > 10
    assert kitti.category_to_detection_name("vehicle.car") == "car"
    for name in ("animal", "car", "vehicle.bus.bendy", "nothing"):
        assert kitti.category_to_detection_name(name) == \
            jax_kitti.category_to_detection_name(name)


def test_calib_files_are_jax_bytewise(tmp_path):
    rng = np.random.RandomState(4)
    p2, vc, r0 = rng.randn(3, 4), rng.randn(4, 4), rng.randn(3, 3)
    for i, rect in enumerate((None, r0)):
        a, b = str(tmp_path / f"port{i}.txt"), str(tmp_path / f"jax{i}.txt")
        kitti.write_calib_file(a, p2, vc, rect)
        jax_kitti.write_calib_file(b, p2, vc, rect)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
        got, want = kitti.read_calib_file(a), jax_kitti.read_calib_file(b)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["P2"], p2, rtol=1e-12)


@pytest.fixture(scope="module")
def raw_tables(tmp_path_factory):
    return make_synthetic_raw_tables(str(tmp_path_factory.mktemp("raw")),
                                     SPLITS)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_trees(a, b):
    names = _tree(a)
    assert names == _tree(b) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n
    return names


@pytest.fixture(scope="module")
def exported(raw_tables, tmp_path_factory):
    out = tmp_path_factory.mktemp("kitti")
    tokens = {}
    for split in SPLITS:
        got = kitti.nuscenes_gt_to_kitti(raw_tables, "v1.0-mini", split,
                                         str(out / "port"), imsize=(400, 300))
        want = jax_kitti.nuscenes_gt_to_kitti(raw_tables, "v1.0-mini", split,
                                              str(out / "jax"),
                                              imsize=(400, 300))
        assert got == want
        tokens[split] = got
    return out, tokens


def test_gt_export_is_jax_bytewise(exported):
    out, tokens = exported
    names = _same_trees(out / "jax", out / "port")
    for split, n in SPLITS.items():
        assert len(tokens[split]) == n
        for sub in ("label_2", "calib", "velodyne"):
            assert sum(x.startswith(f"{split}/{sub}/") for x in names) == n
    labels = [n for n in names if "/label_2/" in n]
    lines = [line for n in labels
             for line in open(out / "port" / n).read().splitlines()]
    assert lines and all(len(line.split(" ")) == 15 for line in lines)


def test_submission_round_trip_equals_jax_and_ground_truth(exported,
                                                           raw_tables):
    from centerfusiondetect3d_tpu_torch.data.convert_nuscenes import (
        RawNuScenes)

    out, tokens = exported
    nusc = RawNuScenes(raw_tables, "v1.0-mini")
    for split in SPLITS:
        got = kitti.kitti_results_to_nuscenes(
            str(out / "port"), split, raw_tables, "v1.0-mini",
            out_path=str(out / f"port_{split}.json"))
        want = jax_kitti.kitti_results_to_nuscenes(
            str(out / "jax"), split, raw_tables, "v1.0-mini",
            out_path=str(out / f"jax_{split}.json"))
        assert got == want
        with open(out / f"port_{split}.json", "rb") as f, \
                open(out / f"jax_{split}.json", "rb") as g:
            assert f.read() == g.read()
        assert sorted(got["results"]) == sorted(tokens[split])
        n = 0
        for token, items in got["results"].items():
            gts = [a for a in nusc.anns_by_sample.get(token, [])
                   if kitti.category_to_detection_name(nusc.category[
                       nusc.instance[a["instance_token"]]["category_token"]]
                       ["name"])]
            for it in items:
                # the labels keep two decimals
                d = [np.abs(np.asarray(it["translation"])
                            - a["translation"]).max() for a in gts]
                assert min(d) < 0.03
                n += 1
        assert n > 0


@pytest.mark.parametrize("render_2d", [False, True])
def test_render_kitti_is_jax_bitwise(exported, tmp_path, render_2d):
    import cv2

    out, _ = exported
    for split in SPLITS:
        got = kitti.render_kitti(str(out / "port"), split,
                                 out_dir=str(tmp_path / "port"),
                                 render_2d=render_2d, imsize=(400, 300))
        want = jax_kitti.render_kitti(str(out / "jax"), split,
                                      out_dir=str(tmp_path / "jax"),
                                      render_2d=render_2d, imsize=(400, 300))
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in want]
        for a, b in zip(got, want):
            x, y = cv2.imread(a), cv2.imread(b)
            np.testing.assert_array_equal(x, y)
    cam = cv2.imread(got[1])
    assert cam.shape == (300, 400, 3) and (cam != 40).any()


def _detections(seed, n_images=3, n=6):
    rng = np.random.RandomState(seed)
    out = {}
    for img_id in range(1, n_images + 1):
        items = []
        for _ in range(n):
            it = {"class": float(rng.randint(1, 11)),
                  "score": float(rng.rand()),
                  "dimension": rng.uniform(0.5, 4, 3).astype(np.float32),
                  "location": (rng.randn(3) * 5 + [0, 0, 20]).astype(
                      np.float32),
                  "yaw": float(rng.uniform(-3, 3)),
                  "bbox": rng.uniform(0, 400, 4).astype(np.float32)}
            if rng.rand() < 0.5:
                it["alpha"] = float(rng.randn())
            items.append(it)
        out[img_id] = items
    return out


@pytest.mark.parametrize("conf_thresh", [0.0, 0.5, 2.0])
def test_export_kitti_is_jax_bytewise(tmp_path, conf_thresh):
    dets = _detections(5)
    for it in dets[1]:
        assert kitti_export.detection_to_kitti_line(it, CLASS_NAMES) == \
            jax_export.detection_to_kitti_line(it, CLASS_NAMES)
    n = kitti_export.export_kitti(dets, str(tmp_path / "port"), CLASS_NAMES,
                                  conf_thresh)
    assert n == jax_export.export_kitti(dets, str(tmp_path / "jax"),
                                        CLASS_NAMES, conf_thresh) == 3
    names = _same_trees(tmp_path / "jax", tmp_path / "port")
    assert names == ["000001.txt", "000002.txt", "000003.txt"]


def test_kitti_names_are_exported_like_jax():
    import centerfusiondetect3d_tpu.evaluation as jax_evaluation

    import centerfusiondetect3d_tpu_torch.evaluation as port_evaluation

    assert set(jax_evaluation.__all__) <= set(port_evaluation.__all__)
    assert port_evaluation.nuscenes_gt_to_kitti is kitti.nuscenes_gt_to_kitti
    assert quat.from_axis_angle([0, 0, 1], 0.0).tolist() == [1, 0, 0, 0]
