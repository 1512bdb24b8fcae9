"""The port's renderers (``utils/visualize.py``) and ``project_3d_points``
against the JAX package's.

- ``project_3d_points`` (torch) and ``project_3d_points_np`` against JAX's
  on numpy and jax.numpy (1e-5 relative: float32 einsums in different
  orders) and against ``geometry.npz``'s ``ddd_proj2d`` (the golden's
  rtol 1e-4, atol 1e-2);
- each renderer bitwise JAX's on the same seeded image and items (both
  draw with the same cv2 here): ``draw_box_3d``, ``pc_heatmap_overlay``
  (a 2-D map, an NHWC map as JAX takes it, and the port's NCHW map against
  JAX's NHWC one), ``box3d_overlay``, ``bev_gt_vs_pred`` and the four
  files of ``debug_pillars``;
- ``ValVisualizer``'s PNGs bytewise JAX's on a synthetic nuScenes
  directory (``data/synthetic.py:make_synthetic_nuscenes``): the port warps
  the image with ``warp_image_native`` where JAX calls ``cv2.warpAffine``,
  bitwise equal on this affine.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_nuscenes)
from centerfusiondetect3d_tpu_torch.geometry import (project_3d_points,
                                                     project_3d_points_np)
from centerfusiondetect3d_tpu_torch.utils import visualize as port

cv2 = pytest.importorskip("cv2")
jnp = pytest.importorskip("jax.numpy")
jax_geometry = pytest.importorskip("centerfusiondetect3d_tpu.geometry")
jax_viz = pytest.importorskip("centerfusiondetect3d_tpu.utils.visualize")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_dataset = pytest.importorskip("centerfusiondetect3d_tpu.data.dataset")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CALIB = np.array([[400.0, 0, 80, 0], [0, 400.0, 48, 0], [0, 0, 1, 0]],
                 np.float32)


def _img(seed=0, h=96, w=160):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _items(seed, n=12, scored=True):
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        it = {"dimension": [1.4 + rng.rand(), 1.6 + rng.rand() * 0.4,
                            3.5 + rng.rand() * 2],
              "location": [float(rng.randn() * 4), float(rng.rand()),
                           float(rng.uniform(-5, 40))],
              "yaw": float(rng.uniform(-np.pi, np.pi))}
        if scored:
            it["score"] = float(rng.rand())
        items.append(it)
    return items


def test_project_3d_points_matches_jax_and_golden():
    rng = np.random.RandomState(0)
    pts = (rng.randn(2, 5, 8, 3) + [0, 0, 12]).astype(np.float32)
    calib = np.broadcast_to(
        (CALIB + rng.randn(3, 4).astype(np.float32) * 0.01)[None, None],
        (2, 5, 3, 4)).astype(np.float32)
    want = jax_geometry.project_3d_points(pts, calib)
    want_j = np.asarray(jax_geometry.project_3d_points(
        jnp.asarray(pts), jnp.asarray(calib), xp=jnp))
    got_np = project_3d_points_np(pts, calib)
    got_t = project_3d_points(torch.from_numpy(pts),
                              torch.from_numpy(calib)).numpy()
    for got in (got_np, got_t):
        assert got.shape == (2, 5, 8, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_np, want)
    g = np.load(os.path.join(FIXTURES, "geometry.npz"))
    b, k = g["ddd_dim"].shape[:2]
    calib_bk = np.ascontiguousarray(np.broadcast_to(g["ddd_calib"][:, None],
                                                    (b, k, 3, 4)))
    proj = project_3d_points(torch.from_numpy(g["ddd_corners"]),
                             torch.from_numpy(calib_bk)).numpy()
    np.testing.assert_allclose(proj, g["ddd_proj2d"], rtol=1e-4, atol=1e-2)


def test_draw_box_3d_is_jax_bitwise():
    rng = np.random.RandomState(1)
    for _ in range(5):
        corners = rng.uniform(-20, 180, (8, 2))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        a = jax_viz.draw_box_3d(_img(), corners, color)
        b = port.draw_box_3d(_img(), corners, color)
        np.testing.assert_array_equal(a, b)
        assert (b != _img()).any()


def test_pc_heatmap_overlay_is_jax_bitwise():
    rng = np.random.RandomState(2)
    hm = np.zeros((24, 40, 3), np.float32)
    hit = rng.rand(24, 40) < 0.2
    hm[..., 0][hit] = rng.uniform(-0.2, 1.3, hit.sum())
    img = _img()
    for want, got in (
            (jax_viz.pc_heatmap_overlay(img, hm[..., 0]),
             port.pc_heatmap_overlay(img, hm[..., 0])),
            (jax_viz.pc_heatmap_overlay(img, hm),
             port.pc_heatmap_overlay(img, hm)),
            (jax_viz.pc_heatmap_overlay(img, hm[..., :1]),
             port.pc_heatmap_overlay(img, np.transpose(hm[..., :1], (2, 0, 1)),
                                     channels_first=True))):
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def test_box3d_overlay_is_jax_bitwise():
    trans = np.array([[0.9, 0.05, 3.0], [-0.02, 0.8, 5.0]], np.float32)
    for thresh in (-1.0, 0.3):
        for scored in (True, False):
            items = _items(3, scored=scored)
            want = jax_viz.box3d_overlay(_img(), items, CALIB, trans,
                                         conf_thresh=thresh)
            got = port.box3d_overlay(_img(), items, CALIB, trans,
                                     conf_thresh=thresh)
            np.testing.assert_array_equal(got, want)
            assert (got != _img()).any()


def test_bev_gt_vs_pred_is_jax_bitwise():
    rng = np.random.RandomState(4)
    radar = np.zeros((18, 60), np.float32)
    radar[0] = rng.randn(60) * 20
    radar[2] = rng.uniform(-10, 130, 60)
    gt, pred = _items(5, scored=False), _items(6)
    for radar_pc in (None, radar, np.zeros((18, 0), np.float32)):
        want = jax_viz.bev_gt_vs_pred(gt, pred, radar_pc=radar_pc)
        got = port.bev_gt_vs_pred(gt, pred, radar_pc=radar_pc)
        np.testing.assert_array_equal(got, want)
    assert (got == np.array(port.GT_COLOR)).all(-1).any()
    assert (got == np.array(port.PRED_COLOR)).all(-1).any()


def test_debug_pillars_files_are_jax_bitwise(tmp_path):
    rng = np.random.RandomState(5)
    n = 30
    pc_2d = np.stack([rng.uniform(0, 40, n), rng.uniform(0, 24, n),
                      rng.uniform(-5, 70, n)]).astype(np.float32)
    pillar_wh = rng.uniform(0.5, 6, (2, n)).astype(np.float32)
    trans_in = np.array([[0.4, 0, 0], [0, 0.4, 0]], np.float32)
    args = (_img(), pc_2d, pillar_wh, trans_in, trans_in / 4.0, (96, 160),
            (24, 40))
    want = jax_viz.debug_pillars(*args, str(tmp_path / "jax"), index=3)
    got = port.debug_pillars(*args, str(tmp_path / "port"), index=3)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        "3_pillarInput2D.jpg", "3_pillarOutput2D.jpg",
        "3_pillarInputOverlay.jpg", "3_imgOrigin.jpg"]
    for a, b in zip(want, got):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), b


def test_normalize_depthmaps_matches_jax_on_nchw():
    m = np.random.RandomState(6).rand(2, 1, 24, 40).astype(np.float32)
    want = jax_viz.normalize_depthmaps({"d": np.transpose(m, (0, 2, 3, 1)),
                                        "none": None})
    got = port.normalize_depthmaps({"d": m, "none": None})
    assert set(got) == set(want) == {"d"}
    np.testing.assert_array_equal(got["d"], want["d"])


OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "DATASET.RADAR_PC", "True",
        "MODEL.FRUSTUM", "True", "MIXED_PRECISION", "False",
        "CONF_THRESH", "0.2"]


def test_val_visualizer_pngs_are_jax_bytewise(tmp_path):
    root = str(tmp_path / "data")
    make_synthetic_nuscenes(root, n_samples=2, img_wh=(160, 96))
    opts = OPTS + ["DATASET.ROOT", repr(root + "/")]
    jcfg = jax_config.load_config(opts=opts, num_classes=10)
    cfg = load_config(opts=opts, num_classes=10)
    jds = jax_dataset.NuScenesDataset(jcfg, "mini_val")
    ds = NuScenesDataset(cfg, "mini_val", device="cpu")
    img_id = ds.images[1]
    item = ds.get_item(1)
    target = item["pc_dep"][..., :1] / float(cfg.DATASET.MAX_PC_DIST)
    pred_hm = np.random.RandomState(7).rand(1, 16, 32).astype(np.float32)
    pred_hm[pred_hm < 0.7] = 0.0
    preds = _items(8)
    for it in preds:
        it["location"][2] = abs(it["location"][2]) + 2.0
    radar = item["pc_3d"].T
    outs = {}
    for name, viz, hm in (
            ("jax", jax_viz.ValVisualizer(str(tmp_path / "jax"), jcfg, jds),
             np.transpose(pred_hm, (1, 2, 0))),
            ("port", port.ValVisualizer(str(tmp_path / "port"), cfg, ds),
             pred_hm)):
        viz.add_ground_truth(img_id, target)
        viz.add_ground_truth(ds.images[0], target)  # the first one stays
        viz.add_predictions(ds.images[0], preds, pc_hm=hm, radar_pc=radar)
        viz.add_predictions(img_id, preds, pc_hm=hm, radar_pc=radar)
        outs[name] = viz.save(epoch=3)
        assert viz.image is None and viz.save(epoch=4) == []
    names = [os.path.basename(p) for p in outs["port"]]
    assert names == [os.path.basename(p) for p in outs["jax"]] == [
        "e0003_target_pc_hm.png", "e0003_target_box_3d.png",
        "e0003_pred_pc_hm.png", "e0003_pred_box_3d.png", "e0003_bev.png"]
    for a, b in zip(outs["jax"], outs["port"]):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), b
    drawn = cv2.imread(outs["port"][1])
    assert drawn.shape == (64, 128, 3)
