"""The port's frustum, decode, post-process, radar paint and serving
pre-process against the executed torch goldens and the JAX package.

Tolerances are those of the JAX package's own golden tests (frustum 1e-6 per
case and 1e-5 for the full chain, decode 1e-4, post-process rtol 2e-4 / atol
5e-3, pre-process 1e-4); the radar paint is compared bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.radar import (
    paint_rows_host,
    prepare_radar_points,
    process_point_cloud,
    process_point_cloud_rows,
)
from centerfusiondetect3d_tpu_torch.geometry.affine import (
    get_affine_transform,
)
from centerfusiondetect3d_tpu_torch.ops.decode import fusion_decode
from centerfusiondetect3d_tpu_torch.ops.frustum import (
    frustum_association,
    get_pc_frustum_heatmap,
)
from centerfusiondetect3d_tpu_torch.ops.postprocess import post_process
from centerfusiondetect3d_tpu_torch.ops.rasterize import (
    paint_rects_device_batch,
)
from centerfusiondetect3d_tpu_torch.runtime.detector import Detector

# the JAX package and what it imports (jax, flax, pyyaml); the card's
# machine has none of them and runs only this repo's -m cuda tests
jnp = pytest.importorskip("jax.numpy")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_radar = pytest.importorskip("centerfusiondetect3d_tpu.data.radar")
jax_decode = pytest.importorskip("centerfusiondetect3d_tpu.ops.decode")
jax_frustum = pytest.importorskip("centerfusiondetect3d_tpu.ops.frustum")
jax_rasterize = pytest.importorskip("centerfusiondetect3d_tpu.ops.rasterize")

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    return np.load(os.path.join(FIXTURES, name))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- frustum


def test_frustum_cases_golden_individual():
    g = _load("frustum_cases.npz")
    for i in range(len(g["bboxes"])):
        got = frustum_association(
            _t(g["pc_dep"][None]), _t(g["depths"][None, i:i + 1]),
            _t(g["bboxes"][None, i:i + 1]), _t(g["threshs"][None, i:i + 1]),
            float(g["max_dist"]))[0]
        np.testing.assert_allclose(got.numpy(), g["out_single"][i],
                                   atol=1e-6, err_msg=f"case {i}")


def test_frustum_cases_golden_sequential_overwrite():
    g = _load("frustum_cases.npz")
    got = frustum_association(_t(g["pc_dep"][None]), _t(g["depths"][None]),
                              _t(g["bboxes"][None]), _t(g["threshs"][None]),
                              float(g["max_dist"]))[0]
    np.testing.assert_allclose(got.numpy(), g["out_sequential"], atol=1e-6)


def test_frustum_full_golden_topk_chain():
    g = _load("frustum_full.npz")
    k, max_dist = int(g["meta"][0]), float(g["meta"][1])
    output = {n: _t(g[n]) for n in ("heatmap", "widthHeight", "depth",
                                    "dimension", "rotation")}
    got = get_pc_frustum_heatmap(output, _t(g["pc_dep"]), _t(g["calib"]), k,
                                 max_dist)
    np.testing.assert_allclose(got.numpy(), g["out_pc_hm"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_frustum_chain_matches_jax(seed):
    """Random first-stage heads with heatmap ties (clamped plateaus) and boxes
    crossing every border: the same peaks, windows and paint as JAX."""
    rng = np.random.RandomState(seed)
    b, h, w, k = 2, 20, 28, 30
    heat = rng.rand(b, 10, h, w).astype(np.float32)
    heat[heat > 0.9] = 0.95  # ties broken by index in both
    out = {
        "heatmap": heat,
        "widthHeight": (rng.rand(b, 2, h, w) * 14).astype(np.float32),
        "depth": rng.uniform(5, 40, (b, 1, h, w)).astype(np.float32),
        "dimension": rng.uniform(0.5, 5, (b, 3, h, w)).astype(np.float32),
        "rotation": rng.randn(b, 8, h, w).astype(np.float32),
    }
    pc_dep = np.zeros((b, 3, h, w), np.float32)
    hit = rng.rand(b, h, w) < 0.3
    pc_dep[:, 0][hit] = rng.uniform(1, 50, hit.sum())
    pc_dep[:, 1:][:, :, hit[0] | hit[1]] = 1.0
    calib = np.tile(np.array([[30.0, 0, w / 2, 0], [0, 30.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    want = jax_frustum.get_pc_frustum_heatmap(
        {n: nhwc(v) for n, v in out.items()}, nhwc(pc_dep),
        jnp.asarray(calib), k, 60.0, approx_topk=False)
    got = get_pc_frustum_heatmap({n: _t(v) for n, v in out.items()},
                                 _t(pc_dep), _t(calib), k, 60.0)
    assert float(got.abs().sum()) > 0
    np.testing.assert_allclose(
        got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)),
        atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- decode


def _layers(blob, n):
    layers = []
    for i in range(n):
        prefix = f"in{i}_"
        lay = {k[len(prefix):]: _t(blob[k]) for k in blob.files
               if k.startswith(prefix)}
        if lay:
            layers.append(lay)
    return layers


@pytest.mark.parametrize("name,nlayers", [
    ("decode_single_layer.npz", 1), ("decode_two_layer.npz", 2),
    ("decode_two_layer_unc.npz", 2)])
def test_fusion_decode_matches_reference(name, nlayers):
    blob = _load(name)
    h, w, k = (int(v) for v in blob["meta_hwk"])
    ret = fusion_decode(_layers(blob, nlayers), (h, w), k=k)
    for key in blob.files:
        if key.startswith("out_"):
            np.testing.assert_allclose(ret[key[4:]].numpy(), blob[key],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name}:{key}")


def test_fusion_decode_ties_match_jax_exact_topk():
    """After NMS most of the heatmap is exactly 0: with K larger than the
    number of peaks the tail is all ties, which both pick by index."""
    rng = np.random.RandomState(2)
    b, c, h, w, k = 2, 3, 12, 16, 150
    heads = {"heatmap": rng.rand(b, c, h, w).astype(np.float32),
             "reg": rng.randn(b, 2, h, w).astype(np.float32),
             "widthHeight": rng.rand(b, 2, h, w).astype(np.float32) * 9,
             "depth": rng.rand(b, 1, h, w).astype(np.float32) * 30,
             "rotation": rng.randn(b, 8, h, w).astype(np.float32),
             "dimension": rng.rand(b, 3, h, w).astype(np.float32) * 3}
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    want = jax_decode.fusion_decode([{n: nhwc(v) for n, v in heads.items()}],
                                    (h, w), k=k, approx_topk=False)
    got = fusion_decode([{n: _t(v) for n, v in heads.items()}], (h, w), k=k)
    assert float((got["scores"] == 0).float().mean()) > 0.2
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


# ----------------------------------------------------------- postprocess


@pytest.mark.parametrize("tag,drop_amodal,is_gt", [
    ("full", False, False), ("noamodal", True, False), ("gt", False, True)])
def test_postprocess_matches_reference(tag, drop_amodal, is_gt):
    g = _load("postprocess.npz")
    oh, ow = (int(v) for v in g["out_hw"])
    y = {k[3:]: _t(g[k]) for k in g.files if k.startswith("in_")
         and not (drop_amodal and k == "in_amodal_offset")}
    trans = get_affine_transform(g["center"], float(g["scale"]), 0, (ow, oh),
                                 inverse=True).astype(np.float32)
    out = post_process(y, trans, (oh, ow), _t(g["calib"]), is_gt=is_gt)
    # the per-image (B, 2, 3) form gives the same result
    out_b = post_process(y, np.stack([trans, trans]), (oh, ow), _t(g["calib"]),
                         is_gt=is_gt)
    compared = 0
    for key in g.files:
        if key.startswith(f"{tag}_"):
            name = key[len(tag) + 1:]
            want = g[key]
            for res in (out, out_b):
                got = res[name].numpy()
                np.testing.assert_allclose(got, want.reshape(got.shape),
                                           rtol=2e-4, atol=5e-3,
                                           err_msg=f"{tag}:{name}")
            compared += 1
    assert compared >= 10, compared


# ------------------------------------------------------------ radar paint


def _random_rows(rng, n, h, w):
    y1 = rng.randint(0, h, n)
    x1 = rng.randint(0, w, n)
    boxes = np.stack([y1, np.minimum(y1 + rng.randint(0, h // 2, n), h), x1,
                      np.minimum(x1 + rng.randint(0, w // 2, n), w)], 1)
    return boxes.astype(np.int32), rng.randn(n, 3).astype(np.float32)


@pytest.mark.parametrize("n,chunk", [(200, 64), (37, 16), (0, 128)])
def test_device_paint_bitexact_with_host_paint(n, chunk):
    rng = np.random.RandomState(n)
    h, w = 28, 50
    rows = [_random_rows(rng, n, h, w) for _ in range(2)]
    if n >= 100:  # duplicated boxes with new values exercise the order
        for boxes, _ in rows:
            boxes[50:100] = boxes[:50]
    pad = np.zeros((2, 8, 4), np.int32)  # all-zero padding covers nothing
    boxes = np.concatenate([np.stack([r[0] for r in rows]), pad], axis=1)
    values = np.concatenate([np.stack([r[1] for r in rows]),
                             rng.randn(2, 8, 3).astype(np.float32)], axis=1)
    dev = paint_rects_device_batch(_t(boxes), _t(values), (h, w),
                                   chunk=chunk).numpy()
    for i in range(2):
        host = paint_rows_host(boxes[i], values[i], (h, w))
        np.testing.assert_array_equal(dev[i], np.transpose(host, (2, 0, 1)))
        np.testing.assert_array_equal(
            host, jax_radar.paint_rows_host(boxes[i], values[i], (h, w)))
        np.testing.assert_array_equal(dev[i], np.transpose(np.asarray(
            jax_rasterize.paint_rects_device(boxes[i], values[i], (h, w))),
            (2, 0, 1)))


@pytest.mark.parametrize("method", ["pillars", "heatmap", "points"])
def test_radar_rows_and_host_raster_match_jax(method):
    opts = ["MODEL.INPUT_SIZE", "(64, 128)", "DATASET.PC_ROI_METHOD",
            f"'{method}'"]
    cfg, jcfg = load_config(opts=opts), jax_load_config(opts=opts)
    rng = np.random.RandomState(3)
    n = 40
    pc_2d = np.stack([rng.rand(n) * 600 + 10, rng.rand(n) * 330 + 10,
                      rng.rand(n) * 55 + 2]).astype(np.float32)
    pc_3d = rng.randn(18, n).astype(np.float32)
    pc_3d[2] = pc_2d[2]
    trans_out = np.array([[0.2, 0, 0], [0, 0.2, -1.0]], np.float32)
    calib = np.array([[120.0, 0, 16, 0], [0, 120.0, 8, 0], [0, 0, 1, 0]],
                     np.float32)
    got = process_point_cloud_rows(pc_2d, pc_3d, cfg, trans_out, calib)
    want = jax_radar.process_point_cloud_rows(pc_2d, pc_3d, jcfg, trans_out,
                                              calib)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    raster = process_point_cloud(pc_2d, pc_3d, cfg, trans_out, calib)[2]
    np.testing.assert_array_equal(
        raster, jax_radar.process_point_cloud(pc_2d, pc_3d, jcfg, trans_out,
                                              calib)[2])
    np.testing.assert_array_equal(
        raster, paint_rows_host(got[2], got[3], cfg.MODEL.OUTPUT_SIZE))


def test_prepare_radar_points_matches_jax():
    cfg, jcfg = load_config(), jax_load_config()
    rng = np.random.RandomState(4)
    n = 300
    radar = np.zeros((18, n), np.float32)
    radar[2] = rng.uniform(1, 70, n)
    radar[0] = rng.uniform(-0.7, 0.7, n) * radar[2]
    radar[1] = rng.uniform(-1, 2, n)
    radar[8:10] = rng.randn(2, n)
    calib = np.array([[1266.0, 0, 800, 0], [0, 1266.0, 450, 0], [0, 0, 1, 0]],
                     np.float32)
    info = {"calib": calib.tolist(), "camera_intrinsic": calib[:3, :3].tolist(),
            "width": 1600, "height": 900}
    trans = get_affine_transform(np.array([800, 450], np.float32), 1600.0, 0,
                                 (200, 112))
    for rows in (True, False):
        got = prepare_radar_points(radar, info, cfg, trans, return_paint=rows)
        want = jax_radar.prepare_radar_points(radar, info, jcfg, trans,
                                              return_paint=rows)
        assert int(got[1]) == int(want[1]) > 0
        for a, b in zip(got[2] if rows else [got[2]],
                        want[2] if rows else [want[2]]):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- pre-process


@pytest.mark.parametrize("tag,z_offset", [("plain", 0.0), ("zoff", 0.5)])
def test_detector_preprocess_matches_reference(tag, z_offset):
    g = _load("detector_preprocess.npz")
    H, W, ih, iw, oh, ow = (int(v) for v in g["meta"])
    cfg = load_config(opts=["MODEL.INPUT_SIZE", f"({ih}, {iw})",
                            "MODEL.DLA.NODE", "Conv",
                            "DATASET.PC_Z_OFFSET", str(z_offset),
                            "DATASET.MAX_PC_DIST", "60"], num_classes=10)
    det = Detector(cfg, device="cpu")
    calib = g[f"{tag}_calib"]
    infos = [{"calib": calib.tolist(),
              "camera_intrinsic": calib[:3, :3].tolist(),
              "width": W, "height": H} for _ in range(2)]
    batch, metas = det.pre_process(
        [g[f"{tag}_img0"].copy(), g[f"{tag}_img1"].copy()], infos,
        [g[f"{tag}_radar0"].copy(), g[f"{tag}_radar1"].copy()])

    image = _t(batch["image"]).permute(0, 3, 1, 2).float()
    norm = ((image / 255.0 - det.mean) / det.std).numpy()
    np.testing.assert_allclose(norm, g[f"{tag}_out_images"], atol=1e-4)
    pc_dep = paint_rects_device_batch(_t(batch["pc_boxes"]),
                                      _t(batch["pc_values"]), (oh, ow))
    np.testing.assert_allclose(pc_dep.numpy(), g[f"{tag}_out_pc_deps"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(batch["calib"], g[f"{tag}_out_calibs"],
                               atol=1e-5)
