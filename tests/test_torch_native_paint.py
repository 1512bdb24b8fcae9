"""The port's C++ host kernels (``native/``) against their numpy plain
versions and the JAX package's ``native``, bitwise, and the radar pipeline
that calls the paint against JAX's; the C++ warp against numpy
``warp_image``.

Seeded boxes that reach past every edge of the map, one-hot channels, and
gaussian splats with centres outside the plane go through the port's
kernel, its plain version and JAX's kernel. ``process_point_cloud`` (C++
paint) must equal ``process_point_cloud_plain`` (the kernel's numpy plain
version) and JAX's ``process_point_cloud`` on the same cloud, for the pillar and
heatmap boxes, one-hot and not; ``paint_rows_host`` likewise. A build that
fails raises, in the kernel and in the radar pipeline alike. The call
counts hold under many threads.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch import native
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data import radar, transforms
from centerfusiondetect3d_tpu_torch.geometry.affine import get_affine_transform

jax_native = pytest.importorskip("centerfusiondetect3d_tpu.native")
jax_radar = pytest.importorskip("centerfusiondetect3d_tpu.data.radar")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config


@pytest.fixture(scope="module", autouse=True)
def jax_kernel_built():
    if jax_native.lib() is None:
        pytest.skip("the JAX package's native kernel did not build")


def _boxes(rng, n, h, w):
    """Boxes from well outside the map to well past it, some empty."""
    b = np.zeros((n, 4), np.int32)
    b[:, 0] = rng.randint(-6, h + 2, n)
    b[:, 1] = b[:, 0] + rng.randint(-2, 14, n)
    b[:, 2] = rng.randint(-6, w + 2, n)
    b[:, 3] = b[:, 2] + rng.randint(-2, 14, n)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paint_rects_bitwise(seed):
    rng = np.random.RandomState(seed)
    h, w, c, n = 30, 41, 3, 60
    boxes, values = _boxes(rng, n, h, w), rng.randn(n, c).astype(np.float32)
    got, plain, ref = (np.zeros((h, w, c), np.float32) for _ in range(3))
    native.paint_rects(got, boxes, values)
    native.paint_rects_plain(plain, boxes, values)
    assert jax_native.paint_rects(ref, boxes, values)
    assert (got != 0).any()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_paint_rects_channels_bitwise(seed):
    rng = np.random.RandomState(seed)
    h, w, c, n, k = 20, 25, 12, 40, 3
    boxes = _boxes(rng, n, h, w)
    values = rng.randn(n, k).astype(np.float32)
    layer = rng.randint(0, 4, n)
    channels = np.stack([layer, layer + 4, layer + 8], axis=1)
    got, plain, ref = (np.zeros((h, w, c), np.float32) for _ in range(3))
    native.paint_rects_channels(got, boxes, values, channels)
    native.paint_rects_channels_plain(plain, boxes, values, channels)
    assert jax_native.paint_rects_channels(ref, boxes, values, channels)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="channels outside"):
        native.paint_rects_channels(got, boxes, values, channels + 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_gaussians_bitwise(seed):
    rng = np.random.RandomState(seed)
    h, w, n = 28, 37, 25
    centers = np.stack([rng.uniform(-6, w + 6, n), rng.uniform(-6, h + 6, n)],
                       axis=1).astype(np.float32)
    radii = rng.randint(0, 8, (n, 2)).astype(np.int32)
    got, plain, ref = (np.zeros((h, w), np.float32) for _ in range(3))
    native.splat_gaussians(got, centers, radii)
    native.splat_gaussians_plain(plain, centers, radii)
    assert jax_native.splat_gaussians(ref, centers, radii)
    assert (got > 0).any()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)


def test_kernels_refuse_a_wrong_map():
    with pytest.raises(ValueError, match="float32"):
        native.paint_rects(np.zeros((4, 4, 3)), np.zeros((0, 4)),
                           np.zeros((0, 3)))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.splat_gaussians(np.zeros((4, 8), np.float32)[:, ::2],
                               np.zeros((0, 2)), np.zeros((0, 2)))
    with pytest.raises(ValueError, match="shape"):
        native.paint_rects(np.zeros((4, 4, 3), np.float32),
                           np.zeros((2, 4)), np.zeros((2, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_warp_bilinear_is_warp_image_bitwise(seed):
    """The C++ warp against its plain version, numpy ``warp_image``:
    seeded images of 1, 3 and 4 channels and 2-D ones, affines from the
    dataset's augmentation (shifted past the edges, scaled, rotated) and
    arbitrary ones."""
    rng = np.random.RandomState(seed)
    calls = native.warp_bilinear.calls
    for case in range(24):
        h, w = rng.randint(1, 120, 2)
        shape = (h, w) if case % 4 == 3 else (h, w, (1, 3, 4)[case % 3])
        img = rng.randint(0, 256, shape).astype(np.uint8)
        ow, oh = rng.randint(1, 100, 2)
        center = np.array([rng.uniform(-30, w + 30), rng.uniform(-30, h + 30)],
                          np.float32)
        trans = get_affine_transform(center, rng.uniform(0.2, 3) * max(h, w),
                                     rng.uniform(-45, 45), (ow, oh))
        if case % 5 == 0:
            trans = rng.randn(2, 3) * [[2, 2, 40], [2, 2, 40]]
        got = transforms.warp_image_native(img, trans, (ow, oh))
        want = transforms.warp_image(img, trans, (ow, oh))
        assert got.shape == want.shape == (oh, ow) + img.shape[2:]
        np.testing.assert_array_equal(got, want)
    assert native.warp_bilinear.calls == calls + 24


def test_warp_bilinear_refuses_wrong_arrays():
    src = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="uint8 source"):
        native.warp_bilinear(src.astype(np.float32), np.zeros(6),
                             np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="output"):
        native.warp_bilinear(src, np.zeros(6), np.zeros((2, 2, 1), np.uint8))
    with pytest.raises(ValueError, match="2x3"):
        native.warp_bilinear(src, np.zeros(4), np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        transforms.warp_image_native(src.astype(np.float32), np.eye(2, 3),
                                     (2, 2))


def _cloud(seed, n=70, max_dist=60.0):
    rng = np.random.RandomState(seed)
    pc_2d = np.zeros((3, n), np.float32)
    pc_2d[0] = rng.rand(n) * 640
    pc_2d[1] = rng.rand(n) * 360
    pc_2d[2] = rng.rand(n) * (max_dist - 2) + 1.5
    pc_3d = np.zeros((18, n), np.float32)
    pc_3d[0] = rng.randn(n) * 10
    pc_3d[1] = rng.rand(n)
    pc_3d[2] = pc_2d[2]
    pc_3d[8] = rng.randn(n)
    pc_3d[9] = rng.randn(n)
    return pc_2d, pc_3d


TRANS = np.array([[0.25, 0, 0], [0, 0.26, 0]], np.float64)
CALIB = np.array([[400.0, 0, 200, 0], [0, 400, 150, 0], [0, 0, 1, 0]],
                 np.float32)


@pytest.mark.parametrize("one_hot", [False, True])
@pytest.mark.parametrize("method", ["pillars", "heatmap"])
def test_process_point_cloud_matches_plain_and_jax(method, one_hot):
    opts = ["MODEL.INPUT_SIZE", "(96, 160)", "MIXED_PRECISION", "False",
            "DATASET.PC_ROI_METHOD", repr(method), "DATASET.ONE_HOT_PC",
            str(one_hot), "DATASET.MAX_PC_DIST", "20" if one_hot else "60",
            "MODEL.FRUSTUM", "False"]
    cfg = load_config(opts=opts, num_classes=10)
    jcfg = jax_load_config(opts=opts, num_classes=10)
    pc_2d, pc_3d = _cloud(3, max_dist=float(cfg.DATASET.MAX_PC_DIST))
    calls = native.paint_rects.calls + native.paint_rects_channels.calls
    got = radar.process_point_cloud(pc_2d, pc_3d, cfg, TRANS, CALIB)
    assert (native.paint_rects.calls + native.paint_rects_channels.calls
            == calls + 1)
    plain = radar.process_point_cloud_plain(pc_2d, pc_3d, cfg, TRANS, CALIB)
    ref = jax_radar.process_point_cloud(pc_2d, pc_3d, jcfg, TRANS, CALIB)
    assert (got[2] != 0).any()
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)


def test_one_hot_depth_at_the_limit_is_clamped_as_plain():
    """A depth of exactly MAX_PC_DIST passes the inclusive distance filter;
    the port's kernel paints it into the last depth layer, as the
    reference's loop clamps it (nuscenes.py:234-263), not into a velocity
    layer, and equals its plain version."""
    opts = ["MODEL.INPUT_SIZE", "(96, 160)", "DATASET.ONE_HOT_PC", "True",
            "DATASET.MAX_PC_DIST", "20", "MIXED_PRECISION", "False",
            "MODEL.FRUSTUM", "False", "DATASET.PC_ROI_METHOD", "'heatmap'"]
    cfg = load_config(opts=opts, num_classes=10)
    pc_2d, pc_3d = _cloud(4, n=10, max_dist=20.0)
    pc_2d[0] /= 5.0  # inside the 40x24 output map
    pc_2d[1] /= 5.0
    pc_2d[2, :] = 20.0
    got = radar.process_point_cloud(pc_2d, pc_3d, cfg, TRANS, CALIB)[2]
    plain = radar.process_point_cloud_plain(pc_2d, pc_3d, cfg, TRANS,
                                            CALIB)[2]
    assert (got[..., 19] == 20.0).any()
    np.testing.assert_array_equal(got, plain)


def test_paint_rows_host_matches_plain_and_jax():
    rng = np.random.RandomState(9)
    boxes, values = _boxes(rng, 50, 24, 40), rng.randn(50, 3).astype(
        np.float32)
    got = radar.paint_rows_host(boxes, values, (24, 40))
    np.testing.assert_array_equal(
        got, radar.paint_rows_host_plain(boxes, values, (24, 40)))
    np.testing.assert_array_equal(
        got, jax_radar.paint_rows_host(boxes, values, (24, 40)))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", "cfd3d-no-such-compiler")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.load()
    broken = tmp_path / "rasterize.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.paint_rects(np.zeros((4, 4, 3), np.float32),
                           np.zeros((1, 4)), np.ones((1, 3)))
    assert not list((tmp_path / "_build").glob("*.so"))
    # the radar pipeline raises too: no fallback to the numpy loop
    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(96, 160)"], num_classes=10)
    pc_2d, pc_3d = _cloud(5)
    with pytest.raises(RuntimeError, match="failed to build"):
        radar.process_point_cloud(pc_2d, pc_3d, cfg, TRANS, CALIB)


def test_call_counts_hold_under_threads():
    """More threads than cores and a short switch interval: the counts of
    every call are kept (a lost update would show)."""
    native.load()
    workers, calls = 16, 100
    before = native.paint_rects.calls
    boxes = np.array([[0, 2, 0, 2]], np.int32)
    values = np.ones((1, 3), np.float32)

    def work():
        depth_map = np.zeros((4, 4, 3), np.float32)
        for _ in range(calls):
            native.paint_rects(depth_map, boxes, values)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert native.paint_rects.calls == before + workers * calls
