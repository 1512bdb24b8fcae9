"""The port's demo (``demo.py``) against the JAX package's.

- ``render_camera`` and ``render_bev`` bitwise JAX's on the same frame and
  items (both draw with the same cv2 here), with and without
  ``trans_matrix`` (the back camera's transform of ``tests/test_cli.py:139``
  too) and with radar clouds;
- ``demo.main --device cpu`` against JAX ``demo.main`` on a synthetic
  nuScenes directory (``data/synthetic.py:make_synthetic_nuscenes``)
  regrouped six images to a sample (``chip_smoke.py:demo_root``, each
  camera with its own ``trans_matrix``), at 64x128 with DLA-34 and Conv
  nodes, both loading one reference ``.pt`` of He-scaled weights
  (``test_torch_inference_cli.py``'s, with the box heads calmed as in
  ``test_torch_debug_hooks.py`` so that boxes are kept and drawn) and
  computing in float64: each
  sample's detections within ``test_torch_detector.py``'s tolerances
  (rtol = atol = 1e-3; yaw and velocity 1e-2; detections pair within 0.05
  input pixels), and each mosaic with at most ``MOSAIC_DIFF_SHARE`` of its
  pixels differing (box lines drawn from coordinates that differ in the
  last bits may round to the neighbouring pixel);
- ``--save-video`` writes a video that reads back frame for frame, and a
  writer that cannot open raises; ``--show-attention`` writes the overlays
  for one-camera samples; ``--load`` refuses a directory.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch
from test_torch_debug_hooks import _calm_boxes
from test_torch_detector import _assert_matched, _perturb
from test_torch_detector_files import float64_model

import chip_smoke
from centerfusiondetect3d_tpu_torch import demo
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_nuscenes)
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime import detector as port_detector
from centerfusiondetect3d_tpu_torch.training.checkpoint import save_checkpoint
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")
jax_demo = pytest.importorskip("centerfusiondetect3d_tpu.demo")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")

torch.set_num_threads(2)

OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.APPROX_TOPK", "False",
        "MODEL.K", "40", "MIXED_PRECISION", "False"]
N_CAMS, N_SAMPLES = 6, 2
COMPARED = 20
MOSAIC_DIFF_SHARE = 0.002
CONF = "0.0"  # every detection is drawn


def _frame(seed=0, h=96, w=160):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _items(seed, n=15):
    rng = np.random.RandomState(seed)
    return [{"score": float(rng.rand()),
             "dimension": [1.4 + rng.rand(), 1.6 + rng.rand() * 0.4,
                           3.5 + rng.rand() * 2],
             "location": np.array([rng.randn() * 5, rng.rand(),
                                   rng.uniform(-8, 45)], np.float32),
             "yaw": float(rng.uniform(-np.pi, np.pi))} for _ in range(n)]


def _infos(n):
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        m = np.eye(4)
        m[0, 0] = m[2, 2] = np.cos(a)
        m[0, 2], m[2, 0] = np.sin(a), -np.sin(a)
        m[:3, 3] = (1.5 * i, 0.0, 0.7 * i)
        out.append({"trans_matrix": m.tolist()})
    return out


def test_render_camera_is_jax_bitwise():
    calib = np.array([[120.0, 0, 80, 0], [0, 120.0, 48, 0], [0, 0, 1, 0]],
                     np.float32)
    for thresh in (0.0, 0.5):
        want = jax_demo.render_camera(_frame(), _items(1), calib, thresh)
        got = demo.render_camera(_frame(), _items(1), calib, thresh)
        np.testing.assert_array_equal(got, want)
        assert (got != _frame()).any()


def test_render_bev_is_jax_bitwise():
    rng = np.random.RandomState(2)
    radars = []
    for _ in range(4):
        pc = np.zeros((18, 40), np.float32)
        pc[0], pc[2] = rng.randn(40) * 15, rng.uniform(-70, 70, 40)
        radars.append(pc)
    items = {ci: _items(10 + ci) for ci in range(4)}
    for infos in (None, _infos(4), _infos(4)[:1]):
        for rad in (None, radars, radars[:2] + [None, radars[3]]):
            want = jax_demo.render_bev(items, rad, 0.2, infos)
            got = demo.render_bev(items, rad, 0.2, infos)
            np.testing.assert_array_equal(got, want)
    assert got.shape == (demo.BEV_SIZE, demo.BEV_SIZE, 3)


def test_render_bev_transforms_the_back_camera():
    """``tests/test_cli.py:139``: the back camera's detections land behind
    the ego through its ``trans_matrix``, in its own frame in front."""
    items = {0: [], 1: [{"score": 1.0, "location": [0.0, 0.0, 10.0],
                         "yaw": 0.0, "dimension": [1.5, 2.0, 4.0]}]}
    ry = np.eye(4)
    ry[0, 0] = ry[2, 2] = -1.0
    infos = [{"trans_matrix": np.eye(4).tolist()},
             {"trans_matrix": ry.tolist()}]
    for fn in (demo.render_bev, jax_demo.render_bev):
        ys, _ = np.nonzero(np.all(fn(items, None, 0.5, infos)
                                  == (80, 220, 80), axis=-1))
        assert ys.size and ys.min() > demo.BEV_SIZE / 2
        ys2, _ = np.nonzero(np.all(fn(items, None, 0.5, None)
                                   == (80, 220, 80), axis=-1))
        assert ys2.size and ys2.max() < demo.BEV_SIZE / 2
    np.testing.assert_array_equal(demo.render_bev(items, None, 0.5, infos),
                                  jax_demo.render_bev(items, None, 0.5,
                                                      infos))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """6-image samples of a synthetic directory, each camera turned by its
    own ``trans_matrix``."""
    import json

    src = make_synthetic_nuscenes(str(tmp_path_factory.mktemp("src")),
                                  n_samples=N_CAMS * N_SAMPLES,
                                  img_wh=(160, 96), seed=2)
    root = chip_smoke.demo_root(str(tmp_path_factory.mktemp("demo")), src,
                                "mini_val", N_CAMS)
    path = os.path.join(root, "nuscenes", "annotations", "mini_val.json")
    with open(path) as f:
        coco = json.load(f)
    for i, img in enumerate(coco["images"]):
        img["trans_matrix"] = _infos(N_CAMS)[i % N_CAMS]["trans_matrix"]
    with open(path, "w") as f:
        json.dump(coco, f)
    return root


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jcfg = jax_config.load_config(opts=OPTS, num_classes=10)
    variables = _calm_boxes(_perturb(jax_detector.Detector(jcfg).variables,
                                     1))
    model = build_model(load_config(opts=OPTS, num_classes=10))
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], jcfg.head_conv))
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), model,
                           None, 0)


def _args(root, ckpt, *extra):
    return ["--load", ckpt, "--conf-thresh", CONF, *extra, *OPTS,
            "DATASET.ROOT", repr(root + "/")]


@pytest.fixture(scope="module")
def both_demos(data_root, checkpoint, tmp_path_factory):
    """(JAX results and frames, port results and frames) of the two
    demos, each frame as ``cv2.imwrite`` got it."""
    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("out")
    written = {}
    real_imwrite = cv2.imwrite

    def imwrite(path, img, *a):
        written[path] = np.array(img, copy=True)
        return real_imwrite(path, img, *a)

    mp.setattr(cv2, "imwrite", imwrite)
    mp.setattr(jax_detector, "build_model", lambda cfg: jax_models.build_model(
        cfg, dtype=jax.numpy.float64))
    mp.setattr(port_detector, "build_model", float64_model)
    jax_runs = []
    real_run = jax_detector.Detector.run

    def run(self, *a, **k):
        ret = real_run(self, *a, **k)
        jax_runs.append(ret["results"])
        return ret

    mp.setattr(jax_detector.Detector, "run", run)
    try:
        with jax.enable_x64(True):
            jax_demo.main(_args(data_root, checkpoint, "--save-dir",
                                str(out / "jax")))
        jax_frames = dict(written)
        written.clear()
        port = demo.main(_args(data_root, checkpoint, "--device", "cpu",
                               "--save-dir", str(out / "port"),
                               "--save-video", str(out / "port.mp4")))
    finally:
        mp.undo()
    return jax_runs, jax_frames, port, dict(written), out


def test_demo_detections_match_jax(both_demos):
    jax_runs, _, port, _, _ = both_demos
    assert list(port) == [f"demo{i:04d}" for i in range(N_SAMPLES)]
    assert len(jax_runs) == N_SAMPLES
    for want_sample, (token, got_sample) in zip(jax_runs, port.items()):
        assert sorted(got_sample) == sorted(want_sample) == list(
            range(N_CAMS))
        for cam, want in want_sample.items():
            got = got_sample[cam]
            assert len(got) == len(want) > COMPARED
            cutoff = sorted(it["score"] for it in want)[-COMPARED]
            _assert_matched(want, got, cutoff, f"{token}/{cam}")
            _assert_matched(got, want, cutoff * (1 + 1e-3), f"{token}/{cam}")


def test_demo_mosaics_match_jax(both_demos):
    _, jax_frames, _, port_frames, out = both_demos
    names = sorted(os.path.basename(p) for p in port_frames)
    assert names == sorted(os.path.basename(p) for p in jax_frames) == [
        f"demo{i:04d}.jpg" for i in range(N_SAMPLES)]
    by_name = {os.path.basename(p): f for p, f in jax_frames.items()}
    for path, frame in port_frames.items():
        want = by_name[os.path.basename(path)]
        assert frame.shape == want.shape == (448, 1648, 3)
        differ = np.any(frame != want, axis=-1).mean()
        assert differ <= MOSAIC_DIFF_SHARE, (path, differ)
        assert os.path.exists(path)


def test_demo_video_reads_back(both_demos):
    *_, out = both_demos
    cap = cv2.VideoCapture(str(out / "port.mp4"))
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (448, 1648, 3)
        n += 1
    cap.release()
    assert n == N_SAMPLES


def test_a_video_writer_that_cannot_open_raises(data_root, checkpoint,
                                                tmp_path):
    with pytest.raises(OSError, match="video writer"):
        demo.main(_args(data_root, checkpoint, "--device", "cpu",
                        "--max-samples", "1", "--save-video",
                        str(tmp_path / "missing" / "dir" / "out.mp4")))


def test_load_refuses_a_directory(data_root, tmp_path):
    with pytest.raises(SystemExit, match="reference .pt"):
        demo.main(_args(data_root, str(tmp_path), "--device", "cpu"))


def test_show_attention_writes_overlays_for_one_camera(data_root, checkpoint,
                                                       tmp_path, recwarn):
    src = os.path.realpath(os.path.join(data_root, "nuscenes"))
    one = chip_smoke.demo_root(str(tmp_path / "one"), src, "mini_val", 1, 2)
    demo.main(_args(one, checkpoint, "--device", "cpu", "--save-dir",
                    str(tmp_path / "att"), "--show-attention"))
    files = sorted(os.listdir(tmp_path / "att"))
    assert files == sorted(f"demo{i:04d}{s}.jpg" for i in range(2) for s in (
        "", "_att_depthMap", "_att_pc_hm"))
    # several cameras a sample: the reference's warning, no overlays
    demo.main(_args(data_root, checkpoint, "--device", "cpu", "--save-dir",
                    str(tmp_path / "six"), "--show-attention",
                    "--max-samples", "1"))
    assert os.listdir(tmp_path / "six") == ["demo0000.jpg"]
    assert any("multiple camera" in str(w.message) for w in recwarn)
    shutil.rmtree(tmp_path / "att")
