"""The port's inference CLI (``inference.py``) against the JAX package's.

One reference ``.pt`` checkpoint, written by the port's
``training/checkpoint.py:save_checkpoint`` from the He-scaled JAX init of
``test_torch_detector.py`` (``state_dict_from_jax``), is loaded by both
CLIs (the JAX one imports it with its ``load_weights``). Both serve a
folder of three 1600x900 JPEGs written by cv2 from seeded arrays
(``test_torch_detector_files._raw_frame``, textured) at 64x128 with
DeformConv nodes, frame by frame with ``TEST.FAST_DECODE``, their models
computing in float64 over the checkpoint's float32 weights; their
detections match per frame name at ``test_torch_detector.py``'s tolerances
(rtol = atol = 1e-3; yaw and velocity 1e-2; detections pair within
``MATCH_RADIUS``, that file's 0.05 input pixels in the frame's pixels).

On the repo's 448x256 JPEGs: ``--stream`` gives the serial detections
exactly; ``--save-dir`` writes ``<stem>_det.jpg`` (the decoded,
half-resolution frame) and ``results.json``, with ``--stream``
``results.json`` alone; ``--show-attention`` writes the depth and
radar maps' overlays, which are the JAX package's bitwise
(``normalize_depthmaps`` on NCHW maps, ``attention_overlay``);
``draw_detections`` divides boxes by the decode
scale (JAX ``tests/test_cli.py:123``) and draws what the JAX package draws; ``--load``
refuses a file that is not a ``.pt``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch
from test_torch_detector import ITEM_ATOL, _center, _perturb
from test_torch_detector_files import _raw_frame, float64_model

from centerfusiondetect3d_tpu_torch import inference
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime import detector as port_detector
from centerfusiondetect3d_tpu_torch.training.checkpoint import save_checkpoint
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")
jax_inference = pytest.importorskip("centerfusiondetect3d_tpu.inference")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_JPEGS = sorted(glob.glob(os.path.join(
    ROOT, "output", "campaign_r5", "data", "nuscenes", "samples",
    "CAM_FRONT", "c1img*.jpg")))[:4]
OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "MODEL.DLA.DCN_IMPL", "'xla'", "DATASET.RADAR_PC", "True",
        "MODEL.FRUSTUM", "True", "MODEL.FUSION_STRATEGY", "'middle'",
        "MODEL.APPROX_TOPK", "False", "MIXED_PRECISION", "False"]
COMPARED = 40
# test_torch_detector.py pairs detections centred within 0.05 px of its
# 128-pixel-wide frames; these frames are 1600 wide, 12.5 times the input
MATCH_RADIUS = 0.05 * 1600 / 128


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference .pt of the He-scaled JAX init, written by the port."""
    jcfg = jax_config.load_config(opts=OPTS, num_classes=10)
    variables = _perturb(jax_detector.Detector(jcfg).variables, 1)
    model = build_model(load_config(opts=OPTS, num_classes=10))
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], jcfg.head_conv))
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), model,
                           None, 0)


@pytest.fixture(scope="module")
def raw_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("raw")
    for i in range(3):
        cv2.imwrite(str(folder / f"cam{i}.jpg"), _raw_frame(7 + i, True))
    return str(folder)


@pytest.fixture(scope="module")
def repo_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("repo")
    for path in REPO_JPEGS:
        os.symlink(path, folder / os.path.basename(path))
    return str(folder)


def _port(*args):
    return inference.main(["--device", "cpu", *args, *OPTS])


def test_cli_matches_jax_on_one_checkpoint(checkpoint, raw_folder, capsys,
                                           monkeypatch):
    """Both CLIs in float64 (the models, over the checkpoint's float32
    weights): in float32 the two packages' attributes differ by up to
    2.8e-3 on these frames, float32 rounding through the random network."""
    monkeypatch.setattr(jax_detector, "build_model",
                        lambda cfg: jax_models.build_model(
                            cfg, dtype=jax.numpy.float64))
    monkeypatch.setattr(port_detector, "build_model", float64_model)
    with jax.enable_x64(True):
        want = jax_inference.main(["--input", raw_folder, "--load",
                                   checkpoint, *OPTS])
    jax_out = capsys.readouterr().out
    assert "0 missing" in jax_out
    got = _port("--input", raw_folder, "--load", checkpoint)
    out = capsys.readouterr().out
    assert "0 missing" in out and "processed 3 frames" in out
    assert list(got) == list(want) == [f"cam{i}.jpg" for i in range(3)]
    for name, want_items in want.items():
        got_items = got[name]
        assert len(got_items) == len(want_items) > COMPARED
        cutoff = sorted(it["score"] for it in want_items)[-COMPARED]
        _assert_matched(want_items, got_items, cutoff, name)
        _assert_matched(got_items, want_items, cutoff * (1 + 1e-3), name)


def _assert_matched(items, others, cutoff, name):
    """``test_torch_detector._assert_matched`` at ``MATCH_RADIUS``: every
    item scoring >= cutoff has a same-class counterpart, and their values
    agree within ``ITEM_ATOL``."""
    for a in items:
        if a["score"] < cutoff:
            continue
        same = [b for b in others if b["class"] == a["class"]]
        dist = [np.abs(_center(b) - _center(a)).max() for b in same]
        assert same and min(dist) < MATCH_RADIUS, (name, a["score"])
        b = same[int(np.argmin(dist))]
        for key, atol in ITEM_ATOL.items():
            np.testing.assert_allclose(
                np.asarray(a[key], np.float64), np.asarray(b[key], np.float64),
                rtol=1e-3, atol=atol, err_msg=f"{name} {key}")


def test_stream_writes_the_serial_detections(checkpoint, repo_folder,
                                             tmp_path):
    serial_dir, stream_dir = tmp_path / "serial", tmp_path / "stream"
    serial = _port("--input", repo_folder, "--load", checkpoint,
                   "--save-dir", str(serial_dir), "--conf-thresh", "0.02")
    stream = _port("--input", repo_folder, "--load", checkpoint,
                   "--save-dir", str(stream_dir), "--stream")
    names = [os.path.basename(p) for p in REPO_JPEGS]
    assert list(serial) == list(stream) == names
    assert serial == stream and all(serial[n] for n in names)
    saved = [json.loads((d / "results.json").read_text())
             for d in (serial_dir, stream_dir)]
    assert saved[0] == saved[1] == json.loads(json.dumps(serial))
    for name in names:
        det = cv2.imread(str(serial_dir / f"{name[:-4]}_det.jpg"))
        assert det.shape == (128, 224, 3)  # the half-resolution decode
    assert sorted(os.listdir(stream_dir)) == ["results.json"]


def test_show_attention_writes_overlays(checkpoint, tmp_path):
    out = tmp_path / "att"
    _port("--input", REPO_JPEGS[0], "--load", checkpoint, "--save-dir",
          str(out), "--show-attention")
    stem = os.path.basename(REPO_JPEGS[0])[:-4]
    maps = ("depthMap", "pc_hm")
    assert sorted(os.listdir(out)) == sorted(
        ["results.json", f"{stem}_det.jpg"]
        + [f"{stem}_att_{m}.jpg" for m in maps])
    for m in maps:
        overlay = cv2.imread(str(out / f"{stem}_att_{m}.jpg"))
        assert overlay.shape == (16, 32, 3)  # the output plane


def test_overlays_are_jax_bitwise():
    from centerfusiondetect3d_tpu.utils import visualize as jax_visualize

    from centerfusiondetect3d_tpu_torch.data import image_io
    from centerfusiondetect3d_tpu_torch.utils.visualize import (
        normalize_depthmaps)

    rng = np.random.default_rng(7)
    maps = {"depthMap": rng.normal(size=(2, 3, 16, 32)).astype(np.float32),
            "pc_hm": rng.uniform(0, 60, (2, 1, 16, 32)).astype(np.float32)}
    got = normalize_depthmaps(maps)
    want = jax_visualize.normalize_depthmaps(
        {k: v.transpose(0, 2, 3, 1) for k, v in maps.items()})
    frame = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    for k in maps:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            image_io.attention_overlay(frame, got[k][0]),
            jax_visualize.attention_overlay(frame, want[k][0]))


def test_draw_detections_scale_as_jax():
    img = np.zeros((100, 100, 3), np.uint8)
    items = [{"score": 0.9, "class": 1.0,
              "bbox": np.array([40.0, 40.0, 160.0, 160.0])}]
    out = inference.draw_detections(img, items, ["car"] * 10, 0.5, scale=2.0)
    # rectangle drawn at 20..80, not clipped at the frame edge
    assert out[20, 50].any() and out[80, 50].any()
    assert not out[95, 50].any()
    assert not img.any()  # a copy is drawn on
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (90, 160, 3)).astype(np.uint8)
    items = [{"score": float(s), "class": float(c),
              "bbox": rng.uniform(0, 300, 4)}
             for s, c in zip(rng.rand(6), rng.randint(1, 11, 6))]
    items.append({"score": 0.99, "class": 2.0})  # no box: skipped
    for scale in (1.0, 2.0):
        np.testing.assert_array_equal(
            inference.draw_detections(frame, items, inference.NuScenesDataset
                                      .class_name, 0.3, scale),
            jax_inference.draw_detections(frame, items, inference
                                          .NuScenesDataset.class_name, 0.3,
                                          scale))


def test_load_takes_a_reference_checkpoint_only(tmp_path):
    with pytest.raises(SystemExit, match=r"\.pt"):
        _port("--input", REPO_JPEGS[0], "--load", str(tmp_path / "orbax"))


def test_iter_frames_reads_folders_files_and_video(tmp_path):
    frames = [_raw_frame(i, False)[:64, :96] for i in range(3)]
    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (96, 64))
    if not writer.isOpened():
        pytest.skip("this opencv writes no MJPG video")
    for f in frames:
        writer.write(f)
    writer.release()
    got = list(inference.iter_frames(video))
    assert [n for n, _ in got] == ["frame000000", "frame000001",
                                   "frame000002"]
    assert all(f.shape == (64, 96, 3) for _, f in got)
    assert list(inference.iter_frames(REPO_JPEGS[0])) == [
        (os.path.basename(REPO_JPEGS[0]), REPO_JPEGS[0])]
