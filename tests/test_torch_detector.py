"""The port's serving engine against the JAX package's, end to end.

Both ``Detector.run`` calls get the same weights (JAX init from a seed,
perturbed with numpy, carried over by ``state_dict_from_jax``), the same two
camera frames and radar clouds, at 64x128 with the exact top-k
(``APPROX_TOPK=False``) and the exact DCN. The frustum map is compared in
full. Detections are matched by class and box center, since the float32 sums
of the two frameworks differ by ~1e-4 relative after DLA-34's depth and may
swap the rank of two close scores: every detection scoring above the JAX
run's ``COMPARED``-th score needs a counterpart in the other run whose
center lies within 0.05 px, and the pair's score, box, location, dimension
and attributes agree within rtol = atol = 1e-3. Yaw and velocity go through
atan2 of rotation-bin outputs of magnitude ~0.1 whose float32 error, in
either framework, is ~3e-4 against a float64 forward of the same weights;
they agree within atol = 1e-2 (radians, m/s).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.runtime import detector
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

# the JAX package and what it imports (jax, flax, pyyaml); the card's
# machine has none of them and runs only this repo's -m cuda tests
jax = pytest.importorskip("jax")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")

torch.set_num_threads(1)

OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.APPROX_TOPK", "False",
        "MODEL.DLA.DCN_IMPL", "'xla'", "MIXED_PRECISION", "False"]
COMPARED = 80
ITEM_ATOL = {"score": 1e-3, "bbox": 1e-3, "location": 1e-3,
             "dimension": 1e-3, "nuscenes_att": 1e-3, "yaw": 1e-2,
             "velocity": 1e-2}


def _perturb(variables, seed):
    rng = np.random.RandomState(seed)

    def fn(path, v):
        v = np.array(v, np.float32)
        names = [getattr(p, "key", str(p)) for p in path]
        if "conv_offset_mask" in names and names[-1] == "kernel":
            v = rng.randn(*v.shape) * 1.5 / np.sqrt(np.prod(v.shape[:3]))
        elif (names[-1] in ("kernel", "weight")
              and not any(n.startswith("up_") for n in names)):
            # He scale: the torch default init's 1/3 variance lets the
            # signal fade over DLA-34's depth into flat, tie-ridden maps
            v = v * np.sqrt(6.0)
        elif names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
            v = 0.1 * rng.randn(*v.shape)
        elif names[-2:] == ["out", "bias"] and names[-3] == "depth":
            v[:] = -np.log(20.0)
        elif names[-2:] == ["out", "bias"] and names[-3] == "dimension":
            v[:] = (1.5, 1.6, 4.0)
        return np.asarray(v, np.float32)

    return {k: jax.tree_util.tree_map_with_path(fn, v)
            for k, v in variables.items()}


def _frames(seed, n=2, h=72, w=128):
    rng = np.random.RandomState(seed)
    calib = np.array([[100.0, 0, w / 2, 0], [0, 100.0, h / 2, 0],
                      [0, 0, 1, 0]], np.float32)
    images, infos, radars = [], [], []
    for _ in range(n):
        images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        infos.append({"calib": calib.tolist(),
                      "camera_intrinsic": calib[:3, :3].tolist(),
                      "width": w, "height": h})
        pts = np.zeros((18, 80), np.float32)
        pts[2] = rng.uniform(15, 25, 80)
        pts[0] = rng.uniform(-0.6, 0.6, 80) * pts[2]
        pts[1] = rng.uniform(-0.3, 0.3, 80) * pts[2]
        pts[8:10] = rng.randn(2, 80)
        radars.append(pts)
    return images, infos, radars


def _center(item):
    box = np.asarray(item["bbox"], np.float64)
    return np.array([box[0] + box[2], box[1] + box[3]]) / 2


def _assert_matched(items, others, cutoff, img_id):
    """Every item scoring >= cutoff has a same-class counterpart in others
    centered within 0.05 px, with the same values."""
    for a in items:
        if a["score"] < cutoff:
            continue
        same = [b for b in others if b["class"] == a["class"]]
        dist = [np.abs(_center(b) - _center(a)).max() for b in same]
        assert same and min(dist) < 0.05, (img_id, a["score"], _center(a))
        b = same[int(np.argmin(dist))]
        for key, atol in ITEM_ATOL.items():
            np.testing.assert_allclose(
                np.asarray(a[key], np.float64), np.asarray(b[key], np.float64),
                rtol=1e-3, atol=atol, err_msg=f"image {img_id} {key}")


def test_run_matches_jax_detector():
    jcfg = jax_load_config(opts=OPTS, num_classes=10)
    jdet = jax_detector.Detector(jcfg, batch_size=2)
    jdet.variables = _perturb(jdet.variables, 1)
    head_conv = jcfg.head_conv
    sd = state_dict_from_jax(jdet.variables["params"],
                             jdet.variables["batch_stats"], head_conv)
    det = detector.Detector(load_config(opts=OPTS, num_classes=10), sd,
                            device="cpu")

    images, infos, radars = _frames(0)
    want = jdet.run(images, infos, radars)
    got = det.run(images, infos, radars)
    assert set(got["times"]) >= {"load", "preprocess", "net", "merge",
                                 "total"}
    assert float(got["extras"]["pc_hm"].abs().sum()) > 0
    np.testing.assert_allclose(got["extras"]["pc_hm"].numpy(), np.transpose(
        np.asarray(want["extras"]["pc_hm"]), (0, 3, 1, 2)), atol=1e-5)

    assert sorted(got["results"]) == sorted(want["results"]) == [0, 1]
    for img_id, want_items in want["results"].items():
        got_items = got["results"][img_id]
        assert len(got_items) == len(want_items) > COMPARED
        cutoff = sorted(it["score"] for it in want_items)[-COMPARED]
        _assert_matched(want_items, got_items, cutoff, img_id)
        _assert_matched(got_items, want_items, cutoff * (1 + 1e-3), img_id)


def test_warp_general_affine_matches_jax():
    """A frame that does not map onto the input by an integer crop goes
    through cv2's bilinear warp in both packages."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (90, 150, 3)).astype(np.uint8)
    trans = np.array([[0.8, 0.0, 3.5], [0.0, 0.8, -2.25]])
    np.testing.assert_array_equal(
        detector._warp_or_crop(img, trans, 64, 128),
        jax_detector._warp_or_crop(img, trans, 64, 128))
    crop = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -4.0]])
    np.testing.assert_array_equal(
        detector._warp_or_crop(img, crop, 64, 128),
        jax_detector._warp_or_crop(img, crop, 64, 128))


def test_entry_point_needs_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detector.Detector(cfg)
    det = detector.Detector(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        det.load_data("frame.jpg")
