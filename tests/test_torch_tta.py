"""Flip and multi-scale test-time augmentation against the JAX package.

Every comparison runs both packages in float64 on the same He-scaled
weights (``test_torch_detector_files.float64_pair``; in float32 the two
differ by float32 rounding through the random network, as
``test_torch_validation.py`` notes), at 64x128 with DeformConv nodes:

- ``ops/tta.py:flip_forward`` against JAX's ``flip_forward`` on the same
  normalized images and radar map (NCHW here, NHWC there): every 4-D head
  within ``HEAD_RTOL`` (1e-3) of its largest magnitude, and the mirror half's
  calib ``out_width - cx``;
- ``Detector.run`` with ``TEST.FLIP_TEST`` against JAX's ``Detector.run``
  on frames with radar: detections matched at ``test_torch_detector.py``'s
  tolerances (rtol = atol = 1e-3; yaw and velocity 1e-2);
- ``_cross_scale_nms`` against JAX's on seeded items.

``test_torch_tta_multiscale.py`` holds ``TEST.MULTI_SCALE`` and
``test_torch_tta_val.py`` ``Trainer.val`` with ``TEST.FLIP_TEST`` (files of
their own, so that the test workers compile the three JAX programs side by
side).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_detector import _assert_matched, _frames
from test_torch_detector_files import float64_pair

from centerfusiondetect3d_tpu_torch.ops import tta
from centerfusiondetect3d_tpu_torch.runtime import detector

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_ops = pytest.importorskip("centerfusiondetect3d_tpu.ops")
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")

torch.set_num_threads(2)

OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "MODEL.DLA.DCN_IMPL", "'xla'", "DATASET.RADAR_PC", "True",
        "MODEL.FRUSTUM", "True", "MODEL.FUSION_STRATEGY", "'middle'",
        "MODEL.APPROX_TOPK", "False", "MIXED_PRECISION", "False"]
# of each head's largest magnitude (measured: heatmap 1.5e-5, velocity
# 1.04e-4; the JAX package's float64 model keeps float32 steps; the
# float32 forwards of test_torch_model.py are held at 2e-3)
HEAD_RTOL = 1e-3
COMPARED = 60


def _hold(got, want, compared=COMPARED):
    """Every detection scoring at least the ``compared``-th score has its
    counterpart (None: every detection)."""
    assert sorted(got["results"]) == sorted(want["results"]) == [0, 1]
    for img_id, want_items in want["results"].items():
        got_items = got["results"][img_id]
        assert len(got_items) == len(want_items) > (compared or 0)
        cutoff = (sorted(it["score"] for it in want_items)[-compared]
                  if compared else -1.0)
        _assert_matched(want_items, got_items, cutoff, img_id)
        _assert_matched(got_items, want_items, cutoff * (1 + 1e-3), img_id)


@pytest.fixture(scope="module")
def flip_pair():
    return float64_pair(OPTS + ["TEST.FLIP_TEST", "True"])


def test_flip_forward_matches_jax(flip_pair):
    jdet, det = flip_pair
    model = det.model  # float64
    rng = np.random.RandomState(3)
    b, h, w = 2, 64, 128
    image = rng.randn(b, h, w, 3)
    pc = np.zeros((b, h // 4, w // 4, 3))
    ys, xs = rng.randint(0, h // 4, 40), rng.randint(0, w // 4, 40)
    pc[np.arange(40) % b, ys, xs] = np.stack(
        [rng.uniform(15, 25, 40), rng.randn(40), rng.randn(40)], -1)
    calib = np.tile(np.array([[90.0, 0, 70.0, 0], [0, 90.0, 30.0, 0],
                              [0, 0, 1, 0]]), (b, 1, 1))
    seen = []

    def spy(image, pc_dep, calib, pc_hm):
        seen.append(calib)
        return model(image, pc_dep, calib, pc_hm)

    with torch.inference_mode():
        got = tta.flip_forward(
            spy, torch.from_numpy(image.transpose(0, 3, 1, 2)).contiguous(),
            torch.from_numpy(pc.transpose(0, 3, 1, 2)).contiguous(),
            torch.from_numpy(calib))
    mirrored = seen[0].numpy()
    np.testing.assert_array_equal(mirrored[:b], calib)
    np.testing.assert_array_equal(mirrored[b:, 0, 2], w // 4 - calib[:, 0, 2])
    with jax.enable_x64(True):
        want = jax.jit(lambda v, im, dep, cal: jax_ops.flip_forward(
            lambda v, im, hm, dep, cal: jdet.det.model.apply(
                v, im, hm, dep, cal, train=False),
            v, im, None, dep, cal)[0])(
            jdet.det.variables, jnp.asarray(image), jnp.asarray(pc),
            jnp.asarray(calib))
    heads = [k for k, v in got.items() if v.dim() == 4]
    assert {"heatmap", "widthHeight", "depth", "velocity", "pc_hm"} <= set(
        heads)
    for k in heads:
        theirs = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        mine = got[k].numpy()
        scale = max(float(np.abs(theirs).max()), 1e-12)
        assert float(np.abs(mine - theirs).max()) <= HEAD_RTOL * scale, k
    assert float(got["pc_hm"].abs().sum()) > 0


def test_detector_flip_matches_jax(flip_pair):
    jdet, det = flip_pair
    images, infos, radars = _frames(0)
    want = jdet.run(images, infos, radars)
    got = det.run(images, infos, radars)
    _hold(got, want)


def test_cross_scale_nms_matches_jax():
    rng = np.random.RandomState(5)
    items = [{"score": float(s), "class": float(rng.randint(1, 4)),
              "location": rng.uniform(-1, 1, 3).astype(np.float32)
              * np.float32([3, 1, 3]) + np.float32([0, 0, 20])}
             for s in sorted(rng.rand(200), reverse=True)]
    kept = detector._cross_scale_nms(items)
    theirs = jax_detector._cross_scale_nms(items)
    assert [id(it) for it in kept] == [id(it) for it in theirs]
    assert 0 < len(kept) < len(items)
    assert len(detector._cross_scale_nms(items, 1.0)) == len(
        jax_detector._cross_scale_nms(items, 1.0))
