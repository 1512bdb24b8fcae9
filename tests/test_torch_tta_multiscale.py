"""Multi-scale test-time augmentation against the JAX package.

``Detector.run`` with ``TEST.MULTI_SCALE (0.75, 1.0, 1.25)`` in both
packages, in float64 on the same He-scaled weights
(``test_torch_detector_files.float64_pair``; the JAX package's scaled
detectors build float64 models too), at 64x128 with DeformConv nodes, on
frames with radar: the merged detections (cross-scale NMS, then the top K)
match whole at ``test_torch_detector.py``'s tolerances (rtol = atol = 1e-3;
yaw and velocity 1e-2); the scaled detectors sit at JAX's 32-aligned sizes
and serve the one ``nn.Module``.
"""

from __future__ import annotations

import pytest
import torch
from test_torch_detector import _frames
from test_torch_detector_files import float64_pair
from test_torch_tta import OPTS, _hold

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")

torch.set_num_threads(2)

SCALES = "(0.75, 1.0, 1.25)"


def test_detector_multi_scale_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_detector, "build_model",
                        lambda cfg: jax_models.build_model(cfg,
                                                           dtype=jnp.float64))
    jdet, det = float64_pair(OPTS + ["TEST.MULTI_SCALE", SCALES])
    images, infos, radars = _frames(0)
    want = jdet.run(images, infos, radars)
    got = det.run(images, infos, radars)
    _hold(got, want, None)  # the merged lists, whole
    for s in (0.75, 1.25):
        assert (det._scaled[s].config.MODEL.INPUT_SIZE
                == jdet.det._scaled[s].config.MODEL.INPUT_SIZE)
        assert det._scaled[s].model is det.model  # one module, no copy
    assert det._scaled[0.75].config.MODEL.INPUT_SIZE == (64, 96)
    assert det._scaled[1.25].config.MODEL.INPUT_SIZE == (64, 160)
    assert all(len(v) <= det.config.MODEL.K for v in got["results"].values())
