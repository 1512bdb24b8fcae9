"""``Trainer.val`` with ``TEST.FLIP_TEST`` against the JAX package's.

As ``test_torch_validation.py`` holds validation without the flip (its
converter-built one-image set, the same He-scaled weights, float64 in both
packages), at 64x96 with DeformConv nodes: the image ids and detections
within ``DET_RTOL`` of each quantity's largest magnitude, the loss meters,
and NDS and mAP within ``SUMMARY_ATOL``; a plain forward on the same
weights gives other detections, so the flip ran.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from test_torch_detector import _perturb
from test_torch_validation import (DET_RTOL, KEYS, SUMMARY_ATOL, _Float64,
                                   _opts, eval_root)

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.pipeline import Loader
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_data = pytest.importorskip("centerfusiondetect3d_tpu.data")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_fit = pytest.importorskip("centerfusiondetect3d_tpu.runtime.fit")
jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")

assert eval_root  # the validation fixture, shared with that file

torch.set_num_threads(2)

VAL_OPTS = ("EVAL", "True", "TEST.FLIP_TEST", "True", "MODEL.INPUT_SIZE",
            "(64, 96)")


def test_trainer_val_with_flip_matches_jax(eval_root, tmp_path):
    jcfg = jax_config.load_config(
        opts=_opts(eval_root, tmp_path / "jax", *VAL_OPTS), num_classes=10)
    jds = jax_data.NuScenesDataset(jcfg, "mini_val")
    with jax.enable_x64(True):
        jtrainer = jax_fit.Trainer(
            jcfg, jax_models.build_model(jcfg, dtype=jnp.float64), None, jds,
            str(tmp_path / "jax"))
        loader = jax_pipeline.Loader(_Float64(jds), 1, num_threads=1,
                                     prefetch=0, drop_last=False,
                                     drop_keys=())
        first = loader.peek()
        first.pop("meta")
        jtrainer.init_state(first)
        variables = _perturb({"params": jtrainer.state.params,
                              "batch_stats": jtrainer.state.batch_stats}, 1)
        jtrainer.state = jtrainer.state.replace(
            params=jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                variables["params"]),
            batch_stats=jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                     variables["batch_stats"]))
        jtrainer.profile = lambda batch: {}
        jresults = jtrainer.val(loader)

    cfg = load_config(opts=_opts(eval_root, tmp_path / "port", *VAL_OPTS),
                      num_classes=10)
    assert cfg.TEST.FLIP_TEST
    ds = NuScenesDataset(cfg, "mini_val", device="cpu")
    trainer = Trainer(cfg, None, ds, device="cpu")
    trainer.model = build_model(cfg, torch.float64)
    trainer.init_state(state_dict_from_jax(variables["params"],
                                           variables["batch_stats"],
                                           jcfg.head_conv))
    results = trainer.val(Loader(_Float64(ds), 1, drop_last=False,
                                 drop_keys=()))
    assert sorted(results) == sorted(jresults) == [1]
    for img_id, items in results.items():
        theirs = jresults[img_id]
        assert len(items) == len(theirs) == 8
        for key in KEYS:
            got = np.array([np.asarray(it[key], np.float64) for it in items])
            want = np.array([np.asarray(it[key], np.float64)
                             for it in theirs])
            scale = max(float(np.abs(want).max()), 1e-12)
            assert float(np.abs(got - want).max()) <= DET_RTOL * scale, key
    for key, values in trainer.history["val"].items():
        np.testing.assert_allclose(values, jtrainer.history["val"][key],
                                   rtol=1e-3, atol=1e-4, err_msg=key)
    summary = "nuscenes_eval_det_output_mini_val/range_all/metrics_summary.json"
    mine = json.load(open(tmp_path / "port" / summary))
    theirs = json.load(open(tmp_path / "jax" / summary))
    assert abs(mine["nd_score"] - theirs["nd_score"]) <= SUMMARY_ATOL
    assert abs(mine["mean_ap"] - theirs["mean_ap"]) <= SUMMARY_ATOL
    # the flip changes the result: a plain forward gives other detections
    plain = Trainer(load_config(opts=_opts(eval_root, tmp_path / "plain",
                                           *VAL_OPTS[:2], *VAL_OPTS[4:]),
                                num_classes=10), None, ds, device="cpu")
    plain.model = trainer.model
    plain.init_state(trainer.model.state_dict())
    unflipped = plain.val(Loader(_Float64(ds), 1, drop_last=False,
                                 drop_keys=()))
    assert unflipped[1][0]["score"] != results[1][0]["score"]
