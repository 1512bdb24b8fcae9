"""The ``DEBUG`` hooks of the port against the JAX package's.

- ``DEBUG 2``: every dataset item with radar writes the pillar renders
  (``utils/visualize.py:debug_pillars``) into ``OUTPUT_DIR/debug``; the
  port's ``NuScenesDataset`` writes the files JAX's writes, with the same
  names and the same bytes, on a synthetic nuScenes directory
  (``data/synthetic.py:make_synthetic_nuscenes``), for eval items and for
  augmented (flipped, shifted) training items on the same seeds.
- ``DEBUG 1``: ``Trainer.val`` renders its first image
  (``ValVisualizer``) into ``OUTPUT_DIR/viz/e0000_*.png``; the port's
  files equal JAX's bytewise. Both validations run in float64 on the same
  He-scaled weights (``test_torch_detector.py:_perturb``, with the depth
  and dimension heads calmed so that boxes land in the image; carried over
  by ``state_dict_from_jax``; DLA-34 with Conv nodes, radar and frustum
  association, 64x128), as ``test_torch_validation.py`` runs them, so
  that the detections, and so the drawn pixels, agree.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from test_torch_detector import _perturb
from test_torch_validation import _Float64

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.pipeline import Loader
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_nuscenes)
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_data = pytest.importorskip("centerfusiondetect3d_tpu.data")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_fit = pytest.importorskip("centerfusiondetect3d_tpu.runtime.fit")
jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")

torch.set_num_threads(2)

OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
        "MODEL.K", "16", "MODEL.APPROX_TOPK", "False",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MIXED_PRECISION", "False",
        "WORKERS", "1", "TEST.BATCH_SIZE", "1", "CONF_THRESH", "0.0"]


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_nuscenes(root, n_samples=3, img_wh=(160, 96), seed=4)
    return root


def _cfgs(root, out, *extra):
    opts = OPTS + ["DATASET.ROOT", repr(root + "/"), *extra]
    return (jax_config.load_config(opts=opts + ["OUTPUT_DIR",
                                                repr(str(out / "jax"))],
                                   num_classes=10),
            load_config(opts=opts + ["OUTPUT_DIR", repr(str(out / "port"))],
                        num_classes=10))


def _calm_boxes(variables):
    """``variables`` with the last kernels of the heads that place and size
    a box scaled by 1e-3: the He-scaled network puts boxes ~1e3 m deep or
    ~1e2 m aside, and none is drawn; near their biases (20 m, a car's
    size, on the heatmap's peak; depth2's bias set to depth's) the boxes
    land in the image."""
    heads = variables["params"]["detect_head_0"]
    for name in ("depth", "depth2", "dimension", "amodal_offset", "reg"):
        out = heads[name]["out"]
        out["kernel"] = np.asarray(out["kernel"]) * 1e-3
    heads["depth2"]["out"]["bias"] = np.full_like(
        np.asarray(heads["depth2"]["out"]["bias"]), -np.log(20.0))
    return variables


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_files(a, b):
    names = _tree(a)
    assert names == _tree(b)
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n
    return names


@pytest.mark.parametrize("split,augment", [("mini_val", False),
                                           ("mini_train", True)])
def test_dataset_pillar_renders_are_jax_bytewise(synthetic_root, tmp_path,
                                                 split, augment):
    jcfg, cfg = _cfgs(synthetic_root, tmp_path, "DEBUG", "2",
                      "DATASET.FLIP", "0.5")
    jds = jax_data.NuScenesDataset(jcfg, split)
    ds = NuScenesDataset(cfg, split, device="cpu")
    for i in range(len(ds)):
        rng = (lambda: np.random.RandomState(11 + i)) if augment else (
            lambda: None)
        jitem, item = jds.get_item(i, rng()), ds.get_item(i, rng())
        np.testing.assert_array_equal(item["pc_dep"], jitem["pc_dep"])
    names = _same_files(tmp_path / "jax" / "debug",
                        tmp_path / "port" / "debug")
    assert names == sorted(f"{i}_{n}.jpg" for i in range(len(ds)) for n in (
        "pillarInput2D", "pillarOutput2D", "pillarInputOverlay",
        "imgOrigin"))


def test_dataset_without_debug_writes_no_renders(synthetic_root, tmp_path):
    _, cfg = _cfgs(synthetic_root, tmp_path)
    NuScenesDataset(cfg, "mini_val", device="cpu").get_item(0)
    assert not os.path.exists(tmp_path / "port" / "debug")


def test_val_renders_are_jax_bytewise(synthetic_root, tmp_path):
    import jax.numpy as jnp

    jcfg, cfg = _cfgs(synthetic_root, tmp_path, "DEBUG", "1")
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
        variables = _calm_boxes(_perturb(
            {"params": jtrainer.state.params,
             "batch_stats": jtrainer.state.batch_stats}, 1))
        jtrainer.state = jtrainer.state.replace(
            params=jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                variables["params"]),
            batch_stats=jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                     variables["batch_stats"]))
        jtrainer.profile = lambda batch: {}  # a log line only
        jresults = jtrainer.val(loader)

    ds = NuScenesDataset(cfg, "mini_val", device="cpu")
    trainer = Trainer(cfg, None, ds, device="cpu")
    trainer.model = build_model(cfg, torch.float64)
    trainer.init_state(state_dict_from_jax(variables["params"],
                                           variables["batch_stats"],
                                           jcfg.head_conv))
    results = trainer.val(Loader(_Float64(ds), 1, drop_last=False,
                                 drop_keys=()))
    assert sorted(results) == sorted(jresults)
    names = _same_files(tmp_path / "jax" / "viz", tmp_path / "port" / "viz")
    assert names == ["e0000_bev.png", "e0000_pred_box_3d.png",
                     "e0000_pred_pc_hm.png", "e0000_target_box_3d.png",
                     "e0000_target_pc_hm.png"]
    import cv2

    from centerfusiondetect3d_tpu_torch.utils.visualize import ValVisualizer

    plain = ValVisualizer(str(tmp_path / "plain"), cfg, ds)
    plain.add_ground_truth(ds.images[0], None)
    pred = cv2.imread(str(tmp_path / "port" / "viz" /
                          "e0000_pred_box_3d.png"))
    assert pred.shape == plain.image.shape == (64, 128, 3)
    assert (pred != plain.image).any(axis=-1).sum() > 50, "no box drawn"
    # a second validation writes the next epoch's set beside the first
    trainer.val(Loader(_Float64(ds), 1, drop_last=False, drop_keys=()))
    assert len(_tree(tmp_path / "port" / "viz")) == 10
