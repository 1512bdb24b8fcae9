"""Validation and NDS scoring in the port's Trainer, and the port's
``main.py``, against the JAX package.

The dataset is built here as ``tests/test_e2e_eval.py:eval_root`` builds
its own: raw ``v1.0-mini`` tables -> the JAX package's converter ->
one camera image, a car 10 m ahead. The port's ``Trainer.val`` and the JAX
package's run on the same weights (JAX init perturbed as in
``test_torch_detector.py``, so that the heatmaps have no NMS ties, carried
over by ``state_dict_from_jax``): DLA-34 with DeformConv nodes, so that the
eval forward crosses the DCN, at 96x160 in float32 with the exact top-k.
Both give the same image ids and detections within ``DET_RTOL`` of each
quantity's largest magnitude, the same loss meters, and every ``range_all``
summary metric within ``SUMMARY_ATOL``.

``main.py`` then trains 2 epochs with ``TRAIN.VAL_INTERVALS 1`` on the same
data (Conv nodes, to stay quick): a crash-guard checkpoint before each of
the two validations, each of which writes the submission and the NDS
summaries; and ``main.py`` with ``EVAL True`` on the last checkpoint scores
the same image.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from test_torch_detector import _perturb

from centerfusiondetect3d_tpu_torch import main as port_main
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.pipeline import Loader
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_data = pytest.importorskip("centerfusiondetect3d_tpu.data")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_fit = pytest.importorskip("centerfusiondetect3d_tpu.runtime.fit")
jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")

torch.set_num_threads(2)

DET_RTOL = 1e-4  # of each detection quantity's largest magnitude
SUMMARY_ATOL = 1e-4
OPTS = ["MODEL.INPUT_SIZE", "(96, 160)", "MODEL.DLA.NODE", "DeformConv",
        "MODEL.DLA.DCN_IMPL", "'xla'", "MODEL.K", "8",
        "MODEL.APPROX_TOPK", "False", "DATASET.RADAR_PC", "False",
        "MIXED_PRECISION", "False", "WORKERS", "1", "TEST.BATCH_SIZE", "1"]
KEYS = ("score", "class", "bbox", "dimension", "location", "yaw")


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """Raw nuScenes tables + the JAX converter's COCO json + one image, as
    ``tests/test_e2e_eval.py:eval_root``."""
    cv2 = pytest.importorskip("cv2")
    from centerfusiondetect3d_tpu.data.convert_nuscenes import (
        export_split, scene_splits)

    root = tmp_path_factory.mktemp("e2e")
    version = root / "v1.0-mini"
    version.mkdir()
    scene_name = scene_splits()["mini_val"][0]

    def w(name, obj):
        (version / f"{name}.json").write_text(json.dumps(obj))

    w("scene", [{"token": "sc0", "name": scene_name, "description": "sunny"}])
    w("sample", [
        {"token": "sa0", "scene_token": "sc0", "timestamp": 1_000_000,
         "prev": "", "next": ""},
    ])
    w("sensor", [
        {"token": "se_cam", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "se_lid", "channel": "LIDAR_TOP", "modality": "lidar"},
    ])
    w("calibrated_sensor", [
        {"token": "cs_cam", "sensor_token": "se_cam", "translation": [0, 0, 0],
         "rotation": [1, 0, 0, 0],
         "camera_intrinsic": [[400.0, 0, 200.0], [0, 400.0, 150.0],
                              [0, 0, 1]]},
        {"token": "cs_lid", "sensor_token": "se_lid", "translation": [0, 0, 0],
         "rotation": [1, 0, 0, 0], "camera_intrinsic": []},
    ])
    w("ego_pose", [{"token": "ep0", "translation": [0, 0, 0],
                    "rotation": [1, 0, 0, 0]}])
    w("sample_data", [
        {"token": "sd_cam0", "sample_token": "sa0", "ego_pose_token": "ep0",
         "calibrated_sensor_token": "cs_cam", "is_key_frame": True,
         "filename": "samples/CAM_FRONT/img0.jpg", "width": 400,
         "height": 300, "prev": "", "next": ""},
        {"token": "sd_lid0", "sample_token": "sa0", "ego_pose_token": "ep0",
         "calibrated_sensor_token": "cs_lid", "is_key_frame": True,
         "filename": "samples/LIDAR_TOP/l0.pcd.bin", "width": 0, "height": 0,
         "prev": "", "next": ""},
    ])
    w("category", [{"token": "cat_car", "name": "vehicle.car"}])
    w("instance", [{"token": "in0", "category_token": "cat_car"}])
    w("attribute", [{"token": "at_mv", "name": "vehicle.moving"}])
    w("sample_annotation", [
        {"token": "an0", "sample_token": "sa0", "instance_token": "in0",
         "translation": [0.5, 0.2, 10.0], "size": [1.9, 4.5, 1.6],
         "rotation": [1, 0, 0, 0], "attribute_tokens": ["at_mv"],
         "prev": "", "next": "", "visibility_token": "4",
         "num_lidar_pts": 10, "num_radar_pts": 2},
    ])

    img_dir = root / "samples" / "CAM_FRONT"
    img_dir.mkdir(parents=True)
    # a textured frame (a flat one gives flat maps and NMS ties)
    img = np.random.RandomState(3).randint(0, 256, (300, 400, 3), np.uint8)
    cv2.imwrite(str(img_dir / "img0.jpg"), img)

    export_split(str(root), "mini_val", verbose=False)
    os.symlink(root, root / "nuscenes")  # the dataset reads ROOT/nuscenes
    return str(root)


def _opts(root, out, *extra):
    return ["DATASET.ROOT", repr(root + "/"), "OUTPUT_DIR", repr(str(out)),
            *OPTS, *extra]


class _Float64:
    """A dataset whose items carry their floating arrays (``meta`` aside) in
    float64."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def get_item(self, index, rng=None):
        item = self.ds.get_item(index, rng)
        return {k: v if k == "meta" or np.asarray(v).dtype.kind != "f"
                else np.asarray(v, np.float64) for k, v in item.items()}


@pytest.fixture(scope="module")
def both_vals(eval_root, tmp_path_factory):
    """(JAX results, JAX summaries, JAX loss history, port Trainer, port
    results) of one validation each on the same weights, in float64."""
    import jax.numpy as jnp

    out = tmp_path_factory.mktemp("val")
    jcfg = jax_config.load_config(
        opts=_opts(eval_root, out / "jax", "EVAL", "True"), num_classes=10)
    jds = jax_data.NuScenesDataset(jcfg, "mini_val")
    with jax.enable_x64(True):
        jtrainer = jax_fit.Trainer(
            jcfg, jax_models.build_model(jcfg, dtype=jnp.float64), None, jds,
            str(out / "jax"))
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
        # its one-time FLOPs report compiles the forward a second time and
        # feeds only a log line; the port has no counterpart
        jtrainer.profile = lambda batch: {}
        jresults = jtrainer.val(loader)
    jsum = json.load(open(out / "jax" / "nuscenes_eval_det_output_mini_val"
                          / "range_all" / "metrics_summary.json"))

    cfg = load_config(opts=_opts(eval_root, out / "port", "EVAL", "True"),
                      num_classes=10)
    ds = NuScenesDataset(cfg, "mini_val", device="cpu")
    trainer = Trainer(cfg, None, ds, device="cpu")
    trainer.model = build_model(cfg, torch.float64)
    trainer.init_state(state_dict_from_jax(variables["params"],
                                           variables["batch_stats"],
                                           jcfg.head_conv))
    results = trainer.val(Loader(_Float64(ds), 1, drop_last=False,
                                 drop_keys=()))
    return jresults, jsum, jtrainer.history["val"], trainer, results


def test_val_gives_jax_image_ids_and_detections(both_vals):
    jresults, _, _, _, results = both_vals
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


def test_val_loss_meters_match_jax(both_vals):
    _, _, jhist, trainer, _ = both_vals
    hist = trainer.history["val"]
    assert sorted(hist) == sorted(jhist)
    for key, values in hist.items():
        np.testing.assert_allclose(values, jhist[key], rtol=1e-3, atol=1e-4,
                                   err_msg=key)


def test_val_scores_like_jax(both_vals):
    _, jsum, _, trainer, _ = both_vals
    out = trainer.config.OUTPUT_DIR
    assert os.path.exists(os.path.join(out, "results_nuscenes_det_mini_val.json"))
    path = os.path.join(out, "nuscenes_eval_det_output_mini_val", "range_all",
                        "metrics_summary.json")
    got = json.load(open(path))
    assert trainer.summaries["range_all"]["nd_score"] == got["nd_score"]
    assert 0.0 <= got["nd_score"] <= 1.0

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    mine, theirs = dict(flat(got)), dict(flat(jsum))
    assert sorted(mine) == sorted(theirs)
    for key, v in mine.items():
        w = theirs[key]
        if v is None or w is None:  # NaN written as null
            assert v is w, key
        else:
            assert abs(v - w) <= SUMMARY_ATOL, (key, v, w)


def _main_opts(root, out, *extra):
    return ["--device", "cpu", "DATASET.ROOT", repr(root + "/"),
            "OUTPUT_DIR", repr(str(out)), "NAME", "port",
            "MODEL.INPUT_SIZE", "(64, 96)", "MODEL.DLA.NODE", "Conv",
            "MODEL.K", "8", "DATASET.RADAR_PC", "False",
            "MIXED_PRECISION", "False", "TEST.BATCH_SIZE", "1",
            "DATASET.TRAIN_SPLIT", "mini_val", "DATASET.VAL_SPLIT", "mini_val",
            *extra]


def test_main_trains_with_crash_guard_checkpoints_and_validations(
        eval_root, tmp_path, monkeypatch):
    saved, vals = [], []
    real_val = Trainer.val

    def val(self, loader=None):
        vals.append(sorted(os.listdir(os.path.join(self.config.OUTPUT_DIR,
                                                   "ckpts"))))
        return real_val(self, loader)

    monkeypatch.setattr(Trainer, "val", val)
    trainer = port_main.main(_main_opts(
        eval_root, tmp_path, "TRAIN.EPOCHS", "2", "TRAIN.VAL_INTERVALS", "1",
        "TRAIN.SAVE_INTERVALS", "100", "TRAIN.BATCH_SIZE", "1",
        "TRAIN.WARM_EPOCHS", "0", "MODEL.FREEZE_BACKBONE", "True",
        "MODEL.DEFREEZE", "0"))
    out = trainer.config.OUTPUT_DIR
    assert out.startswith(str(tmp_path / "port"))
    # epoch 0's crash guard before the first val; epoch 1's (the last
    # epoch's save and the crash guard) before the second
    assert vals == [["model_0.pt", "model_last.pt"],
                    ["model_0.pt", "model_1.pt", "model_last.pt"]]
    assert [s["frozen"] for s in trainer.steps] == [True, False]
    assert len(trainer.history["val"]["total"]) == 2
    assert len(trainer.val_seconds) == 2
    nds = trainer.summaries["range_all"]["nd_score"]
    assert 0.0 <= nds <= 1.0
    assert os.path.exists(os.path.join(out, "config.json"))
    assert "param census" in open(os.path.join(out, "train.log")).read()

    monkeypatch.undo()
    ckpt = os.path.join(out, "ckpts", "model_last.pt")
    ev = port_main.main(_main_opts(
        eval_root, tmp_path / "eval", "EVAL", "True",
        "MODEL.LOAD_DIR", repr(ckpt)))
    assert ev.dataset_train is None and ev.steps == []
    assert len(ev.val_seconds) == 1
    sub = json.load(open(os.path.join(
        ev.config.OUTPUT_DIR, "results_nuscenes_det_mini_val.json")))
    assert sorted(sub["results"]) == ["sa0"]
    assert 0.0 <= ev.summaries["range_all"]["nd_score"] <= 1.0
    for k, v in ev.model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
