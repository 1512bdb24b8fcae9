"""Reference ``.pt`` checkpoints in the port's Trainer, against the JAX
package's own reader and writer.

(1) A checkpoint written by JAX ``export_torch_checkpoint`` loads through
``MODEL.LOAD_DIR`` into the port's Trainer, whose model then gives the JAX
model's heads (float32 tolerance of ``test_torch_model.py``, 2e-3).
(2) The port's ``save_checkpoint`` is read by JAX ``load_torch_file`` and
``import_torch_checkpoint`` with no missing and no shape-mismatched key.
(3) ``modernize_torch_key`` against the executed reference's names
(``legacy_names.npz``).
(4) ``TRAIN.RESUME`` restores the epoch and the optimizer state: the epoch
after a resume equals the same epoch of an uninterrupted run, in float64.
(5) What the Trainer refuses: a ``TRAIN.VAL_INTERVALS`` epoch without a
``dataset_val`` and a
``LOAD_DIR`` that is not a ``.pt``/``.pth`` file; it trains under
``MIXED_PRECISION`` and saves float32 checkpoints.
Small model: Conv nodes, 64x128.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    SyntheticTrainingSet,
)
from centerfusiondetect3d_tpu_torch.training import checkpoint

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_build_model = pytest.importorskip(
    "centerfusiondetect3d_tpu.models").build_model
jax_ckpt = pytest.importorskip("centerfusiondetect3d_tpu.training.checkpoint")

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RTOL = ATOL = 2e-3  # test_torch_model.py's float32 bound


def _opts(tmp_path, *extra):
    return MAIN_PATH_OPTS + [
        "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
        "MODEL.FRUSTUM", "False", "MIXED_PRECISION", "False",
        "MODEL.DLA.DCN_IMPL", "'xla'", "OUTPUT_DIR", repr(str(tmp_path)),
        "TRAIN.BATCH_SIZE", "2", "TRAIN.EPOCHS", "2",
        "TRAIN.VAL_INTERVALS", "0", "TRAIN.SAVE_INTERVALS", "1",
        "MODEL.FREEZE_BACKBONE", "False", "MODEL.DEFREEZE", "-1",
        "TRAIN.WARM_EPOCHS", "0", "TRAIN.LR", str(2.0 ** -10),
        "TRAIN.LR_STEP", "[100]", *extra]


def _inputs(seed, b=2, h=64, w=128):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, 3, h, w).astype(np.float32)
    pc_dep = np.zeros((b, 3, h // 4, w // 4), np.float32)
    hit = rng.rand(b, h // 4, w // 4) < 0.15
    pc_dep[:, 0][hit] = rng.uniform(15, 25, hit.sum())
    pc_dep[:, 1][hit] = rng.randn(hit.sum())
    pc_dep[:, 2][hit] = rng.randn(hit.sum())
    calib = np.tile(np.array([[100.0, 0, w / 2, 0], [0, 100.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    return img, pc_dep, calib


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX float32 model with random BatchNorm statistics and affine
    parameters, exported with ``export_torch_checkpoint``; its heads on
    seeded inputs."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    cfg = jax_load_config(opts=_opts(tmp), num_classes=10)
    model = jax_build_model(cfg)
    img, pc_dep, calib = _inputs(0)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), nhwc(img), None, nhwc(pc_dep),
        jnp.asarray(calib), train=False)
    rng = np.random.RandomState(1)

    def perturb(path, v):
        v = np.array(v, np.float32)
        names = [getattr(p, "key", str(p)) for p in path]
        if names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
            v = 0.1 * rng.randn(*v.shape)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb,
                                             variables["batch_stats"])
    y = model.apply({"params": params, "batch_stats": stats}, nhwc(img),
                    None, nhwc(pc_dep), jnp.asarray(calib), train=False)[-1]
    path = str(tmp / "jax_export.pt")
    history = {"train": {"total": [3.0, 2.5, 2.0]}, "val": {}}
    jax_ckpt.export_torch_checkpoint(path, params, stats, epoch=7,
                                     history=history,
                                     head_conv=dict(cfg.head_conv))
    heads = {k: np.transpose(np.asarray(v), (0, 3, 1, 2))
             for k, v in y.items() if k != "calib"}
    return cfg, params, stats, path, (img, pc_dep, calib), heads


def test_trainer_loads_jax_exported_checkpoint(jax_model, tmp_path):
    _, _, _, path, inputs, want = jax_model
    cfg = load_config(opts=_opts(tmp_path, "MODEL.LOAD_DIR", repr(path)),
                      num_classes=10)
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    assert trainer.start_epoch == 0  # the epoch is restored only on RESUME
    assert trainer.history["train"]["total"] == [3.0, 2.5, 2.0]
    model = trainer.model.eval()
    with torch.no_grad():
        y = model(*(torch.from_numpy(a) for a in inputs))
    assert sorted(k for k in y if k != "calib") == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(y[name].numpy(), value, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_port_checkpoint_reads_in_jax(jax_model, tmp_path):
    cfg, params, stats, _, _, _ = jax_model
    port_cfg = load_config(opts=_opts(tmp_path), num_classes=10)
    trainer = Trainer(port_cfg, device="cpu")
    trainer.init_state(seed=3)
    history = {"train": {"total": [5.0, 4.0], "hm": [1.0, 0.5]},
               "val": {"total": [4.5]}}
    out = checkpoint.save_checkpoint(
        os.path.join(tmp_path, "ckpts"), trainer.model, trainer.optimizer, 4,
        history)
    assert out.endswith("model_4.pt")
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["model_4.pt",
                                                      "model_last.pt"]
    payload = jax_ckpt.load_torch_file(out)
    assert payload["epoch"] == 4
    assert payload["history"] == history
    new_params, new_stats, report = jax_ckpt.import_torch_checkpoint(
        payload["state_dict"], params, stats, dict(cfg.head_conv))
    assert report["missing"] == [] and report["shape_mismatch"] == []
    assert report["loaded"]
    got = jax_ckpt.export_torch_state_dict(new_params, new_stats,
                                           dict(cfg.head_conv))
    own = trainer.model.state_dict()
    assert sorted(got) == sorted(k for k in own
                                 if not k.endswith("num_batches_tracked"))
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), own[k].numpy(),
                                      err_msg=k)
    raw = torch.load(out, map_location="cpu", weights_only=False)
    assert sorted(raw) == ["epoch", "optimizer", "state_dict", "train", "val"]
    # the JAX package's epoch keys: the last value on the epoch
    assert raw["train"]["total"] == {3: 5.0, 4: 4.0}
    assert raw["optimizer"]["state"] == {}  # no step taken yet


def test_modernize_torch_key_matches_reference():
    g = np.load(os.path.join(FIXTURES, "legacy_names.npz"))
    mapping = json.loads(bytes(g["mapping_json"]).decode())
    assert len(mapping) > 10
    for old, new in mapping.items():
        assert checkpoint.modernize_torch_key(old) == new, old
        assert checkpoint.modernize_torch_key(old) == \
            jax_ckpt.modernize_torch_key(old)


def test_load_torch_file_takes_bare_and_legacy_state_dicts(tmp_path):
    path = tmp_path / "bare.pth"
    torch.save({"module.hm.0.weight": torch.ones(2, 3),
                "base.base_layer.0.weight": np.zeros((1, 2), np.float32)},
               path)
    payload = checkpoint.load_torch_file(str(path))
    assert payload["epoch"] == -1 and payload["optimizer"] is None
    assert payload["history"] == {"train": {}, "val": {}}
    assert sorted(payload["state_dict"]) == [
        "base.base_layer.0.weight", "detectHead_0.heatmap.0.weight"]
    assert all(isinstance(v, torch.Tensor)
               for v in payload["state_dict"].values())


class _Float64Items:
    """A dataset's items with their floating arrays in float64."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get_item(self, index, rng=None):
        def cast(d):
            return {k: cast(v) if isinstance(v, dict) else (
                np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
                else v) for k, v in d.items()}
        return cast(self.dataset.get_item(index, rng))


def _trainer64(cfg, items):
    trainer = Trainer(cfg, items, device="cpu")
    trainer.model.double()
    trainer.init_state(seed=0)  # the seed is not read under LOAD_DIR
    return trainer


def test_resume_restores_epoch_and_optimizer(tmp_path):
    """Two epochs of two AdamW steps, saved every epoch; a run resumed from
    the first epoch's checkpoint takes the second epoch's steps exactly as
    the uninterrupted run did (float64), and a run that loads the same file
    without RESUME starts over at epoch 0 with a fresh optimizer."""
    cfg = load_config(opts=_opts(tmp_path / "a"), num_classes=10)
    items = _Float64Items(SyntheticTrainingSet(cfg, 4, seed=5))
    full = _trainer64(cfg, items)
    full.train()
    ckpts = tmp_path / "a" / "ckpts"
    assert sorted(os.listdir(ckpts)) == ["model_0.pt", "model_1.pt",
                                         "model_last.pt"]
    final = {k: v.clone() for k, v in full.model.state_dict().items()}

    resume_opts = ["MODEL.LOAD_DIR", repr(str(ckpts / "model_0.pt"))]
    cfg_r = load_config(opts=_opts(tmp_path / "b", *resume_opts,
                                   "TRAIN.RESUME", "True"), num_classes=10)
    resumed = _trainer64(cfg_r, items)
    assert resumed.start_epoch == 1
    assert resumed.optimizer.state_dict()["state"]
    resumed.train()
    assert [s["epoch"] for s in resumed.steps] == [1, 1]
    np.testing.assert_allclose([s["total"] for s in resumed.steps],
                               [s["total"] for s in full.steps[2:]],
                               rtol=1e-12)
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=1e-10,
                                   atol=1e-14, err_msg=k)
    assert sorted(os.listdir(tmp_path / "b" / "ckpts")) == [
        "model_1.pt", "model_last.pt"]
    assert len(resumed.history["train"]["total"]) == 2  # taken over + 1

    cfg_w = load_config(opts=_opts(tmp_path / "c", *resume_opts),
                        num_classes=10)
    warm = _trainer64(cfg_w, items)
    assert warm.start_epoch == 0
    assert warm.optimizer.state_dict()["state"] == {}


def test_saves_at_intervals_and_the_last_epoch(tmp_path):
    cfg = load_config(opts=_opts(tmp_path, "TRAIN.EPOCHS", "3",
                                 "TRAIN.SAVE_INTERVALS", "2"),
                      num_classes=10)
    trainer = Trainer(cfg, SyntheticTrainingSet(cfg, 2, seed=6),
                      device="cpu")
    trainer.train()
    assert len(trainer.steps) == 3
    assert sorted(os.listdir(tmp_path / "ckpts")) == [
        "model_1.pt", "model_2.pt", "model_last.pt"]
    last = checkpoint.load_torch_file(str(tmp_path / "ckpts" /
                                          "model_last.pt"))
    assert last["epoch"] == 2
    own = trainer.model.state_dict()
    for k, v in last["state_dict"].items():
        assert torch.equal(v, own[k]), k


def test_validation_epoch_raises_before_the_first_step(tmp_path):
    cfg = load_config(opts=_opts(tmp_path, "TRAIN.VAL_INTERVALS", "2"),
                      num_classes=10)
    trainer = Trainer(cfg, SyntheticTrainingSet(cfg, 2, seed=6),
                      device="cpu")
    with pytest.raises(ValueError, match="TRAIN.VAL_INTERVALS.*dataset_val"):
        trainer.train()
    assert trainer.steps == []
    assert not os.path.exists(tmp_path / "ckpts")


@pytest.mark.parametrize("kind", ["directory", "npz"])
def test_load_dir_that_is_not_a_pt_file_raises(tmp_path, kind):
    target = tmp_path / "model_last"
    if kind == "directory":
        target.mkdir()
    else:
        target = tmp_path / "weights.npz"
        np.savez(target, a=np.zeros(2))
    cfg = load_config(opts=_opts(tmp_path, "MODEL.LOAD_DIR",
                                 repr(str(target))), num_classes=10)
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"\.pt/\.pth"):
        trainer.init_state()


def test_trainer_raises_on_mixed_precision(tmp_path):
    """The Trainer no longer raises on MIXED_PRECISION True: it builds a
    bf16 model over float32 parameters, trains, and saves float32
    reference checkpoints that read back equal to the model."""
    cfg = load_config(opts=_opts(tmp_path, "MIXED_PRECISION", "True",
                                 "TRAIN.EPOCHS", "1"), num_classes=10)
    trainer = Trainer(cfg, SyntheticTrainingSet(cfg, 2, seed=6),
                      device="cpu")
    assert trainer.model.compute_dtype == torch.bfloat16
    trainer.init_state(seed=0)
    trainer.train()
    assert len(trainer.steps) == 1
    assert np.isfinite(trainer.steps[0]["total"])
    ckpt = checkpoint.load_torch_file(str(tmp_path / "ckpts" /
                                          "model_last.pt"))
    tensors = [v for v in ckpt["state_dict"].values() if v.is_floating_point()]
    assert tensors and {v.dtype for v in tensors} == {torch.float32}
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(ckpt["state_dict"][name], value), name
