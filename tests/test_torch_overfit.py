"""``tools/overfit.py`` against ``scripts/overfit_tpu.py``'s JAX loop.

- The loss sequence of the tool's loop (``run_steps``: frozen steps at
  ``LR_FROZEN`` before the boundary, unfrozen ones at ``LR_UNFROZEN`` after,
  one AdamW) equals a JAX ``make_train_step`` loop (``freeze_backbone`` before
  the boundary) on the same weights (``weights.state_dict_from_jax``) and the
  same batch: the script's synthetic scene at a toy size (128x64, Conv
  nodes), 5 steps across a boundary at 2, in float64 (a train step of a
  random DLA-34 is chaotic in float32; PRs 5 and 16). Tolerance: rtol 1e-8.
- The script's assertions (``check_losses``) pass on a sequence that meets
  them and fail on each clause broken; ``gt_recovery`` counts as the script.
- The offset table read through forward hooks equals the script's
  ``capture_intermediates`` table on the same DeformConv weights (JAX's
  exact ``xla`` DCN, float32, offset convs drawn so offsets are ~1 px):
  every node's mean, p99 and max within rtol 1e-4, in call order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.data.pipeline import to_device
from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_nuscenes)
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.tools import overfit
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_losses = pytest.importorskip("centerfusiondetect3d_tpu.losses")
jax_state = pytest.importorskip("centerfusiondetect3d_tpu.training")

torch.set_num_threads(2)
TOY_WH = (128, 64)
STEPS, DEFREEZE = 5, 2
LOSS_RTOL = 1e-8
OFFSET_RTOL = 1e-4


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The script's scene at 128x64: (root, numpy batch in float64)."""
    root = str(tmp_path_factory.mktemp("overfit"))
    make_synthetic_nuscenes(root, n_samples=overfit.N_SAMPLES,
                            img_wh=TOY_WH, n_objects=overfit.N_OBJECTS,
                            seed=overfit.DATA_SEED)
    cfg = overfit.overfit_config(root, TOY_WH, ["MIXED_PRECISION", "False"])
    _, batch, _ = overfit.make_batch(cfg, "cpu")
    return root, _cast(batch, np.float64)


def _cast(batch, dtype):
    """The batch with its floating arrays in ``dtype`` (nested dicts too)."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else (
        np.asarray(v, dtype) if np.asarray(v).dtype.kind == "f" else v)
        for k, v in batch.items()}


def _jax_model(opts, dtype):
    cfg = jax_config.load_config(opts=opts, num_classes=10)
    return cfg, jax_models.build_model(cfg, dtype=dtype)


def test_loss_sequence_equals_jax_train_step_loop(toy):
    root, batch = toy
    opts = ["MODEL.DLA.NODE", "Conv", "MIXED_PRECISION", "False"]
    port_cfg = overfit.overfit_config(root, TOY_WH, opts)
    jax_opts = (["DATASET.ROOT", repr(root + "/"), "MODEL.INPUT_SIZE",
                 f"({TOY_WH[1]}, {TOY_WH[0]})"] + overfit.OPTS + opts)
    with jax.enable_x64(True):
        cfg, model = _jax_model(jax_opts, jnp.float64)
        loss_fn = jax_losses.GenericLoss(cfg)
        b = jax.tree.map(jnp.asarray, batch)
        variables = jax.jit(model.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
            b["calib"], train=True)
        variables = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64),
            variables)
        state = jax_state.create_train_state(cfg, model, {
            "params": variables["params"],
            "batch_stats": jax.tree.map(lambda a: a.astype(jnp.float32),
                                        variables["batch_stats"])})
        state.opt_state.hyperparams["learning_rate"] = jnp.asarray(
            0.0, jnp.float64)
        steps = {f: jax.jit(jax_state.make_train_step(
            model, loss_fn, freeze_backbone=f)) for f in (True, False)}
        want = []
        for i in range(STEPS):
            frozen = i < DEFREEZE
            state, metrics = steps[frozen](
                state, b, overfit.LR_FROZEN if frozen else overfit.LR_UNFROZEN)
            want.append(float(metrics["total"]))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             cfg.head_conv)
    port = build_model(port_cfg).double()
    port.load_state_dict(sd, strict=True)
    logged = []
    got = overfit.run_steps(port, port_cfg, to_device(batch, "cpu"), STEPS,
                            DEFREEZE, log=logged.append)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    assert any("DEFREEZE boundary" in line for line in logged)


def _losses(first=50.0, pre=3.0, spike=400.0, post_last=20.0, last=5.0):
    """A 20-step sequence with its boundary at 10, shaped as the card's."""
    seq = [first] + [pre] * 9
    seq += [pre * 0.9, spike, spike / 2, spike / 10, post_last]
    seq += list(np.linspace(post_last * 0.8, last, 5))
    return seq


def test_check_losses_passes_the_scripts_shape():
    rec = overfit.check_losses(_losses(), 10)
    assert rec["pre"] == 3.0 and rec["at_boundary"] == pytest.approx(2.7)
    assert rec["post_max"] == 400.0 and rec["last"] == 5.0
    assert rec["ratio"] == pytest.approx(10.0)


@pytest.mark.parametrize("kw,why", [
    (dict(last=11.0), "fall 5x"),
    (dict(pre=3.0, first=50.0, spike=400.0, post_last=20.0, last=9.9),
     None),
    (dict(spike=float("inf")), "non-finite"),
    (dict(post_last=61.0, last=5.0), "no recovery"),
    (dict(post_last=4.0, last=5.0), "no descent"),
])
def test_check_losses_fails_each_clause(kw, why):
    seq = _losses(**kw)
    if why is None:  # within every limit
        overfit.check_losses(seq, 10)
        return
    with pytest.raises(AssertionError, match=why):
        overfit.check_losses(seq, 10)


def test_check_losses_discontinuous_boundary():
    seq = _losses()
    seq[10] = 3.0 + 1.81  # max(1, 0.6 * 3) = 1.8 from the frozen mean
    with pytest.raises(AssertionError, match="discontinuous"):
        overfit.check_losses(seq, 10)
    seq[10] = 3.0 + 1.79
    overfit.check_losses(seq, 10)


class _Coco:
    def __init__(self, anns):
        self.anns = anns

    def get_ann_ids(self, img_id):
        return [i for i, a in enumerate(self.anns) if a["image_id"] == img_id]

    def load_anns(self, ids):
        return [self.anns[i] for i in ids]


class _Dataset:
    def __init__(self, anns, images):
        self.coco, self.images = _Coco(anns), images


def test_gt_recovery_counts_as_the_script():
    anns = [{"image_id": 7, "category_id": 1, "depth": 20.0},
            {"image_id": 7, "category_id": 2, "depth": 10.0},
            {"image_id": 8, "category_id": 1, "depth": 30.0}]
    ds = _Dataset(anns, [7, 8])
    scores = np.array([[0.9, 0.3, 0.1], [0.26, 0.9, 0.0]])
    classes = np.array([[1, 2, 1], [1, 3, 1]])
    locs = np.zeros((2, 3, 3))
    locs[0, :, 2] = [23.9, 10.0, 20.0]  # hit (within 20 %), hit, low score
    locs[1, :, 2] = [23.9, 30.0, 30.0]  # 23.9 misses 30 by > 20 %
    assert overfit.gt_recovery(ds, scores, locs, classes) == (2, 1)
    scores[1, 0] = 0.25  # not above SCORE_MIN
    locs[1, 0, 2] = 30.0
    assert overfit.gt_recovery(ds, scores, locs, classes) == (2, 1)
    scores[1, 0] = 0.2501
    assert overfit.gt_recovery(ds, scores, locs, classes) == (3, 0)


def test_offset_table_equals_capture_intermediates(toy):
    """The hooks' table against the script's capture on the same weights."""
    root, batch = toy
    opts = ["MIXED_PRECISION", "False", "MODEL.DLA.DCN_IMPL", "'xla'"]
    cfg, model = _jax_model(["DATASET.ROOT", repr(root + "/"),
                             "MODEL.INPUT_SIZE",
                             f"({TOY_WH[1]}, {TOY_WH[0]})"]
                            + overfit.OPTS + opts, jnp.float32)
    b = jax.tree.map(jnp.asarray, _cast(batch, np.float32))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
        b["calib"], train=False)
    rng = np.random.RandomState(5)

    def draw(path, v):
        names = [getattr(p, "key", str(p)) for p in path]
        v = np.array(v, np.float32)
        if "conv_offset_mask" in names and names[-1] == "kernel":
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            v = (rng.randn(*v.shape) * 1.5 / np.sqrt(fan_in)).astype(
                np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = variables["batch_stats"]
    inter = model.apply(
        {"params": params, "batch_stats": stats}, b["image"], b["pc_hm"],
        b["pc_dep"], b["calib"], train=False,
        capture_intermediates=lambda mdl, name: mdl.name == "conv_offset_mask",
        mutable=["intermediates"])[1]["intermediates"]

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + (k,))
        else:
            yield path, tree

    want = []
    for path, v in walk(inter):
        if "conv_offset_mask" in path and path[-1] == "__call__":
            off = np.abs(np.asarray(v[0], np.float32)[..., :18])
            want.append(("/".join(path[:-2]), off.mean(),
                         np.percentile(off, 99), off.max()))
    port_cfg = overfit.overfit_config(root, TOY_WH, ["MIXED_PRECISION",
                                                     "False"])
    port = build_model(port_cfg)
    port.load_state_dict(state_dict_from_jax(params, stats, cfg.head_conv),
                         strict=True)
    got = overfit.offset_table(port, to_device(_cast(batch, np.float32),
                                               "cpu"))
    assert len(got) == len(want) == 16
    for (gname, *g), (wname, *w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OFFSET_RTOL,
                                   err_msg=f"{gname} / {wname}")
        assert min(g) > 0  # drawn offset convs: the table sees offsets


def test_fresh_head_biases_are_jax_init(toy):
    """The overfit and the campaign train from the model's own
    initialisers: every head-tower bias of a fresh port model starts where
    JAX's ``model.init`` puts it (zero; the heatmap's last layer -4.6)."""
    root, batch = toy
    opts = ["MODEL.DLA.NODE", "Conv", "MIXED_PRECISION", "False"]
    cfg, model = _jax_model(["DATASET.ROOT", repr(root + "/"),
                             "MODEL.INPUT_SIZE",
                             f"({TOY_WH[1]}, {TOY_WH[0]})"]
                            + overfit.OPTS + opts, jnp.float32)
    b = jax.tree.map(jnp.asarray, _cast(batch, np.float32))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
        b["calib"], train=False)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"],
                               cfg.head_conv)
    torch.manual_seed(0)
    port = build_model(overfit.overfit_config(root, TOY_WH, opts))
    biases = {k: v for k, v in port.state_dict().items()
              if k.startswith("detectHead") and k.endswith("bias")}
    assert len(biases) > 20
    for key, value in biases.items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(),
                                      err_msg=key)
