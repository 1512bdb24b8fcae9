"""The port's training stack against the executed torch reference and JAX.

- ``learning_rate`` against ``schedule.npz`` (torch's SequentialLR) and the
  JAX package's ``learning_rate``: rtol 1e-9, both are float64 host math.
- The optimizer against ``optimizer.npz`` (torch.optim trajectories) and
  the JAX package's ``make_optimizer`` across freeze -> defreeze: rtol 1e-5,
  atol 1e-7, the JAX package's own tolerance for float32 trajectories.
- ``TargetBuilder`` against ``targets.npz`` (rtol = atol = 1e-4, the JAX
  package's) and the JAX ``TargetBuilder`` on synthetic items (exact up to
  float32 rounding: rtol 1e-6, atol 1e-6).
- One train step against ``train_step.npz`` and ``train_step_dcn.npz``,
  whose float64 anchors were executed by the reference (torchvision DCN in
  the second): the port runs in float64 too, with the tolerances of the JAX
  package's float64 worker (``tests/_x64_trainstep_worker.py``): loss parts
  1e-7 relative, gradient norms 1e-5, gradients rtol 1e-5, post-AdamW values
  rtol 1e-7, BatchNorm statistics 3e-7.
- The train step against JAX ``make_train_step`` on the same weights and
  batch, frozen, unfrozen and with ``GRAD_ACCUM 2``, and three Trainer
  steps across the defreeze boundary against a JAX loop on the same
  batches: all in float64 (``jax.enable_x64``), so two correct
  implementations agree to ~1e-12 and the limits are loss parts and
  gradient norm rtol 1e-8, parameters rtol 3e-7 (the JAX side is read
  through ``weights.state_dict_from_jax``, which rounds to float32) and
  BatchNorm statistics within 3e-7 of their largest magnitude (the JAX
  package keeps and updates them in float32). These use Conv aggregation nodes: XLA compiles the
  float64 DCN train step of the JAX package in ~90 s on the CPU; the DCN
  backward is held against JAX in ``test_torch_dcn_grad.py`` and against
  the torchvision-executed reference by ``train_step_dcn.npz`` here, and
  the DeformConv variant of the JAX comparison runs under ``-m slow``.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import stack_items, to_device
from centerfusiondetect3d_tpu_torch.data.targets import TargetBuilder
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    NUSCENES_ATT_RANGE,
    SyntheticTrainingSet,
)
from centerfusiondetect3d_tpu_torch.training import (
    learning_rate,
    make_optimizer,
    train_step,
)
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_losses = pytest.importorskip("centerfusiondetect3d_tpu.losses")
jax_state = pytest.importorskip("centerfusiondetect3d_tpu.training.state")
jax_schedule = pytest.importorskip("centerfusiondetect3d_tpu.training.schedule")
jax_targets = pytest.importorskip("centerfusiondetect3d_tpu.data.targets")
jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")
optax = pytest.importorskip("optax")

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HEADS = {"heatmap": 10, "reg": 2, "widthHeight": 2, "depth": 1,
         "rotation": 8, "dimension": 3, "amodal_offset": 2,
         "nuscenes_att": 8, "velocity": 3, "depth2": 1, "rotation2": 8}


def _load(name):
    return np.load(os.path.join(FIXTURES, name))


# ------------------------------------------------------------- schedule


@pytest.mark.parametrize("key,warm,defreeze", [
    ("warm_only", 5, -1), ("warm_defreeze", 5, 10), ("no_warm", 0, -1)])
def test_learning_rate_matches_torch_golden(key, warm, defreeze):
    g = _load("schedule.npz")
    cfg = load_config(opts=[
        "TRAIN.LR", str(float(g["base_lr"])), "TRAIN.LR_STEP", "(50, 70)",
        "TRAIN.WARM_EPOCHS", str(warm),
        "MODEL.FREEZE_BACKBONE", str(defreeze > 0),
        "MODEL.DEFREEZE", str(defreeze)], num_classes=10)
    for epoch, want in enumerate(g[key]):
        np.testing.assert_allclose(learning_rate(cfg, epoch, 0), want,
                                   rtol=1e-9, err_msg=f"{key} {epoch}")


@pytest.mark.parametrize("opts,start", [
    (["TRAIN.LR_SCHEDULER", "StepLR", "MODEL.DEFREEZE", "170",
      "TRAIN.LR_STEP", "[185, 195]"], 0),
    (["TRAIN.LR_SCHEDULER", "StepLR", "MODEL.DEFREEZE", "170",
      "TRAIN.LR_STEP", "[185, 195]"], 172),
    (["TRAIN.LR_SCHEDULER", "StepLR", "MODEL.DEFREEZE", "-1",
      "TRAIN.LR_STEP", "[20, 30]", "TRAIN.WARM_EPOCHS", "0"], 25),
    (["TRAIN.LR_SCHEDULER", "CLR", "MODEL.DEFREEZE", "20",
      "TRAIN.LR_STEP", "[15, 30, 35]"], 0),
    (["TRAIN.LR_SCHEDULER", "CLR", "MODEL.DEFREEZE", "20",
      "TRAIN.LR_STEP", "[30]"], 4),
])
def test_learning_rate_matches_jax(opts, start):
    opts = MAIN_PATH_OPTS + opts
    cfg = load_config(opts=opts, num_classes=10)
    jcfg = jax_config.load_config(opts=opts, num_classes=10)
    for epoch in range(start, start + 40):
        np.testing.assert_allclose(
            learning_rate(cfg, epoch, start),
            jax_schedule.learning_rate(jcfg, epoch, start), rtol=1e-9,
            err_msg=f"epoch {epoch}")


# ------------------------------------------------------------ optimizer


class _Params(torch.nn.Module):
    def __init__(self, *arrays):
        super().__init__()
        self.ps = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.tensor(a)) for a in arrays])


@pytest.mark.parametrize("traj_key,name", [("traj_adamw", "adam"),
                                           ("traj_sgd", "sgd")])
def test_optimizer_matches_torch_golden(traj_key, name):
    g = _load("optimizer.npz")
    assert float(g["wd"]) == 5e-4
    cfg = SimpleNamespace(TRAIN=SimpleNamespace(OPTIMIZER=name,
                                                LR=float(g["lr"])))
    model = _Params(g["p0"])
    opt = make_optimizer(cfg, model)
    for t in range(g["grads"].shape[0]):
        model.ps[0].grad = torch.tensor(g["grads"][t])
        opt.step()
        np.testing.assert_allclose(model.ps[0].detach().numpy(),
                                   g[traj_key][t], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{name} step {t}")


def test_optimizer_matches_jax_across_defreeze():
    """A frozen parameter (grad None here; zero-filled grad and masked
    update in the JAX package) and a live one, 4 frozen steps then 5 live:
    per-parameter Adam step counts make the defrosted parameter start its
    bias correction at t=1 in both. (SGD is not compared: the JAX chain
    feeds the weight decay of a frozen parameter into its momentum trace
    during the frozen steps, torch.optim.SGD and the reference do not.)"""
    name = "adam"
    rng = np.random.RandomState(5)
    lr, freeze_steps, total = 2e-3, 4, 9
    p0 = rng.randn(2, 6).astype(np.float32)
    grads = rng.randn(total, 2, 6).astype(np.float32)
    cfg = SimpleNamespace(TRAIN=SimpleNamespace(OPTIMIZER=name, LR=lr))
    model = _Params(p0[0], p0[1])
    opt = make_optimizer(cfg, model)
    for t in range(total):
        opt.zero_grad(set_to_none=True)
        if t >= freeze_steps:
            model.ps[0].grad = torch.tensor(grads[t, 0])
        model.ps[1].grad = torch.tensor(grads[t, 1])
        opt.step()

    tx = jax_state.make_optimizer(cfg)
    params = {"f": jnp.asarray(p0[0]), "l": jnp.asarray(p0[1])}
    state = tx.init(params)
    for t in range(total):
        live = t >= freeze_steps
        g = {"f": jnp.asarray(grads[t, 0]) if live else jnp.zeros(6),
             "l": jnp.asarray(grads[t, 1])}
        updates, state = tx.update(g, state, params)
        if not live:
            updates = {"f": jnp.zeros(6), "l": updates["l"]}
        params = optax.apply_updates(params, updates)
    for i, key in enumerate("fl"):
        np.testing.assert_allclose(model.ps[i].detach().numpy(),
                                   np.asarray(params[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{name} {key}")


# -------------------------------------------------------------- targets


def _target_cfg(pyramid, norm2d, hm_rep, frustum, oh=24, ow=40):
    return SimpleNamespace(
        heads=dict(HEADS),
        MODEL=SimpleNamespace(OUTPUT_SIZE=(oh, ow),
                              PYRAMID_OUT_SIZE=[tuple(p) for p in pyramid],
                              NORM_2D=norm2d, FRUSTUM=frustum),
        DATASET=SimpleNamespace(HEATMAP_REP=hm_rep, RADAR_PC=frustum,
                                MAX_PC_DIST=60.0))


@pytest.mark.parametrize("tag,pyramid,norm2d,hm_rep,frustum", [
    ("single", [(24, 40)], False, "3d", True),
    ("pyramid", [(24, 40), (48, 80)], True, "2d", False),
])
def test_target_builder_matches_reference_golden(tag, pyramid, norm2d,
                                                 hm_rep, frustum):
    g = _load("targets.npz")
    anns = json.loads(bytes(g["anns_json"]).decode())
    tb = TargetBuilder(_target_cfg(pyramid, norm2d, hm_rep, frustum),
                       num_classes=10, max_objs=16,
                       nuscenes_att_range=NUSCENES_ATT_RANGE)
    trans_out = g[f"{tag}_trans_out"].astype(np.float32)
    hwc = lambda a: np.transpose(a, (1, 2, 0))
    item = tb.init_item()
    pc_dep = pc_hm = None
    if frustum:
        pc_dep = hwc(g[f"{tag}_pc_dep"]).copy()
        pc_hm = np.zeros_like(pc_dep)
    for i, ann in enumerate(anns):
        bbox = tb.transform_bbox(ann["bbox"], trans_out)
        np.testing.assert_allclose(bbox, g[f"{tag}_bbox{i}"], rtol=1e-4,
                                   atol=1e-3, err_msg=f"bbox {i}")
        tb.add_instance(item, i, int(g[f"{tag}_class_ids"][i]),
                        g[f"{tag}_bbox{i}"].astype(np.float32), ann,
                        trans_out, float(g[f"{tag}_scale_factor"]),
                        calib=g["calib"], pc_dep=pc_dep, pc_hm=pc_hm)
    target = item.pop("target")
    compared = 0
    for key in g.files:
        if key.startswith(f"{tag}_item_"):
            name, ours = key[len(tag) + 6:], item
        elif key.startswith(f"{tag}_target_"):
            name, ours = key[len(tag) + 8:], target
        else:
            continue
        if name in ("pc_dep", "pc_hm", "calib"):
            continue
        if ours is target and name in ("nuscenes_att", "velocity"):
            assert not g[key].any()  # allocated, never written, by both
            continue
        want = hwc(g[key]) if name.startswith("heatmap") else g[key]
        np.testing.assert_allclose(ours[name], want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{tag}:{name}")
        compared += 1
    assert compared >= 15, compared
    if frustum:
        np.testing.assert_allclose(pc_hm, hwc(g[f"{tag}_item_pc_hm"]),
                                   rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_target_builder_matches_jax_on_synthetic_items():
    opts = MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(128, 256)"]
    cfg = load_config(opts=opts, num_classes=10)
    jcfg = jax_config.load_config(opts=opts, num_classes=10)
    ds = SyntheticTrainingSet(cfg, 3, seed=4)
    jtb = jax_targets.TargetBuilder(jcfg, 10, 128, NUSCENES_ATT_RANGE)
    for i in range(len(ds)):
        item = ds.get_item(i)
        want = _flat(jtb.build(ds.annotations(i), {}, ds.trans_out, 1.0,
                               calib=ds.calib, pc_dep=item["pc_dep"]))
        got = _flat(item)
        assert set(want) <= set(got)
        assert got["mask"].sum() >= 3 and got["pc_hm"].any()
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-6,
                                       err_msg=f"item {i} {key}")


# ------------------------------------- one train step vs the executed reference


def _golden_step(fixture, sd_fixture, node):
    g = _load(fixture)
    sd_src = _load(sd_fixture)
    lr = float(g["lr"])
    cfg = load_config(opts=[
        "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", node,
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "False",
        "MODEL.FUSION_STRATEGY", "'middle'",
        "LOSS_WEIGHTS.LIDAR_DEPTH", "0.7", "LOSS_WEIGHTS.RADAR_DEPTH", "0.6",
        "TRAIN.OPTIMIZER", "'adam'", "TRAIN.LR", str(lr),
        "MIXED_PRECISION", "False"], num_classes=10)
    sd = {k[3:]: sd_src[k] for k in sd_src.files if k.startswith("sd_")}
    sd.update({k[5:]: g[k] for k in g.files if k.startswith("pert_")})
    checksum = float(sum(np.sum(v, dtype=np.float64) for v in sd.values()))
    assert abs(checksum - float(g["sd_checksum"])) < 1e-3 * max(
        1.0, abs(checksum))
    model = build_model(cfg).double()
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in sd.items()}, strict=True)
    f64 = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.astype(np.float64) if a.dtype.kind == "f" else a))
    batch = {"image": f64(g["in_img"]), "pc_hm": f64(g["in_pc_hm"]),
             "pc_dep": f64(g["in_pc_dep"]), "calib": f64(g["in_calib"])}
    for k in g.files:
        if k.startswith("batch_"):
            v = g[k]
            if k[6:] in ("pc_lidar", "pc_2d"):
                v = np.transpose(v, (0, 2, 1))  # (B, 3, N) -> (B, N, 3)
            batch[k[6:]] = f64(v)
    batch["target"] = {k[7:]: f64(g[k]) for k in g.files
                       if k.startswith("target_")}
    opt = make_optimizer(cfg, model)
    metrics = train_step(model, opt, GenericLoss(cfg), batch, lr)
    return g, model, metrics


@pytest.mark.parametrize("fixture,sd_fixture,node", [
    ("train_step.npz", "model_forward.npz", "Conv"),
    ("train_step_dcn.npz", "model_forward_dcn.npz", "DeformConv"),
])
def test_train_step_matches_reference_f64(fixture, sd_fixture, node):
    g, model, metrics = _golden_step(fixture, sd_fixture, node)
    compared = 0
    for k in g.files:
        if k.startswith("loss64_") and k != "loss64_total_ret":
            want = float(g[k])
            got = float(metrics[k[7:]])
            assert abs(got - want) <= 1e-7 * abs(want) + 1e-9, (k, got, want)
            compared += 1
    assert compared >= 12, compared
    want = float(g["loss64_total_ret"])
    assert abs(float(metrics["total"]) - want) <= 1e-7 * abs(want)

    params = dict(model.named_parameters())
    want_norm = dict(zip((str(n) for n in g["grad_names"]),
                         g["grad_norms64"]))
    assert sorted(want_norm) == sorted(params)
    for name, p in params.items():
        got = float(torch.linalg.vector_norm(p.grad))
        assert abs(got - want_norm[name]) <= 1e-5 * want_norm[name] + 1e-7, (
            name, got, want_norm[name])
    for i, name in enumerate(str(n) for n in g["sub_names"]):
        want_g = g[f"subgrad64_{i}"]
        np.testing.assert_allclose(
            params[name].grad.numpy(), want_g, rtol=1e-5,
            atol=1e-8 * max(1e-9, float(np.abs(want_g).max())),
            err_msg=f"grad {name}")
        want_p = g[f"subpost64_{i}"]
        np.testing.assert_allclose(
            params[name].detach().numpy(), want_p, rtol=1e-7,
            atol=1e-9 * max(1e-9, float(np.abs(want_p).max())),
            err_msg=f"post-AdamW {name}")

    buffers = dict(model.named_buffers())
    for name, want in zip((str(n) for n in g["bnstat_names"]),
                          g["bnstat_norms64"]):
        got = float(torch.linalg.vector_norm(buffers[name].double()))
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-9,
                                   err_msg=f"bn stat {name}")
    full = [k for k in g.files if k.startswith("bnfull64_")]
    assert full
    for k in full:
        np.testing.assert_allclose(buffers[k[9:]].numpy(), g[k], rtol=3e-7,
                                   atol=1e-9, err_msg=k)


# ---------------------------------------------- the train step vs JAX, float64


def _small_opts(node):
    return MAIN_PATH_OPTS + [
        "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", node,
        "MODEL.DLA.DCN_IMPL", "'xla'", "MIXED_PRECISION", "False",
        # 2^-10: this LR and its warm-up halvings are exact in float32, in
        # which the JAX step holds the LR
        "TRAIN.LR", str(2.0 ** -10), "TRAIN.BATCH_SIZE", "2",
        "TRAIN.EPOCHS", "2",
        "MODEL.DEFREEZE", "0", "TRAIN.WARM_EPOCHS", "1"]


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


class _JaxReference:
    """The JAX package's model, loss and jitted train steps in float64, with
    weights from a seed that float32 represents exactly (so that the port
    loads the very same numbers through ``state_dict_from_jax``)."""

    def __init__(self, node):
        self.opts = _small_opts(node)
        self.port_cfg = load_config(opts=self.opts, num_classes=10)
        self.items = _Float64Items(SyntheticTrainingSet(self.port_cfg, 4,
                                                        seed=1))
        self.batch4 = stack_items([self.items.get_item(i) for i in range(4)])
        self.steps = {}
        with jax.enable_x64(True):
            self.cfg = jax_config.load_config(opts=self.opts, num_classes=10)
            self.model = jax_models.build_model(self.cfg, dtype=jnp.float64)
            self.loss_fn = jax_losses.GenericLoss(self.cfg)
            b = self._jax_batch(self.batch4)
            variables = jax.jit(self.model.init, static_argnames=("train",))(
                jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
                b["calib"], train=True)
        rng = np.random.RandomState(7)

        def perturb(path, v):
            v = np.array(v, np.float64)
            names = [getattr(p, "key", str(p)) for p in path]
            if names[-1] in ("kernel", "weight") and not any(
                    n.startswith("up_") for n in names):
                v = v * np.sqrt(6.0)  # He scale: signal survives DLA-34
            elif names[-1] in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif names[-1] == "mean" or (names[-1] == "bias"
                                         and "bn" in names):
                v = 0.1 * rng.randn(*v.shape)
            elif names[-1] == "bias":
                v = v + 0.05 * rng.randn(*v.shape)
            return v.astype(np.float32).astype(np.float64)

        self.params = jax.tree_util.tree_map_with_path(perturb,
                                                       variables["params"])
        self.stats = jax.tree_util.tree_map_with_path(
            perturb, variables["batch_stats"])
        self.state_dict = state_dict_from_jax(self.params, self.stats,
                                              self.cfg.head_conv)

    @staticmethod
    def _jax_batch(batch):
        return jax.tree.map(jnp.asarray, batch)

    def state(self, params=None, stats=None):
        with jax.enable_x64(True):
            state = jax_state.create_train_state(
                self.cfg, self.model,
                {"params": jax.tree.map(jnp.asarray, params or self.params),
                 # the JAX package keeps BatchNorm statistics in float32
                 "batch_stats": jax.tree.map(
                     lambda a: jnp.asarray(a, jnp.float32),
                     stats or self.stats)})
            # a step returns the LR hyperparameter in float64; start with
            # one, or the second call would trace anew
            state.opt_state.hyperparams["learning_rate"] = jnp.asarray(
                0.0, jnp.float64)
        return state

    def step(self, state, batch, lr, frozen, accum=1):
        key = (frozen, accum)
        with jax.enable_x64(True):
            if key not in self.steps:
                self.steps[key] = jax.jit(jax_state.make_train_step(
                    self.model, self.loss_fn, freeze_backbone=frozen,
                    accum_steps=accum))
            state, metrics = self.steps[key](state, self._jax_batch(batch),
                                             lr)
            return state, {k: float(v) for k, v in metrics.items()}

    def port_model(self):
        model = build_model(self.port_cfg).double()
        model.load_state_dict(self.state_dict, strict=True)
        return model


@pytest.fixture(scope="module")
def conv_ref():
    return _JaxReference("Conv")


def _compare_step(ref, frozen, accum, batch_size):
    batch = {k: v[:batch_size] if not isinstance(v, dict) else
             {kk: vv[:batch_size] for kk, vv in v.items()}
             for k, v in ref.batch4.items()}
    lr = 2.0 ** -10
    model = ref.port_model()
    opt = make_optimizer(ref.port_cfg, model)
    metrics = train_step(model, opt, GenericLoss(ref.port_cfg),
                         to_device(batch, "cpu"), lr, frozen, accum)
    state, want = ref.step(ref.state(), batch, lr, frozen, accum)
    assert set(want) == set(metrics)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    new_sd = state_dict_from_jax(state.params, state.batch_stats,
                                 ref.cfg.head_conv)
    got_sd = model.state_dict()
    changed = {"base": 0, "detectHead_0": 0}
    for key, want_t in new_sd.items():
        got = got_sd[key].float().numpy()
        want_n = want_t.numpy()
        # the JAX package updates BatchNorm statistics in float32
        atol = (3e-7 * float(np.abs(want_n).max()) if "running" in key
                else 1e-10)
        np.testing.assert_allclose(got, want_n, rtol=3e-7, atol=atol,
                                   err_msg=key)
        top = key.split(".")[0]
        if top in changed and "running" not in key and not np.array_equal(
                want_t.numpy(), ref.state_dict[key].numpy()):
            changed[top] += 1
    assert changed["detectHead_0"] > 0
    assert (changed["base"] == 0) == frozen, changed


@pytest.mark.parametrize("frozen,accum,batch_size", [
    (True, 1, 2), (False, 1, 2), (False, 2, 4)],
    ids=["frozen", "unfrozen", "grad_accum_2"])
def test_train_step_matches_jax_f64(conv_ref, frozen, accum, batch_size):
    _compare_step(conv_ref, frozen, accum, batch_size)


def test_train_step_rejects_batch_grad_accum_does_not_divide(conv_ref):
    model = conv_ref.port_model()
    batch = to_device(conv_ref.batch4, "cpu")
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        train_step(model, make_optimizer(conv_ref.port_cfg, model),
                   GenericLoss(conv_ref.port_cfg), batch, 2.0 ** -10,
                   accum_steps=3)


def test_trainer_steps_across_defreeze_match_jax_f64(conv_ref, tmp_path):
    """FREEZE_BACKBONE, DEFREEZE 0, 2 epochs of 2 steps: two frozen steps,
    then unfrozen ones; the per-step losses of the port's Trainer against
    a JAX make_train_step loop fed the JAX Loader's batches (same order).
    The last epoch's checkpoint goes to a temporary OUTPUT_DIR."""
    cfg = conv_ref.port_cfg.clone()
    cfg.defrost()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.freeze()
    trainer = Trainer(cfg, conv_ref.items, device="cpu")
    trainer.model.double()
    trainer.init_state(state_dict=conv_ref.state_dict)
    trainer.train()
    assert [s["frozen"] for s in trainer.steps] == [True, True, False, False]

    loader = jax_pipeline.Loader(conv_ref.items, 2, shuffle=True,
                                 seed=cfg.RANDOM_SEED, num_threads=1,
                                 prefetch=0)
    state = conv_ref.state()
    want = []
    for epoch in range(2):
        loader.epoch = epoch
        lr = jax_schedule.learning_rate(conv_ref.cfg, epoch, 0)
        for batch in loader:
            state, metrics = conv_ref.step(state, batch, lr, epoch <= 0)
            want.append(metrics["total"])
    got = [s["total"] for s in trainer.steps]
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert sorted(trainer.history["train"]["total"]) and len(
        trainer.history["train"]["total"]) == 2
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["model_1.pt",
                                                      "model_last.pt"]


@pytest.mark.slow
def test_train_step_matches_jax_f64_deformconv():
    """The unfrozen step with DeformConv nodes (~2 min of XLA compile)."""
    _compare_step(_JaxReference("DeformConv"), False, 1, 2)


def test_loader_and_to_device_match_jax_order_and_layout():
    cfg = load_config(opts=MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(64, 128)"],
                      num_classes=10)
    ds = SyntheticTrainingSet(cfg, 5, seed=2)
    from centerfusiondetect3d_tpu_torch.data.pipeline import Loader

    port = Loader(ds, 2, shuffle=True, seed=3)
    ref = jax_pipeline.Loader(ds, 2, shuffle=True, seed=3, num_threads=1,
                              prefetch=0)
    assert len(port) == len(ref) == 2
    for epoch in range(2):
        port.epoch = ref.epoch = epoch
        batches = list(port)
        want = list(ref)
        assert len(batches) == len(want) == 2
        for got, exp in zip(batches, want):
            got_f, exp_f = _flat(got), _flat(exp)
            assert sorted(got_f) == sorted(exp_f)
            for k in exp_f:
                np.testing.assert_array_equal(got_f[k], exp_f[k], err_msg=k)
    dev = to_device(batches[0], "cpu")
    for key in ("image", "pc_dep", "pc_hm", "heatmap0"):
        np.testing.assert_array_equal(
            dev[key].numpy(), np.transpose(batches[0][key], (0, 3, 1, 2)))
        assert dev[key].is_contiguous()
    np.testing.assert_array_equal(dev["target"]["bboxes3d"].numpy(),
                                  batches[0]["target"]["bboxes3d"])
