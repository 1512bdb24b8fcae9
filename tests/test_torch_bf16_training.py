"""bf16 mixed-precision training (``MIXED_PRECISION True``, as every shipped
config trains): the port's ``train_step`` on a bf16 model against the JAX
package's ``make_train_step`` on its bf16 model, bf16 blocks with
train-mode BatchNorm against JAX's, the Trainer across the defreeze in bf16,
and (``-m slow``) the seeded model's defreeze at 448x800.

The two frameworks round bf16 at other places (XLA on the CPU also keeps
fused chains of bf16 operations in float32), so the port is held against
JAX relative to a float64 step (the port's ``train_step`` on a float64 model
with the same weights and batch, which ``test_torch_training.py`` holds to
JAX's float64 step within 1e-8). A deviation is relative: to the float64
value for a scalar (loss parts, ``grad_norm``), in the L2 norm for a
gradient tensor.

With train-mode BatchNorm (the shipped setting) a whole bf16 step of this
model at 64x128 and B=2 is chaotic: on the JAX package's initialization a
float32 step's gradients lie a median 2.6e-4 of their norm off the float64
ones but a bf16 step's 0.2-0.8, in both frameworks, and rounding the
image to bf16 alone moves the float64 gradients as far. Batch statistics
over a handful of positions per channel turn each ReLU or max-pool that a
rounding flips into an O(1) change. No limit on such a step tells a
correct backward from a zeroed one, so the whole-step comparison runs with
``MODEL.NORM_EVAL True`` (an option of both packages: BatchNorm normalizes
with its running statistics), where a float32 step lies 2e-7 off float64
and a bf16 step a median 5e-2; train-mode BatchNorm in bf16 is held per
block, where it is not chaotic (``test_bf16_block_in_train_mode_matches_jax``
here, ``DeformConvNode`` in ``test_torch_dcn_bf16_grad.py``).

The noise of each quantity is the largest of its deviations in several
draws of the same computation: the JAX bf16 step, the float64 step on the
image rounded to bf16, and ``N_DRAWS`` float64 steps with every parameter
and the image scaled elementwise by 1 + u, |u| <= 2**-8 (half a bf16
spacing). Each quantity of the port's bf16 step lies within ``STEP_MULT``
times its own noise plus a floor (``STEP_FLOOR`` for a scalar,
``GRAD_FLOOR`` for a tensor). One draw alone is too few: a few
object centres carry a head's gradient, and a ReLU that a rounding flips
there moves one draw of a head tensor ten times more than the others. The
limit of every gradient tensor stays below 1, so a gradient that is zeroed,
doubled or of the wrong sign fails (the test asserts this of its own
limits). JAX's gradients are read through an optimizer that records them
instead of updating (``_recording_tx``), so the compared step is
``make_train_step`` itself.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import stack_items, to_device
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.dla import Tree
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    SyntheticTrainingSet,
    seeded_weights,
)
from centerfusiondetect3d_tpu_torch.training import make_optimizer, train_step
from centerfusiondetect3d_tpu_torch.training.checkpoint import load_torch_file
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
jax_losses = pytest.importorskip("centerfusiondetect3d_tpu.losses")
jax_state = pytest.importorskip("centerfusiondetect3d_tpu.training.state")

torch.set_num_threads(2)

STEP_MULT, STEP_FLOOR, GRAD_FLOOR = 2.0, 1e-3, 1e-2
N_DRAWS = 2
LR = 2.0 ** -10
BACKBONE = ("base.", "dla_up.", "ida_up.")


def _opts(node, *extra):
    return MAIN_PATH_OPTS + [
        "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", node,
        "MODEL.DLA.DCN_IMPL", "'xla'", "MIXED_PRECISION", "True",
        "MODEL.NORM_EVAL", "True",
        "TRAIN.LR", str(LR), "TRAIN.BATCH_SIZE", "2", "TRAIN.EPOCHS", "2",
        "MODEL.DEFREEZE", "0", "TRAIN.WARM_EPOCHS", "1", *extra]


def _recording_tx():
    """An optimizer for ``make_train_step`` that applies no update and keeps
    the step's gradient in its state (``inner_state["grads"]``)."""
    def make(learning_rate):
        del learning_rate
        return optax.GradientTransformation(
            lambda params: {"grads": jax.tree.map(jnp.zeros_like, params)},
            lambda grads, state, params=None: (
                jax.tree.map(jnp.zeros_like, grads), {"grads": grads}))
    return optax.inject_hyperparams(make)(learning_rate=0.0)


class _Bf16Reference:
    """The JAX package's bf16 model and jitted ``make_train_step`` on JAX's
    own initialization (BatchNorm affine and statistics drawn at random,
    values that float32 represents exactly), and the port's configuration
    and batch of the same items."""

    def __init__(self, node):
        opts = _opts(node)
        self.port_cfg = load_config(opts=opts, num_classes=10)
        items = SyntheticTrainingSet(self.port_cfg, 4, seed=1)
        self.batch4 = stack_items([items.get_item(i) for i in range(4)])
        self.cfg = jax_config.load_config(opts=opts, num_classes=10)
        assert self.cfg.MIXED_PRECISION
        self.model = jax_models.build_model(self.cfg)
        self.loss_fn = jax_losses.GenericLoss(self.cfg)
        b = jax.tree.map(jnp.asarray, self.batch4)
        variables = jax.jit(self.model.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
            b["calib"], train=True)
        rng = np.random.RandomState(3)

        def perturb(path, v):
            v = np.array(v, np.float32)
            names = [getattr(p, "key", str(p)) for p in path]
            if names[-1] in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
                v = 0.1 * rng.randn(*v.shape)
            elif (names[-1] == "kernel" and "conv_offset_mask" in names):
                v = rng.randn(*v.shape) * 1.5 / np.sqrt(np.prod(v.shape[:3]))
            return np.asarray(v, np.float32)

        self.params = jax.tree_util.tree_map_with_path(perturb,
                                                       variables["params"])
        self.stats = jax.tree_util.tree_map_with_path(
            perturb, variables["batch_stats"])
        self.state_dict = state_dict_from_jax(self.params, self.stats,
                                              self.cfg.head_conv)
        self.steps = {}

    def batch(self, size):
        return {k: v[:size] if not isinstance(v, dict) else
                {kk: vv[:size] for kk, vv in v.items()}
                for k, v in self.batch4.items()}

    def jax_step(self, batch, frozen, accum):
        """make_train_step's metrics and gradients (named as the port's
        parameters, float64 numpy)."""
        key = (frozen, accum)
        if key not in self.steps:
            self.steps[key] = jax.jit(jax_state.make_train_step(
                self.model, self.loss_fn, freeze_backbone=frozen,
                accum_steps=accum))
        tx = _recording_tx()
        state = jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=self.params,
            batch_stats=self.stats, opt_state=tx.init(self.params), tx=tx)
        state, metrics = self.steps[key](
            state, jax.tree.map(jnp.asarray, batch), LR)
        grads = state_dict_from_jax(state.opt_state.inner_state["grads"], {},
                                    self.cfg.head_conv)
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.double().numpy() for k, v in grads.items()})

    def port_step(self, batch, frozen, accum, dtype, state_dict=None):
        """The port's train_step on a bf16 (``dtype`` None: as the config
        says) or float64 model with these weights (or ``state_dict``):
        metrics, gradients and the model."""
        model = build_model(self.port_cfg, dtype)
        model.load_state_dict(self.state_dict if state_dict is None
                              else state_dict, strict=True)
        tb = to_device(batch, "cpu")
        if dtype == torch.float64:
            tb = {k: ({kk: vv.double() if vv.is_floating_point() else vv
                       for kk, vv in v.items()} if isinstance(v, dict) else
                      (v.double() if v.is_floating_point() else v))
                  for k, v in tb.items()}
        metrics = train_step(model, make_optimizer(self.port_cfg, model),
                             GenericLoss(self.port_cfg), tb, LR, frozen,
                             accum)
        # the heads return float32 to a bf16 model's losses, and the
        # gradient norm sums float32 gradients: nothing of them is bf16
        want = torch.float32 if dtype is None else dtype
        assert {v.dtype for v in metrics.values()} == {want}
        grads = {n: p.grad.double().numpy()
                 for n, p in model.named_parameters() if p.grad is not None}
        return {k: float(v) for k, v in metrics.items()}, grads, model


@pytest.fixture(scope="module")
def conv_ref():
    return _Bf16Reference("Conv")


def _noise_draws(ref, batch, frozen, accum):
    """The float64 step's metrics and gradients on the image rounded to
    bf16, and on N_DRAWS jitterings of the parameters and the image."""
    draws = [ref.port_step(dict(batch, image=_bf16_rounded(batch["image"])),
                           frozen, accum, torch.float64)[:2]]
    for seed in range(N_DRAWS):
        gen = torch.Generator().manual_seed(seed)
        sd = _jittered_state(ref.state_dict, gen)
        image = _jitter(torch.from_numpy(batch["image"]), gen).numpy()
        draws.append(ref.port_step(dict(batch, image=image), frozen, accum,
                                   torch.float64, sd)[:2])
    return draws


def _jitter(t, gen):
    """``t`` scaled elementwise by 1 + u, |u| <= 2**-8: half a bf16
    spacing."""
    u = torch.rand(t.shape, generator=gen, dtype=torch.float64)
    return (t.double() * (1 + (u - 0.5) * 2.0 ** -7)).to(t.dtype)


def _jittered_state(state_dict, gen):
    """The parameters jittered; the BatchNorm statistics (float32 in a bf16
    model too) as they are."""
    return {k: _jitter(v, gen) if v.is_floating_point() and "running" not in k
            else v for k, v in state_dict.items()}


def _bf16_rounded(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _deviation(got, want) -> float:
    """Relative to the float64 value: |a - b| / |b| for a scalar, the L2
    norm of the difference over that of the tensor."""
    return float(np.linalg.norm(np.subtract(got, want))) / max(
        float(np.linalg.norm(want)), 1e-30)


def _rows(port, draws, ref):
    """(name, port deviation, noise) per quantity of ``ref`` (a dict of
    float64 values); the noise is the largest deviation of the draws."""
    return [(name, _deviation(port[name], want),
             max(_deviation(d[name], want) for d in draws))
            for name, want in ref.items()]


def _assert_within_noise(rows, what, floor=GRAD_FLOOR):
    """Each row within STEP_MULT x noise + floor; prints the reading (seen
    under ``pytest -s``)."""
    limits = [STEP_MULT * noise + floor for _, _, noise in rows]
    for (name, port, noise), limit in zip(rows, limits):
        assert port <= limit, (f"{what} {name}: port bf16 {port:.3e} from "
                               f"float64, noise {noise:.3e}; limit "
                               f"{STEP_MULT} x noise + {floor}")
    share, worst = max((p / lim, n) for (n, p, _), lim in zip(rows, limits))
    print(f"{what}: worst share of its limit {share:.2f} ({worst}), "
          f"largest limit {max(limits):.3f}, median port "
          f"{np.median([p for _, p, _ in rows]):.2e}, median noise "
          f"{np.median([n for _, _, n in rows]):.2e}")


def _compare(ref, frozen, accum, batch_size):
    batch = ref.batch(batch_size)
    m_jax, g_jax = ref.jax_step(batch, frozen, accum)
    m_16, g_16, model = ref.port_step(batch, frozen, accum, None)
    m_64, g_64, _ = ref.port_step(batch, frozen, accum, torch.float64)
    draws = [(m_jax, g_jax)] + _noise_draws(ref, batch, frozen, accum)
    assert model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert sorted(m_jax) == sorted(m_16) == sorted(m_64)
    live = sorted(g_64)
    if frozen:
        assert not any(n.startswith(BACKBONE) for n in live)
        assert all(not np.any(g_jax[n]) for n in g_jax
                   if n.startswith(BACKBONE))
    assert sorted(g_16) == live and set(live) <= set(g_jax)
    losses = _rows(m_16, [m for m, _ in draws], m_64)
    grads = _rows(g_16, [g for _, g in draws], g_64)
    case = f"frozen {frozen}, accum {accum}"
    _assert_within_noise(losses, f"{case}: loss part", STEP_FLOOR)
    _assert_within_noise(grads, f"{case}: gradient")
    # the comparison can see a gradient that is zeroed or doubled
    # (deviation 1) or of the wrong sign (2), in every tensor
    assert max(STEP_MULT * n + GRAD_FLOOR for _, _, n in grads) < 1.0
    # bf16 is really in use: the port's bf16 step is off the float64 step
    # by more than float32 rounding
    assert max(p for _, p, _ in grads) > 1e-3


@pytest.mark.parametrize("frozen,accum,batch_size", [
    (True, 1, 2), (False, 1, 2), (False, 2, 4)],
    ids=["frozen", "unfrozen", "grad_accum_2"])
def test_bf16_train_step_matches_jax_bf16(conv_ref, frozen, accum,
                                          batch_size):
    _compare(conv_ref, frozen, accum, batch_size)


@pytest.mark.slow
def test_bf16_train_step_matches_jax_bf16_deformconv():
    """The unfrozen step with DeformConv nodes (the JAX DCN train step
    compiles for minutes on the CPU)."""
    _compare(_Bf16Reference("DeformConv"), False, 1, 2)


# ---------------------------- a bf16 block with train-mode BatchNorm vs JAX

KINK = 0.05  # the block test's cotangent margin from the output's ReLU kink


def _jax_tree_vjp(tree, params, stats, x, cot, dtype):
    """The JAX Tree in train mode at ``dtype``: output, parameter and input
    gradients for cotangent ``cot``, and the updated statistics; float64
    numpy in the port's names and layouts ("y", "dx" and the state_dict's
    keys)."""
    wide = dtype if dtype == jnp.float64 else jnp.float32
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, wide), t)
                     for t in (params, stats))

    def f(params, x):
        y, upd = tree.clone(dtype=dtype).apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"])
        return y, upd["batch_stats"]

    (y, new_stats), vjp = jax.vjp(f, params, jnp.asarray(x, dtype))
    g_params, g_x = vjp((jnp.asarray(cot, y.dtype),
                         jax.tree.map(jnp.zeros_like, new_stats)))
    nchw = lambda a: np.transpose(np.asarray(a, np.float64), (0, 3, 1, 2))
    out = {"y": nchw(y), "dx": nchw(g_x)}
    out.update({k.lstrip("."): v.double().numpy() for k, v in
                state_dict_from_jax(g_params, new_stats).items()})
    return out


def _port_tree_vjp(state_dict, x, cot, dtype):
    """The port's Tree in train mode: bf16 compute on float32 parameters
    (``dtype`` bf16) or float64 throughout; the same keys as
    ``_jax_tree_vjp``."""
    tree = Tree(1, x.shape[1], cot.shape[1], 2,
                compute_dtype=dtype if dtype == torch.bfloat16 else None)
    tree = tree if dtype == torch.bfloat16 else tree.to(dtype)
    tree.load_state_dict(state_dict, strict=True)
    tree.train()
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = tree(xt)
    assert y.dtype == dtype
    y.backward(torch.from_numpy(cot).to(dtype))
    out = {"y": y.double().detach().numpy(), "dx": xt.grad.double().numpy()}
    for name, p in tree.named_parameters():
        assert p.grad.dtype == p.dtype, name
        out[name] = p.grad.double().numpy()
    out.update({n: t.double().numpy() for n, t in tree.named_buffers()
                if "running" in n})
    return out


def test_bf16_block_in_train_mode_matches_jax():
    """DLA-34's level-2 Tree (a max-pool, the 1x1 projection, two
    BasicBlocks and the Root: convolutions, train-mode BatchNorm, residual
    adds, a concat and ReLUs) in bf16 against the JAX package's Tree on the
    same weights and input, for one cotangent: the output, the gradients of
    all parameters and of x, and the running statistics, each within
    STEP_MULT times its noise plus GRAD_FLOOR of the float64 values (the
    port's float64 Tree, held to JAX's float64 Tree within 1e-6). The noise
    is the largest deviation of the JAX bf16 Tree and of N_DRAWS float64
    Trees with the parameters and x jittered by half a bf16 spacing."""
    jax_dla = pytest.importorskip("centerfusiondetect3d_tpu.models.dla")
    b, cin, cout, h, w = 2, 16, 32, 16, 18
    rng = np.random.RandomState(30)
    x = _bf16_rounded(rng.randn(b, h, w, cin).astype(np.float32))
    # no two largest values of a 2x2 max-pool window tie: a bf16 tie routes
    # the gradient by each framework's own rule (windows that tie are drawn
    # again)
    windows = x.reshape(b, h // 2, 2, w // 2, 2, cin).transpose(
        0, 1, 3, 5, 2, 4)  # a view of x: (B, H/2, W/2, C, 2, 2)
    while True:
        top = np.sort(windows.reshape(windows.shape[:4] + (4,)), axis=-1)
        tie = top[..., 3] == top[..., 2]
        if not tie.any():
            break
        windows[tie] = _bf16_rounded(
            rng.randn(int(tie.sum()), 2, 2).astype(np.float32))
    tree = jax_dla.Tree(1, cin, cout, 2, dtype=jnp.bfloat16)
    variables = tree.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)

    def draw(path, v):
        names = [getattr(p, "key", str(p)) for p in path]
        v = np.asarray(v, np.float32)
        if names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] in ("mean", "bias"):
            v = 0.1 * rng.randn(*v.shape)
        else:
            v = _bf16_rounded(v)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    stats = jax.tree_util.tree_map_with_path(draw,
                                             variables["batch_stats"])
    sd = {k.lstrip("."): v for k, v in
          state_dict_from_jax(params, stats).items()}
    x_nchw = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    # the cotangent is zero where the float64 output lies within KINK of
    # the ReLU's kink: a rounding there decides whether an O(1) cotangent
    # passes, a discrete step that measures no numerics
    y64 = _port_tree_vjp(sd, x_nchw, np.zeros((b, cout, h // 2, w // 2)),
                         torch.float64)["y"]
    cot = rng.randn(*y64.shape) * (y64 > KINK * y64.max())
    cot = _bf16_rounded(cot.astype(np.float32))
    assert 0.2 < np.mean(cot != 0) < 0.6
    ref = _port_tree_vjp(sd, x_nchw, cot, torch.float64)
    with jax.enable_x64(True):
        jax64 = _jax_tree_vjp(tree, params, stats, x, np.transpose(
            cot, (0, 2, 3, 1)), jnp.float64)
    assert sorted(jax64) == sorted(ref)
    for name, want in ref.items():  # the converter stores float32
        assert _deviation(jax64[name], want) <= 1e-6, name
    draws = [_jax_tree_vjp(tree, params, stats, x,
                           np.transpose(cot, (0, 2, 3, 1)), jnp.bfloat16)]
    for seed in range(N_DRAWS):
        gen = torch.Generator().manual_seed(seed)
        draws.append(_port_tree_vjp(
            _jittered_state(sd, gen),
            _jitter(torch.from_numpy(x_nchw), gen).numpy(), cot,
            torch.float64))
    got = _port_tree_vjp(sd, x_nchw, cot, torch.bfloat16)
    rows = _rows(got, draws, ref)
    _assert_within_noise(rows, "Tree")
    assert max(STEP_MULT * n + GRAD_FLOOR for _, _, n in rows) < 1.0
    assert max(p for _, p, _ in rows) > 1e-3


def test_bf16_trainer_across_defreeze_keeps_float32_state(conv_ref,
                                                          tmp_path):
    """The Trainer with MIXED_PRECISION True, FREEZE_BACKBONE, DEFREEZE 0
    and 2 epochs of 2 steps: a bf16 model, frozen then unfrozen steps with
    finite losses, the backbone changed only after the defreeze, and
    float32 parameters, AdamW state and checkpoint tensors."""
    cfg = conv_ref.port_cfg.clone()
    cfg.defrost()
    cfg.MODEL.NORM_EVAL = False  # train-mode BatchNorm, as shipped
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.freeze()
    items = SyntheticTrainingSet(cfg, 4, seed=1)
    trainer = Trainer(cfg, items, device="cpu")
    assert trainer.model.compute_dtype == torch.bfloat16
    trainer.init_state(state_dict=conv_ref.state_dict)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    frozen_snap = {}

    def on_step(epoch, step, frozen, metrics):
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        if frozen:
            frozen_snap.update({n: p.detach().clone() for n, p in
                                trainer.model.named_parameters()})

    trainer.on_step = on_step
    trainer.train()
    assert [s["frozen"] for s in trainer.steps] == [True, True, False, False]
    after = dict(trainer.model.named_parameters())
    for name, p in after.items():
        assert p.dtype == torch.float32, name
        if name.startswith(BACKBONE):
            assert torch.equal(frozen_snap[name], before[name]), name
            assert not torch.equal(p.detach(), before[name]), name
    opt_state = trainer.optimizer.state_dict()["state"]
    assert opt_state and {t.dtype for s in opt_state.values()
                          for t in s.values()
                          if torch.is_tensor(t) and t.is_floating_point()
                          } == {torch.float32}
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["model_1.pt",
                                                      "model_last.pt"]
    ckpt = load_torch_file(str(tmp_path / "ckpts" / "model_last.pt"))
    assert {v.dtype for v in ckpt["state_dict"].values()
            if v.is_floating_point()} == {torch.float32}
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(ckpt["state_dict"][name], value), name


# ------------------------------------- the seeded model at 448x800 (slow)


@pytest.mark.slow
def test_seeded_defreeze_float64_port_matches_jax():
    """The open question of ROADMAP.md Queue 3: is the seeded full-width
    model's chaotic defreeze (a first unfrozen grad_norm of ~1e8 against
    ~1e3 frozen) the port's or the weights'? One frozen and one unfrozen
    step at 448x800, B=2, DeformConv nodes, from the same seeded weights
    (``runtime/synthetic.py:seeded_weights``) and batch, in JAX float64
    and in the port float64: per-step losses and grad_norm within 1e-6
    relative (the JAX package keeps BatchNorm statistics in float32, so the
    two agree to ~1e-7, not ~1e-12; the chaotic amplification is a float64
    computation in both)."""
    opts = MAIN_PATH_OPTS + [
        "MODEL.DLA.DCN_IMPL", "'xla'", "MIXED_PRECISION", "False",
        "MODEL.FREEZE_BACKBONE", "True"]
    cfg = load_config(opts=opts, num_classes=10)
    items = SyntheticTrainingSet(cfg, 2, seed=1)
    batch = stack_items([items.get_item(i) for i in range(2)])
    model = build_model(cfg, torch.float64)
    seeded_weights(model, 0)
    jax_cfg = jax_config.load_config(opts=opts, num_classes=10)
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    lr = float(cfg.TRAIN.LR)
    port = []
    optimizer = make_optimizer(cfg, model)
    tb = to_device(batch, "cpu")
    tb = {k: ({kk: vv.double() if vv.is_floating_point() else vv
               for kk, vv in v.items()} if isinstance(v, dict) else
              (v.double() if v.is_floating_point() else v))
          for k, v in tb.items()}
    loss = GenericLoss(cfg)
    for frozen in (True, False):
        port.append({k: float(v) for k, v in train_step(
            model, optimizer, loss, tb, lr, frozen).items()})
    want = _jax_seeded_steps(jax_cfg, sd, batch, lr)
    for step, (got, exp) in enumerate(zip(port, want)):
        for k in ("total", "grad_norm"):
            assert abs(got[k] - exp[k]) <= 1e-6 * abs(exp[k]), (step, k,
                                                                got[k],
                                                                exp[k])
    # the chaos is the weights': the first unfrozen grad_norm dwarfs the
    # frozen one in both
    print("seeded 448x800 float64 steps (port / JAX):",
          [(p["total"], p["grad_norm"]) for p in port],
          [(w["total"], w["grad_norm"]) for w in want])


def _jax_seeded_steps(jax_cfg, sd, batch, lr):
    """One frozen and one unfrozen JAX float64 step of ``make_train_step``
    with AdamW from the port's weights ``sd`` (numpy, reference names)."""
    jax_ckpt = pytest.importorskip(
        "centerfusiondetect3d_tpu.training.checkpoint")
    with jax.enable_x64(True):
        model = jax_models.build_model(jax_cfg, dtype=jnp.float64)
        loss_fn = jax_losses.GenericLoss(jax_cfg)
        b = jax.tree.map(lambda a: jnp.asarray(
            a, jnp.float64 if np.asarray(a).dtype.kind == "f" else None),
            batch)
        variables = jax.jit(model.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), b["image"], b["pc_hm"], b["pc_dep"],
            b["calib"], train=True)
        params, stats, report = jax_ckpt.import_torch_checkpoint(
            sd, variables["params"], variables["batch_stats"],
            jax_cfg.head_conv)
        assert not report["missing"] and not report["shape_mismatch"]
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        # the JAX package keeps BatchNorm statistics in float32
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), stats)
        state = jax_state.create_train_state(
            jax_cfg, model, {"params": params, "batch_stats": stats})
        state.opt_state.hyperparams["learning_rate"] = jnp.asarray(
            0.0, jnp.float64)
        out = []
        for frozen in (True, False):
            step = jax.jit(jax_state.make_train_step(
                model, loss_fn, freeze_backbone=frozen))
            state, metrics = step(state, b, lr)
            out.append({k: float(v) for k, v in metrics.items()})
        return out
