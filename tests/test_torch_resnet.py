"""The port's ResNet-18/34 backbones (``models/resnet.py``) against the
JAX package's, behind the same DLAUp/IDAUp neck (16 DeformConv nodes) and
CenterFusion heads, with middle fusion and frustum association.

Weights are the JAX init with kernels scaled to ``HE_GAIN`` times its
variance (offset convs drawn so offsets are ~1.5 px, random BatchNorm affine and
statistics, depth and dimension biases that put the frustum windows on the
radar's 15-25 m), carried over by ``weights.state_dict_from_jax``:

The ResNet-18 cases run behind DeformConv nodes, the ResNet-34 ones behind
Conv nodes (behind DeformConv nodes under ``-m slow``):

- float64, both packages: every head within rtol = atol = 1e-9 (two exact
  implementations of the same arithmetic);
- float32: within ``test_torch_model.py``'s rtol = atol = 2e-3;
- bf16 under ``MIXED_PRECISION True`` (frustum off, the JAX init's own
  scale, as ``test_torch_mixed_precision.py`` holds DLA-34): each head's
  deviation from the float64 forward within twice JAX bf16's plus 1e-3;
- one unfrozen ``train_step`` of ``resnet_18`` with ``MODEL.NORM_EVAL
  True`` (Conv nodes) against JAX ``make_train_step``, in float64 at
  ``test_torch_training.py``'s limits;
- a ``.pt`` of a ResNet model saved by the ``Trainer`` reloads equal;
  other architectures raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import test_torch_training as training_tests
from test_torch_model import _inputs

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.models.resnet import ResNetBackbone
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    SyntheticTrainingSet)
from centerfusiondetect3d_tpu_torch.training.checkpoint import (
    load_torch_file)
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_build_model = pytest.importorskip(
    "centerfusiondetect3d_tpu.models").build_model
export_torch_state_dict = pytest.importorskip(
    "centerfusiondetect3d_tpu.training.checkpoint").export_torch_state_dict

torch.set_num_threads(2)

# (arch, aggregation node): XLA compiles the JAX DeformConv forward in
# ~25 s per precision on the CPU, so ResNet-34 behind DeformConv nodes runs
# under -m slow; behind Conv nodes it runs here
CASES = [("resnet_18", "DeformConv"), ("resnet_34", "Conv"),
         pytest.param(("resnet_34", "DeformConv"), marks=pytest.mark.slow)]
IDS = ["resnet_18-DeformConv", "resnet_34-Conv", "resnet_34-DeformConv"]
# the kernels' variance over the JAX init's (torch's default 1/3 of He):
# DLA-34's tests take 6 (He); the ResNets' unnormalized residual sums
# explode there (heads ~1e4) and fade at 2 (flat heatmaps), while 3 gives
# heatmaps of 1e-4 to 0.9 and depths on the radar's range
HE_GAIN = 3.0
F64_TOL = 1e-9
F32_RTOL = F32_ATOL = 2e-3  # test_torch_model.py's
BF16_MULT, BF16_ATOL = 2.0, 1e-3  # test_torch_mixed_precision.py's


def _opts(arch, node="DeformConv", frustum=True, mixed=False):
    return ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", node,
            "MODEL.ARCH", repr(arch), "DATASET.RADAR_PC", "True",
            "MODEL.FRUSTUM", str(frustum), "MODEL.FUSION_STRATEGY",
            "'middle'", "MODEL.DLA.DCN_IMPL", "'xla'", "MODEL.APPROX_TOPK",
            "False", "MIXED_PRECISION", str(mixed)]


def _nhwc(a, dtype=None):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)), dtype)


def _init(cfg, model, inputs, he: bool):
    """The JAX init of ``model``, perturbed; ``he``: kernels at ``HE_GAIN``
    and head biases for ~20 m car-sized boxes."""
    img, pc_dep, calib = inputs
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), _nhwc(img), None, _nhwc(pc_dep),
        jnp.asarray(calib), train=False)
    rng = np.random.RandomState(1)

    def perturb(path, v):
        v = np.array(v, np.float32)
        names = [getattr(p, "key", str(p)) for p in path]
        if "conv_offset_mask" in names and names[-1] == "kernel":
            v = rng.randn(*v.shape) * 1.5 / np.sqrt(np.prod(v.shape[:3]))
        elif (he and names[-1] in ("kernel", "weight")
              and not any(n.startswith("up_") for n in names)):
            v = v * np.sqrt(HE_GAIN)
        elif names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
            v = 0.1 * rng.randn(*v.shape)
        elif he and names[-2:] == ["out", "bias"] and names[-3] == "depth":
            v[:] = -np.log(20.0)
        elif he and names[-2:] == ["out", "bias"] and names[-3] == "dimension":
            v[:] = (1.5, 1.6, 4.0)
        return np.asarray(v, np.float32)

    return (jax.tree_util.tree_map_with_path(perturb, variables["params"]),
            jax.tree_util.tree_map_with_path(perturb,
                                             variables["batch_stats"]))


def _heads(y, skip=("calib",)):
    return {k: np.transpose(np.asarray(v, np.float64), (0, 3, 1, 2))
            for k, v in y.items() if k not in skip}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def jax_resnet(request):
    """(arch, node, JAX config, params, stats, inputs, float32 heads,
    float64 heads) of the JAX model of ``arch`` with ``node`` aggregation
    nodes on He-scaled weights."""
    arch, node = request.param
    cfg = jax_load_config(opts=_opts(arch, node), num_classes=10)
    model = jax_build_model(cfg)
    inputs = _inputs(0)
    params, stats = _init(cfg, model, inputs, he=True)
    img, pc_dep, calib = inputs
    y32 = jax.jit(model.apply, static_argnames=("train",))(
        {"params": params, "batch_stats": stats}, _nhwc(img), None,
        _nhwc(pc_dep), jnp.asarray(calib), train=False)[-1]
    with jax.enable_x64(True):
        m64 = jax_build_model(cfg, dtype=jnp.float64)
        v64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                           {"params": params, "batch_stats": stats})
        f64 = jnp.float64
        y64 = jax.jit(m64.apply, static_argnames=("train",))(
            v64, _nhwc(img, f64), None, _nhwc(pc_dep, f64),
            jnp.asarray(calib, f64), train=False)[-1]
        y64 = _heads(y64)
    return arch, node, cfg, params, stats, inputs, _heads(y32), y64


def _port(arch, node, cfg, params, stats, inputs, dtype, frustum=True,
          mixed=False):
    port_cfg = load_config(opts=_opts(arch, node, frustum, mixed),
                           num_classes=10)
    model = build_model(port_cfg, dtype).eval()
    model.load_state_dict(state_dict_from_jax(params, stats, cfg.head_conv),
                          strict=True)
    img, pc_dep, calib = (torch.from_numpy(a) for a in inputs)
    if dtype == torch.float64:
        img, pc_dep, calib = img.double(), pc_dep.double(), calib.double()
    with torch.no_grad():
        y = model(img, pc_dep, calib)
    y.pop("calib")
    return model, {k: v.double().numpy() for k, v in y.items()}


def test_state_dict_from_jax_maps_every_resnet_parameter(jax_resnet):
    """Every JAX parameter and statistic lands on a parameter or buffer of
    the port's model (the JAX package's own ``export_torch_state_dict``
    knows no ResNet: it names the blocks' BatchNorms as a DCN node's)."""
    arch, node, cfg, params, stats, *_ = jax_resnet
    sd = state_dict_from_jax(params, stats, cfg.head_conv)
    n_leaves = sum(len(jax.tree_util.tree_leaves(t)) for t in (params, stats))
    assert len(sd) == n_leaves
    model = build_model(load_config(opts=_opts(arch, node), num_classes=10))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert {k for k in export_torch_state_dict(params, stats, cfg.head_conv)
            if ".activation.0." in k and k.startswith("base.")}
    assert isinstance(model.base, ResNetBackbone)
    blocks = {"resnet_18": 8, "resnet_34": 16}[arch]
    assert len({k.split(".")[1] for k in sd
                if k.startswith("base.layer")}) == blocks
    assert "base.layer1_0.downsample.0.weight" in sd
    assert "base.layer1_1.downsample.0.weight" not in sd


def test_resnet_forward_matches_jax_float64(jax_resnet):
    arch, node, cfg, params, stats, inputs, _, want = jax_resnet
    model, got = _port(arch, node, cfg, params, stats, inputs, torch.float64)
    assert sum(isinstance(m, DeformConvNode) for m in model.modules()) == (
        16 if node == "DeformConv" else 0)
    assert float(np.abs(got["pc_hm"]).sum()) > 0, "frustum painted nothing"
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=F64_TOL,
                                   atol=F64_TOL, err_msg=name)


def test_resnet_forward_matches_jax_float32(jax_resnet):
    arch, node, cfg, params, stats, inputs, want, _ = jax_resnet
    _, got = _port(arch, node, cfg, params, stats, inputs, torch.float32)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_resnet_bf16_forward_matches_jax_mixed_precision(case):
    arch, node = case
    cfg = jax_load_config(opts=_opts(arch, node, False, True),
                          num_classes=10)
    model = jax_build_model(cfg)
    inputs = _inputs(0)
    params, stats = _init(cfg, model, inputs, he=False)
    img, pc_dep, calib = inputs
    # op by op, as test_torch_mixed_precision.py applies it: under jit XLA
    # fuses a head's last conv into its sigmoid and skips the bf16 rounding
    # of the logits that both packages' eager forwards make (the heatmap's
    # deviation from float64 drops 3x)
    jax_bf16 = _heads(model.apply(
        {"params": params, "batch_stats": stats}, _nhwc(img), None,
        _nhwc(pc_dep), jnp.asarray(calib), train=False)[-1])
    m16, port = _port(arch, node, cfg, params, stats, inputs, None, False,
                      True)
    _, ref = _port(arch, node, cfg, params, stats, inputs, torch.float64,
                   False, True)
    assert m16.compute_dtype == torch.bfloat16
    assert sorted(port) == sorted(jax_bf16)
    worst = {}
    for name, want in ref.items():
        scale = max(np.abs(want).max(), 1e-30)
        dev_port = np.abs(port[name] - want).max() / scale
        dev_jax = np.abs(jax_bf16[name] - want).max() / scale
        worst[name] = (dev_port, dev_jax)
        assert dev_port <= BF16_MULT * dev_jax + BF16_ATOL, (name, dev_port,
                                                             dev_jax)
    assert max(p for p, _ in worst.values()) > 1e-4, worst


class _ResNetReference(training_tests._JaxReference):
    """``test_torch_training.py``'s float64 JAX reference with a ResNet
    backbone and ``MODEL.NORM_EVAL True``."""

    def __init__(self, arch):
        small = training_tests._small_opts
        training_tests._small_opts = lambda node: small(node) + [
            "MODEL.ARCH", repr(arch), "MODEL.NORM_EVAL", "True"]
        try:
            super().__init__("Conv")
        finally:
            training_tests._small_opts = small


def test_resnet18_train_step_matches_jax_f64():
    ref = _ResNetReference("resnet_18")
    assert ref.port_cfg.MODEL.ARCH == "resnet_18"
    assert ref.port_cfg.MODEL.NORM_EVAL
    training_tests._compare_step(ref, False, 1, 2)


def test_trainer_saves_and_reloads_a_resnet_checkpoint(tmp_path):
    opts = training_tests._small_opts("Conv") + [
        "MODEL.ARCH", "'resnet_34'", "OUTPUT_DIR", repr(str(tmp_path)),
        "TRAIN.EPOCHS", "1", "MODEL.FREEZE_BACKBONE", "False"]
    cfg = load_config(opts=opts, num_classes=10)
    trainer = Trainer(cfg, SyntheticTrainingSet(cfg, 2, seed=3),
                      device="cpu")
    trainer.init_state(seed=0)
    trainer.train()
    path = tmp_path / "ckpts" / "model_last.pt"
    ckpt = load_torch_file(str(path))
    want = trainer.model.state_dict()
    assert sorted(ckpt["state_dict"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    cfg2 = cfg.clone()
    cfg2.defrost()
    cfg2.MODEL.LOAD_DIR = str(path)
    cfg2.OUTPUT_DIR = str(tmp_path / "again")
    cfg2.freeze()
    again = Trainer(cfg2, None, device="cpu")
    again.init_state(seed=1)
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("arch", ["dla_60", "resnet_50", "resnet", "vgg_16"])
def test_other_architectures_raise(arch):
    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.ARCH",
                            repr(arch)], num_classes=10)
    with pytest.raises(NotImplementedError, match="architecture"):
        build_model(cfg)
