"""Mixed precision (``MIXED_PRECISION True``): the port's bf16 DCN and bf16
model against the JAX package's bf16 kernels and model.

(1) The bf16 plain DCN (``ops/dcn.py:deform_conv2d_bf16_plain``, the plain
version of the ``dcn_fwd_bf16`` kernel) against the TPU kernels run in
interpret mode, as ``tests/test_pallas_dcn.py`` runs them: K1
(``deform_conv2d_pallas``, offsets inside +-8) and both kernels of probe P4
(``scripts/probe_dcn_select.py``: ``_kernel_select`` and
``_kernel_value_acc``, clamp 1). Tolerance: 8e-3 of the largest magnitude,
two bf16 ulps there; K1 rounds to bf16 before its bias and the port after,
and both sum in another order.
(2) The bf16 port model against JAX ``build_model`` with ``MIXED_PRECISION
True`` on the same weights: each head's deviation from a float64 forward is
at most twice the JAX bf16 model's own deviation, plus 1e-3.
(3) The dispatch rules of ``deform_conv2d`` and the ``cuda``-marked kernel
test, which decides in its body whether there is a card. JAX is imported
inside the tests that use it: the card's machine has none of it and runs the
``cuda`` test alone.
"""

from __future__ import annotations

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNEL_RTOL = 8e-3  # two bf16 ulps at the largest magnitude
HEAD_MULT, HEAD_ATOL = 2.0, 1e-3


def _bf16_exact(a):
    """float32 values that bf16 represents exactly (both sides get the same
    bf16 inputs)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


def _nhwc_inputs(seed, b=1, h=16, w=24, c=16, o=16, off_scale=2.5,
                 off_clip=7.9):
    rng = np.random.RandomState(seed)
    x = _bf16_exact(rng.randn(b, h, w, c))
    offset = (rng.randn(b, h, w, 18) * off_scale).clip(-off_clip, off_clip)
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = _bf16_exact(rng.randn(3, 3, c, o) * 0.2)
    bias = _bf16_exact(rng.randn(o) * 0.5)
    return x, offset.astype(np.float32), mask, weight, bias


def _port_plain(x, offset, mask, weight, bias, max_offset):
    """The port's bf16 plain DCN on NHWC numpy inputs; NHWC float32 out."""
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2))))
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(weight, (3, 2, 0, 1)))).bfloat16()
    out = dcn.deform_conv2d_bf16_plain(
        nchw(x).bfloat16(), nchw(offset), nchw(mask), w,
        None if bias is None else torch.from_numpy(bias).bfloat16(),
        max_offset)
    assert out.dtype == torch.bfloat16
    return np.transpose(out.float().numpy(), (0, 2, 3, 1))


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _jnp():
    return pytest.importorskip("jax.numpy")


def _bf16(a):
    jnp = _jnp()
    return jnp.asarray(a).astype(jnp.bfloat16)


def test_bf16_plain_dcn_matches_pallas_k1_interpret():
    """K1 (``_dcn_shift_kernel`` through ``deform_conv2d_pallas``), bf16 x
    and weight, offsets inside its +-8 window, with a bias."""
    jnp = _jnp()
    pallas_dcn = pytest.importorskip("centerfusiondetect3d_tpu.ops.pallas_dcn")
    x, offset, mask, weight, bias = _nhwc_inputs(0)
    got = pallas_dcn.deform_conv2d_pallas(
        _bf16(x), jnp.asarray(offset), jnp.asarray(mask), _bf16(weight),
        _bf16(bias), max_offset=8.0, block_rows=8, interpret=True)
    assert got.dtype == jnp.bfloat16
    want = _port_plain(x, offset, mask, weight, bias, 8.0)
    assert _rel(np.asarray(got.astype(jnp.float32)), want) <= KERNEL_RTOL


@pytest.fixture(scope="module")
def probe_p4():
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "probe_dcn_select", ROOT / "scripts" / "probe_dcn_select.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", ["_kernel_select", "_kernel_value_acc"])
def test_bf16_plain_dcn_matches_probe_p4_interpret(probe_p4, kernel):
    """P4's two kernels through the probe's own ``run_kernel`` (clamp 1, no
    bias), offsets drawn past the clamp."""
    jnp = _jnp()
    x, offset, mask, weight, _ = _nhwc_inputs(1, off_scale=0.8)
    got = probe_p4.run_kernel(
        getattr(probe_p4, kernel), _bf16(x), jnp.asarray(offset),
        jnp.asarray(mask), _bf16(weight), max_offset=1.0, block_rows=8,
        interpret=True)
    assert got.dtype == jnp.bfloat16
    assert np.abs(offset).max() > 1.0
    want = _port_plain(x, offset, mask, weight, None, 1.0)
    assert _rel(np.asarray(got.astype(jnp.float32)), want) <= KERNEL_RTOL


def test_bf16_plain_dcn_rounds_each_tap_once():
    """The plain version is the float32 DCN on the bf16-rounded taps: with
    every tap already a bf16 value (integer offsets, mask 1, small-integer
    x), it equals the float32 DCN of the same inputs rounded once."""
    rng = np.random.RandomState(2)
    b, c, h, w, o = 2, 8, 6, 7, 5
    x = torch.from_numpy(rng.randint(-4, 5, (b, c, h, w)).astype(np.float32))
    offset = torch.from_numpy(
        rng.randint(-2, 3, (b, 18, h, w)).astype(np.float32))
    mask = torch.ones(b, 9, h, w)
    weight = torch.from_numpy(_bf16_exact(rng.randn(o, c, 3, 3)))
    bias = torch.from_numpy(_bf16_exact(rng.randn(o)))
    want = dcn.deform_conv2d_plain(x, offset, mask, weight, bias)
    got = dcn.deform_conv2d(x.bfloat16(), offset, mask, weight.bfloat16(),
                            bias.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# ------------------------------------------------------------ dispatch


def _small_args(dtype, requires_grad=False):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 6, generator=gen).to(dtype)
    offset = torch.randn(1, 18, 5, 6, generator=gen)
    mask = torch.rand(1, 9, 5, 6, generator=gen)
    weight = (torch.randn(3, 4, 3, 3, generator=gen) / 6).to(dtype)
    bias = torch.zeros(3).to(dtype)
    return x.requires_grad_(requires_grad), offset, mask, weight, bias


def test_float16_raises():
    with pytest.raises(TypeError, match="float16"):
        dcn.deform_conv2d(*_small_args(torch.float16))


def test_bf16_under_autograd_raises_and_counts_nothing():
    """A bf16 DCN under autograd no longer raises: it returns gradients in
    the inputs' dtypes through ``DeformConv2dFunction``; without autograd
    it still takes the forward alone. The CPU runs the plain versions, so
    no kernel launch is counted either way."""
    counts = [dcn.dcn_fwd_bf16.launches] + [
        f.launches for f in dcn.BACKWARD_KERNELS_BF16.values()]
    x, offset, mask, weight, bias = _small_args(torch.bfloat16,
                                                requires_grad=True)
    out = dcn.deform_conv2d(x, offset, mask, weight, bias)
    assert type(out.grad_fn).__name__ == "DeformConv2dFunctionBackward"
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    assert bool(x.grad.float().abs().sum() > 0)
    with torch.no_grad():
        out = dcn.deform_conv2d(*_small_args(torch.bfloat16,
                                             requires_grad=True))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 5, 6)
    assert out.grad_fn is None
    assert counts == [dcn.dcn_fwd_bf16.launches] + [
        f.launches for f in dcn.BACKWARD_KERNELS_BF16.values()]


@pytest.mark.parametrize("bad", ["weight_f32", "offset_bf16", "bias_f32"])
def test_bf16_dcn_checks_its_argument_types(bad):
    x, offset, mask, weight, bias = _small_args(torch.bfloat16)
    if bad == "weight_f32":
        weight = weight.float()
    elif bad == "offset_bf16":
        offset = offset.bfloat16()
    else:
        bias = bias.float()
    with pytest.raises(TypeError):
        dcn.deform_conv2d(x, offset, mask, weight, bias)


def test_mixed_precision_config_builds_a_bf16_model():
    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                            "MODEL.DLA.NODE", "Conv"])
    assert cfg.MIXED_PRECISION
    model = build_model(cfg)
    assert model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.state_dict().values()
            if p.is_floating_point()} == {torch.float32}
    off = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                            "MODEL.DLA.NODE", "Conv", "MIXED_PRECISION",
                            "False"])
    assert build_model(off).compute_dtype is None
    assert build_model(cfg, torch.float64).compute_dtype is None
    with pytest.raises(TypeError):
        build_model(cfg, torch.float16)


# ------------------------------------------------------ the bf16 model


def _opts():
    return ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
            "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "False",
            "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.DLA.DCN_IMPL", "'xla'",
            "MODEL.DLA.S2D_STEM", "False", "MIXED_PRECISION", "True"]


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
def bf16_models():
    """JAX and port models on the same weights: the JAX package's own
    initialization (torch's default conv scale, under which a float32 or
    bf16 forward does not amplify its rounding through DLA-34's depth),
    with offset convs drawn so offsets are ~1.5 px and random BatchNorm
    affine and statistics. Middle fusion without frustum association: the
    frustum's top-K box choice is a discrete step outside the numerics."""
    jax = pytest.importorskip("jax")
    jnp = _jnp()
    jax_load_config = pytest.importorskip(
        "centerfusiondetect3d_tpu.config").load_config
    jax_build_model = pytest.importorskip(
        "centerfusiondetect3d_tpu.models").build_model
    cfg = jax_load_config(opts=_opts(), num_classes=10)
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
        if "conv_offset_mask" in names and names[-1] == "kernel":
            v = rng.randn(*v.shape) * 1.5 / np.sqrt(np.prod(v.shape[:3]))
        elif names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
            v = 0.1 * rng.randn(*v.shape)
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb,
                                             variables["batch_stats"])
    y = model.apply({"params": params, "batch_stats": stats}, nhwc(img),
                    None, nhwc(pc_dep), jnp.asarray(calib), train=False)[-1]
    jax_bf16 = {k: np.transpose(np.asarray(v, np.float64), (0, 3, 1, 2))
                for k, v in y.items() if k != "calib"}
    sd = state_dict_from_jax(params, stats, cfg.head_conv)
    port_cfg = load_config(opts=_opts(), num_classes=10)
    return port_cfg, sd, (img, pc_dep, calib), jax_bf16


def _port_forward(cfg, sd, inputs, dtype):
    model = build_model(cfg, dtype).eval()
    model.load_state_dict(sd, strict=True)
    img, pc_dep, calib = (torch.from_numpy(a) for a in inputs)
    if dtype == torch.float64:
        img, pc_dep, calib = img.double(), pc_dep.double(), calib.double()
    with torch.no_grad():
        y = model(img, pc_dep, calib)
    y.pop("calib")
    return model, {k: v.double().numpy() for k, v in y.items()}, {
        k: v.dtype for k, v in y.items()}


def test_bf16_model_matches_jax_bf16_model(bf16_models):
    cfg, sd, inputs, jax_bf16 = bf16_models
    model, port, dtypes = _port_forward(cfg, sd, inputs, None)
    _, ref, _ = _port_forward(cfg, sd, inputs, torch.float64)
    nodes = [m for m in model.modules() if isinstance(m, DeformConvNode)]
    assert len(nodes) == 16 and model.compute_dtype == torch.bfloat16
    assert set(dtypes.values()) == {torch.float32}
    assert sorted(port) == sorted(jax_bf16)
    worst = {}
    for name, want in ref.items():
        scale = max(np.abs(want).max(), 1e-30)
        dev_port = np.abs(port[name] - want).max() / scale
        dev_jax = np.abs(jax_bf16[name] - want).max() / scale
        worst[name] = (dev_port, dev_jax)
        assert dev_port <= HEAD_MULT * dev_jax + HEAD_ATOL, (name, dev_port,
                                                             dev_jax)
    # bf16 is really in use: some head is off the float64 forward by more
    # than float32 rounding
    assert max(p for p, _ in worst.values()) > 1e-4, worst


def test_bf16_model_feeds_the_dcn_bf16(bf16_models):
    """Each DCN node gets bf16 x, weight and bias and float32 offset and
    mask (the JAX package's ``layers.py:226-229, 304-306``)."""
    cfg, sd, inputs, _ = bf16_models
    model = build_model(cfg).eval()
    model.load_state_dict(sd, strict=True)
    seen = []

    def spy(x, offset, mask, weight, bias, max_offset=None):
        seen.append((x.dtype, offset.dtype, mask.dtype, weight.dtype,
                     bias.dtype))
        return dcn.deform_conv2d(x, offset, mask, weight, bias, max_offset)

    for m in model.modules():
        if isinstance(m, DeformConvNode):
            m.dcn_fn = spy
    with torch.no_grad():
        model(*(torch.from_numpy(a) for a in inputs))
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf16, f32, f32, bf16, bf16)] * 16


# -------------------------------------------------------------- the card


@pytest.mark.cuda
def test_dcn_fwd_bf16_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, c, h, w, o in ((2, 64, 28, 50, 64), (1, 20, 9, 11, 24),
                          (3, 128, 14, 25, 256)):
        x = torch.randn(b, c, h, w, generator=gen, device="cuda")
        offset = 2.0 * torch.randn(b, 18, h, w, generator=gen, device="cuda")
        mask = torch.rand(b, 9, h, w, generator=gen, device="cuda")
        weight = torch.randn(o, c, 3, 3, generator=gen,
                             device="cuda") / math.sqrt(9 * c)
        bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
        args = (x.bfloat16(), offset, mask, weight.bfloat16())
        for max_offset in (None, 8.0, 1.0):
            for bb in (bias.bfloat16(), None):
                before = dcn.dcn_fwd_bf16.launches
                got = dcn.deform_conv2d(*args, bb, max_offset=max_offset)
                torch.cuda.synchronize()
                assert dcn.dcn_fwd_bf16.launches == before + 1
                want = dcn.deform_conv2d_bf16_plain(*args, bb, max_offset)
                assert got.dtype == torch.bfloat16
                err = (got.float() - want.float()).abs().max().item()
                assert err <= KERNEL_RTOL * want.float().abs().max().item()
