"""The port's DCNv2 (plain version and CUDA kernel) against the JAX package.

Inputs are drawn with numpy from a seed and fed to both frameworks. The
plain version is held against the executed torchvision golden
(``dcn.npz``), the exact JAX op, the JAX TPU formulations it reproduces with
``max_offset`` (K1 ``deform_conv2d_pallas`` clamps at 8, K2
``deform_conv2d_pallas_static`` equals ``deform_conv2d_shift`` at 1), and the
Pallas kernels themselves in interpret mode. The CUDA kernel is held against
the plain version on the card (``-m cuda``).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# fp32 in both frameworks; sums run in another order (padded flat gathers
# and per-tap dots in JAX), so agreement is to a few float32 ulps of the
# O(1) outputs
RTOL = ATOL = 1e-4


def _case(seed, b=2, c=5, h=9, w=11, o=7, far=True):
    """Offsets N(0, 1.5 px) with ~5% of them pushed to 8-12 px (past the
    clamps and far outside the 9x11 map), a sigmoided mask, O(1) outputs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    offset = (1.5 * rng.randn(b, 18, h, w)).astype(np.float32)
    if far:
        pick = rng.rand(*offset.shape) < 0.05
        offset[pick] = (np.sign(rng.randn(int(pick.sum())))
                        * rng.uniform(8, 12, int(pick.sum())))
    mask = (1 / (1 + np.exp(-rng.randn(b, 9, h, w)))).astype(np.float32)
    weight = (rng.randn(o, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rng.randn(o)).astype(np.float32)
    return x, offset, mask, weight, bias


def _port(args, max_offset=None, fn=dcn.deform_conv2d_plain):
    return fn(*(torch.from_numpy(a) for a in args),
              max_offset=max_offset).numpy()


def _jax_module(name):
    """A module of the JAX package, imported here so that the card's tests
    of this file collect where JAX is not installed."""
    return pytest.importorskip(f"centerfusiondetect3d_tpu.ops.{name}")


def _jax(fn, x, offset, mask, weight, bias, **kw):
    import jax.numpy as jnp

    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    out = fn(nhwc(x), nhwc(offset), nhwc(mask),
             jnp.asarray(np.transpose(weight, (2, 3, 1, 0))),
             jnp.asarray(bias), **kw)
    return np.transpose(np.asarray(out, np.float32), (0, 3, 1, 2))


def test_plain_matches_torchvision_golden():
    g = np.load(os.path.join(FIXTURES, "dcn.npz"))
    got = _port((g["x"], g["offset"], g["mask"], g["weight"], g["bias"]))
    np.testing.assert_allclose(got, g["out"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed,shape", [
    (0, dict()), (1, dict(b=1, c=3, h=4, w=5, o=2)),
    (2, dict(c=16, h=12, w=7, o=9)), (3, dict(b=3, c=1, h=1, w=6, o=1))])
def test_plain_matches_jax_exact(seed, shape):
    args = _case(seed, **shape)
    want = _jax(_jax_module("dcn").deform_conv2d, *args)
    np.testing.assert_allclose(_port(args), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [4, 5])
def test_clamp_1_matches_jax_shift_k2(seed):
    """K2 semantics: deform_conv2d_pallas_static == deform_conv2d_shift."""
    args = _case(seed)
    want = _jax(_jax_module("dcn").deform_conv2d_shift, *args,
                max_offset=1.0)
    np.testing.assert_allclose(_port(args, max_offset=1.0), want,
                               rtol=RTOL, atol=ATOL)
    # the clamp is active: unclamped output differs
    assert np.abs(_port(args) - want).max() > 1e-2


@pytest.mark.parametrize("seed", [6, 7])
def test_clamp_8_matches_jax_exact_on_clipped_offsets_k1(seed):
    """K1 semantics: deform_conv2d_pallas clamps offsets to +-8."""
    x, offset, mask, weight, bias = _case(seed, h=24, w=26)
    want = _jax(_jax_module("dcn").deform_conv2d, x, np.clip(offset, -8, 8),
                mask, weight, bias)
    got = _port((x, offset, mask, weight, bias), max_offset=8.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(_port((x, offset, mask, weight, bias)) - want).max() > 1e-3


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_plain_matches_pallas_interpret(kind):
    """The Pallas kernels (bf16 taps, f32 accumulation) in interpret mode;
    the tolerance is the bf16 one of test_golden_parity's Pallas check."""
    pallas_dcn = _jax_module("pallas_dcn")
    args = _case(8, b=1, c=8, h=10, w=12, o=8)
    if kind == "k1":
        want = _jax(pallas_dcn.deform_conv2d_pallas, *args, interpret=True)
        got = _port(args, max_offset=8.0)
    else:
        want = _jax(pallas_dcn.deform_conv2d_pallas_static, *args,
                    max_offset=1.0, interpret=True)
        got = _port(args, max_offset=1.0)
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.15)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _case(9)]
    before = dcn.deform_conv2d.launches
    for max_offset in (None, 1.0):
        assert torch.equal(dcn.deform_conv2d(*args, max_offset=max_offset),
                           dcn.deform_conv2d_plain(*args,
                                                   max_offset=max_offset))
    assert dcn.deform_conv2d.launches == before


def test_wrapper_raises_on_devices_without_kernel():
    args = [torch.from_numpy(a).to("meta") for a in _case(10)]
    with pytest.raises(RuntimeError, match="no kernel"):
        dcn.deform_conv2d(*args)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "offset", "weight",
                                 "bias", "max_offset", "grad"])
def test_kernel_launch_validates_before_building(bad):
    """The launch path checks what the kernel takes and raises before it
    builds or touches the card."""
    x, offset, mask, weight, bias = (torch.from_numpy(a) for a in _case(11))
    kw = {}
    if bad == "dtype":
        x = x.double()
    elif bad == "contiguous":
        x = x.transpose(2, 3)
    elif bad == "offset":
        offset = offset[:, :16]
    elif bad == "weight":
        weight = weight[:, :, :2]
    elif bad == "bias":
        bias = bias[:3]
    elif bad == "max_offset":
        kw["max_offset"] = -1.0
    else:
        weight.requires_grad_(True)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        dcn._launch(x, offset, mask, weight, bias, kw.get("max_offset"))


@pytest.mark.cuda
@pytest.mark.parametrize("max_offset", [None, 8.0, 1.0])
@pytest.mark.parametrize("shape", [
    dict(), dict(b=2, c=64, h=20, w=30, o=64),
    dict(b=1, c=130, h=13, w=17, o=70), dict(b=1, c=3, h=1, w=1, o=1)])
def test_kernel_matches_plain_on_card(shape, max_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.from_numpy(a).cuda() for a in _case(12, **shape)]
    before = dcn.deform_conv2d.launches
    got = dcn.deform_conv2d(*args, max_offset=max_offset)
    torch.cuda.synchronize()
    assert dcn.deform_conv2d.launches == before + 1
    want = dcn.deform_conv2d_plain(*args, max_offset=max_offset)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
    assert dcn.deform_conv2d(*args[:4], None, max_offset=max_offset).shape \
        == want.shape


@pytest.mark.cuda
def test_detector_launches_kernel_once_per_node_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from centerfusiondetect3d_tpu_torch.config import load_config
    from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
    from centerfusiondetect3d_tpu_torch.runtime.detector import Detector

    det = Detector(load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                                     "MIXED_PRECISION", "False"]))
    assert det.device.type == "cuda"
    nodes = [m for m in det.model.modules() if isinstance(m, DeformConvNode)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in nodes:
            w = m.conv_offset_mask.weight
            w.copy_(0.05 * torch.randn(w.shape, generator=gen))
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (72, 128, 3)).astype(np.uint8)
              for _ in range(2)]
    before = dcn.deform_conv2d.launches
    ret = det.run(frames)
    assert dcn.deform_conv2d.launches - before == len(nodes) == 16
    for items in ret["results"].values():
        assert all(np.isfinite(it["score"]) for it in items)
