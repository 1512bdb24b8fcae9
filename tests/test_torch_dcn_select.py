"""``tools/dcn_select.py``: the plain select formulation of the clamped DCN
against the JAX scripts' and ops', and the clamped kernels against it on
the card.

- ``deform_conv2d_select`` (NCHW) equals JAX
  ``scripts/probe_dcn_select_xla.py:deform_conv2d_select`` (NHWC, loaded
  with importlib) on the same inputs, forward and the gradients of
  sum(out^2) in x, offset, mask and weight, in float64 (1e-10: the same
  arithmetic; both clamp straight-through, so offsets beyond ±1 are in) and
  in bf16 (the taps rounded at the same points; ``BF16_RTOL`` of the
  output's magnitude).
- It equals JAX ``ops/dcn.py:deform_conv2d_shift(max_offset=1)`` in
  float32, forward on offsets beyond the clamp and gradients on offsets
  strictly inside it (at the clamp the shift's tent derivative and the
  straight-through one differ by convention), within ``F32_RTOL`` of each
  quantity's magnitude; and the port's plain clamped DCN the same way.
- The tool's CPU run prints its lines and a plain-only verdict, no time.
- ``cuda``: the clamped kernels (``dcn_fwd`` and ``dcn_fwd_bf16`` with
  ``max_offset=1``) against the select formulation on the card at the
  tool's shape and at an odd one. The JAX stack is imported inside the
  fixtures that need it, so these run where JAX is not installed.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.tools import dcn_select

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "probe_dcn_select_xla.py")
SMALL = (2, 10, 12, 5)  # B, H, W, C
F64_RTOL = 1e-10
F32_RTOL = 1e-5
BF16_RTOL = 8e-3


@pytest.fixture(scope="module")
def jax_select():
    jax = pytest.importorskip("jax")
    pytest.importorskip("centerfusiondetect3d_tpu.ops.dcn")
    spec = importlib.util.spec_from_file_location("probe_dcn_select_xla",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return jax, mod


def _inputs(shape=SMALL, scale=0.6, dtype=torch.float64, seed=0):
    """(x, offset, mask, weight) in the port's layouts, as the scripts draw
    them; ``scale`` of the offsets' N(0, 1)."""
    b, h, w, c = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w)
    offset = rng.randn(b, 18, h, w) * scale
    mask = rng.rand(b, 9, h, w)
    weight = rng.randn(c, c, 3, 3) * 0.05
    return [torch.from_numpy(a).to(dtype) for a in (x, offset, mask, weight)]


def _jax_args(jnp, x, offset, mask, weight, dtype):
    def nhwc(t):
        return jnp.asarray(t.detach().double().numpy().transpose(0, 2, 3, 1),
                           dtype)
    return (nhwc(x), nhwc(offset), nhwc(mask),
            jnp.asarray(weight.detach().double().numpy().transpose(
                2, 3, 1, 0), dtype))


def _port_grads(fn, args):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves)
    (out.double() ** 2).sum().backward()
    return out.detach(), [a.grad for a in leaves]


def _jax_grads(jax, fn, args):
    out = fn(*args)
    grads = jax.grad(lambda *a: (fn(*a).astype("float64") ** 2).sum()
                     if a[0].dtype == "float64" else
                     (fn(*a).astype("float32") ** 2).sum(),
                     argnums=(0, 1, 2, 3))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want_nhwc, rtol, what):
    """``got`` (NCHW torch, or the (O, C, 3, 3) weight) against JAX's
    (NHWC, or (3, 3, C, O)) within ``rtol`` of the magnitude."""
    g = got.detach().double().numpy()
    w = np.asarray(want_nhwc, np.float64)
    w = w.transpose(3, 2, 0, 1) if g.shape[-2:] == (3, 3) else w.transpose(
        0, 3, 1, 2)
    scale = max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() <= rtol * scale, (
        what, np.abs(g - w).max() / scale)


def test_select_equals_the_scripts_in_float64(jax_select):
    jax, mod = jax_select
    import jax.numpy as jnp

    args = _inputs()
    assert float(args[1].abs().max()) > 1.5  # the clamp is exercised
    out, grads = _port_grads(dcn_select.deform_conv2d_select, args)
    with jax.enable_x64(True):
        want, wgrads = _jax_grads(jax, mod.deform_conv2d_select,
                                  _jax_args(jnp, *args, jnp.float64))
    _close(out, want, F64_RTOL, "out")
    for name, g, w in zip(("dx", "doffset", "dmask", "dweight"), grads,
                          wgrads):
        _close(g, w, F64_RTOL, name)


def test_select_equals_the_scripts_in_bf16(jax_select):
    jax, mod = jax_select
    import jax.numpy as jnp

    x, offset, mask, weight = _inputs(dtype=torch.float32)
    got = dcn_select.deform_conv2d_select(x.to(torch.bfloat16), offset, mask,
                                          weight.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jx, joff, jmask, jw = _jax_args(jnp, x, offset, mask, weight,
                                    jnp.float32)
    want = mod.deform_conv2d_select(jx.astype(jnp.bfloat16), joff, jmask,
                                    jw.astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16_RTOL,
           "bf16 out")


def test_select_equals_the_shift_dcn_in_float32(jax_select):
    jax, _ = jax_select
    import jax.numpy as jnp
    from centerfusiondetect3d_tpu.ops.dcn import deform_conv2d_shift

    def shift(*a):
        return deform_conv2d_shift(*a, max_offset=1.0)

    args = _inputs(dtype=torch.float32)  # forward: offsets beyond ±1
    got = dcn_select.deform_conv2d_select(*args)
    _close(got, np.asarray(shift(*_jax_args(jnp, *args, jnp.float32))),
           F32_RTOL, "forward vs shift")
    inside = _inputs(dtype=torch.float32, scale=0.25)
    inside[1] = inside[1].clamp(-0.99, 0.99)
    out, grads = _port_grads(dcn_select.deform_conv2d_select, inside)
    want, wgrads = _jax_grads(jax, shift,
                              _jax_args(jnp, *inside, jnp.float32))
    _close(out, want, F32_RTOL, "out inside")
    for name, g, w in zip(("dx", "doffset", "dmask", "dweight"), grads,
                          wgrads):
        _close(g, w, F32_RTOL, name)


def test_select_equals_the_plain_clamped_dcn():
    """Forward with offsets beyond the clamp; gradients strictly inside
    it, against autograd of ``deform_conv2d_plain(max_offset=1)`` (float64,
    1e-10)."""
    args = _inputs()
    torch.testing.assert_close(
        dcn_select.deform_conv2d_select(*args),
        dcn.deform_conv2d_plain(*args, None, 1.0), rtol=0, atol=1e-12)
    inside = _inputs(scale=0.25)
    inside[1] = inside[1].clamp(-0.99, 0.99)
    out, grads = _port_grads(dcn_select.deform_conv2d_select, inside)
    want, wgrads = _port_grads(
        lambda *a: dcn.deform_conv2d_plain(*a, None, 1.0), inside)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=F64_RTOL * float(w.abs().max()))


def test_select_refuses_another_clamp():
    with pytest.raises(ValueError, match="±1"):
        dcn_select.deform_conv2d_select(*_inputs(), max_offset=2.0)


def test_probe_inputs_are_the_scripts_layout_of_its_draws():
    x, offset, mask, weight = dcn_select.probe_inputs((2, 4, 5, 3))
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        x.numpy(), rng.randn(2, 4, 5, 3).astype(np.float32).transpose(
            0, 3, 1, 2))
    np.testing.assert_array_equal(
        offset.numpy(), (rng.randn(2, 4, 5, 18) * 0.6).astype(
            np.float32).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        mask.numpy(), rng.rand(2, 4, 5, 9).astype(np.float32).transpose(
            0, 3, 1, 2))
    np.testing.assert_array_equal(
        weight.numpy(), (rng.randn(3, 3, 3, 3) * 0.05).astype(
            np.float32).transpose(3, 2, 0, 1))


def test_cpu_run_prints_the_lines_and_no_time():
    lines = []
    rec = dcn_select.run("cpu", (1, 12, 16, 8), log=lines.append)
    assert rec["select"]["rel_err"] == 0.0  # the plain version on the CPU
    assert rec["select_plain"]["fwd_rel_err"] < 1e-5
    assert max(rec["select_plain"]["grad_rel_err"].values()) < 1e-5
    assert lines[-1].startswith("VERDICT: CLAMPED-PLAIN-ONLY")
    assert not any("ms" in line for line in lines)
    assert [line.split("]")[0] for line in lines[:2]] == ["[select",
                                                          "[select-plain"]


# -------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dcn_select.SHAPE, (3, 17, 29, 40)],
                         ids=["tool", "odd"])
def test_clamped_kernels_hold_against_the_select_formulation(shape):
    dev = _card()
    x, offset, mask, weight = dcn_select.probe_inputs(shape, dev)
    before = (dcn.deform_conv2d.launches, dcn.dcn_fwd_bf16.launches)
    with torch.no_grad():
        want = dcn_select.deform_conv2d_select(x, offset, mask, weight)
        got = dcn.deform_conv2d(x, offset, mask, weight, None, 1.0)
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        want16 = dcn.deform_conv2d_bf16_plain(xb, offset, mask, wb, None,
                                              1.0)
        got16 = dcn.dcn_fwd_bf16(xb, offset, mask, wb, None, 1.0)
    torch.cuda.synchronize()
    assert (dcn.deform_conv2d.launches, dcn.dcn_fwd_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    assert dcn_select.rel_err(got, want) < 1e-4
    assert dcn_select.rel_err(got16, want16) < BF16_RTOL
    assert dcn_select.rel_err(got16, want) < 2 * BF16_RTOL


@pytest.mark.cuda
def test_card_run_times_and_gives_a_verdict():
    dev = _card()
    lines = []
    rec = dcn_select.run(dev, (2, 56, 100, 64), iters=5, log=lines.append)
    assert rec["select"]["ms"] > 0
    assert len(rec["recheck"]["exact_ms"]) == len(
        rec["recheck"]["clamped_ms"]) == 2 * dcn_select.TURNS
    assert rec["recheck"]["verdict"].startswith(
        ("VERDICT: CLAMP-PAYS", "VERDICT: CLAMP-DOES-NOT-PAY"))
    assert max(rec["select_plain"]["grad_rel_err"].values()) < 1e-4
