"""The bf16 DCNv2 backward (mixed-precision training): the port's bf16
backward against JAX's, its plain kernels against the float32 ones, the
dtypes autograd gets, a bf16 ``DeformConvNode`` in train mode against JAX's,
and (``-m cuda``) the bf16 kernels of ``csrc/dcn_bwd.cu`` against their plain
versions on the card.

Inputs are drawn with numpy from a seed; x, weight, bias and the output
gradient are bf16 values, offset and mask float32, as in the bf16 model.
On the CPU a bf16 ``deform_conv2d`` under autograd runs
``DeformConv2dFunction`` with the bf16 kernels' plain versions: the card's
decomposition and rounding points (columns and column gradients rounded to
bf16 once, float32 sums). JAX rounds elsewhere (its XLA formulation,
``centerfusiondetect3d_tpu/ops/dcn.py:29``, computes its taps in bf16), so
the port is held against JAX relative to the float64 VJP (autograd of the
plain DCN in float64): each gradient's deviation from it is at most
``JAX_MULT`` times the JAX bf16 VJP's own, plus ``FLOOR`` of the float64
gradient's largest magnitude.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode, _cast
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

JAX_MULT, FLOOR = 2.0, 1e-3
# on the card, kernel against plain version on identical inputs, relative to
# the largest magnitude: bf16 outputs within two bf16 ulps (as dcn_fwd_bf16),
# float32 outputs within the float32 kernels' 1e-4
BF16_RTOL = 8e-3
GRAD_RTOL = 1e-4
NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")
KINK = 0.05  # the node test's cotangent margin from the ReLU kink
BF16, F32 = torch.bfloat16, torch.float32


def _bf16_exact(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


def _case(seed, b=2, c=6, h=8, w=9, o=5, scale=1.5):
    """bf16-valued x, weight, bias and output gradient; float32 offsets
    N(0, scale px) with ~5% pushed to 8-12 px (past both clamps and out of
    the map); a sigmoided float32 mask."""
    rng = np.random.RandomState(seed)
    x = _bf16_exact(rng.randn(b, c, h, w))
    offset = (scale * rng.randn(b, 18, h, w)).astype(np.float32)
    pick = rng.rand(*offset.shape) < 0.05
    offset[pick] = (np.sign(rng.randn(int(pick.sum())))
                    * rng.uniform(8, 12, int(pick.sum())))
    mask = (1 / (1 + np.exp(-rng.randn(b, 9, h, w)))).astype(np.float32)
    weight = _bf16_exact(rng.randn(o, c, 3, 3) / np.sqrt(9 * c))
    bias = _bf16_exact(0.1 * rng.randn(o))
    grad = _bf16_exact(rng.randn(b, o, h, w))
    return x, offset, mask, weight, bias, grad


def _port_grads(args, max_offset=None):
    """Gradients of the port's bf16 DCN under autograd (the Function), as
    float64 numpy arrays, and their dtypes."""
    x, offset, mask, weight, bias, grad = (torch.from_numpy(a) for a in args)
    leaves = [x.bfloat16(), offset.clone(), mask.clone(), weight.bfloat16(),
              bias.bfloat16()]
    leaves = [t.requires_grad_(True) for t in leaves]
    out = dcn.deform_conv2d(*leaves, max_offset=max_offset)
    assert out.dtype == BF16
    assert type(out.grad_fn).__name__ == "DeformConv2dFunctionBackward"
    out.backward(grad.bfloat16())
    return ([t.grad.double().numpy() for t in leaves],
            [t.grad.dtype for t in leaves])


def _jax_vjp(fn, args, dtype):
    """jax.vjp of fn(x, offset, mask, weight, bias) in NHWC/HWIO, x, weight,
    bias and the cotangent in ``dtype`` (offset and mask float32 unless
    ``dtype`` is float64); float64 arrays in the port's NCHW/OIHW layouts."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    x, offset, mask, weight, bias, grad = args
    side = jnp.float64 if dtype == jnp.float64 else jnp.float32
    nhwc = lambda a, dt: jnp.asarray(np.transpose(a, (0, 2, 3, 1)), dt)
    nchw = lambda a: np.transpose(np.asarray(a, np.float64), (0, 3, 1, 2))
    _, vjp = jax.vjp(fn, nhwc(x, dtype), nhwc(offset, side),
                     nhwc(mask, side),
                     jnp.asarray(np.transpose(weight, (2, 3, 1, 0)), dtype),
                     jnp.asarray(bias, dtype))
    dx, doff, dmask, dw, db = vjp(nhwc(grad, dtype))
    return [nchw(dx), nchw(doff), nchw(dmask),
            np.transpose(np.asarray(dw, np.float64), (3, 2, 0, 1)),
            np.asarray(db, np.float64)]


def _exact():
    """The JAX exact op (the XLA formulation), no clamp."""
    return pytest.importorskip(
        "centerfusiondetect3d_tpu.ops.dcn").deform_conv2d


def _float64_vjp(args, max_offset):
    """The float64 VJP of the exact op with the clamp: autograd of the
    port's plain DCN in float64 (held against ``jax.vjp`` of the JAX op in
    ``test_torch_dcn_grad.py``)."""
    t = [torch.from_numpy(a).double() for a in args]
    return [g.numpy() for g in dcn.deform_conv2d_backward_plain(
        *t, max_offset=max_offset)]


def _assert_within_jax_noise(port, jax_bf16, ref, what):
    for name, p, j, r in zip(NAMES, port, jax_bf16, ref):
        scale = max(float(np.abs(r).max()), 1e-30)
        dev_port = float(np.abs(p - r).max()) / scale
        dev_jax = float(np.abs(j - r).max()) / scale
        assert dev_port <= JAX_MULT * dev_jax + FLOOR, (
            f"{what} {name}: port bf16 {dev_port:.3e} from float64, JAX bf16 "
            f"{dev_jax:.3e}; limit {JAX_MULT} x JAX + {FLOOR}")


@pytest.mark.parametrize("max_offset", [8.0, 1.0])
def test_bf16_backward_matches_fast_vjp_interpret(max_offset):
    """Against the VJP of the trainable TPU kernel K3 in bf16
    (``deform_conv2d_fast``: its Pallas forward in interpret mode, its
    ``_fast_bwd`` in the activation dtype)."""
    jnp = pytest.importorskip("jax.numpy")
    pallas_dcn = pytest.importorskip("centerfusiondetect3d_tpu.ops.pallas_dcn")
    args = _case(0, b=1, c=4, h=8, w=9, o=4, scale=1.5 * max_offset)
    want = _jax_vjp(
        lambda *a: pallas_dcn.deform_conv2d_fast(*a, max_offset, True), args,
        jnp.bfloat16)
    got, dtypes = _port_grads(args, max_offset)
    assert dtypes == [BF16, F32, F32, BF16, BF16]
    _assert_within_jax_noise(got, want, _float64_vjp(args, max_offset),
                             f"max_offset {max_offset}")
    clamped = np.abs(args[1]) > max_offset
    assert clamped.any() and not np.any(got[1][clamped])


@pytest.mark.parametrize("seed,shape", [(1, dict(b=2, c=8, h=9, w=9, o=3))])
def test_bf16_backward_matches_xla_vjp(seed, shape):
    """Against the VJP of the JAX XLA formulation in bf16, no clamp."""
    jnp = pytest.importorskip("jax.numpy")
    args = _case(seed, **shape)
    want = _jax_vjp(_exact(), args, jnp.bfloat16)
    got, _ = _port_grads(args)
    _assert_within_jax_noise(got, want, _float64_vjp(args, None),
                             f"seed {seed}")


@pytest.mark.parametrize("max_offset", [None, 8.0, 1.0])
def test_bf16_plain_kernels_against_float32_plain_kernels(max_offset):
    """On bf16 inputs each bf16 plain kernel is the float32 one with its
    output rounded as the kernel rounds it: the columns and dx within half
    a bf16 ulp of the float32 values (columns exactly their rounding),
    doffset and dmask equal."""
    x, offset, mask, weight, _, grad = (torch.from_numpy(a)
                                        for a in _case(10))
    xb = x.bfloat16()
    dcols = dcn.column_gradients(weight.bfloat16(), grad.bfloat16())
    assert dcols.dtype == BF16 and dcols.shape == (2, 54, 72)
    cols = dcn.dcn_im2col_bf16_plain(xb, offset, mask, max_offset)
    cols32 = dcn.dcn_im2col_plain(x, offset, mask, max_offset)
    assert cols.dtype == BF16
    assert torch.equal(cols, cols32.bfloat16())
    dx = dcn.dcn_col2im_bf16_plain(dcols, xb, offset, mask, max_offset)
    dx32 = dcn.dcn_col2im_plain(dcols.float(), x, offset, mask, max_offset)
    assert dx.dtype == BF16
    for got, want in ((cols, cols32), (dx, dx32)):
        assert bool(((got.float() - want).abs()
                     <= want.abs() * 2.0 ** -8).all())
    coord = dcn.dcn_col2im_coord_bf16_plain(dcols, xb, offset, mask,
                                            max_offset)
    coord32 = dcn.dcn_col2im_coord_plain(dcols.float(), x, offset, mask,
                                         max_offset)
    for got, want in zip(coord, coord32):
        assert got.dtype == F32 and torch.equal(got, want)
    # on CPU tensors the kernel wrappers are the plain versions and
    # launch nothing
    counts = _counts()
    assert torch.equal(dcn.dcn_im2col_bf16(xb, offset, mask, max_offset),
                       cols)
    assert torch.equal(dcn.dcn_col2im_bf16(dcols, offset, mask, max_offset),
                       dx)
    for a, b in zip(dcn.dcn_col2im_coord_bf16(dcols, xb, offset, mask,
                                              max_offset), coord):
        assert torch.equal(a, b)
    assert _counts() == counts


@pytest.mark.parametrize("needs", ["all", "weight", "x", "offset_mask",
                                   "no_bias"])
def test_bf16_gradient_dtypes(needs):
    """Each gradient in its input's dtype (dx, dweight, dbias bf16; doffset
    and dmask float32), only the gradients asked for, and each equal to the
    plain bf16 backward's."""
    args = [torch.from_numpy(a) for a in _case(11)]
    x, offset, mask, weight, bias, grad = args
    flags = {"all": (1, 1, 1, 1, 1), "weight": (0, 0, 0, 1, 1),
             "x": (1, 0, 0, 0, 0), "offset_mask": (0, 1, 1, 0, 0),
             "no_bias": (1, 1, 1, 1, 0)}[needs]
    leaves = [t.clone().requires_grad_(bool(f)) for t, f in
              zip((x.bfloat16(), offset, mask, weight.bfloat16(),
                   bias.bfloat16()), flags)]
    if needs == "no_bias":
        leaves[4] = None
    out = dcn.deform_conv2d(*leaves)
    out.backward(grad.bfloat16())
    want = dcn.deform_conv2d_bf16_backward_plain(
        x.bfloat16(), offset, mask, weight.bfloat16(),
        None if leaves[4] is None else bias.bfloat16(), grad.bfloat16())
    for leaf, w, name, dtype in zip(leaves, want, NAMES,
                                    (BF16, F32, F32, BF16, BF16)):
        if leaf is None or not leaf.requires_grad:
            continue
        assert leaf.grad.dtype == dtype, (name, leaf.grad.dtype)
        scale = float(w.float().abs().max())
        assert float((leaf.grad.float() - w.float()).abs().max()) <= (
            1e-6 * scale), name


def test_float32_master_weight_gets_the_widened_bf16_gradient():
    """A float32 parameter cast to bf16 (``models/layers.py:_cast``, the
    node's weight and bias) receives a float32 gradient: the bf16 dweight
    and dbias widened, as JAX's float32 parameters receive theirs."""
    x, offset, mask, weight, bias, grad = (torch.from_numpy(a)
                                           for a in _case(12))
    w32 = torch.nn.Parameter(weight.clone())
    b32 = torch.nn.Parameter(bias.clone())
    out = dcn.deform_conv2d(x.bfloat16(), offset, mask, _cast(w32, BF16),
                            _cast(b32, BF16))
    out.backward(grad.bfloat16())
    want = dcn.deform_conv2d_bf16_backward_plain(
        x.bfloat16(), offset, mask, weight.bfloat16(), bias.bfloat16(),
        grad.bfloat16())
    assert w32.grad.dtype == F32 and b32.grad.dtype == F32
    assert torch.equal(w32.grad, want[3].float())
    assert torch.equal(b32.grad, want[4].float())


def test_bf16_forward_without_autograd_takes_the_forward_alone():
    x, offset, mask, weight, bias, _ = (torch.from_numpy(a)
                                        for a in _case(13))
    args = (x.bfloat16(), offset, mask, weight.bfloat16(), bias.bfloat16())
    with torch.no_grad():
        out = dcn.deform_conv2d(*args)
    assert out.grad_fn is None
    assert torch.equal(out, dcn.deform_conv2d_bf16_plain(*args))
    with pytest.raises(RuntimeError, match="records no gradient"):
        dcn.dcn_fwd_bf16(args[0].clone().requires_grad_(True), *args[1:])


# --------------------------------------------- a bf16 DeformConvNode vs JAX


def _jax_node(dtype, params, stats, x_nhwc, cotangent):
    """The JAX package's DeformConvNode (XLA DCN) in train mode: output,
    gradients of every parameter and of x, and the updated statistics."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    layers = pytest.importorskip("centerfusiondetect3d_tpu.models.layers")
    node = layers.DeformConvNode(features=cotangent.shape[-1],
                                 dcn_impl="xla", dtype=dtype)

    def f(params, x):
        y, upd = node.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    (y, new_stats), vjp = jax.vjp(f, params, x_nhwc, has_aux=False)
    zero = jax.tree.map(jnp.zeros_like, new_stats)
    g_params, g_x = vjp((jnp.asarray(cotangent, y.dtype), zero))
    return y, g_params, g_x, new_stats


def test_bf16_deformconv_node_matches_jax_in_train_mode():
    """A bf16 DeformConvNode in train mode (batch statistics in float32,
    their running update in float32) against JAX's on the same weights:
    the output, the gradients of all six parameters and of x, and the
    running statistics, each within JAX_MULT x the JAX bf16 node's own
    deviation from the JAX float64 node plus FLOOR. (The state_dict names
    of the node's own tensors carry no prefix.)"""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    layers = pytest.importorskip("centerfusiondetect3d_tpu.models.layers")
    b, c, h, w, o = 2, 8, 8, 9, 6
    rng = np.random.RandomState(20)
    x = _bf16_exact(rng.randn(b, h, w, c))
    cot = _bf16_exact(rng.randn(b, h, w, o))
    node = layers.DeformConvNode(features=o, dcn_impl="xla",
                                 dtype=jnp.bfloat16)
    variables = node.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # offsets of +-0.5 or +-1.5 px per tap plus ~0.05 px that varies per
    # pixel: no sample lies within a bf16 rounding of an integer coordinate,
    # where the bilinear derivative jumps (another discrete step); the
    # op-level tests above cover offsets anywhere
    om_bias = np.concatenate([rng.choice([-1.5, -0.5, 0.5, 1.5], 18),
                              0.3 * rng.randn(9)])
    params = {
        "conv_offset_mask": {
            "kernel": _bf16_exact(rng.randn(3, 3, c, 27) * 0.05
                                  / np.sqrt(9 * c)),
            "bias": _bf16_exact(om_bias)},
        "weight": _bf16_exact(rng.randn(3, 3, c, o) / np.sqrt(9 * c)),
        "bias": _bf16_exact(0.1 * rng.randn(o)),
        "bn": {"scale": rng.uniform(0.5, 1.5, o).astype(np.float32),
               "bias": (0.1 * rng.randn(o)).astype(np.float32)}}
    stats = {"bn": {"mean": (0.1 * rng.randn(o)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, o).astype(np.float32)}}
    assert jax.tree.structure(params) == jax.tree.structure(
        variables["params"])
    # the node ends in a ReLU: where the output lies near the kink, a bf16
    # rounding decides which side an element falls on and so whether its
    # O(1) cotangent passes, a discrete step that measures no numerics. The
    # cotangent is zero where the float64 output is below KINK of its
    # largest value (the port's float64 node gives that output).
    strip = lambda sd: {k.lstrip("."): v for k, v in sd.items()}
    sd = strip(state_dict_from_jax(params, stats))
    node64 = DeformConvNode(c, o).double()
    node64.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y64 = node64.train()(torch.from_numpy(np.ascontiguousarray(
            np.transpose(x, (0, 3, 1, 2)))).double()).numpy()
    live = np.transpose(y64 > KINK * y64.max(), (0, 2, 3, 1))
    cot = np.where(live, cot, 0).astype(np.float32)
    assert 0.2 < live.mean() < 0.6

    def run_jax(dtype):
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
        wide = dtype if dtype == jnp.float64 else jnp.float32
        y, gp, gx, st = _jax_node(dtype, jax.tree.map(
            lambda a: jnp.asarray(a, wide), params), jax.tree.map(
            lambda a: jnp.asarray(a, wide), stats), cast(x), cot)
        nchw = lambda a: np.transpose(np.asarray(a, np.float64),
                                      (0, 3, 1, 2))
        out = {"y": nchw(y), "dx": nchw(gx)}
        out.update({k: v.double().numpy()
                    for k, v in strip(state_dict_from_jax(gp, st)).items()})
        return out

    jax_bf16 = run_jax(jnp.bfloat16)
    with jax.enable_x64(True):
        ref = run_jax(jnp.float64)

    port = DeformConvNode(c, o, compute_dtype=BF16)
    port.load_state_dict(sd, strict=True)
    port.train()
    xt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(x, (0, 3, 1, 2)))).bfloat16().requires_grad_(True)
    y = port(xt)
    assert y.dtype == BF16
    y.backward(torch.from_numpy(np.ascontiguousarray(
        np.transpose(cot, (0, 3, 1, 2)))).bfloat16())
    got = {"y": y.double().detach().numpy(), "dx": xt.grad.double().numpy()}
    for name, p in port.named_parameters():
        assert p.dtype == F32 and p.grad.dtype == F32, name
        got[name] = p.grad.double().numpy()
    for name, t in port.named_buffers():
        if "running" in name:
            assert t.dtype == F32
            got[name] = t.double().numpy()
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    # the DCN bias's exact gradient is 0 (train-mode BatchNorm follows)
    assert np.abs(ref.pop("bias")).max() < 1e-12 * np.abs(ref["weight"]).max()
    for name, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        dev_port = float(np.abs(got[name] - r).max()) / scale
        dev_jax = float(np.abs(jax_bf16[name] - r).max()) / scale
        assert dev_port <= JAX_MULT * dev_jax + FLOOR, (name, dev_port,
                                                        dev_jax)
    # bf16 is really in use: the output is off the float64 one by more
    # than float32 rounding
    assert np.abs(got["y"] - ref["y"]).max() > 1e-4 * np.abs(ref["y"]).max()


# ------------------------------------------------------------------ the card


def _counts():
    return ([dcn.deform_conv2d.launches, dcn.dcn_fwd_bf16.launches]
            + [f.launches for f in dcn.BACKWARD_KERNELS.values()]
            + [f.launches for f in dcn.BACKWARD_KERNELS_BF16.values()])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("max_offset", [None, 8.0, 1.0])
@pytest.mark.parametrize("shape", [
    dict(), dict(b=2, c=64, h=20, w=30, o=64),
    dict(b=1, c=130, h=13, w=17, o=70), dict(b=1, c=3, h=1, w=1, o=1),
    dict(b=3, c=17, h=5, w=33, o=9)])
def test_bf16_backward_kernels_match_plain_on_card(shape, max_offset):
    """Each bf16 kernel against its plain version on identical inputs (one
    launch each), and the whole bf16 backward against the plain bf16
    backward (whose GEMMs are float32 products of the bf16 values, so a
    column gradient may round to its neighbour: BF16_RTOL for all five)."""
    _card()
    x, offset, mask, weight, bias, grad = (
        torch.from_numpy(a).cuda() for a in _case(70, **shape))
    xb, wb, gb = x.bfloat16(), weight.bfloat16(), grad.bfloat16()
    dcols = dcn.column_gradients(wb, gb)
    counts = _counts()
    pairs = [
        (dcn.dcn_im2col_bf16(xb, offset, mask, max_offset),
         dcn.dcn_im2col_bf16_plain(xb, offset, mask, max_offset), BF16_RTOL),
        (dcn.dcn_col2im_bf16(dcols, offset, mask, max_offset),
         dcn.dcn_col2im_bf16_plain(dcols, xb, offset, mask, max_offset),
         BF16_RTOL),
        *((a, b, GRAD_RTOL) for a, b in zip(
            dcn.dcn_col2im_coord_bf16(dcols, xb, offset, mask, max_offset),
            dcn.dcn_col2im_coord_bf16_plain(dcols, xb, offset, mask,
                                            max_offset))),
    ]
    torch.cuda.synchronize()
    assert _counts() == counts[:5] + [c + 1 for c in counts[5:]]
    for got, want, rtol in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _rel(got, want) <= rtol, (_rel(got, want), rtol)
    got = dcn.deform_conv2d_backward(xb, offset, mask, wb, gb, max_offset)
    want = dcn.deform_conv2d_bf16_backward_plain(xb, offset, mask, wb,
                                                 bias.bfloat16(), gb,
                                                 max_offset)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype, name
        assert _rel(a, b) <= BF16_RTOL, (name, _rel(a, b))


@pytest.mark.cuda
def test_bf16_autograd_on_card_launches_only_bf16_kernels():
    """No fallback: a bf16 DCN under autograd on the card launches
    dcn_fwd_bf16 and the three bf16 backward kernels once each, and no
    float32 kernel; the gradients come back in the inputs' dtypes."""
    _card()
    x, offset, mask, weight, bias, grad = (
        torch.from_numpy(a).cuda() for a in _case(71, c=16, o=8))
    leaves = [t.requires_grad_(True) for t in (
        x.bfloat16(), offset.clone(), mask.clone(), weight.bfloat16(),
        bias.bfloat16())]
    counts = _counts()
    out = dcn.deform_conv2d(*leaves)
    out.backward(grad.bfloat16())
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), counts)] == [0, 1, 0, 0, 0,
                                                          1, 1, 1]
    assert [t.grad.dtype for t in leaves] == [BF16, F32, F32, BF16, BF16]
    want = dcn.deform_conv2d_bf16_backward_plain(
        *(t.detach() for t in leaves), grad.bfloat16())
    for name, leaf, w in zip(NAMES, leaves, want):
        assert _rel(leaf.grad, w) <= BF16_RTOL, name
