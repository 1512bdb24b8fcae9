"""The DCNv2 backward: the plain version's gradients against JAX, and the
card's backward kernels (``csrc/dcn_bwd.cu``) against the plain version.

Inputs are drawn with numpy from a seed and fed to both frameworks. The
plain backward (autograd of ``deform_conv2d_plain``) is held against
``jax.vjp`` of the exact JAX op ``ops/dcn.py:deform_conv2d`` and against the
VJP of the trainable TPU kernel ``deform_conv2d_fast`` (Pallas forward in
interpret mode, ``_fast_bwd`` backward) at its clamps 1 and 8, including the
cases where the conventions matter: integer offsets (one-sided derivative),
samples straddling the border, samples wholly outside the image. A float64
``gradcheck`` pins the plain version's own derivative. The kernels are held
against the plain backward on the card (``-m cuda``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn

torch.set_num_threads(1)

# fp32 in both frameworks, sums in another order: every gradient within
# 1e-4 of the largest magnitude of its reference tensor (the forward's
# limit in test_torch_dcn.py, taken relative since dweight sums B*H*W
# products and is O(10))
GRAD_RTOL = 1e-4
NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")


def _case(seed, b=2, c=5, h=9, w=11, o=7, scale=1.5, far=True):
    """Offsets N(0, scale px) with ~5% pushed to 8-12 px (past both clamps
    and out of the map), a sigmoided mask, an O(1) output gradient."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    offset = (scale * rng.randn(b, 18, h, w)).astype(np.float32)
    if far:
        pick = rng.rand(*offset.shape) < 0.05
        offset[pick] = (np.sign(rng.randn(int(pick.sum())))
                        * rng.uniform(8, 12, int(pick.sum())))
    mask = (1 / (1 + np.exp(-rng.randn(b, 9, h, w)))).astype(np.float32)
    weight = (rng.randn(o, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rng.randn(o)).astype(np.float32)
    grad = rng.randn(b, o, h, w).astype(np.float32)
    return x, offset, mask, weight, bias, grad


def _plain_grads(args, max_offset=None):
    x, offset, mask, weight, bias, grad = (torch.from_numpy(a) for a in args)
    return [t.numpy() for t in dcn.deform_conv2d_backward_plain(
        x, offset, mask, weight, bias, grad, max_offset)]


def _jax_grads(fn, args):
    """jax.vjp of fn(x, offset, mask, weight, bias) in NHWC/HWIO, returned
    in the port's NCHW/OIHW layouts."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    x, offset, mask, weight, bias, grad = args
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    nchw = lambda a: np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))
    _, vjp = jax.vjp(fn, nhwc(x), nhwc(offset), nhwc(mask),
                     jnp.asarray(np.transpose(weight, (2, 3, 1, 0))),
                     jnp.asarray(bias))
    dx, doff, dmask, dw, db = vjp(nhwc(grad))
    return [nchw(dx), nchw(doff), nchw(dmask),
            np.transpose(np.asarray(dw, np.float32), (3, 2, 0, 1)),
            np.asarray(db, np.float32)]


def _assert_close(got, want, rtol=GRAD_RTOL, what=""):
    for name, g, w in zip(NAMES, got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (
            f"{what} {name}: max abs err {err:.3e}, limit {rtol * scale:.3e}")


def _jax_exact():
    return pytest.importorskip("centerfusiondetect3d_tpu.ops.dcn").deform_conv2d


@pytest.mark.parametrize("seed,shape", [
    (0, dict()), (1, dict(b=1, c=3, h=4, w=5, o=2)),
    (2, dict(c=16, h=12, w=7, o=9)), (3, dict(b=3, c=1, h=1, w=6, o=1))])
def test_plain_backward_matches_jax_grad(seed, shape):
    args = _case(seed, **shape)
    _assert_close(_plain_grads(args), _jax_grads(_jax_exact(), args),
                  what=f"seed {seed}")


def _special_offsets(kind, b, h, w):
    """Offsets that land every sample on one of the convention cases."""
    rng = np.random.RandomState({"integer": 20, "border": 21,
                                 "outside": 22}[kind])
    if kind == "integer":
        # whole-pixel shifts: ly = lx = 0, the derivative is one-sided
        return rng.randint(-2, 3, (b, 18, h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    off = np.zeros((b, 18, h, w), np.float32)
    for k in range(9):
        i, j = divmod(k, 3)
        if kind == "border":
            # sample at -0.5 .. -0.1 or H-0.9 .. H-0.6 (and the same in x):
            # one corner pair inside, one outside
            ty = np.where(rng.rand(b, h, w) < 0.5, rng.uniform(-0.9, -0.1,
                          (b, h, w)), rng.uniform(h - 0.9, h - 0.1, (b, h, w)))
            tx = np.where(rng.rand(b, h, w) < 0.5, rng.uniform(-0.9, -0.1,
                          (b, h, w)), rng.uniform(w - 0.9, w - 0.1, (b, h, w)))
        else:
            # wholly outside (-1, H) x (-1, W): every corner outside
            ty = np.where(rng.rand(b, h, w) < 0.5, -1.0 - rng.uniform(
                0.01, 3, (b, h, w)), h + rng.uniform(0.01, 3, (b, h, w)))
            tx = rng.uniform(-1, w, (b, h, w))
        off[:, 2 * k] = ty - (ys + i - 1)
        off[:, 2 * k + 1] = tx - (xs + j - 1)
    return off.astype(np.float32)


@pytest.mark.parametrize("kind", ["integer", "border", "outside"])
def test_plain_backward_conventions_match_jax(kind):
    x, _, mask, weight, bias, grad = _case(30, b=2, c=4, h=6, w=7, o=3)
    offset = _special_offsets(kind, 2, 6, 7)
    args = (x, offset, mask, weight, bias, grad)
    got = _plain_grads(args)
    _assert_close(got, _jax_grads(_jax_exact(), args), what=kind)
    if kind == "outside":
        # nothing sampled: no input, offset or mask gradient at all
        for g in got[:3]:
            assert not np.any(g)
    if kind == "integer":
        # one-sided: d/dy at an integer y is x[y0 + 1] - x[y0] (here for
        # tap 4, the centre, of pixel (2, 3) of image 0, channel sum)
        py = 2 + offset[0, 8, 2, 3]
        px = 3 + offset[0, 9, 2, 3]
        if 0 <= py < 5 and 0 <= px < 7:
            wsum = weight[:, :, 1, 1].T @ grad[0, :, 2, 3]  # (C,)
            want = mask[0, 4, 2, 3] * float(
                wsum @ (x[0, :, int(py) + 1, int(px)]
                        - x[0, :, int(py), int(px)]))
            np.testing.assert_allclose(got[1][0, 8, 2, 3], want, rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("max_offset", [1.0, 8.0])
def test_plain_backward_matches_fast_vjp_interpret(max_offset):
    """The VJP of the trainable TPU kernel K3 (``deform_conv2d_fast``, its
    Pallas forward in interpret mode): the clamp sits inside the
    differentiated function, so clamped offsets get a zero gradient."""
    pallas_dcn = pytest.importorskip("centerfusiondetect3d_tpu.ops.pallas_dcn")
    args = _case(40, b=1, c=4, h=8, w=10, o=4, scale=1.5 * max_offset)
    want = _jax_grads(
        lambda *a: pallas_dcn.deform_conv2d_fast(*a, max_offset, True), args)
    got = _plain_grads(args, max_offset=max_offset)
    _assert_close(got, want, what=f"max_offset {max_offset}")
    clamped = np.abs(args[1]) > max_offset
    assert clamped.any() and not np.any(got[1][clamped])


@pytest.mark.parametrize("max_offset", [None, 1.0])
def test_plain_gradcheck_float64(max_offset):
    x, offset, mask, weight, bias, _ = _case(50, b=1, c=2, h=4, w=5, o=3,
                                             far=False)
    tensors = [torch.from_numpy(a).double().requires_grad_(True)
               for a in (x, offset, mask, weight, bias)]
    assert torch.autograd.gradcheck(
        lambda *t: dcn.deform_conv2d_plain(*t, max_offset=max_offset),
        tensors, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_im2col_plain_is_the_forward_columns():
    """The pixel-major columns (B, H*W, 9, C) contract with the weight in
    (k, c) order to the forward."""
    x, offset, mask, weight, bias, _ = (torch.from_numpy(a)
                                        for a in _case(60))
    cols = dcn.dcn_im2col_plain(x, offset, mask)
    b, c, h, w = x.shape
    o = weight.shape[0]
    assert cols.shape == (b, h * w, 9, c) and cols.is_contiguous()
    w_kc = weight.permute(0, 2, 3, 1).reshape(o, 9 * c)
    out = cols.reshape(b, h * w, 9 * c) @ w_kc.t() + bias
    want = dcn.deform_conv2d_plain(x, offset, mask, weight, bias)
    torch.testing.assert_close(out.transpose(1, 2).reshape(want.shape), want,
                               rtol=1e-5, atol=1e-5)


def test_wrapper_autograd_on_cpu_is_plain_and_launches_nothing():
    args = [torch.from_numpy(a) for a in _case(61)]
    leaves = [t.clone().requires_grad_(True) for t in args[:5]]
    counts = _counts()
    out = dcn.deform_conv2d(*leaves, max_offset=8.0)
    got = torch.autograd.grad(out, leaves, args[5])
    want = dcn.deform_conv2d_backward_plain(*args, max_offset=8.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _counts() == counts


def test_backward_wrappers_run_plain_on_cpu_and_check_the_card_inputs():
    x, offset, mask, weight, _, grad = (torch.from_numpy(a)
                                        for a in _case(62))
    dcols = torch.randn(2, 99, 9, 5)
    counts = _counts()
    torch.testing.assert_close(dcn.dcn_im2col(x, offset, mask, 8.0),
                               dcn.dcn_im2col_plain(x, offset, mask, 8.0))
    torch.testing.assert_close(
        dcn.dcn_col2im(dcols, offset, mask),
        dcn.dcn_col2im_plain(dcols, x, offset, mask))
    for a, b in zip(dcn.dcn_col2im_coord(dcols, x, offset, mask),
                    dcn.dcn_col2im_coord_plain(dcols, x, offset, mask)):
        torch.testing.assert_close(a, b)
    assert _counts() == counts
    # what the kernels do not take is refused before a build or a launch
    with pytest.raises(TypeError):
        dcn._check_sampling(x.double(), offset, mask, None)
    with pytest.raises(ValueError):
        dcn._check_sampling(x, offset[:, :9], mask, None)
    with pytest.raises(ValueError):
        dcn._check_columns(dcols[:, :44], offset, mask, None)
    with pytest.raises(ValueError, match="contiguous"):
        dcn._check_columns(dcols.transpose(0, 1).contiguous().transpose(0, 1),
                           offset, mask, None)
    with pytest.raises(ValueError):
        dcn._check_sampling(x, offset, mask, -2.0)
    with pytest.raises(RuntimeError, match="no kernel"):
        dcn.dcn_im2col(x.to("meta"), offset.to("meta"), mask.to("meta"))


def _counts():
    return [dcn.deform_conv2d.launches] + [
        f.launches for f in dcn.BACKWARD_KERNELS.values()]


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("max_offset", [None, 8.0, 1.0])
@pytest.mark.parametrize("shape", [
    dict(), dict(b=2, c=64, h=20, w=30, o=64),
    dict(b=1, c=130, h=13, w=17, o=70), dict(b=1, c=3, h=1, w=1, o=1)])
def test_backward_kernels_match_plain_on_card(shape, max_offset):
    _card()
    args = [torch.from_numpy(a).cuda() for a in _case(70, **shape)]
    x, offset, mask, weight, bias, grad = args
    counts = _counts()
    got = dcn.deform_conv2d_backward(x, offset, mask, weight, grad,
                                     max_offset)
    torch.cuda.synchronize()
    assert _counts() == [counts[0]] + [c + 1 for c in counts[1:]]
    want = dcn.deform_conv2d_backward_plain(*args, max_offset=max_offset)
    _assert_close([t.cpu().numpy() for t in got],
                  [t.cpu().numpy() for t in want], what=str(shape))
    cols = dcn.dcn_im2col(x, offset, mask, max_offset)
    torch.testing.assert_close(
        cols, dcn.dcn_im2col_plain(x, offset, mask, max_offset),
        rtol=0, atol=1e-5 * max(1.0, float(x.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "border", "outside"])
def test_backward_kernels_conventions_on_card(kind):
    _card()
    x, _, mask, weight, bias, grad = _case(30, b=2, c=4, h=6, w=7, o=3)
    offset = _special_offsets(kind, 2, 6, 7)
    args = [torch.from_numpy(a).cuda()
            for a in (x, offset, mask, weight, bias, grad)]
    got = dcn.deform_conv2d_backward(*args[:4], args[5])
    want = dcn.deform_conv2d_backward_plain(*args)
    _assert_close([t.cpu().numpy() for t in got],
                  [t.cpu().numpy() for t in want], what=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["all", "weight", "x", "offset_mask",
                                   "no_bias"])
def test_autograd_function_on_card(needs):
    """deform_conv2d under autograd on the card launches dcn_fwd and only
    the backward kernels its gradients need, and matches the plain grads."""
    _card()
    args = [torch.from_numpy(a).cuda() for a in _case(71, c=16, o=8)]
    want = dcn.deform_conv2d_backward_plain(*args, max_offset=None)
    flags = {"all": (1, 1, 1, 1, 1), "weight": (0, 0, 0, 1, 1),
             "x": (1, 0, 0, 0, 0), "offset_mask": (0, 1, 1, 0, 0),
             "no_bias": (1, 1, 1, 1, 0)}[needs]
    leaves = [t.clone().requires_grad_(bool(f))
              for t, f in zip(args[:5], flags)]
    if needs == "no_bias":
        leaves[4] = None
    counts = _counts()
    out = dcn.deform_conv2d(*leaves)
    out.backward(args[5])
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), counts)]
    assert launched[0] == 1
    assert launched[1] == flags[3]  # im2col only for dweight
    assert launched[2] == flags[0]  # col2im only for dx
    assert launched[3] == int(flags[1] or flags[2])
    for leaf, w, name in zip(leaves, want, NAMES):
        if leaf is None or not leaf.requires_grad:
            continue
        scale = max(float(w.abs().max()), 1e-6)
        err = float((leaf.grad - w).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("max_offset", [None, 1.0])
def test_plain_kernel_pieces_compose_to_the_plain_backward(max_offset):
    """dcn_im2col_plain, the two GEMMs, dcn_col2im_plain and
    dcn_col2im_coord_plain give the plain backward (the decomposition the
    card's kernels follow)."""
    x, offset, mask, weight, bias, grad = (torch.from_numpy(a)
                                           for a in _case(63))
    cols = dcn.dcn_im2col_plain(x, offset, mask, max_offset)
    dcols = dcn.column_gradients(weight, grad)
    got = (dcn.dcn_col2im_plain(dcols, x, offset, mask, max_offset),
           *dcn.dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset),
           dcn.weight_gradient(grad, cols), grad.sum((0, 2, 3)))
    want = dcn.deform_conv2d_backward_plain(x, offset, mask, weight, bias,
                                            grad, max_offset)
    _assert_close([t.numpy() for t in got], [t.numpy() for t in want],
                  rtol=1e-5, what="composed")


@pytest.mark.cuda
@pytest.mark.parametrize("max_offset", [None, 8.0, 1.0])
def test_each_backward_kernel_matches_its_plain_version_on_card(max_offset):
    _card()
    x, offset, mask, _, _, _ = (torch.from_numpy(a).cuda()
                                for a in _case(72, c=24, h=17, w=23))
    dcols = torch.randn(2, 17 * 23, 9, 24, device="cuda")
    pairs = [
        (dcn.dcn_im2col(x, offset, mask, max_offset),
         dcn.dcn_im2col_plain(x, offset, mask, max_offset)),
        (dcn.dcn_col2im(dcols, offset, mask, max_offset),
         dcn.dcn_col2im_plain(dcols, x, offset, mask, max_offset)),
        *zip(dcn.dcn_col2im_coord(dcols, x, offset, mask, max_offset),
             dcn.dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale


@pytest.mark.cuda
def test_train_step_kernel_matches_plain_on_card():
    """One unfrozen train step of a small DeformConv model on the card.
    Inside the kernel step each DCN node's backward matches the plain
    backward on the tensors it saw (GRAD_RTOL). The step's loss parts and
    gradients are held against a float64 plain step to 4x the plain
    float32 step's own deviation plus 1e-3: a float32 train step of this
    seeded DLA-34 is chaotic (train-mode BatchNorm over nearly constant
    channels), so two correct float32 steps differ by far more than 1e-3."""
    _card()
    from centerfusiondetect3d_tpu_torch.config import load_config
    from centerfusiondetect3d_tpu_torch.data.pipeline import (
        stack_items,
        to_device,
    )
    from centerfusiondetect3d_tpu_torch.losses import GenericLoss
    from centerfusiondetect3d_tpu_torch.models import build_model
    from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
    from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
        MAIN_PATH_OPTS,
        SyntheticTrainingSet,
        seeded_weights,
    )
    from centerfusiondetect3d_tpu_torch.training import (
        make_optimizer,
        train_step,
    )

    cfg = load_config(opts=MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(64, 128)",
                                             "MIXED_PRECISION", "False"],
                      num_classes=10)
    ds = SyntheticTrainingSet(cfg, 2)
    host = stack_items([ds.get_item(i) for i in range(2)])
    runs, records = [], []
    for fn, dtype in ((None, torch.float32),
                      (dcn.deform_conv2d_plain, torch.float32),
                      (dcn.deform_conv2d_plain, torch.float64)):
        model = build_model(cfg)
        seeded_weights(model, 0)
        model = model.to("cuda", dtype)
        for m in model.modules():
            if isinstance(m, DeformConvNode):
                m.dcn_fn = fn or _recording(m, records)
        cast = lambda v: v.to(dtype) if v.is_floating_point() else v
        batch = {k: ({kk: cast(vv) for kk, vv in v.items()}
                     if isinstance(v, dict) else cast(v))
                 for k, v in to_device(host, "cuda").items()}
        counts = _counts()
        metrics = train_step(model, make_optimizer(cfg, model),
                             GenericLoss(cfg), batch, 1e-4)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), counts)]
        assert launched == ([16] * 4 if fn is None else [0] * 4)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.double() for n, p in model.named_parameters()}))
    assert len(records) == 16
    for rec in records:
        want = dcn.deform_conv2d_backward_plain(
            rec["x"], rec["offset"], rec["mask"], rec["weight"], rec["bias"],
            rec["grad_out"])
        got = (rec["dx"], rec["doffset"], rec["dmask"],
               rec["node"].weight.grad, rec["node"].bias.grad)
        _assert_close([t.cpu().numpy() for t in got],
                      [t.cpu().numpy() for t in want], what="in-step")
    (m_k, g_k), (m_p, g_p), (m_64, g_64) = runs
    for k, w in m_64.items():
        ek, ep = abs(m_k[k] - w), abs(m_p[k] - w)
        assert ek <= 4 * ep + 1e-3 * abs(w), (k, ek, ep, w)
    for n, w in g_64.items():
        if n.endswith(".bias") and n[:-5] + ".conv_offset_mask.weight" in g_64:
            continue  # exact gradient 0: train-mode BatchNorm follows
        scale = float(w.abs().max())
        ek = float((g_k[n] - w).abs().max())
        ep = float((g_p[n] - w).abs().max())
        assert ek <= 4 * ep + 1e-3 * scale, (n, ek, ep, scale)


def _recording(node, records):
    """A DCN op for ``node`` that records its inputs, weight, output
    gradient and the gradients it returns for x, offset and mask."""
    def fn(x, offset, mask, weight, bias, max_offset=None):
        xv = x.view_as(x)  # the op's own handle on x: only it feeds dx
        rec = {"node": node, "x": x.detach(), "offset": offset.detach(),
               "mask": mask.detach(), "weight": weight.detach().clone(),
               "bias": bias.detach().clone()}
        for name, t in (("dx", xv), ("doffset", offset), ("dmask", mask)):
            t.register_hook(lambda g, name=name: rec.__setitem__(name, g))
        out = dcn.deform_conv2d(xv, offset, mask, weight, bias, max_offset)
        out.register_hook(lambda g: rec.__setitem__("grad_out", g))
        records.append(rec)
        return out
    return fn
