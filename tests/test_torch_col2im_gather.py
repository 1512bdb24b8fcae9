"""The DCN backward's dx as a gather through an inverse sampling map.

``dcn_col2im`` / ``dcn_col2im_bf16`` on the card build a map from each
pixel q to the samples (tap k, output pixel p) whose bilinear corners land
on q (``csrc/dcn_bwd.cu``), then sum each pixel's entries. Their plain model
(``dcn_inverse_map_plain``, ``dcn_col2im_gather_plain``) is held here
against the plain col2im (autograd of the plain im2col) in float64, against
``jax.vjp`` of the JAX XLA formulation with the clamp inside the
differentiated function (as the TPU kernel K3's backward takes it) in
float32, and against brute-force invariants of the map; the kernels are
held against the plain versions on the card (``-m cuda``).

Offsets cover the smoke's draw, zero offsets, the convention cases of
``test_torch_dcn_grad.py`` (integer, border, outside), every tap of an
image collapsed onto one pixel (long segments), and wild offsets (+-1e4).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from test_torch_dcn_grad import (
    GRAD_RTOL,
    _case,
    _jax_grads,
    _special_offsets,
)

torch.set_num_threads(1)

# the bf16 gather against the bf16 plain col2im: two bf16 ulps at the
# largest magnitude (f32 sums in another order, one rounding each)
BF16_RTOL = 8e-3
# float64: the same sums in another order
F64_RTOL = 1e-12
B, C, H, W = 2, 8, 9, 11
KINDS = ("seeded", "zero", "integer", "border", "outside", "collapsed",
         "wild")
CLAMPS = (None, 8.0, 1.0)


def _offsets(kind, b=B, h=H, w=W):
    """(B, 18, H, W) float32 offsets of one kind (see the module note)."""
    rng = np.random.RandomState(KINDS.index(kind))
    if kind in ("integer", "border", "outside"):
        return _special_offsets(kind, b, h, w)
    if kind == "zero":
        return np.zeros((b, 18, h, w), np.float32)
    off = 1.5 * rng.randn(b, 18, h, w)
    if kind == "seeded":
        # the smoke's draw: N(0, 1.5 px) with 2% pushed to 8-12 px
        far = rng.rand(*off.shape) < 0.02
        off = np.where(far, np.sign(off) * rng.uniform(8, 12, off.shape),
                       off)
    elif kind == "wild":
        far = rng.rand(*off.shape) < 0.3
        off = np.where(far, np.sign(off) * rng.uniform(1e3, 1e4, off.shape),
                       off)
    elif kind == "collapsed":
        # image 0 onto the integer pixel (3, 4), image 1 onto (2.5, 6.25)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        for k in range(9):
            i, j = divmod(k, 3)
            for img, (ty, tx) in enumerate(((3.0, 4.0), (2.5, 6.25))):
                off[img, 2 * k] = ty - (ys + i - 1)
                off[img, 2 * k + 1] = tx - (xs + j - 1)
    return off.astype(np.float32)


def _inputs(kind, dtype=torch.float64, seed=0, b=B, c=C, h=H, w=W):
    """offset, mask (one tap of image 0 masked to 0) and dcols (B, 9C, HW)
    lying (9C, B, HW) as the GEMM leaves them."""
    rng = np.random.RandomState(100 + seed)
    mask = 1 / (1 + np.exp(-rng.randn(b, 9, h, w)))
    mask[0, 4, : h // 2] = 0.0
    dcols = rng.randn(9 * c, b, h * w)
    offset = torch.from_numpy(_offsets(kind, b, h, w)).to(dtype)
    return (offset, torch.from_numpy(mask).to(dtype),
            torch.from_numpy(dcols).to(dtype).transpose(0, 1))


def _rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
def test_gather_model_matches_plain_col2im_float64(kind, max_offset):
    offset, mask, dcols = _inputs(kind)
    got = dcn.dcn_col2im_gather_plain(dcols, offset, mask, H, W, max_offset)
    want = dcn.dcn_col2im_plain(dcols, torch.zeros(B, C, H, W,
                                                   dtype=torch.float64),
                                offset, mask, max_offset)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) <= F64_RTOL
    if kind == "outside" and max_offset is None:
        assert not bool(got.any())  # nothing sampled, nothing gathered


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
def test_gather_model_matches_jax_vjp_float32(kind, max_offset):
    """dx of jax.vjp of the XLA DCN (``ops/dcn.py:29``) with the clamp
    inside, as ``pallas_dcn.py:_fast_bwd`` takes it: the gather of the
    column gradients W^T g."""
    jax_dcn = pytest.importorskip(
        "centerfusiondetect3d_tpu.ops.dcn").deform_conv2d
    import jax.numpy as jnp

    x, _, _, weight, bias, grad = _case(7, b=B, c=C, h=H, w=W, o=5)
    offset = _offsets(kind)
    mask = _inputs(kind, torch.float32)[1].numpy()

    def clamped(x, off, m, wt, bs):
        if max_offset is not None:
            off = jnp.clip(off, -max_offset, max_offset)
        return jax_dcn(x, off, m, wt, bs)

    want = _jax_grads(clamped, (x, offset, mask, weight, bias, grad))[0]
    dcols = dcn.column_gradients(torch.from_numpy(weight),
                                 torch.from_numpy(grad))
    got = dcn.dcn_col2im_gather_plain(dcols, torch.from_numpy(offset),
                                      torch.from_numpy(mask), H, W,
                                      max_offset)
    assert got.dtype == torch.float32
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= GRAD_RTOL * scale, (err, scale)


def _brute_force_corners(offset, mask, max_offset):
    """Per (b, k, p): the list of (q, weight) of its corners inside the
    image with a non-zero weight, and the in-image share of its bilinear
    weights; from the JAX formulation's arithmetic in float64 numpy."""
    off = offset.numpy().astype(np.float64)
    if max_offset is not None:
        off = np.clip(off, -max_offset, max_offset)
    msk = mask.numpy().astype(np.float64)
    corners, share = {}, {}
    for b in range(B):
        for k in range(9):
            i, j = divmod(k, 3)
            for p in range(H * W):
                py = p // W + i - 1 + off[b, 2 * k].flat[p]
                px = p % W + j - 1 + off[b, 2 * k + 1].flat[p]
                y0, x0 = np.floor(py), np.floor(px)
                ly, lx = py - y0, px - x0
                found, total = [], 0.0
                for cy in (0, 1):
                    for cx in (0, 1):
                        yy, xx = int(y0) + cy, int(x0) + cx
                        wgt = (ly if cy else 1 - ly) * (lx if cx else 1 - lx)
                        if 0 <= yy < H and 0 <= xx < W:
                            total += wgt
                            wgt *= msk[b, k].flat[p]
                            if wgt != 0:
                                found.append((yy * W + xx, wgt))
                corners[b, k, p] = found
                share[b, k, p] = msk[b, k].flat[p] * total
    return corners, share


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
def test_inverse_map_invariants(kind, max_offset):
    """Each segment holds exactly the in-image, non-zero-weight corners
    that land on its pixel, in increasing key order; every entry points
    back to a sample that lands there, with that corner's weight; and the
    weights of one (b, k, p) sum to its mask times the in-image share of
    its bilinear weights."""
    offset, mask, _ = _inputs(kind)
    ends, keys, weights = dcn.dcn_inverse_map_plain(offset, mask, H, W,
                                                    max_offset)
    assert ends.dtype == keys.dtype == torch.int32
    assert weights.dtype == torch.float64
    assert ends.shape == (B * H * W,)
    assert keys.shape == weights.shape == (int(ends[-1]),)
    corners, share = _brute_force_corners(offset, mask, max_offset)
    want = {bq: [] for bq in range(B * H * W)}
    for (b, k, p), found in corners.items():
        for q, _ in found:
            want[b * H * W + q].append(p * 9 + k)
    total = {}
    start = 0
    for bq, end in enumerate(ends.tolist()):
        seg = keys[start:end].tolist()
        assert seg == sorted(want[bq]), bq  # length, entries, order
        b, q = divmod(bq, H * W)
        for key, wgt in zip(seg, weights[start:end].tolist()):
            p, k = divmod(key, 9)
            np.testing.assert_allclose(wgt, dict(corners[b, k, p])[q],
                                       rtol=1e-12)
            total[b, k, p] = total.get((b, k, p), 0.0) + wgt
        start = end
    for bkp, want_share in share.items():
        np.testing.assert_allclose(total.get(bkp, 0.0), want_share,
                                   rtol=1e-12, atol=1e-15)
    if kind == "collapsed" and max_offset is None:
        # every unmasked sample of image 0 lands on (3, 4) alone
        seg_len = np.diff(np.concatenate([[0], ends.numpy()]))
        assert seg_len[3 * W + 4] == 9 * H * W - int((mask[0] == 0).sum())


@pytest.mark.parametrize("max_offset", CLAMPS)
def test_bf16_gather_model_matches_bf16_plain(max_offset):
    """bf16 column gradients, summed in float32 and rounded once."""
    offset, mask, dcols = _inputs("seeded", torch.float32)
    dcols = dcols.bfloat16()
    got = dcn.dcn_col2im_gather_plain(dcols, offset, mask, H, W, max_offset)
    want = dcn.dcn_col2im_bf16_plain(dcols, torch.zeros(B, C, H, W), offset,
                                     mask, max_offset)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want.float()) <= BF16_RTOL


def test_col2im_wrappers_on_cpu_are_plain_and_launch_nothing():
    offset, mask, dcols = _inputs("seeded", torch.float32)
    counts = (dcn.dcn_col2im.launches, dcn.dcn_col2im_bf16.launches,
              dcn.dcn_inverse_map.launches)
    assert torch.equal(dcn.dcn_col2im(dcols, offset, mask, 8.0),
                       dcn.dcn_col2im_plain(dcols, torch.zeros(B, C, H, W),
                                            offset, mask, 8.0))
    for a, b in zip(dcn.dcn_inverse_map(offset, mask, 8.0),
                    dcn.dcn_inverse_map_plain(offset, mask, H, W, 8.0)):
        assert torch.equal(a, b)
    assert (dcn.dcn_col2im.launches, dcn.dcn_col2im_bf16.launches,
            dcn.dcn_inverse_map.launches) == counts


def test_map_checks_refuse_what_the_kernels_do_not_take():
    offset, mask, _ = _inputs("seeded", torch.float32)
    with pytest.raises(TypeError):
        dcn._check_offset_mask(offset.double(), mask, None)
    with pytest.raises(ValueError):
        dcn._check_offset_mask(offset[:, :17].contiguous(), mask, None)
    with pytest.raises(ValueError):
        dcn._check_offset_mask(offset, mask, -1.0)
    # 36 entries a pixel must fit the int32 keys and slots, checked before
    # anything is allocated or launched
    with pytest.raises(ValueError, match="int32"):
        dcn._inverse_map(torch.empty((1, 18, 8192, 8192), device="meta"),
                         torch.empty((1, 9, 8192, 8192), device="meta"),
                         None)
    with pytest.raises(RuntimeError, match="no kernel"):
        dcn.dcn_inverse_map(offset.to("meta"), mask.to("meta"))


# ------------------------------------------------------------------ the card

# the distinct (C, H, W) of the DCN nodes at the main path's 448x800
NODE_SHAPES = ((512, 14, 25), (256, 28, 50), (128, 56, 100), (64, 112, 200))
DTYPES = {"float32": (torch.float32, dcn.dcn_col2im, GRAD_RTOL),
          "bf16": (torch.bfloat16, dcn.dcn_col2im_bf16, BF16_RTOL)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _plain_dx(dtype, dcols, offset, mask, max_offset):
    b, rows, _ = dcols.shape
    x = torch.zeros((b, rows // 9) + tuple(offset.shape[2:]),
                    device=dcols.device)
    if dtype == torch.bfloat16:
        return dcn.dcn_col2im_bf16_plain(dcols, x, offset, mask, max_offset)
    return dcn.dcn_col2im_plain(dcols, x, offset, mask, max_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_map_and_dx_match_plain_on_card(kind, max_offset):
    """The kernels' map equals the plain map (segments sorted: keys
    exactly, weights to float32 rounding), and their dx the plain col2im's,
    in both dtypes, on every offset kind."""
    _card()
    offset, mask, dcols = (t.cuda() for t in _inputs(kind, torch.float32))
    ends, keys, weights = dcn.dcn_inverse_map(offset, mask, max_offset)
    want = dcn.dcn_inverse_map_plain(offset.cpu(), mask.cpu(), H, W,
                                     max_offset)
    assert torch.equal(ends.cpu(), want[0])
    assert torch.equal(keys.cpu(), want[1])
    # the same float32 products in the same order
    torch.testing.assert_close(weights.cpu(), want[2], rtol=1e-6, atol=0)
    for name, (dtype, col2im, rtol) in DTYPES.items():
        d = dcols.to(dtype)
        got = col2im(d, offset, mask, max_offset)
        want = _plain_dx(dtype, d, offset, mask, max_offset)
        assert got.dtype == dtype and got.shape == want.shape, name
        assert _rel(got.float(), want.float()) <= rtol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("shape", NODE_SHAPES)
def test_kernel_col2im_matches_plain_at_node_shapes_on_card(shape, max_offset,
                                                            dtype):
    """At the main path's node shapes (B=2) on the smoke's offsets, one
    launch each; and two runs give bitwise-equal dx (sorted segments)."""
    _card()
    torch_dtype, col2im, rtol = DTYPES[dtype]
    c, h, w = shape
    offset, mask, dcols = (t.cuda() for t in _inputs("seeded", torch.float32,
                                                     b=2, c=c, h=h, w=w))
    dcols = dcols.to(torch_dtype)
    before = col2im.launches
    got = col2im(dcols, offset, mask, max_offset)
    again = col2im(dcols, offset, mask, max_offset)
    torch.cuda.synchronize()
    assert col2im.launches == before + 2
    assert torch.equal(got, again)
    want = _plain_dx(torch_dtype, dcols, offset, mask, max_offset)
    assert _rel(got.float(), want.float()) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_col2im_collapsed_is_reproducible_on_card(dtype):
    """Every tap of every pixel collapsed onto one pixel at the largest
    node shape: segments of 9*H*W entries (the long sort, and warps that
    walk 9*H*W entries), right and bitwise reproducible."""
    _card()
    torch_dtype, col2im, rtol = DTYPES[dtype]
    c, h, w = NODE_SHAPES[-1]
    offset, mask, dcols = (t.cuda() for t in _inputs(
        "collapsed", torch.float32, b=2, c=c, h=h, w=w))
    dcols = dcols.to(torch_dtype)
    ends = dcn.dcn_inverse_map(offset, mask)[0]
    # image 0 onto the integer pixel (3, 4): one entry per unmasked sample
    q = 3 * w + 4
    assert int(ends[q] - ends[q - 1]) == 9 * h * w - int((mask[0] == 0).sum())
    got = col2im(dcols, offset, mask)
    assert torch.equal(got, col2im(dcols, offset, mask))
    want = _plain_dx(torch_dtype, dcols, offset, mask, None)
    assert _rel(got.float(), want.float()) <= rtol
