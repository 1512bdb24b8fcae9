"""The DCN backward on pixel-major columns and a channels-last x.

``csrc/dcn_bwd.cu``'s ``dcn_im2col`` and ``dcn_col2im_coord`` (float32 and
bf16) read x channels-last (the copy the forward made, which
``DeformConv2dFunction`` saves) and lay the columns and column gradients out
(B, H*W, 9, C): a pixel's 9*C values tap-major, channels fastest, written
and read by the two GEMMs (``weight_gradient``, ``column_gradients``) as
they lie, and by col2im's gather with no copy where C is a multiple of 32.

On the CPU the new-layout plain pieces compose to the JAX gradients:
``dcn_im2col_plain`` then ``weight_gradient`` give dweight,
``column_gradients`` then ``dcn_col2im_coord_plain`` give doffset and
dmask, ``dcn_col2im_plain`` gives dx. They are held against ``jax.vjp`` of
``centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d`` with the clamp inside
(1e-4 relative in float32), against K3's ``deform_conv2d_fast`` in
interpret mode, and against the plain autograd in float64 (1e-12); bf16 as
``test_torch_dcn_bf16_grad.py`` holds it. The coord kernel's own algebra
(the 4 corner sums over C, then the sample and its derivatives) is held
against the plain coord in float64. Cases: C not a multiple of the vector
width or of 32, B*H*W not a multiple of the 32-pixel tile, max_offset None,
8 and 1, zero, integer, border, outside and collapsed offsets, an NCHW and
a channels-last x. The ``cuda`` cases hold each kernel against its plain
version at the node shapes on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from test_torch_col2im_gather import _offsets
from test_torch_dcn_bf16_grad import (
    _assert_within_jax_noise,
    _jax_vjp,
)
from test_torch_dcn_bf16_grad import _case as _bf16_case
from test_torch_dcn_grad import GRAD_RTOL, _assert_close, _case, _jax_grads

torch.set_num_threads(1)

F64_RTOL = 1e-12
BF16_RTOL = 8e-3  # two bf16 ulps at the largest magnitude
CLAMPS = (None, 8.0, 1.0)
KINDS = ("seeded", "zero", "integer", "border", "outside", "collapsed")
# (B, C, H, W, O): C = 5 is no multiple of either vector width (4 float32,
# 8 bf16), C = 40 is one but no multiple of 32; B*H*W = 198 and 84 are no
# multiples of the 32-pixel tile
SHAPES = ((2, 5, 9, 11, 7), (2, 40, 6, 7, 3))


def _inputs(kind, shape, seed=0, dtype=np.float32):
    """x, offset (of ``kind``), mask, weight, bias, output gradient."""
    b, c, h, w, o = shape
    x, offset, mask, weight, bias, grad = _case(seed, b=b, c=c, h=h, w=w,
                                                o=o)
    if kind != "seeded":
        offset = _offsets(kind, b, h, w)
    return tuple(np.asarray(a, dtype) for a in (x, offset, mask, weight,
                                                bias, grad))


def _layout(x, layout):
    return (x.contiguous(memory_format=torch.channels_last)
            if layout == "channels_last" else x)


def _pieces(args, max_offset, layout="nchw"):
    """(dx, doffset, dmask, dweight, dbias) from the new-layout plain
    pieces around the two GEMMs."""
    x, offset, mask, weight, _, grad = (torch.from_numpy(a) for a in args)
    x = _layout(x, layout)
    cols = dcn.dcn_im2col_plain(x, offset, mask, max_offset)
    b, c, h, w = x.shape
    assert cols.shape == (b, h * w, 9, c) and cols.is_contiguous()
    dcols = dcn.column_gradients(weight, grad)
    assert dcols.shape == (b, h * w, 9, c) and dcols.is_contiguous()
    return (dcn.dcn_col2im_plain(dcols, x, offset, mask, max_offset),
            *dcn.dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset),
            dcn.weight_gradient(grad, cols), grad.sum((0, 2, 3)))


def _clamped_jax(max_offset):
    """The JAX exact op with the clamp inside, differentiated as
    ``torch.clamp`` (and the kernels) differentiate it: the gradient passes
    where |offset| <= max_offset, the boundary included. (``jnp.clip``
    passes half of it at the boundary, which integer and collapsed offsets
    hit at max_offset 1.)"""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    exact = pytest.importorskip(
        "centerfusiondetect3d_tpu.ops.dcn").deform_conv2d
    stop = jax.lax.stop_gradient

    def fn(x, off, m, wt, bs):
        if max_offset is not None:
            inside = jnp.abs(off) <= max_offset
            off = (stop(jnp.clip(off, -max_offset, max_offset))
                   + jnp.where(inside, off - stop(off), 0.0))
        return exact(x, off, m, wt, bs)
    return fn


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pixel_major_pieces_match_jax_vjp(shape, max_offset, layout):
    args = _inputs("seeded", shape, seed=1)
    got = [t.numpy() for t in _pieces(args, max_offset, layout)]
    _assert_close(got, _jax_grads(_clamped_jax(max_offset), args),
                  what=f"{shape} {max_offset} {layout}")


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS[1:])
def test_pixel_major_pieces_on_offset_kinds_match_jax_vjp(kind, max_offset):
    args = _inputs(kind, SHAPES[0], seed=2)
    got = [t.numpy() for t in _pieces(args, max_offset, "channels_last")]
    _assert_close(got, _jax_grads(_clamped_jax(max_offset), args),
                  what=f"{kind} {max_offset}")


@pytest.mark.parametrize("max_offset", [1.0, 8.0])
def test_pixel_major_pieces_match_fast_vjp_interpret(max_offset):
    """Against the VJP of K3 (``deform_conv2d_fast``, Pallas forward in
    interpret mode, ``_fast_bwd``), with its clamp inside."""
    pallas_dcn = pytest.importorskip("centerfusiondetect3d_tpu.ops.pallas_dcn")
    x, offset, mask, weight, bias, grad = _case(41, b=1, c=5, h=7, w=9, o=3,
                                                scale=1.5 * max_offset)
    args = (x, offset, mask, weight, bias, grad)
    want = _jax_grads(
        lambda *a: pallas_dcn.deform_conv2d_fast(*a, max_offset, True), args)
    got = [t.numpy() for t in _pieces(args, max_offset, "channels_last")]
    _assert_close(got, want, what=f"fast {max_offset}")
    clamped = np.abs(offset) > max_offset
    assert clamped.any() and not np.any(got[1][clamped])


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pixel_major_pieces_float64(shape, kind, max_offset):
    """In float64 the pieces are the plain autograd's gradients to the
    order of their sums."""
    args = _inputs(kind, shape, seed=3, dtype=np.float64)
    got = _pieces(args, max_offset, "channels_last")
    want = dcn.deform_conv2d_backward_plain(
        *(torch.from_numpy(a) for a in args), max_offset=max_offset)
    _assert_close([t.numpy() for t in got], [t.numpy() for t in want],
                  rtol=F64_RTOL, what=f"{shape} {kind} {max_offset}")


def _coord_by_corner_sums(dcols, x, offset, mask, max_offset):
    """The coord kernel's algebra in float64: per (pixel, tap) the 4 sums
    over C of dcols times the corner values (zero for a corner outside the
    image), then the sample (dmask) and its y and x derivatives times the
    mask (doffset, zero for an offset outside the clamp range)."""
    b, c, h, w = x.shape
    hw = h * w
    xh = x.permute(0, 2, 3, 1).reshape(b * hw, c)
    off = offset.reshape(b, 9, 2, hw)
    pass_y = pass_x = torch.ones_like(off[:, :, 0], dtype=torch.bool)
    if max_offset is not None:
        pass_y = off[:, :, 0].abs() <= max_offset
        pass_x = off[:, :, 1].abs() <= max_offset
        off = off.clamp(-max_offset, max_offset)
    pos = torch.arange(hw)
    tap = torch.arange(9)
    py = (pos // w)[None, None] + (tap // 3)[None, :, None] - 1 + off[:, :, 0]
    px = (pos % w)[None, None] + (tap % 3)[None, :, None] - 1 + off[:, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    g = dcols.reshape(b, hw, 9, c).permute(0, 2, 1, 3)  # (B, 9, HW, C)
    sums = []
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = (y0 + cy).long(), (x0 + cx).long()
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        row = (torch.arange(b)[:, None, None] * hw
               + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
        sums.append((g * xh[row]).sum(-1) * inside)
    d00, d01, d10, d11 = sums
    val = (1 - ly) * ((1 - lx) * d00 + lx * d01) + ly * ((1 - lx) * d10
                                                         + lx * d11)
    d_y = (1 - lx) * (d10 - d00) + lx * (d11 - d01)
    d_x = (1 - ly) * (d01 - d00) + ly * (d11 - d10)
    m = mask.reshape(b, 9, hw)
    doffset = torch.stack([torch.where(pass_y, m * d_y, 0 * d_y),
                           torch.where(pass_x, m * d_x, 0 * d_x)], 2)
    return doffset.reshape(b, 18, h, w), val.reshape(b, 9, h, w)


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("kind", KINDS)
def test_coord_corner_sums_are_the_plain_coord_float64(kind, max_offset):
    x, offset, mask, weight, _, grad = (torch.from_numpy(a) for a in _inputs(
        kind, SHAPES[0], seed=4, dtype=np.float64))
    dcols = dcn.column_gradients(weight, grad)
    got = _coord_by_corner_sums(dcols, x, offset, mask, max_offset)
    want = dcn.dcn_col2im_coord_plain(dcols, x, offset, mask, max_offset)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= F64_RTOL * scale


def _bf16_pieces(args, max_offset, layout):
    """The bf16 backward from the new-layout bf16 plain pieces (columns and
    column gradients rounded once, float32 sums), as float64 arrays."""
    x, offset, mask, weight, _, grad = (torch.from_numpy(a) for a in args)
    xb = _layout(x.bfloat16(), layout)
    gb, wb = grad.bfloat16(), weight.bfloat16()
    cols = dcn.dcn_im2col_bf16_plain(xb, offset, mask, max_offset)
    dcols = dcn.column_gradients(wb.float(), gb.float()).bfloat16()
    out = (dcn.dcn_col2im_bf16_plain(dcols, xb, offset, mask, max_offset),
           *dcn.dcn_col2im_coord_bf16_plain(dcols, xb, offset, mask,
                                            max_offset),
           dcn.weight_gradient(gb.float(), cols.float()).bfloat16(),
           gb.float().sum((0, 2, 3)).bfloat16())
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want = dcn.deform_conv2d_bf16_backward_plain(xb, offset, mask, wb,
                                                 torch.zeros(1), gb,
                                                 max_offset)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    return [t.double().numpy() for t in out]


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("max_offset", CLAMPS)
def test_bf16_pixel_major_pieces_match_jax_bf16(max_offset, layout):
    """Within twice JAX bf16's own deviation from the float64 VJP plus
    1e-3, as ``test_torch_dcn_bf16_grad.py``; C = 5 (no vector multiple)
    and B*H*W = 90 (no tile multiple)."""
    jnp = pytest.importorskip("jax.numpy")
    args = _bf16_case(5, b=2, c=5, h=5, w=9, o=3)
    want = _jax_vjp(_clamped_jax(max_offset), args, jnp.bfloat16)
    ref = [g.numpy() for g in dcn.deform_conv2d_backward_plain(
        *(torch.from_numpy(a).double() for a in args),
        max_offset=max_offset)]
    _assert_within_jax_noise(_bf16_pieces(args, max_offset, layout), want,
                             ref, f"{max_offset} {layout}")


class _Spy:
    """Records the C entry points ``dcn._run`` is asked to call, with their
    first pointer argument, without calling them."""

    def __init__(self):
        self.calls = []

    def __call__(self, like, name, *args):
        self.calls.append((name, args[0]))


@pytest.mark.parametrize("c", [64, 24])
def test_col2im_reads_the_gemm_output_as_it_lies(monkeypatch, c):
    """At C % 32 == 0 (every model node) the gather gets the column
    gradients the GEMM wrote, no copy; other C get a zero-padded copy of
    rows of 32 channels. (The launch is recorded, not made.)"""
    spy = _Spy()
    monkeypatch.setattr(dcn, "_require_cuda", lambda t: None)
    monkeypatch.setattr(dcn, "_run", spy)
    monkeypatch.setattr(dcn, "_inverse_map",
                        lambda *a: tuple(torch.zeros(1) for _ in range(4)))
    b, h, w = 2, 3, 5
    offset = torch.zeros(b, 18, h, w)
    mask = torch.ones(b, 9, h, w)
    dcols = torch.randn(b, h * w, 9, c)
    copies = []
    monkeypatch.setattr(torch.Tensor, "new_zeros", lambda self, *a, **k:
                        copies.append(a) or torch.zeros(*a, dtype=self.dtype))
    dx = dcn._col2im("cfd_dcn_col2im", torch.float32, dcols, offset, mask,
                     None)
    assert dx.shape == (b, c, h, w)
    assert [name for name, _ in spy.calls] == ["cfd_dcn_col2im"]
    if c % 32 == 0:
        assert spy.calls[0][1] == dcols.data_ptr() and not copies
    else:
        assert spy.calls[0][1] != dcols.data_ptr()
        assert copies == [((b, h * w, 9, 32),)]


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_autograd_saves_the_forward_channels_last_copy(layout):
    """The Function (a bf16 x runs it on the CPU too) saves the
    channels-last x its forward read: x itself where x is channels-last,
    else the one copy; the gradients are those of the plain bf16
    backward."""
    x, offset, mask, weight, bias, grad = (torch.from_numpy(a)
                                           for a in _bf16_case(6))
    xb = _layout(x.bfloat16(), layout).requires_grad_(True)
    wb, bb = weight.bfloat16(), bias.bfloat16()
    out = dcn.deform_conv2d(xb, offset, mask, wb, bb)
    saved = out.grad_fn.saved_tensors[0]
    assert saved.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(saved, xb.detach())
    assert (saved.data_ptr() == xb.data_ptr()) == (layout == "channels_last")
    out.backward(grad.bfloat16())
    want = dcn.deform_conv2d_bf16_backward_plain(xb.detach(), offset, mask,
                                                 wb, bb, grad.bfloat16())
    assert xb.grad.dtype == torch.bfloat16
    assert _rel(xb.grad, want[0]) <= BF16_RTOL


def test_wrappers_check_the_pixel_major_columns():
    x, offset, mask, *_ = (torch.from_numpy(a)
                           for a in _inputs("seeded", SHAPES[0]))
    b, c, h, w = x.shape
    assert dcn._check_columns(torch.zeros(b, h * w, 9, c), offset, mask,
                              None) == (b, c, h, w)
    for bad in (torch.zeros(b, 9 * c, h * w), torch.zeros(b, h * w, 8, c),
                torch.zeros(b, h * w + 1, 9, c),
                torch.zeros(b, c, 9, h * w).transpose(1, 3)):
        with pytest.raises(ValueError):
            dcn._check_columns(bad, offset, mask, None)
    with pytest.raises(TypeError):
        dcn._check_columns(torch.zeros(b, h * w, 9, c, dtype=torch.float64),
                           offset, mask, None)
    assert dcn._vec(8, torch.zeros(4, 8)) == 1
    assert dcn._vec(6, torch.zeros(4, 6)) == 0
    assert dcn._vec(8, torch.zeros(4, 8, dtype=torch.bfloat16)) == 1
    assert dcn._vec(4, torch.zeros(4, 4, dtype=torch.bfloat16)) == 0
    assert dcn._vec(8, torch.zeros(33)[1:].view(4, 8)) == 0  # misaligned


# ------------------------------------------------------------------ the card

# the (C, H, W, O) of the 16 DCN nodes at the main path's 448x800
NODE_SHAPES = ((512, 14, 25, 256), (256, 28, 50, 256), (256, 28, 50, 128),
               (128, 56, 100, 128), (128, 56, 100, 64), (64, 112, 200, 64),
               (256, 28, 50, 64))
KERNELS = {
    "float32": (torch.float32, dcn.dcn_im2col, dcn.dcn_im2col_plain,
                dcn.dcn_col2im_coord, dcn.dcn_col2im_coord_plain, GRAD_RTOL),
    "bf16": (torch.bfloat16, dcn.dcn_im2col_bf16, dcn.dcn_im2col_bf16_plain,
             dcn.dcn_col2im_coord_bf16, dcn.dcn_col2im_coord_bf16_plain,
             BF16_RTOL)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _card_inputs(shape, dtype, b=2, seed=0, kind="seeded"):
    c, h, w, o = shape
    args = [torch.from_numpy(a).cuda()
            for a in _case(seed, b=b, c=c, h=h, w=w, o=o)]
    if kind != "seeded":
        args[1] = torch.from_numpy(_offsets(kind, b, h, w)).cuda()
    x, offset, mask, weight, bias, grad = args
    x, weight, grad = x.to(dtype), weight.to(dtype), grad.to(dtype)
    return x, offset, mask, weight, grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KERNELS))
@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("shape", NODE_SHAPES)
def test_kernels_match_plain_at_node_shapes_on_card(shape, max_offset, dtype):
    """im2col and coord against their plain versions at the node shapes
    (B=2), on a channels-last x; one launch each; coord bitwise equal over
    two runs; im2col equal on an NCHW x (its copy)."""
    _card()
    torch_dtype, im2col, im2col_plain, coord, coord_plain, rtol = \
        KERNELS[dtype]
    x, offset, mask, weight, grad = _card_inputs(shape, torch_dtype)
    xh = dcn.dcn_fwd_nhwc(x)
    dcols = dcn.column_gradients(weight, grad)
    counts = (im2col.launches, coord.launches)
    cols = im2col(xh, offset, mask, max_offset)
    got = coord(dcols, xh, offset, mask, max_offset)
    again = coord(dcols, xh, offset, mask, max_offset)
    torch.cuda.synchronize()
    assert (im2col.launches, coord.launches) == (counts[0] + 1,
                                                 counts[1] + 2)
    assert cols.dtype == torch_dtype and cols.is_contiguous()
    assert _rel(cols, im2col_plain(x, offset, mask, max_offset)) <= rtol
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, coord_plain(dcols, x, offset, mask, max_offset)):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= GRAD_RTOL
    assert torch.equal(im2col(x, offset, mask, max_offset), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KERNELS))
@pytest.mark.parametrize("kind", KINDS[1:])
def test_kernels_on_offset_kinds_and_odd_shapes_on_card(kind, dtype):
    """The convention cases and collapsed offsets, at C not a multiple of
    the vector (the element-wise path) and of 32 (col2im's padded copy),
    and B*H*W not a multiple of the tile."""
    _card()
    torch_dtype, im2col, im2col_plain, coord, coord_plain, rtol = \
        KERNELS[dtype]
    for shape in ((5, 9, 11, 7), (40, 9, 11, 3), (64, 9, 11, 5)):
        x, offset, mask, weight, grad = _card_inputs(shape, torch_dtype,
                                                     kind=kind)
        dcols = dcn.column_gradients(weight, grad)
        for max_offset in CLAMPS:
            assert _rel(im2col(x, offset, mask, max_offset),
                        im2col_plain(x, offset, mask, max_offset)) <= rtol
            for a, b in zip(coord(dcols, x, offset, mask, max_offset),
                            coord_plain(dcols, x, offset, mask, max_offset)):
                assert _rel(a, b) <= GRAD_RTOL, (shape, max_offset)
            got = dcn.deform_conv2d_backward(x, offset, mask, weight, grad,
                                             max_offset)
            assert got[0].shape == x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KERNELS))
def test_col2im_makes_no_copy_at_the_node_shapes_on_card(monkeypatch, dtype):
    """dcn_col2im hands the GEMM's column gradients to the gather as they
    lie at every node shape: the C entry gets dcols' own pointer."""
    _card()
    torch_dtype = KERNELS[dtype][0]
    col2im = dcn.dcn_col2im_bf16 if dtype == "bf16" else dcn.dcn_col2im
    run = dcn._run
    seen = []
    monkeypatch.setattr(dcn, "_run", lambda like, name, *a: (
        seen.append((name, a[0])), run(like, name, *a))[1])
    for shape in NODE_SHAPES:
        x, offset, mask, weight, grad = _card_inputs(shape, torch_dtype)
        dcols = dcn.column_gradients(weight, grad)
        seen.clear()
        col2im(dcols, offset, mask)
        gather = [p for name, p in seen if not name.endswith(("_count",
                                                              "_fill"))]
        assert gather == [dcols.data_ptr()], shape


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", sorted(KERNELS))
def test_autograd_makes_one_channels_last_copy_on_card(monkeypatch, dtype,
                                                       layout):
    """Forward and backward under autograd make one channels-last copy of an
    NCHW x and none of a channels-last one; the backward kernels read the
    saved copy."""
    _card()
    torch_dtype = KERNELS[dtype][0]
    x, offset, mask, weight, grad = _card_inputs((64, 9, 11, 5), torch_dtype)
    x = _layout(x, layout).requires_grad_(True)
    weight.requires_grad_(True)
    run = dcn._run
    names = []
    monkeypatch.setattr(dcn, "_run", lambda like, name, *a: (
        names.append(name), run(like, name, *a))[1])
    out = dcn.deform_conv2d(x, offset, mask, weight)
    out.backward(grad)
    torch.cuda.synchronize()
    copies = [n for n in names if n.endswith("_nhwc")]
    assert len(copies) == (1 if layout == "nchw" else 0)
    assert any("im2col" in n for n in names)
