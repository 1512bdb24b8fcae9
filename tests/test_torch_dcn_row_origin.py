"""The DCN kernels' row origin (``ops/dcn.py``, ``csrc/``) on the card.

A height-split rank's DeformConv node reads the whole x (H rows) and
writes its own output rows: offset and mask of Ho rows, the output rows
[row0, row0 + Ho) of the op. Here, without JAX (the card's machine has
none): the wrappers refuse rows outside x before any build or launch, and
their C entries take Ho and row0 (CPU); on the card (``-m cuda``) each of
the eight kernels with a row origin against its plain version with the
same row origin, at a vector and an odd channel count, on wild offsets
and, for col2im, on offsets that collapse onto one pixel (segments of up
to 9*Ho*W entries), and the whole op's rows against the row-origin call.
``tests/test_torch_spatial.py`` holds the plain versions against the rows
of the whole op and JAX's; ``chip_smoke.py`` phase 22a does the same as
here at the 16 nodes' shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn

F32_RTOL = 1e-4  # the kernels against plain: sums in another order
BF16_RTOL = 8e-3  # a bf16 rounding of the output or of a tap


def _case(seed, b=2, c=24, h=13, w=11, o=16, collapse=False):
    rng = np.random.RandomState(seed)
    offset = 1.5 * rng.randn(b, 18, h, w)
    far = rng.rand(*offset.shape) < 0.05
    offset = np.where(far, np.sign(offset) * (6 + 4 * rng.rand(
        *offset.shape)), offset)
    if collapse:  # every tap of every pixel onto (h // 2, w // 2)
        ys = np.arange(h)[:, None]
        xs = np.arange(w)[None, :]
        for k in range(9):
            i, j = divmod(k, 3)
            offset[:, 2 * k] = h // 2 - (ys + i - 1)
            offset[:, 2 * k + 1] = w // 2 - (xs + j - 1)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(b, c, h, w), offset,
        1.0 / (1.0 + np.exp(-rng.randn(b, 9, h, w))),
        rng.randn(o, c, 3, 3) / np.sqrt(9 * c), 0.1 * rng.randn(o))]


def _rows(t, row0, ho):
    return t[:, :, row0:row0 + ho].contiguous()


def test_rows_outside_x_are_refused_before_a_launch():
    x, off, mask, w, b = _case(0)
    for row0, ho in ((10, 4), (-1, 4), (0, 14)):
        with pytest.raises(ValueError, match="rows"):
            dcn._check_rows(13, ho, row0)
    with pytest.raises(ValueError, match="rows"):
        dcn._check_sampling(x, _rows(off, 0, 4), _rows(mask, 0, 4), None,
                            row0=10)
    # the C entries take the output rows and the origin after W
    for name in ("cfd_dcn_fwd", "cfd_dcn_fwd_bf16"):
        assert dcn._SIGNATURES[name][2] == 13
    for name in ("cfd_dcn_im2col", "cfd_dcn_col2im_coord",
                 "cfd_dcn_im2col_bf16", "cfd_dcn_col2im_coord_bf16"):
        assert dcn._SIGNATURES[name][2] == 7
    assert dcn._SIGNATURES["cfd_dcn_col2im"][2] == 6
    assert dcn._SIGNATURES["cfd_dcn_col2im_count"][2] == 5
    assert dcn._SIGNATURES["cfd_dcn_col2im_fill"][2] == 6


def test_the_plain_row_origin_call_has_the_rows_shapes():
    x, off, mask, w, b = _case(1)
    row0, ho = 5, 6
    op, mp = _rows(off, row0, ho), _rows(mask, row0, ho)
    assert dcn.deform_conv2d(x, op, mp, w, b, row0=row0).shape == (
        2, 16, ho, 11)
    cols = dcn.dcn_im2col(x, op, mp, row0=row0)
    assert cols.shape == (2, ho * 11, 9, 24)
    assert dcn.dcn_col2im(cols, op, mp, row0=row0, height=13).shape == (
        2, 24, 13, 11)
    doff, dmask = dcn.dcn_col2im_coord(cols, x, op, mp, row0=row0)
    assert doff.shape == op.shape and dmask.shape == mp.shape


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


CARD_CASES = [  # (c, o, collapse, row0, ho) on 13 rows
    (24, 16, False, 5, 6), (24, 16, False, 7, 6), (24, 16, True, 4, 5),
    (5, 7, False, 1, 11), (64, 64, False, 0, 7), (24, 16, False, 12, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("c,o,collapse,row0,ho", CARD_CASES)
def test_kernels_with_a_row_origin_match_plain(c, o, collapse, row0, ho,
                                               bf16):
    _card()
    dt = torch.bfloat16 if bf16 else torch.float32
    x, off, mask, w, b = (t.cuda() for t in _case(2, c=c, o=o,
                                                   collapse=collapse))
    x, w, b = x.to(dt), w.to(dt), b.to(dt)
    op, mp = _rows(off, row0, ho), _rows(mask, row0, ho)
    dcols = torch.randn(2, ho * 11, 9, c, device="cuda").to(dt)
    plain_fwd = dcn.deform_conv2d_plain(x, op, mp, w, b, row0=row0)
    with torch.no_grad():
        fwd = (dcn.dcn_fwd_bf16(x, op, mp, w, b, row0=row0) if bf16
               else dcn.deform_conv2d(x, op, mp, w, b, row0=row0))
    sfx = "_bf16" if bf16 else ""
    pairs = [
        (fwd, plain_fwd, BF16_RTOL if bf16 else F32_RTOL),
        (getattr(dcn, f"dcn_im2col{sfx}")(x, op, mp, row0=row0),
         getattr(dcn, f"dcn_im2col{sfx}_plain")(x, op, mp, row0=row0),
         BF16_RTOL if bf16 else F32_RTOL),
        (getattr(dcn, f"dcn_col2im{sfx}")(dcols, op, mp, row0=row0,
                                          height=13),
         getattr(dcn, f"dcn_col2im{sfx}_plain")(dcols, x, op, mp,
                                                row0=row0),
         BF16_RTOL if bf16 else F32_RTOL)]
    coord = getattr(dcn, f"dcn_col2im_coord{sfx}")(dcols, x, op, mp,
                                                   row0=row0)
    coord_plain = getattr(dcn, f"dcn_col2im_coord{sfx}_plain")(
        dcols, x, op, mp, row0=row0)
    pairs += [(g, v, F32_RTOL) for g, v in zip(coord, coord_plain)]
    torch.cuda.synchronize()
    for i, (got, want, rtol) in enumerate(pairs):
        assert got.shape == want.shape and got.dtype == want.dtype, i
        assert _rel(got, want) <= rtol, (i, _rel(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_row_origin_calls_give_the_whole_ops_rows(bf16):
    """Two calls on the upper and lower rows together give the whole
    forward, and their col2im dx sum to the whole col2im's: each rank's
    share of a height-split node."""
    _card()
    dt = torch.bfloat16 if bf16 else torch.float32
    x, off, mask, w, b = (t.cuda() for t in _case(3))
    x, w, b = x.to(dt), w.to(dt), b.to(dt)
    fwd = dcn.dcn_fwd_bf16 if bf16 else dcn.deform_conv2d
    col2im = dcn.dcn_col2im_bf16 if bf16 else dcn.dcn_col2im
    dcols = torch.randn(2, 13 * 11, 9, 24, device="cuda").to(dt)
    with torch.no_grad():
        whole = fwd(x, off, mask, w, b)
        parts = [fwd(x, _rows(off, r0, ho), _rows(mask, r0, ho), w, b,
                     row0=r0) for r0, ho in ((0, 7), (7, 6))]
        dx_whole = col2im(dcols, off, mask)
        dx_parts = sum(col2im(dcols[:, r0 * 11:(r0 + ho) * 11].contiguous(),
                              _rows(off, r0, ho), _rows(mask, r0, ho),
                              row0=r0, height=13).float()
                       for r0, ho in ((0, 7), (7, 6)))
    torch.cuda.synchronize()
    rtol = BF16_RTOL if bf16 else F32_RTOL
    assert _rel(torch.cat(parts, dim=2), whole) <= rtol
    assert _rel(dx_parts, dx_whole) <= 2 * rtol
