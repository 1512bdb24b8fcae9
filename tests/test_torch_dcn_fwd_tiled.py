"""The DCNv2 forward kernels' decomposition: channels-last, tiles of B*H*W,
a fixed-order split of the 9*C rows.

``dcn_fwd`` and ``dcn_fwd_bf16`` (``csrc/dcn_fwd_common.cuh``) read x
channels-last with one 16-byte load per corner, cut pixel tiles from the
flattened B*H*W (tiles straddle images), cover all O <= 256 in one output
tile, and where the tiles are few split the chunks of input channels into
ranges whose float32 partials are summed in split order. Their plain model
(``dcn.deform_conv2d_tiled_plain`` with ``dcn.dcn_fwd_plan``) is held here
against the plain DCN in float64, against JAX's
``centerfusiondetect3d_tpu/ops/dcn.py:deform_conv2d`` in float32, and
against the plain bf16 DCN in bf16; the kernels are held against the plain
versions on the card (``-m cuda``), with bitwise-equal reruns and NCHW and
channels-last x giving the same output.

Shapes cover a B*H*W that is no multiple of the pixel tile with tiles that
straddle images, a C that is no multiple of the vector width or the chunk,
an O that is no multiple of the output tile, and a split that does not
divide the chunks; offsets the smoke's draw, zero, border, outside and
collapsed ones (``test_torch_col2im_gather._offsets``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from test_torch_col2im_gather import _offsets

torch.set_num_threads(1)

# float64: the same sums in another order (the mask folded into the corner
# weights, the splits)
F64_RTOL = 1e-12
# float32 against JAX: sums in another order, a few float32 ulps of O(1)
F32_RTOL = 1e-4
# the card's limits, those of chip_smoke.py (KERNEL_RTOL, BF16_RTOL)
KERNEL_RTOL = 1e-4
BF16_RTOL = 8e-3
CLAMPS = (None, 8.0, 1.0)
KINDS = ("seeded", "zero", "border", "outside", "collapsed")
# (b, c, h, w, o, target_blocks): B*H*W = 198 straddles images at 64- and
# 128-pixel tiles; C = 20 and 13 are no multiple of 8 or 16 (and 13 of 4),
# O = 70 of 64; the last (C = 140) splits its 1260 rows 3 ways: 432 + 432
# + 396 in float32 (9 groups of 16 channels), 576 + 576 + 108 in bf16 (5
# groups of 32); the last group of each holds 12 channels
SHAPES = ((2, 5, 9, 11, 7, None), (3, 20, 7, 13, 70, None),
          (2, 13, 5, 7, 3, None), (2, 140, 6, 9, 9, 3))
# the model's DCN node shapes (C, H, W, O) at 448x800
NODE_SHAPES = ((64, 112, 200, 64), (128, 56, 100, 64), (128, 56, 100, 128),
               (256, 28, 50, 128), (256, 28, 50, 256), (256, 28, 50, 64),
               (512, 14, 25, 256))


def _case(shape, kind, seed=0, dtype=np.float64):
    """x N(0, 1), offsets of ``kind``, a sigmoided mask with one tap of
    image 0 masked to 0, weight N(0, 1/9C), bias N(0, 0.01)."""
    b, c, h, w, o = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w)
    mask = 1 / (1 + np.exp(-rng.randn(b, 9, h, w)))
    mask[0, 4, : h // 2] = 0.0
    weight = rng.randn(o, c, 3, 3) / np.sqrt(9 * c)
    bias = 0.1 * rng.randn(o)
    offset = _offsets(kind, b, h, w)
    return tuple(torch.from_numpy(np.asarray(a, dtype))
                 for a in (x, offset, mask, weight, bias))


def _with_target(shape, monkeypatch):
    """The (b, c, h, w, o) of a SHAPES entry; its split target, where it
    names one, set in place of ``dcn._FWD_TARGET_BLOCKS``."""
    *dims, target = shape
    if target is not None:
        monkeypatch.setattr(dcn, "_FWD_TARGET_BLOCKS", target)
    return dims


def _rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_model_matches_plain_float64(shape, max_offset, kind,
                                           monkeypatch):
    args = _case(_with_target(shape, monkeypatch), kind)
    got = dcn.deform_conv2d_tiled_plain(*args, max_offset=max_offset)
    want = dcn.deform_conv2d_plain(*args, max_offset=max_offset)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) <= F64_RTOL


@pytest.mark.parametrize("max_offset", CLAMPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_model_matches_jax_float32(shape, max_offset, monkeypatch):
    """JAX's exact DCN (``ops/dcn.py:deform_conv2d``, NHWC) on offsets
    clipped to +-max_offset: the clamp of the TPU kernels K1 (8) and K2 (1)
    before sampling."""
    jax_dcn = pytest.importorskip("centerfusiondetect3d_tpu.ops.dcn")
    import jax.numpy as jnp

    x, offset, mask, weight, bias = (a.numpy() for a in _case(
        _with_target(shape, monkeypatch), "seeded", seed=1,
        dtype=np.float32))
    clipped = offset if max_offset is None else np.clip(
        offset, -max_offset, max_offset)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    want = np.transpose(np.asarray(jax_dcn.deform_conv2d(
        nhwc(x), nhwc(clipped), nhwc(mask),
        jnp.asarray(np.transpose(weight, (2, 3, 1, 0))), jnp.asarray(bias)),
        np.float32), (0, 3, 1, 2))
    got = dcn.deform_conv2d_tiled_plain(
        *(torch.from_numpy(a) for a in (x, offset, mask, weight, bias)),
        max_offset=max_offset)
    assert got.dtype == torch.float32
    assert _rel(got, torch.from_numpy(want)) <= F32_RTOL


def _bf16(args):
    x, offset, mask, weight, bias = args
    return (x.float().bfloat16(), offset.float(), mask.float(),
            weight.float().bfloat16(), bias.float().bfloat16())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_model_matches_plain_bf16_within_one_ulp(shape, kind,
                                                       monkeypatch):
    """bf16 taps rounded once, float32 sums in another order: within one
    bf16 ulp of the output's largest magnitude."""
    args = _bf16(_case(_with_target(shape, monkeypatch), kind, seed=2))
    for max_offset in CLAMPS:
        got = dcn.deform_conv2d_tiled_plain(*args, max_offset=max_offset)
        want = dcn.deform_conv2d_bf16_plain(*args, max_offset=max_offset)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        top = float(want.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
        assert float((got.float() - want.float()).abs().max()) <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [2, 6, 13])
@pytest.mark.parametrize("node", NODE_SHAPES)
def test_plan_covers_every_chunk_once_and_fills_the_card(node, batch, dtype):
    """Every group of channels lies in exactly one split, no split is
    empty, the output tile covers O <= 256 (one sampling per pixel), and a
    split only where pixel tiles x output tiles are fewer than the target;
    the split then gives at least half the target in blocks (rounding the
    groups per split up so that no split is empty) or one group a split."""
    c, h, w, o = node
    plan = dcn.dcn_fwd_plan(dtype, batch, c, h, w, o)
    assert plan.tile_o >= o
    assert plan.groups == -(-c // plan.group)
    assert (plan.splits - 1) * plan.groups_per_split < plan.groups \
        <= plan.splits * plan.groups_per_split
    # the kernels derive the groups per split from the splits alone
    assert plan.groups_per_split == -(-plan.groups // plan.splits)
    blocks = -(-(batch * h * w) // plan.tile_p)
    if blocks >= dcn._FWD_TARGET_BLOCKS:
        assert plan.splits == 1
    else:
        assert (2 * blocks * plan.splits >= dcn._FWD_TARGET_BLOCKS
                or plan.groups_per_split == 1)
    if dtype == torch.float32:
        # 8 x 8 a thread, the rows split between two halves of the block
        assert plan.tile_p * plan.tile_o == 8192
    else:
        assert plan.tile_p in (64, 128)
    # a corner's channels of a group: one 64- or 128-byte segment of x
    assert plan.group * (2 if dtype == torch.bfloat16 else 4) in (64, 128)


def test_plan_splits_the_deepest_node_at_serving_batch():
    """(6, 512, 14, 25, 256): 2100 pixels, 33 bf16 tiles of 64 and 66
    float32 tiles of 32; the bf16 kernel splits its 8 groups of 64 channels
    8 ways, the float32 one its 16 groups of 32 channels 4 ways."""
    assert tuple(dcn.dcn_fwd_plan(torch.bfloat16, 6, 512, 14, 25, 256)) == (
        64, 256, 64, 8, 1, 8)
    assert tuple(dcn.dcn_fwd_plan(torch.float32, 6, 512, 14, 25, 256)) == (
        32, 256, 32, 16, 4, 4)


def test_wrappers_take_channels_last_x_on_cpu():
    """An NCHW and a channels-last x give the same output; the
    channels-last view is x itself, with no copy."""
    args = _bf16(_case((2, 16, 6, 7, 5), "seeded", seed=3))
    x_cl = args[0].contiguous(memory_format=torch.channels_last)
    assert dcn.dcn_fwd_nhwc(x_cl) is x_cl
    assert dcn.dcn_fwd_nhwc(args[0]).is_contiguous(
        memory_format=torch.channels_last)
    before = dcn.dcn_fwd_bf16.launches
    for max_offset in CLAMPS:
        want = dcn.dcn_fwd_bf16(*args, max_offset=max_offset)
        got = dcn.dcn_fwd_bf16(x_cl, *args[1:], max_offset=max_offset)
        assert torch.equal(got, want)
    assert dcn.dcn_fwd_bf16.launches == before


def test_forward_refuses_an_x_neither_contiguous_nor_channels_last():
    x, offset, mask, weight, bias = (a.float() for a in _case(
        (2, 4, 6, 7, 3), "seeded"))
    with pytest.raises(ValueError, match="channels-last"):
        dcn._launch(x.transpose(2, 3).contiguous().transpose(2, 3),
                    offset, mask, weight, bias, None)
    with pytest.raises(ValueError, match="contiguous"):
        dcn._launch(x, offset.transpose(2, 3).contiguous().transpose(2, 3),
                    mask, weight, bias, None)


# -------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(shape, kind, seed, device):
    return tuple(t.float().to(device) for t in _case(shape, kind, seed))


def _kernel_vs_plain(args, bf16, max_offset):
    if bf16:
        args = _bf16(args)
        got = dcn.dcn_fwd_bf16(*args, max_offset=max_offset)
        want = dcn.deform_conv2d_bf16_plain(*args, max_offset=max_offset)
        limit = BF16_RTOL
    else:
        got = dcn.deform_conv2d(*args, max_offset=max_offset)
        want = dcn.deform_conv2d_plain(*args, max_offset=max_offset)
        limit = KERNEL_RTOL
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got.float(), want.float()) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch", [6, 13])
@pytest.mark.parametrize("node", NODE_SHAPES)
def test_kernels_match_plain_at_node_shapes_on_card(node, batch, bf16):
    """At serving's batch and at the training microbatch, whose pixel tiles
    and splits differ (``dcn_fwd_plan``)."""
    device = _card()
    c, h, w, o = node
    args = _card_case((batch, c, h, w, o), "seeded", 4, device)
    for max_offset in CLAMPS:
        _kernel_vs_plain(args, bf16, max_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_odd_shapes_on_card(shape, kind, bf16,
                                                   monkeypatch):
    """Ragged and straddling tiles, masked channel tails, O = 70, and the
    test's split target (the last shape: 4 + 4 + 2 float32 chunks)."""
    device = _card()
    args = _card_case(_with_target(shape, monkeypatch), kind, 5, device)
    for max_offset in CLAMPS:
        _kernel_vs_plain(args, bf16, max_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES + ((6, 512, 14, 25, 256, None),
                                            (13, 256, 28, 50, 128, None)))
def test_kernels_match_the_tiled_model_on_card(shape, bf16, monkeypatch):
    """The kernels against their plain model (``deform_conv2d_tiled_plain``
    on the card), which cuts as ``dcn_fwd_plan`` does: the odd shapes, the
    deepest node split at serving's batch and a node at the training
    microbatch."""
    device = _card()
    args = _card_case(_with_target(shape, monkeypatch), "seeded", 7, device)
    if bf16:
        args = _bf16(args)
    fwd = dcn.dcn_fwd_bf16 if bf16 else dcn._launch
    for max_offset in CLAMPS:
        got = fwd(*args, max_offset=max_offset)
        want = dcn.deform_conv2d_tiled_plain(*args, max_offset=max_offset)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got.float(), want.float()) <= (BF16_RTOL if bf16
                                                   else KERNEL_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES + ((6, 64, 112, 200, 64, None),
                                            (13, 128, 56, 100, 128, None),
                                            (6, 512, 14, 25, 256, None)))
def test_overlap_variant_gives_the_kernels_output_bitwise_on_card(
        shape, bf16, monkeypatch):
    """``dcn.FWD_OVERLAP`` (the in-block overlap variant; the bf16
    256-channel tile has none) sums the same values in the same order."""
    device = _card()
    args = _card_case(_with_target(shape, monkeypatch), "seeded", 9, device)
    if bf16:
        args = _bf16(args)
    fwd = dcn.dcn_fwd_bf16 if bf16 else dcn._launch
    for max_offset in (None, 1.0):
        want = fwd(*args, max_offset=max_offset)
        monkeypatch.setattr(dcn, "FWD_OVERLAP", True)
        got = fwd(*args, max_offset=max_offset)
        monkeypatch.setattr(dcn, "FWD_OVERLAP", False)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_refuse_a_plan_that_is_not_their_engines_on_card(
        bf16, monkeypatch):
    """The C entry holds the plan's tiles against its engine's: a plan that
    cuts otherwise raises, it is not run."""
    device = _card()
    args = _card_case((2, 16, 6, 9, 8), "seeded", 8, device)
    if bf16:
        args = _bf16(args)
    plan = dcn.dcn_fwd_plan
    for field in ("tile_p", "tile_o", "group"):
        monkeypatch.setattr(
            dcn, "dcn_fwd_plan", lambda *a, field=field: plan(*a)._replace(
                **{field: 2 * getattr(plan(*a), field)}))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            (dcn.dcn_fwd_bf16 if bf16 else dcn._launch)(*args,
                                                         max_offset=None)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("node", [(256, 28, 50, 128), (512, 14, 25, 256),
                                  (64, 112, 200, 64)])
def test_kernels_are_bitwise_reproducible_and_take_channels_last_on_card(
        node, bf16):
    """Two runs give bitwise-equal outputs (the split nodes included), and
    an NCHW and a channels-last x the same output."""
    device = _card()
    c, h, w, o = node
    args = _card_case((6, c, h, w, o), "seeded", 6, device)
    if bf16:
        args = _bf16(args)
    fwd = dcn.dcn_fwd_bf16 if bf16 else dcn._launch
    first = fwd(*args, max_offset=None)
    again = fwd(*args, max_offset=None)
    x_cl = args[0].contiguous(memory_format=torch.channels_last)
    last = fwd(x_cl, *args[1:], max_offset=None)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, last)


@pytest.mark.cuda
def test_nhwc_copy_kernel_matches_permute_on_card():
    device = _card()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 37, 9, 41, device=device).to(dtype)
        got = dcn.dcn_fwd_nhwc(x)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, x)
