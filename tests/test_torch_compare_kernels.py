"""``tools/compare_kernels.py`` on the CPU: the checks it makes before it
needs a card, and each kernel's call on the wrappers' plain versions."""

import os

import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.tools import compare_kernels as ck
from centerfusiondetect3d_tpu_torch.tools import probe_dcn


@pytest.mark.parametrize("other", ["/", "..", "."])
def test_refuses_a_directory_outside_the_checkout_or_the_checkout(other):
    with pytest.raises(SystemExit, match="inside"):
        ck.main(["--other", os.path.join(ck.ROOT, other),
                 "--kernel", "dcn_col2im"])


def test_refuses_a_directory_without_the_package():
    inside = os.path.join(ck.ROOT, "tests")
    with pytest.raises(SystemExit, match="inside"):
        ck.main(["--other", inside, "--kernel", "dcn_col2im"])


def test_refuses_an_unknown_kernel():
    with pytest.raises(SystemExit):
        ck.main(["--other", ck.ROOT, "--kernel", "round_to_bf16"])


@pytest.mark.parametrize("batch", ["0", "-3", "six"])
def test_refuses_a_batch_that_is_not_a_positive_count(batch):
    with pytest.raises(SystemExit):
        ck.main(["--other", os.path.join(ck.ROOT, "_compare", "parent"),
                 "--kernel", "dcn_fwd", "--batch", batch])


@pytest.mark.parametrize("kernels", [["dcn_col2im"],
                                     ["dcn_fwd", "dcn_im2col_bf16"]])
def test_overlap_takes_only_the_forward_kernels(kernels):
    with pytest.raises(SystemExit, match="only the forward"):
        ck.main(["--overlap"] + [a for k in kernels for a in ("--kernel", k)])


@pytest.mark.parametrize("argv", [
    ["--overlap", "--other", ck.ROOT, "--kernel", "dcn_fwd"],
    ["--kernel", "dcn_fwd"]])
def test_overlap_stands_in_place_of_another_tree(argv):
    """One of ``--other`` and ``--overlap``, not both, not neither."""
    with pytest.raises(SystemExit):
        ck.main(argv)


def test_overlap_call_sets_the_variant_for_its_call_alone():
    seen = []
    ck.overlap_call(lambda: seen.append(dcn.FWD_OVERLAP))()
    assert seen == [True] and dcn.FWD_OVERLAP is False

    def fails():
        raise ValueError("inside the call")

    with pytest.raises(ValueError):
        ck.overlap_call(fails)()
    assert dcn.FWD_OVERLAP is False


def test_batch_replaces_the_microbatch_of_every_node_shape():
    """``--batch 6`` runs the training node shapes at serving's batch;
    without it they stay at the microbatch."""
    shapes = [(13, 64, 112, 200, 64), (13, 512, 14, 25, 256),
              (13, 64, 112, 200, 64)]
    assert ck.at_batch(shapes) == shapes
    assert ck.at_batch(shapes, 6) == [(6, 64, 112, 200, 64),
                                      (6, 512, 14, 25, 256),
                                      (6, 64, 112, 200, 64)]


@pytest.mark.parametrize("name", ck.KERNELS)
def test_kernel_call_runs_each_kernel_in_its_dtype(name):
    """On CPU tensors each wrapper runs its plain version: the call gives the
    kernel's output shapes in the dtype the name says (doffset and dmask
    float32; the whole backward its five gradients in the inputs' dtypes),
    and its layout-free form dweight for im2col's columns."""
    b, c, h, w, o = 2, 8, 5, 6, 4
    dtype = ck.dtype_of(name)
    inputs = ck.node_inputs((b, c, h, w, o), dtype, "cpu", 0)
    assert inputs[0].dtype == dtype
    call, layout_free = ck.kernel_call(name, dcn, inputs)
    with torch.no_grad():
        out = call()
    if name in ck.BACKWARD:
        assert [tuple(t.shape) for t in out] == [
            (b, c, h, w), (b, 18, h, w), (b, 9, h, w), (o, c, 3, 3), (o,)]
        assert [t.dtype for t in out] == [dtype, torch.float32,
                                          torch.float32, dtype, dtype]
        return
    if "coord" in name:
        assert [tuple(t.shape) for t in out] == [(b, 18, h, w), (b, 9, h, w)]
        assert all(t.dtype == torch.float32 for t in out)
        return
    want = {"fwd": (b, o, h, w), "im2col": (b, h * w, 9, c),
            "col2im": (b, c, h, w)}
    kind = next(k for k in want if k in name)
    assert tuple(out.shape) == want[kind]
    assert out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    if kind == "im2col":
        assert tuple(layout_free(out).shape) == (o, c, 3, 3)
    else:
        assert layout_free(out) is out


class _NchwColumnsTree:
    """A stand-in for a tree whose backward kernels read an NCHW x and lay
    their columns out (B, 9C, H*W), row c*9 + k, lying (9C, B, H*W) (the
    layout before the columns went pixel-major), built on this tree's
    plain versions."""

    def __init__(self):
        self.seen_x = []

    def dcn_im2col(self, x, offset, mask):
        self.seen_x.append(x)
        cols = dcn.dcn_im2col_plain(x, offset, mask)  # (B, HW, 9, C)
        b, hw, _, c = cols.shape
        return cols.permute(3, 2, 0, 1).reshape(9 * c, b, hw).transpose(0, 1)

    def weight_gradient(self, grad_out, cols):
        b, o, h, w = grad_out.shape
        g = grad_out.transpose(0, 1).reshape(o, b * h * w)
        return g @ cols.transpose(0, 1).reshape(-1, b * h * w).t()

    def column_gradients(self, weight, grad_out):
        b, o, h, w = grad_out.shape
        g = grad_out.transpose(0, 1).reshape(o, b * h * w)
        return (weight.reshape(o, -1).t() @ g).view(-1, b, h * w).transpose(
            0, 1)

    def _pixel_major(self, dcols, c):
        b, _, hw = dcols.shape
        return dcols.reshape(b, c, 9, hw).permute(0, 3, 2, 1).contiguous()

    def dcn_col2im(self, dcols, offset, mask):
        c = dcols.shape[1] // 9
        return dcn.dcn_col2im(self._pixel_major(dcols, c), offset, mask)

    def dcn_col2im_coord(self, dcols, x, offset, mask):
        self.seen_x.append(x)
        return dcn.dcn_col2im_coord(self._pixel_major(dcols, x.shape[1]), x,
                                    offset, mask)


@pytest.mark.parametrize("name", ["dcn_im2col", "dcn_col2im",
                                  "dcn_col2im_coord"])
def test_trees_of_other_layouts_compare_in_a_layout_free_form(name):
    """Each tree gets x and the column gradients in its own layout, made
    from the same values: a tree without ``BACKWARD_X_CHANNELS_LAST`` an
    NCHW x and its own (9C, B, H*W) column gradients; the two outputs agree
    in their layout-free forms (im2col: through each tree's
    ``weight_gradient``)."""
    inputs = ck.node_inputs((2, 8, 5, 6, 4), torch.float32, "cpu", 3)
    old = _NchwColumnsTree()
    call_this, free_this = ck.kernel_call(name, dcn, inputs)
    call_old, free_old = ck.kernel_call(name, old, inputs)
    with torch.no_grad():
        got, want = free_this(call_this()), free_old(call_old())
    assert ck.rel_err(got, want) <= 1e-6
    assert all(x.is_contiguous() for x in old.seen_x)
    assert dcn.BACKWARD_X_CHANNELS_LAST
    if name == "dcn_im2col":
        assert tuple(got.shape) == (4, 8, 3, 3)


def test_overlap_refuses_the_probe_kernels():
    with pytest.raises(SystemExit, match="only the forward"):
        ck.main(["--overlap", "--kernel", "probe_p1"])


@pytest.mark.parametrize("name", ck.PROBE_KERNELS)
def test_probe_calls_give_both_trees_the_tool_inputs(name):
    """Each probe input of ``tools/probe_dcn.py`` (P5's windows their own,
    a tile probe's three inputs at both geometries) goes to both trees'
    wrappers and to this tree's yardstick where there is one (``k2``,
    ``p1``, ``p2``, ``p4``; none for the other tile probes); on CPU
    tensors the wrappers run their plain versions, so a tree compared with itself gives equal outputs, and the
    yardstick agrees within its order's rounding (``p4``'s, a bf16
    ``baddbmm`` with a float32 result, has no CPU kernel: its card test
    holds it)."""
    from centerfusiondetect3d_tpu_torch.ops import probes

    calls = ck.probe_calls(name, probes, "cpu")
    short = name[6:]
    if short in ("p1", "p2", "p3", "p4"):
        labels = [label for label, _, _ in probe_dcn.p5_cases(
            short, ck.SEED, "cpu")]
    else:
        labels = [probe_dcn.tile_label(case, geom)
                  for geom in probes.GEOMETRIES for case in probe_dcn.CASES]
    assert [label for label, *_ in calls] == labels
    for label, this, other, library in calls:
        got = this()
        assert torch.equal(got, other()), label
        assert (library is None) == (short not in ("k2", "p1", "p2",
                                                   "p4")), label
        if library is not None and short != "p4":
            assert ck.rel_err(library(), got) <= 1e-6, label


@pytest.mark.parametrize("name", [
    "probe_k2", "probe_k5", "probe_k4", "probe_kd", "probe_ke", "probe_kb",
    "probe_ka", "probe_k3", "probe_kc", "probe_k1"])
def test_the_redesigned_probes_are_kernels_of_the_tool(name):
    """The parser takes them (the refusal is the directory's, not the
    kernel's), and their calls run the plain versions on the CPU."""
    from centerfusiondetect3d_tpu_torch.ops import probes

    assert name in ck.PROBE_KERNELS
    with pytest.raises(SystemExit, match="inside"):
        ck.main(["--other", ck.ROOT, "--kernel", name])
    probe = probes.PROBES[name[6:]]
    cases = [(g, c) for g in probes.GEOMETRIES for c in probe_dcn.CASES]
    for (label, this, _, _), (geom, case) in zip(
            ck.probe_calls(name, probes, "cpu"), cases, strict=True):
        inp = probe_dcn.tile_inputs(probe.script, geom, case, ck.SEED, "cpu")
        want = probe.plain(*[inp[k] for k in probe.kernel.inputs], geom)
        assert torch.equal(this(), want), label


def test_a_probe_is_held_to_its_rtol():
    """0 is bitwise; a nonzero rtol is relative to the largest magnitude;
    the message names the tolerance."""
    want = torch.tensor([1.0, -2.0, 4.0])
    assert ck.hold_probe(want.clone(), want, 0.0, "k2", "case") == 0.0
    near = want + torch.tensor([0.0, 0.0, 4e-3])
    with pytest.raises(SystemExit, match="rtol 0 "):
        ck.hold_probe(near, want, 0.0, "k2", "case")
    assert ck.hold_probe(near, want, 8e-3, "k5", "case") == pytest.approx(
        1e-3, rel=1e-3)
    with pytest.raises(SystemExit, match="rtol 0.0001"):
        ck.hold_probe(near, want, 1e-4, "k5", "case")


def test_warp_affine_is_a_kernel_of_the_tool():
    """``warp_affine``'s inputs are serving's two geometries, and its call
    on the CPU runs the plain warp: numpy ``warp_image`` of each frame."""
    import numpy as np

    from centerfusiondetect3d_tpu_torch.data.transforms import warp_image
    from centerfusiondetect3d_tpu_torch.geometry.affine import (
        get_affine_transform)
    from centerfusiondetect3d_tpu_torch.ops import warp

    assert "warp_affine" in ck.WARP_KERNELS
    cases = ck.warp_inputs("cpu", n=2)
    assert [len(f) for _, f, _ in cases] == [2, 2]
    assert [tuple(f[0].shape[:2]) for _, f, _ in cases] == list(
        ck.WARP_SOURCES)
    for label, frames, inv in cases:
        out = ck.warp_call(warp, frames, inv)()
        assert tuple(out.shape) == (2, *ck.WARP_OUT, 3)
        h, w = frames[0].shape[:2]
        trans = get_affine_transform(np.array([w / 2, h / 2], np.float32),
                                     max(h, w), 0, ck.WARP_OUT[::-1])
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(
                out[i].numpy(), warp_image(f.numpy(), trans,
                                           ck.WARP_OUT[::-1]), err_msg=label)


def test_warp_affine_refuses_a_tree_without_the_warp(tmp_path):
    with pytest.raises(SystemExit, match="ops/warp.py"):
        ck.load_other_warp(str(tmp_path))
