"""``tools/compare_kernels.py`` on the CPU: the checks it makes before it
needs a card, and each kernel's call on the wrappers' plain versions."""

import os

import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.tools import compare_kernels as ck


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
    float32)."""
    b, c, h, w, o = 2, 8, 5, 6, 4
    inputs = ck.node_inputs((b, c, h, w, o), ck.dtype_of(name), "cpu", 0)
    assert inputs[0].dtype == ck.dtype_of(name)
    with torch.no_grad():
        out = ck.kernel_call(name, dcn, inputs)()
    if "coord" in name:
        assert [tuple(t.shape) for t in out] == [(b, 18, h, w), (b, 9, h, w)]
        assert all(t.dtype == torch.float32 for t in out)
        return
    want = {"fwd": (b, o, h, w), "im2col": (b, 9 * c, h * w),
            "col2im": (b, c, h, w)}
    kind = next(k for k in want if k in name)
    assert tuple(out.shape) == want[kind]
    assert out.dtype == ck.dtype_of(name)
    assert torch.isfinite(out.float()).all()
