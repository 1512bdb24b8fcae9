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
