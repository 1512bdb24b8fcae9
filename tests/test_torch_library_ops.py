"""The DCN forward kernels as ``torch.library`` operators (``ops/dcn.py``).

``cfd3d::dcn_fwd`` and ``cfd3d::dcn_fwd_bf16`` pass ``torch.library.opcheck``
on the CPU (schema, fake tensor, autograd registration, AOT dispatch), where
each is bitwise its plain version (float32 and float64 for ``dcn_fwd``);
``deform_conv2d`` without autograd, and ``DeformConv2dFunction``'s forward,
reach them, so a traced graph holds one operator node per DCN node. The
``cuda`` cases hold the operators bitwise against direct calls of the
kernels' wrappers at every DCN node shape of the Middle config at 448x800
(B=6), counted once a call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from centerfusiondetect3d_tpu_torch.ops import dcn

# (C, H, W, O) of the 16 DCN nodes at 448x800 (the neck's distinct shapes)
NODE_SHAPES = ((64, 112, 200, 64), (128, 56, 100, 64), (128, 56, 100, 128),
               (256, 28, 50, 128), (256, 28, 50, 256), (256, 28, 50, 64),
               (512, 14, 25, 256))


def _case(b=2, c=5, h=6, w=7, o=4, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g, dtype=torch.float64)
    offset = 1.5 * torch.randn(b, 18, h, w, generator=g, dtype=torch.float64)
    mask = torch.rand(b, 9, h, w, generator=g, dtype=torch.float64)
    weight = torch.randn(o, c, 3, 3, generator=g,
                         dtype=torch.float64) / np.sqrt(9 * c)
    bias = 0.1 * torch.randn(o, generator=g, dtype=torch.float64)
    if dtype == torch.bfloat16:
        return (x.bfloat16(), offset.float(), mask.float(), weight.bfloat16(),
                bias.bfloat16())
    return tuple(t.to(dtype) for t in (x, offset, mask, weight, bias))


class _Ops(TorchDispatchMode):
    """Records the operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("max_offset", [None, 1.0, 8.0])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dcn_fwd_opcheck_and_bitwise_plain(dtype, bias, max_offset):
    x, offset, mask, weight, b = _case(dtype=dtype)
    args = (x, offset, mask, weight, b if bias else None, max_offset)
    torch.library.opcheck(torch.ops.cfd3d.dcn_fwd.default, args)
    got = torch.ops.cfd3d.dcn_fwd(*args)
    assert got.dtype == dtype and got.shape == (2, 4, 6, 7)
    assert torch.equal(got, dcn.deform_conv2d_plain(*args))


@pytest.mark.parametrize("max_offset", [None, 1.0])
@pytest.mark.parametrize("bias", [True, False])
def test_dcn_fwd_bf16_opcheck_and_bitwise_plain(bias, max_offset):
    x, offset, mask, weight, b = _case(dtype=torch.bfloat16, seed=1)
    args = (x, offset, mask, weight, b if bias else None, max_offset)
    torch.library.opcheck(torch.ops.cfd3d.dcn_fwd_bf16.default, args)
    got = torch.ops.cfd3d.dcn_fwd_bf16(*args)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, dcn.deform_conv2d_bf16_plain(*args))


def test_fake_tensors_give_the_output_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x, offset, mask, weight, bias = (
            torch.empty(3, 8, 5, 9), torch.empty(3, 18, 5, 9),
            torch.empty(3, 9, 5, 9), torch.empty(6, 8, 3, 3), torch.empty(6))
        out = torch.ops.cfd3d.dcn_fwd(x, offset, mask, weight, bias, None)
        out16 = torch.ops.cfd3d.dcn_fwd_bf16(
            x.bfloat16(), offset, mask, weight.bfloat16(), None, 1.0)
    assert out.shape == out16.shape == (3, 6, 5, 9)
    assert out.dtype == torch.float32 and out16.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_deform_conv2d_without_autograd_goes_through_the_operator(dtype):
    args = _case(dtype=dtype, seed=2)
    before = (dcn.deform_conv2d.launches, dcn.dcn_fwd_bf16.launches)
    with _Ops() as ops, torch.no_grad():
        got = dcn.deform_conv2d(*args)
    name = "cfd3d.dcn_fwd_bf16" if dtype == torch.bfloat16 else "cfd3d.dcn_fwd"
    assert [n for n in ops.names if n.startswith("cfd3d")] == [
        name + ".default"]
    plain = (dcn.deform_conv2d_bf16_plain if dtype == torch.bfloat16
             else dcn.deform_conv2d_plain)
    assert torch.equal(got, plain(*args))
    # the CPU runs the plain version: nothing is launched or counted
    assert (dcn.deform_conv2d.launches, dcn.dcn_fwd_bf16.launches) == before


def test_bf16_autograd_forward_goes_through_the_operator():
    x, offset, mask, weight, bias = _case(dtype=torch.bfloat16, seed=3)
    x.requires_grad_(True)
    with _Ops() as ops:
        out = dcn.deform_conv2d(x, offset, mask, weight, bias)
    assert type(out.grad_fn).__name__ == "DeformConv2dFunctionBackward"
    assert "cfd3d.dcn_fwd_bf16.default" in ops.names
    out.float().sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.bfloat16


def test_float32_autograd_on_the_cpu_differentiates_the_plain_version():
    x, offset, mask, weight, bias = _case(dtype=torch.float32, seed=4)
    weight.requires_grad_(True)
    with _Ops() as ops:
        out = dcn.deform_conv2d(x, offset, mask, weight, bias)
    assert not [n for n in ops.names if n.startswith("cfd3d")]
    out.sum().backward()
    assert weight.grad is not None


def test_a_traced_graph_holds_one_operator_per_dcn_node():
    from centerfusiondetect3d_tpu_torch.config import load_config
    from centerfusiondetect3d_tpu_torch.models import build_model
    from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode

    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                            "MODEL.DLA.NODE", "DeformConv",
                            "DATASET.RADAR_PC", "False",
                            "MODEL.FRUSTUM", "False",
                            "MODEL.FUSION_STRATEGY", "''",
                            "MIXED_PRECISION", "False"], num_classes=10)
    model = build_model(cfg).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    nodes = sum(isinstance(m, DeformConvNode) for m in model.modules())
    with torch.no_grad():
        program = torch.export.export(model, (torch.zeros(1, 3, 64, 128),))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert nodes == 16
    assert targets.count("cfd3d.dcn_fwd.default") == nodes
    assert not [t for t in targets if "dcn_fwd_bf16" in t]


def test_the_kernel_implementation_refuses_float64_before_the_card():
    args = _case(seed=5)
    with pytest.raises(TypeError, match="float32"):
        dcn._launch(*args, None)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_operators_are_the_kernels_at_every_node_shape_on_card(bf16):
    """Each operator on the card is bitwise a direct call of its kernel's
    wrapper, and counts one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    op = torch.ops.cfd3d.dcn_fwd_bf16 if bf16 else torch.ops.cfd3d.dcn_fwd
    direct = dcn.dcn_fwd_bf16 if bf16 else dcn._launch
    counter = dcn.dcn_fwd_bf16 if bf16 else dcn.deform_conv2d
    for i, (c, h, w, o) in enumerate(NODE_SHAPES):
        args = [t.cuda() for t in _case(6, c, h, w, o, seed=10 + i,
                                        dtype=torch.bfloat16 if bf16
                                        else torch.float32)]
        for max_offset in (None, 1.0):
            before = counter.launches
            with torch.no_grad():
                got = op(*args, max_offset)
                want = direct(*args, max_offset)
            torch.cuda.synchronize()
            assert counter.launches == before + 2
            assert torch.equal(got, want), (c, h, w, o, max_offset)
