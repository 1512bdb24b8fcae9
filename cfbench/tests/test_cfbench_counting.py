"""The operation and byte counts of the rooflines and MFU against hand
counts."""

import pytest
import torch

from cfbench_tiny import harness  # noqa: F401  (puts the checkout on the path)
from cfbench import counting
from cfbench.reference.model import DeformConvNode, QConv2d, Quant


def test_dcn_forward_bf16_hand_count():
    b, c, h, w, o = 2, 64, 8, 10, 32
    flops, nbytes, least = counting.dcn_fwd_bf16((b, c, h, w, o))
    assert flops == 2 * b * h * w * 9 * c * o
    # x, weight, bias, output in bf16; offsets (18) and mask (9) in float32
    assert nbytes == (2 * (b * c * h * w + o * c * 9 + o + b * o * h * w)
                      + 4 * 27 * b * h * w)
    assert least == max(flops / 989e12, nbytes / 3.35e12)


def test_dcn_backward_bf16_hand_count():
    b, c, h, w, o = 2, 64, 8, 10, 32
    flops, nbytes, least = counting.dcn_bwd_bf16((b, c, h, w, o))
    # the weight gradient and the column gradients: each as much as the
    # forward's contraction
    assert flops == 2 * (2 * b * h * w * 9 * c * o)
    # read: x, the output gradient, the weight (bf16), offsets and mask
    # (float32); written: dx, dweight, dbias (bf16), their gradients
    # (float32); no columns
    read = 2 * (b * c * h * w + b * o * h * w + o * c * 9) + 4 * 27 * b * h * w
    written = 2 * (b * c * h * w + o * c * 9 + o) + 4 * 27 * b * h * w
    assert nbytes == read + written
    assert least == max(flops / 989e12, nbytes / 3.35e12)


class OneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = QConv2d(3, 8, 3, padding=1, stride=2, quant=Quant())

    def forward(self, x):
        return self.conv(x)


class OneNode(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.node = DeformConvNode(16, 24, Quant())

    def forward(self, x):
        return self.node(x)


def test_one_convolution():
    got = counting.count_model(OneConv().to("meta"),
                               torch.zeros(2, 3, 16, 20, device="meta"))
    # output 2 x 8 x 8 x 10, each 3 * 3 * 3 multiply-adds
    assert got["flops"] == 2 * (2 * 8 * 8 * 10) * (3 * 9)
    assert got["dcn"] == []


def test_one_dcn_node():
    got = counting.count_model(OneNode().to("meta"),
                               torch.zeros(2, 16, 6, 7, device="meta"))
    offset_conv = 2 * (2 * 27 * 6 * 7) * (16 * 9)
    contraction = 2 * 2 * 6 * 7 * 9 * 16 * 24
    assert got["flops"] == offset_conv + contraction
    assert got["dcn"] == [(2, 16, 6, 7, 24)]


def test_training_rule():
    layers = [("base.a", 10.0), ("base.b", 20.0),
              ("detectHead_0.heatmap.0", 4.0), ("detectHead_0.heatmap.2", 1.0)]
    # unfrozen: the first layer takes no input gradient
    assert counting.train_flops(layers) == 10 * 2 + 20 * 3 + 4 * 3 + 1 * 3
    # frozen backbone: forward only there; a head's first layer takes no
    # input gradient
    assert counting.train_flops(layers, ("base.",)) == 10 + 20 + 4 * 2 + 3


class _Event:
    def __init__(self, name, parent=None, kernels=()):
        self.name, self.cpu_parent = name, parent
        self.kernels = [type("K", (), {"duration": d})() for d in kernels]


def test_op_device_time_counts_the_kernels_of_nested_ops_once():
    from cfbench.trace import op_device_seconds

    ev = _Event("autograd::engine::evaluate_function: NodeBackward")
    node = _Event("NodeBackward", ev)
    mm = _Event("aten::mm", node, kernels=[30.0])
    inner = _Event("NodeBackward", node, kernels=[5.0])  # same name inside
    own = _Event("custom_op", node, kernels=[10.0, 20.0])
    other = _Event("aten::mm", None, kernels=[7.0])
    got = op_device_seconds([ev, node, mm, inner, own, other])
    assert got["NodeBackward"] == pytest.approx((65e-6, 1))
    assert got["aten::mm"] == pytest.approx((37e-6, 2))
    assert got["custom_op"] == pytest.approx((30e-6, 1))
    assert got[ev.name] == pytest.approx((65e-6, 1))
