"""The port's profiling helpers (``utils/observability.py``): the device
busy time of a set of kernel intervals, the per-group report that
``tools/profile_serving.py`` and ``tools/profile_training.py`` print, and
``trace_profile``'s Chrome trace. On the CPU there is no device time: the
report says so (None), and the tools print host operators instead."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from centerfusiondetect3d_tpu_torch.tools import profile_training
from centerfusiondetect3d_tpu_torch.utils.observability import (
    device_time_report,
    trace_profile,
    union_us,
)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 12)], 12.0),
    ([(20, 30), (0, 10), (2, 3)], 20.0), ([(0, 5), (5, 7)], 7.0)])
def test_union_us(intervals, want):
    assert union_us(intervals) == want


class _FakeProfile:
    """``torch.profiler``'s events() as the report reads them."""

    def __init__(self, kernels):
        cuda = torch.autograd.DeviceType.CUDA
        self._events = [SimpleNamespace(
            name=name, device_type=cuda,
            time_range=SimpleNamespace(start=s, end=e))
            for name, s, e in kernels]
        self._events.append(SimpleNamespace(
            name="aten::add", device_type=torch.autograd.DeviceType.CPU,
            time_range=SimpleNamespace(start=0, end=1e6)))

    def events(self):
        return self._events


def test_device_time_report_groups_the_training_kernels():
    """Busy time is the union of the kernels' intervals (two overlapping
    kernels count once); each kernel joins the first group whose key its
    lower-cased name holds: the bf16 DCN backward's gather and the kernels
    that build its map (the prefix sum too) and its columns in the backward
    group, the cuDNN wgrad in the convolution group."""
    prof = _FakeProfile([
        ("void (anonymous namespace)::dcn_col2im_gather_kernel<__nv_bfloat16>"
         "(...)", 0, 400),
        ("void (anonymous namespace)::dcn_col2im_map_kernel<true>(...)", 400,
         415),
        ("(anonymous namespace)::dcn_col2im_scan_kernel(...)", 415, 430),
        ("void (anonymous namespace)::dcn_im2col_kernel<__nv_bfloat16, 8>"
         "(...)", 430, 450),
        ("(anonymous namespace)::dcn_fwd_bf16_kernel(...)", 500, 700),
        ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32", 700, 1000),
        ("void at::native::vectorized_elementwise_kernel<8>", 900, 1100),
    ])
    lines = device_time_report(prof, 2, 4000.0, profile_training.GROUPS,
                               profile_training.REST, 3)
    # busy: 0-450 and 500-1100 us, 1050 us of 4000 over 2 runs
    assert lines[0].startswith("device busy 0.53 ms per run, idle share "
                               "0.738")
    report = "\n".join(lines)
    assert "DCN backward" in lines[1] and "0.23 ms per run" in lines[1]
    assert "convolution / GEMM" in report and "DCN forward" in report
    assert "other" in report
    assert sum(1 for line in lines if line.startswith("   ")) == 3


def test_trace_profile_writes_a_chrome_trace_and_no_device_time_on_cpu(
        tmp_path):
    with trace_profile(str(tmp_path), "cpu") as prof:
        torch.ones(8).add_(1)
    trace = tmp_path / "profile" / "trace.json"
    assert trace.is_file()
    assert "traceEvents" in json.loads(trace.read_text())
    assert any(e.key == "aten::add_" for e in prof.key_averages())
    assert device_time_report(prof, 1, 1.0, profile_training.GROUPS,
                              profile_training.REST, 3) is None
    with trace_profile(None, "cpu"):
        torch.ones(2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["profile"]
