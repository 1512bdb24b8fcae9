"""What the per-layer metrics under ``cfbench/metrics/`` read: the traced
window's counts (``run.counters``, set by the traffic loop), its device trace
(``cfbench/trace.py``) and the work counted from shapes
(``cfbench/counting.py``, through the traffic loop's ``work``)."""

from __future__ import annotations

from typing import Optional

from . import counting
from .trace import device_seconds, op_seconds

# substrings of the names of cuDNN's and cuBLAS's convolution and GEMM
# kernels and their layout copies, matched lower-cased (the groups of
# tools/profile_serving.py)
CONV_KEYS = ("convolve", "conv2d", "cudnn", "gemm", "xmma", "cutlass",
             "winograd", "implicit", "fprop", "nchwtonhwc", "nhwctonchw")
DCN_FWD_KEYS = ("dcn_fwd",)  # the NHWC copy, the kernel, the split's sum
# the autograd node of a DCN node's backward (ops/dcn.py:
# DeformConv2dFunction): every kernel it launches, whatever their names
DCN_BWD_OP = "DeformConv2dFunctionBackward"


def units(run, kind: str) -> Optional[float]:
    """Batches (serving) or steps (training) in the traced window, where
    this run is of ``kind`` and was traced; else None."""
    c = run.counters
    if c.get("kind") != kind or not c.get("units"):
        return None
    return float(c["units"])


def work(run):
    if "work" not in run.counters:
        run.counters["work"] = run.loop.work(run)
    return run.counters["work"]


def device_ms(run, summary, kind: str, keys) -> Optional[float]:
    n = units(run, kind)
    if n is None or summary is None:
        return None
    secs, launches = device_seconds(summary, keys)
    return 1e3 * secs / n if launches else None


def roofline(run, summary, kind: str, keys, least_per_unit,
             op: Optional[str] = None) -> Optional[float]:
    """Least time of the window's work over the device time of the
    kernels whose names hold ``keys`` (or, with ``op``, of every kernel
    that the host op ``op`` launched), in %; None without such a kernel."""
    n = units(run, kind)
    if n is None or summary is None:
        return None
    secs, launches = (op_seconds(summary, op) if op
                      else device_seconds(summary, keys))
    if not launches or secs <= 0 or least_per_unit <= 0:
        return None
    return 100.0 * least_per_unit * n / secs


def dcn_fwd_least(run) -> float:
    return sum(counting.dcn_fwd_bf16(s)[2] for s in work(run)["dcn"])


def dcn_bwd_least(run) -> float:
    return sum(counting.dcn_bwd_bf16(s)[2] for s in work(run)["dcn_bwd"])


def idle_share(run, summary, kind: str) -> Optional[float]:
    if units(run, kind) is None or summary is None:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def mfu(run, summary, kind: str) -> Optional[float]:
    n = units(run, kind)
    if n is None or summary is None:
        return None
    return 100.0 * work(run)["flops"] * n / (summary["window_s"]
                                            * counting.PEAK_BF16)
