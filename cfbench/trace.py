"""Reduction of a ``torch.profiler`` trace of part of a window: the device
kernels' intervals, their union (the device's busy time), kernel time by
name, and the longest idle gaps of the device named by what the host was
doing then (the benchmark's own span, ``bench.*``, and the innermost host
op in progress at the gap's middle), and the device time of each host op
(an operator or an autograd node), all the kernels it launched, itself or
through the ops inside it."""

from __future__ import annotations

from typing import Dict, List, Tuple

TOP = 10


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_label(cpu, t: float) -> str:
    """The benchmark span and the innermost host op in progress at ``t``
    (``cpu``: (start, end, name) sorted by start)."""
    span, inner, inner_len = None, None, float("inf")
    for s, e, name in cpu:
        if s > t:
            break
        if e < t:
            continue
        if name.startswith("bench."):
            if span is None or e - s < span[1]:
                span = (name, e - s)
        elif e - s < inner_len:
            inner, inner_len = name, e - s
    return f"{span[0] if span else '-'} | {inner or 'no host op'}"


def op_device_seconds(host_events) -> Dict[str, Tuple[float, int]]:
    """name -> (device seconds, calls) of host ops: each call's kernels
    (``kernels``, durations in us), its own and those of the ops nested
    in it (``cpu_parent``); a call nested in a call of the same name
    counts within that one only."""
    own: Dict[int, float] = {}
    for e in host_events:
        k = sum(getattr(x, "duration", 0.0) for x in
                (getattr(e, "kernels", None) or ()))
        if k:
            p = e
            while p is not None:  # the kernels count for every ancestor
                own[id(p)] = own.get(id(p), 0.0) + k
                p = getattr(p, "cpu_parent", None)
    out: Dict[str, List[float]] = {}
    for e in host_events:
        p = getattr(e, "cpu_parent", None)
        while p is not None and p.name != e.name:
            p = getattr(p, "cpu_parent", None)
        if p is not None:  # inside a call of its own name
            continue
        acc = out.setdefault(e.name, [0.0, 0])
        acc[0] += own.get(id(e), 0.0) * 1e-6
        acc[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def reduce_profile(prof, window_s: float) -> Dict:
    """``{"busy_s", "window_s", "kernels", "ops", "breakdown"}``:
    ``kernels`` is kernel name -> (device seconds, launches) and ``ops``
    host op name -> (device seconds, calls) over the traced window."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, cpu, host = [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # a record_function range shows on the device too: no kernel
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                kernels.append((s, t, e.name))
        else:
            cpu.append((s, t, e.name))
            host.append(e)
    by_name: Dict[str, List[float]] = {}
    for s, t, name in kernels:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (t - s) * 1e-6
        acc[1] += 1
    busy = union_us([(s, t) for s, t, _ in kernels]) * 1e-6
    spans = merged([(s, t) for s, t, _ in kernels])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:TOP]
    cpu.sort()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy, "window_s": window_s,
        "kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
        "ops": op_device_seconds(host),
        "breakdown": {
            "device_ops": [[k[:200], v[0]] for k, v in top],
            "idle_gaps": [[_host_label(cpu, (a + b) / 2)[:200], g * 1e-6]
                          for g, a, b in gaps]},
    }


def op_seconds(summary: Dict, name: str) -> Tuple[float, int]:
    """Device seconds and calls of the host op ``name`` (whole name)."""
    return summary.get("ops", {}).get(name, (0.0, 0))


def device_seconds(summary: Dict, keys) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose lower-cased name
    holds one of ``keys``."""
    secs, n = 0.0, 0
    for name, (s, k) in summary["kernels"].items():
        low = name.lower()
        if any(key in low for key in keys):
            secs += s
            n += k
    return secs, n
