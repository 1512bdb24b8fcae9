"""The benchmark's core: one run of one cell, driven by data.

A cell (``BENCHMARK.json`` ``workloads``) names a file
``cfbench/workloads/<cell>.json``: its configuration (``cfbench/configs/
<config>.json``), its traffic loop (``cfbench/traffic/<loop>.py``), the
loop's parameters and the limits of its correctness check. A per-layer
metric is ``cfbench/metrics/<metric>.py``. Nothing here names a cell, a
configuration or a metric: a later cell or metric is a new file.

A traffic loop module has three functions:

- ``setup(run)``: builds the program on the card, its weights and inputs
  from ``run.seed``, and warms up every shape the cell uses;
- ``window(run, state)``: opens the window (``run.open_window()``),
  drives the program for ``run.seconds`` and returns its end-to-end
  metrics, ``attempted`` and ``failed``;
- ``check(run, state)``: after the window, the comparison with the plain
  reference under ``cfbench/reference/``: a list of ``Check``.

The run prints, as its last line, the JSON result that the benchmark's
contract fixes, each compared number beside its limit last in it and on the
last lines of standard error.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import platform
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules that may not be loaded in a run, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "centerfusiondetect3d_tpu")
CACHE_DIR = ROOT / ".cfbench_cache"  # fixed: the second run finds the first's
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Check:
    """One compared number: correct while ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


# ------------------------------------------------------------ finding files
def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``cfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = _path(kind, name, ".py")
    mod_name = f"cfbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_workload(name: str) -> dict:
    wl = load_json("workloads", name)
    wl["name"] = name
    wl["config_file"] = load_json("configs", wl["config"])
    return wl


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(spec: dict, cell: str, reported_e2e) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer entries of ``spec`` that ``cell``
    reports: an entry with ``workloads`` where it lists the cell; one
    without, where the cell reports the end-to-end metric it moves (an
    end-to-end entry without it: in every cell)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e} & set(reported_e2e) | {"setup_s"}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> List[str]:
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


# -------------------------------------------------------------- the record
def host_info() -> dict:
    """CPU model (``/proc/cpuinfo``, else ``lscpu``), cores and load."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=20, check=False).stdout
            model = next((line.split(":", 1)[1].strip()
                          for line in out.splitlines()
                          if line.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    model = model or platform.processor() or platform.machine()
    try:
        load = os.getloadavg()
    except OSError:
        load = None
    return {"cpu": model, "nproc": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "loadavg": load}


def card_info() -> dict:
    """The card as nvidia-smi reads it (name, power limit, clocks)."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False).stdout
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": None}
    return {"nvidia_smi": [line.strip() for line in out.splitlines()
                           if line.strip()], "fields": fields}


# -------------------------------------------------------------------- spans
class Spans:
    """Host-clock spans kept in memory: name -> list of seconds. Under a
    trace each span is also a ``record_function`` range of the profile."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.profiling:
            import torch

            rf = torch.profiler.record_function("bench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def clear(self):
        self.times.clear()


class Trace:
    """``torch.profiler`` over part of the window (``start``/``stop``),
    reduced to the device's busy time, kernel time by name and the idle
    gaps named by what the host was doing (``cfbench/trace.py``)."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled = enabled
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.spans.profiling = True
        self.t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def stop(self, sync: Callable[[], None]):
        if not self.active:
            return
        sync()
        self.t1 = time.perf_counter()
        self.spans.profiling = False
        self.prof.stop()

    def reduce(self):
        from .trace import reduce_profile

        if self.prof is not None and self.summary is None:
            self.summary = reduce_profile(self.prof, self.t1 - self.t0)
            self.prof = None
        return self.summary


class Run:
    """What a traffic loop and a metric reader see of one run."""

    def __init__(self, workload: dict, seed: int, seconds: float, trace: bool,
                 device, start: float):
        self.workload = workload
        self.name = workload["name"]
        self.config = workload["config_file"]
        self.params = workload.get("params", {})
        self.limits = workload.get("limits", {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.start = start
        self.spans = Spans()
        self.trace = Trace(trace, self.spans)
        self.setup_parts: Dict[str, float] = {}
        self.window_open: Optional[float] = None
        self.counters: Dict[str, float] = {}  # the traced window's counts
        self.info: Dict[str, object] = {}  # recorded on earlier lines

    @contextlib.contextmanager
    def setup_part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.setup_parts[name] = (self.setup_parts.get(name, 0.0)
                                      + time.perf_counter() - t0)

    def open_window(self) -> float:
        self.window_open = time.perf_counter()
        return self.window_open


def _seed_of(seed: int) -> int:
    """A seed of any size folded into the 63 bits a torch generator takes."""
    return int(seed) % (2 ** 63 - 1)


def run_cell(workload: dict, seed: int, seconds: float, trace: bool,
             device=None, start: Optional[float] = None) -> dict:
    """One run of ``workload`` (a loaded workload dict): set-up, window,
    check. Returns the result dict (the contract's keys, ``checks`` last);
    ``device`` None is the first CUDA card."""
    import torch

    start = time.perf_counter() if start is None else start
    device = torch.device("cuda" if device is None else device)
    run = Run(workload, _seed_of(seed), seconds, trace, device, start)
    loop = run.loop = load_module("traffic", workload["loop"])
    on_card = device.type == "cuda"
    found = {"allow_tf32.matmul": torch.backends.cuda.matmul.allow_tf32,
             "allow_tf32.cudnn": torch.backends.cudnn.allow_tf32,
             "cudnn.benchmark": torch.backends.cudnn.benchmark}

    state = loop.setup(run)
    if on_card:
        torch.cuda.synchronize(device)
    out = loop.window(run, state)
    if on_card:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    setup_s = run.window_open - start
    found_after = {"allow_tf32.matmul": torch.backends.cuda.matmul.allow_tf32,
                   "allow_tf32.cudnn": torch.backends.cudnn.allow_tf32,
                   "cudnn.benchmark": torch.backends.cudnn.benchmark}
    summary = run.trace.reduce()

    # the per-layer readings, before the check frees the program
    layer_values: Dict[str, float] = {}
    spec = workload.get("spec") or benchmark_spec()
    chosen = metrics_of(spec, run.name, out["metrics"])
    units = {m["name"]: m["unit"] for m in
             chosen["end_to_end"] + chosen["per_layer"]}
    if trace:
        for m in chosen["per_layer"]:
            value = load_module("metrics", m["name"]).read(run, summary)
            if value is not None:
                layer_values[m["name"]] = float(value)

    t_check = time.perf_counter()
    checks: List[Check] = loop.check(run, state)
    check_s = time.perf_counter() - t_check
    correct = bool(checks) and all(c.ok for c in checks)

    if trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in layer_values.items()}
    else:
        metrics = {m["name"]: {"value": float(out["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in chosen["end_to_end"]
                   if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else platform.processor() or "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    run.info.update({"setup_parts_s": run.setup_parts, "setup_s": setup_s,
                     "check_s": check_s, "tf32_found": found,
                     "tf32_after_window": found_after,
                     "counts": out.get("counts", {})})
    result["info"] = run.info  # the record; main_run prints it apart
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def _fail(msg: str) -> int:
    print(f"cfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main_run(name: str, seed: int, seconds: float, trace: bool,
             start: float) -> int:
    """The command: refuses without the cards the cell asks for, keeps
    every build cache inside the checkout, prints the record lines, the
    result, and each check beside its limit on standard error."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        wl = load_workload(name)
        spec = benchmark_spec()
    except (OSError, ValueError) as e:
        return _fail(str(e))
    if name not in {w["name"] for w in spec["workloads"]}:
        return _fail(f"{name!r} is not a cell of BENCHMARK.json")
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == name)
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        return _fail(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} present")
    wl["spec"] = spec
    print("info host " + json.dumps(host_info()), flush=True)
    print("info card " + json.dumps(card_info()), flush=True)
    result = run_cell(wl, seed, seconds, trace, start=start)
    bad = forbidden_modules()
    if bad:
        return _fail("modules that may not be loaded in a run: "
                     + ", ".join(bad))
    info = dict(result.pop("info", {}))
    print("info run " + json.dumps(info, default=str), flush=True)
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0
