"""Build a kernel source under ``csrc/`` with nvcc and load it with ctypes.

Each source has a plain ``extern "C"`` entry point and includes no PyTorch
header, so one ``nvcc`` call builds it in seconds. The shared library goes to
``_build/`` beside the package (git-ignored), named after a hash of the
source and the flags, so a changed source builds anew and an unchanged one is
loaded as it is. nvcc writes to a temporary name that is then moved into
place, so a process never loads a half-written library.

Nothing here runs at import time: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was loaded
    ptxas: List[str]  # nvcc -Xptxas -v lines on registers and spills


_LOADED: Dict[str, KernelLibrary] = {}
_LOCK = threading.Lock()  # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}  # one per source


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; the "
        "CUDA kernels of centerfusiondetect3d_tpu_torch need the CUDA toolkit")


def load_kernel_library(source: str) -> KernelLibrary:
    """Build (once per source hash) and load ``csrc/<source>``."""
    with _LOCK:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source not in _LOADED:
            _LOADED[source] = _build_and_load(CSRC_DIR / source)
        return _LOADED[source]


def load_kernel_libraries(sources) -> Dict[str, KernelLibrary]:
    """Build and load several sources at once: one nvcc each, together."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(load_kernel_library, sources)))


def _build_and_load(src: Path) -> KernelLibrary:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"{src.stem}_{digest}.so"
    log_path = so_path.with_suffix(".log")
    seconds = 0.0
    if not so_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        log_tmp = log_path.with_name(f".{log_path.name}.{os.getpid()}.tmp")
        log_tmp.write_text(proc.stdout + proc.stderr)
        os.replace(log_tmp, log_path)
        os.replace(tmp, so_path)
    ptxas = []
    if log_path.exists():
        ptxas = [line.strip() for line in log_path.read_text().splitlines()
                 if "registers" in line or "spill" in line]
    return KernelLibrary(ctypes.CDLL(str(so_path)), so_path, seconds, ptxas)
