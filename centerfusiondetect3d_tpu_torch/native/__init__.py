"""Host kernels of the data loader in C++ (``rasterize.cpp``, ``warp.cpp``),
with ctypes.

The port of ``centerfusiondetect3d_tpu/native/__init__.py``. ``load()``
builds both sources into one library with ``g++ -O3 -shared -fPIC
-ffp-contract=off`` at its first call, never at import, into ``_build/``
beside the package (git-ignored), named after a hash of the sources and
the command, as ``ops/cuda_build.py`` names the CUDA libraries; g++ writes
to a temporary name that is then moved into place. Unlike the JAX package,
which falls back to numpy when g++ is missing, a failed build raises: no
path takes the numpy loops without asking for them. ctypes lets go of the
interpreter lock for each call, so the Loader's threads run them side by
side.

``paint_rects``, ``paint_rects_channels``, ``splat_gaussians`` and
``warp_bilinear`` each count their calls (``.calls``, under a lock: the
Loader's threads call them). The plain versions of the first three,
``*_plain``, are the same loops in numpy and Python; ``warp_bilinear``'s
is ``data/transforms.py:warp_image``. The tests hold the kernels to them
bitwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rasterize.cpp"
WARP_SOURCE = Path(__file__).resolve().parent / "warp.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# no contraction: warp.cpp rounds each product and sum as numpy does
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_LOCK = threading.Lock()  # the build and the call counts
_LIB = None

_SIGNATURES = {
    "paint_rects": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int],
    "paint_rects_channels": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    "splat_gaussians": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    "warp_bilinear_u8": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int],
}


def load() -> ctypes.CDLL:
    """The built library (built once per source hash); raises
    RuntimeError when g++ is missing or fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
        return _LIB


def _build_and_load() -> ctypes.CDLL:
    cmd = (CXX,) + CXX_FLAGS
    sources = (SOURCE, WARP_SOURCE)
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in sources)
                            + " ".join(cmd).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"{SOURCE.stem}_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([*cmd, "-o", str(tmp),
                                   *(str(src) for src in sources)],
                                  capture_output=True, text=True,
                                  check=False)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build {SOURCE.name}: "
                               f"{e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed to build {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _count(fn) -> None:
    with _LOCK:
        fn.calls += 1


def _check_map(a: np.ndarray, ndim: int, name: str) -> None:
    if (a.dtype != np.float32 or a.ndim != ndim
            or not a.flags.c_contiguous or not a.flags.writeable):
        raise ValueError(f"{name}: a writable C-contiguous float32 array of "
                         f"{ndim} dimensions, not {a.dtype} {a.shape}")


def _rows(a, dtype, n: int, cols: int, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.shape != (n, cols):
        raise ValueError(f"{name}: shape {a.shape}, expected {(n, cols)}")
    return a


def paint_rects(depth_map: np.ndarray, boxes, values) -> None:
    """Paints ``values[i]`` into ``boxes[i]`` of ``depth_map`` (H, W, C)
    float32 in place, in order (later boxes overwrite earlier ones).
    ``boxes`` (N, 4) [y1, y2, x1, x2), clipped to the map; ``values``
    (N, C)."""
    _check_map(depth_map, 3, "paint_rects")
    h, w, c = depth_map.shape
    n = len(boxes)
    boxes = _rows(boxes, np.int32, n, 4, "paint_rects boxes")
    values = _rows(values, np.float32, n, c, "paint_rects values")
    load().paint_rects(_ptr(depth_map), h, w, c, _ptr(boxes), _ptr(values),
                       n)
    _count(paint_rects)


def paint_rects_channels(depth_map: np.ndarray, boxes, values,
                         channels) -> None:
    """``paint_rects`` that writes value ``k`` of box ``i`` into channel
    ``channels[i, k]`` only (the one-hot radar layout)."""
    _check_map(depth_map, 3, "paint_rects_channels")
    h, w, c = depth_map.shape
    n = len(boxes)
    boxes = _rows(boxes, np.int32, n, 4, "paint_rects_channels boxes")
    values = np.ascontiguousarray(values, np.float32)
    k = values.shape[1] if values.ndim == 2 else -1
    values = _rows(values, np.float32, n, k, "paint_rects_channels values")
    channels = _rows(channels, np.int32, n, k,
                     "paint_rects_channels channels")
    if n and (channels.min() < 0 or channels.max() >= c):
        raise ValueError(f"paint_rects_channels: channels outside [0, {c})")
    load().paint_rects_channels(_ptr(depth_map), h, w, c, _ptr(boxes),
                                _ptr(values), _ptr(channels), k, n)
    _count(paint_rects_channels)


def splat_gaussians(heatmap: np.ndarray, centers, radii) -> None:
    """Max-splats a gaussian peak of value 1 at each ``centers[i]`` (x, y)
    with radii ``radii[i]`` (rx, ry) onto ``heatmap`` (H, W) float32."""
    _check_map(heatmap, 2, "splat_gaussians")
    h, w = heatmap.shape
    n = len(centers)
    centers = _rows(centers, np.float32, n, 2, "splat_gaussians centers")
    radii = _rows(radii, np.int32, n, 2, "splat_gaussians radii")
    load().splat_gaussians(_ptr(heatmap), h, w, _ptr(centers), _ptr(radii),
                           n)
    _count(splat_gaussians)


def warp_bilinear(src: np.ndarray, inverse, out: np.ndarray) -> None:
    """Warps ``src`` (H, W, C) uint8 into ``out`` (OH, OW, C) uint8, both
    C-contiguous: each destination pixel (x, y) reads ``src`` bilinearly at
    ``inverse`` (2x3, float32) applied to (x, y, 1), a zero border, in
    ``data/transforms.py:warp_image``'s arithmetic (``warp.cpp``)."""
    if (src.dtype != np.uint8 or src.ndim != 3
            or not src.flags.c_contiguous):
        raise ValueError(f"warp_bilinear: a C-contiguous (H, W, C) uint8 "
                         f"source, not {src.dtype} {src.shape}")
    if (out.dtype != np.uint8 or out.ndim != 3 or out.shape[2] != src.shape[2]
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"warp_bilinear: a writable C-contiguous (OH, OW, "
                         f"{src.shape[2]}) uint8 output, not {out.dtype} "
                         f"{out.shape}")
    inverse = np.ascontiguousarray(inverse, np.float32).reshape(-1)
    if inverse.shape != (6,):
        raise ValueError(f"warp_bilinear: a 2x3 inverse, not {inverse.shape}")
    h, w, c = src.shape
    load().warp_bilinear_u8(_ptr(src), h, w, c, _ptr(inverse), _ptr(out),
                            out.shape[0], out.shape[1])
    _count(warp_bilinear)


for _fn in (paint_rects, paint_rects_channels, splat_gaussians,
            warp_bilinear):
    _fn.calls = 0


# ---------------------------------------------------------- plain versions
def _clip(box, h: int, w: int):
    y1, y2, x1, x2 = (int(v) for v in box)
    return max(y1, 0), min(y2, h), max(x1, 0), min(x2, w)


def paint_rects_plain(depth_map: np.ndarray, boxes, values) -> None:
    """``paint_rects`` in numpy."""
    h, w, _ = depth_map.shape
    for box, v in zip(np.asarray(boxes), np.asarray(values, np.float32)):
        y1, y2, x1, x2 = _clip(box, h, w)
        if y2 > y1 and x2 > x1:
            depth_map[y1:y2, x1:x2] = v


def paint_rects_channels_plain(depth_map: np.ndarray, boxes, values,
                               channels) -> None:
    """``paint_rects_channels`` in numpy."""
    h, w, _ = depth_map.shape
    for box, v, ch in zip(np.asarray(boxes), np.asarray(values, np.float32),
                          np.asarray(channels)):
        y1, y2, x1, x2 = _clip(box, h, w)
        if y2 > y1 and x2 > x1:
            for value, channel in zip(v, ch):
                depth_map[y1:y2, x1:x2, int(channel)] = value


def splat_gaussians_plain(heatmap: np.ndarray, centers, radii) -> None:
    """``splat_gaussians`` in Python, in the kernel's double arithmetic
    (``math.exp`` is the C library's ``exp``)."""
    h, w = heatmap.shape
    for (fx, fy), (rx, ry) in zip(np.asarray(centers, np.float32),
                                  np.asarray(radii, np.int32)):
        cx, cy, rx, ry = int(fx), int(fy), int(rx), int(ry)
        sx, sy = (2 * rx + 1) / 6.0, (2 * ry + 1) / 6.0
        left, right = min(cx, rx), min(w - cx, rx + 1)
        top, bottom = min(cy, ry), min(h - cy, ry + 1)
        if left + right <= 0 or top + bottom <= 0:
            continue
        for dy in range(-top, bottom):
            for dx in range(-left, right):
                g = math.exp(-(dx * dx) / (2 * sx * sx)
                             - (dy * dy) / (2 * sy * sy))
                if g > heatmap[cy + dy, cx + dx]:
                    heatmap[cy + dy, cx + dx] = np.float32(g)
