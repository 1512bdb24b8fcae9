"""Image-file decoding: ``cv2.imread`` on the CPU, nvJPEG on a CUDA device.

The counterpart of ``cv2.imread`` in the JAX package's dataset
(``centerfusiondetect3d_tpu/data/dataset.py:73``). The decoder follows the
device the caller names and never falls back from one to the other:

- ``cpu``: ``cv2.imread``, as the JAX package reads, so that the port's
  items match the JAX package's bitwise; cv2 is imported only here;
- ``cuda``: ``csrc/jpeg_decode.cu``, built by ``ops/cuda_build.py``
  (linked with ``-lnvjpeg``) at the first decode, never at import. The
  file's bytes are read on the host; nvJPEG decodes them on the card into
  their Y, Cb and Cr planes (``decode_planes``), and ``ycc_to_bgr``'s
  kernel upsamples the chroma and converts to BGR as libjpeg, cv2's
  decoder, does (its plain version is ``ycc_to_bgr_plain``), so that only
  the inverse DCT's rounding differs from cv2; the result is copied back.
  A file the decoder cannot take raises, naming the file and the status.
  ``decode_jpeg.launches`` counts the decodes, ``ycc_to_bgr.launches`` the
  conversion kernel's launches.

Both return an HWC uint8 host array in BGR order (``read_image``,
``decode_jpeg``, for the dataset). Serving keeps the card's decode on the
card (``decode_jpeg_device``, ``load_frame``). ``load_frame`` is
``runtime/detector.py:load_data``'s reader: on the CPU it takes the JAX
package's ``TEST.FAST_DECODE`` half-resolution decode
(``cv2.IMREAD_REDUCED_COLOR_2``) where the reduced image still covers the
network input; nvJPEG has no DCT-scaled decode, so on the card it decodes
at full resolution (decode scale 1), a documented difference
(``ROADMAP.md``, Queue 3).

The inference CLI's video and webcam reader (``video_frames``), its JPEG
writer (``write_image``), its box and label drawing (``draw_box``) and its
``--show-attention`` overlay (``attention_overlay``) are opencv's as well;
they import it when called and name it when it is missing (``opencv``,
which ``data/synthetic.py`` calls too).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda_build import load_kernel_library

SOURCE = "jpeg_decode.cu"

# nvjpegStatus_t, and the source's own codes
STATUS = {
    1: "NVJPEG_STATUS_NOT_INITIALIZED",
    2: "NVJPEG_STATUS_INVALID_PARAMETER",
    3: "NVJPEG_STATUS_BAD_JPEG",
    4: "NVJPEG_STATUS_JPEG_NOT_SUPPORTED",
    5: "NVJPEG_STATUS_ALLOCATOR_FAILURE",
    6: "NVJPEG_STATUS_EXECUTION_FAILED",
    7: "NVJPEG_STATUS_ARCH_MISMATCH",
    8: "NVJPEG_STATUS_INTERNAL_ERROR",
    9: "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED",
    10: "NVJPEG_STATUS_INCOMPLETE_BITSTREAM",
    2000: "the image is not the size its header gave",
    2001: "components or chroma sampling other than grey, 4:4:4, 4:2:2 or "
          "4:2:0",
}
_COUNT = threading.Lock()  # serving decodes in the stream's worker threads
_THREAD = threading.local()  # read_image's CUDA stream of each thread
# libjpeg's fixed-point YCbCr -> RGB (jdcolor.c: FIX(x) at 16 bits)
ONE_HALF = 1 << 15
FIX_1_40200, FIX_1_77200, FIX_0_34414, FIX_0_71414 = 91881, 116130, 22554, 46802

_SIGNATURES = {
    "cfd_jpeg_info": [ctypes.c_void_p, ctypes.c_size_t]
    + [ctypes.POINTER(ctypes.c_int)] * 6,
    "cfd_jpeg_decode_planes": [ctypes.c_void_p, ctypes.c_size_t]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "cfd_ycc_to_bgr": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def status_name(code: int) -> str:
    if 1000 < code < 2000:
        return f"CUDA error {code - 1000}"
    return STATUS.get(code, f"status {code}")


def _entry(name: str):
    fn = getattr(load_kernel_library(SOURCE).lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
    return fn


def read_image(path: str, device) -> np.ndarray:
    """The image at ``path`` as HWC BGR uint8, decoded on ``device``. On a
    CUDA device each calling thread decodes on a stream of its own (the
    Loader's threads decode side by side, and apart from the training
    step's stream); the copy back to the host waits for that stream."""
    device = torch.device(device)
    if device.type == "cpu":
        return _read_cv2(path)
    if device.type == "cuda":
        streams = _THREAD.__dict__.setdefault("streams", {})
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(streams[device]):
            return decode_jpeg(np.fromfile(path, np.uint8), device, name=path)
    raise RuntimeError(f"read_image: no decoder for device {device}")


def _read_cv2(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_frame(path: str, device, input_hw: Tuple[int, int],
               fast: bool) -> Tuple[object, float]:
    """(frame, decode scale) for serving the image at ``path`` on
    ``device``. CPU: as the JAX package's ``Detector.load_data`` reads it,
    with ``fast`` (``TEST.FAST_DECODE``) a JPEG decoded at half resolution
    (``cv2.IMREAD_REDUCED_COLOR_2``, scale 2) where that still covers
    ``input_hw``, else in full (scale 1): an HWC BGR uint8 array. CUDA:
    nvJPEG at full resolution (scale 1: no reduced decode there), an HWC
    BGR uint8 tensor that stays on the card. ``FileNotFoundError`` for a
    missing or unreadable file."""
    device = torch.device(device)
    if device.type == "cuda":
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return decode_jpeg_device(np.fromfile(path, np.uint8), device,
                                  name=path), 1.0
    if device.type != "cpu":
        raise RuntimeError(f"load_frame: no decoder for device {device}")
    import cv2

    if fast and path.lower().endswith((".jpg", ".jpeg")):
        img = cv2.imread(path, cv2.IMREAD_REDUCED_COLOR_2)
        if img is not None and (img.shape[0] >= input_hw[0]
                                and img.shape[1] >= input_hw[1]):
            return img, 2.0
    return _read_cv2(path), 1.0


def decode_jpeg(data: np.ndarray, device, name: str = "<bytes>"
                ) -> np.ndarray:
    """Decodes the JPEG bytes ``data`` (uint8) on the CUDA ``device``:
    nvJPEG's planes, then ``ycc_to_bgr``; returns HWC BGR uint8 on the
    host. Raises, naming ``name`` and the status, on a file it cannot
    decode."""
    return decode_jpeg_device(data, device, name).cpu().numpy()


def decode_jpeg_device(data: np.ndarray, device, name: str = "<bytes>"
                       ) -> torch.Tensor:
    """``decode_jpeg`` whose result stays on the card: the (H, W, 3) BGR
    uint8 tensor ``ycc_to_bgr`` wrote, on the current stream. Counted in
    ``decode_jpeg.launches``."""
    out = ycc_to_bgr(*decode_planes(data, device, name=name))
    with _COUNT:
        decode_jpeg.launches += 1
    return out


decode_jpeg.launches = 0


def decode_planes(data: np.ndarray, device, name: str = "<bytes>"):
    """The planes of the JPEG bytes ``data`` as nvJPEG decodes them on the
    CUDA ``device``: Y (H, W) and Cb, Cr at their sampling (None for a grey
    image), uint8 tensors on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"decode_jpeg: nvJPEG decodes on a CUDA device, "
                           f"not {device}")
    data = np.ascontiguousarray(data, np.uint8)
    ptr = data.ctypes.data_as(ctypes.c_void_p)
    w, h, comps, sub, cw, ch = (ctypes.c_int() for _ in range(6))
    code = _entry("cfd_jpeg_info")(ptr, data.size, *map(ctypes.byref, (
        w, h, comps, sub, cw, ch)))
    if code == 0 and cw.value and _sampling(cw.value, ch.value, w.value,
                                            h.value) is None:
        code = 2001
    if code != 0:
        raise RuntimeError(f"nvJPEG cannot read {name}: {status_name(code)}")
    y = torch.empty((h.value, w.value), dtype=torch.uint8, device=device)
    cb = cr = None
    if cw.value:
        cb, cr = (torch.empty((ch.value, cw.value), dtype=torch.uint8,
                              device=device) for _ in range(2))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _entry("cfd_jpeg_decode_planes")(
            ptr, data.size, y.data_ptr(), _ptr(cb), _ptr(cr), w.value,
            h.value, cw.value, ch.value, stream)
    if code != 0:  # the entry waits for the stream before it returns
        raise RuntimeError(f"nvJPEG failed to decode {name}: "
                           f"{status_name(code)}")
    return y, cb, cr


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ycc_to_bgr(y: torch.Tensor, cb: Optional[torch.Tensor],
               cr: Optional[torch.Tensor]) -> torch.Tensor:
    """HWC BGR uint8 from a JPEG's planes, as libjpeg makes it: on a CUDA
    tensor ``csrc/jpeg_decode.cu:ycc_to_bgr_kernel``, on the CPU
    ``ycc_to_bgr_plain``. Chroma planes are the image's size or half it,
    rounded up (4:4:4, 4:2:2, 4:2:0); None for grey."""
    planes = [t for t in (y, cb, cr) if t is not None]
    if (len(planes) == 2 or any(t.dtype != torch.uint8 or t.dim() != 2
                                or t.device != y.device for t in planes)
            or (cb is not None and cb.shape != cr.shape)):
        raise RuntimeError("ycc_to_bgr: Y, and Cb and Cr of one shape or "
                           "neither, 2-D uint8 on one device")
    if y.device.type == "cpu":
        return ycc_to_bgr_plain(y, cb, cr)
    if y.device.type != "cuda":
        raise RuntimeError(f"ycc_to_bgr: no kernel for device {y.device}")
    y, cb, cr = (None if t is None else t.contiguous() for t in (y, cb, cr))
    h, w = y.shape
    ch, cw = (0, 0) if cb is None else cb.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = _entry("cfd_ycc_to_bgr")(
            y.data_ptr(), _ptr(cb), _ptr(cr), out.data_ptr(), w, h, cw, ch,
            stream)
    if code != 0:
        raise RuntimeError(f"ycc_to_bgr: {status_name(code)}")
    with _COUNT:
        ycc_to_bgr.launches += 1
    return out


ycc_to_bgr.launches = 0


def _sampling(cw: int, ch: int, w: int, h: int) -> Optional[tuple]:
    """(1 where the chroma is halved across, 1 where halved down) for 4:4:4,
    4:2:2 and 4:2:0 planes of an image w x h (halves rounded up), else
    None."""
    shifts = tuple(0 if c == n else 1 if c == (n + 1) // 2 else None
                   for c, n in ((cw, w), (ch, h)))
    return None if None in shifts or shifts == (0, 1) else shifts


def _fancy_upsample(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """libjpeg's fancy upsampling (jdsample.c h2v1/h2v2) of a chroma plane
    to (h, w), int32: a 3:1 blend with the nearer and the farther sample,
    edge samples standing in for missing neighbours."""
    shifts = _sampling(c.shape[1], c.shape[0], w, h)
    if shifts is None:
        raise RuntimeError(f"ycc_to_bgr: {status_name(2001)}")
    hs, vs = shifts
    c = c.to(torch.int32)
    if not hs:
        return c

    def shifted(t, dim):  # the neighbour before and after along dim
        first, last = t.narrow(dim, 0, 1), t.narrow(dim, t.shape[dim] - 1, 1)
        n = t.shape[dim]
        return (torch.cat([first, t.narrow(dim, 0, n - 1)], dim),
                torch.cat([t.narrow(dim, 1, n - 1), last], dim))

    if vs:  # column sums with the row above (even rows), below (odd rows)
        above, below = shifted(c, 0)
        c = torch.stack([3 * c + above, 3 * c + below], 1).reshape(
            -1, c.shape[1])
        bias, shift = (8, 7), 4
    else:
        bias, shift = (1, 2), 2
    left, right = shifted(c, 1)
    out = torch.stack([(3 * c + left + bias[0]) >> shift,
                       (3 * c + right + bias[1]) >> shift], 2)
    return out.reshape(c.shape[0], -1)[:h, :w]


def ycc_to_bgr_plain(y: torch.Tensor, cb: Optional[torch.Tensor],
                     cr: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of ``ycc_to_bgr``'s kernel: libjpeg's fancy chroma
    upsampling, then jdcolor.c's fixed-point ``ycc_rgb_convert``, as
    (H, W, 3) BGR uint8."""
    if cb is None:
        return y.unsqueeze(-1).expand(*y.shape, 3).contiguous()
    h, w = y.shape
    luma = y.to(torch.int32)
    b = _fancy_upsample(cb, h, w) - 128
    r = _fancy_upsample(cr, h, w) - 128
    bgr = torch.stack([
        luma + ((FIX_1_77200 * b + ONE_HALF) >> 16),
        luma + ((-FIX_0_34414 * b - FIX_0_71414 * r + ONE_HALF) >> 16),
        luma + ((FIX_1_40200 * r + ONE_HALF) >> 16)], -1)
    return bgr.clamp(0, 255).to(torch.uint8)



# ----------------------------------------------------------- the CLI's opencv
def opencv(what: str):
    """The cv2 module, imported here, or an ImportError that names
    ``what`` needs it (the CLI's drawing and writing, the synthetic
    tables' renders and JPEGs, ``data/synthetic.py``)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs opencv (the cv2 module), which is "
                          "not installed") from e
    return cv2


def video_frames(source) -> Iterator[np.ndarray]:
    """The BGR uint8 frames of a video file, or of the webcam for
    ``source`` 0, as ``cv2.VideoCapture`` reads them."""
    cap = opencv("reading video").VideoCapture(source)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield frame
    finally:
        cap.release()


def write_image(path: str, img: np.ndarray) -> None:
    """Writes the HWC BGR uint8 ``img`` to ``path`` (``cv2.imwrite``: JPEG
    for a .jpg name); raises where it cannot."""
    if not opencv("writing images").imwrite(path, np.ascontiguousarray(img)):
        raise OSError(f"cannot write {path}")


def draw_box(img: np.ndarray, box, label: str,
             color=(0, 255, 0)) -> None:
    """Draws the integer box (x1, y1, x2, y2) and ``label`` above it onto
    ``img`` in place, as the JAX package's ``inference.draw_detections``
    does (``cv2.rectangle``, ``cv2.putText``)."""
    cv2 = opencv("drawing detections")
    x1, y1, x2, y2 = box
    cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
    cv2.putText(img, label, (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                0.5, color, 1)


def attention_overlay(image: np.ndarray, att_map: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """The jet-coloured attention/depth map (H, W) uint8 blended onto the
    HWC BGR ``image`` resized to the map's size, as the JAX package's
    ``utils/visualize.py:attention_overlay`` computes it."""
    cv2 = opencv("drawing attention overlays")
    small = cv2.resize(image, (att_map.shape[1], att_map.shape[0]))
    heat = cv2.applyColorMap(np.asarray(att_map, np.uint8), cv2.COLORMAP_JET)
    return cv2.addWeighted(heat, alpha, small, 1.0, 0)
