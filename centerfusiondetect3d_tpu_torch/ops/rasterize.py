"""Radar depth-map rasterization on the device.

The port of ``centerfusiondetect3d_tpu/ops/rasterize.py``. The host computes
each radar point's integer paint box (``data/radar.py``, the same rounding as
the host raster) and ships compact (box, value) rows; the device paints them.
A pixel takes the row with the highest index whose box covers it, the
``max``-of-covering-index form of "last writer wins" (reference
``drawPcHeat``, ``nuscenes.py:234-263``). The winner's values are gathered
untouched, so the device raster equals the host raster bit for bit.
"""

from __future__ import annotations

import torch


def paint_rects_device_batch(boxes, values, out_size, chunk: int = 128):
    """(B, N, 4) int rows [y1, y2, x1, x2) and (B, N, C) float values ->
    (B, C, H, W). Rows with y1 >= y2 or x1 >= x2 (the all-zero padding)
    cover nothing; uncovered pixels are zero. ``chunk`` rows are tested at a
    time to bound the (B, chunk, H, W) cover mask."""
    h, w = int(out_size[0]), int(out_size[1])
    b, n = boxes.shape[:2]
    dev = boxes.device
    boxes = boxes.to(torch.int32)
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    winner = torch.full((b, h, w), -1, device=dev, dtype=torch.int32)
    for s in range(0, n, chunk):
        bx = boxes[:, s:s + chunk, :, None, None]  # (B, c, 4, 1, 1)
        cover = ((yy >= bx[:, :, 0]) & (yy < bx[:, :, 1])
                 & (xx >= bx[:, :, 2]) & (xx < bx[:, :, 3]))  # (B, c, H, W)
        ids = torch.arange(s, s + bx.shape[1], device=dev,
                           dtype=torch.int32)[:, None, None]
        winner = torch.maximum(winner,
                               torch.where(cover, ids, -1).amax(dim=1))
    c = values.shape[-1]
    vals = torch.gather(
        values.to(torch.float32).transpose(1, 2), 2,
        winner.clamp(min=0).reshape(b, 1, -1).expand(b, c, -1).long())
    vals = vals.reshape(b, c, h, w)
    return torch.where((winner >= 0)[:, None], vals, torch.zeros_like(vals))
