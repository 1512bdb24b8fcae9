"""CornerNet gaussian radius and heatmap splats (host-side, numpy).

The port's own copy of ``centerfusiondetect3d_tpu/geometry/gaussian.py``
(reference ``src/lib/utils/image.py:145-256``): the radar ``heatmap`` ROI
method sizes its paint boxes with ``gaussian_radius``, and the training
target builder (``data/targets.py``) max-splats object peaks with
``draw_gaussian``.
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """Smallest radius keeping >= min_overlap IoU for a (h, w) detection."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    """Isotropic 2D gaussian kernel of the given (rows, cols) shape."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def ellip_gaussian_2d(shape, sigma_x: float, sigma_y: float) -> np.ndarray:
    """Anisotropic 2D gaussian kernel (MonoFlex-style edge heatmap)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x) / (2 * sigma_x * sigma_x)
               - (y * y) / (2 * sigma_y * sigma_y))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius,
                  k: float = 1.0) -> np.ndarray:
    """Max-splat a gaussian peak onto ``heatmap`` (H, W) in place.

    ``radius`` is an int (circular) or an (rx, ry) pair (elliptical, for
    out-of-view amodal centers).
    """
    if isinstance(radius, (int, np.integer)):
        diameter = 2 * int(radius) + 1
        gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)
        radius = [int(radius), int(radius)]
    else:
        dx, dy = 2 * int(radius[0]) + 1, 2 * int(radius[1]) + 1
        gaussian = ellip_gaussian_2d((dy, dx), sigma_x=dx / 6, sigma_y=dy / 6)
        radius = [int(radius[0]), int(radius[1])]

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]
    left, right = min(x, radius[0]), min(width - x, radius[0] + 1)
    top, bottom = min(y, radius[1]), min(height - y, radius[1] + 1)
    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[radius[1] - top : radius[1] + bottom,
                               radius[0] - left : radius[0] + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap
