"""CornerNet gaussian radius (host-side, numpy).

The port's own copy of ``gaussian_radius`` from
``centerfusiondetect3d_tpu/geometry/gaussian.py`` (reference
``src/lib/utils/image.py:145-176``); the radar ``heatmap`` ROI method sizes
its paint boxes with it.
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
