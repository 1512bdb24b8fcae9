"""Display helpers of the inference CLI's ``--show-attention``: depth and
radar maps normalized for display.

The port of ``normalize_depthmaps`` from
``centerfusiondetect3d_tpu/utils/visualize.py`` (reference
``detector.py:351-394``), on the NCHW maps the port's model gives. The
overlay that blends a map onto the frame is opencv's, so it lives beside
the other cv2 calls (``data/image_io.py:attention_overlay``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def normalize_depthmaps(extras: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """Model depth/attention maps -> display-normalized uint8 (B, H, W):
    a channel max of (B, C, H, W) maps, then per-image min/max
    normalization. Reference quirk (detector.py:388-389), kept: row 0 and
    column 0 of image 0 alone are zeroed to anchor the range."""
    out = {}
    for key, m in extras.items():
        if m is None:
            continue
        m = np.asarray(m, np.float32)
        if m.ndim == 4:  # NCHW -> channel max
            m = m.max(axis=1)
        m = m.copy()
        m[0, 0, :] = 0.0
        m[0, :, 0] = 0.0
        lo = m.min(axis=(1, 2), keepdims=True)
        hi = m.max(axis=(1, 2), keepdims=True)
        out[key] = ((m - lo) / np.maximum(hi - lo, 1e-9) * 255).astype(
            np.uint8)
    return out
