"""Flip-averaging test-time augmentation, NCHW.

The port of ``centerfusiondetect3d_tpu/ops/tta.py:flip_forward``: the model
runs once on the image batch concatenated with its horizontal mirror, the
mirror half's outputs are flipped back, and the horizontally symmetric heads
(``SYMMETRIC_HEADS``) are averaged; the other heads (reg, rotation,
amodal_offset, velocity, nuscenes_att, the radar maps) keep the original
view's prediction, the upstream CenterNet flip-test policy.

The JAX package is NHWC and flips axis 2; here the width is dim 3. The radar
map (``[d, vx, vz]`` channels) mirrors with the image and negates its
x velocity, channel 1 of dim 1. The mirror half's calib takes
``out_width - cx`` (JAX's docstring says why: the frustum association mixes
output-plane box centres with the raw calib).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

SYMMETRIC_HEADS = ("heatmap", "widthHeight", "depth", "depth2", "dimension",
                   "depthMap")


def _flip_pc(pc: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if pc is None:
        return None
    out = torch.flip(pc, dims=(3,))
    if out.shape[1] >= 2:  # channel 1 is vel_x in the [d, vx, vz] layout
        out[:, 1] = -out[:, 1]
    return out


def flip_forward(model: Callable, image: torch.Tensor,
                 pc_dep: Optional[torch.Tensor] = None,
                 calib: Optional[torch.Tensor] = None,
                 pc_hm: Optional[torch.Tensor] = None,
                 out_width: int = 0) -> Dict[str, torch.Tensor]:
    """``model(image, pc_dep, calib, pc_hm)`` on [x; flip(x)], fused.

    image (B, 3, H, W); pc_dep and pc_hm (B, C, H/4, W/4) or None; calib
    (B, 3, 4) or None; ``out_width`` the output plane's width (default
    W // 4). Returns the model's dict with every 4-D output of the mirror
    half flipped back and averaged into the original's for the symmetric
    heads; other entries keep the first B rows."""
    b = image.shape[0]
    if not out_width:
        out_width = image.shape[3] // 4
    cat = lambda t, f: None if t is None else torch.cat([t, f(t)], dim=0)
    big_calib = None
    if calib is not None:
        mirror = calib.clone()
        mirror[:, 0, 2] = out_width - calib[:, 0, 2]
        big_calib = torch.cat([calib, mirror], dim=0)
    outputs = model(cat(image, lambda t: torch.flip(t, dims=(3,))),
                    cat(pc_dep, _flip_pc), big_calib, cat(pc_hm, _flip_pc))
    fused = {}
    for name, v in outputs.items():
        if not isinstance(v, torch.Tensor) or v.dim() != 4:
            fused[name] = (v[:b] if isinstance(v, torch.Tensor) and v.dim()
                           else v)
            continue
        orig = v[:b]
        fused[name] = (0.5 * (orig + torch.flip(v[b:], dims=(3,)))
                       if name in SYMMETRIC_HEADS else orig)
    return fused
