"""Plain reference of what follows the network: the frustum association of
the radar map to the first-stage boxes, peak decoding and the
post-processing into camera-space 3D boxes (CenterFusion,
arXiv:2011.04841, sections 4.3-4.4; CenterNet, arXiv:1904.07850). Written
per box and per detection where that is clearer than the batched form;
it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

PI = math.pi
_X = (0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)
_Y = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0)
_Z = (0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5)


def get_alpha(rot):
    """8-bin rotation (..., 8) -> observation angle."""
    a1 = torch.atan2(rot[..., 2], rot[..., 3]) - 0.5 * PI
    a2 = torch.atan2(rot[..., 6], rot[..., 7]) + 0.5 * PI
    return torch.where(rot[..., 1] > rot[..., 5], a1, a2)


def wrap(a):
    a = a - 2 * PI * (a > PI)
    return a + 2 * PI * (a < -PI)


def corners(dim, yaw):
    """(..., 3) [h, w, l], (...,) yaw -> (..., 8, 3) box corners."""
    s = dim.new_tensor((_X, _Y, _Z))
    x, y, z = dim[..., 2:3] * s[0], dim[..., 0:1] * s[1], dim[..., 1:2] * s[2]
    c, n = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    return torch.stack([c * x + n * z, y, -n * x + c * z], -1)


def topk(x, k):
    """Top-k over the last axis, ties by the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def peaks(heat, k):
    """Two-stage top-k of a (B, C, H, W) map: scores, flat H*W index,
    class, ys, xs, each (B, K)."""
    b, c, h, w = heat.shape
    s_c, i_c = topk(heat.reshape(b, c, -1), k)
    s, i = topk(s_c.reshape(b, -1), k)
    flat = torch.gather(i_c.reshape(b, -1), 1, i)
    return s, flat, torch.div(i, k, rounding_mode="floor"), \
        torch.div(flat, w, rounding_mode="floor"), flat % w


def gather(feat, flat):
    """(B, C, H, W), (B, K) -> (B, K, C)."""
    b, c = feat.shape[:2]
    return torch.gather(feat.reshape(b, c, -1), 2,
                        flat[:, None, :].expand(b, c, flat.shape[1])
                        ).transpose(1, 2)


def frustum_heatmap(y: Dict[str, torch.Tensor], pc_dep, calib, k: int,
                    max_dist: float):
    """Radar heatmap of the first-stage boxes: for each of the top-k boxes
    (no NMS) in descending score order, the nearest radar pixel of the box
    whose depth lies in the box's frustum window paints [d / max_dist, vx,
    vz] into the 0.3-scaled box at its centre; later boxes overwrite.
    Python slice semantics (negative starts wrap) as the reference has
    them."""
    b, _, h, w = pc_dep.shape
    out = torch.zeros_like(pc_dep)
    _, flat, _, ys, xs = peaks(y["heatmap"], k)
    xs, ys = xs.float() + 0.5, ys.float() + 0.5
    depth = gather(y["depth"], flat)[..., 0]
    wh = gather(y["widthHeight"], flat).clamp(min=0.0)
    dim = gather(y["dimension"], flat)
    alpha = get_alpha(gather(y["rotation"], flat))
    x1, y1 = xs - wh[..., 0] / 2, ys - wh[..., 1] / 2
    x2, y2 = xs + wh[..., 0] / 2, ys + wh[..., 1] / 2
    cx = (x1 + x2) / 2
    yaw = wrap(alpha + torch.atan2(cx - calib[:, None, 0, 2],
                                   calib[:, None, 0, 0]))
    z = corners(dim, yaw)[..., 2]
    thresh = z.amax(-1) - z.amin(-1) / 2.0
    for bi in range(b):
        d_map = pc_dep[bi, 0]
        for j in range(k):
            c0, c1 = int(torch.floor(x1[bi, j])), int(torch.ceil(x2[bi, j]))
            r0, r1 = int(torch.floor(y1[bi, j])), int(torch.ceil(y2[bi, j]))
            crop = d_map[r0:r1 + 1, c0:c1 + 1]
            lo = max(float(depth[bi, j] - thresh[bi, j]), 0.0)
            hi = float(depth[bi, j] + thresh[bi, j])
            ok = (crop > 0) & (crop < hi) & (crop > lo)
            if not bool(ok.any()):
                continue
            masked = torch.where(ok, crop, torch.full_like(crop, math.inf))
            # the first nearest in the crop's row-major order
            rr, cc = divmod(int(torch.argmin(masked.reshape(-1))),
                            crop.shape[1])
            # the crop's own rows and columns in the map
            row = range(h)[r0:r1 + 1][rr]
            col = range(w)[c0:c1 + 1][cc]
            val = torch.stack([d_map[row, col] / max_dist,
                               pc_dep[bi, 1, row, col],
                               pc_dep[bi, 2, row, col]])
            # float32 arithmetic, truncated toward zero as python int()
            ccx = (x1[bi, j] + x2[bi, j]) / 2.0
            ccy = (y1[bi, j] + y2[bi, j]) / 2.0
            wi = 0.3 * (x2[bi, j] - x1[bi, j])
            hi_ = 0.3 * (y2[bi, j] - y1[bi, j])
            wmin, wmax = int(ccx - wi / 2.0), int(ccx + wi / 2.0)
            hmin, hmax = int(ccy - hi_ / 2.0), int(ccy + hi_ / 2.0)
            out[bi, :, hmin:hmax + 1, wmin:wmax + 2] = val[:, None, None]
    return out


def decode(y: Dict[str, torch.Tensor], k: int):
    """Top-K detections of one pyramid level: 3x3 max-pool NMS, two-stage
    top-k, the regression heads gathered at the peaks (depth2 and
    rotation2 in place of depth and rotation where present). Also returns
    the peaks themselves (class, ys, xs)."""
    heat = y["heatmap"]
    hmax = F.max_pool2d(heat, 3, stride=1, padding=1)
    heat = torch.where(hmax == heat, heat, torch.zeros_like(heat))
    h, w = heat.shape[-2:]
    scores, flat, cls, ys, xs = peaks(heat, k)
    xn, yn = xs / w, ys / h  # the normalized centres, as float32
    reg = gather(y["reg"], flat)
    px, py = xn * w + reg[..., 0], yn * h + reg[..., 1]
    wh = gather(y["widthHeight"], flat).clamp(min=0.0)
    det = {"scores": scores, "classIds": cls.float(),
           "bboxes": torch.stack([px - wh[..., 0] / 2, py - wh[..., 1] / 2,
                                  px + wh[..., 0] / 2, py + wh[..., 1] / 2],
                                 -1),
           "centers": torch.stack([xn, yn], -1),
           "depth": gather(y["depth2" if "depth2" in y else "depth"], flat),
           "rotation": gather(y["rotation2" if "rotation2" in y
                              else "rotation"], flat)}
    for head in ("dimension", "amodal_offset", "nuscenes_att", "velocity"):
        if head in y:
            det[head] = gather(y[head], flat)
    return det, (cls, ys, xs)


def post_process(det, trans_inv, output_hw, calib):
    """Decoded detections -> original-image boxes and camera-space 3D
    boxes. trans_inv (B, 2, 3) output plane -> image; calib (B, 3, 4)."""
    oh, ow = output_hw

    def affine(p):  # (B, K, 2)
        return torch.einsum("bkj,bij->bki", p, trans_inv[:, :, :2]) \
            + trans_inv[:, None, :, 2]

    b, k = det["scores"].shape
    out = {"scores": det["scores"], "classIds": det["classIds"] + 1,
           "dimension": det["dimension"]}
    out["bboxes"] = affine(det["bboxes"].reshape(b, 2 * k, 2)).reshape(b, k, 4)
    alpha = get_alpha(det["rotation"])
    centers = det["centers"] * det["centers"].new_tensor([ow, oh])
    centers = affine(centers + det["amodal_offset"])
    depth = det["depth"][..., 0]
    cal = calib[:, None]
    z = depth - cal[..., 2, 3]
    x = (centers[..., 0] * depth - cal[..., 0, 3] - cal[..., 0, 2] * z) \
        / cal[..., 0, 0]
    yy = (centers[..., 1] * depth - cal[..., 1, 3] - cal[..., 1, 2] * z) \
        / cal[..., 1, 1]
    out["locations"] = torch.stack([x, yy + det["dimension"][..., 0] / 2, z],
                                   -1)
    out["yaws"] = wrap(alpha + torch.atan2(centers[..., 0] - cal[..., 0, 2],
                                           cal[..., 0, 0]))
    if "velocity" in det:
        v = det["velocity"]
        speed = torch.sqrt(v[..., 0] ** 2 + v[..., 2] ** 2)
        out["velocity"] = torch.stack([torch.cos(out["yaws"]) * speed,
                                       v[..., 1],
                                       -torch.sin(out["yaws"]) * speed], -1)
    if "nuscenes_att" in det:
        out["nuscenes_att"] = det["nuscenes_att"]
    return out
