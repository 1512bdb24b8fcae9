"""Plain reference of the serving pre-processing: the camera frame warped
to the network input, and the radar cloud drawn as pillars into the
stride-4 depth map [d, vx, vz] (CenterFusion, arXiv:2011.04841, section
4.2). numpy on the host for the geometry, torch for the warp; it imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

MEAN = (0.40789654, 0.44719302, 0.47026115)
STD = (0.28863828, 0.27408164, 0.27809835)
PILLAR_DIMS = (1.5, 0.2, 0.2)


def affine_transform(center, scale, out_wh, inverse=False) -> np.ndarray:
    """The 2x3 affine taking the square of side ``scale`` at ``center``
    onto an (out_w, out_h) image (three point pairs, solved in float64)."""
    center = np.asarray(center, np.float32)
    scale = np.array([scale, scale], np.float32)
    dst_w, dst_h = out_wh
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + np.array([0.0, scale[0] * -0.5], np.float32)
    dst[0] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32)
    dst[1] = np.array([0.0, dst_w * -0.5], np.float32) + dst[0]
    for p in (src, dst):
        d = p[0] - p[1]
        p[2] = p[1] + np.array([-d[1], d[0]], np.float32)
    a, b = (dst, src) if inverse else (src, dst)
    lhs = np.concatenate([a, np.ones((3, 1), np.float32)], 1)
    return np.linalg.solve(lhs.astype(np.float64), b.astype(np.float64)).T


def frame_geometry(width: int, height: int, in_hw, out_hw):
    """(trans_in, trans_out, trans_inv_out) of a frame served whole."""
    center = np.array([width / 2.0, height / 2.0], np.float32)
    scale = float(max(height, width))
    return (affine_transform(center, scale, (in_hw[1], in_hw[0])),
            affine_transform(center, scale, (out_hw[1], out_hw[0])),
            affine_transform(center, scale, (out_hw[1], out_hw[0]),
                             inverse=True).astype(np.float32))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def warp(src: torch.Tensor, trans: np.ndarray, out_hw) -> torch.Tensor:
    """Bilinear warp of an (H, W, 3) uint8 frame by the forward affine
    ``trans`` with a zero border: each destination pixel reads the source
    at the inverse affine's image of it (inverse in float64, used in
    float32), its two row lerps and the column lerp each rounded once, then
    rounded half to even into uint8."""
    m = np.asarray(trans, np.float64).reshape(-1)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a0, a1, a3, a4 = m[4] * d, m[1] * -d, m[3] * -d, m[0] * d
    inv = torch.tensor([a0, a1, -a0 * m[2] - a1 * m[5],
                        a3, a4, -a3 * m[2] - a4 * m[5]],
                       dtype=torch.float32, device=src.device)
    h, w = src.shape[:2]
    oh, ow = out_hw
    xs = torch.arange(ow, dtype=torch.float32, device=src.device)[None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=src.device)[:, None]
    sx = _fma(inv[0], xs, inv[1] * ys + inv[2])
    sy = _fma(inv[3], xs, inv[4] * ys + inv[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.long(), fy.long()

    def px(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return src[yy.clamp(0, h - 1), xx.clamp(0, w - 1)].float() \
            * inside[..., None]

    p00, p01, p10, p11 = px(0, 0), px(0, 1), px(1, 0), px(1, 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return torch.round(_fma(ay, bottom - top, top)).clamp(0, 255).to(
        torch.uint8)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 normalized."""
    mean = torch.tensor(MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=images.device).view(1, 3, 1, 1)
    return (images.permute(0, 3, 1, 2).float() / 255.0 - mean) / std


def _box_corners(dim, center):
    """(n, 3) corners of axis-aligned (yaw 0) [h, w, l] boxes at centre."""
    h, w, l = dim[..., 0:1], dim[..., 1:2], dim[..., 2:3]
    x = l * np.asarray((0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5),
                       np.float32)
    y = h * np.asarray((0, 0, 0, 0, -1, -1, -1, -1), np.float32)
    z = w * np.asarray((0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5),
                       np.float32)
    c, s = np.cos(np.zeros_like(dim[..., 0]))[..., None], \
        np.sin(np.zeros_like(dim[..., 0]))[..., None]
    return np.stack([c * x + s * z, y, -s * x + c * z], -1) + center[..., None, :]


def _project(points, calib):
    homo = np.concatenate([points, np.ones_like(points[..., :1])], -1)
    proj = np.einsum("...ij,...nj->...ni", calib, homo)
    return proj[..., :2] / proj[..., 2:3]


def radar_map(cloud: np.ndarray, calib: np.ndarray, width: int, height: int,
              trans_out: np.ndarray, out_hw, max_dist: float) -> np.ndarray:
    """(18, N) camera-frame radar returns -> (H/4, W/4, 3) depth map: the
    returns within ``max_dist`` that project inside the frame (a 1-pixel
    margin), in ascending depth order, each painted as the image of a
    1.5 m x 0.2 m x 0.2 m pillar standing on it (its projected width
    centred on the point, its height above it), a later point overwriting
    an earlier one."""
    oh, ow = out_hw
    pc = np.asarray(cloud, np.float32)
    pc = pc[:, pc[2] <= max_dist]
    intr = np.asarray(calib, np.float32)[:3, :3]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = intr
    homo = np.vstack([pc[:3], np.ones((1, pc.shape[1]), pc.dtype)])
    proj = view @ homo
    proj = proj[:3] / np.maximum(proj[2:3], 1e-9)
    keep = ((pc[2] > 0) & (proj[0] > 1) & (proj[0] < width - 1)
            & (proj[1] > 1) & (proj[1] < height - 1))
    pc2 = proj[:, keep]
    pc2[2] = pc[2, keep]
    pc3 = pc[:, keep]
    order = np.argsort(pc2[2, :], kind="stable")
    pc2, pc3 = pc2[:, order], pc3[:, order]
    out = np.zeros((oh, ow, 3), np.float32)
    if pc2.shape[1] == 0:
        return out
    pts = trans_out[:, :2] @ pc2[:2] + trans_out[:, 2:3]
    inside = (pts[0] < ow) & (0 < pts[0]) & (pts[1] < oh) & (0 < pts[1])
    pts = np.concatenate([pts[:, inside], pc2[2:, inside]], 0)
    pc3 = pc3[:, inside]
    n = pts.shape[1]
    if n == 0:
        return out
    dims = np.broadcast_to(np.asarray(PILLAR_DIMS, np.float32), (1, n, 3))
    corner = _box_corners(dims, pc3[:3].T.reshape(1, n, 3).astype(np.float32))
    cal = np.broadcast_to(np.asarray(calib, np.float32).reshape(1, 1, 3, 4),
                          (1, n, 3, 4))
    flat = _project(corner, cal).reshape(-1, 2).T
    img = trans_out[:, :2] @ flat[:2] + trans_out[:, 2:3]
    box = img.T.reshape(n, 8, 2)
    pw = (box[..., 0].max(1) - box[..., 0].min(1)).astype(np.float32)
    ph = (box[..., 1].max(1) - box[..., 1].min(1)).astype(np.float32)
    vals = np.stack([pts[2].astype(np.float32), pc3[8], pc3[9]], 1)
    for i in range(n):
        x, y = pts[0, i], pts[1, i]
        b = np.round([max(y - ph[i], 0.0), y, max(x - pw[i] / 2, 0.0),
                      min(x + pw[i] / 2, ow)]).astype(np.int32)
        y1, y2, x1, x2 = max(b[0], 0), min(b[1], oh), max(b[2], 0), \
            min(b[3], ow)
        if y2 > y1 and x2 > x1:
            out[y1:y2, x1:x2] = vals[i]
    return out
