"""Validation and debug renders, and the display helpers of the CLIs.

The port of ``centerfusiondetect3d_tpu/utils/visualize.py`` (reference
``src/lib/utils/logger.py:35-485`` WandbLogger and
``generic_dataset.py:959-1129`` debugPillar): radar-heatmap and 3D-box
overlays, a ground-truth-vs-prediction bird's-eye view, the radar-pillar
renders of ``DEBUG > 1`` and ``ValVisualizer``, which ``Trainer.val`` runs
at ``DEBUG > 0`` to write the first validation image's renders as PNGs
under ``<out_dir>/viz/``. The drawing is opencv's, as in the JAX package:
cv2 comes from ``data/image_io.py:opencv`` when a renderer is called.

One deliberate difference: ``ValVisualizer.add_ground_truth`` warps the
image with the dataset's own warp (``data/transforms.py:warp_image_native``,
bitwise numpy ``warp_image``, which follows cv2 5.0's arithmetic) where the
JAX package calls ``cv2.warpAffine``; another opencv may differ from it by
a level at single pixels (``ROADMAP.md``, Queue 3).

``normalize_depthmaps`` serves the inference CLI's and the demo's
``--show-attention``; the overlay that blends a map onto the frame is
``data/image_io.py:attention_overlay``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.image_io import opencv
from ..data.transforms import warp_image_native
from ..geometry.affine import get_affine_transform
from ..geometry.transforms3d import get_3d_box_np, project_3d_points_np

logger = logging.getLogger("cfd3d.visualize")

BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
GT_COLOR = (80, 80, 255)      # BGR red-ish: ground truth
PRED_COLOR = (80, 220, 80)    # BGR green: predictions


def draw_box_3d(img, corners_2d, color=(80, 220, 80)):
    """Wireframe 3D box from 8 projected corners, drawn into ``img``."""
    cv2 = opencv("drawing 3D boxes")
    pts = np.asarray(corners_2d).astype(np.int32)
    for a, b in BOX_EDGES:
        cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, 1, cv2.LINE_AA)
    return img


def pc_heatmap_overlay(image: np.ndarray, pc_hm: np.ndarray,
                       channels_first: bool = False) -> np.ndarray:
    """Radar heatmap on the input image (logger.py:173-190 drawPcHeatmap):
    active pixels blacked out, intensity in the green channel. ``pc_hm`` is
    (H, W), (H, W, C), or with ``channels_first`` (C, H, W), as the port's
    NCHW model gives it; its first channel is drawn."""
    cv2 = opencv("drawing radar heatmaps")
    out = image.copy()
    hm = np.asarray(pc_hm, np.float32)
    if hm.ndim == 3:
        hm = hm[0] if channels_first else hm[..., 0]
    hm8 = (np.clip(hm, 0.0, 1.0) * 255).astype(np.uint8)
    hm8 = cv2.resize(hm8, (out.shape[1], out.shape[0]),
                     interpolation=cv2.INTER_NEAREST)
    active = hm8 > 0
    out[active] = 0
    out[:, :, 1][active] = hm8[active]
    return out


def box3d_overlay(image: np.ndarray, items: List[dict], calib: np.ndarray,
                  trans_input: np.ndarray, conf_thresh: float = 0.3,
                  color=(80, 220, 80)) -> np.ndarray:
    """3D boxes projected into input coordinates (logger.py:197-245
    drawBox3D). ``items`` are annotation or detection dicts with dimension,
    location and yaw; boxes with a corner behind the camera are skipped."""
    out = image.copy()
    calib = np.asarray(calib, np.float32).reshape(1, 1, 3, 4)
    for it in items:
        if "score" in it and it["score"] < conf_thresh:
            continue
        corners = get_3d_box_np(
            np.asarray(it["dimension"], np.float32).reshape(1, 1, 3),
            np.asarray(it["location"], np.float32).reshape(1, 1, 3),
            np.asarray([[it["yaw"]]], np.float32))  # (1, 1, 8, 3)
        if corners[..., 2].min() <= 0:
            continue
        pts = project_3d_points_np(corners.astype(np.float32), calib)[0, 0]
        pts = pts @ trans_input[:, :2].T + trans_input[:, 2]
        draw_box_3d(out, pts, color=color)
    return out


def bev_gt_vs_pred(gt_items: List[dict], pred_items: List[dict],
                   radar_pc: Optional[np.ndarray] = None,
                   conf_thresh: float = 0.3, size: int = 640,
                   bev_range: float = 60.0) -> np.ndarray:
    """Top-down ground truth against predictions (logger.py:247-287): the
    ego at the bottom centre, ground truth red, predictions green, radar
    points amber."""
    cv2 = opencv("drawing the bird's-eye view")
    canvas = np.full((size, size, 3), 30, np.uint8)
    scale = size / (2 * bev_range)

    def to_px(x, z):
        return int(size / 2 + x * scale), int(size - z * scale)

    for r in (10, 30, 50):
        cv2.circle(canvas, to_px(0, 0), int(r * scale), (60, 60, 60), 1)
    if radar_pc is not None and radar_pc.size:
        for i in range(radar_pc.shape[1]):
            x, z = radar_pc[0, i], radar_pc[2, i]
            if abs(x) < bev_range and 0 < z < 2 * bev_range:
                cv2.circle(canvas, to_px(x, z), 2, (60, 180, 255), -1)
    for items, color in ((gt_items, GT_COLOR), (pred_items, PRED_COLOR)):
        for it in items:
            if "score" in it and it["score"] < conf_thresh:
                continue
            x, _, z = np.asarray(it["location"], np.float32)
            h, w, l = np.asarray(it["dimension"], np.float32)
            box = cv2.boxPoints((to_px(float(x), float(z)),
                                 (l * scale, w * scale),
                                 -np.degrees(float(it["yaw"]))))
            cv2.polylines(canvas, [box.astype(np.int32)], True, color, 1)
    return canvas


def debug_pillars(img: np.ndarray, pc_2d: np.ndarray, pillar_wh: np.ndarray,
                  trans_input: np.ndarray, trans_output: np.ndarray,
                  input_size, output_size, out_dir: str, index: int = 0,
                  max_dist: float = 60.0) -> List[str]:
    """The radar-pillar renders of ``DEBUG > 1`` (debugPillar,
    generic_dataset.py:959-1129): jet-coloured radar returns and their
    pillar rectangles over the warped input image, over the output-size
    image, and the original image, written as
    ``<out_dir>/<index>_{pillarInput2D,pillarOutput2D,pillarInputOverlay,
    imgOrigin}.jpg``.

    img: the original HWC BGR image; pc_2d: (3, N) radar points in output
    coordinates [x, y, d]; pillar_wh: (2, N) pillar sizes at output scale;
    trans_input / trans_output: original -> input / output affines;
    input_size / output_size: (H, W).
    """
    cv2 = opencv("drawing the radar-pillar renders")
    in_h, in_w = input_size
    out_h, out_w = output_size
    img_input = cv2.warpAffine(img, trans_input, (in_w, in_h))
    img_output = cv2.warpAffine(img, trans_output, (out_w, out_h))
    overlay_input = img_input.copy()
    n = pc_2d.shape[1]
    scale_in = in_w / out_w
    depth_colors = cv2.applyColorMap(
        (np.clip(pc_2d[2, :n] / max_dist, 0, 1) * 255).astype(
            np.uint8).reshape(-1, 1), cv2.COLORMAP_JET)
    for i in range(n - 1, -1, -1):
        x_o, y_o, d = pc_2d[0, i], pc_2d[1, i], pc_2d[2, i]
        if d <= 0:
            continue
        color = depth_colors[i, 0].tolist()
        pw, ph = float(pillar_wh[0, i]), float(pillar_wh[1, i])
        cv2.circle(img_output, (int(x_o), int(y_o)), 1, color, -1)
        cv2.rectangle(img_output,
                      (max(int(x_o - pw / 2), 0), max(int(y_o - ph), 0)),
                      (min(int(x_o + pw / 2), out_w), min(int(y_o), out_h)),
                      color, 1, lineType=cv2.LINE_AA)
        x_i, y_i = x_o * scale_in, y_o * scale_in
        pwi, phi = pw * scale_in, ph * scale_in
        cv2.circle(img_input, (int(x_i), int(y_i)), 3, color, -1)
        cv2.rectangle(img_input,
                      (max(int(x_i - pwi / 2), 0), max(int(y_i - phi), 0)),
                      (min(int(x_i + pwi / 2), in_w), min(int(y_i), in_h)),
                      color, 1, lineType=cv2.LINE_AA)
        cv2.circle(overlay_input, (int(x_i), int(y_i)), 3, color, -1)
    os.makedirs(out_dir, exist_ok=True)
    frames = {"pillarInput2D": img_input, "pillarOutput2D": img_output,
              "pillarInputOverlay": overlay_input, "imgOrigin": img}
    paths = []
    for name, frame in frames.items():
        path = os.path.join(out_dir, f"{index}_{name}.jpg")
        cv2.imwrite(path, frame)
        paths.append(path)
    return paths


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


class ValVisualizer:
    """One validation image's renders per validation, written to
    ``<out_dir>/viz/`` (WandbLogger addGroundTruth / addPredict /
    renderVisualizeResult, logger.py:78-487)."""

    def __init__(self, out_dir: str, config, dataset):
        self.dir = os.path.join(out_dir, "viz")
        self.config = config
        self.dataset = dataset
        self.conf_thresh = float(config.CONF_THRESH)
        self.reset()

    def reset(self):
        self.image = None
        self.img_id = None
        self.trans_input = None
        self.calib = None
        self.gt_anns: List[dict] = []
        self.frames: Dict[str, np.ndarray] = {}

    def add_ground_truth(self, img_id: int, pc_hm: Optional[np.ndarray]):
        """Capture the first image and its ground-truth overlays
        (logger.py:78-137); ``pc_hm`` is the target radar map, (H, W, C)."""
        if self.image is not None:
            return
        info = self.dataset.coco.load_imgs(img_id)[0]
        self.gt_anns = self.dataset.coco.load_anns(
            self.dataset.coco.get_ann_ids(img_id))
        self.img_id = img_id
        in_h, in_w = self.config.MODEL.INPUT_SIZE
        center = np.array([info["width"] / 2.0, info["height"] / 2.0],
                          np.float32)
        if self.config.DATASET.MAX_CROP:
            scale = max(info["height"], info["width"]) * 1.0
        else:
            scale = np.array([info["width"], info["height"]], np.float32)
        self.trans_input = get_affine_transform(center, scale, 0,
                                                (in_w, in_h))
        self.image = warp_image_native(self.dataset.load_image(info),
                                       self.trans_input, (in_w, in_h))
        self.calib = np.array(
            info.get("calib", [[1266.4, 0, info["width"] / 2, 0],
                               [0, 1266.4, info["height"] / 2, 0],
                               [0, 0, 1, 0]]), np.float32)
        if pc_hm is not None:
            self.frames["target_pc_hm"] = pc_heatmap_overlay(self.image,
                                                             pc_hm)
        self.frames["target_box_3d"] = box3d_overlay(
            self.image, self.gt_anns, self.calib, self.trans_input,
            conf_thresh=-1.0, color=GT_COLOR)

    def add_predictions(self, img_id: int, items: List[dict],
                        pc_hm: Optional[np.ndarray] = None,
                        radar_pc: Optional[np.ndarray] = None):
        """Prediction overlays and the bird's-eye view of the captured image
        (logger.py:140-171 addPredict); ``pc_hm`` is the model's radar
        heatmap of that image, (C, H, W)."""
        if self.image is None or img_id != self.img_id:
            return
        if pc_hm is not None:
            self.frames["pred_pc_hm"] = pc_heatmap_overlay(
                self.image, pc_hm, channels_first=True)
        self.frames["pred_box_3d"] = box3d_overlay(
            self.image, items, self.calib, self.trans_input,
            conf_thresh=self.conf_thresh, color=PRED_COLOR)
        self.frames["bev"] = bev_gt_vs_pred(
            self.gt_anns, items, radar_pc=radar_pc,
            conf_thresh=self.conf_thresh)

    def save(self, epoch: Optional[int] = None) -> List[str]:
        """Write the collected renders as ``[e####_]<name>.png``."""
        if not self.frames:
            return []
        cv2 = opencv("writing validation renders")
        os.makedirs(self.dir, exist_ok=True)
        tag = f"e{epoch:04d}_" if epoch is not None else ""
        paths = []
        for name, frame in self.frames.items():
            path = os.path.join(self.dir, f"{tag}{name}.png")
            cv2.imwrite(path, frame)
            paths.append(path)
        logger.info("visualized img %s -> %s", self.img_id, self.dir)
        self.reset()
        return paths
