"""KITTI interchange: nuScenes ground truth -> KITTI files and back.

The port's own copy of ``centerfusiondetect3d_tpu/evaluation/kitti.py``
(numpy only; cv2 from ``data/image_io.py:opencv`` where ``render_kitti``
draws), a native analogue of the reference's KITTI stack
(``src/lib/nuScenes_lib/utils_kitti.py``: ``KittiDB.parse_label_line:91``,
``box_nuscenes_to_kitti:120``, ``project_kitti_box_to_image:154``,
``box_to_string:379``; ``export_kitti.py``:
``KittiConverter.nuscenes_gt_to_kitti:83``, ``kitti_res_to_nuscenes:271``).
The reference drives the nuScenes devkit (``Box``/``Quaternion`` objects);
this works on numpy arrays and the converter's raw-table reader
(``data/convert_nuscenes.py:RawNuScenes``), so it runs without the devkit.

Frames, following the KITTI devkit conventions the reference mirrors:
  * nuScenes LIDAR: x forward, y left, z up.
  * KITTI LIDAR:    x forward, y left, z up, but rotated -90 degrees about
    z relative to nuScenes (``kitti_to_nu_lidar = Rz(+90)``).
  * KITTI camera:   x right, y down, z forward; the box centre is the
    BOTTOM-face centre (the +h/2 translate in ``box_nuscenes_to_kitti``).

Deviation from the reference, documented as in the JAX package:
``kitti_results_to_nuscenes`` returns boxes transformed back to the GLOBAL
frame (what a nuScenes submission requires), where the reference's dormant
``kitti_res_to_nuscenes`` emits lidar-frame centres verbatim
(export_kitti.py:320-341).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import quaternion as quat

# Rz(+90 degrees): KITTI lidar -> nuScenes lidar (utils_kitti.py:123-124)
KITTI_TO_NU_LIDAR = quat.from_axis_angle([0.0, 0.0, 1.0], np.pi / 2)
KITTI_TO_NU_LIDAR_INV = quat.inverse(KITTI_TO_NU_LIDAR)

# nuScenes category -> detection-challenge name (devkit category_to_detection_name)
_DETECTION_NAME = {
    "animal": None,
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.personal_mobility": None,
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.stroller": None,
    "human.pedestrian.wheelchair": None,
    "movable_object.barrier": "barrier",
    "movable_object.debris": None,
    "movable_object.pushable_pullable": None,
    "movable_object.trafficcone": "traffic_cone",
    "static_object.bicycle_rack": None,
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": None,
    "vehicle.emergency.police": None,
    "vehicle.motorcycle": "motorcycle",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def category_to_detection_name(category: str) -> Optional[str]:
    if category in _DETECTION_NAME:
        return _DETECTION_NAME[category]
    # raw converter categories may already be detection names
    return category if category in {v for v in _DETECTION_NAME.values() if v} else None


# --------------------------------------------------------------------------
# label-line format (utils_kitti.py:91-117, 379-415)
# --------------------------------------------------------------------------

def parse_label_line(line: str) -> dict:
    """One KITTI label line -> dict; same keys as the reference parser.

    Boxes are in the KITTI camera frame; `wlh` is (width, length, height)
    re-ordered from the file's h/w/l columns, `score` is NaN when absent.
    """
    p = line.split(" ")
    out = {
        "name": p[0].strip(),
        "truncation": float(p[1]),
        "occlusion": float(p[2]),
        "alpha": float(p[3]),
        "bbox_camera": (float(p[4]), float(p[5]), float(p[6]), float(p[7])),
        "wlh": (float(p[9]), float(p[10]), float(p[8])),
        "xyz_camera": (float(p[11]), float(p[12]), float(p[13])),
        "yaw_camera": float(p[14]),
        "score": float(p[15]) if len(p) > 15 else float("nan"),
    }
    return out


def yaw_camera_from_quat(q) -> float:
    """Yaw about the camera Y axis of the box x-axis (utils_kitti.py:397-398)."""
    v = quat.rotate(q, [1.0, 0.0, 0.0])
    return float(-np.arctan2(v[2], v[0]))


def box_to_string(name: str, center, wlh, yaw: float,
                  bbox_2d=(-1.0, -1.0, -1.0, -1.0), truncation: float = -1.0,
                  occlusion: int = -1, alpha: float = -10.0,
                  score: float = float("nan")) -> str:
    """KITTI camera-frame box -> official label line.

    Field order: type truncated occluded alpha bbox(4) h w l x y z ry [score]
    (utils_kitti.py:379-415; like the reference, score is appended only when
    not NaN so GT and result files share one writer).
    """
    w, l, h = float(wlh[0]), float(wlh[1]), float(wlh[2])
    x, y, z = (float(v) for v in center)
    parts = [
        name,
        f"{truncation:.2f}",
        f"{int(occlusion):d}",
        f"{alpha:.2f}",
        f"{bbox_2d[0]:.2f}", f"{bbox_2d[1]:.2f}",
        f"{bbox_2d[2]:.2f}", f"{bbox_2d[3]:.2f}",
        f"{h:.2f}", f"{w:.2f}", f"{l:.2f}",
        f"{x:.2f}", f"{y:.2f}", f"{z:.2f}",
        f"{yaw:.2f}",
    ]
    line = " ".join(parts)
    if not np.isnan(score):
        line += f" {score:.4f}"
    return line


# --------------------------------------------------------------------------
# frame transforms (utils_kitti.py:120-192)
# --------------------------------------------------------------------------

def box_nuscenes_to_kitti(center, wlh, rotation,
                          velo_to_cam_rot, velo_to_cam_trans,
                          r0_rect=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """nuScenes-lidar-frame box -> KITTI camera frame.

    Mirrors `KittiDB.box_nuscenes_to_kitti` (utils_kitti.py:120-152): rotate
    into KITTI lidar, apply velo->cam, rectify, then shift the center down
    to the bottom face (+h/2 along camera Y). Returns (center, wlh, quat).
    """
    center = np.asarray(center, np.float64)
    rotation = np.asarray(rotation, np.float64)
    # nuScenes lidar -> KITTI lidar
    center = quat.rotate(KITTI_TO_NU_LIDAR_INV, center)
    rotation = quat.multiply(KITTI_TO_NU_LIDAR_INV, rotation)
    # KITTI lidar -> camera
    center = quat.rotate(velo_to_cam_rot, center) + np.asarray(
        velo_to_cam_trans, np.float64)
    rotation = quat.multiply(velo_to_cam_rot, rotation)
    if r0_rect is not None:
        center = quat.rotate(r0_rect, center)
        rotation = quat.multiply(r0_rect, rotation)
    # true center -> KITTI bottom-face center
    center = center + np.array([0.0, float(wlh[2]) / 2.0, 0.0])
    return center, np.asarray(wlh, np.float64), rotation


def box_kitti_to_nuscenes_lidar(center, wlh, rotation,
                                velo_to_cam_rot, velo_to_cam_trans,
                                r0_rect=None):
    """Inverse of :func:`box_nuscenes_to_kitti` (KITTI cam -> nuScenes lidar)."""
    center = np.asarray(center, np.float64) - np.array(
        [0.0, float(wlh[2]) / 2.0, 0.0])
    rotation = np.asarray(rotation, np.float64)
    if r0_rect is not None:
        inv = quat.inverse(r0_rect)
        center = quat.rotate(inv, center)
        rotation = quat.multiply(inv, rotation)
    inv = quat.inverse(velo_to_cam_rot)
    center = quat.rotate(inv, center - np.asarray(velo_to_cam_trans, np.float64))
    rotation = quat.multiply(inv, rotation)
    center = quat.rotate(KITTI_TO_NU_LIDAR, center)
    rotation = quat.multiply(KITTI_TO_NU_LIDAR, rotation)
    return center, np.asarray(wlh, np.float64), rotation


def box_corners_camera(center, wlh, rotation) -> np.ndarray:
    """(8, 3) corners of a KITTI-camera-frame box given its TRUE center.

    Same local corner layout the devkit `Box.corners()` uses: x along
    length, y along width, z along height, rotated by the box quaternion.
    """
    w, l, h = (float(v) for v in wlh)
    xs = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64) * (l / 2)
    ys = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64) * (w / 2)
    zs = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64) * (h / 2)
    local = np.stack([xs, ys, zs])
    return (quat.rotation_matrix(rotation) @ local
            + np.asarray(center, np.float64)[:, None]).T


def project_kitti_box_to_image(center, wlh, rotation, p_left,
                               imsize: Tuple[int, int]):
    """3D KITTI-camera box -> clipped 2D bbox, or None when out of FOV.

    `center` is the KITTI bottom-face center; like the reference
    (utils_kitti.py:154-192) the true center is recovered (-h/2 along Y),
    corners behind the camera are dropped, and the projected bbox is
    clipped to ``imsize=(width, height)``.
    """
    true_center = np.asarray(center, np.float64) - np.array(
        [0.0, float(wlh[2]) / 2.0, 0.0])
    corners = box_corners_camera(true_center, wlh, rotation)
    front = corners[corners[:, 2] > 0]
    if front.shape[0] == 0:
        return None
    p = np.asarray(p_left, np.float64)
    pts = (p[:3, :3] @ front.T) + p[:3, 3:4]
    xs, ys = pts[0] / pts[2], pts[1] / pts[2]
    x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
    width, height = imsize
    x1, y1 = max(0.0, x1), max(0.0, y1)
    x2, y2 = min(float(width), x2), min(float(height), y2)
    if x1 >= x2 or y1 >= y2:
        return None
    return (float(x1), float(y1), float(x2), float(y2))


# --------------------------------------------------------------------------
# calib files
# --------------------------------------------------------------------------

def write_calib_file(path: str, p2: np.ndarray, velo_to_cam: np.ndarray,
                     r0_rect: Optional[np.ndarray] = None) -> None:
    """KITTI calib txt: P0..P3, R0_rect, Tr_velo_to_cam, Tr_imu_to_velo
    (export_kitti.py:181-195; unused entries are zero-filled)."""
    zeros34 = np.zeros((3, 4))
    entries = [
        ("P0", zeros34), ("P1", zeros34), ("P2", np.asarray(p2)),
        ("P3", zeros34),
        ("R0_rect", np.eye(3) if r0_rect is None else np.asarray(r0_rect)),
        ("Tr_velo_to_cam", np.asarray(velo_to_cam)[:3, :4]),
        ("Tr_imu_to_velo", zeros34),
    ]
    with open(path, "w") as f:
        for key, val in entries:
            f.write(key + ": " + " ".join(f"{v:.12e}" for v in
                                          np.asarray(val).ravel()) + "\n")


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, rest = line.split(":", 1)
            vals = np.array([float(v) for v in rest.split()])
            if vals.size == 9:
                out[key] = vals.reshape(3, 3)
            elif vals.size == 12:
                out[key] = vals.reshape(3, 4)
            else:
                out[key] = vals
    return out


# --------------------------------------------------------------------------
# GT export (export_kitti.py:83-243) and result import (:271-341)
# --------------------------------------------------------------------------

def nuscenes_gt_to_kitti(dataroot: str, version: str, split: str,
                         out_dir: str, cam_channel: str = "CAM_FRONT",
                         lidar_channel: str = "LIDAR_TOP",
                         image_count: Optional[int] = None,
                         imsize: Tuple[int, int] = (1600, 900),
                         convert_lidar: bool = True) -> List[str]:
    """Export nuScenes GT to a KITTI-format directory tree.

    Writes ``{out_dir}/{split}/{label_2,calib,velodyne}/<sample_token>.*``
    plus ``ImageSets/{split}.txt`` from the raw tables (devkit-free; the
    reference's KittiConverter needs the devkit). Images are not copied —
    this framework consumes nuScenes natively; the KITTI tree exists for
    interchange with KITTI-format tools. Returns the exported tokens.
    """
    from ..data.convert_nuscenes import RawNuScenes, read_lidar_bin, scene_splits

    nusc = RawNuScenes(dataroot, version)
    split_scenes = set(scene_splits().get(split, []))
    label_dir = os.path.join(out_dir, split, "label_2")
    calib_dir = os.path.join(out_dir, split, "calib")
    velo_dir = os.path.join(out_dir, split, "velodyne")
    sets_dir = os.path.join(out_dir, "ImageSets")
    for d in (label_dir, calib_dir, velo_dir, sets_dir):
        os.makedirs(d, exist_ok=True)

    tokens: List[str] = []
    for sample in nusc.sample:
        scene = nusc.scene[sample["scene_token"]]
        if split_scenes and scene["name"] not in split_scenes:
            continue
        channels = nusc.sample_channel.get(sample["token"], {})
        if cam_channel not in channels or lidar_channel not in channels:
            continue
        if image_count is not None and len(tokens) >= image_count:
            break
        sd_cam = nusc.sd_by_token[channels[cam_channel]]
        sd_lid = nusc.sd_by_token[channels[lidar_channel]]
        cs_cam = nusc.calibrated_sensor[sd_cam["calibrated_sensor_token"]]
        cs_lid = nusc.calibrated_sensor[sd_lid["calibrated_sensor_token"]]

        # velo->cam in KITTI lidar coordinates: ego_from_lid then cam_from_ego,
        # post-composed with Rz(+90 degrees) (export_kitti.py:126-135)
        lid_to_ego = quat.transform_matrix(cs_lid["translation"],
                                           cs_lid["rotation"])
        ego_to_cam = quat.transform_matrix(cs_cam["translation"],
                                           cs_cam["rotation"], inverse_=True)
        velo_to_cam = ego_to_cam @ lid_to_ego
        velo_to_cam_kitti = velo_to_cam @ quat.transform_matrix(
            [0.0, 0.0, 0.0], KITTI_TO_NU_LIDAR)
        vc_rot_q = quat.from_rotation_matrix(velo_to_cam_kitti[:3, :3])
        vc_trans = velo_to_cam_kitti[:3, 3]

        p2 = np.zeros((3, 4))
        p2[:3, :3] = np.asarray(cs_cam["camera_intrinsic"], np.float64)

        token = sample["token"]
        write_calib_file(os.path.join(calib_dir, token + ".txt"), p2,
                         velo_to_cam_kitti)

        if convert_lidar:
            lid_path = os.path.join(nusc.dataroot, sd_lid["filename"])
            if os.path.exists(lid_path):
                pts = read_lidar_bin(lid_path)  # (N, 5) x y z intensity ring
                rot = quat.rotation_matrix(KITTI_TO_NU_LIDAR_INV)
                kitti_pts = pts[:, :4].astype(np.float32).copy()
                kitti_pts[:, :3] = (rot @ pts[:, :3].T).T.astype(np.float32)
                kitti_pts.tofile(os.path.join(velo_dir, token + ".bin"))

        # ego pose of the LIDAR keyframe: annotation boxes are global
        pose = nusc.ego_pose[sd_lid["ego_pose_token"]]
        lines = []
        for ann in nusc.anns_by_sample.get(token, []):
            cat = nusc.category[nusc.instance[ann["instance_token"]]
                                ["category_token"]]["name"]
            name = category_to_detection_name(cat)
            if name is None:
                continue
            # global -> nuScenes lidar frame
            center = np.asarray(ann["translation"], np.float64)
            rot_q = np.asarray(ann["rotation"], np.float64)
            center = quat.rotate(quat.inverse(pose["rotation"]),
                                 center - np.asarray(pose["translation"]))
            rot_q = quat.multiply(quat.inverse(pose["rotation"]), rot_q)
            center = quat.rotate(quat.inverse(cs_lid["rotation"]),
                                 center - np.asarray(cs_lid["translation"]))
            rot_q = quat.multiply(quat.inverse(cs_lid["rotation"]), rot_q)

            c_cam, wlh, q_cam = box_nuscenes_to_kitti(
                center, ann["size"], rot_q, vc_rot_q, vc_trans)
            bbox_2d = project_kitti_box_to_image(c_cam, wlh, q_cam, p2,
                                                 imsize=imsize)
            if bbox_2d is None:
                continue
            # GT lines carry NO score column (box_to_string omits it for
            # NaN): strict KITTI consumers expect 15-column GT files
            lines.append(box_to_string(
                name, c_cam, wlh, yaw_camera_from_quat(q_cam),
                bbox_2d=bbox_2d, truncation=0.0, occlusion=0))
        with open(os.path.join(label_dir, token + ".txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        tokens.append(token)

    with open(os.path.join(sets_dir, f"{split}.txt"), "w") as f:
        f.write("\n".join(tokens) + ("\n" if tokens else ""))
    return tokens


# --------------------------------------------------------------------------
# rendering (export_kitti.py:245-269, utils_kitti.py:441-552)
# --------------------------------------------------------------------------

# per-detection-class BGR colors (analogue of NuScenesExplorer.get_color)
_CLASS_COLORS = {
    "car": (80, 160, 255), "truck": (60, 120, 220), "bus": (40, 90, 200),
    "trailer": (90, 200, 250), "construction_vehicle": (0, 200, 230),
    "pedestrian": (255, 158, 0), "motorcycle": (200, 60, 255),
    "bicycle": (255, 61, 99), "traffic_cone": (0, 61, 255),
    "barrier": (112, 128, 144),
}


def _class_color(name: str):
    if name in _CLASS_COLORS:
        return _CLASS_COLORS[name]
    h = abs(hash(name))
    return (64 + h % 160, 64 + (h // 7) % 160, 64 + (h // 49) % 160)


def _label_boxes(label_path: str) -> List[dict]:
    """Parsed label lines minus DontCare/Misc (utils_kitti.py:293-294)."""
    if not os.path.exists(label_path):
        return []
    with open(label_path) as f:
        boxes = [parse_label_line(line) for line in f if line.strip()]
    return [b for b in boxes if b["name"] not in ("DontCare", "Misc")]


def render_kitti(kitti_dir: str, split: str, out_dir: Optional[str] = None,
                 tokens: Optional[List[str]] = None, render_2d: bool = False,
                 axes_limit: float = 30.0, image_count: Optional[int] = None,
                 imsize: Tuple[int, int] = (1600, 900),
                 canvas_px: int = 900) -> List[str]:
    """Render KITTI-dir samples to ``{out_dir}/{token}_{lidar,camera}.png``.

    Native cv2 analogue of ``KittiConverter.render_kitti``
    (export_kitti.py:245-269) + ``KittiDB.render_sample_data``
    (utils_kitti.py:441-552): the lidar view is a BEV scatter of the
    velodyne points in the nuScenes lidar frame (±``axes_limit`` m) with box
    footprints and heading ticks; the camera view is ``image_2/<token>.png``
    when present (else a blank ``imsize`` canvas) with either the label's 2D
    boxes (``render_2d=True``) or the 3D wireframes projected through P2.
    Returns the written paths.
    """
    from ..data.image_io import opencv

    cv2 = opencv("rendering KITTI samples")
    out_dir = out_dir or os.path.join(kitti_dir, "render")
    os.makedirs(out_dir, exist_ok=True)
    label_dir = os.path.join(kitti_dir, split, "label_2")
    calib_dir = os.path.join(kitti_dir, split, "calib")
    velo_dir = os.path.join(kitti_dir, split, "velodyne")
    image_dir = os.path.join(kitti_dir, split, "image_2")
    if tokens is None:
        sets = os.path.join(kitti_dir, "ImageSets", f"{split}.txt")
        if os.path.exists(sets):
            with open(sets) as f:
                tokens = [t.strip() for t in f if t.strip()]
        else:
            tokens = sorted(os.path.splitext(p)[0]
                            for p in os.listdir(calib_dir))
    if image_count is not None:
        tokens = tokens[:image_count]

    scale = canvas_px / (2.0 * axes_limit)

    def to_px(x: float, y: float) -> Tuple[int, int]:
        # BEV: ego at center, x (forward) up, y (left) leftward
        return (int(round(canvas_px / 2 - y * scale)),
                int(round(canvas_px / 2 - x * scale)))

    paths: List[str] = []
    for token in tokens:
        calib = read_calib_file(os.path.join(calib_dir, token + ".txt"))
        p2, vc = calib["P2"], calib["Tr_velo_to_cam"]
        vc_rot_q = quat.from_rotation_matrix(vc[:3, :3])
        vc_trans = vc[:3, 3]
        boxes = _label_boxes(os.path.join(label_dir, token + ".txt"))

        # ---- lidar BEV (utils_kitti.py:501-525) ----
        bev = np.full((canvas_px, canvas_px, 3), 24, np.uint8)
        velo_path = os.path.join(velo_dir, token + ".bin")
        if os.path.exists(velo_path):
            pts = np.fromfile(velo_path, np.float32).reshape(-1, 4)
            # KITTI lidar -> nuScenes lidar (the reference renders lidar in
            # the nuScenes frame, utils_kitti.py:505)
            xyz = (quat.rotation_matrix(KITTI_TO_NU_LIDAR) @ pts[:, :3].T).T
            keep = ((np.abs(xyz[:, 0]) < axes_limit)
                    & (np.abs(xyz[:, 1]) < axes_limit))
            inten = pts[keep, 3]
            rng = inten.max() - inten.min() if inten.size else 1.0
            shade = (80 + 175 * (inten - (inten.min() if inten.size else 0))
                     / (rng if rng > 0 else 1.0)).astype(np.uint8)
            # vectorized 2x2-dot scatter (a full sweep is ~30k points —
            # per-point cv2 calls would take seconds per frame)
            px = np.round(canvas_px / 2 - xyz[keep, 1] * scale).astype(np.int64)
            py = np.round(canvas_px / 2 - xyz[keep, 0] * scale).astype(np.int64)
            for dy in (0, 1):
                for dx in (0, 1):
                    qy = np.clip(py + dy, 0, canvas_px - 1)
                    qx = np.clip(px + dx, 0, canvas_px - 1)
                    bev[qy, qx] = shade[:, None]
        cv2.drawMarker(bev, to_px(0.0, 0.0), (255, 255, 255),
                       cv2.MARKER_TRIANGLE_UP, 12, 1)
        for b in boxes:
            q_cam = quat.from_axis_angle([0.0, 1.0, 0.0], b["yaw_camera"])
            center, wlh, q_lid = box_kitti_to_nuscenes_lidar(
                b["xyz_camera"], b["wlh"], q_cam, vc_rot_q, vc_trans)
            corners = box_corners_camera(center, wlh, q_lid)
            # bottom-face footprint ring (corner layout: 2,3 front-bottom,
            # 6,7 rear-bottom) + a heading tick to the front-face middle
            ring = [3, 2, 6, 7]
            pix = [to_px(corners[i, 0], corners[i, 1]) for i in ring]
            color = _class_color(b["name"])
            cv2.polylines(bev, [np.array(pix, np.int32)], True, color, 2)
            front = corners[[2, 3], :2].mean(0)
            cv2.line(bev, to_px(*center[:2]), to_px(*front), color, 1)
        lid_path = os.path.join(out_dir, f"{token}_lidar.png")
        cv2.imwrite(lid_path, bev)
        paths.append(lid_path)

        # ---- camera (utils_kitti.py:528-552) ----
        img_path = os.path.join(image_dir, token + ".png")
        img = cv2.imread(img_path) if os.path.exists(img_path) else None
        if img is None:
            img = np.full((imsize[1], imsize[0], 3), 40, np.uint8)
        for b in boxes:
            color = _class_color(b["name"])
            if render_2d:
                x1, y1, x2, y2 = (int(round(v)) for v in b["bbox_camera"])
                cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
                continue
            q_cam = quat.from_axis_angle([0.0, 1.0, 0.0], b["yaw_camera"])
            true_center = np.asarray(b["xyz_camera"], np.float64) - np.array(
                [0.0, b["wlh"][2] / 2.0, 0.0])
            corners = box_corners_camera(true_center, b["wlh"], q_cam)
            if (corners[:, 2] <= 0.1).any():
                continue  # BoxVisibility-style skip for behind-camera boxes
            pts3 = (p2[:3, :3] @ corners.T) + p2[:3, 3:4]
            corners_2d = (pts3[:2] / pts3[2]).T
            if (corners_2d[:, 0].max() < 0 or corners_2d[:, 1].max() < 0
                    or corners_2d[:, 0].min() >= img.shape[1]
                    or corners_2d[:, 1].min() >= img.shape[0]):
                continue
            from ..utils.visualize import draw_box_3d

            draw_box_3d(img, corners_2d, color=color)
        cam_path = os.path.join(out_dir, f"{token}_camera.png")
        cv2.imwrite(cam_path, img)
        paths.append(cam_path)
    return paths


def kitti_results_to_nuscenes(kitti_dir: str, split: str, dataroot: str,
                              version: str,
                              lidar_channel: str = "LIDAR_TOP",
                              out_path: Optional[str] = None,
                              meta: Optional[dict] = None) -> dict:
    """KITTI-format label files -> nuScenes detection submission dict.

    Counterpart of the reference's `kitti_res_to_nuscenes`
    (export_kitti.py:271-318) but emits GLOBAL-frame translations/rotations
    (the submission format's requirement) instead of lidar-frame passthrough.
    """
    from ..data.convert_nuscenes import RawNuScenes

    nusc = RawNuScenes(dataroot, version)
    label_dir = os.path.join(kitti_dir, split, "label_2")
    calib_dir = os.path.join(kitti_dir, split, "calib")
    sets = os.path.join(kitti_dir, "ImageSets", f"{split}.txt")
    if os.path.exists(sets):
        with open(sets) as f:
            tokens = [t.strip() for t in f if t.strip()]
    else:
        tokens = sorted(os.path.splitext(p)[0] for p in os.listdir(label_dir))

    results: Dict[str, List[dict]] = {}
    for token in tokens:
        calib = read_calib_file(os.path.join(calib_dir, token + ".txt"))
        vc = calib["Tr_velo_to_cam"]
        vc_rot_q = quat.from_rotation_matrix(vc[:3, :3])
        vc_trans = vc[:3, 3]
        sd_lid = nusc.sd_by_token[nusc.sample_channel[token][lidar_channel]]
        cs_lid = nusc.calibrated_sensor[sd_lid["calibrated_sensor_token"]]
        pose = nusc.ego_pose[sd_lid["ego_pose_token"]]

        items = []
        label_path = os.path.join(label_dir, token + ".txt")
        with open(label_path) as f:
            boxes = [parse_label_line(line) for line in f if line.strip()]
        for b in boxes:
            # camera yaw -> quaternion about camera Y: Ry(yaw) maps the box
            # x-axis to (cos yaw, 0, -sin yaw), the inverse of
            # yaw_camera_from_quat's yaw = -atan2(v_z, v_x) for upright boxes
            q_cam = quat.from_axis_angle([0.0, 1.0, 0.0], b["yaw_camera"])
            center, wlh, q_lid = box_kitti_to_nuscenes_lidar(
                b["xyz_camera"], b["wlh"], q_cam, vc_rot_q, vc_trans)
            # lidar -> ego -> global
            center = quat.rotate(cs_lid["rotation"], center) + np.asarray(
                cs_lid["translation"], np.float64)
            q_glob = quat.multiply(cs_lid["rotation"], q_lid)
            center = quat.rotate(pose["rotation"], center) + np.asarray(
                pose["translation"], np.float64)
            q_glob = quat.multiply(pose["rotation"], q_glob)
            items.append({
                "sample_token": token,
                "translation": [float(v) for v in center],
                "size": [float(v) for v in wlh],
                "rotation": [float(v) for v in q_glob],
                "velocity": [0.0, 0.0],
                "detection_name": b["name"],
                "detection_score": 0.0 if np.isnan(b["score"]) else b["score"],
                "attribute_name": "",
            })
        results[token] = items

    submission = {
        "meta": meta or {"use_camera": True, "use_lidar": False,
                         "use_radar": True, "use_map": False,
                         "use_external": False},
        "results": results,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(submission, f, indent=2)
    return submission
