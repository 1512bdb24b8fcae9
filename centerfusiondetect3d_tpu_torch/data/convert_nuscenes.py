"""Offline nuScenes -> converter-format dataset ETL, devkit-free.

The port's own copy of ``centerfusiondetect3d_tpu/data/convert_nuscenes.py``
(numpy and the standard library only), with the same arithmetic in the same
order and dtypes, so that it writes the JAX converter's annotations and
point-cloud files exactly. Re-design of the reference converter
(``src/convert_nuScenes.py:126-473``) directly on the raw nuScenes
relational tables (no nuscenes-devkit, no pyquaternion): per split, walks
every sample x 6 cameras, writes COCO-format ``images`` (calib,
global/velocity transform chains, pose + calibrated-sensor records) and
``annotations`` (camera-frame 3D boxes with yaw/alpha, projected amodal
centers, attributes, camera-frame velocities, truncation), aggregates
6-sweep radar per camera (with velocity vectors rotated through the
rotation-only chain) and 1-sweep lidar into per-sample pickles, and applies
the depth-ordered occlusion filter. Official scene splits ship as a JSON
resource (public nuScenes metadata, ``data/nuscenes_splits.json``).

Usage: python -m centerfusiondetect3d_tpu_torch.data.convert_nuscenes
--dataroot data/nuscenes [--splits mini_train mini_val]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..geometry.transforms3d import project_3d_points_np
from ..utils import quaternion as quat

CATS = [
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
]
CAT_IDS = {c: i + 1 for i, c in enumerate(CATS)}

# devkit category_to_detection_name mapping
DETECTION_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

ATTRIBUTE_TO_ID = {
    "": 0,
    "cycle.with_rider": 1,
    "cycle.without_rider": 2,
    "pedestrian.moving": 3,
    "pedestrian.standing": 4,
    "pedestrian.sitting_lying_down": 5,
    "vehicle.moving": 6,
    "vehicle.parked": 7,
    "vehicle.stopped": 8,
}

USED_SENSOR = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
    "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]
SENSOR_ID = {
    "CAM_FRONT": 1, "CAM_FRONT_RIGHT": 2, "CAM_BACK_RIGHT": 3, "CAM_BACK": 4,
    "CAM_BACK_LEFT": 5, "CAM_FRONT_LEFT": 6, "RADAR_FRONT": 7, "LIDAR_TOP": 8,
    "RADAR_FRONT_LEFT": 9, "RADAR_FRONT_RIGHT": 10, "RADAR_BACK_LEFT": 11,
    "RADAR_BACK_RIGHT": 12,
}
RADARS_FOR_CAMERA = {
    "CAM_FRONT_LEFT": ["RADAR_FRONT_LEFT", "RADAR_FRONT"],
    "CAM_FRONT": ["RADAR_FRONT_RIGHT", "RADAR_FRONT_LEFT", "RADAR_FRONT"],
    "CAM_FRONT_RIGHT": ["RADAR_FRONT_RIGHT", "RADAR_FRONT"],
    "CAM_BACK_LEFT": ["RADAR_BACK_LEFT", "RADAR_FRONT_LEFT"],
    "CAM_BACK": ["RADAR_BACK_RIGHT", "RADAR_BACK_LEFT"],
    "CAM_BACK_RIGHT": ["RADAR_BACK_RIGHT", "RADAR_FRONT_RIGHT"],
}
SPLIT_VERSIONS = {
    "mini_train": "v1.0-mini", "mini_val": "v1.0-mini",
    "train": "v1.0-trainval", "val": "v1.0-trainval", "test": "v1.0-test",
}

_SPLITS_JSON = os.path.join(os.path.dirname(__file__), "nuscenes_splits.json")


def scene_splits() -> Dict[str, List[str]]:
    with open(_SPLITS_JSON) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# point cloud file parsing (devkit RadarPointCloud.from_file / LidarPointCloud)
# --------------------------------------------------------------------------

_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
              ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_radar_pcd(path: str) -> np.ndarray:
    """Parse a nuScenes radar .pcd file -> (18, N) float array."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("latin-1").strip()
            key, *vals = line.split()
            header[key] = vals
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        width = int(header["WIDTH"][0])
        fmt = header["DATA"][0]
        dtype = np.dtype(
            [
                (name, _PCD_TYPES[(t, s)], c) if c > 1 else (name, _PCD_TYPES[(t, s)])
                for name, t, s, c in zip(fields, types, sizes, counts)
            ]
        )
        if fmt == "binary":
            data = np.frombuffer(f.read(dtype.itemsize * width), dtype=dtype)
        elif fmt == "ascii":
            rows = [f.readline().decode().split() for _ in range(width)]
            data = np.array([tuple(map(float, r)) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PCD data format {fmt!r}")
    return np.stack([np.asarray(data[name], np.float64) for name in fields])


def read_lidar_bin(path: str) -> np.ndarray:
    """nuScenes lidar .pcd.bin: float32 (x, y, z, intensity, ring) -> (4, N)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return scan[:, :4].T


# --------------------------------------------------------------------------
# table access
# --------------------------------------------------------------------------

class RawNuScenes:
    """Raw-table access with the reverse indexes the converter needs."""

    def __init__(self, dataroot: str, version: str):
        self.dataroot = dataroot
        self.version = version

        def load(name):
            with open(os.path.join(dataroot, version, f"{name}.json")) as f:
                return json.load(f)

        self.sample = load("sample")
        self.sample_by_token = {s["token"]: s for s in self.sample}
        self.scene = {s["token"]: s for s in load("scene")}
        self.sample_data = load("sample_data")
        self.sd_by_token = {s["token"]: s for s in self.sample_data}
        self.ego_pose = {p["token"]: p for p in load("ego_pose")}
        self.calibrated_sensor = {c["token"]: c for c in load("calibrated_sensor")}
        self.sensor = {s["token"]: s for s in load("sensor")}
        try:
            self.annotations = load("sample_annotation")
        except FileNotFoundError:  # test split has no annotations
            self.annotations = []
        self.ann_by_token = {a["token"]: a for a in self.annotations}
        self.anns_by_sample: Dict[str, List[dict]] = {}
        for a in self.annotations:
            self.anns_by_sample.setdefault(a["sample_token"], []).append(a)
        self.instance = {i["token"]: i for i in load("instance")} if self.annotations else {}
        self.category = {c["token"]: c for c in load("category")}
        self.attribute = {a["token"]: a for a in load("attribute")}
        # sample -> {channel: sample_data token} for keyframes
        self.sample_channel: Dict[str, Dict[str, str]] = {}
        for sd in self.sample_data:
            if not sd.get("is_key_frame"):
                continue
            cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
            channel = self.sensor[cs["sensor_token"]]["channel"]
            self.sample_channel.setdefault(sd["sample_token"], {})[channel] = sd["token"]

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
        current = self.ann_by_token[ann_token]
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not (has_prev or has_next):
            return np.full(3, np.nan)
        first = self.ann_by_token[current["prev"]] if has_prev else current
        last = self.ann_by_token[current["next"]] if has_next else current
        t0 = 1e-6 * self.sample_by_token[first["sample_token"]]["timestamp"]
        t1 = 1e-6 * self.sample_by_token[last["sample_token"]]["timestamp"]
        if t1 - t0 > max_time_diff or t1 == t0:
            return np.full(3, np.nan)
        return (
            np.asarray(last["translation"]) - np.asarray(first["translation"])
        ) / (t1 - t0)


# --------------------------------------------------------------------------
# geometry helpers
# --------------------------------------------------------------------------

def _rot_y2alpha(yaw: float, x: float, cx: float, fx: float) -> float:
    alpha = yaw - np.arctan2(x - cx, fx)
    if alpha > np.pi:
        alpha -= 2 * np.pi
    if alpha < -np.pi:
        alpha += 2 * np.pi
    return float(alpha)


def box_to_camera(ann: dict, pose: dict, cs: dict):
    """Global box -> camera frame: (center xyz, wlh, yaw, corners_cam)."""
    center = np.asarray(ann["translation"], np.float64)
    wlh = np.asarray(ann["size"], np.float64)  # (w, l, h)
    q = np.asarray(ann["rotation"], np.float64)

    # global -> ego -> camera
    center = quat.rotate(quat.inverse(pose["rotation"]),
                         center - np.asarray(pose["translation"]))
    q = quat.multiply(quat.inverse(pose["rotation"]), q)
    center = quat.rotate(quat.inverse(cs["rotation"]),
                         center - np.asarray(cs["translation"]))
    q = quat.multiply(quat.inverse(cs["rotation"]), q)

    # yaw around camera Y: heading of the box x-axis in the xz plane
    v = quat.rotate(q, [1.0, 0.0, 0.0])
    yaw = -np.arctan2(v[2], v[0])

    # corners in camera frame: box axes from the quaternion
    w, l, h = wlh
    x_signs = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * (l / 2)
    y_signs = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2)
    z_signs = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (h / 2)
    corners_local = np.stack([x_signs, y_signs, z_signs])  # (3, 8)
    corners = quat.rotation_matrix(q) @ corners_local + center[:, None]
    return center, wlh, float(yaw), corners.T  # corners (8, 3)


def corners_in_image(corners, intrinsic, width, height, min_z=0.1):
    """Projected corner bbox clipped to the image; None if all behind camera."""
    z = corners[:, 2]
    if np.all(z < min_z):
        return None, 0
    safe = corners.copy()
    safe[:, 2] = np.maximum(z, min_z)
    proj = (intrinsic @ safe.T) / safe[:, 2]
    xs, ys = proj[0], proj[1]
    visible = (
        (z > min_z) & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    ).sum()
    x1, y1 = np.clip(xs.min(), 0, width - 1), np.clip(ys.min(), 0, height - 1)
    x2, y2 = np.clip(xs.max(), 0, width - 1), np.clip(ys.max(), 0, height - 1)
    if x2 <= x1 or y2 <= y1:
        return None, 0
    return [float(x1), float(y1), float(x2), float(y2)], int(visible)


def _bbox_inside(box1, box2) -> bool:
    """box1 fully inside box2 (xywh) (convert_nuScenes.py:104-110)."""
    return (
        box1[0] > box2[0]
        and box1[0] + box1[2] < box2[0] + box2[2]
        and box1[1] > box2[1]
        and box1[1] + box1[3] < box2[1] + box2[3]
    )


# --------------------------------------------------------------------------
# radar aggregation
# --------------------------------------------------------------------------

def aggregate_radar(nusc: RawNuScenes, sample: dict, radar_channel: str,
                    ref_channel: str, nsweeps: int = 6,
                    min_distance: float = 1.0) -> np.ndarray:
    """Multisweep radar -> reference camera frame, velocities rotated
    (utils/pointcloud.py:54-192)."""
    ref_sd = nusc.sd_by_token[nusc.sample_channel[sample["token"]][ref_channel]]
    ref_cs = nusc.calibrated_sensor[ref_sd["calibrated_sensor_token"]]
    ref_pose = nusc.ego_pose[ref_sd["ego_pose_token"]]

    ref_from_car = quat.transform_matrix(ref_cs["translation"], ref_cs["rotation"], True)
    ref_from_car_rot = quat.transform_matrix([0, 0, 0], ref_cs["rotation"], True)
    car_from_global = quat.transform_matrix(ref_pose["translation"], ref_pose["rotation"], True)
    car_from_global_rot = quat.transform_matrix([0, 0, 0], ref_pose["rotation"], True)

    token = nusc.sample_channel[sample["token"]].get(radar_channel)
    if token is None:
        return np.zeros((18, 0))
    sd = nusc.sd_by_token[token]
    points_all = []
    for _ in range(nsweeps):
        path = os.path.join(nusc.dataroot, sd["filename"])
        if os.path.exists(path):
            pts = read_radar_pcd(path)
            # devkit remove_close is an axis-aligned BOX, not a radial disk:
            # a point is dropped only when BOTH |x| and |y| are under the
            # threshold (data_classes.PointCloud.remove_close; golden-pinned
            # by tests/fixtures/multisweep.npz)
            close = (np.abs(pts[0]) < min_distance) & (
                np.abs(pts[1]) < min_distance)
            pts = pts[:, ~close]

            pose = nusc.ego_pose[sd["ego_pose_token"]]
            cs = nusc.calibrated_sensor[sd["calibrated_sensor_token"]]
            global_from_car = quat.transform_matrix(pose["translation"], pose["rotation"], False)
            global_from_car_rot = quat.transform_matrix([0, 0, 0], pose["rotation"], False)
            car_from_current = quat.transform_matrix(cs["translation"], cs["rotation"], False)
            car_from_current_rot = quat.transform_matrix([0, 0, 0], cs["rotation"], False)

            tm = ref_from_car @ car_from_global @ global_from_car @ car_from_current
            vel_tm = (ref_from_car_rot @ car_from_global_rot
                      @ global_from_car_rot @ car_from_current_rot)

            xyz1 = np.vstack([pts[:3], np.ones((1, pts.shape[1]))])
            pts[:3] = (tm @ xyz1)[:3]
            # rotate compensated velocities (rows 8, 9) through the
            # rotation-only chain; camera frame keeps (x, z)
            n = pts.shape[1]
            v = np.vstack([pts[8:10], np.zeros((1, n)), np.ones((1, n))])
            v = vel_tm @ v
            pts[8] = v[0]
            pts[9] = v[2]
            points_all.append(pts)
        if sd["prev"] == "":
            break
        sd = nusc.sd_by_token[sd["prev"]]
    if not points_all:
        return np.zeros((18, 0))
    return np.concatenate(points_all, axis=1)


def lidar_to_image(nusc: RawNuScenes, sample: dict, ref_channel: str,
                   intrinsic: np.ndarray, width: int, height: int) -> np.ndarray:
    """1-sweep lidar projected to the reference camera image -> (3, N) [x,y,d]."""
    lt = nusc.sample_channel[sample["token"]].get("LIDAR_TOP")
    ct = nusc.sample_channel[sample["token"]].get(ref_channel)
    if lt is None or ct is None:
        return np.zeros((3, 0))
    lsd, csd = nusc.sd_by_token[lt], nusc.sd_by_token[ct]
    path = os.path.join(nusc.dataroot, lsd["filename"])
    if not os.path.exists(path):
        return np.zeros((3, 0))
    pts = read_lidar_bin(path)[:3]

    lcs = nusc.calibrated_sensor[lsd["calibrated_sensor_token"]]
    lpose = nusc.ego_pose[lsd["ego_pose_token"]]
    ccs = nusc.calibrated_sensor[csd["calibrated_sensor_token"]]
    cpose = nusc.ego_pose[csd["ego_pose_token"]]
    tm = (
        quat.transform_matrix(ccs["translation"], ccs["rotation"], True)
        @ quat.transform_matrix(cpose["translation"], cpose["rotation"], True)
        @ quat.transform_matrix(lpose["translation"], lpose["rotation"], False)
        @ quat.transform_matrix(lcs["translation"], lcs["rotation"], False)
    )
    xyz1 = np.vstack([pts, np.ones((1, pts.shape[1]))])
    cam = (tm @ xyz1)[:3]
    z = cam[2]
    keep = z > 0.1
    cam = cam[:, keep]
    proj = (intrinsic @ cam) / cam[2]
    inside = (proj[0] > 1) & (proj[0] < width - 1) & (proj[1] > 1) & (proj[1] < height - 1)
    out = np.vstack([proj[:2, inside], cam[2, inside][None]])
    return out


# --------------------------------------------------------------------------
# main export
# --------------------------------------------------------------------------

def export_split(dataroot: str, split: str, out_dir: Optional[str] = None,
                 nsweeps: int = 6, verbose: bool = True) -> str:
    version = SPLIT_VERSIONS[split]
    nusc = RawNuScenes(dataroot, version)
    out_dir = out_dir or os.path.join(dataroot, "annotations")
    os.makedirs(out_dir, exist_ok=True)
    radar_dir = os.path.join(out_dir, "radar_pc")
    lidar_dir = os.path.join(out_dir, "lidar_pc")
    for cam in USED_SENSOR:
        os.makedirs(os.path.join(radar_dir, cam), exist_ok=True)
        os.makedirs(os.path.join(lidar_dir, cam), exist_ok=True)

    splits = scene_splits()
    ret = {
        "images": [], "annotations": [],
        "categories": [{"name": c, "id": i + 1} for i, c in enumerate(CATS)],
        "videos": [], "attributes": ATTRIBUTE_TO_ID, "pointclouds": [],
    }
    num_images = num_anns = num_videos = 0
    track_ids: Dict[str, int] = {}

    for sample in nusc.sample:
        scene_name = nusc.scene[sample["scene_token"]]["name"]
        if split != "test" and scene_name not in splits.get(split, []):
            continue
        if sample["prev"] == "":
            num_videos += 1
            ret["videos"].append({"id": num_videos, "file_name": scene_name})
            track_ids = {}

        for sensor_name in USED_SENSOR:
            sd_token = nusc.sample_channel[sample["token"]].get(sensor_name)
            if sd_token is None:
                continue
            sd = nusc.sd_by_token[sd_token]
            num_images += 1
            prev_id = num_images if sample["prev"] == "" else num_images - len(USED_SENSOR)

            cs = nusc.calibrated_sensor[sd["calibrated_sensor_token"]]
            pose = nusc.ego_pose[sd["ego_pose_token"]]
            intrinsic = np.asarray(cs["camera_intrinsic"], np.float64)
            calib = np.zeros((3, 4))
            calib[:3, :3] = intrinsic

            trans_matrix = (
                quat.transform_matrix(pose["translation"], pose["rotation"], False)
                @ quat.transform_matrix(cs["translation"], cs["rotation"], False)
            )
            velocity_trans_matrix = (
                quat.transform_matrix([0, 0, 0], pose["rotation"], False)
                @ quat.transform_matrix([0, 0, 0], cs["rotation"], False)
            )

            image_info = {
                "id": num_images,
                "prev_id": prev_id,
                "file_name": sd["filename"],
                "calib": calib.tolist(),
                "video_id": num_videos,
                "frame_id": sample["token"],
                "sensor_id": SENSOR_ID[sensor_name],
                "sample_token": sample["token"],
                "trans_matrix": trans_matrix.tolist(),
                "velocity_trans_matrix": velocity_trans_matrix.tolist(),
                "width": sd["width"],
                "height": sd["height"],
                "pose_record_trans": pose["translation"],
                "pose_record_rot": pose["rotation"],
                "cs_record_trans": cs["translation"],
                "cs_record_rot": cs["rotation"],
                "camera_intrinsic": intrinsic.tolist(),
            }
            ret["images"].append(image_info)

            # --- radar + lidar pickles
            radar_pts = np.zeros((18, 0))
            for radar_channel in RADARS_FOR_CAMERA[sensor_name]:
                pts = aggregate_radar(nusc, sample, radar_channel, sensor_name, nsweeps)
                radar_pts = np.concatenate([radar_pts, pts], axis=1)
            with open(os.path.join(radar_dir, sensor_name, f"{sample['token']}.bin"), "wb") as f:
                pickle.dump(radar_pts.tolist(), f)
            lidar_pts = lidar_to_image(
                nusc, sample, sensor_name, intrinsic, sd["width"], sd["height"]
            )
            with open(os.path.join(lidar_dir, sensor_name, f"{sample['token']}.bin"), "wb") as f:
                pickle.dump(lidar_pts.tolist(), f)

            # --- annotations
            anns: List[dict] = []
            for a in nusc.anns_by_sample.get(sample["token"], []):
                inst = nusc.instance.get(a["instance_token"], {})
                cat_name = nusc.category.get(inst.get("category_token", ""), {}).get("name", "")
                det_name = DETECTION_MAPPING.get(cat_name)
                if det_name is None:
                    continue
                center, wlh, yaw, corners = box_to_camera(a, pose, cs)
                bbox_xyxy, n_visible = corners_in_image(
                    corners, intrinsic, sd["width"], sd["height"]
                )
                if bbox_xyxy is None or n_visible == 0:
                    continue
                num_anns += 1
                w, l, h = wlh
                # location convention: bottom center (y down, +h/2)
                location = [center[0], center[1] + h / 2, center[2]]
                amodal = project_3d_points_np(
                    np.asarray(center, np.float32).reshape(1, 1, 1, 3),
                    calib.reshape(1, 1, 3, 4).astype(np.float32),
                )[0, 0, 0].tolist()
                if a["instance_token"] not in track_ids:
                    track_ids[a["instance_token"]] = len(track_ids) + 1
                att_names = [
                    nusc.attribute[t]["name"] for t in a.get("attribute_tokens", [])
                ]
                att = att_names[0] if att_names else ""
                vel = nusc.box_velocity(a["token"])
                vel_list = vel.tolist()
                vel_cam = (
                    np.linalg.inv(velocity_trans_matrix)
                    @ np.array([*np.nan_to_num(vel), 0.0])
                ).tolist()
                cx = (bbox_xyxy[0] + bbox_xyxy[2]) / 2
                ann = {
                    "id": num_anns,
                    "image_id": num_images,
                    "category_id": CAT_IDS[det_name],
                    "dimension": [h, w, l],
                    "location": location,
                    "depth": location[2],
                    "occluded": (4 - int(a.get("visibility_token", 4))) / 4,
                    "yaw": yaw,
                    "amodal_center": amodal,
                    "track_id": track_ids[a["instance_token"]],
                    "attributes": ATTRIBUTE_TO_ID.get(att, 0),
                    "velocity": vel_list,
                    "velocity_cam": vel_cam,
                    "truncated": int(
                        amodal[0] < 0 or amodal[0] >= sd["width"]
                        or amodal[1] < 0 or amodal[1] >= sd["height"]
                    ),
                    "bbox": [
                        bbox_xyxy[0], bbox_xyxy[1],
                        bbox_xyxy[2] - bbox_xyxy[0], bbox_xyxy[3] - bbox_xyxy[1],
                    ],
                    "area": (bbox_xyxy[2] - bbox_xyxy[0]) * (bbox_xyxy[3] - bbox_xyxy[1]),
                    "alpha": _rot_y2alpha(yaw, cx, intrinsic[0, 2], intrinsic[0, 0]),
                }
                anns.append(ann)

            # occlusion filter (convert_nuScenes.py:345-358)
            for i in range(len(anns)):
                occluded = False
                for j in range(len(anns)):
                    if (
                        anns[i]["depth"] - min(anns[i]["dimension"]) / 2
                        > anns[j]["depth"] + max(anns[j]["dimension"]) / 2
                        and _bbox_inside(anns[i]["bbox"], anns[j]["bbox"])
                    ):
                        occluded = True
                        break
                if not occluded:
                    ret["annotations"].append(anns[i])

    # re-order images by (video, sensor) for sequential readers
    by_key: Dict[tuple, List[dict]] = {}
    for img in ret["images"]:
        by_key.setdefault((img["video_id"], img["sensor_id"]), []).append(img)
    ret["images"] = [img for key in sorted(by_key) for img in by_key[key]]

    out_path = os.path.join(out_dir, f"{split}.json")
    with open(out_path, "w") as f:
        json.dump(ret, f)
    if verbose:
        print(
            f"{split}: {len(ret['images'])} images, {len(ret['annotations'])} annotations -> {out_path}"
        )
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="nuScenes -> COCO-format converter")
    p.add_argument("--dataroot", default="data/nuscenes")
    p.add_argument("--splits", nargs="*", default=["mini_train", "mini_val"])
    p.add_argument("--nsweeps", type=int, default=6)
    args = p.parse_args(argv)
    for split in args.splits:
        export_split(args.dataroot, split, nsweeps=args.nsweeps)


if __name__ == "__main__":
    main()
