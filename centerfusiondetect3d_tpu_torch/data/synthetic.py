"""Synthetic dataset generators (host numpy), devkit-free.

The port's own copy of ``centerfusiondetect3d_tpu/data/synthetic.py``: the
same draws from the same seeds, so that both packages write the same
tables and files. opencv (through ``data/image_io.py:opencv``) is imported
by the functions that render frames and write JPEGs, when they are called.

- ``make_synthetic_nuscenes``: CONVERTER-OUTPUT format (COCO json +
  radar/lidar pickles, the schema of the reference's convert_nuScenes.py
  output), read by ``data/dataset.py`` directly;
- ``make_synthetic_raw_tables``: RAW-TABLE format (v1.0-mini json tables,
  camera JPEGs, radar PCD sweeps, lidar bins), read by the converter
  (``data/convert_nuscenes.py``); one scene per requested split, one car
  per sample with a radar return on it, so that converter -> dataset ->
  train -> val -> NDS runs with no external data (``tools rehearse``);
- ``make_campaign_tables``: raw tables of a learnable world (several
  objects a frame, rendered, with real CAM_FRONT extrinsics), the
  generator of ``output/campaign_r5/data``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np

from .image_io import opencv

# one car per sample, camera frame (x right, y down, z forward); identity
# sensor/ego transforms make radar-sensor == camera == global frames.
CAR_XYZ = (2.0, 0.5, 10.0)
CAR_WLH = (1.9, 4.5, 1.6)

PCD_FIELDS = (
    "x y z dyn_prop id rcs vx vy vx_comp vy_comp is_quality_valid "
    "ambig_state x_rms y_rms invalid_state pdh0 vx_rms vy_rms"
)


def write_radar_pcd(path, points) -> None:
    """nuScenes-style 18-field radar PCD (ascii). points: (N, 18)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = "\n".join(
        [
            "# .PCD v0.7 - Point Cloud Data file format",
            "VERSION 0.7",
            f"FIELDS {PCD_FIELDS}",
            "SIZE " + " ".join(["4"] * 18),
            "TYPE " + " ".join(["F"] * 18),
            "COUNT " + " ".join(["1"] * 18),
            f"WIDTH {n}",
            "HEIGHT 1",
            "VIEWPOINT 0 0 0 1 0 0 0",
            f"POINTS {n}",
            "DATA ascii",
        ]
    )
    rows = "\n".join(" ".join(f"{v:.6f}" for v in row) for row in points)
    with open(path, "wb") as f:
        f.write((header + "\n" + rows + "\n").encode())


def radar_point(x, y, z, vx_comp=4.0, vy_comp=0.5):
    row = np.zeros(18, np.float32)
    row[:3] = (x, y, z)
    row[8], row[9] = vx_comp, vy_comp
    return row


def make_synthetic_raw_tables(root: str,
                            splits: Dict[str, int] | None = None,
                            seed: int = 3) -> str:
    """Write synthetic raw tables under ``root`` for the given
    ``{split: n_samples}`` map (default ``{"mini_val": 3}``).

    One scene per split (named from ``scene_splits()`` so the converter's
    split filter picks it up). The first scene keeps the bare sa{i}/sd_*
    token names the flagship e2e fixtures assert on; later scenes prefix
    tokens with the scene index. Returns ``root``.
    """
    from .convert_nuscenes import scene_splits

    cv2 = opencv("writing the synthetic tables' JPEGs")
    splits = dict(splits or {"mini_val": 3})
    version = os.path.join(root, "v1.0-mini")
    os.makedirs(version, exist_ok=True)

    def w(name, obj):
        with open(os.path.join(version, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    all_splits = scene_splits()
    scenes, samples, sample_data, annotations = [], [], [], []
    cam_dir = os.path.join(root, "samples", "CAM_FRONT")
    rad_dir = os.path.join(root, "samples", "RADAR_FRONT")
    lid_dir = os.path.join(root, "samples", "LIDAR_TOP")
    for d in (cam_dir, rad_dir, lid_dir):
        os.makedirs(d, exist_ok=True)

    rng = np.random.RandomState(seed)
    for k, (split, n_samples) in enumerate(splits.items()):
        pfx = "" if k == 0 else f"s{k}"
        scene_name = all_splits[split][0]
        scenes.append({"token": f"{pfx}sc0", "name": scene_name,
                       "description": "rain"})
        for i in range(n_samples):
            samples.append(
                {
                    "token": f"{pfx}sa{i}",
                    "scene_token": f"{pfx}sc0",
                    "timestamp": 1_000_000 + 500_000 * i + 10_000_000 * k,
                    "prev": f"{pfx}sa{i - 1}" if i else "",
                    "next": f"{pfx}sa{i + 1}" if i < n_samples - 1 else "",
                }
            )
            sample_data += [
                {"token": f"{pfx}sd_cam{i}", "sample_token": f"{pfx}sa{i}",
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_cam",
                 "is_key_frame": True,
                 "filename": f"samples/CAM_FRONT/{pfx}img{i}.jpg",
                 "width": 400, "height": 300, "prev": "", "next": ""},
                {"token": f"{pfx}sd_rad{i}", "sample_token": f"{pfx}sa{i}",
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_rad",
                 "is_key_frame": True,
                 "filename": f"samples/RADAR_FRONT/{pfx}r{i}.pcd",
                 "width": 0, "height": 0, "prev": "", "next": ""},
                {"token": f"{pfx}sd_lid{i}", "sample_token": f"{pfx}sa{i}",
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_lid",
                 "is_key_frame": True,
                 "filename": f"samples/LIDAR_TOP/{pfx}l{i}.pcd.bin",
                 "width": 0, "height": 0, "prev": "", "next": ""},
            ]
            annotations.append(
                {"token": f"{pfx}an{i}", "sample_token": f"{pfx}sa{i}",
                 "instance_token": f"{pfx}in0", "translation": list(CAR_XYZ),
                 "size": list(CAR_WLH), "rotation": [1, 0, 0, 0],
                 "attribute_tokens": ["at_mv"], "prev": "", "next": "",
                 "visibility_token": "4", "num_lidar_pts": 12,
                 "num_radar_pts": 3},
            )
            img = (rng.rand(300, 400, 3) * 40).astype(np.uint8)
            cv2.imwrite(os.path.join(cam_dir, f"{pfx}img{i}.jpg"), img)
            # a radar return on the car plus one clutter point; the
            # min-distance filter needs |(x, y)| >= 1 in the radar frame
            write_radar_pcd(
                os.path.join(rad_dir, f"{pfx}r{i}.pcd"),
                [radar_point(*CAR_XYZ),
                 radar_point(-3.0, 0.2, 22.0, 0.0, 0.0)],
            )
            lidar = np.zeros((8, 5), np.float32)
            lidar[:, 0] = CAR_XYZ[0] + rng.randn(8) * 0.3
            lidar[:, 1] = CAR_XYZ[1]
            lidar[:, 2] = CAR_XYZ[2] + rng.randn(8) * 0.5
            lidar.tofile(os.path.join(lid_dir, f"{pfx}l{i}.pcd.bin"))

    w("scene", scenes)
    w("sample", samples)
    w("sensor", [
        {"token": "se_cam", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "se_rad", "channel": "RADAR_FRONT", "modality": "radar"},
        {"token": "se_lid", "channel": "LIDAR_TOP", "modality": "lidar"},
    ])
    w("calibrated_sensor", [
        {"token": "cs_cam", "sensor_token": "se_cam",
         "translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
         "camera_intrinsic": [[400.0, 0, 200.0], [0, 400.0, 150.0],
                              [0, 0, 1]]},
        {"token": "cs_rad", "sensor_token": "se_rad",
         "translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
         "camera_intrinsic": []},
        {"token": "cs_lid", "sensor_token": "se_lid",
         "translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
         "camera_intrinsic": []},
    ])
    w("ego_pose", [{"token": "ep0", "translation": [0, 0, 0],
                    "rotation": [1, 0, 0, 0]}])
    w("sample_data", sample_data)
    w("sample_annotation", annotations)
    w("category", [{"token": "cat_car", "name": "vehicle.car"}])
    w("instance", [{"token": f"s{k}in0" if k else "in0",
                    "category_token": "cat_car"}
                   for k in range(len(splits))])
    w("attribute", [{"token": "at_mv", "name": "vehicle.moving"}])
    return root


# --------------------------------------------------------------------------
# campaign tables: a LEARNABLE synthetic world for from-scratch training
# --------------------------------------------------------------------------

# camera->ego rotation of a real nuScenes CAM_FRONT (cam x right -> ego -y,
# cam y down -> ego -z, cam z fwd -> ego x); using the true extrinsic keeps
# global x = depth so the eval's BEV center_distance (evaluation/algo.py:22)
# actually prices depth errors, unlike the identity-frame smoke tables above.
CAM_FRONT_ROT = (0.5, -0.5, 0.5, -0.5)
CAM_HEIGHT = 1.5

# (category name, (w, l, h) meters, BGR render color, depth range)
CAMPAIGN_CLASSES = (
    ("vehicle.car", (1.9, 4.5, 1.6), (40, 40, 200), (8.0, 35.0)),
    ("vehicle.truck", (2.5, 8.0, 3.0), (200, 80, 40), (10.0, 35.0)),
    ("human.pedestrian.adult", (0.7, 0.7, 1.75), (40, 180, 40), (6.0, 18.0)),
)


def _campaign_spawn(rng):
    """One persistent world object: class/pose/size/yaw plus a constant
    global velocity so linked annotations yield real (nonzero) GT velocity
    and the radar's compensated-velocity channels carry matching signal."""
    ci = int(rng.choice(len(CAMPAIGN_CLASSES), p=[0.6, 0.25, 0.15]))
    name, wlh0, _, (d_lo, d_hi) = CAMPAIGN_CLASSES[ci]
    wlh = np.asarray(wlh0) * rng.uniform(0.9, 1.1, 3)
    depth = rng.uniform(d_lo, d_hi)
    lat = rng.uniform(-0.4, 0.4) * depth  # stays inside the ~58 deg FOV
    yaw = rng.uniform(-np.pi, np.pi)
    v_max = 1.5 if name.startswith("human") else 8.0
    vel = np.array([rng.uniform(-v_max, v_max),
                    rng.uniform(-v_max, v_max), 0.0])
    # global/ego frame: x fwd (= camera depth), y left, z up, ground z=0
    return {"ci": ci, "xyz": np.array([depth, -lat, wlh[2] / 2]),
            "wlh": wlh, "yaw": yaw, "vel": vel, "prev_ann": "", "age": 0}


def _campaign_in_view(o):
    d = o["xyz"][0]
    return 5.0 <= d <= 42.0 and abs(o["xyz"][1]) <= 0.42 * d


def _campaign_corners_global(xyz, wlh, yaw):
    """(8, 3) global-frame box corners, yaw about global z, x-axis = length."""
    w, l, h = wlh
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    x = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * (l / 2)
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2)
    z = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (h / 2)
    return (rot @ np.stack([x, y, z])).T + xyz


def _campaign_render(objs, intrinsic, wh, rng):
    """Paint the frame: gradient sky/ground + textured noise + per-object
    filled corner hulls (color keyed to category, shaded by depth) so the
    camera branch carries real signal for heatmap/size/depth learning."""
    from ..utils import quaternion as quat

    cv2 = opencv("rendering the campaign's frames")

    w, h = wh
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    base = (np.array([[170, 150, 120]], np.float32) * (1 - yy)
            + np.array([[90, 95, 100]], np.float32) * yy)
    img = np.broadcast_to(base, (h, w, 3)).copy()
    img += cv2.GaussianBlur((rng.rand(h, w, 3) * 70).astype(np.float32),
                            (0, 0), 2) - 35
    img = np.clip(img, 0, 255).astype(np.uint8)

    r_inv = quat.rotation_matrix(quat.inverse(CAM_FRONT_ROT))
    t = np.array([0.0, 0.0, CAM_HEIGHT])
    for ci, xyz, wlh, yaw in objs:
        color = CAMPAIGN_CLASSES[ci][2]
        corners = _campaign_corners_global(xyz, wlh, yaw)
        cam = (r_inv @ (corners - t).T)  # (3, 8) camera frame
        if np.any(cam[2] < 0.5):
            continue
        proj = (intrinsic @ cam) / cam[2]
        pts = np.round(proj[:2].T).astype(np.int32)
        hull = cv2.convexHull(pts)
        shade = float(np.clip(1.2 - xyz[0] / 45.0, 0.45, 1.1))
        col = tuple(int(np.clip(c * shade * rng.uniform(0.9, 1.1), 0, 255))
                    for c in color)
        cv2.fillConvexPoly(img, hull, col)
        cv2.polylines(img, [hull], True,
                      tuple(int(c * 0.5) for c in col), 1)
    return img


def make_campaign_tables(root: str, splits: Dict[str, int] | None = None,
                         seed: int = 7, img_wh=(448, 256)) -> str:
    """Raw v1.0-mini tables for the from-scratch training campaign
    (``output/campaign_r5``): multi-object frames with rendered geometry,
    real CAM_FRONT extrinsics, per-object radar returns and clutter.

    Unlike ``make_synthetic_raw_tables`` (minimal fixed-pose smoke data,
    kept verbatim for the e2e fixtures), every frame here varies object
    class/pose/size/yaw and the imagery actually shows the objects, so a
    detector trained on the ``mini_train`` split must learn real
    appearance->geometry mappings to score on the held-out ``mini_val``
    split. Reference contract being rehearsed: src/main.py:106-124.
    """
    from .convert_nuscenes import scene_splits

    cv2 = opencv("writing the campaign's JPEGs")
    splits = dict(splits or {"mini_train": 400, "mini_val": 100})
    version = os.path.join(root, "v1.0-mini")
    os.makedirs(version, exist_ok=True)
    w, h = img_wh
    fx = 400.0
    intrinsic = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])

    def dump(name, obj):
        with open(os.path.join(version, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    all_splits = scene_splits()
    scenes, samples, sample_data, annotations, instances = [], [], [], [], []
    cam_dir = os.path.join(root, "samples", "CAM_FRONT")
    rad_dir = os.path.join(root, "samples", "RADAR_FRONT")
    lid_dir = os.path.join(root, "samples", "LIDAR_TOP")
    for d in (cam_dir, rad_dir, lid_dir):
        os.makedirs(d, exist_ok=True)

    rng = np.random.RandomState(seed)
    ann_ct = 0
    ann_by_token: Dict[str, dict] = {}
    dt = 0.5  # seconds between samples (timestamps below)
    for k, (split, n_samples) in enumerate(splits.items()):
        pfx = f"c{k}"
        scenes.append({"token": f"{pfx}sc0", "name": all_splits[split][0],
                       "description": "campaign"})
        active: list = []
        for i in range(n_samples):
            tok = f"{pfx}sa{i}"
            # world step: move, cull (out of view / aged out), respawn
            for o in active:
                o["xyz"] = o["xyz"] + o["vel"] * dt
                o["age"] += 1
            active = [o for o in active
                      if _campaign_in_view(o) and o["age"] < 6]
            want = rng.randint(1, 5)
            while len(active) < want:
                o = _campaign_spawn(rng)
                if _campaign_in_view(o):
                    o["inst"] = f"{pfx}ob{len(instances)}"
                    instances.append({"token": o["inst"],
                                      "category_token": f"cat{o['ci']}"})
                    active.append(o)
            # far-to-near so the near object overdraws (painter's occlusion)
            active.sort(key=lambda o: -o["xyz"][0])
            samples.append({
                "token": tok, "scene_token": f"{pfx}sc0",
                "timestamp": 1_000_000 + 500_000 * i + 10 ** 9 * k,
                "prev": f"{pfx}sa{i - 1}" if i else "",
                "next": f"{pfx}sa{i + 1}" if i < n_samples - 1 else "",
            })
            sample_data += [
                {"token": f"{pfx}sdc{i}", "sample_token": tok,
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_cam",
                 "is_key_frame": True,
                 "filename": f"samples/CAM_FRONT/{pfx}img{i}.jpg",
                 "width": w, "height": h, "prev": "", "next": ""},
                {"token": f"{pfx}sdr{i}", "sample_token": tok,
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_rad",
                 "is_key_frame": True,
                 "filename": f"samples/RADAR_FRONT/{pfx}r{i}.pcd",
                 "width": 0, "height": 0, "prev": "", "next": ""},
                {"token": f"{pfx}sdl{i}", "sample_token": tok,
                 "ego_pose_token": "ep0", "calibrated_sensor_token": "cs_lid",
                 "is_key_frame": True,
                 "filename": f"samples/LIDAR_TOP/{pfx}l{i}.pcd.bin",
                 "width": 0, "height": 0, "prev": "", "next": ""},
            ]
            radar_rows, lidar_rows = [], []
            for o in active:
                ci, xyz, wlh, yaw = o["ci"], o["xyz"], o["wlh"], o["yaw"]
                name = CAMPAIGN_CLASSES[ci][0]
                ann_ct += 1
                ann_tok = f"{pfx}an{ann_ct}"
                attr = ("at_pm" if name.startswith("human") else "at_vm")
                c, s = np.cos(yaw / 2), np.sin(yaw / 2)
                ann = {
                    "token": ann_tok, "sample_token": tok,
                    "instance_token": o["inst"],
                    "translation": [float(v) for v in xyz],
                    "size": [float(v) for v in wlh],
                    "rotation": [float(c), 0.0, 0.0, float(s)],
                    "attribute_tokens": [attr],
                    "prev": o["prev_ann"], "next": "",
                    "visibility_token": "4", "num_lidar_pts": 8,
                    "num_radar_pts": 2,
                }
                if o["prev_ann"]:
                    # link the chain so box_velocity derives the true
                    # (finite-difference == constant) velocity
                    ann_by_token[o["prev_ann"]]["next"] = ann_tok
                annotations.append(ann)
                ann_by_token[ann_tok] = ann
                o["prev_ann"] = ann_tok
                # radar return near the object's near face + slight noise,
                # compensated velocity = the object's true global (vx, vy).
                # Points are written in the SENSOR frames (identity
                # rotation, mounted 0.5 m / 1.8 m up) — subtract the mount
                # height from global z.
                r = radar_point(xyz[0] - wlh[1] / 2 * abs(np.cos(yaw)),
                                xyz[1] + rng.randn() * 0.15,
                                xyz[2] - 0.5,
                                float(o["vel"][0]), float(o["vel"][1]))
                radar_rows.append(r)
                pts = np.zeros((6, 5), np.float32)
                pts[:, 0] = xyz[0] - wlh[1] / 2 + rng.rand(6) * 0.3
                pts[:, 1] = xyz[1] + (rng.rand(6) - 0.5) * wlh[0]
                pts[:, 2] = xyz[2] + (rng.rand(6) - 0.5) * wlh[2] - 1.8
                lidar_rows.append(pts)
            # clutter: off-object returns the association must reject
            for _ in range(rng.randint(2, 6)):
                d = rng.uniform(5, 50)
                radar_rows.append(radar_point(
                    d, rng.uniform(-0.45, 0.45) * d, rng.uniform(-0.5, 1.0),
                    0.0, 0.0))
            write_radar_pcd(os.path.join(rad_dir, f"{pfx}r{i}.pcd"),
                            radar_rows)
            lid = (np.concatenate(lidar_rows) if lidar_rows
                   else np.zeros((1, 5), np.float32))
            lid.astype(np.float32).tofile(
                os.path.join(lid_dir, f"{pfx}l{i}.pcd.bin"))
            img = _campaign_render(
                [(o["ci"], o["xyz"], o["wlh"], o["yaw"]) for o in active],
                intrinsic, img_wh, rng)
            cv2.imwrite(os.path.join(cam_dir, f"{pfx}img{i}.jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])

    dump("scene", scenes)
    dump("sample", samples)
    dump("sensor", [
        {"token": "se_cam", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "se_rad", "channel": "RADAR_FRONT", "modality": "radar"},
        {"token": "se_lid", "channel": "LIDAR_TOP", "modality": "lidar"},
    ])
    dump("calibrated_sensor", [
        {"token": "cs_cam", "sensor_token": "se_cam",
         "translation": [0.0, 0.0, CAM_HEIGHT],
         "rotation": list(CAM_FRONT_ROT),
         "camera_intrinsic": intrinsic.tolist()},
        {"token": "cs_rad", "sensor_token": "se_rad",
         "translation": [0.0, 0.0, 0.5], "rotation": [1, 0, 0, 0],
         "camera_intrinsic": []},
        {"token": "cs_lid", "sensor_token": "se_lid",
         "translation": [0.0, 0.0, 1.8], "rotation": [1, 0, 0, 0],
         "camera_intrinsic": []},
    ])
    dump("ego_pose", [{"token": "ep0", "translation": [0, 0, 0],
                       "rotation": [1, 0, 0, 0]}])
    dump("sample_data", sample_data)
    dump("sample_annotation", annotations)
    dump("category", [{"token": f"cat{ci}", "name": name}
                      for ci, (name, _, _, _) in enumerate(CAMPAIGN_CLASSES)])
    dump("instance", instances)
    dump("attribute", [{"token": "at_vm", "name": "vehicle.moving"},
                       {"token": "at_pm", "name": "pedestrian.moving"}])
    return root


def make_synthetic_nuscenes(root: str, n_samples: int = 4, img_wh=(160, 96),
                            n_objects: int = 3, n_radar: int = 40, seed: int = 0):
    """Write a synthetic nuScenes-converter-format dataset under ``root``.

    Returns the data directory (root/nuscenes). Image files are small random
    JPEGs; calibration uses a pinhole camera scaled to img_wh.
    """
    rng = np.random.RandomState(seed)
    try:  # without opencv the images are not written, as in JAX
        cv2 = opencv("writing the synthetic JPEGs")
    except ImportError:
        cv2 = None
    w, h = img_wh
    data_dir = os.path.join(root, "nuscenes")
    ann_dir = os.path.join(data_dir, "annotations")
    os.makedirs(os.path.join(ann_dir, "radar_pc", "CAM_FRONT"), exist_ok=True)
    os.makedirs(os.path.join(ann_dir, "lidar_pc", "CAM_FRONT"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "samples"), exist_ok=True)

    fx = w * 0.8
    calib = [[fx, 0.0, w / 2, 0.0], [0.0, fx, h / 2, 0.0], [0.0, 0.0, 1.0, 0.0]]
    intr = [[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]]

    images, annotations = [], []
    ann_id = 0
    for i in range(n_samples):
        token = f"sample{i:04d}"
        fname = f"samples/img_{i:04d}.jpg"
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        if cv2 is not None:
            cv2.imwrite(os.path.join(data_dir, fname), img)
        images.append(
            {
                "id": i + 1,
                "prev_id": max(1, i),
                "file_name": fname,
                "calib": calib,
                "video_id": 1,
                "frame_id": i + 1,
                "sensor_id": 1,  # CAM_FRONT
                "sample_token": token,
                "trans_matrix": np.eye(4).tolist(),
                "velocity_trans_matrix": np.eye(4).tolist(),
                "width": w,
                "height": h,
                "pose_record_trans": [0.0, 0.0, 0.0],
                "pose_record_rot": [1.0, 0.0, 0.0, 0.0],
                "cs_record_trans": [0.0, 0.0, 0.0],
                "cs_record_rot": [1.0, 0.0, 0.0, 0.0],
                "camera_intrinsic": intr,
            }
        )

        for _ in range(n_objects):
            depth = float(rng.rand() * 40 + 5)
            x3d = float(rng.randn() * depth * 0.3)
            y3d = float(rng.rand() * 1.5)
            dim = [1.5 + rng.rand(), 1.6 + rng.rand() * 0.4, 3.5 + rng.rand()]
            yaw = float(rng.rand() * 2 * np.pi - np.pi)
            cx = fx * x3d / depth + w / 2
            cy = fx * (y3d - dim[0] / 2) / depth + h / 2
            bw = fx * dim[2] / depth
            bh = fx * dim[0] / depth
            x1 = float(np.clip(cx - bw / 2, 0, w - 2))
            y1 = float(np.clip(cy - bh / 2, 0, h - 2))
            bw = float(min(bw, w - 1 - x1))
            bh = float(min(bh, h - 1 - y1))
            alpha = yaw - np.arctan2(cx - w / 2, fx)
            vel = rng.randn(3) * 2
            ann_id += 1
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": i + 1,
                    "category_id": int(rng.randint(1, 11)),
                    "dimension": dim,
                    "location": [x3d, y3d, depth],
                    "depth": depth,
                    "occluded": 0,
                    "yaw": yaw,
                    "amodal_center": [float(cx), float(cy)],
                    "track_id": ann_id,
                    "attributes": int(rng.randint(0, 9)),
                    "velocity": vel.tolist(),
                    "velocity_cam": [*vel.tolist(), 0.0],
                    "truncated": 0,
                    "bbox": [x1, y1, bw, bh],
                    "area": bw * bh,
                    "alpha": float(alpha),
                }
            )

        # radar: 18-row point cloud, camera frame (x right, y down, z fwd)
        radar = np.zeros((18, n_radar), np.float32)
        radar[2] = rng.rand(n_radar) * 50 + 2  # depth
        radar[0] = rng.randn(n_radar) * radar[2] * 0.3
        radar[1] = rng.rand(n_radar) * 2
        radar[8] = rng.randn(n_radar)  # vx
        radar[9] = rng.randn(n_radar)  # vz
        with open(os.path.join(ann_dir, "radar_pc", "CAM_FRONT", f"{token}.bin"), "wb") as f:
            pickle.dump(radar.tolist(), f)

        lidar = np.zeros((3, 200), np.float32)
        lidar[0] = rng.rand(200) * (w - 2) + 1
        lidar[1] = rng.rand(200) * (h - 2) + 1
        lidar[2] = rng.rand(200) * 50 + 1
        with open(os.path.join(ann_dir, "lidar_pc", "CAM_FRONT", f"{token}.bin"), "wb") as f:
            pickle.dump(lidar.tolist(), f)

    for split in ("train", "mini_train", "mini_val", "val"):
        with open(os.path.join(ann_dir, f"{split}.json"), "w") as f:
            json.dump(
                {
                    "images": images,
                    "annotations": annotations,
                    "categories": [
                        {"name": f"c{j}", "id": j + 1} for j in range(10)
                    ],
                    "videos": [{"id": 1, "file_name": "scene-0001"}],
                    "pointclouds": [],
                },
                f,
            )
    return data_dir
