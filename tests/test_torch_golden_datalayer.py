"""The port's host data layer against the executed torch-reference goldens
that the JAX package's ``tests/test_golden_datalayer.py`` reads, at its
tolerances:

- ``geometry.npz`` (the reference's ``utils/image.py``, ``utils/ddd.py``):
  affine matrices and point maps, gaussian radii and splats, 3D boxes,
  their projection (numpy ``project_3d_points_np`` and the torch
  ``project_3d_points``), alpha/yaw and image-to-camera unprojection;
- ``radar_raster.npz`` (``generic_dataset.processPointCloud`` through the
  nuScenes draws): every ROI method, the one-hot and the max-distance
  case, with the C++ paint (``native/``) and its numpy plain version;
- ``multisweep.npz`` (``RadarPointCloudWithVelocity.from_file_multisweep``):
  the converter's multi-sweep radar aggregation.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch import geometry
from centerfusiondetect3d_tpu_torch.data.convert_nuscenes import (
    aggregate_radar)
from centerfusiondetect3d_tpu_torch.data.radar import (
    process_point_cloud, process_point_cloud_plain)
from centerfusiondetect3d_tpu_torch.data.synthetic import write_radar_pcd

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    return np.load(os.path.join(FIXTURES, name))


def _chw(x):
    return np.transpose(x, (1, 2, 0))


def test_affine_matrices_and_points_match_reference():
    g = _load("geometry.npz")
    for i in range(len(g["affine_rots"])):
        mat = geometry.get_affine_transform(
            g["affine_centers"][i], g["affine_scales"][i],
            float(g["affine_rots"][i]), tuple(g["affine_outs"][i]),
            shift=g["affine_shifts"][i], inverse=bool(g["affine_inv"][i]))
        np.testing.assert_allclose(mat, g["affine_mats"][i], rtol=1e-4,
                                   atol=1e-3, err_msg=f"case {i}")
    mat = geometry.get_affine_transform(np.array([800.0, 450.0], np.float32),
                                        1600.0, 0.0, (200, 112))
    np.testing.assert_allclose(mat, g["affine_scalar_mat"], atol=1e-5)
    for i, mat in enumerate(g["affine_mats"]):
        ours = geometry.apply_affine(g["points"].copy(),
                                     mat.astype(np.float32))
        np.testing.assert_allclose(ours, g["points_out"][i], rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(ours, g["points_out_torch"][i], rtol=1e-4,
                                   atol=1e-3)


def test_gaussian_radius_and_splats_match_reference():
    g = _load("geometry.npz")
    for (h, w), ov, want in zip(g["radius_det_sizes"], g["radius_overlaps"],
                                g["radius_out"]):
        assert abs(geometry.gaussian_radius((h, w), float(ov)) - want) < 1e-6
    circ = np.zeros_like(g["circ_out"])
    for cx, cy, r, k in g["circ_cases"]:
        geometry.draw_gaussian(circ, np.array([cx, cy], np.float32), int(r),
                               k=float(k))
    np.testing.assert_allclose(circ, g["circ_out"], atol=1e-6)
    ellip = np.zeros_like(g["ellip_out"])
    for cx, cy, rx, ry, k in g["ellip_cases"]:
        geometry.draw_gaussian(ellip, np.array([cx, cy], np.float32),
                               (int(rx), int(ry)), k=float(k))
    np.testing.assert_allclose(ellip, g["ellip_out"], atol=1e-6)


@pytest.mark.parametrize("xp", ["numpy", "torch"])
def test_3d_geometry_matches_reference(xp):
    g = _load("geometry.npz")
    b, k = g["ddd_dim"].shape[:2]
    calib_bk = np.broadcast_to(g["ddd_calib"][:, None], (b, k, 3, 4))
    if xp == "numpy":
        corners = geometry.get_3d_box_np(g["ddd_dim"], g["ddd_loc"],
                                         g["ddd_yaw"])
        proj = geometry.project_3d_points_np(corners.astype(np.float32),
                                             calib_bk)
    else:
        t = torch.from_numpy
        corners = geometry.get_3d_box(t(g["ddd_dim"]), t(g["ddd_loc"]),
                                      t(g["ddd_yaw"]))
        proj = geometry.project_3d_points(
            corners, t(np.ascontiguousarray(calib_bk))).numpy()
        corners = corners.numpy()
    np.testing.assert_allclose(corners, g["ddd_corners"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(proj, g["ddd_proj2d"], rtol=1e-4, atol=1e-2)


def test_alpha_yaw_and_unprojection_match_reference():
    g = _load("geometry.npz")
    t = torch.from_numpy
    b, k = g["ddd_dim"].shape[:2]
    calib_bk = np.ascontiguousarray(
        np.broadcast_to(g["ddd_calib"][:, None], (b, k, 3, 4)))
    rot_y = geometry.alpha_to_yaw(t(g["ddd_alpha"].copy()), t(g["ddd_xs"]),
                                  t(calib_bk[:, :, 0, 2].copy()),
                                  t(calib_bk[:, :, 0, 0].copy()))
    np.testing.assert_allclose(rot_y.numpy(), g["ddd_rot_y"], atol=1e-5)
    np.testing.assert_allclose(rot_y.numpy(), g["alpha_yaw"], atol=1e-5)
    locs, yaws = geometry.img_to_cam_coord(
        t(g["ddd_centers2d"]), t(g["ddd_alpha"]), t(g["ddd_dim"]),
        t(g["ddd_depth"]), t(g["ddd_calib"]))
    np.testing.assert_allclose(locs.numpy(), g["ddd_cam_locs"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(yaws.numpy(), g["ddd_cam_yaws"], atol=1e-5)
    np.testing.assert_allclose(geometry.get_alpha(t(g["rot8"])).numpy(),
                               g["rot8_alpha"], atol=1e-5)


def _radar_cfg(method, onehot, maxdist, oh=24, ow=40):
    return SimpleNamespace(
        MODEL=SimpleNamespace(OUTPUT_SIZE=(oh, ow)),
        DATASET=SimpleNamespace(
            PC_ROI_METHOD=method, ONE_HOT_PC=onehot, MAX_PC_DIST=maxdist,
            PILLAR_DIMS=(1.5, 0.2, 0.2)))


@pytest.mark.parametrize("paint", ["native", "numpy"])
@pytest.mark.parametrize("method,onehot,maxdist", [
    ("pillars", False, 60.0),
    ("heatmap", False, 60.0),
    ("points", False, 60.0),
    ("pillars", True, 10.0),
])
def test_radar_rasterize_matches_reference(method, onehot, maxdist, paint):
    g = _load("radar_raster.npz")
    tag = f"{method}{'_onehot' if onehot else ''}"
    keep = g["pc_3d"][2] <= maxdist  # loadRadarPointCloud's distance filter
    fn = process_point_cloud if paint == "native" else (
        process_point_cloud_plain)
    pts, p3d, depth_map = fn(g["pc_2d"][:, keep].copy(),
                             g["pc_3d"][:, keep].copy(),
                             _radar_cfg(method, onehot, maxdist),
                             g["trans_out"].astype(np.float32), g["calib"])
    np.testing.assert_allclose(pts, g[f"{tag}_points"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(p3d, g[f"{tag}_pc3d"], atol=1e-6)
    np.testing.assert_allclose(depth_map, _chw(g[f"{tag}_depthmap"]),
                               rtol=1e-5, atol=1e-4, err_msg=tag)
    assert float(np.abs(depth_map).sum()) > 0


def test_multisweep_aggregation_matches_reference(tmp_path):
    g = _load("multisweep.npz")
    records = json.loads(bytes(g["records_json"]).decode())
    (tmp_path / "sweeps" / "RADAR_FRONT").mkdir(parents=True)
    for i in range(3):
        write_radar_pcd(str(tmp_path / f"sweeps/RADAR_FRONT/s{i}.pcd"),
                        g[f"sweep_s{i}"].T)
    nusc = SimpleNamespace(
        dataroot=str(tmp_path), sd_by_token=records["sample_data"],
        ego_pose=records["ego_pose"],
        calibrated_sensor=records["calibrated_sensor"],
        sample_channel={"samp": {"CAM_FRONT": "sd_cam",
                                 "RADAR_FRONT": "sd_r0"}})
    agg = aggregate_radar(nusc, {"token": "samp"}, "RADAR_FRONT", "CAM_FRONT",
                          nsweeps=3, min_distance=1.0)
    want = g["out_points"]
    assert agg.shape == want.shape, (agg.shape, want.shape)
    np.testing.assert_allclose(agg, want, rtol=1e-4, atol=1e-4)
