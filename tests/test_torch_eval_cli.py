"""The port's evaluation CLI (``evaluation/cli.py``) against the JAX
package's (``tests/test_cli.py:62``) on the same submission and raw
tables: the same summaries returned, and every ``metrics_summary.json``
(each range and extreme variant) equal to 1e-9.

The raw tables are ``data/synthetic.py:make_synthetic_raw_tables``' with
more annotations (cars, pedestrians, trucks and barriers around each
sample) and one scene described "Night, Rain", so that each range band and
the extreme variants have boxes; the submission is the ground truth moved,
resized, turned and rescored from a seed, with misses and false
positives.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.data.synthetic import (
    make_synthetic_raw_tables)
from centerfusiondetect3d_tpu_torch.evaluation import cli

jax_cli = pytest.importorskip("centerfusiondetect3d_tpu.evaluation.cli")
pytest.importorskip("cv2")  # the synthetic tables' JPEGs

CATEGORIES = {"vehicle.car": ("car", "vehicle.moving"),
              "human.pedestrian.adult": ("pedestrian", "pedestrian.moving"),
              "vehicle.truck": ("truck", "vehicle.parked"),
              "movable_object.barrier": ("barrier", "")}


def _write(version, name, rows):
    with open(os.path.join(version, f"{name}.json"), "w") as f:
        json.dump(rows, f)


def _read(version, name):
    with open(os.path.join(version, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = make_synthetic_raw_tables(str(tmp_path_factory.mktemp("raw")),
                                     {"mini_val": 4, "mini_train": 3})
    version = os.path.join(root, "v1.0-mini")
    rng = np.random.RandomState(0)
    scenes = _read(version, "scene")
    scenes[-1]["description"] = "Night, Rain"
    _write(version, "scene", scenes)
    cats = [{"token": f"cat{i}", "name": n}
            for i, n in enumerate(CATEGORIES)]
    attrs = [{"token": f"at{i}", "name": a}
             for i, (_, a) in enumerate(CATEGORIES.values()) if a]
    attr_of = {a["name"]: a["token"] for a in attrs}
    instances, anns = [], _read(version, "sample_annotation")
    for a in anns:
        a["attribute_tokens"] = [attr_of["vehicle.moving"]]
    for inst in _read(version, "instance"):
        inst["category_token"] = "cat0"
        instances.append(inst)
    poses = {p["token"]: p for p in _read(version, "ego_pose")}
    for sample in _read(version, "sample"):
        for j in range(6):
            ci = j % len(CATEGORIES)
            name, attr = list(CATEGORIES.items())[ci]
            dist = rng.uniform(3, 48)
            ang = rng.uniform(-np.pi, np.pi)
            instances.append({"token": f"i_{sample['token']}_{j}",
                              "category_token": f"cat{ci}"})
            yaw = rng.uniform(-np.pi, np.pi)
            anns.append({
                "token": f"a_{sample['token']}_{j}",
                "sample_token": sample["token"],
                "instance_token": f"i_{sample['token']}_{j}",
                "translation": [dist * np.cos(ang), dist * np.sin(ang), 0.8],
                "size": [float(v) for v in rng.uniform(0.5, 4.0, 3)],
                "rotation": [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                "attribute_tokens": [attr_of[attr[1]]] if attr[1] else [],
                "prev": "", "next": "", "visibility_token": "4",
                "num_lidar_pts": int(rng.randint(0, 20)),
                "num_radar_pts": int(rng.randint(0, 5))})
    assert poses
    _write(version, "category", cats)
    _write(version, "attribute", attrs)
    _write(version, "instance", instances)
    _write(version, "sample_annotation", anns)
    return root


@pytest.fixture(scope="module")
def submission(tables, tmp_path_factory):
    version = os.path.join(tables, "v1.0-mini")
    rng = np.random.RandomState(1)
    cat_of = {c["token"]: c["name"] for c in _read(version, "category")}
    inst_cat = {i["token"]: cat_of[i["category_token"]]
                for i in _read(version, "instance")}
    attr_name = {a["token"]: a["name"] for a in _read(version, "attribute")}
    results = {s["token"]: [] for s in _read(version, "sample")}
    for a in _read(version, "sample_annotation"):
        if rng.rand() < 0.15:
            continue  # a miss
        name, _ = CATEGORIES[inst_cat[a["instance_token"]]]
        yaw = rng.randn() * 0.3
        rot = np.asarray(a["rotation"], np.float64)
        turn = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        w1, x1, y1, z1 = turn
        w2, x2, y2, z2 = rot
        q = [w1 * w2 - z1 * z2, 0.0, 0.0, w1 * z2 + z1 * w2]
        results[a["sample_token"]].append({
            "sample_token": a["sample_token"],
            "translation": (np.asarray(a["translation"])
                            + rng.randn(3) * [0.6, 0.6, 0.1]).tolist(),
            "size": (np.asarray(a["size"]) * rng.uniform(0.8, 1.2, 3)).tolist(),
            "rotation": q, "velocity": rng.randn(2).tolist(),
            "detection_name": name,
            "attribute_name": (attr_name[a["attribute_tokens"][0]]
                               if a["attribute_tokens"] else ""),
            "detection_score": float(rng.rand())})
    for token, items in results.items():
        for _ in range(2):  # false positives
            items.append({
                "sample_token": token,
                "translation": (rng.randn(3) * 20).tolist(),
                "size": [1.8, 4.2, 1.5], "rotation": [1.0, 0, 0, 0],
                "velocity": [0.0, 0.0], "detection_name": "car",
                "attribute_name": "vehicle.parked",
                "detection_score": float(rng.rand() * 0.5)})
    path = tmp_path_factory.mktemp("sub") / "results.json"
    path.write_text(json.dumps({"meta": {"use_camera": True},
                                "results": results}))
    return str(path)


def _summaries(root):
    out = {}
    for d, _, files in os.walk(root):
        if "metrics_summary.json" in files:
            with open(os.path.join(d, "metrics_summary.json")) as f:
                out[os.path.relpath(d, root)] = json.load(f)
    return out


def _assert_close(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{where}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), (where, got,
                                                                   want)
    else:
        assert got == want, where


def _args(sub, out, root):
    return [sub, "--output_dir", out, "--eval_set", "mini_val", "--dataroot",
            root, "--version", "v1.0-mini", "--verbose", "1"]


def test_cli_writes_jax_summaries(tables, submission, tmp_path, capsys):
    got = cli.main(_args(submission, str(tmp_path / "port"), tables))
    port_out = capsys.readouterr().out
    want = jax_cli.main(_args(submission, str(tmp_path / "jax"), tables))
    jax_out = capsys.readouterr().out
    assert port_out.splitlines()[-1] == jax_out.splitlines()[-1]
    assert port_out.splitlines()[-1].startswith("mAP: ")
    _assert_close(got, want)
    files = _summaries(tmp_path / "port")
    assert sorted(files) == sorted(_summaries(tmp_path / "jax")) == sorted(
        f"range_{r}{x}" for r in ("10", "30", "50", "all")
        for x in ("", "_extreme"))
    _assert_close(files, _summaries(tmp_path / "jax"))
    assert got["range_all"]["mean_ap"] > 0
    assert got["range_all_extreme"]["mean_ap"] > 0
    for name in ("car", "pedestrian", "truck", "barrier"):
        assert name in got["range_all"]["label_aps"]


def test_cli_on_the_jax_test_case(tmp_path):
    """``tests/test_cli.py:62``'s perfect one-box submission."""
    version = tmp_path / "v1.0-mini"
    version.mkdir()

    def w(name, obj):
        (version / f"{name}.json").write_text(json.dumps(obj))

    w("scene", [{"token": "sc0", "name": "s", "description": "Rain"}])
    w("sample", [{"token": "sa0", "scene_token": "sc0", "timestamp": 0,
                  "prev": "", "next": ""}])
    w("category", [{"token": "c0", "name": "vehicle.car"}])
    w("instance", [{"token": "i0", "category_token": "c0"}])
    w("attribute", [{"token": "a0", "name": "vehicle.moving"}])
    w("sample_annotation", [
        {"token": "an0", "sample_token": "sa0", "instance_token": "i0",
         "translation": [8, 0, 0], "size": [2, 4.5, 1.6],
         "rotation": [1, 0, 0, 0], "attribute_tokens": ["a0"],
         "prev": "", "next": "", "num_lidar_pts": 5, "num_radar_pts": 1}])
    w("ego_pose", [{"token": "e0", "translation": [0, 0, 0],
                    "rotation": [1, 0, 0, 0]}])
    w("sample_data", [{"token": "sd0", "sample_token": "sa0",
                       "ego_pose_token": "e0", "is_key_frame": True,
                       "filename": "samples/LIDAR_TOP/x.bin"}])
    sub = {"meta": {}, "results": {"sa0": [{
        "sample_token": "sa0", "translation": [8, 0, 0],
        "size": [2, 4.5, 1.6], "rotation": [1, 0, 0, 0], "velocity": [0, 0],
        "detection_name": "car", "attribute_name": "vehicle.moving",
        "detection_score": 0.9}]}}
    path = tmp_path / "sub.json"
    path.write_text(json.dumps(sub))
    args = [str(path), "--dataroot", str(tmp_path), "--version", "v1.0-mini",
            "--verbose", "0"]
    got = cli.main(args + ["--output_dir", str(tmp_path / "port")])
    want = jax_cli.main(args + ["--output_dir", str(tmp_path / "jax")])
    assert got["range_all"]["label_aps"]["car"]["0.5"] == pytest.approx(1.0)
    assert (tmp_path / "port" / "range_all" / "mAR.csv").exists()
    assert got["range_all_extreme"]["mean_ap"] > 0
    _assert_close(got, want)
    _assert_close(_summaries(tmp_path / "port"), _summaries(tmp_path / "jax"))
