"""The port's nuScenes evaluation (``evaluation/*``,
``data/nuscenes_eval.py``) against the executed reference's fixtures and the
JAX package.

``accumulate`` against ``eval_accumulate.npz`` (greedy matching with the
reference's tie order, 101-point interpolation, NaN-aware TP curves, the
achieved recall), ``filter_eval_boxes`` against ``eval_filter.npz`` (the
strict distance band, zero-point, bike-rack and scene-keyword filters) and
``convert_eval_format`` against ``eval_format.npz`` (camera -> global
submission records), each with the tolerances of the JAX package's own
tests of those fixtures (``tests/test_golden_datalayer.py``), and bitwise
against the JAX package's functions on the same inputs. ``DetectionEval.run``
(every range and extreme-scene variant: AP, TP errors, NDS) against the JAX
package's on seeded boxes, within 1e-9.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.nuscenes_eval import (
    convert_eval_format)
from centerfusiondetect3d_tpu_torch import evaluation
from centerfusiondetect3d_tpu_torch.evaluation import (
    DetectionConfig, EvalBox, EvalBoxes, accumulate, filter_eval_boxes)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SUMMARY_ATOL = 1e-9
CURVES = ("recall", "precision", "confidence", "trans_err", "vel_err",
          "scale_err", "orient_err", "attr_err")


def _load(name):
    path = os.path.join(FIXTURES, name)
    if not os.path.exists(path):
        pytest.skip(f"golden fixture {name} not generated")
    return np.load(path)


def _eval_boxes(g, prefix, box_cls=EvalBox, boxes_cls=EvalBoxes):
    boxes = boxes_cls()
    for i in range(len(g[f"{prefix}_token"])):
        token = str(g[f"{prefix}_token"][i])
        boxes.add_boxes(token, [box_cls(
            sample_token=token,
            translation=g[f"{prefix}_translation"][i],
            size=g[f"{prefix}_size"][i],
            rotation=g[f"{prefix}_rotation"][i],
            velocity=g[f"{prefix}_velocity"][i],
            detection_name=str(g[f"{prefix}_name"][i]),
            detection_score=float(g[f"{prefix}_score"][i]),
            attribute_name=str(g[f"{prefix}_attr"][i]),
        )])
    return boxes


def test_accumulate_matches_the_reference_and_jax():
    from centerfusiondetect3d_tpu.evaluation import algo as jax_algo
    from centerfusiondetect3d_tpu.evaluation import detection as jax_det

    g = _load("eval_accumulate.npz")
    gt, pred = _eval_boxes(g, "gt"), _eval_boxes(g, "pred")
    jgt = _eval_boxes(g, "gt", jax_det.EvalBox, jax_det.EvalBoxes)
    jpred = _eval_boxes(g, "pred", jax_det.EvalBox, jax_det.EvalBoxes)
    for case in map(str, g["cases"]):
        cls, dist_th = case.rsplit("_", 1)
        md = accumulate(gt, pred, cls, float(dist_th))
        jmd = jax_algo.accumulate(jgt, jpred, cls, float(dist_th))
        for f in CURVES:
            np.testing.assert_allclose(md[f], g[f"{case}_{f}"], rtol=1e-7,
                                       atol=1e-9, err_msg=f"{case}:{f}")
            np.testing.assert_array_equal(md[f], jmd[f], err_msg=case)
        assert abs(md["max_recall"] - float(g[f"{case}_maxrecall"])) < 1e-12
        assert md["max_recall"] == jmd["max_recall"] and md["npos"] == jmd[
            "npos"]


@pytest.mark.parametrize("tag,keywords", [
    ("plain", None),
    ("extreme", ["dark", "very dark", "Night", "Rain", "heavy rain"]),
])
def test_filter_eval_boxes_matches_the_reference(tag, keywords):
    g = _load("eval_filter.npz")
    rows = json.loads(bytes(g["rows_json"]).decode())
    scenes = json.loads(bytes(g["scenes_json"]).decode())
    rack = json.loads(bytes(g["rack_json"]).decode())
    max_dist = json.loads(bytes(g["max_dist_json"]).decode())
    want = json.loads(bytes(g[f"{tag}_kept_json"]).decode())

    boxes = EvalBoxes()
    uid_of = {}
    for uid, tok, name, exy, npts, tr in rows:
        b = EvalBox(
            sample_token=tok, translation=np.asarray(tr, np.float64),
            size=np.array([0.6, 1.8, 1.2]),
            rotation=np.array([np.cos(0.05), 0, 0, np.sin(0.05)]),
            velocity=np.zeros(2), detection_name=name, detection_score=0.5,
            num_pts=npts, ego_translation=np.array([exy[0], exy[1], 0.0]))
        uid_of[id(b)] = uid
        boxes.add_boxes(tok, [b])
    scene_filter = None
    if keywords is not None:
        def scene_filter(token):
            return bool({s.strip() for s in scenes[token].split(",")}
                        & set(keywords))

    out = filter_eval_boxes(boxes, DetectionConfig(
        class_range=dict(max_dist), min_dist=30.0),
        scene_filter=scene_filter, bike_racks={"sA": [rack]})
    got = {t: sorted(uid_of[id(b)] for b in out[t]) for t in out.sample_tokens}
    assert got == {t: sorted(v) for t, v in want.items()}


def _format_inputs():
    g = _load("eval_format.npz")
    inputs = json.loads(bytes(g["inputs_json"]).decode())
    want = json.loads(bytes(g["output_json"]).decode())
    infos = {int(k): v for k, v in inputs["infos"].items()}
    results = {int(k): v for k, v in inputs["results"].items()}

    class _Coco:
        def load_imgs(self, ids):
            ids = ids if isinstance(ids, (list, tuple)) else [ids]
            return [infos[i] for i in ids]

    ds = SimpleNamespace(
        config=SimpleNamespace(DATASET=SimpleNamespace(RADAR_PC=True)),
        coco=_Coco(), images=sorted(infos),
        class_name=list(NuScenesDataset.class_name),
        cycles=list(NuScenesDataset.cycles),
        pedestrians=list(NuScenesDataset.pedestrians),
        vehicles=list(NuScenesDataset.vehicles),
        id_to_attribute=dict(NuScenesDataset.id_to_attribute))
    return results, ds, want


def test_convert_eval_format_matches_the_reference_and_jax():
    from centerfusiondetect3d_tpu.data import nuscenes_eval as jax_eval

    results, ds, want = _format_inputs()
    got = convert_eval_format(results, ds)
    assert got == jax_eval.convert_eval_format(results, ds)
    assert got["meta"] == want["meta"]
    assert sorted(got["results"]) == sorted(want["results"])
    for token, recs_w in want["results"].items():
        recs_g = got["results"][token]
        assert len(recs_w) == len(recs_g), token
        for rw, rg in zip(recs_w, recs_g):
            for key in ("sample_token", "detection_name", "attribute_name",
                        "tracking_name", "sensor_id", "tracking_id",
                        "det_id"):
                assert rg[key] == rw[key], (token, key)
            for key in ("translation", "size", "rotation", "velocity",
                        "detection_score", "tracking_score"):
                np.testing.assert_allclose(
                    np.asarray(rg[key], np.float64),
                    np.asarray(rw[key], np.float64), rtol=1e-4, atol=1e-4,
                    err_msg=f"{token}:{key}")


def _seeded_submission(seed, n_samples=12):
    """GT boxes (dicts), a submission, ego positions, scene descriptions and
    bike racks, drawn from a seed: every class, distances across the range
    bands, some night scenes, jittered and missed detections."""
    from centerfusiondetect3d_tpu_torch.evaluation.detection import (
        ATTRIBUTE_NAMES, DETECTION_NAMES)

    rng = np.random.RandomState(seed)
    gts, subs, ego, desc = {}, {}, {}, {}
    for s in range(n_samples):
        token = f"s{s}"
        ego[token] = rng.randn(3) * 5
        desc[token] = rng.choice(["sunny, parked cars", "Night, rain",
                                  "very dark, Rain", "clear"])
        gts[token], subs[token] = [], []
        for _ in range(rng.randint(3, 12)):
            name = DETECTION_NAMES[rng.randint(len(DETECTION_NAMES))]
            dist = rng.uniform(2, 55)
            ang = rng.uniform(-np.pi, np.pi)
            t = ego[token] + np.array([dist * np.cos(ang), dist * np.sin(ang),
                                       rng.randn()])
            yaw = rng.uniform(-np.pi, np.pi)
            box = {"translation": t.tolist(),
                   "size": (rng.uniform(0.5, 5, 3)).tolist(),
                   "rotation": [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                   "velocity": rng.randn(2).tolist(),
                   "detection_name": name,
                   "attribute_name": ATTRIBUTE_NAMES[
                       rng.randint(len(ATTRIBUTE_NAMES))],
                   "num_pts": int(rng.randint(0, 5))}
            gts[token].append(box)
            if rng.rand() < 0.8:  # detected, jittered
                pred = dict(box, detection_score=float(rng.rand()))
                pred["translation"] = (t + rng.randn(3) * 0.8).tolist()
                pred["size"] = (np.asarray(box["size"])
                                * rng.uniform(0.8, 1.2, 3)).tolist()
                pred.pop("num_pts")
                subs[token].append(pred)
        for _ in range(rng.randint(0, 4)):  # false positives
            pred = dict(gts[token][0], detection_score=float(rng.rand()) / 2)
            pred["translation"] = (ego[token] + rng.randn(3) * 20).tolist()
            pred.pop("num_pts")
            subs[token].append(pred)
    racks = {"s0": [{"translation": gts["s0"][0]["translation"],
                     "size": [3.0, 3.0, 3.0], "rotation": [1, 0, 0, 0]}]}
    return gts, {"meta": {}, "results": subs}, ego, desc, racks


def _gt_boxes(gts, box_cls, boxes_cls):
    boxes = boxes_cls()
    for token, rows in gts.items():
        boxes.add_boxes(token, [box_cls(
            sample_token=token,
            translation=np.asarray(r["translation"], np.float64),
            size=np.asarray(r["size"], np.float64),
            rotation=np.asarray(r["rotation"], np.float64),
            velocity=np.asarray(r["velocity"], np.float64),
            detection_name=r["detection_name"],
            attribute_name=r["attribute_name"], num_pts=r["num_pts"])
            for r in rows])
    return boxes


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_detection_eval_run_matches_jax(tmp_path):
    from centerfusiondetect3d_tpu import evaluation as jax_evaluation

    gts, sub, ego, desc, racks = _seeded_submission(7)
    sub_path = tmp_path / "submission.json"
    sub_path.write_text(json.dumps(sub))
    runs = []
    for pkg, out in ((jax_evaluation, "jax"), (evaluation, "port")):
        gt = pkg.add_ego_translation(
            _gt_boxes(gts, pkg.EvalBox, pkg.EvalBoxes), ego)
        ev = pkg.DetectionEval(gt, str(sub_path), str(tmp_path / out),
                               sample_scene_description=desc,
                               bike_racks=racks)
        ev.pred_boxes = pkg.add_ego_translation(ev.pred_boxes, ego)
        runs.append(ev.run())
    theirs, mine = runs
    assert sorted(mine) == sorted(theirs) == sorted(
        f"range_{r}{e}" for r in ("10", "30", "50", "all")
        for e in ("", "_extreme"))
    assert mine["range_all"]["mean_ap"] > 0  # the draw does score
    for variant in mine:
        a, b = dict(_flat(mine[variant])), dict(_flat(theirs[variant]))
        assert sorted(a) == sorted(b), variant
        for key, v in a.items():
            w = b[key]
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(w), (variant, key)
            else:
                assert abs(v - w) <= SUMMARY_ATOL, (variant, key, v, w)
    for variant in mine:
        a = json.load(open(tmp_path / "port" / variant / "metrics_summary.json"))
        b = json.load(open(tmp_path / "jax" / variant / "metrics_summary.json"))
        assert a == b, variant
