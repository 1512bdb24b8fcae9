"""``Detector.run_stream``, the pipelined serving loop, on the CPU.

A tiny seeded Detector (64x128, Conv nodes, float32, BatchNorm calibrated
on one batch so that every image has detections) serves batches of two
frames: decoded arrays with radar, and the repo's JPEG paths. ``run_stream``
yields ``run``'s detections bitwise, batch by batch and in input order,
with 1 and 3 worker threads and 1 and 8 batches in flight; closing the
generator early leaves no producer thread alive within 5 s; an error in
the producer reaches the consumer; a stress run with more workers than
cores and a short switch interval counts every decode and warp once (the
stage counters are shared by the threads). ``derive_stream_defaults`` is
the JAX package's for 1-64 cores, and the one packed fetch
(``_pack_detections``, ``_fetch_packed``) gives back every entry, also
with a (B,)-shaped one that sorts first, as the JAX package's does.
"""

from __future__ import annotations

import glob
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.runtime import detector
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    calibrate_batchnorm, seeded_weights, synthetic_frames)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = sorted(glob.glob(os.path.join(
    ROOT, "output", "campaign_r5", "data", "nuscenes", "samples",
    "CAM_FRONT", "c1img*.jpg")))[:4]
OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
        "MIXED_PRECISION", "False"]
PRODUCER = "cfd3d-stream-producer"


@pytest.fixture(scope="module")
def det():
    d = detector.Detector(load_config(opts=OPTS, num_classes=10),
                          device="cpu")
    seeded_weights(d.model, 0)
    calibrate_batchnorm(d, synthetic_frames(2, 72, 128, seed=0))
    return d


@pytest.fixture(scope="module")
def batches():
    """Five (images, img_infos, radar_pcs) batches of two frames: three of
    decoded arrays with radar, two of JPEG paths."""
    out = [synthetic_frames(2, 72, 128, seed=s) for s in (1, 2, 3)]
    out += [(JPEGS[i:i + 2], None, None) for i in (0, 2)]
    return out


def _same(got, want):
    assert sorted(got) == sorted(want)
    for img_id, items in want.items():
        assert len(got[img_id]) == len(items) > 0
        for a, b in zip(got[img_id], items):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("depth", [1, 8])
def test_stream_yields_runs_detections_in_order(det, batches, workers,
                                                depth):
    want = [det.run(*b) for b in batches]
    got = list(det.run_stream(iter(batches), prefetch=2, depth=depth,
                              workers=workers, fetch_workers=3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g["results"], w["results"])
        assert [m["width"] for m in g["metas"]] == [
            m["width"] for m in w["metas"]]
        assert sorted(g["extras"]) == sorted(w["extras"])
    stats = det.stage_stats()
    assert {"decode", "warp", "get_wait", "dispatch", "pack", "fetch",
            "merge"} <= set(stats)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == PRODUCER and t.is_alive()]


def test_early_close_reaps_the_producer(det, batches):
    def frames():
        for _ in range(20):
            yield batches[0]

    assert _producers() == []
    gen = det.run_stream(frames(), prefetch=1, depth=1, workers=2)
    next(gen)
    gen.close()
    deadline = time.monotonic() + 5.0
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _producers() == [], "the producer outlived close()"


def test_a_producer_error_reaches_the_consumer(det, batches):
    def frames():
        yield batches[0]
        raise RuntimeError("boom in the producer")

    with pytest.raises(RuntimeError, match="boom in the producer"):
        for _ in det.run_stream(frames(), depth=2, workers=1):
            pass
    with pytest.raises(FileNotFoundError):
        for _ in det.run_stream(iter([(["absent.jpg"], None, None)]),
                                workers=2):
            pass


def test_stage_counts_under_thread_contention(det, batches):
    """More workers than cores and a 1 us switch interval: the shared stage
    counters count each of the 24 frames' decode and warp once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        det.stage_stats(reset=True)
        items = [batches[i % 3] for i in range(12)]
        out = list(det.run_stream(iter(items), prefetch=4, depth=4,
                                  workers=2 * (os.cpu_count() or 1) + 1))
    finally:
        sys.setswitchinterval(old)
    assert len(out) == 12
    assert det._stage_n["decode"] == det._stage_n["warp"] == 24
    assert det._stage_n["dispatch"] == det._stage_n["fetch"] == 12


def test_stream_defaults_are_jaxs():
    jax_detector = pytest.importorskip(
        "centerfusiondetect3d_tpu.runtime.detector")
    for n in range(1, 65):
        assert detector.derive_stream_defaults(n) == \
            jax_detector.derive_stream_defaults(n), n


def test_packed_fetch_round_trips_with_a_vector_entry():
    rng = np.random.RandomState(0)
    b, k = 3, 5
    processed = {
        "aaa_flag": torch.from_numpy(rng.rand(b).astype(np.float32)),
        "scores": torch.from_numpy(rng.rand(b, k).astype(np.float32)),
        "classIds": torch.from_numpy(rng.randint(0, 10, (b, k))),
        "location": torch.from_numpy(rng.randn(b, k, 3).astype(np.float32)),
        "bboxes": torch.from_numpy(rng.randn(b, k, 4).astype(np.float32)),
    }
    packed, rest = detector._pack_detections(processed)
    flat, packable, widths, _ = packed
    assert sorted(rest) == ["aaa_flag"]
    assert packable == ["bboxes", "classIds", "location", "scores"]
    assert widths == [4, 1, 3, 1] and tuple(flat.shape) == (b, k, 9)
    assert flat.dtype == torch.float32
    out = detector._fetch_packed(processed)
    assert sorted(out) == sorted(processed)
    for key, val in processed.items():
        assert out[key].shape == tuple(val.shape)
        np.testing.assert_array_equal(out[key], val.numpy().astype(
            out[key].dtype))
    jax_detector = pytest.importorskip(
        "centerfusiondetect3d_tpu.runtime.detector")
    jnp = pytest.importorskip("jax.numpy")
    theirs = jax_detector._fetch_packed({k: jnp.asarray(v.numpy())
                                         for k, v in processed.items()})
    for key in processed:
        np.testing.assert_array_equal(out[key], np.asarray(theirs[key]))
    only_scores = {"scores": processed["scores"]}
    assert detector._pack_detections(only_scores) == (None, only_scores)
