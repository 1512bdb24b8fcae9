"""The port's serving engine on image files, against the JAX package's.

Both ``Detector.run`` calls get the same weights (``test_torch_detector``'s
He-scaled JAX init, carried over by ``state_dict_from_jax``), at 64x128 with
DeformConv nodes (the exact DCN) and the exact top-k, and the same JPEG paths: 1600x900 frames written by cv2 from seeded
arrays and the repo's 448x256 JPEGs, with empty radar clouds, as the
inference CLI serves (the frustum association picks radar points by
thresholds, so a float32 rounding can flip one detection's secondary heads;
``test_torch_detector.py`` holds that path on frames whose picks are
stable). With ``TEST.FAST_DECODE`` True both
decode at half resolution (``cv2.IMREAD_REDUCED_COLOR_2``, decode scale 2)
and compose the scale into the warp; with False both decode in full.
Detections match at ``test_torch_detector.py``'s tolerances (rtol = atol =
1e-3; yaw and velocity 1e-2), the decode scales are JAX's, a mixed-size
batch maps each frame's boxes into its own frame, and a missing file raises
``FileNotFoundError``.

The card has no reduced decode: there ``FAST_DECODE`` decodes in full and
warps with the full affine, which is what the CPU computes with
``FAST_DECODE`` False. ``test_card_fast_decode_delta`` measures that
difference here, in pixels of the warped input and in detections of the
tiny model (``ROADMAP.md``, Queue 3); ``pytest -s`` prints it.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from test_torch_detector import _assert_matched, _center, _perturb

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data import image_io
from centerfusiondetect3d_tpu_torch.geometry.affine import get_affine_transform
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.runtime import detector
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_detector = pytest.importorskip("centerfusiondetect3d_tpu.runtime.detector")
jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_JPEGS = [os.path.join(ROOT, "output", "campaign_r5", "data", "nuscenes",
                           "samples", "CAM_FRONT", f"c1img{i}.jpg")
              for i in (0, 1)]
OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "MODEL.DLA.DCN_IMPL", "'xla'",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.APPROX_TOPK", "False",
        "MIXED_PRECISION", "False"]
COMPARED = 40
# the card's FAST_DECODE against the CPU's, measured here on the files
# below (ROADMAP.md, Queue 3), with a margin: (mean, largest) pixel
# difference of the warped input at 448x800 and at 64x128, and the largest
# difference of an image's top score on the tiny model. On a random model
# the top-10 detections of the two share no peak even on smooth frames, so
# the test prints that share and bounds the top score alone.
DELTA_LIMITS = {"smooth": (1.0, 6, 0.01), "textured": (12.0, 160, 0.03)}


def _raw_frame(seed, textured):
    """A seeded 1600x900 BGR frame. Smooth: a cubic-upsampled 9x16 grid of
    colours. Textured: 16x16-pixel blocks of random colours (about one
    input pixel each at 64x128, so that the seeded model's heatmaps are not
    flat) plus uniform noise of +-20 levels."""
    rng = np.random.default_rng(seed)
    if not textured:
        return cv2.resize(rng.integers(0, 256, (9, 16, 3), dtype=np.uint8),
                          (1600, 900), interpolation=cv2.INTER_CUBIC)
    blocks = rng.integers(0, 256, (57, 100, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:900, :1600]
    return np.clip(img.astype(np.int16) + rng.integers(-20, 21, img.shape),
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """{"smooth": [2 paths], "textured": [2 paths]} of 1600x900 JPEGs."""
    tmp = tmp_path_factory.mktemp("frames")
    out = {}
    for kind in ("smooth", "textured"):
        out[kind] = []
        for i in range(2):
            path = str(tmp / f"{kind}{i}.jpg")
            cv2.imwrite(path, _raw_frame(10 * i + 1, kind == "textured"))
            out[kind].append(path)
    return out


def float64_model(config):
    """The port's model of ``config`` in float64, taking the serving
    engine's float32 inputs as the JAX package's float64 model does (its
    state_dict keys are the model's own)."""
    model = build_model(config, torch.float64)
    forward = model.forward
    f64 = lambda t: None if t is None else t.double()
    model.forward = lambda image, pc_dep=None, calib=None, pc_hm=None: \
        forward(f64(image), f64(pc_dep), f64(calib), f64(pc_hm))
    return model


class Float64Jax:
    """A JAX ``Detector`` whose model and weights are float64, run under
    ``jax.enable_x64``."""

    def __init__(self, jdet, jcfg):
        import jax.numpy as jnp

        self.det = jdet
        with jax.enable_x64(True):
            jdet.model = jax_models.build_model(jcfg, dtype=jnp.float64)
            jdet.variables = jax.tree.map(
                lambda v: jnp.asarray(v, jnp.float64), jdet.variables)
            jdet._infer = jax.jit(jdet._forward)

    def __getattr__(self, name):
        attr = getattr(self.det, name)
        if name not in ("run", "load_data"):
            return attr

        def call(*args, **kwargs):
            with jax.enable_x64(True):
                return attr(*args, **kwargs)
        return call


def float64_pair(opts, batch_size=2):
    """(JAX Detector, port Detector) of ``opts`` on the same He-scaled
    weights, both computing in float64: in float32 the two packages'
    detections on the repo's smooth frames differ by up to ~1.5e-3 in an
    attribute (float32 rounding through the random network), above the
    comparison's 1e-3."""
    jcfg = jax_load_config(opts=opts, num_classes=10)
    jdet = jax_detector.Detector(jcfg, batch_size=batch_size)
    jdet.variables = _perturb(jdet.variables, 1)
    sd = state_dict_from_jax(jdet.variables["params"],
                             jdet.variables["batch_stats"], jcfg.head_conv)
    cfg = load_config(opts=opts, num_classes=10)
    model = float64_model(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in sd.items()})
    det = detector.Detector(cfg, device="cpu", model=model)
    return Float64Jax(jdet, jcfg), det


@pytest.fixture(scope="module")
def pair():
    """(JAX Detector, port Detector) on the same weights, batch 2."""
    return float64_pair(OPTS)


def _with_fast_decode(det, fast: bool):
    """``det`` with its config's ``TEST.FAST_DECODE`` set (load_data reads
    it; the compiled forward does not)."""
    target = getattr(det, "det", det)
    cfg = target.config.clone()
    cfg.defrost()
    cfg.TEST.FAST_DECODE = fast
    cfg.freeze()
    target.config = cfg
    return det


def _hold(got, want):
    assert sorted(got["results"]) == sorted(want["results"])
    for img_id, want_items in want["results"].items():
        got_items = got["results"][img_id]
        assert len(got_items) == len(want_items) > COMPARED
        cutoff = sorted(it["score"] for it in want_items)[-COMPARED]
        _assert_matched(want_items, got_items, cutoff, img_id)
        _assert_matched(got_items, want_items, cutoff * (1 + 1e-3), img_id)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("source", ["raw", "repo"])
def test_run_on_jpeg_paths_matches_jax(pair, jpegs, fast, source):
    jdet, det = (_with_fast_decode(d, fast) for d in pair)
    paths = jpegs["textured"] if source == "raw" else REPO_JPEGS
    want = jdet.run(paths, radar_pcs=None)
    got = det.run(paths, radar_pcs=None)
    assert got["decode_scales"] == want["decode_scales"] == (
        [2.0, 2.0] if fast else [1.0, 1.0])
    for g, w in zip(got["images"], want["images"]):
        np.testing.assert_array_equal(g, w)  # the decoded frames
    assert [m["width"] for m in got["metas"]] == [
        m["width"] for m in want["metas"]]
    _hold(got, want)


def test_mixed_size_batch_matches_jax(pair, jpegs):
    jdet, det = (_with_fast_decode(d, True) for d in pair)
    paths = [jpegs["textured"][0], REPO_JPEGS[0]]
    want = jdet.run(paths, radar_pcs=None)
    got = det.run(paths, radar_pcs=None)
    assert got["decode_scales"] == want["decode_scales"] == [2.0, 2.0]
    assert [(m["height"], m["width"]) for m in got["metas"]] == [
        (900, 1600), (256, 448)]
    _hold(got, want)


def test_a_missing_file_raises_in_both(pair, tmp_path):
    jdet, det = pair
    missing = str(tmp_path / "absent.jpg")
    for d in (jdet, det):
        with pytest.raises(FileNotFoundError):
            d.load_data([missing])
    with pytest.raises(FileNotFoundError):
        image_io.load_frame(missing, "cpu", (64, 128), True)


def test_reduced_decode_only_where_it_covers_the_input(tmp_path):
    """A JPEG whose half-resolution decode is smaller than the input is
    decoded in full (scale 1), as in the JAX package; a PNG always."""
    img = _raw_frame(3, False)[:100, :200]
    jpg, png = str(tmp_path / "small.jpg"), str(tmp_path / "small.png")
    cv2.imwrite(jpg, img)
    cv2.imwrite(png, img)
    got, scale = image_io.load_frame(jpg, "cpu", (64, 128), True)
    assert scale == 1.0 and got.shape == (100, 200, 3)
    got, scale = image_io.load_frame(jpg, "cpu", (48, 96), True)
    assert scale == 2.0 and got.shape == (50, 100, 3)
    got, scale = image_io.load_frame(png, "cpu", (48, 96), True)
    assert scale == 1.0 and np.array_equal(got, img)


def _top_matched(items, others, n=10):
    """Share of the top ``n`` items by score with a same-class counterpart
    in ``others`` centred within 1 px."""
    top = sorted(items, key=lambda it: -it["score"])[:n]
    hits = 0
    for a in top:
        d = [np.abs(_center(b) - _center(a)).max() for b in others
             if b["class"] == a["class"]]
        hits += bool(d) and min(d) <= 1.0
    return hits / max(1, len(top))


@pytest.mark.parametrize("kind", ["smooth", "textured"])
def test_card_fast_decode_delta(pair, jpegs, kind):
    """The CPU's FAST_DECODE (reduced decode, warp at decode scale 2)
    against the card's (full decode, the full affine): pixels at serving's
    448x800 and at the tiny model's 64x128, and the tiny model's
    detections."""
    pixels = {}
    for in_hw in ((448, 800), (64, 128)):
        diffs = []
        for path in jpegs[kind]:
            reduced, s = image_io.load_frame(path, "cpu", in_hw, True)
            full, s1 = image_io.load_frame(path, "cpu", in_hw, False)
            assert (s, s1) == (2.0, 1.0)
            trans = get_affine_transform(np.array([800, 450], np.float32),
                                         1600, 0, (in_hw[1], in_hw[0]))
            scaled = trans.copy()
            scaled[:, :2] *= s
            diffs.append(np.abs(
                detector._warp_or_crop(reduced, scaled, *in_hw).astype(
                    np.int16) - detector._warp_or_crop(full, trans, *in_hw)))
        d = np.stack(diffs)
        pixels[in_hw] = (float(d.mean()), int(d.max()), float((d == 0).mean()))
    _, det = pair
    cpu = _with_fast_decode(det, True).run(jpegs[kind], radar_pcs=None)
    card = _with_fast_decode(det, False).run(jpegs[kind], radar_pcs=None)
    matched = min(_top_matched(cpu["results"][i], card["results"][i])
                  for i in cpu["results"])
    top_score = max(abs(max(it["score"] for it in cpu["results"][i])
                        - max(it["score"] for it in card["results"][i]))
                    for i in cpu["results"])
    print(f"\nFAST_DECODE card vs CPU, {kind}: pixels (mean, max, share "
          f"equal) {pixels}; top-10 matched {matched:.2f}, top score "
          f"difference {top_score:.4f}")
    mean_limit, max_limit, score_limit = DELTA_LIMITS[kind]
    for mean, worst, _ in pixels.values():
        assert mean <= mean_limit and worst <= max_limit, pixels
    assert top_score <= score_limit
