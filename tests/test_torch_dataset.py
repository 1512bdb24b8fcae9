"""The port's file-backed data (``data/dataset.py``, ``data/transforms.py``,
``data/pipeline.py:Loader``) against the JAX package, on the repo's
nuScenes-format data (``output/campaign_r5/data``).

``warp_image`` reproduces ``cv2.warpAffine(..., INTER_LINEAR)`` with a zero
border in numpy: held here against cv2 on the JAX package's own affines
(the eval affine, a flipped frame, random shifts and scales from
``sample_augment_params``, a rotation) to at most 1 level anywhere, with the
bitwise share printed and held at ``WARP_BITWISE_SHARE`` or more (it is
1.0 with opencv 5.0, whose warp computes in float32 with fused
multiply-adds; ``warp_image`` follows that arithmetic).

``NuScenesDataset.get_item`` (images decoded with cv2 on the CPU, as the JAX
package reads them) gives the JAX package's items for eval items (rng None)
and augmented train items (the same ``RandomState`` seeds): every key and
``meta`` bitwise, but ``image``, which may differ by 1 level / 255 / std
where the warps differ. ``Loader(drop_last=False, drop_keys=())`` gives the
JAX loader's batches, the last partial one and ``meta`` included.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.data.pipeline import Loader
from centerfusiondetect3d_tpu_torch.data.transforms import warp_image

cv2 = pytest.importorskip("cv2")
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
jax_dataset = pytest.importorskip("centerfusiondetect3d_tpu.data.dataset")
jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")
jax_transforms = pytest.importorskip("centerfusiondetect3d_tpu.data.transforms")
jax_geometry = pytest.importorskip("centerfusiondetect3d_tpu.geometry")

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "output", "campaign_r5", "data")
# the campaign's data settings (output/campaign_r5/config.yaml)
OPTS = ["DATASET.ROOT", repr(ROOT + "/"), "MODEL.INPUT_SIZE", "(128, 224)",
        "DATASET.TRAIN_SPLIT", "mini_train", "DATASET.VAL_SPLIT", "mini_val",
        "MODEL.K", "32", "DATASET.SHIFT", "0.2", "DATASET.SCALE", "0.1",
        "DATASET.ROTATE", "0.0", "DATASET.FLIP", "0.5",
        "DATASET.COLOR_AUG", "True"]
WARP_BITWISE_SHARE = 0.999
INDICES = (0, 7, 41, 99)
SEEDS = (1, 2, 3, 1_000_003 * 4 + 41)


@pytest.fixture(scope="module")
def datasets():
    jcfg = jax_config.load_config(opts=OPTS, num_classes=10)
    cfg = load_config(opts=OPTS, num_classes=10)
    return {split: (jax_dataset.NuScenesDataset(jcfg, split),
                    NuScenesDataset(cfg, split, device="cpu"))
            for split in ("mini_val", "mini_train")}


def _warp_cases():
    """(label, image, 2x3 affine, (W, H)) on a repo JPEG (448x256)."""
    img = cv2.imread(os.path.join(ROOT, "nuscenes", "samples", "CAM_FRONT",
                                  "c1img0.jpg"))
    h, w = img.shape[:2]
    center = np.array([w / 2, h / 2], np.float32)
    cfg = jax_config.load_config(opts=OPTS, num_classes=10)
    cases = []
    for out in ((224, 128), (56, 32), (800, 448), (160, 96)):
        cases.append(("eval", img, jax_geometry.get_affine_transform(
            center, max(h, w), 0, out), out))
        cases.append(("flip", img[:, ::-1], jax_geometry.get_affine_transform(
            center, max(h, w), 0, out), out))
        for seed in range(4):
            rng = np.random.RandomState(seed)
            c, sf, rot = jax_transforms.sample_augment_params(
                rng, center, max(h, w), w, h, cfg)
            cases.append((f"augment {seed}", img,
                          jax_geometry.get_affine_transform(
                              c, max(h, w) * sf, rot, out), out))
        cases.append(("rotate 7", img, jax_geometry.get_affine_transform(
            center, 1.3 * max(h, w), 7.0, out), out))
    return cases


def test_warp_image_is_within_a_level_of_cv2():
    same = total = 0
    for label, img, trans, out in _warp_cases():
        want = cv2.warpAffine(img, trans[:2].astype(np.float64), out,
                              flags=cv2.INTER_LINEAR)
        got = warp_image(img, trans, out)
        assert got.shape == want.shape and got.dtype == np.uint8, label
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1, (label, out, int(diff.max()))
        same += int((diff == 0).sum())
        total += diff.size
    share = same / total
    print(f"warp_image vs cv2.warpAffine: bitwise on {share:.6f} of "
          f"{total} values")
    assert share >= WARP_BITWISE_SHARE


def test_warp_image_takes_gray_and_refuses_float():
    img = cv2.imread(os.path.join(ROOT, "nuscenes", "samples", "CAM_FRONT",
                                  "c1img1.jpg"))[..., 1]
    trans = jax_geometry.get_affine_transform(
        np.array([224.0, 128.0], np.float32), 500.0, 3.0, (160, 96))
    want = cv2.warpAffine(img, trans[:2], (160, 96), flags=cv2.INTER_LINEAR)
    assert np.abs(warp_image(img, trans, (160, 96)).astype(int) - want).max() <= 1
    with pytest.raises(TypeError, match="uint8"):
        warp_image(img.astype(np.float32), trans, (160, 96))


def _assert_items_equal(got, want, std, path=""):
    assert sorted(got) == sorted(want), (path, set(got) ^ set(want))
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _assert_items_equal(g, w, std, f"{path}{key}/")
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (path + key)
        if key == "image":
            limit = (1.0 / 255.0) / std.min() * (1 + 1e-6)
            assert float(np.abs(g - w).max()) <= limit, path + key
        else:
            np.testing.assert_array_equal(g, w, err_msg=path + key)


@pytest.mark.parametrize("index", INDICES)
def test_eval_items_match_jax(datasets, index):
    jds, ds = datasets["mini_val"]
    _assert_items_equal(ds.get_item(index), jds.get_item(index), ds.std)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("index", INDICES)
def test_augmented_train_items_match_jax(datasets, index, seed):
    jds, ds = datasets["mini_train"]
    got = ds.get_item(index, np.random.RandomState(seed))
    want = jds.get_item(index, np.random.RandomState(seed))
    _assert_items_equal(got, want, ds.std)


def test_validation_loader_batches_match_jax(datasets):
    """Batch 16 over the 100 val images: 7 batches, the last of 4, with
    ``meta``."""
    jds, ds = datasets["mini_val"]
    got = list(Loader(ds, 16, drop_last=False, drop_keys=()))
    want = list(jax_pipeline.Loader(jds, 16, drop_last=False, drop_keys=(),
                                    num_threads=1, prefetch=0))
    assert [b["image"].shape[0] for b in got] == [16] * 6 + [4]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_items_equal(g, w, ds.std)
        assert "meta" in g


def test_train_loader_drops_the_last_batch_and_meta(datasets):
    _, ds = datasets["mini_val"]
    loader = Loader(ds, 16)
    assert len(loader) == 6
    batches = list(loader)
    assert len(batches) == 6 and all("meta" not in b for b in batches)
    assert loader.epoch == 1
