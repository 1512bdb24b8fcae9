"""The device warp (``ops/warp.py``): its plain version against
``data/transforms.py:warp_image`` and ``cv2.warpAffine``, the wrapper's
refusals, and on the card the kernel (``csrc/warp_affine.cu``) against the
plain version and the serving batch that it writes against the CPU path's.

The plain version is held bitwise against ``warp_image`` and this
environment's ``cv2.warpAffine`` on serving's geometries (a downscale of a
raw 1600x900 frame, an upscale of the repo's 448x256 frames), a rotated and
scaled affine of the dataset's augmentation, a shear, points outside the
image and a mixed-size batch. The ``cuda`` cases hold the kernel bitwise
against the plain version on the same cases, on a batch of six 1600x900
frames and on a batch wider than one launch, and count its launches; the
file imports no JAX, so they run on the card's machine. The serving batch
of ``Detector.load_data`` and ``pre_process`` is held against the CPU
path's on repo JPEG paths and on a batch that mixes crops and warps.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.data.transforms import warp_image
from centerfusiondetect3d_tpu_torch.geometry.affine import get_affine_transform
from centerfusiondetect3d_tpu_torch.ops import warp

# (source (H, W), output (H, W), rotation degrees, scale of the source box)
CASES = {
    "downscale_1600x900": ((900, 1600), (448, 800), 0, 1.0),
    "upscale_448x256": ((256, 448), (448, 800), 0, 1.0),
    "augmented": ((256, 448), (448, 800), 12.5, 1.17),
    "small_rotated": ((90, 150), (64, 128), -30, 0.8),
    "outside": ((72, 128), (64, 128), 45, 2.5),
}


def _frame(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)


def _trans(case):
    (h, w), (oh, ow), rot, s = CASES[case]
    center = np.array([w / 2 + 3.25, h / 2 - 1.5], np.float32)
    return get_affine_transform(center, max(h, w) * s, rot, (ow, oh))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_is_warp_image_and_cv2_bitwise(case):
    cv2 = pytest.importorskip("cv2")
    src_hw, (oh, ow), _, _ = CASES[case]
    img = _frame(src_hw, 1)
    trans = _trans(case)
    got = warp.warp_affine_plain(torch.from_numpy(img),
                                 warp.inverse_matrices(trans)[0], (oh, ow))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (oh, ow, 3)
    np.testing.assert_array_equal(got.numpy(), warp_image(img, trans,
                                                          (ow, oh)))
    np.testing.assert_array_equal(got.numpy(), cv2.warpAffine(
        img, trans[:2], (ow, oh), flags=cv2.INTER_LINEAR))


def test_shear_is_warp_image_bitwise():
    img = _frame((60, 90), 2)
    trans = np.array([[0.7, 0.3, -5.5], [-0.2, 1.1, 3.0]])
    got = warp.warp_affine_plain(torch.from_numpy(img),
                                 warp.inverse_matrices(trans)[0], (50, 70))
    np.testing.assert_array_equal(got.numpy(), warp_image(img, trans,
                                                          (70, 50)))


def test_mixed_size_batch_on_the_cpu():
    """Frames of three sizes into one output batch, each with its own
    matrix: each is ``warp_image`` of its frame."""
    sizes = [(72, 128), (90, 160), (45, 64)]
    imgs = [_frame(hw, i) for i, hw in enumerate(sizes)]
    trans = [get_affine_transform(np.array([w / 2, h / 2], np.float32),
                                  max(h, w), 0, (128, 64)) for h, w in sizes]
    out = torch.zeros((3, 64, 128, 3), dtype=torch.uint8)
    ret = warp.warp_affine([torch.from_numpy(i) for i in imgs],
                           warp.inverse_matrices(np.stack(trans)), out)
    assert ret is out
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(out[i].numpy(),
                                      warp_image(img, trans[i], (128, 64)))


def test_inverse_matrices_are_warp_images():
    trans = _trans("augmented")
    inv = warp.inverse_matrices(np.stack([trans, trans]))
    assert inv.dtype == np.float32 and inv.shape == (2, 6)
    from centerfusiondetect3d_tpu_torch.data.transforms import _invert_affine
    np.testing.assert_array_equal(inv[1], _invert_affine(trans).astype(
        np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_wrapper_refuses_frames_that_are_not_uint8(dtype):
    src = torch.zeros((8, 8, 3), dtype=dtype)
    out = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        warp.warp_affine([src], np.zeros((1, 6), np.float32), out)
    with pytest.raises(TypeError, match="uint8"):
        warp.warp_affine_plain(src, np.zeros(6, np.float32), (4, 4))


def test_wrapper_refuses_mismatched_arguments():
    src = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2 matrices"):
        warp.warp_affine([src], np.zeros((2, 6), np.float32),
                         torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="one size"):
        warp.warp_affine([src, src], np.zeros((2, 6), np.float32),
                         [torch.zeros((4, 4, 3), dtype=torch.uint8),
                          torch.zeros((4, 5, 3), dtype=torch.uint8)])
    with pytest.raises(TypeError, match="uint8"):
        warp.warp_affine([src[..., :1]], np.zeros((1, 6), np.float32),
                         torch.zeros((1, 4, 4, 3), dtype=torch.uint8))


def test_wrapper_has_no_kernel_for_another_device():
    src = torch.zeros((8, 8, 3), dtype=torch.uint8, device="meta")
    out = torch.zeros((1, 4, 4, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        warp.warp_affine([src], np.zeros((1, 6), np.float32), out)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the wrapper's
    card path without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_the_card_path_launches_on_the_frames_and_never_reads_them(
        monkeypatch):
    """On a CUDA tensor the wrapper neither runs the plain version nor
    copies a frame to the host or to numpy: it hands the frames, the
    outputs and the matrices to the launch, one launch per MAX_IMAGES."""
    launches = []
    monkeypatch.setattr(warp, "_launch", lambda s, o, inv, hw: launches.append(
        (len(s), len(o), inv.shape, hw)))
    monkeypatch.setattr(warp, "warp_affine_plain", None)
    for name in ("numpy", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: (
            _ for _ in ()).throw(AssertionError("a frame left the card")))
    n = warp.MAX_IMAGES + 3
    srcs = [torch.Tensor._make_subclass(_OnCard, torch.zeros(
        (9, 7, 3), dtype=torch.uint8)) for _ in range(n)]
    out = torch.Tensor._make_subclass(_OnCard, torch.zeros(
        (n, 4, 5, 3), dtype=torch.uint8))
    warp.warp_affine(srcs, np.zeros((n, 6), np.float32), out)
    assert launches == [(warp.MAX_IMAGES, warp.MAX_IMAGES,
                         (warp.MAX_IMAGES, 6), (4, 5)),
                        (3, 3, (3, 6), (4, 5))]
    assert "np." not in inspect.getsource(warp._launch).replace(
        "np.ascontiguousarray(inv", "")


def test_warp_builds_at_first_launch_only(monkeypatch):
    built = []
    monkeypatch.setattr(warp, "load_kernel_library",
                        lambda source: built.append(source))
    src = torch.zeros((8, 8, 3), dtype=torch.uint8)
    warp.warp_affine([src], np.zeros((1, 6), np.float32),
                     torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
    assert built == []


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_plain_bitwise(case):
    device = _card()
    src_hw, (oh, ow), _, _ = CASES[case]
    img = torch.from_numpy(_frame(src_hw, 3))
    inv = warp.inverse_matrices(_trans(case))
    out = torch.empty((1, oh, ow, 3), dtype=torch.uint8, device=device)
    before = warp.warp_affine.launches
    warp.warp_affine([img.to(device)], inv, out)
    torch.cuda.synchronize()
    assert warp.warp_affine.launches == before + 1
    want = warp.warp_affine_plain(img, inv[0], (oh, ow))
    assert torch.equal(out[0].cpu(), want), int((out[0].cpu() != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, warp.MAX_IMAGES + 2])
def test_kernel_batches_and_mixed_sizes_are_plain_bitwise(n):
    device = _card()
    sizes = [(900, 1600)] * 4 + [(256, 448), (90, 150)]
    sizes = (sizes * (n // len(sizes) + 1))[:n]
    imgs = [torch.from_numpy(_frame(hw, 10 + i)) for i, hw in enumerate(sizes)]
    trans = np.stack([get_affine_transform(
        np.array([w / 2, h / 2], np.float32), max(h, w) * (1 + 0.01 * i),
        3 * i, (800, 448)) for i, (h, w) in enumerate(sizes)])
    inv = warp.inverse_matrices(trans)
    out = torch.empty((n, 448, 800, 3), dtype=torch.uint8, device=device)
    before = warp.warp_affine.launches
    warp.warp_affine([im.to(device) for im in imgs], inv, out)
    torch.cuda.synchronize()
    assert warp.warp_affine.launches - before == -(-n // warp.MAX_IMAGES)
    for i, im in enumerate(imgs):
        assert torch.equal(out[i].cpu(), warp.warp_affine_plain(
            im, inv[i], (448, 800))), i


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_the_serving_batch_is_the_cpu_paths(device):
    """``Detector.load_data`` and ``pre_process`` on six repo JPEG paths
    and on a batch that mixes crops and warps of paths and arrays
    (``chip_smoke.check_batch_images``): on the card nvJPEG, the device
    crops and one ``warp_affine`` launch scattered into the batch write
    bitwise what the CPU's ``pre_process`` writes from the same decoded
    frames, and within the decoder's limits of the CPU's cv2 decode; on
    the CPU the check runs the CPU path against itself."""
    pytest.importorskip("cv2")  # the CPU path's decoder
    import chip_smoke
    from centerfusiondetect3d_tpu_torch.config import load_config
    from centerfusiondetect3d_tpu_torch.runtime.detector import Detector

    if device == "cuda":
        _card()
    det = Detector(load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)"],
                               num_classes=10), device=device)
    rows = chip_smoke.check_batch_images(det, rehearsal=device == "cpu")
    assert [r["images"] for r in rows] == [6, 5]
    assert [r["warp_launches"] for r in rows] == [int(device == "cuda")] * 2
    assert all(r["bytes_differing_same_frames"] == 0 for r in rows)
