"""Image-file decoding (``data/image_io.py``): cv2 on the CPU, nvJPEG and
libjpeg's chroma upsampling and colour conversion on the card.

``chip_smoke.py`` holds the card's decoder against ``DECODE_REFERENCE``,
per-channel means and the means of a 4x4 grid of cells of cv2's decode of
three ``mini_val`` JPEGs of the repo's data, and against ``DECODE_CROPS``,
16x16 crops of that decode, pixel by pixel. The CPU cases check those
literals against cv2 here, so they cannot go stale, that the CPU decoder is
``cv2.imread`` itself, and that ``ycc_to_bgr_plain`` (the plain version of
the card's colour kernel) turns a JPEG's planes into cv2's pixels bitwise:
on images of flat 16x16 (or 32x32) blocks encoded at quality 100, whose
planes PIL reads exactly (Y as decoded; a chroma sample is its block's
value), at 4:2:0, 4:2:2, 4:4:4 and grey, even and odd sizes. The ``cuda``
cases hold the decoder within the smoke's limits of the literals and, where
the card's machine has cv2, of cv2's decode of every image of the repo's
data; the colour kernel bitwise against its plain version; decodes from
six threads at once, each on its own stream as ``Detector.run_stream``'s
workers decode, bitwise the serial ones; the counts; and the refusal of
a file that is not a JPEG and of planes of a sampling the kernel does not
take.
"""

from __future__ import annotations

import glob
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from centerfusiondetect3d_tpu_torch.data import image_io

NAMES = sorted(chip_smoke.DECODE_REFERENCE)


def _path(name):
    return os.path.join(chip_smoke.DATA_ROOT, "nuscenes", name)


@pytest.mark.parametrize("name", NAMES)
def test_the_reference_literals_are_cv2s(name):
    cv2 = pytest.importorskip("cv2")
    img = cv2.imread(_path(name))
    assert img.shape == (256, 448, 3)
    means, cells = chip_smoke.decode_stats(img)
    want_means, want_cells = chip_smoke.DECODE_REFERENCE[name]
    np.testing.assert_allclose(means, want_means, rtol=0, atol=5e-4)
    np.testing.assert_allclose(cells, want_cells, rtol=0, atol=5e-4)
    crops = chip_smoke.crop_literal(name)
    assert len(crops) == 3
    for (y, x), want in crops:
        size = chip_smoke.CROP
        assert np.array_equal(img[y:y + size, x:x + size], want), (y, x)


def test_cpu_decoder_is_cv2_imread():
    cv2 = pytest.importorskip("cv2")
    path = _path(NAMES[0])
    got = image_io.read_image(path, "cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, cv2.imread(path))
    res = chip_smoke.decode_vs_reference("cpu")
    assert res["mean_levels"] <= 5e-4 and res["pixel_max"] == 0
    with pytest.raises(FileNotFoundError):
        image_io.read_image(path + ".missing", "cpu")


def _blocky_jpeg(h, w, block, sampling, seed):
    """(cv2's decode, PIL's Y, the raw Cb and Cr planes) of a seeded image
    of flat ``block`` x ``block`` colour blocks, encoded by cv2 at quality
    100 with ``sampling`` ("420", "422", "444" or "grey")."""
    cv2 = pytest.importorskip("cv2")
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // block + 1, w // block + 1, 3),
                         dtype=np.uint8)
    img = np.repeat(np.repeat(cells, block, 0), block, 1)[:h, :w]
    params = [cv2.IMWRITE_JPEG_QUALITY, 100]
    if sampling == "grey":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
            cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    decoded = cv2.imdecode(enc, cv2.IMREAD_COLOR)
    im = pil.open(io.BytesIO(enc.tobytes()))
    if sampling == "grey":
        return decoded, np.asarray(im), None, None
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    hs = 1 if sampling in ("420", "422") else 0
    vs = 1 if sampling == "420" else 0
    rows = np.arange(-(-h // (1 + vs))) * (1 + vs)
    cols = np.arange(-(-w // (1 + hs))) * (1 + hs)
    # a chroma sample is flat over its block: read it at the block's centre
    rows = np.minimum(rows // block * block + block // 2, h - 1)
    cols = np.minimum(cols // block * block + block // 2, w - 1)
    return (decoded, ycc[..., 0], ycc[rows][:, cols, 1].copy(),
            ycc[rows][:, cols, 2].copy())


@pytest.mark.parametrize("sampling", ["420", "422", "444", "grey"])
@pytest.mark.parametrize("h, w, block", [(256, 448, 16), (61, 83, 16),
                                         (48, 80, 32)])
def test_plain_colour_conversion_is_libjpegs(sampling, h, w, block):
    decoded, y, cb, cr = _blocky_jpeg(h, w, block, sampling, seed=h + w)
    planes = [None if p is None else torch.from_numpy(np.array(p))
              for p in (y, cb, cr)]
    got = image_io.ycc_to_bgr(*planes)  # a CPU tensor: the plain version
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert np.array_equal(got.numpy(), decoded)


def test_colour_conversion_refuses_other_samplings():
    y = torch.zeros((8, 8), dtype=torch.uint8)
    for shape in ((4, 8), (3, 4), (8, 3)):  # 4:4:0, off by one, a third
        c = torch.zeros(shape, dtype=torch.uint8)
        with pytest.raises(RuntimeError, match="chroma sampling"):
            image_io.ycc_to_bgr(y, c, c)
    with pytest.raises(RuntimeError, match="no kernel"):
        image_io.ycc_to_bgr(y.to("meta"), None, None)
    c = torch.zeros((4, 4), dtype=torch.uint8)
    for cb, cr in ((c, None), (c, c[:, :3]), (c, c.float()), (c, c[0])):
        with pytest.raises(RuntimeError, match="one shape"):
            image_io.ycc_to_bgr(y, cb, cr)


def test_decode_jpeg_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        image_io.decode_jpeg(np.zeros(4, np.uint8), "cpu")
    with pytest.raises(RuntimeError, match="no decoder"):
        image_io.read_image(_path(NAMES[0]), "meta")


@pytest.mark.cuda
def test_card_decode_is_within_the_limits_of_cv2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = image_io.decode_jpeg.launches
    converted = image_io.ycc_to_bgr.launches
    res = chip_smoke.decode_vs_reference("cuda")  # raises beyond the limits
    assert res["mean_levels"] <= chip_smoke.DECODE_TOL
    assert res["pixel_max"] <= chip_smoke.DECODE_PIXEL_TOL
    assert image_io.decode_jpeg.launches == before + len(NAMES)
    assert image_io.ycc_to_bgr.launches == converted + len(NAMES)
    img = image_io.read_image(_path(NAMES[0]), "cuda")
    assert img.shape == (256, 448, 3) and img.dtype == np.uint8


@pytest.mark.cuda
def test_card_decode_of_every_image_is_within_the_limits_of_cv2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cv2 = pytest.importorskip("cv2")
    paths = sorted(glob.glob(os.path.join(chip_smoke.DATA_ROOT, "nuscenes",
                                          "samples", "*", "*.jpg")))
    assert len(paths) == 500
    worst, total, n = 0, 0, 0
    for path in paths:
        d = np.abs(image_io.read_image(path, "cuda").astype(np.int16)
                   - cv2.imread(path))
        worst, total, n = max(worst, int(d.max())), total + int(d.sum()), \
            n + d.size
    print(f"\n{len(paths)} images: {worst} levels at most, {total / n:.4f} "
          f"on average from cv2 {cv2.__version__}")
    assert worst <= chip_smoke.DECODE_PIXEL_TOL
    assert total / n <= chip_smoke.DECODE_PIXEL_MEAN_TOL


@pytest.mark.cuda
def test_concurrent_decodes_on_worker_streams_are_the_serial_ones():
    """Six threads decode the repo's 500 JPEGs at once, each on its own
    CUDA stream, while a seventh stream keeps the card busy with matrix
    products (as the forward does when ``run_stream`` serves): every frame
    is bitwise what a serial decode gives, though one nvJPEG decoder state
    serves all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    paths = sorted(glob.glob(os.path.join(chip_smoke.DATA_ROOT, "nuscenes",
                                          "samples", "*", "*.jpg")))
    data = [np.fromfile(p, np.uint8) for p in paths]
    want = [image_io.decode_jpeg_device(d, "cuda").cpu() for d in data]
    local = threading.local()

    def decode(d):
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream()
        with torch.cuda.stream(local.stream):
            return image_io.decode_jpeg_device(d, "cuda").cpu()

    busy = torch.cuda.Stream()
    a = torch.randn((4096, 4096), device="cuda")
    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = [pool.submit(decode, d) for d in data]
        with torch.cuda.stream(busy):
            while not all(f.done() for f in futures):
                for _ in range(4):
                    a = torch.tanh(a @ a)
                busy.synchronize()
        got = [f.result() for f in futures]
    bad = [os.path.basename(p) for p, g, w in zip(paths, got, want)
           if not torch.equal(g, w)]
    assert not bad, f"{len(bad)} of {len(paths)} differ: {bad[:8]}"


@pytest.mark.cuda
def test_colour_kernel_is_bitwise_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert chip_smoke.ycc_kernel_vs_plain("cuda") == 4 * len(NAMES)
    y = torch.zeros((8, 8), dtype=torch.uint8, device="cuda")
    c = torch.zeros((4, 8), dtype=torch.uint8, device="cuda")  # 4:4:0
    with pytest.raises(RuntimeError, match="chroma sampling"):
        image_io.ycc_to_bgr(y, c, c)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["420", "422", "444", "grey", "440"])
def test_card_decode_of_each_sampling(sampling, tmp_path):
    """A repo image written by cv2 at each chroma sampling: the card's
    decode within the smoke's limits of cv2's, and 4:4:0, which the colour
    kernel does not take, refused by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cv2 = pytest.importorskip("cv2")
    img = cv2.imread(_path(NAMES[0]))
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if sampling == "grey":
        img = img[..., 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
            cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    path = str(tmp_path / f"s{sampling}.jpg")
    assert cv2.imwrite(path, img[:253, :443], params)  # odd sizes
    if sampling == "440":
        with pytest.raises(RuntimeError, match=f"s440.jpg.*chroma sampling"):
            image_io.read_image(path, "cuda")
        return
    d = np.abs(image_io.read_image(path, "cuda").astype(np.int16)
               - cv2.imread(path))
    assert d.shape == (253, 443, 3)
    assert d.max() <= chip_smoke.DECODE_PIXEL_TOL
    assert d.mean() <= chip_smoke.DECODE_PIXEL_MEAN_TOL


@pytest.mark.cuda
def test_nvjpeg_names_the_file_it_cannot_decode(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bad = tmp_path / "not_a.jpg"
    bad.write_bytes(b"\xff\xd8 this is not a JPEG")
    with pytest.raises(RuntimeError, match="not_a.jpg"):
        image_io.read_image(str(bad), "cuda")
