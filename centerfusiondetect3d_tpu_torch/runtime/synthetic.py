"""Synthetic serving inputs and seeded weights for runs without a dataset.

Used by ``chip_smoke.py`` and ``tools/profile_serving.py`` to drive the
serving path at the full width of ``configs/Centerfusion_Middle.yaml`` with
nothing but a seed: random weights with BatchNorm statistics calibrated on
one synthetic batch, and camera frames with radar clouds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .detector import Detector

# configs/Centerfusion_Middle.yaml as dotted overrides, so no YAML reader is
# needed, plus the serving settings it runs with (the defaults, stated)
MAIN_PATH_OPTS = [
    "NAME", "CenterFusion_Middle",
    "DATASET.TRAIN_SPLIT", "train", "DATASET.VAL_SPLIT", "val",
    "DATASET.RADAR_PC", "True",
    "MODEL.LOAD_DIR", "''", "MODEL.FREEZE_BACKBONE", "True",
    "MODEL.DEFREEZE", "170", "MODEL.FRUSTUM", "True",
    "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.DLA.NODE", "DeformConv",
    "TRAIN.BATCH_SIZE", "26", "TRAIN.EPOCHS", "200", "TRAIN.LR", "5.0e-5",
    "TRAIN.LR_STEP", "[185, 195]", "TRAIN.WARM_EPOCHS", "5",
    "TRAIN.SAVE_INTERVALS", "10", "TRAIN.VAL_INTERVALS", "10",
    "MODEL.INPUT_SIZE", "(448, 800)", "MODEL.K", "100",
    "TEST.DEVICE_RASTERIZE", "True",
]


def seeded_weights(model: torch.nn.Module, seed: int) -> None:
    """Weights from a seed: He-normal convs, DCN offset convs drawn so the
    offsets are ~1 px (non-zero, so a wrong kernel shows), BatchNorm affine
    from U(0.5, 1.5) / N(0, 0.1), and head biases for a car-sized object at
    ~20 m so that frustum association finds radar."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".up_" in name:
                continue  # fixed bilinear upsampling
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                std = (1.5 if "conv_offset_mask" in name else
                       math.sqrt(2.0)) / math.sqrt(fan_in)
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif name.endswith("weight"):  # BatchNorm scale
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        heads = model.detectHead_0
        heads.heatmap[-1].bias.fill_(-4.6)
        for name in ("depth", "depth2"):
            getattr(heads, name)[-1].bias.fill_(-math.log(20.0))
        heads.dimension[-1].bias.copy_(torch.tensor([1.5, 1.6, 4.0]))


def calibrate_batchnorm(det: Detector, frames) -> None:
    """Set every BatchNorm's running statistics to those of one synthetic
    batch, so activations keep unit scale through the random network as a
    trained one's do."""
    model = det.model
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch sets the stats
    model.train()
    try:
        det.run(*frames)
    finally:
        model.eval()


def synthetic_frames(n: int, height: int, width: int, seed: int):
    """n uint8 BGR frames with a nuScenes-like camera (focal 0.79 x width) and
    ~200 radar points each in front of it (18-row clouds, camera frame)."""
    rng = np.random.RandomState(seed)
    focal = 0.79 * width
    calib = np.array([[focal, 0, width / 2, 0], [0, focal, height / 2, 0],
                      [0, 0, 1, 0]], np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    images, infos, radars = [], [], []
    for i in range(n):
        base = (127 + 60 * np.sin(xx / (7.0 + i)) * np.cos(yy / 11.0))[..., None]
        noise = rng.randint(-40, 41, (height, width, 3))
        images.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        infos.append({"calib": calib.tolist(),
                      "camera_intrinsic": calib[:3, :3].tolist(),
                      "width": width, "height": height})
        m = 200
        pts = np.zeros((18, m), np.float32)
        pts[2] = rng.uniform(2.0, 58.0, m)
        pts[0] = rng.uniform(-0.6, 0.6, m) * pts[2]
        pts[1] = rng.uniform(-0.05, 0.1, m) * pts[2]
        pts[8:10] = rng.randn(2, m)
        radars.append(pts)
    return images, infos, radars
