"""Synthetic inputs and seeded weights for runs without a dataset.

Used by ``chip_smoke.py``, ``tools/profile_serving.py`` and
``tools/profile_training.py`` to drive the serving and training paths at the
full width of ``configs/Centerfusion_Middle.yaml`` with nothing but a seed:
random weights with BatchNorm statistics calibrated on one synthetic batch,
camera frames with radar clouds, and an in-memory training set
(``SyntheticTrainingSet``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data.radar import prepare_radar_points
from ..data.targets import TargetBuilder
from ..geometry.affine import get_affine_transform
from ..geometry.transforms3d import get_3d_box_np, project_3d_points_np
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
# The YAML leaves MIXED_PRECISION at its default, True: MAIN_PATH_OPTS serve
# and train in bf16. Runs that mean float32 add these overrides.
FP32_OPTS = ["MIXED_PRECISION", "False"]
# the training main path: the flagship's batch of 26 (MAIN_PATH_OPTS) in
# microbatches of 13; 2 epochs, the first frozen (DEFREEZE 0), before the
# first validation epoch; TRAIN_ITEMS items give 2 steps per epoch
TRAIN_OPTS = ["TRAIN.GRAD_ACCUM", "2", "MODEL.DEFREEZE", "0",
              "TRAIN.EPOCHS", "2"]
TRAIN_ITEMS = 52


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
        for name in ("depth", "depth2"):  # depth2: radar models only
            if hasattr(heads, name):
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


# nuScenes image statistics and attribute groups (the JAX package's
# NuScenesDataset: mean/std of data/dataset.py:290-291, nuscenes_att_range)
NUSCENES_MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
NUSCENES_STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
NUSCENES_ATT_RANGE = {0: [0, 1], 1: [0, 1], 2: [2, 3, 4], 3: [2, 3, 4],
                      4: [2, 3, 4], 5: [5, 6, 7], 6: [5, 6, 7], 7: [5, 6, 7]}
NUSCENES_MAX_OBJS = 128


class SyntheticTrainingSet:
    """An in-memory training set with the items of the JAX package's
    ``GenericDataset.get_item`` (``data/dataset.py:85-234``) for a radar
    frustum config: ``image`` (H, W, 3) normalized, ``calib``, ``pc_2d``,
    ``pc_3d``, ``pc_N``, ``pc_dep``, the ``TargetBuilder`` targets and the
    ground-truth frustum ``pc_hm``.

    Item ``i`` is drawn from ``seed`` and ``i`` alone: 3 to 8 objects in
    front of a nuScenes-like camera (focal 0.79 x width) with 3D boxes,
    classes, attributes and velocities, drawn as bright boxes into a
    textured image that already has the network's input size (so no warp
    and no image decoder is needed), radar returns on every object plus
    clutter, painted into ``pc_dep`` by ``data/radar.py``. Every head has
    positives in every item. ``get_item`` ignores ``rng``: there is no
    augmentation.
    """

    def __init__(self, config, n_items: int, seed: int = 0,
                 num_classes: int = 10):
        self.config = config
        self.n_items = int(n_items)
        self.seed = int(seed)
        self.num_classes = num_classes
        in_h, in_w = config.MODEL.INPUT_SIZE
        out_h, out_w = config.MODEL.OUTPUT_SIZE
        self.focal = 0.79 * in_w
        self.calib = np.array([[self.focal, 0, in_w / 2, 0],
                               [0, self.focal, in_h / 2, 0],
                               [0, 0, 1, 0]], np.float32)
        center = np.array([in_w / 2.0, in_h / 2.0], np.float32)
        self.trans_out = get_affine_transform(center, float(max(in_h, in_w)),
                                              0, (out_w, out_h))
        self.builder = TargetBuilder(config, num_classes, NUSCENES_MAX_OBJS,
                                     NUSCENES_ATT_RANGE)

    def __len__(self):
        return self.n_items

    def _objects(self, rng):
        in_h, in_w = self.config.MODEL.INPUT_SIZE
        anns = []
        n_objects = rng.randint(3, 9)
        while len(anns) < n_objects:
            depth = rng.uniform(8.0, 45.0)
            dim = np.array([rng.uniform(1.4, 2.0), rng.uniform(1.6, 2.1),
                            rng.uniform(3.6, 5.0)], np.float32)  # h, w, l
            loc = np.array([rng.uniform(-0.35, 0.35) * depth,
                            rng.uniform(1.2, 1.8), depth], np.float32)
            yaw = np.float32(rng.uniform(-np.pi, np.pi))
            corners = get_3d_box_np(dim, loc, yaw)
            uv = project_3d_points_np(corners, self.calib)
            x1, y1 = np.clip(uv.min(0), 0, [in_w - 2, in_h - 2])
            x2, y2 = np.clip(uv.max(0), 0, [in_w - 1, in_h - 1])
            if x2 - x1 < 4 or y2 - y1 < 4:
                continue
            center3d = loc - np.array([0, dim[0] / 2, 0], np.float32)
            amodal = project_3d_points_np(center3d[None], self.calib)[0]
            alpha = float(yaw - np.arctan2(amodal[0] - in_w / 2, self.focal))
            vel = rng.randn(3).astype(np.float32) * 3.0
            anns.append({
                "category_id": int(rng.randint(1, self.num_classes + 1)),
                "bbox": [float(x1), float(y1), float(x2 - x1),
                         float(y2 - y1)],
                "dimension": dim.tolist(), "location": loc.tolist(),
                "depth": float(depth), "yaw": float(yaw), "alpha": alpha,
                "amodal_center": amodal.tolist(),
                "attributes": int(rng.randint(1, 9)),
                "velocity_cam": [*vel.tolist(), 0.0], "truncated": 0,
            })
        return anns

    def _radar(self, rng, anns):
        """18-row returns: 6 on each object's near face, moving with it,
        and 120 of clutter."""
        cols = []
        for a in anns:
            (h, w, l), (x, y, z) = a["dimension"], a["location"]
            n = 6
            pts = np.zeros((18, n), np.float32)
            pts[0] = x + rng.uniform(-w / 2, w / 2, n)
            pts[1] = y - rng.uniform(0.2, h - 0.2, n)
            pts[2] = z - rng.uniform(0.0, l / 2, n)
            pts[8] = a["velocity_cam"][0]
            pts[9] = a["velocity_cam"][2]
            cols.append(pts)
        m = 120
        clutter = np.zeros((18, m), np.float32)
        clutter[2] = rng.uniform(2.0, 58.0, m)
        clutter[0] = rng.uniform(-0.6, 0.6, m) * clutter[2]
        clutter[1] = rng.uniform(-0.05, 0.1, m) * clutter[2]
        clutter[8:10] = rng.randn(2, m)
        cols.append(clutter)
        return np.concatenate(cols, axis=1)

    def _image(self, rng, anns):
        in_h, in_w = self.config.MODEL.INPUT_SIZE
        yy, xx = np.mgrid[0:in_h, 0:in_w].astype(np.float32)
        img = 110 + 40 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
        img = img[..., None] + rng.randint(-30, 31, (in_h, in_w, 3))
        for a in sorted(anns, key=lambda a: -a["depth"]):
            x, y, w, h = (int(round(v)) for v in a["bbox"])
            shade = 60 + 18 * a["category_id"]
            img[y:y + h + 1, x:x + w + 1] = (shade, 255 - shade, 200)
        img = np.clip(img, 0, 255).astype(np.float32) / 255.0
        return ((img - NUSCENES_MEAN) / NUSCENES_STD).astype(np.float32)

    def _rng(self, index: int):
        return np.random.RandomState(self.seed * 1_000_003 + int(index))

    def annotations(self, index: int):
        """Item ``index``'s objects as ``GenericDataset`` annotations."""
        return self._objects(self._rng(index))

    def get_item(self, index: int, rng=None):
        cfg = self.config
        in_h, in_w = cfg.MODEL.INPUT_SIZE
        r = self._rng(index)
        anns = self._objects(r)
        img_info = {"calib": self.calib.tolist(),
                    "camera_intrinsic": self.calib[:, :3].tolist(),
                    "width": in_w, "height": in_h}
        pc_2d, pc_n, pc_dep, pc_3d = prepare_radar_points(
            self._radar(r, anns), img_info, cfg, self.trans_out)
        item = {"image": self._image(r, anns), "calib": self.calib.copy(),
                "pc_2d": pc_2d.T, "pc_3d": pc_3d.T, "pc_N": pc_n,
                "pc_dep": pc_dep}
        item.update(self.builder.build(
            anns, {}, self.trans_out, 1.0, calib=self.calib, pc_dep=pc_dep))
        return item
