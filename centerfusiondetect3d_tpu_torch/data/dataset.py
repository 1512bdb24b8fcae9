"""Dataset: COCO-format samples -> full training/eval item dicts (numpy, NHWC).

Re-design of the reference GenericDataset / nuScenes dataset
(reference src/lib/dataset/generic_dataset.py:41-270,
datasets/nuscenes.py:32-391): per-sample image load + augmentation + affine
warp, radar/lidar point-cloud prep, and target building via
``targets.TargetBuilder``. Pure functions of an explicit numpy RandomState -
no hidden global RNG - so the pipeline is reproducible and thread-parallel.

The port's own copy of ``centerfusiondetect3d_tpu/data/dataset.py``, but
for the image decoder and the warp: a dataset decodes its JPEGs on the
device it is given (``data/image_io.py``: cv2 on the CPU, nvJPEG on the
card; the card unless the caller names another device) and warps with
``data/transforms.py:warp_image``, cv2's arithmetic in numpy. With
``DEBUG > 1`` each item with radar also writes the JAX package's pillar
renders (``utils/visualize.py:debug_pillars``) into ``OUTPUT_DIR/debug``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ..geometry.affine import get_affine_transform
from ..utils.device import resolve_device
from .coco import CocoReader
from .image_io import read_image
from .targets import TargetBuilder
from .transforms import flip_annotations, sample_augment_params, transform_input
from .radar import prepare_radar_points


class GenericDataset:
    """Base dataset over converter-format COCO json."""

    num_categories: int = 10
    class_ids: Dict[int, int] = {}
    max_objs: int = 128
    focal_length: float = 1200.0
    default_resolution = (900, 1600)
    mean = np.zeros(3, np.float32)
    std = np.ones(3, np.float32)
    nuscenes_att_range: Dict[int, list] = {}

    def __init__(self, config, split: str, ann_path: str, img_dir: str,
                 device=None):
        self.config = config
        self.device = resolve_device(device)  # the image decoder's
        self.split = split
        self.img_dir = img_dir
        self.coco = CocoReader(ann_path)
        self.images = self.coco.get_img_ids()
        # meta (true per-image center/scale/img_id) rides with every item of
        # an eval split. The reference gates this on OFFICIAL_EVAL/EVAL
        # (generic_dataset.py enable_meta) and its in-training val leans on
        # default_resolution matching the real image size (900x1600); with
        # arbitrary image sizes that fallback unprojects detections with the
        # WRONG center/scale — found by the round-5 from-scratch campaign
        # (448x256 frames, val mAP pinned at 0 while the loss trained) — so
        # eval splits always carry meta here.
        self.enable_meta = (
            split in ("val", "mini_val", "test")
            or config.TEST.OFFICIAL_EVAL
            or config.EVAL
            or config.weights.get("bbox3d", 0) > 0
        )
        self.builder = TargetBuilder(
            config, self.num_categories, self.max_objs, self.nuscenes_att_range
        )

    def __len__(self):
        return len(self.images)

    # -- hooks ---------------------------------------------------------------
    def load_image(self, img_info) -> np.ndarray:
        return read_image(os.path.join(self.img_dir, img_info["file_name"]),
                          self.device)

    def load_radar(self, img_info) -> Optional[np.ndarray]:
        raise NotImplementedError

    def load_lidar(self, img_info) -> Optional[np.ndarray]:
        raise NotImplementedError

    # -- main ----------------------------------------------------------------
    def get_item(self, index: int, rng: Optional[np.random.RandomState] = None):
        """Build the full item dict for one sample.

        rng enables training augmentation; None means deterministic eval mode.
        """
        cfg = self.config
        img_id = self.images[index]
        img_info = self.coco.load_imgs(img_id)[0]
        # shared CocoReader table rows: read-only here. The one mutating
        # transform (flip_annotations) owns copy-on-write and returns fresh
        # dicts; everything else must not write into these.
        anns = self.coco.load_anns(self.coco.get_ann_ids(img_id))
        img = self.load_image(img_info)

        center = np.array(
            [img_info["width"] / 2.0, img_info["height"] / 2.0], np.float32
        )
        if cfg.DATASET.MAX_CROP:
            scale = max(img_info["height"], img_info["width"]) * 1.0
        else:
            scale = np.array([img_info["width"], img_info["height"]], np.float32)

        calib = np.array(
            img_info.get(
                "calib",
                [
                    [self.focal_length, 0, img_info["width"] / 2, 0],
                    [0, self.focal_length, img_info["height"] / 2, 0],
                    [0, 0, 1, 0],
                ],
            ),
            np.float32,
        )

        is_train = "train" in self.split and rng is not None
        scale_factor, rotate_factor, flipped = 1.0, 0.0, False
        if is_train:
            center, scale_factor, rotate_factor = sample_augment_params(
                rng, center, scale, img_info["width"], img_info["height"], cfg
            )
            scale = scale * scale_factor
            if rng.random_sample() < cfg.DATASET.FLIP:
                flipped = True
                img = img[:, ::-1, :]
                anns = flip_annotations(
                    anns,
                    img_info["width"],
                    cfg.heads,
                    cfg.DATASET.RADAR_PC,
                    np.array(img_info["velocity_trans_matrix"], np.float32)
                    if "velocity_trans_matrix" in img_info
                    else None,
                )

        in_h, in_w = cfg.MODEL.INPUT_SIZE
        out_h, out_w = cfg.MODEL.OUTPUT_SIZE
        trans_in = get_affine_transform(center, scale, rotate_factor, (in_w, in_h))
        trans_out = get_affine_transform(center, scale, rotate_factor, (out_w, out_h))

        item: Dict = {
            "image": transform_input(
                img, trans_in, (in_h, in_w), self.mean, self.std,
                rng=rng, color_aug=is_train and cfg.DATASET.COLOR_AUG,
            ),
            "calib": calib,
        }

        pc_dep = None
        if cfg.DATASET.RADAR_PC:
            radar = self.load_radar(img_info)
            if radar is None:
                # keep batch shapes consistent: a missing sweep is an empty cloud
                radar = np.zeros((18, 0), np.float32)
            pc_2d, pc_n, pc_dep, pc_3d = prepare_radar_points(
                radar, img_info, cfg, trans_out, flipped,
                img_info["width"], img_info["height"],
            )
            item.update(
                {"pc_2d": pc_2d.T, "pc_3d": pc_3d.T, "pc_N": pc_n, "pc_dep": pc_dep}
            )
            if cfg.DEBUG > 1:
                # pillar inspection renders (debugPillar,
                # generic_dataset.py:959-1129), written as files
                from ..utils.visualize import debug_pillars
                from .radar import pillar_sizes

                n = int(pc_n)
                debug_pillars(
                    img, pc_2d[:, :n],
                    pillar_sizes(pc_3d[:, :n], calib[:3, :4], trans_out,
                                 (out_h, out_w), cfg.DATASET.PILLAR_DIMS),
                    trans_in, trans_out, (in_h, in_w), (out_h, out_w),
                    os.path.join(cfg.OUTPUT_DIR, "debug"), index=index,
                    max_dist=float(cfg.DATASET.MAX_PC_DIST),
                )

        if cfg.weights.get("lidar_depth", 0) > 0:
            lidar = self.load_lidar(img_info)
            if lidar is not None:
                if flipped:
                    # flip only REAL points: the array is already zero-padded
                    # and mirroring pad columns would mint fake points at
                    # x = out_w-1 that pass the depth loss's pc > 0 mask
                    # (reference flips before padding, nuscenes.py:339-345)
                    valid = lidar[2] > 0
                    lidar[0, valid] = (out_w - 1) - lidar[0, valid]
                item["pc_lidar"] = lidar.T  # (N, 3)

        built = self.builder.build(
            anns, self.class_ids, trans_out, scale_factor, calib=calib, pc_dep=pc_dep
        )
        item.update(built)

        if cfg.DATASET.RADAR_PC and not cfg.MODEL.FRUSTUM and pc_dep is not None:
            # non-frustum train-time normalization (generic_dataset.py:229-238)
            pc_hm = pc_dep.copy()
            s = int(cfg.DATASET.MAX_PC_DIST) if cfg.DATASET.ONE_HOT_PC else 1
            pc_hm[..., :s] = 1.0 - pc_hm[..., :s] / cfg.DATASET.MAX_PC_DIST
            item["pc_hm"] = pc_hm

        if cfg.weights.get("bbox3d", 0) > 0:
            # inverse output->original affine for the bbox3d decode loss:
            # the reference derives ONE matrix from batch meta at loss time
            # (genericLoss.py:70-77); here each sample carries its own
            # (documented improvement — per-sample aug means per-sample
            # matrices; GenericLoss accepts (2,3) or (B,2,3))
            item["trans_mat"] = get_affine_transform(
                center, scale, rotate_factor, (out_w, out_h), inverse=True
            ).astype(np.float32)
            # hflipped samples decode in the mirrored frame while the 3D
            # corner targets come from the unflipped annotation — supervising
            # them would pull x toward its mirror. The reference shares this
            # blind spot (its meta-derived matrix ignores flip too); here the
            # loss is masked out for flipped samples instead of corrupted.
            item["trans_mat_valid"] = np.float32(0.0 if flipped else 1.0)

        if cfg.DEBUG > 0 or self.enable_meta:
            item["meta"] = {
                "center": center,
                "scale": scale,
                "img_id": img_info["id"],
                "img_width": img_info["width"],
                "img_height": img_info["height"],
                "isFliped": flipped,
                "velocity_mat": np.array(
                    img_info.get("velocity_trans_matrix", np.eye(4)), np.float32
                ),
            }
        return item


class NuScenesDataset(GenericDataset):
    """nuScenes metadata + converter-format loading (datasets/nuscenes.py:32-391)."""

    default_resolution = (900, 1600)
    num_categories = 10
    max_objs = 128

    class_name = [
        "car", "truck", "bus", "trailer", "construction_vehicle",
        "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
    ]
    class_ids = {i + 1: i + 1 for i in range(num_categories)}

    vehicles = ["car", "truck", "bus", "trailer", "construction_vehicle"]
    cycles = ["motorcycle", "bicycle"]
    pedestrians = ["pedestrian"]

    attribute_to_id = {
        "": 0,
        "cycle.with_rider": 1,
        "cycle.without_rider": 2,
        "pedestrian.moving": 3,
        "pedestrian.standing": 4,
        "pedestrian.sitting_lying_down": 5,
        "vehicle.moving": 6,
        "vehicle.parked": 7,
        "vehicle.stopped": 8,
    }
    id_to_attribute = {v: k for k, v in attribute_to_id.items()}

    SENSOR_NAME = {
        1: "CAM_FRONT", 2: "CAM_FRONT_RIGHT", 3: "CAM_BACK_RIGHT", 4: "CAM_BACK",
        5: "CAM_BACK_LEFT", 6: "CAM_FRONT_LEFT", 7: "RADAR_FRONT", 8: "LIDAR_TOP",
        9: "RADAR_FRONT_LEFT", 10: "RADAR_FRONT_RIGHT", 11: "RADAR_BACK_LEFT",
        12: "RADAR_BACK_RIGHT",
    }
    RADARS_FOR_CAMERA = {
        "CAM_FRONT_LEFT": ["RADAR_FRONT_LEFT", "RADAR_FRONT"],
        "CAM_FRONT": ["RADAR_FRONT_RIGHT", "RADAR_FRONT_LEFT", "RADAR_FRONT"],
        "CAM_FRONT_RIGHT": ["RADAR_FRONT_RIGHT", "RADAR_FRONT"],
        "CAM_BACK_LEFT": ["RADAR_BACK_LEFT", "RADAR_FRONT_LEFT"],
        "CAM_BACK": ["RADAR_BACK_RIGHT", "RADAR_BACK_LEFT"],
        "CAM_BACK_RIGHT": ["RADAR_BACK_RIGHT", "RADAR_FRONT_RIGHT"],
    }
    SPLITS = {
        "mini_val": "v1.0-mini", "mini_train": "v1.0-mini",
        "train": "v1.0-trainval", "val": "v1.0-trainval", "test": "v1.0-test",
    }
    nuscenes_att_range = {
        0: [0, 1], 1: [0, 1],
        2: [2, 3, 4], 3: [2, 3, 4], 4: [2, 3, 4],
        5: [5, 6, 7], 6: [5, 6, 7], 7: [5, 6, 7],
    }

    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)

    def __init__(self, config, split: str, device=None):
        data_dir = os.path.join(config.DATASET.ROOT, "nuscenes")
        ann_path = os.path.join(data_dir, "annotations", f"{split}.json")
        super().__init__(config, split, ann_path, data_dir, device)

    def convert_eval_format(self, results):
        from .nuscenes_eval import convert_eval_format

        return convert_eval_format(results, self)

    def run_eval(self, results, save_dir: str, verbose: bool = False):
        """Submission dump + native scoring (nuscenes.py:559-587)."""
        from .nuscenes_eval import run_eval

        return run_eval(results, self, save_dir, verbose)

    @staticmethod
    def log_valid_result(logger, summaries):
        """Log per-range/per-extreme metrics (nuscenes.py:589-626)."""
        if not summaries:
            return
        ranges = {"range_10": "0-10", "range_30": "10-30", "range_50": "30-50",
                  "range_all": "0-50"}
        for variant, metrics in summaries.items():
            base = variant.replace("_extreme", "")
            logger.info("Eval range: %s | extreme: %s",
                        ranges.get(base, base), "_extreme" in variant)
            logger.info("AP/overall: %.2f%%", metrics["mean_ap"] * 100.0)
            for k, v in metrics["mean_dist_aps"].items():
                logger.info("AP/%s: %.2f%%", k, v * 100.0)
            for k, v in metrics["tp_errors"].items():
                logger.info("Scores/%s: %s", k, v)
            logger.info("Scores/NDS: %s", metrics["nd_score"])

    def _pc_path(self, kind: str, img_info) -> str:
        sensor = self.SENSOR_NAME[img_info["sensor_id"]]
        return os.path.join(
            self.img_dir, "annotations", kind, sensor, f"{img_info['sample_token']}.bin"
        )

    def load_radar(self, img_info):
        path = self._pc_path("radar_pc", img_info)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return np.array(pickle.load(f), np.float32)

    def load_lidar(self, img_info):
        """Lidar aux points mapped to output coords, padded to 4000
        (nuscenes.py:296-346)."""
        path = self._pc_path("lidar_pc", img_info)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            pc = np.array(pickle.load(f), np.float32)  # (3, N) [x, y, d]
        out_h, out_w = self.config.MODEL.OUTPUT_SIZE
        pc[0] *= out_w / img_info["width"]
        pc[1] *= out_h / img_info["height"]
        pc = pc[:, pc[2] <= self.config.DATASET.MAX_PC_DIST]
        fixed = np.zeros((3, 4000), np.float32)
        n = min(4000, pc.shape[1])
        fixed[:, :n] = pc[:, :n]
        return fixed


DATASETS = {"nuscenes": NuScenesDataset}


def get_dataset(name: str):
    """Dataset registry (dataset_factory.py:7-12)."""
    return DATASETS[name]
