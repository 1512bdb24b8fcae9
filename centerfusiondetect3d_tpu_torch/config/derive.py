"""Derived config: heads, loss weights, per-head tower widths, output sizes.

The port's own copy of ``centerfusiondetect3d_tpu/config/derive.py``: the
reference's derivation rules (``src/lib/config/utils.py:69-204``) — head dict,
per-head loss weights, head-tower channel lists, OUTPUT_SIZE = INPUT_SIZE // 4
— plus the consistency auto-corrections of its updateConfig
(``utils.py:23-64``).
"""

from __future__ import annotations

import os
import warnings

from .node import ConfigNode
from .defaults import default_config

DOWN_RATIO = 4


def update_config(config: ConfigNode, cfg_file: str | None = None, opts=()) -> ConfigNode:
    """Merge yaml + dotted overrides and apply consistency rules."""
    config.defrost()
    if cfg_file:
        config.merge_from_file(cfg_file)
    if opts:
        config.merge_from_list(opts)

    if config.DATASET.RADAR_PC:
        if config.MODEL.FRUSTUM and config.MODEL.FUSION_STRATEGY != "middle":
            warnings.warn("Frustum association needs middle fusion; disabling frustum.")
            config.MODEL.FRUSTUM = False
        if config.MODEL.FRUSTUM and config.DATASET.ONE_HOT_PC:
            # the reference hard-asserts this combination (detectHeads.py:48)
            raise ValueError(
                "ONE_HOT_PC is incompatible with frustum association "
                "(frustum heatmaps are [depth, vx, vz] 3-channel)"
            )
        # pillar/heatmap rasterization overwrites per point; keep nearest point
        # drawn last so it wins (reference: PC_REVERSE, config/utils.py:31-33)
        config.DATASET.PC_REVERSE = config.DATASET.PC_ROI_METHOD != "points"
    else:
        if config.MODEL.FRUSTUM:
            warnings.warn("Frustum association needs radar point cloud; disabling frustum.")
            config.MODEL.FRUSTUM = False
        if config.MODEL.FUSION_STRATEGY is not None:
            warnings.warn("Fusion strategy needs radar point cloud; disabling fusion.")
            config.MODEL.FUSION_STRATEGY = None

    if config.TRAIN.WARM_EPOCHS and config.TRAIN.LR_SCHEDULER != "StepLR":
        warnings.warn("Warmup epochs are only available for StepLR; disabling warmup.")
        config.TRAIN.WARM_EPOCHS = 0

    config.freeze()
    return config


def derive_heads(config: ConfigNode) -> dict:
    """Head name -> number of output channels (config/utils.py:69-106)."""
    heads = {
        "heatmap": config.DATASET.NUM_CLASSES,
        "reg": 2,
        "widthHeight": 2,
        "depth": 1,
        "rotation": 8,
        "dimension": 3,
        "amodal_offset": 2,
    }
    if config.DATASET.DATASET == "nuscenes":
        heads.update({"nuscenes_att": 8, "velocity": 3})
    if config.DATASET.RADAR_PC and config.MODEL.FUSION_STRATEGY == "middle":
        heads.update({"depth2": 1, "rotation2": 8})
    if config.TRAIN.UNCERTAINTY_LOSS:
        heads.update({"uncertainty": 1})
    return heads


def derive_weights(config: ConfigNode) -> dict:
    """Per-head loss weights (config/utils.py:109-141)."""
    lw = config.LOSS_WEIGHTS
    return {
        "heatmap": lw.HEATMAP,
        "widthHeight": lw.DIMENSION_2D,
        "reg": lw.AMODAL_OFFSET,
        "bbox2d": lw.BBOX_2D,
        "depth": lw.DEPTH,
        "depth2": lw.DEPTH,
        "rotation": lw.ROTATION,
        "rotation2": lw.ROTATION,
        "dimension": lw.DIMENSION_3D,
        "amodal_offset": lw.AMODAL_OFFSET,
        "bbox3d": lw.BBOX_3D,
        "lidar_depth": lw.LIDAR_DEPTH,
        "radar_depth": lw.RADAR_DEPTH,
        "nuscenes_att": lw.NUSCENES_ATT,
        "velocity": lw.VELOCITY,
    }


def derive_head_conv(config: ConfigNode, heads: dict) -> dict:
    """Per-head tower channel lists (config/utils.py:144-166)."""
    head_conv = {head: [256] for head in heads}
    if config.DATASET.RADAR_PC:
        if config.MODEL.FUSION_STRATEGY == "middle":
            head_conv.update({"depth2": [256] * 3, "rotation2": [256] * 3})
        if config.DATASET.DATASET == "nuscenes":
            head_conv.update({"velocity": [256] * 3, "nuscenes_att": [256] * 3})
    return head_conv


def finalize_config(config: ConfigNode, num_classes: int, default_resolution=None,
                    output_dir: str | None = None) -> ConfigNode:
    """Apply dataset-dependent derived fields (config/utils.py:169-204)."""
    config.defrost()
    if output_dir is not None:
        config.OUTPUT_DIR = output_dir
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "config.yaml"), "w") as f:
            f.write(config.dump())

    config.DATASET.NUM_CLASSES = num_classes
    if config.MODEL.INPUT_SIZE is None:
        config.MODEL.INPUT_SIZE = tuple(default_resolution)
    config.MODEL.OUTPUT_SIZE = (
        config.MODEL.INPUT_SIZE[0] // DOWN_RATIO,
        config.MODEL.INPUT_SIZE[1] // DOWN_RATIO,
    )
    # single-layer pyramid for DLA (dla.py:579 in the reference)
    config.MODEL.PYRAMID_OUT_SIZE = (tuple(config.MODEL.OUTPUT_SIZE),)
    if not config.MODEL.FREEZE_BACKBONE:
        config.MODEL.DEFREEZE = 0

    config.heads = ConfigNode(derive_heads(config))
    config.weights = ConfigNode(derive_weights(config))
    config.head_conv = ConfigNode(derive_head_conv(config, config.heads))
    config.freeze()
    return config


def load_config(cfg_file: str | None = None, opts=(), num_classes: int = 10,
                default_resolution=(900, 1600), output_dir: str | None = None) -> ConfigNode:
    """One-call config construction: defaults -> yaml -> overrides -> derived."""
    config = default_config()
    update_config(config, cfg_file, opts)
    return finalize_config(config, num_classes, default_resolution, output_dir)
