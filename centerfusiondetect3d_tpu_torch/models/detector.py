"""The flagship model: DLA-34 (or ResNet-18/34) + DLAUp/IDAUp +
CenterFusion heads.

The port of ``centerfusiondetect3d_tpu/models/detector.py`` (reference
DLASeg/BaseModel, dla.py:571-635 and base_model.py:30-106): backbone ->
hierarchical upsampling to stride 4 -> first-stage CenterNet heads ->
(middle fusion) frustum radar association -> secondary heads. Names follow
the reference state_dict (``base.*``, ``dla_up.*``, ``ida_up.*``,
``detectHead_0.*``). ``MODEL.ARCH`` picks the backbone as the JAX package's
family switch does (``models/detector.py:73, 84-85, 209``): ``dla_34``, or
``resnet_18`` / ``resnet_34`` (``models/resnet.py``, the same six-level
pyramid, so the neck's 16 DCN nodes and the heads stay); any other
architecture raises.

Serving calls ``forward(image, pc_dep, calib)`` in eval mode. Training calls
``forward(image, pc_dep, calib, pc_hm, train=True)`` (the JAX package's
``train=True`` branches, ``models/detector.py:149-200``): the secondary heads
take the ground-truth frustum heatmap ``pc_hm`` of the batch, no frustum
association runs, and ``pc_hm_in`` is the raw ``pc_dep``. BatchNorm follows
the module mode, as everywhere in PyTorch: after ``model.train()`` it uses
batch statistics and updates its running statistics, and with
``norm_eval`` (``MODEL.NORM_EVAL``) ``train()`` keeps the backbone's
BatchNorm in eval. Freezing the backbone (``backbone_parameters``) removes
only its gradients; its BatchNorm statistics still update.

``build_model`` resolves the compute dtype from ``MIXED_PRECISION`` as the
JAX package's does (``models/detector.py:204-207``): bfloat16 when it is
true (the default of every shipped config), float32 otherwise. A bf16 model
keeps float32 parameters and BatchNorm statistics, casts the normalized
image to bf16, computes the backbone, neck and head towers in bf16
(``models/layers.py``) and returns head outputs in float32; the radar maps
and the frustum association stay float32.

Inside a layout whose spatial axis is wider than 1 (``parallel/mesh.py``)
``image`` is this rank's rows (``shard_batch``): the backbone and the neck
run on the rank's rows, the stride-4 features are gathered whole along H,
and the heads, the frustum and the outputs are those of the whole image
(the radar maps are gathered whole where they come as the rank's rows).
The whole height must be a multiple of 32 * n_spatial.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops.frustum import get_pc_frustum_heatmap
from ..parallel.mesh import (active_layout, check_spatial_height, row_shard,
                             whole_rows)
from .dla import DLA, DLA34_CHANNELS
from .heads import SECONDARY_HEADS, DetectHeadSet, resize_nearest
from .resnet import RESNET_SPECS, ResNetBackbone
from .upsample import DLAUp, IDAUp

FIRST_LEVEL = 2  # log2(down_ratio=4)
LAST_LEVEL = 5
# the backbone subtrees that MODEL.FREEZE_BACKBONE freezes (the JAX
# package's training/state.py:BACKBONE_KEYS); every DCN node lives in them
BACKBONE_KEYS = ("base", "dla_up", "ida_up")
ARCHS = ("dla_34",) + tuple(f"resnet_{d}" for d in RESNET_SPECS)


class CenterFusionDLA(nn.Module):
    def __init__(self, heads: Mapping[str, int],
                 head_conv: Mapping[str, Sequence[int]],
                 node: str = "DeformConv", fusion_strategy: Optional[str] =
                 "middle", radar_pc: bool = True, frustum: bool = True,
                 one_hot_pc: bool = False, max_pc_dist: float = 60.0,
                 top_k: int = 100, norm_eval: bool = False,
                 compute_dtype=None, arch: str = "dla_34",
                 fused_heads: bool = False):
        super().__init__()
        if arch not in ARCHS:
            raise NotImplementedError(f"architecture {arch!r} is not "
                                      f"implemented ({', '.join(ARCHS)})")
        dt = self.compute_dtype = compute_dtype
        self.norm_eval = bool(norm_eval)
        self.fusion_strategy = fusion_strategy
        self.radar_pc = radar_pc
        self.frustum = frustum
        self.one_hot_pc = one_hot_pc
        self.max_pc_dist = float(max_pc_dist)
        self.top_k = int(top_k)
        channels = DLA34_CHANNELS
        pc_channels = 3 * int(max_pc_dist) if one_hot_pc else 3
        early = radar_pc and fusion_strategy == "early"
        in_channels = 3 + (pc_channels if early else 0)
        if arch.startswith("resnet"):
            self.base = ResNetBackbone(arch.partition("_")[2], in_channels,
                                       compute_dtype=dt)
        else:
            self.base = DLA(in_channels, compute_dtype=dt)
        scales = [2 ** i for i in range(len(channels[FIRST_LEVEL:]))]
        self.dla_up = DLAUp(FIRST_LEVEL, channels[FIRST_LEVEL:], scales, node,
                            dt)
        self.ida_up = IDAUp(
            channels[FIRST_LEVEL], channels[FIRST_LEVEL:LAST_LEVEL],
            [2 ** i for i in range(LAST_LEVEL - FIRST_LEVEL)], node, dt)
        secondary = (tuple(h for h in heads if h in SECONDARY_HEADS)
                     if fusion_strategy == "middle" and radar_pc else ())
        self.detectHead_0 = DetectHeadSet(
            channels[FIRST_LEVEL], heads, head_conv, secondary, pc_channels,
            dt, fuse_towers=fused_heads)

    def backbone_parameters(self):
        """(name, parameter) of ``base``, ``dla_up`` and ``ida_up``."""
        return [(n, p) for n, p in self.named_parameters()
                if n.split(".")[0] in BACKBONE_KEYS]

    def train(self, mode: bool = True):
        """``nn.Module.train``, except that ``norm_eval`` holds the
        backbone's BatchNorm in eval (running statistics, no updates)."""
        super().train(mode)
        if mode and self.norm_eval:
            for key in BACKBONE_KEYS:
                for m in getattr(self, key).modules():
                    if isinstance(m, nn.modules.batchnorm._BatchNorm):
                        m.eval()
        return self

    @property
    def pc_slice(self) -> int:
        return int(self.max_pc_dist) if self.one_hot_pc else 1

    def img2feats(self, x):
        """The stride-4 features of the image; under a height-sharded
        layout the backbone and neck run on this rank's rows and the
        features come back whole."""
        lay = active_layout()
        rows = lay.rows() if lay is not None else None
        with row_shard(rows):
            feats = self.base(x)
            pyramid = self.dla_up(feats)
            y = list(pyramid[: LAST_LEVEL - FIRST_LEVEL])
            out = self.ida_up(y, 0, len(y))[-1]
        return out if rows is None else rows.gather(out)

    def frustum_heatmap(self, y: Dict[str, torch.Tensor], pc_dep, calib):
        """Radar heatmap from the first-stage boxes (pointcloud.py:331-394)."""
        return get_pc_frustum_heatmap(y, pc_dep, calib, self.top_k,
                                      self.max_pc_dist)

    def forward(self, image, pc_dep=None, calib=None, pc_hm=None,
                train: bool = False):
        """image (B, 3, H, W) normalized; pc_dep (B, C_pc, H/4, W/4) raw radar
        map [d, vx, vz]; calib (B, 3, 4); pc_hm (B, C_pc, H/4, W/4) the
        batch's radar heatmap, read only with ``train=True`` (where a radar
        model needs it). Returns a dict of NCHW head outputs in at least
        float32 (plus ``calib``)."""
        x = image if self.compute_dtype is None else image.to(
            self.compute_dtype)
        lay = active_layout()
        if lay is not None and lay.n_spatial > 1:
            # image: this rank's rows; the radar maps whole for the heads
            height = image.shape[2] * lay.n_spatial
            check_spatial_height(height, lay.n_spatial)
            pc_dep = whole_rows(pc_dep, height // 4, lay)
            pc_hm = whole_rows(pc_hm, height // 4, lay)
        if train:
            if self.radar_pc and pc_hm is None:
                raise ValueError("forward(train=True) needs the batch's "
                                 "radar heatmap pc_hm")
        elif self.radar_pc and not (self.frustum
                                    and self.fusion_strategy == "middle"):
            # eval-time radar normalization (base_model.py:67-79)
            s = self.pc_slice
            pc_hm = torch.cat([1.0 - pc_dep[:, :s] / self.max_pc_dist,
                               pc_dep[:, s:]], dim=1)
        if self.radar_pc and self.fusion_strategy == "early":
            pc_in = pc_hm
            if lay is not None and lay.n_spatial > 1:  # this rank's rows
                rows = pc_hm.shape[2] // lay.n_spatial
                pc_in = pc_hm.narrow(2, lay.rows().row0(rows), rows)
            x = torch.cat([x, resize_nearest(pc_in, x.shape[-2:]).to(x.dtype)],
                          dim=1)

        feats = self.img2feats(x)
        y = self.detectHead_0.first_stage(feats)
        y["calib"] = calib
        if self.radar_pc and self.fusion_strategy == "middle":
            # outside the frustum path the reference stores the normalized
            # map (its eval normalization mutates pc_dep in place)
            y["pc_hm_in"] = (pc_hm if not (train or self.frustum)
                             else pc_dep)[:, : self.pc_slice]
            if self.frustum and not train:
                pc_hm = self.frustum_heatmap(y, pc_dep, calib)
            y["pc_hm"] = pc_hm[:, 0:1]
            y.update(self.detectHead_0.second_stage(feats, pc_hm,
                                                    self.pc_slice))
        return y


def build_model(config, dtype=None) -> CenterFusionDLA:
    """Model from a finalized config (model/model.py:18-44).

    ``dtype``: bfloat16 (mixed precision: float32 parameters, bf16 compute),
    float32 or float64 (parameters and compute); None takes bfloat16 when
    ``MIXED_PRECISION`` is true, else float32.
    """
    if dtype is None:
        dtype = torch.bfloat16 if config.MIXED_PRECISION else torch.float32
    if dtype not in (torch.bfloat16, torch.float32, torch.float64):
        raise TypeError(f"build_model: no {dtype} model; bfloat16 (mixed "
                        "precision), float32 or float64")
    mixed = dtype == torch.bfloat16
    model = CenterFusionDLA(
        heads={k: int(v) for k, v in config.heads.items()},
        head_conv={k: tuple(v) for k, v in config.head_conv.items()},
        node=config.MODEL.DLA.NODE,
        fusion_strategy=config.MODEL.FUSION_STRATEGY,
        radar_pc=bool(config.DATASET.RADAR_PC),
        frustum=bool(config.MODEL.FRUSTUM),
        one_hot_pc=bool(config.DATASET.ONE_HOT_PC),
        max_pc_dist=float(config.DATASET.MAX_PC_DIST),
        top_k=int(config.MODEL.K),
        norm_eval=bool(config.MODEL.NORM_EVAL),
        compute_dtype=dtype if mixed else None,
        arch=str(config.MODEL.ARCH),
        fused_heads=bool(config.MODEL.get("FUSED_HEAD_TOWERS", False)),
    )
    return model if mixed else model.to(dtype)
