"""Weights of the JAX package -> the port's (reference-named) state_dict.

The port's own copy of the name mapping behind
``centerfusiondetect3d_tpu/training/checkpoint.py:export_torch_state_dict``:
flax parameter paths become the reference's torch names and HWIO kernels
become OIHW. It takes plain nested dicts of numpy arrays and imports nothing
of JAX. The ResNet backbones (``models/resnet.py``), which the reference
does not have, keep the JAX paths: ``stem``, ``level1`` and the blocks'
``conv1``, ``conv2`` and ``downsample`` ConvBnAct units become Sequentials
of conv (0) and BN (1).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# BasicBlock ConvBnAct submodules -> reference conv/bn attribute names
_TREE_BLOCK = {"block1": ("conv1", "bn1"), "block2": ("conv2", "bn2")}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
# the ResNet backbones' ConvBnAct units -> Sequential(conv, bn)
_RESNET_UNITS = ("stem", "level1", "conv1", "conv2", "downsample")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax path -> (reference torch key, kind); kind picks the layout
    change (conv, dcn_w and up kernels are HWIO -> OIHW)."""
    parts = list(path)
    leaf = parts.pop()
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "base_layer":
            out.append("base_layer." + ("0" if parts[i + 1] == "conv" else "1"))
            i += 2
            continue
        if re.fullmatch(r"level[01]_\d+", p):
            lvl, idx = p.split("_")
            j = 3 * int(idx) + (0 if parts[i + 1] == "conv" else 1)
            out.append(f"{lvl}.{j}")
            i += 2
            continue
        if p in _TREE_BLOCK:
            conv_name, bn_name = _TREE_BLOCK[p]
            out.append(conv_name if parts[i + 1] == "conv" else bn_name)
            i += 2
            continue
        if (p in _RESNET_UNITS and i + 1 < len(parts)
                and parts[i + 1] in ("conv", "bn")):
            out.append(p + "." + ("0" if parts[i + 1] == "conv" else "1"))
            i += 2
            continue
        if p == "project":
            out.append("project." + ("0" if parts[i + 1] == "conv" else "1"))
            i += 2
            continue
        if p == "root":
            out.append("root." + ("conv" if parts[i + 1] == "conv" else "bn"))
            i += 2
            continue
        if re.fullmatch(r"up_\d+", p):
            out.append(p)
            return ".".join(out) + ".weight", "up"
        if re.fullmatch(r"(left|right)[12]", p):
            side = "convLeft" if p.startswith("left") else "convRight"
            out.append(f"{side}.{int(p[-1]) - 1}")
        elif p == "bn" and leaf in _BN_LEAF:
            # a node's own BN (DeformConv, GlobalConv) -> activation.0
            out.append("activation.0")
            return ".".join(out) + "." + _BN_LEAF[leaf], "bn"
        elif (p == "conv" and i + 1 < len(parts)
              and parts[i + 1] in ("conv", "bn")):
            # ConvNode's ConvBnAct -> torch Sequential conv.0 / conv.1
            out.append("conv." + ("0" if parts[i + 1] == "conv" else "1"))
            i += 2
            continue
        elif p == "detect_head_0":
            out.append("detectHead_0")
        elif re.fullmatch(r"tower_\d+", p):
            out.append(str(2 * int(p.split("_")[1])))
        elif p == "out":
            out.append("__OUT__")  # resolved from the tower depth
        else:
            out.append(p)
        i += 1

    key = ".".join(out)
    if leaf == "kernel":
        return key + ".weight", "conv"
    if leaf == "weight":
        return key + ".weight", "dcn_w"
    if leaf == "bias":
        return key + ".bias", "bias"
    if leaf in _BN_LEAF:
        return key + "." + _BN_LEAF[leaf], "bn"
    return key + "." + leaf, "raw"


def _resolve_out_index(key: str, head_conv: Mapping[str, list]) -> str:
    """The head tower's last Sequential index: 2 * number of hidden convs."""
    if "__OUT__" not in key:
        return key
    head = re.search(r"detectHead_0\.([A-Za-z_0-9]+?)\.__OUT__", key).group(1)
    n_hidden = len(head_conv.get(head, []))
    return key.replace("__OUT__", str(2 * n_hidden if n_hidden else 0))


def state_dict_from_jax(params, batch_stats, head_conv=None
                        ) -> Dict[str, torch.Tensor]:
    """JAX package parameters (nested dicts of arrays: ``params`` and
    ``batch_stats``) -> the port's state_dict, float32 tensors in OIHW.

    The keys are those of ``export_torch_state_dict``; BatchNorm's
    ``num_batches_tracked`` is absent and ``load_state_dict`` fills it.
    """
    head_conv = dict(head_conv or {})
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree).items():
            key, kind = _torch_key(path)
            key = _resolve_out_index(key, head_conv)
            v = np.asarray(value, np.float32)
            if kind in ("conv", "dcn_w", "up") and v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out
