"""Reference ``.pt`` checkpoints: the port's native checkpoint format.

The counterpart of the parts of ``centerfusiondetect3d_tpu/training/
checkpoint.py`` that a PyTorch program needs (``export_torch_checkpoint``,
``load_torch_file``, ``migrate_reference_history``, ``modernize_torch_key``;
reference ``saveModel``, ``src/lib/utils/utils.py:197-218``, and
``toggleWeightName``, ``model/model.py:165-250``). A checkpoint is one
``torch.save`` dict ``{state_dict, epoch, train, val, optimizer}``: the
weights under the reference's names, the epoch, the loss logs keyed by epoch
and the optimizer's ``state_dict``. The JAX package reads it with its own
``load_torch_file`` and ``import_torch_checkpoint``. The JAX package's native
orbax directories are not read here: the card's machine has no orbax.

``torch.load`` unpickles, so load only files this program or the reference
wrote.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Mapping

import torch

# legacy upstream-CenterFusion name aliases handled by the reference's
# elastic loader (model/model.py:165-250 toggleWeightName)
_LEGACY_HEAD_ALIASES = {
    "dep_sec.": "detectHead_0.depth2.",
    "rot_sec.": "detectHead_0.rotation2.",
    "hm.": "detectHead_0.heatmap.",
    "wh.": "detectHead_0.widthHeight.",
    "dep.": "detectHead_0.depth.",
    "dim.": "detectHead_0.dimension.",
    "rot.": "detectHead_0.rotation.",
    "amodel_offset.": "detectHead_0.amodal_offset.",
}
_LEGACY_HEADS = (
    "reg", "depth2", "rotation2", "heatmap", "widthHeight", "depth", "rotation",
    "dimension", "amodal_offset", "nuscenes_att", "velocity",
)
CHECKPOINT_SUFFIXES = (".pt", ".pth")


def modernize_torch_key(name: str) -> str:
    """Map legacy CenterFusion state_dict names onto current reference names."""
    # old DCN param layout: <up>.<node>_N.conv.{weight,bias} -> .{weight,bias}
    if re.match(r".*_up.*_\d\.conv\.(weight|bias)$", name):
        name = name.replace("conv.weight", "weight").replace("conv.bias", "bias")
    name = name.replace(".actf.", ".activation.")
    name = name.replace("conv.conv_offset_mask", "conv_offset_mask")
    for old, new in _LEGACY_HEAD_ALIASES.items():
        if name.startswith(old):
            return new + name[len(old):]
    # oldv2: bare head prefixes without the detectHead_0 module
    for head in _LEGACY_HEADS:
        if name.startswith(head + "."):
            return "detectHead_0." + name
    return name


def migrate_reference_history(ckpt: Mapping[str, Any]
                              ) -> Dict[str, Dict[str, list]]:
    """A checkpoint's loss logs as ``{train: {head: [per epoch]}, val:
    {head: [per eval]}}``: the legacy per-epoch lists as they are, the
    epoch-keyed dicts of the reference's ``renewCheckpoint``
    (model/model.py:253-316) flattened in epoch order."""
    out: Dict[str, Dict[str, list]] = {"train": {}, "val": {}}
    for split in ("train", "val"):
        log = ckpt.get(split)
        if not isinstance(log, dict):
            continue
        for head, values in log.items():
            if isinstance(values, dict) and values:
                ordered = sorted(values.items(), key=lambda kv: float(kv[0]))
                out[split][head] = [v for _, v in ordered]
            elif isinstance(values, list):
                out[split][head] = list(values)
    return out


def is_torch_checkpoint(path: str) -> bool:
    """True for a reference-style checkpoint file (.pt/.pth)."""
    return os.path.isfile(path) and str(path).endswith(CHECKPOINT_SUFFIXES)


def load_torch_file(path: str) -> Dict[str, Any]:
    """Read a reference checkpoint: a full ``saveModel`` dict or a bare
    state_dict.

    Returns ``{"state_dict", "epoch", "history", "optimizer"}``: the
    weights with ``module.``/``model.`` prefixes stripped and legacy names
    modernized, the epoch (-1 when absent), the migrated loss history and
    the optimizer's ``state_dict`` (None when absent). Any other path, an
    orbax checkpoint directory of the JAX package included, raises
    ``ValueError``.
    """
    path = str(path)
    if not is_torch_checkpoint(path):
        kind = "a directory (a JAX orbax checkpoint?)" if os.path.isdir(
            path) else "not a .pt/.pth file"
        raise ValueError(
            f"MODEL.LOAD_DIR {path!r} is {kind}: the port reads reference "
            "checkpoint files (.pt/.pth) only; convert an orbax checkpoint "
            "with the JAX package's export_torch_checkpoint")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    full = isinstance(ckpt, dict) and "state_dict" in ckpt
    raw = ckpt["state_dict"] if full else ckpt
    state_dict = {}
    for key, value in raw.items():
        key = key[7:] if key.startswith("module.") else key
        key = key[6:] if key.startswith("model.") else key
        state_dict[modernize_torch_key(key)] = torch.as_tensor(value)
    return {
        "state_dict": state_dict,
        "epoch": int(ckpt.get("epoch", -1)) if full else -1,
        "history": (migrate_reference_history(ckpt) if full
                    else {"train": {}, "val": {}}),
        "optimizer": ckpt.get("optimizer") if full else None,
    }


def load_weights(model: torch.nn.Module, state_dict: Mapping[str, Any],
                 logger: logging.Logger = None) -> Dict[str, list]:
    """Copy ``state_dict`` into ``model`` elastically, as the reference's
    ``loadModel`` and the JAX package's ``import_torch_checkpoint`` do: a
    key of the model that the file lacks, or whose shape differs, keeps
    the model's value and is reported. Values take the dtype and device of
    the model's own tensors. Returns ``{"loaded", "missing",
    "shape_mismatch"}``."""
    own = model.state_dict()
    report = {"loaded": [], "missing": [], "shape_mismatch": []}
    merged = {}
    for key, current in own.items():
        value = state_dict.get(key)
        if value is None:
            report["missing"].append(key)
            merged[key] = current
        elif tuple(value.shape) != tuple(current.shape):
            report["shape_mismatch"].append(key)
            merged[key] = current
        else:
            report["loaded"].append(key)
            merged[key] = value.to(dtype=current.dtype, device=current.device)
    model.load_state_dict(merged, strict=True)
    if logger is not None:
        logger.info("checkpoint: %d loaded, %d missing, %d shape-mismatched",
                    len(report["loaded"]), len(report["missing"]),
                    len(report["shape_mismatch"]))
        absent = [k for k in report["missing"] + report["shape_mismatch"]
                  if not k.endswith("num_batches_tracked")]
        if absent:
            logger.warning("checkpoint lacks or mismatches %d weights, which "
                           "keep their initial values: %s", len(absent),
                           ", ".join(absent[:8]))
    return report


def epoch_keyed(values, epoch: int) -> Dict[int, float]:
    """One head's per-epoch losses keyed by epoch as the JAX package's
    ``export_torch_checkpoint`` keys them: the last value lands on ``epoch``
    when the log is no longer than that (a resumed run's tail), else the
    keys count from 1."""
    start = epoch - len(values) + 1 if epoch >= len(values) else 1
    return {start + i: float(v) for i, v in enumerate(values)}


def save_checkpoint(path: str, model: torch.nn.Module, optimizer, epoch: int,
                    history: Mapping[str, Mapping[str, list]] = None) -> str:
    """Write ``model_{epoch}.pt`` and ``model_last.pt`` into the directory
    ``path`` (made if missing), each the reference ``saveModel`` dict:
    ``state_dict`` (CPU tensors under the reference's names), ``epoch``,
    ``train`` and ``val`` loss logs keyed by epoch, and ``optimizer``
    (its ``state_dict``, or None). Each file is written under a temporary
    name and moved into place. Returns the path of ``model_{epoch}.pt``."""
    os.makedirs(path, exist_ok=True)
    history = history or {}
    ckpt: Dict[str, Any] = {
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "epoch": int(epoch),
        "optimizer": (optimizer.state_dict() if optimizer is not None
                      else None),
    }
    for split in ("train", "val"):
        ckpt[split] = {head: epoch_keyed(values, int(epoch))
                       for head, values in (history.get(split) or {}).items()}
    out = os.path.join(path, f"model_{int(epoch)}.pt")
    for target in (out, os.path.join(path, "model_last.pt")):
        tmp = f"{target}.{os.getpid()}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, target)
    return out
