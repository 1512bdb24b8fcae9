"""Host data pipeline: batching, shuffling, host-to-device transfer.

The port of ``centerfusiondetect3d_tpu/data/pipeline.py`` without its thread
pool, prefetch queue, ``peek``, sharding and ``pad_to_batch``: ``Loader``
builds each batch on the calling thread from any dataset with ``__len__``
and ``get_item(index, rng)``, in the JAX package's index order and with its
per-item augmentation seeds, and
``to_device`` moves a stacked batch to the card from pinned memory, laying
the NHWC maps of the items out NCHW.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

# item maps that are NHWC on the host and NCHW on the device
NHWC_MAPS = ("image", "pc_dep", "pc_hm")


def stack_items(items) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts into batched arrays (recursive)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], dict):
            out[key] = stack_items(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


class Loader:
    """Iterable over stacked batches of ``batch_size`` items, shuffled per
    epoch from ``seed + epoch`` as the JAX package's loader does; the last,
    partial batch is dropped unless ``drop_last`` is false (validation
    keeps it). ``augment`` (default ``shuffle``, as there) builds item ``i``
    of epoch ``e`` with ``get_item(i, np.random.RandomState((seed + e) *
    1_000_003 + i))``, the JAX loader's per-item seed; without it
    ``get_item(i, None)``. The item keys in ``drop_keys`` (by default
    ``meta``, which only validation reads) are left out of the batches.
    Iterating ends the epoch: ``epoch`` advances by one.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, drop_keys=("meta",),
                 augment: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = shuffle if augment is None else bool(augment)
        self.seed = seed
        self.drop_last = drop_last
        self.drop_keys = set(drop_keys or ())
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _build(self, index: int, sample_seed: int):
        rng = np.random.RandomState(sample_seed) if self.augment else None
        item = self.dataset.get_item(index, rng)
        for key in self.drop_keys:
            item.pop(key, None)
        return item

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(indices)
        base = (self.seed + self.epoch) * 1_000_003
        for b in range(len(self)):
            chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
            yield stack_items([self._build(int(i), base + int(i))
                               for i in chunk])
        self.epoch += 1


def to_device(batch, device) -> Dict:
    """numpy batch -> tensors on ``device`` (recursive). On a CUDA device
    each array goes through pinned memory with a non-blocking copy; the
    image, radar maps and ``heatmap{i}`` targets become NCHW."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = to_device(value, device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if t.dim() == 4 and (key in NHWC_MAPS or key.startswith("heatmap")):
            t = t.permute(0, 3, 1, 2).contiguous()
        out[key] = t
    return out
