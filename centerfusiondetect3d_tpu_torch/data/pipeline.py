"""Host data pipeline: batching, shuffling, host-to-device transfer.

The port of ``centerfusiondetect3d_tpu/data/pipeline.py`` without its thread
pool, prefetch queue, sharding and augmentation seeds: ``Loader`` builds
each batch on the calling thread from any dataset with ``__len__`` and
``get_item(index, rng)``, in the JAX package's index order, and
``to_device`` moves a stacked batch to the card from pinned memory, laying
the NHWC maps of the items out NCHW.
"""

from __future__ import annotations

from typing import Dict, Iterator

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
    """Iterable over stacked batches of ``batch_size`` items (the last,
    partial batch is dropped), shuffled per epoch from ``seed + epoch`` as
    the JAX package's loader does. Items are built without augmentation
    (``get_item(index, None)``). Iterating ends the epoch: ``epoch``
    advances by one.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(indices)
        for b in range(len(self)):
            chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
            yield stack_items([self.dataset.get_item(int(i), None)
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
