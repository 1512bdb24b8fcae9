"""Host data pipeline: batching, shuffling, threaded prefetch, device put.

The port of ``centerfusiondetect3d_tpu/data/pipeline.py`` (reference
``src/main.py:98-122``'s DataLoader and worker processes): ``Loader``
builds the items of each batch in a pool of ``num_threads`` threads
(``pool.map``, in index order) behind a bounded queue of ``prefetch``
batches, from any dataset with ``__len__`` and ``get_item(index, rng)``, in
the JAX package's index order (shuffle, ``shard``, ``pad_to_batch``) and
with its per-item augmentation seeds, so that threads change no batch. The
item work (decode, warp, radar paint in C++, target scatter) is numpy,
opencv, nvJPEG and ``native/``, which release the GIL for most of it.

``to_device`` moves a stacked batch to a device, laying the NHWC maps of
the items out NCHW; ``device_prefetch`` does so ``size`` batches ahead of
the consumer, on a CUDA card on a side stream from pinned memory.
"""

from __future__ import annotations

import queue
import threading
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

    ``num_threads`` threads build a batch's items (one: the calling
    thread), and a producer thread keeps up to ``prefetch`` batches ready
    (0: none, the batches are built as they are asked for). An item's
    exception reaches the consumer; a consumer that stops early releases
    the threads. ``shard=(shard_id, num_shards)`` iterates a strided slice
    of the shuffled index stream, padded to equal lengths;
    ``pad_to_batch`` pads the stream to whole batches (both as in JAX:
    multi-process data parallelism).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, num_threads: int = 2,
                 prefetch: int = 2, drop_keys=("meta",),
                 augment: Optional[bool] = None, shard=None,
                 pad_to_batch: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = shuffle if augment is None else bool(augment)
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, int(num_threads))
        self.prefetch = int(prefetch)
        self.drop_keys = set(drop_keys or ())
        self.shard = tuple(shard) if shard else None
        self.pad_to_batch = bool(pad_to_batch)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.shard:
            # padded shards (_indices) are all ceil(n / num_shards) long
            n = -(-n // self.shard[1])
        if self.pad_to_batch:
            # the padded stream's last batch is full: drop_last keeps it
            return -(-n // self.batch_size)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the same order on every shard; disjoint slices of it
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.shard:
            sid, ns = self.shard
            # repeat leading indices up to a multiple of num_shards, so
            # every shard yields the same number of batches (np.resize
            # tiles cyclically, also where the pad exceeds the dataset)
            pad = (-len(idx)) % ns
            if pad:
                idx = np.resize(idx, len(idx) + pad)
            idx = idx[sid::ns]
        if self.pad_to_batch and len(idx):
            pad = (-len(idx)) % self.batch_size
            if pad:
                idx = np.resize(idx, len(idx) + pad)
        return idx

    def _build(self, index: int, sample_seed: int):
        rng = np.random.RandomState(sample_seed) if self.augment else None
        item = self.dataset.get_item(index, rng)
        for key in self.drop_keys:
            item.pop(key, None)
        return item

    def peek(self) -> Dict[str, np.ndarray]:
        """The epoch's first batch, built on the calling thread: starts no
        thread and does not advance the epoch."""
        indices = self._indices()[:self.batch_size]
        if not len(indices):
            raise ValueError("Loader.peek: the dataset is empty")
        base = (self.seed + self.epoch) * 1_000_003
        return stack_items([self._build(int(i), base + int(i))
                            for i in indices])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        n_batches = len(self)
        base = (self.seed + self.epoch) * 1_000_003

        def chunk_items(pool, b):
            chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]

            def build(i):
                return self._build(int(i), base + int(i))

            # the seeds come from the indices and pool.map keeps their
            # order, so the threads' finishing order changes no batch
            items = (list(pool.map(build, chunk)) if pool
                     else [build(i) for i in chunk])
            return stack_items(items)

        def batches():
            if self.num_threads > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=self.num_threads,
                                        thread_name_prefix="cfd3d-loader"
                                        ) as pool:
                    for b in range(n_batches):
                        yield chunk_items(pool, b)
            else:
                for b in range(n_batches):
                    yield chunk_items(None, b)

        if self.prefetch > 0:
            yield from _prefetch_iter(batches(), self.prefetch)
        else:
            yield from batches()
        self.epoch += 1


def _prefetch_iter(it, depth: int):
    """Run the producer ``it`` in a background thread with a bounded queue
    of ``depth``. An abandoned consumer does not leak the producer: its
    ``finally`` (run when the abandoned generator is closed or collected)
    sets a stop event that the producer's puts poll; the producer then
    closes ``it``, which shuts the Loader's thread pool down. A producer's
    exception is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    err = []
    stop = threading.Event()

    def safe_put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for x in it:
                    if not safe_put(x):
                        break
            finally:
                it.close()  # unwinds batches()'s ThreadPoolExecutor
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        safe_put(end)

    t = threading.Thread(target=worker, daemon=True,
                         name="cfd3d-loader-prefetch")
    t.start()
    try:
        while True:
            x = q.get()
            if x is end:
                break
            yield x
        if err:
            raise err[0]
    finally:
        stop.set()


def _nchw(key: str, t: torch.Tensor) -> bool:
    return t.dim() == 4 and (key in NHWC_MAPS or key.startswith("heatmap"))


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
        if _nchw(key, t):
            t = t.permute(0, 3, 1, 2).contiguous()
        out[key] = t
    return out


def _tensors(batch):
    for value in batch.values():
        if isinstance(value, dict):
            yield from _tensors(value)
        else:
            yield value


def device_prefetch(batch_iter, device, size: int = 2):
    """Yields ``to_device`` of each batch of ``batch_iter``, with up to
    ``size`` batches moved ahead of the consumer (0: none; JAX
    ``device_prefetch``). On a CUDA device the copies and the NCHW
    permutes run on a side stream; the consumer's stream waits on each
    batch's event before the batch is yielded, and every tensor is
    ``record_stream``-ed to it, so that the caching allocator cannot hand
    the memory out again while the consumer's work may still read it.
    Closing the generator closes ``batch_iter``'s iterator."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        if not cuda:
            return to_device(batch, device), None
        with torch.cuda.stream(side):
            moved = to_device(batch, device)
            ready = torch.cuda.Event()
            ready.record(side)
        return moved, ready

    def take(moved, ready):
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in _tensors(moved):
                t.record_stream(current)
        return moved

    it = iter(batch_iter)
    try:
        buf = []
        for batch in it:
            buf.append(put(batch))
            if len(buf) > size:
                yield take(*buf.pop(0))
        while buf:
            yield take(*buf.pop(0))
    finally:
        # closing this generator closes the source at once (a Loader's
        # iterator then releases its threads), not when it is collected
        if hasattr(it, "close"):
            it.close()
