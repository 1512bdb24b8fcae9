"""The port's threaded ``Loader`` and ``device_prefetch`` against the JAX
package's ``data/pipeline.py``.

A seeded numpy dataset whose items hold their index, draws from their
augmentation generator, a nested ``meta`` and an NHWC map, and that sleeps
a seeded few milliseconds an item so that threads finish out of order,
goes through both loaders: the batches must be bitwise the same for every
combination of threads, prefetch, shuffling, ``shard``, ``pad_to_batch``
and ``drop_last``, and so must ``len`` and ``peek``. An abandoned iterator
must leave no live thread, an item's exception must reach the consumer,
and ``device_prefetch`` on the CPU must give ``to_device``'s tensors.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.data.pipeline import (
    Loader, device_prefetch, to_device)

jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")

SEED = 5
N_ITEMS = 11
WAIT_S = 10.0  # for threads to end


class SeededItems:
    """Items built from their index and generator; ``fail_at`` raises."""

    def __init__(self, n: int = N_ITEMS, fail_at=None, sleep: bool = True):
        self.n = n
        self.fail_at = fail_at
        self.sleep = sleep

    def __len__(self):
        return self.n

    def get_item(self, index, rng=None):
        if index == self.fail_at:
            raise ValueError(f"item {index} is broken")
        local = np.random.RandomState(1000 + index)
        if self.sleep:
            time.sleep(local.uniform(0, 0.004))
        draws = (np.full(3, -1.0) if rng is None
                 else np.concatenate([rng.rand(2), rng.randn(1)]))
        return {
            "index": np.int64(index),
            "draws": draws,
            "image": local.rand(4, 6, 3).astype(np.float32),
            "heatmap0": local.rand(2, 3, 2).astype(np.float32),
            "calib": local.rand(3, 4).astype(np.float32),
            "meta": {"img_id": np.int64(index), "center": local.rand(2)},
        }


def _epochs(loader, n: int = 2):
    return [[b for b in loader] for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            if isinstance(g[key], dict):
                _assert_same([g[key]], [w[key]])
            else:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key])


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("cfd3d-loader") and t.is_alive()]


def _wait_for_no_loader_threads():
    deadline = time.monotonic() + WAIT_S
    while _loader_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return _loader_threads()


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("num_threads", [1, 4])
def test_threads_and_prefetch_give_jax_batches(num_threads, prefetch,
                                               shuffle):
    kw = dict(batch_size=3, shuffle=shuffle, seed=SEED, augment=True,
              num_threads=num_threads, prefetch=prefetch)
    port = Loader(SeededItems(), **kw)
    ref = jax_pipeline.Loader(SeededItems(), **kw)
    assert len(port) == len(ref) == N_ITEMS // 3
    for got, want in zip(_epochs(port), _epochs(ref)):
        _assert_same(got, want)
    assert port.epoch == ref.epoch == 2
    assert _wait_for_no_loader_threads() == []


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("pad_to_batch", [False, True])
@pytest.mark.parametrize("shard_id", [0, 1, 2])
def test_shard_and_pad_to_batch_give_jax_batches(shard_id, pad_to_batch,
                                                 drop_last):
    kw = dict(batch_size=2, shuffle=True, seed=SEED, drop_last=drop_last,
              num_threads=3, prefetch=1, drop_keys=(), shard=(shard_id, 3),
              pad_to_batch=pad_to_batch)
    port = Loader(SeededItems(sleep=False), **kw)
    ref = jax_pipeline.Loader(SeededItems(sleep=False), **kw)
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port._indices(), ref._indices())
    got, want = _epochs(port), _epochs(ref)
    for g, w in zip(got, want):
        assert len(g) == len(port)
        _assert_same(g, w)
        if pad_to_batch:
            assert all(len(b["index"]) == 2 for b in g)


def test_shards_cover_a_tiny_dataset():
    """More shards than items: np.resize tiles, every shard is as long."""
    for sid in range(5):
        port = Loader(SeededItems(n=2, sleep=False), 1, shard=(sid, 5),
                      num_threads=1, prefetch=0)
        ref = jax_pipeline.Loader(SeededItems(n=2, sleep=False), 1,
                                  shard=(sid, 5), num_threads=1, prefetch=0)
        assert len(port) == len(ref) == 1
        np.testing.assert_array_equal(port._indices(), ref._indices())


def test_peek_is_the_first_batch_and_starts_no_thread():
    kw = dict(batch_size=4, shuffle=True, seed=SEED, augment=True,
              num_threads=4, prefetch=2)
    port = Loader(SeededItems(), **kw)
    ref = jax_pipeline.Loader(SeededItems(), **kw)
    before = threading.active_count()
    peeked = port.peek()
    assert threading.active_count() == before
    assert port.epoch == 0
    _assert_same([peeked], [ref.peek()])
    _assert_same([peeked], [next(iter(Loader(SeededItems(), **kw)))])
    with pytest.raises(ValueError, match="empty"):
        Loader(SeededItems(n=0), 2).peek()


def test_abandoned_iterator_releases_its_threads():
    loader = Loader(SeededItems(n=40), 2, num_threads=4, prefetch=2)
    it = iter(loader)
    next(it)
    assert _loader_threads(), "the loader's threads should be running"
    it.close()
    assert _wait_for_no_loader_threads() == []
    # and through device_prefetch, dropped unfinished: closing it closes
    # the source at once, though another reference keeps the source alive
    source = iter(Loader(SeededItems(n=40), 2, num_threads=4, prefetch=2))
    batches = device_prefetch(source, "cpu", size=2)
    next(batches)
    batches.close()
    assert _wait_for_no_loader_threads() == []
    with pytest.raises(StopIteration):
        next(source)


@pytest.mark.parametrize("num_threads,prefetch", [(1, 0), (4, 0), (4, 2)])
def test_item_exception_reaches_the_consumer(num_threads, prefetch):
    loader = Loader(SeededItems(fail_at=7), 3, num_threads=num_threads,
                    prefetch=prefetch)
    got = []
    with pytest.raises(ValueError, match="item 7 is broken"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 2  # the batches before the broken item's
    assert _wait_for_no_loader_threads() == []


@pytest.mark.parametrize("size", [0, 1, 3, 10])
def test_device_prefetch_on_the_cpu_is_to_device(size):
    batches = list(Loader(SeededItems(sleep=False), 3, num_threads=1,
                          prefetch=0, drop_keys=()))
    got = list(device_prefetch(iter(batches), "cpu", size=size))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        want = to_device(b, "cpu")
        assert sorted(g) == sorted(want)
        assert g["image"].shape == (3, 3, 4, 6)  # NCHW
        assert g["heatmap0"].shape == (3, 2, 2, 3)
        for key in ("index", "draws", "image", "heatmap0", "calib"):
            assert g[key].dtype == want[key].dtype
            assert torch.equal(g[key], want[key])
        assert torch.equal(g["meta"]["center"], want["meta"]["center"])
