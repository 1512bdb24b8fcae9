"""The port's ``data/pipeline.py:Loader`` hands each item the JAX loader's
augmentation generator, and the port's Trainer asks for it.

The JAX ``Loader`` (``centerfusiondetect3d_tpu/data/pipeline.py``) builds
item ``i`` of epoch ``e`` with ``np.random.RandomState((seed + e) *
1_000_003 + i)`` when ``augment`` is on (its default is ``shuffle``), and
its Trainer passes ``augment=True``. A dataset that records the first draws
of the generator it is given (or that it got none) shows the same item
order and the same draws from both loaders over two epochs, with shuffling
and augmentation each on and off.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import Loader
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    SyntheticTrainingSet,
)

torch.set_num_threads(1)

N_ITEMS, BATCH, SEED, EPOCHS = 7, 3, 11, 2


class Recorder:
    """Items that hold their index and the first 4 draws of their rng
    (-1 without one)."""

    def __len__(self):
        return N_ITEMS

    def get_item(self, index, rng=None):
        draws = (np.full(4, -1.0) if rng is None
                 else np.concatenate([rng.rand(2), rng.randn(2)]))
        return {"index": np.int64(index), "draws": draws}


def _batches(loader):
    out = []
    for _ in range(EPOCHS):
        out.append([{k: v.copy() for k, v in b.items()} for b in loader])
    return out


@pytest.mark.parametrize("augment", [None, True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax_loader_over_two_epochs(shuffle, augment):
    jax_pipeline = pytest.importorskip("centerfusiondetect3d_tpu.data.pipeline")
    port = Loader(Recorder(), BATCH, shuffle=shuffle, seed=SEED,
                  augment=augment)
    ref = jax_pipeline.Loader(Recorder(), BATCH, shuffle=shuffle, seed=SEED,
                              augment=augment, num_threads=1, prefetch=0)
    assert port.augment == ref.augment == (shuffle if augment is None
                                           else augment)
    got, want = _batches(port), _batches(ref)
    assert port.epoch == ref.epoch == EPOCHS
    assert len(got[0]) == N_ITEMS // BATCH
    for epoch, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            assert sorted(gb) == sorted(wb)
            np.testing.assert_array_equal(gb["index"], wb["index"])
            np.testing.assert_array_equal(gb["draws"], wb["draws"])
            if not port.augment:
                assert (gb["draws"] == -1.0).all()
            else:
                # the JAX seed, written out
                for i, row in zip(gb["index"], gb["draws"]):
                    rng = np.random.RandomState(
                        (SEED + epoch) * 1_000_003 + int(i))
                    np.testing.assert_array_equal(
                        row, np.concatenate([rng.rand(2), rng.randn(2)]))
    if port.augment:
        # another epoch, other draws for the same item
        first = {int(i): d for b in got[0] for i, d in zip(b["index"],
                                                          b["draws"])}
        second = {int(i): d for b in got[1] for i, d in zip(b["index"],
                                                           b["draws"])}
        assert all(not np.array_equal(first[i], second[i])
                   for i in first.keys() & second.keys())


class RecordingSet(SyntheticTrainingSet):
    """The synthetic training set, recording each item's index and the rng
    it gets (the Loader's threads build items in any order)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rngs = []

    def get_item(self, index, rng=None):
        self.rngs.append((int(index), rng))
        return super().get_item(index, rng)


def test_trainer_builds_items_with_the_augmentation_rng(tmp_path):
    """As the JAX Trainer (``Loader(..., augment=True)``), the port's
    Trainer hands every item a generator, also with shuffling off, seeded
    as the JAX loader seeds it."""
    cfg = load_config(opts=MAIN_PATH_OPTS + [
        "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
        "MODEL.FRUSTUM", "False", "MIXED_PRECISION", "False",
        "OUTPUT_DIR", repr(str(tmp_path)), "TRAIN.BATCH_SIZE", "2",
        "TRAIN.EPOCHS", "1", "TRAIN.SHUFFLE", "False",
        "TRAIN.VAL_INTERVALS", "0", "TRAIN.SAVE_INTERVALS", "0",
        "MODEL.FREEZE_BACKBONE", "False", "MODEL.DEFREEZE", "-1"],
        num_classes=10)
    data = RecordingSet(cfg, 2, seed=6)
    trainer = Trainer(cfg, data, device="cpu")
    trainer.train()
    assert len(trainer.steps) == 1
    assert sorted(i for i, _ in data.rngs) == [0, 1]
    assert all(isinstance(r, np.random.RandomState) for _, r in data.rngs)
    seed = int(cfg.RANDOM_SEED)
    for i, rng in data.rngs:
        want = np.random.RandomState(seed * 1_000_003 + i)
        assert rng.get_state()[1].tolist() == want.get_state()[1].tolist()
