"""Validation on the card against validation on the CPU (``cuda`` only).

``Trainer.val`` in float32 (TF32 off) on the repo's ``mini_val`` images
(decoded once, on the card, for both runs), DLA-34 with DeformConv nodes at
the campaign's 128x224 and K 32, seeded weights. The check has two links:

1. The forward. The card's run launches ``dcn_fwd`` once per node per
   batch, and its head outputs, batch by batch, lie within ``HEADS_RTOL``
   of the CPU run's, each head relative to its largest magnitude (cuDNN
   and the DCN kernel sum in another order than the CPU). As in
   ``chip_smoke.py:check_heads``, the CPU run's secondary heads take the
   card run's frustum radar heatmap: the two equal unless a near-tie in the
   first-stage heatmap reorders the top-K boxes, a discrete step, which the
   test prints.
2. Decode, post-process and scoring. A second card run replays the CPU
   run's head outputs through the card's ``fusion_decode`` and
   ``post_process`` (per-image inverse affines from ``meta``) and
   ``run_eval``. Its detections must be the CPU run's: per image the same
   number, each CPU detection paired one to one with a card detection of
   its class whose score, bbox, location, dimension and yaw each lie within
   ``REPLAY_RTOL`` of that quantity's largest magnitude (the pairing lets
   detections of equal score trade places); a wrong inverse transform
   moves a detection by O(1) of these scales. Every ``range_all`` summary
   metric agrees within ``SUMMARY_RTOL`` of its own value.

The end-to-end detections and summaries are printed, not asserted: the
seeded net's heatmaps are nearly flat, so float32 rounding changes which
of many near-equal peaks make the top K, and a peak that enters or leaves
shifts every later detection of its image. The CPU tests hold the CPU run
against the JAX package (``test_torch_validation.py``).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.dataset import NuScenesDataset
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "output", "campaign_r5", "data")
KEYS = ("score", "bbox", "location", "dimension", "yaw")
# of each head's largest magnitude in the batch: 2.6x the worst of a card
# run (7.8e-4, widthHeight; H100 80GB HBM3, 700.00 W, PERF.md PR 16)
HEADS_RTOL = 2e-3
REPLAY_RTOL = 1e-5  # of each quantity's largest magnitude over the CPU run
SUMMARY_RTOL = 1e-3  # of each summary metric's own value
OPTS = ["DATASET.ROOT", repr(ROOT + "/"), "DATASET.VAL_SPLIT", "mini_val",
        "MODEL.INPUT_SIZE", "(128, 224)", "MODEL.K", "32",
        "MODEL.DLA.NODE", "DeformConv", "MIXED_PRECISION", "False",
        "TEST.BATCH_SIZE", "16", "EVAL", "True"]


def _pair(want, got, scales):
    """Pairs each detection of ``want`` with one of ``got`` (one to one,
    greedily by cost): the cost of a pair is its largest deviation over
    ``KEYS``, each over its scale, infinite across classes. Returns the
    deviations of the pairs, (len(want), len(KEYS))."""
    def dev(a, b):
        if a["class"] != b["class"]:
            return np.full(len(KEYS), np.inf)
        return np.array([float(np.abs(np.asarray(a[k], np.float64)
                                      - np.asarray(b[k], np.float64)).max())
                         / scales[k] for k in KEYS])

    devs = np.array([[dev(a, b) for b in got] for a in want])
    devs = devs.reshape(len(want), len(got), len(KEYS))
    cost = devs.max(-1)
    pairs = np.full((len(want), len(KEYS)), np.inf)
    free_a, free_b = set(range(len(want))), set(range(len(got)))
    for flat in np.argsort(cost, axis=None, kind="stable"):
        i, j = divmod(int(flat), len(got))
        if i in free_a and j in free_b:
            pairs[i] = devs[i, j]
            free_a.discard(i)
            free_b.discard(j)
    return pairs


def _worst_pairs(want, got, scales) -> str:
    """Per quantity, the largest deviation of a pair over every image."""
    worst = np.zeros(len(KEYS))
    for img_id, items in want.items():
        worst = np.maximum(worst, _pair(items, got[img_id], scales).max(
            0, initial=0.0))
    return ", ".join(f"{k} {w:.3e}" for k, w in zip(KEYS, worst))


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _cfg(tmp_path, name):
    return load_config(opts=OPTS + ["OUTPUT_DIR",
                                    repr(str(tmp_path / name))],
                       num_classes=10)


def _recording(trainer):
    """Wraps the trainer's model so that each batch's head outputs are kept
    (on the host); returns the list they go into."""
    heads, forward = [], trainer.model.forward

    def recorded(*args, **kwargs):
        out = forward(*args, **kwargs)
        heads.append({k: v.cpu() if torch.is_tensor(v) else v
                      for k, v in out.items()})
        return out

    trainer.model.forward = recorded
    return heads


def _summaries_differ(got, want):
    """The ``range_all`` summary metrics of ``got`` off ``want`` by more
    than ``SUMMARY_RTOL`` of their own values (NaN only against NaN)."""
    mine, theirs = dict(_flat(got)), dict(_flat(want))
    assert sorted(mine) == sorted(theirs)
    bad = []
    for key, w in theirs.items():
        g = np.asarray(np.nan if mine[key] is None else mine[key], float)
        w = np.asarray(np.nan if w is None else w, float)
        nan = np.isnan(w)
        limit = SUMMARY_RTOL * np.maximum(np.abs(g), np.abs(w))
        if not (np.array_equal(np.isnan(g), nan)
                and np.all((np.abs(g - w) <= limit)[~nan])):
            bad.append((key, g, w))
    return bad


@pytest.mark.cuda
def test_validation_on_the_card_matches_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(tmp_path, "cuda")
    ds = NuScenesDataset(cfg, "mini_val", device="cuda")
    card_tr = Trainer(cfg, None, ds, device="cuda")
    card_tr.init_state()
    weights = {k: v.cpu() for k, v in card_tr.model.state_dict().items()}
    card_heads = _recording(card_tr)
    frusta, frustum = [], card_tr.model.frustum_heatmap
    card_tr.model.frustum_heatmap = lambda *a: frusta.append(
        frustum(*a)) or frusta[-1]
    before = dcn.deform_conv2d.launches
    card = card_tr.val()
    torch.cuda.synchronize()
    nodes = sum(isinstance(m, DeformConvNode)
                for m in card_tr.model.modules())
    assert dcn.deform_conv2d.launches - before == nodes * 7

    cpu_tr = Trainer(_cfg(tmp_path, "cpu"), None, ds, device="cpu")
    cpu_tr.init_state(state_dict=weights)
    heads = _recording(cpu_tr)
    card_frusta, same_frustum = iter(frusta), []

    def card_frustum(*args, frustum=cpu_tr.model.frustum_heatmap):
        want = next(card_frusta).cpu()
        same_frustum.append(bool(torch.equal(frustum(*args), want)))
        return want

    cpu_tr.model.frustum_heatmap = card_frustum
    cpu = cpu_tr.val()
    assert sorted(card) == sorted(cpu) and len(cpu) == 100
    assert len(heads) == len(card_heads) == len(same_frustum) == 7

    # 1. the forward: every head of every batch
    worst = {}
    for got, want in zip(card_heads, heads):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if torch.is_tensor(w) and w.is_floating_point():
                scale = float(w.abs().max()) or 1.0
                dev = float((got[k] - w).abs().max()) / scale
                worst[k] = max(worst.get(k, 0.0), dev)
    print("\nheads, card vs cpu, of each head's largest magnitude (limit "
          f"{HEADS_RTOL}): " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in sorted(worst.items()))
          + f"; the CPU's own frustum heatmap equal to the card's in "
          f"{sum(same_frustum)} of {len(same_frustum)} batches")
    assert worst and max(worst.values()) <= HEADS_RTOL

    scales = {k: max(float(np.abs(np.asarray(it[k], np.float64)).max())
                     for items in cpu.values() for it in items)
              for k in KEYS}
    print("end to end, not asserted: worst detection pair "
          + _worst_pairs(cpu, card, scales) + "; summaries off by more "
          f"than {SUMMARY_RTOL}: "
          + str(_summaries_differ(card_tr.summaries["range_all"],
                                  cpu_tr.summaries["range_all"])))

    # 2. the CPU run's heads through the card's decode, post-process, scoring
    replay_tr = Trainer(_cfg(tmp_path, "replay"), None, ds, device="cuda")
    replay_tr.init_state(state_dict=weights)
    replay = iter(heads)
    replay_tr.model.forward = lambda *args, **kwargs: {
        k: v.to("cuda") if torch.is_tensor(v) else v
        for k, v in next(replay).items()}
    replayed = replay_tr.val()
    assert sorted(replayed) == sorted(cpu)
    for img_id, items in cpu.items():
        assert len(replayed[img_id]) == len(items), img_id
        costs = _pair(items, replayed[img_id], scales)
        assert np.all(costs <= REPLAY_RTOL), (img_id, costs.max(0))
    print(f"replayed heads, worst pair (limit {REPLAY_RTOL}): "
          + _worst_pairs(cpu, replayed, scales))
    assert _summaries_differ(replay_tr.summaries["range_all"],
                             cpu_tr.summaries["range_all"]) == []
