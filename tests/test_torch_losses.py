"""The port's losses against the executed torch reference and the JAX package.

(1) The primitives against ``losses.npz`` and ``GenericLoss`` against
``generic_loss.npz`` (both produced by executing the reference), with the
tolerances of the JAX package's own golden tests (``test_golden_parity.py``,
``test_golden_datalayer.py``): rtol 2e-4, atol 2e-5 for the primitives and
rtol 2e-4, atol 1e-5 for the loss parts.
(2) The same functions of the JAX package on the same numpy inputs, where
both run float32 and sum in another order: rtol 1e-5, atol 1e-6.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.geometry.affine import get_affine_transform
from centerfusiondetect3d_tpu_torch.losses import (
    SIZE_THRESH,
    GenericLoss,
    build_layer_masks,
)
from centerfusiondetect3d_tpu_torch.losses import primitives as P

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_primitives = pytest.importorskip("centerfusiondetect3d_tpu.losses.primitives")
jax_generic = pytest.importorskip("centerfusiondetect3d_tpu.losses.generic")

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6
HEADS = {"heatmap": 10, "reg": 2, "widthHeight": 2, "depth": 1,
         "rotation": 8, "dimension": 3, "amodal_offset": 2,
         "nuscenes_att": 8, "velocity": 3, "depth2": 1, "rotation2": 8}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _primitive_calls(g, lib, to_map, to_arr):
    """Every primitive on the arrays of a losses.npz-shaped dict."""
    ind = to_arr(g["ind"].astype(np.int64 if lib is P else np.int32))
    cat = to_arr(g["cat"].astype(np.int64 if lib is P else np.int32))
    rotbin = to_arr(g["rotbin"].astype(np.int64 if lib is P else np.int32))
    out = {
        "out_focal": lib.fast_focal_loss(to_map(g["out"]), to_map(g["target"]),
                                         ind, to_arr(g["mask"]), cat),
        "out_regl1": lib.reg_weighted_l1(to_map(g["reg_out"]),
                                         to_arr(g["reg_mask"]), ind,
                                         to_arr(g["reg_target"])),
        "out_wbce": lib.weighted_bce(to_map(g["att_out"]),
                                     to_arr(g["att_mask"]), ind,
                                     to_arr(g["att_target"])),
        "out_binrot": lib.bin_rot_loss(to_map(g["rot_out"]),
                                       to_arr(g["rot_mask"][..., 0]), ind,
                                       rotbin, to_arr(g["rotres"])),
        "out_decoupled": lib.decoupled_loss(to_map(g["dep_out"]),
                                            to_arr(g["dep_mask"]), ind,
                                            to_arr(g["dep_target"]),
                                            to_arr(g["trunc"])),
        "out_giou": lib.giou_2d(to_arr(g["boxes_p"]), to_arr(g["boxes_t"]),
                                to_arr(g["mask"])),
    }
    out["out_unc_l1"], out["out_unc_unc"] = lib.uncertainty_depth_loss(
        to_map(g["dep_out"]), to_arr(g["dep_mask"]), ind,
        to_arr(g["dep_target"]), to_map(g["unc_out"]))
    return {k: float(v) for k, v in out.items()}


def _port_primitives(g):
    return _primitive_calls(g, P, _t, _t)


def _jax_primitives(g):
    return _primitive_calls(g, jax_primitives, _nhwc, jnp.asarray)


def test_primitives_match_reference_golden():
    g = dict(np.load(os.path.join(FIXTURES, "losses.npz")))
    for key, got in _port_primitives(g).items():
        np.testing.assert_allclose(got, g[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)


def _random_losses_case(seed, empty: bool):
    """A losses.npz-shaped dict from a seed; ``empty`` clears every mask
    (the no-target branches)."""
    rng = np.random.RandomState(seed)
    b, m, h, w = 2, 9, 12, 20
    sig = lambda a: 1 / (1 + np.exp(-a))
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(b, m) < 0.7).astype(np.float32) * (not empty)
    g = {
        "out": np.clip(sig(f(b, 10, h, w)), 1e-4, 1 - 1e-4).astype(np.float32),
        "target": rng.rand(b, 10, h, w).astype(np.float32) ** 4,
        "ind": rng.randint(0, h * w, (b, m)), "cat": rng.randint(0, 10, (b, m)),
        "mask": mask, "reg_out": f(b, 3, h, w), "reg_target": f(b, m, 3),
        "reg_mask": np.repeat(mask[..., None], 3, -1),
        "att_out": f(b, 8, h, w), "att_target": (rng.rand(b, m, 8) < 0.3)
        .astype(np.float32),
        "att_mask": np.repeat(mask[..., None], 8, -1),
        "rot_out": f(b, 8, h, w), "rotbin": rng.randint(0, 2, (b, m, 2)),
        "rotres": f(b, m, 2), "rot_mask": mask[..., None],
        "dep_out": f(b, 1, h, w), "dep_target": f(b, m, 1),
        "dep_mask": mask[..., None], "unc_out": f(b, 1, h, w),
        "trunc": (rng.rand(b, m, 1) < 0.3).astype(np.float32),
    }
    x1 = rng.uniform(0, 10, (b, m, 2)).astype(np.float32)
    g["boxes_p"] = np.concatenate([x1, x1 + rng.uniform(1, 5, (b, m, 2))],
                                  -1).astype(np.float32)
    g["boxes_t"] = np.concatenate([x1 + 0.5, x1 + rng.uniform(1, 5, (b, m, 2))],
                                  -1).astype(np.float32)
    return g


@pytest.mark.parametrize("seed,empty", [(0, False), (1, False), (2, True)])
def test_primitives_match_jax(seed, empty):
    g = _random_losses_case(seed, empty)
    want = _jax_primitives(g)
    for key, got in _port_primitives(g).items():
        np.testing.assert_allclose(got, want[key], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=key)


def _golden_loss_case(tag):
    g = np.load(os.path.join(FIXTURES, "generic_loss.npz"))
    n_layers = int(g[f"{tag}_nlayers"])
    weights = dict((str(kv).split("=")[0], float(str(kv).split("=")[1]))
                   for kv in g[f"{tag}_weights"])
    heads = dict(HEADS, heatmap=4)
    if tag == "unc":
        heads["uncertainty"] = 1
    oh, ow = 12, 20
    cfg = SimpleNamespace(
        heads=heads, weights=weights,
        MODEL=SimpleNamespace(OUTPUT_SIZE=(oh, ow), NORM_2D=(tag == "unc")),
        DATASET=SimpleNamespace(DECOUPLE_REP=(tag == "unc")),
        TRAIN=SimpleNamespace(UNCERTAINTY_LOSS=(tag == "unc")))
    outputs = [{k[len(f"{tag}_out{li}_"):]: g[k] for k in g.files
                if k.startswith(f"{tag}_out{li}_")} for li in range(n_layers)]
    batch = {}
    for k in g.files:
        if k.startswith(f"{tag}_batch_"):
            name, v = k[len(tag) + 7:], g[k]
            if name in ("pc_lidar", "pc_2d"):
                v = np.transpose(v, (0, 2, 1))  # (B, 3, N) -> (B, N, 3)
            batch[name] = v
    batch["target"] = {k[len(tag) + 8:]: g[k] for k in g.files
                       if k.startswith(f"{tag}_target_")}
    batch["trans_mat"] = get_affine_transform(
        g[f"{tag}_meta_center"][0], float(g[f"{tag}_meta_scale"][0]), 0,
        (ow, oh), inverse=True).astype(np.float32)
    want = {k[len(tag) + 6:]: float(g[k]) for k in g.files
            if k.startswith(f"{tag}_loss_")}
    return cfg, outputs, batch, want


def _port_loss(cfg, outputs, batch, training):
    to = lambda d: {k: (to(v) if isinstance(v, dict) else _t(v))
                    for k, v in d.items()}
    total, parts = GenericLoss(cfg)([to(o) for o in outputs], to(batch),
                                    train=training)
    return float(total), {k: float(v) for k, v in parts.items()}


def _jax_loss(cfg, outputs, batch, training):
    to = lambda d, maps: {k: (to(v, maps) if isinstance(v, dict) else
                              (_nhwc(v) if maps(k, v) else jnp.asarray(v)))
                          for k, v in d.items()}
    is_map = lambda k, v: np.ndim(v) == 4 and k != "bboxes3d"
    total, parts = jax_generic.GenericLoss(cfg)(
        [to(o, is_map) for o in outputs],
        to(batch, lambda k, v: k.startswith("heatmap")), train=training)
    return float(total), {k: float(v) for k, v in parts.items()}


@pytest.mark.parametrize("tag,training", [("base", False), ("unc", True),
                                          ("two", False)])
def test_generic_loss_matches_reference_golden(tag, training):
    cfg, outputs, batch, want = _golden_loss_case(tag)
    total, parts = _port_loss(cfg, outputs, batch, training)
    compared = 0
    for name, value in want.items():
        if name in ("total_ret", "uncertainty"):
            continue  # the return value below; a placeholder key
        np.testing.assert_allclose(parts[name], value, rtol=2e-4, atol=1e-5,
                                   err_msg=f"{tag}:{name}")
        compared += 1
    np.testing.assert_allclose(total, want["total_ret"], rtol=2e-4)
    assert compared >= 12, compared


@pytest.mark.parametrize("tag,training", [("base", False), ("unc", True),
                                          ("two", False)])
def test_generic_loss_matches_jax(tag, training):
    cfg, outputs, batch, _ = _golden_loss_case(tag)
    total, parts = _port_loss(cfg, outputs, batch, training)
    want_total, want = _jax_loss(cfg, outputs, batch, training)
    assert sorted(parts) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(parts[name], value, rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=f"{tag}:{name}")
    np.testing.assert_allclose(total, want_total, rtol=JAX_RTOL)


def test_layer_masks_match_jax():
    rng = np.random.RandomState(3)
    wh = rng.uniform(0, 12, (2, 30, 2)).astype(np.float32)
    for n in (1, 2, 3):
        got = build_layer_masks(_t(wh), (12, 20), n).numpy()
        want = np.asarray(jax_generic.build_layer_masks(jnp.asarray(wh),
                                                        (12, 20), n))
        np.testing.assert_array_equal(got, want)
    assert SIZE_THRESH == jax_generic.SIZE_THRESH
