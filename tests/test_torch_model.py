"""The port's model against the executed torch reference and the JAX model.

(1) Every head of the ``model_forward_*.npz`` goldens, whose weights are the
reference's own state_dict (``sd_*``, loaded with ``strict=True``); the
``_frustum`` variants reuse their base fixture's weights. Tolerance: the
golden bound of ``test_golden_parity.py``, rtol = atol = 2e-3.
(2) JAX ``model.apply`` on the same weights, carried over by
``weights.state_dict_from_jax``, which must equal the JAX package's
``export_torch_state_dict`` key for key.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

# the JAX package and what it imports (jax, flax, pyyaml); the card's
# machine has none of them and runs only this repo's -m cuda tests
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_build_model = pytest.importorskip(
    "centerfusiondetect3d_tpu.models").build_model
export_torch_state_dict = pytest.importorskip(
    "centerfusiondetect3d_tpu.training.checkpoint").export_torch_state_dict

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RTOL = ATOL = 2e-3


def _opts(node, fusion, frustum):
    # float32: the goldens are float32 runs of the reference
    return ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", node,
            "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", str(frustum),
            "MODEL.FUSION_STRATEGY", repr(fusion), "MIXED_PRECISION", "False"]


@pytest.mark.parametrize("fixture,node,fusion,frustum,sd_fixture", [
    ("model_forward.npz", "Conv", "middle", False, None),
    ("model_forward_globalconv.npz", "GlobalConv", "middle", False, None),
    ("model_forward_early.npz", "Conv", "early", False, None),
    ("model_forward_dcn.npz", "DeformConv", "middle", False, None),
    ("model_forward_dcn_wide.npz", "DeformConv", "middle", False, None),
    ("model_forward_dcn_loud.npz", "DeformConv", "middle", False, None),
    ("model_forward_frustum.npz", "Conv", "middle", True, "model_forward.npz"),
    ("model_forward_dcn_frustum.npz", "DeformConv", "middle", True,
     "model_forward_dcn.npz"),
    ("model_forward_dcn_wide_frustum.npz", "DeformConv", "middle", True,
     "model_forward_dcn_wide.npz"),
])
def test_model_matches_reference_golden(fixture, node, fusion, frustum,
                                        sd_fixture):
    g = np.load(os.path.join(FIXTURES, fixture))
    src = g if sd_fixture is None else np.load(os.path.join(FIXTURES,
                                                            sd_fixture))
    cfg = load_config(opts=_opts(node, fusion, frustum), num_classes=10)
    assert ({k: list(v) for k, v in cfg.head_conv.items()}
            == json.loads(bytes(g["meta_head_conv"]).decode()))
    model = build_model(cfg).eval()
    model.load_state_dict({k[3:]: torch.from_numpy(src[k])
                           for k in src.files if k.startswith("sd_")},
                          strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(g["in_img"]),
                  torch.from_numpy(g["in_pc_dep"]),
                  torch.from_numpy(g["in_calib"]))
    compared = 0
    for key in g.files:
        if key.startswith("out_") and key != "out_calib":
            np.testing.assert_allclose(y[key[4:]].numpy(), g[key],
                                       rtol=RTOL, atol=ATOL, err_msg=key)
            compared += 1
    assert compared >= (12 if fusion == "middle" else 9), compared


def _inputs(seed, b=2, h=64, w=128):
    rng = np.random.RandomState(seed)
    img = rng.randn(b, 3, h, w).astype(np.float32)
    pc_dep = np.zeros((b, 3, h // 4, w // 4), np.float32)
    hit = rng.rand(b, h // 4, w // 4) < 0.15
    pc_dep[:, 0][hit] = rng.uniform(15, 25, hit.sum())
    pc_dep[:, 1][hit] = rng.randn(hit.sum())
    pc_dep[:, 2][hit] = rng.randn(hit.sum())
    calib = np.tile(np.array([[100.0, 0, w / 2, 0], [0, 100.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    return img, pc_dep, calib


@pytest.fixture(scope="module")
def jax_model():
    """A JAX DeformConv middle-fusion model with frustum association and
    weights from a seed: offset convs drawn so offsets are ~1.5 px, random
    BatchNorm affine and running statistics, and depth/dimension biases that
    put the first-stage boxes' frustum windows on the radar's 15-25 m."""
    opts = _opts("DeformConv", "middle", True) + [
        "MODEL.DLA.DCN_IMPL", "'xla'", "MIXED_PRECISION", "False",
        "MODEL.APPROX_TOPK", "False"]
    cfg = jax_load_config(opts=opts, num_classes=10)
    model = jax_build_model(cfg)
    img, pc_dep, calib = _inputs(0)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), nhwc(img), None, nhwc(pc_dep),
        jnp.asarray(calib), train=False)
    rng = np.random.RandomState(1)

    def perturb(path, v):
        v = np.array(v, np.float32)
        names = [getattr(p, "key", str(p)) for p in path]
        if "conv_offset_mask" in names and names[-1] == "kernel":
            v = rng.randn(*v.shape) * 1.5 / np.sqrt(np.prod(v.shape[:3]))
        elif (names[-1] in ("kernel", "weight")
              and not any(n.startswith("up_") for n in names)):
            # He scale: the torch default init's 1/3 variance lets the
            # signal fade over DLA-34's depth into flat, tie-ridden maps
            v = v * np.sqrt(6.0)
        elif names[-1] in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif names[-1] == "mean" or (names[-1] == "bias" and "bn" in names):
            v = 0.1 * rng.randn(*v.shape)
        elif names[-2:] == ["out", "bias"] and names[-3] == "depth":
            v[:] = -np.log(20.0)  # depths near 20 m, as the radar's
        elif names[-2:] == ["out", "bias"] and names[-3] == "dimension":
            v[:] = (1.5, 1.6, 4.0)  # car-sized frustum windows
        return np.asarray(v, np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    stats = jax.tree_util.tree_map_with_path(perturb,
                                             variables["batch_stats"])
    y = model.apply({"params": params, "batch_stats": stats}, nhwc(img),
                    None, nhwc(pc_dep), jnp.asarray(calib), train=False)[-1]
    return cfg, params, stats, (img, pc_dep, calib), y


def test_state_dict_from_jax_equals_jax_export(jax_model):
    cfg, params, stats, _, _ = jax_model
    want = export_torch_state_dict(params, stats, cfg.head_conv)
    got = state_dict_from_jax(params, stats, cfg.head_conv)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_model_matches_jax_apply(jax_model):
    cfg, params, stats, (img, pc_dep, calib), want = jax_model
    port_cfg = load_config(opts=_opts("DeformConv", "middle", True),
                           num_classes=10)
    model = build_model(port_cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, stats, cfg.head_conv),
                          strict=True)
    nodes = [m for m in model.modules() if isinstance(m, DeformConvNode)]
    assert len(nodes) == 16
    assert all(m.conv_offset_mask.weight.abs().max() > 0 for m in nodes)
    with torch.no_grad():
        y = model(torch.from_numpy(img), torch.from_numpy(pc_dep),
                  torch.from_numpy(calib))
    assert float(y["pc_hm"].abs().sum()) > 0, "frustum painted nothing"
    for name, value in want.items():
        if name == "calib":
            continue
        np.testing.assert_allclose(
            y[name].numpy(), np.transpose(np.asarray(value), (0, 3, 1, 2)),
            rtol=RTOL, atol=ATOL, err_msg=name)
