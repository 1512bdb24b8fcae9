"""``MODEL.FUSED_HEAD_TOWERS`` (``models/heads.py``): each stage's
``tower_0`` convs run as one conv, the tails on their channel slices.

- The port's fused heads equal its unfused ones, outputs and gradients,
  in float64 (the model forward, and the head set's backward);
- the port's fused head set equals JAX's fused ``DetectHeadSet``
  (``heads.py:116-167``) on the same weights, outputs and gradients;
- the fused towers compose with the tensor-parallel split: two gloo ranks
  (model 2, ``shard_params_tp``) stepping with fused towers equal one
  process stepping with unfused ones (loss parts, gradients, updated
  parameters), in float64.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from centerfusiondetect3d_tpu.config import load_config as jax_load_config
from centerfusiondetect3d_tpu.models.heads import DetectHeadSet as JaxHeads
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import to_device
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.heads import DetectHeadSet
from centerfusiondetect3d_tpu_torch.runtime.synthetic import seeded_weights
from centerfusiondetect3d_tpu_torch.training import make_optimizer, train_step

from test_torch_distributed import _run_ranks
from test_torch_training import _Float64Items, _small_opts

torch.set_num_threads(2)

LR = 2.0 ** -10


def _opts(fused: bool):
    return _small_opts("Conv") + ["MODEL.FUSED_HEAD_TOWERS", str(fused)]


def test_the_key_fuses_the_towers():
    for fused in (False, True):
        model = build_model(load_config(opts=_opts(fused), num_classes=10))
        assert model.detectHead_0.fuse_towers is fused


def _model_outputs(fused, sd, inputs):
    cfg = load_config(opts=_opts(fused), num_classes=10)
    model = build_model(cfg, dtype=torch.float64)
    model.load_state_dict(sd)
    img, pc, calib, pc_hm = inputs
    y = model(img, pc, calib, pc_hm, train=True)
    loss = sum((v.double() ** 2).mean() for k, v in y.items()
               if k not in ("calib", "pc_hm_in", "pc_hm", "pc_hm_out"))
    loss.backward()
    return y, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_fused_model_equals_unfused_float64():
    cfg = load_config(opts=_opts(False), num_classes=10)
    model = build_model(cfg)
    seeded_weights(model, 2)
    sd = model.state_dict()
    rng = np.random.RandomState(0)
    inputs = [torch.from_numpy(a) for a in (
        rng.randn(2, 3, 64, 128), np.abs(rng.randn(2, 3, 16, 32)),
        np.tile([[[120.0, 0, 16, 0], [0, 120.0, 8, 0], [0, 0, 1, 0]]],
                (2, 1, 1)), np.abs(rng.randn(2, 3, 16, 32)))]
    y0, g0 = _model_outputs(False, sd, inputs)
    y1, g1 = _model_outputs(True, sd, inputs)
    for k, v in y0.items():
        if k != "calib":
            torch.testing.assert_close(y1[k], v, rtol=1e-12, atol=1e-12)
    assert set(g0) == set(g1)
    for k, v in g0.items():  # of each tensor's largest magnitude
        assert float((g1[k] - v).abs().max()) <= 1e-10 * float(
            v.abs().max()), k
    # a head's tower gets its own gradient only
    assert float(g1["detectHead_0.dimension.0.weight"].abs().max()) > 0


@pytest.fixture(scope="module")
def jax_heads():
    """JAX's fused head set at the flagship's heads in float64: its config,
    weights, gradients of a mean-square loss, inputs and outputs."""
    cfg = jax_load_config(opts=_small_opts("Conv"), num_classes=10)
    heads = {k: int(v) for k, v in cfg.heads.items()}
    head_conv = {k: tuple(v) for k, v in cfg.head_conv.items()}
    secondary = ("velocity", "nuscenes_att", "depth2", "rotation2")
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 8, 16, 64)
    pc_hm = np.abs(rng.randn(2, 8, 16, 3))
    with jax.enable_x64(True):
        module = JaxHeads(heads=heads, head_conv=head_conv,
                          secondary=secondary, fuse_towers=True,
                          dtype=jnp.float64)

        def both(m, f, p):
            return m.first_stage(f), m.second_stage(f, p)

        params = module.init(jax.random.PRNGKey(0), feats, pc_hm,
                             method=both)["params"]
        params = jax.tree.map(
            lambda v: np.asarray(v, np.float64)
            + 0.05 * rng.randn(*np.shape(v)), params)

        def loss(p, f, pc):
            first, second = module.apply({"params": p}, f, pc, method=both)
            return sum(jnp.mean(jnp.square(v)) for d in (first, second)
                       for k, v in d.items() if k != "pc_hm_out")

        first, second = module.apply({"params": params}, feats, pc_hm,
                                     method=both)
        grads = jax.grad(loss)(params, feats, pc_hm)
    return {"cfg": cfg, "params": params, "grads": grads, "feats": feats,
            "pc_hm": pc_hm, "out": {**first, **second},
            "secondary": secondary}


def _jax_leaf(tree, name, head_conv):
    """The float64 leaf of a JAX head-set tree behind the port's parameter
    ``name`` (``head.i.weight`` or ``.bias``), laid out as the port's."""
    head, idx, leaf = name.split(".")
    idx = int(idx) // 2
    layer = "out" if idx == len(head_conv[head]) else f"tower_{idx}"
    v = np.asarray(tree[head][layer]["kernel" if leaf == "weight"
                                     else "bias"], np.float64)
    return np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v


def test_fused_heads_equal_jax_fused_heads(jax_heads):
    cfg = jax_heads["cfg"]
    heads = DetectHeadSet(64, {k: int(v) for k, v in cfg.heads.items()},
                          {k: tuple(v) for k, v in cfg.head_conv.items()},
                          jax_heads["secondary"], fuse_towers=True).double()
    with torch.no_grad():
        for name, p in heads.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(_jax_leaf(
                jax_heads["params"], name, cfg.head_conv))))
    f = torch.from_numpy(jax_heads["feats"]).permute(0, 3, 1, 2)
    pc = torch.from_numpy(jax_heads["pc_hm"]).permute(0, 3, 1, 2)
    stages = (heads.first_stage(f), heads.second_stage(f, pc))
    loss = sum((v ** 2).mean() for d in stages for k, v in d.items()
               if k != "pc_hm_out")
    loss.backward()
    got = {**stages[0], **stages[1]}
    for k, v in jax_heads["out"].items():
        np.testing.assert_allclose(got[k].detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(v), rtol=1e-10, atol=1e-12,
                                   err_msg=k)
    for name, p in heads.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), _jax_leaf(jax_heads["grads"], name,
                                      cfg.head_conv),
            rtol=1e-8, atol=1e-14, err_msg=name)


def test_fused_towers_compose_with_the_model_split(tmp_path):
    cfg = load_config(opts=_opts(False), num_classes=10)
    model = build_model(cfg)
    seeded_weights(model, 4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
        SyntheticTrainingSet)
    from centerfusiondetect3d_tpu_torch.data.pipeline import stack_items

    items = _Float64Items(SyntheticTrainingSet(cfg, 2, seed=1))
    batch = stack_items([items.get_item(i) for i in range(2)])
    ranks = _run_ranks(
        {"device": "cpu", "dtype": "float64", "state_dict": sd,
         "batch": batch, "digests": True,
         "steps": [{"opts": _opts(True) + ["TPU.MESH_MODEL", "2"],
                    "tp": True, "frozen": False, "accum": 1, "lr": LR}]},
        tmp_path, world=2)
    single = build_model(cfg, dtype=torch.float64)
    single.load_state_dict(sd)
    opt = make_optimizer(cfg, single)
    metrics = train_step(single, opt, GenericLoss(cfg),
                         to_device(batch, "cpu"), LR, False, 1)
    grads = {n: p.grad for n, p in single.named_parameters()
             if p.grad is not None}
    gmax = max(float(g.abs().max()) for g in grads.values())
    a, b = (r["steps"][0] for r in ranks)
    assert a["metrics"] == b["metrics"]
    assert a["grads_digest"] == b["grads_digest"]
    assert a["state_dict_digest"] == b["state_dict_digest"]
    for rank in ranks[:1]:
        got = rank["steps"][0]
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], float(v),
                                       rtol=1e-10, err_msg=k)
        for k, g in grads.items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-9 * gmax, k
        for k, v in single.state_dict().items():
            atol = (2 * LR if k in grads
                    and float(grads[k].abs().max()) < 1e-6 * gmax else 1e-10)
            np.testing.assert_allclose(got["state_dict"][k].numpy(),
                                       v.numpy(), rtol=1e-9, atol=atol,
                                       err_msg=k)
