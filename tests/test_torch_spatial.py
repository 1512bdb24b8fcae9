"""The height-split (spatial) layout on the CPU: the DCN's row origin
(``ops/dcn.py``), the halo layers (``models/layers.py``), and gloo ranks
against one process (``parallel/mesh.py``, ``tools/ddp_check.py``).

- The plain row-origin DCN: the forward, im2col, col2im (and its gather
  model) and coord on the rows [row0, row0 + Ho) equal those rows of the
  whole op within 1e-12 in float64, the bf16 versions within a bf16
  rounding; the forward's rows equal JAX's ``ops/dcn.py:deform_conv2d``.
- Each halo layer on two in-process shards (``_Rows``: the neighbours'
  rows read from the whole input) equals its slice of the unsharded layer:
  3x3 at stride 1 and 2, 7x7, (7, 1) and (1, 7), a strided 1x1, the
  bilinear transposed upsample, max-pool, a DeformConv node.
- Two gloo ranks (spatial 2) run the eval forward of the tiny model with
  Conv and with DeformConv nodes; four (data 1, spatial 2, model 2, towers
  split) take an unfrozen train step; both equal one process in float64
  (outputs; loss parts, gradients, updated parameters), and that process's
  step equals the JAX package's on the same weights (Conv nodes:
  ``_JaxReference`` and ``_compare_step`` of ``test_torch_training.py``;
  in eval mode those He-scaled weights with their drawn BatchNorm
  statistics blow the activations up, and the two packages' float64
  forwards part at 1e-5). The backbone's gradient is not scaled by the
  spatial ranks. A DeformConv node alone on the four ranks (each its rows
  of x, offsets across the ranks' boundary) equals the whole node forward
  and backward (``ddp_check`` spec ``dcn_node``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from centerfusiondetect3d_tpu.ops import dcn as jax_dcn
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import to_device
from centerfusiondetect3d_tpu_torch.losses import GenericLoss
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import (
    Conv2d, DeformConvNode, bilinear_up)
from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.parallel import mesh as layouts
from centerfusiondetect3d_tpu_torch.training import make_optimizer, train_step

from test_torch_distributed import _start_ranks
from test_torch_training import _JaxReference, _compare_step, _small_opts

torch.set_num_threads(2)

H, W, C, O, B = 9, 7, 5, 4, 2
# (row0, Ho): the top, the middle, the bottom, one row, the whole op
ROWS = [(0, 4), (3, 4), (5, 4), (8, 1), (0, 9)]
LR = 2.0 ** -10


def _dcn_case(seed=0):
    rng = np.random.RandomState(seed)
    offset = 1.5 * rng.randn(B, 18, H, W)
    far = rng.rand(*offset.shape) < 0.05  # off the image and across shards
    offset = np.where(far, np.sign(offset) * (6 + 3 * rng.rand(
        *offset.shape)), offset)
    return [torch.from_numpy(a) for a in (
        rng.randn(B, C, H, W), offset,
        1.0 / (1.0 + np.exp(-rng.randn(B, 9, H, W))),
        rng.randn(O, C, 3, 3) / 6.0, 0.1 * rng.randn(O))]


def _rows(t, row0, ho):
    return t[:, :, row0:row0 + ho].contiguous()


def _close(got, want, tol=1e-12):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale


# ------------------------------------------------ the DCN's row origin


@pytest.mark.parametrize("row0,ho", ROWS)
@pytest.mark.parametrize("max_offset", [None, 1.0])
def test_row_origin_forward_is_the_ops_rows(row0, ho, max_offset):
    x, off, mask, w, b = _dcn_case()
    full = dcn.deform_conv2d_plain(x, off, mask, w, b, max_offset)
    args = (x, _rows(off, row0, ho), _rows(mask, row0, ho), w, b, max_offset)
    want = full[:, :, row0:row0 + ho]
    _close(dcn.deform_conv2d_plain(*args, row0=row0), want)
    _close(dcn.deform_conv2d_tiled_plain(*args, row0=row0), want)
    # the operator, as a node under no grad calls it (the plain version on
    # the CPU)
    _close(dcn.deform_conv2d(*args, row0=row0), want)
    # bf16: the rows of the bf16 op, up to one rounding of the output
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    whole16 = dcn.deform_conv2d_bf16_plain(xb, off.float(), mask.float(), wb,
                                           bb, max_offset)
    part16 = dcn.dcn_fwd_bf16(xb, _rows(off, row0, ho).float(),
                              _rows(mask, row0, ho).float(), wb, bb,
                              max_offset, row0)
    torch.testing.assert_close(part16.float(),
                               whole16[:, :, row0:row0 + ho].float(),
                               rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("row0,ho", [(3, 4), (5, 4)])
def test_row_origin_forward_matches_jax(row0, ho):
    x, off, mask, w, b = _dcn_case(1)
    part = dcn.deform_conv2d_plain(x, _rows(off, row0, ho),
                                   _rows(mask, row0, ho), w, b, row0=row0)
    with jax.enable_x64(True):
        whole = jax_dcn.deform_conv2d(
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
            jnp.asarray(off.permute(0, 2, 3, 1).numpy()),
            jnp.asarray(mask.permute(0, 2, 3, 1).numpy()),
            jnp.asarray(w.permute(2, 3, 1, 0).numpy()), jnp.asarray(b.numpy()))
        whole = np.asarray(whole, np.float64)
    np.testing.assert_allclose(part.permute(0, 2, 3, 1).numpy(),
                               whole[:, row0:row0 + ho], rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("row0,ho", ROWS)
def test_row_origin_backward_kernels_are_the_ops_rows(row0, ho):
    x, off, mask, _, _ = _dcn_case(2)
    op, mp = _rows(off, row0, ho), _rows(mask, row0, ho)
    rng = np.random.RandomState(3)
    dcols = torch.from_numpy(rng.randn(B, ho * W, 9, C))
    # the column gradients of the whole op: the rows' own, zeros elsewhere
    whole_dcols = torch.zeros(B, H * W, 9, C, dtype=torch.float64)
    whole_dcols[:, row0 * W:(row0 + ho) * W] = dcols
    cols = dcn.dcn_im2col_plain(x, off, mask)
    _close(dcn.dcn_im2col(x, op, mp, row0=row0),
           cols[:, row0 * W:(row0 + ho) * W])
    dx = dcn.dcn_col2im_plain(whole_dcols, x, off, mask)
    _close(dcn.dcn_col2im_plain(dcols, x, op, mp, row0=row0), dx)
    _close(dcn.dcn_col2im(dcols, op, mp, row0=row0, height=H), dx)
    _close(dcn.dcn_col2im_gather_plain(dcols, op, mp, H, W, row0=row0), dx)
    doff, dmask = dcn.dcn_col2im_coord_plain(whole_dcols, x, off, mask)
    got_off, got_mask = dcn.dcn_col2im_coord(dcols, x, op, mp, row0=row0)
    _close(got_off, _rows(doff, row0, ho))
    _close(got_mask, _rows(dmask, row0, ho))
    # the map: one segment a pixel of the whole x
    ends, keys, _ = dcn.dcn_inverse_map(op, mp, row0=row0, height=H)
    assert ends.shape == (B * H * W,) and int(ends[-1]) == len(keys)
    assert int(keys.max()) < 9 * ho * W
    # bf16: the rounded columns and dx of the widened values
    xb, db = x.bfloat16(), dcols.bfloat16()
    torch.testing.assert_close(
        dcn.dcn_im2col_bf16(xb, op.float(), mp.float(), row0=row0).float(),
        dcn.dcn_im2col_bf16_plain(xb, off.float(), mask.float())[
            :, row0 * W:(row0 + ho) * W].float(), rtol=0, atol=0)
    wd = torch.zeros(B, H * W, 9, C, dtype=torch.bfloat16)
    wd[:, row0 * W:(row0 + ho) * W] = db
    torch.testing.assert_close(
        dcn.dcn_col2im_bf16(db, op.float(), mp.float(), row0=row0,
                            height=H).float(),
        dcn.dcn_col2im_bf16_plain(wd, xb, off.float(), mask.float()).float(),
        rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("bf16", [False, True])
def test_row_origin_autograd_is_the_ops_rows(bf16):
    """deform_conv2d with a row origin under autograd (float64: the plain
    version's autograd; bf16: the Function with the kernels' plain
    versions): the rows' gradients are those of the whole op for an output
    gradient that is zero outside the rows."""
    x, off, mask, w, b = _dcn_case(4)
    row0, ho = 3, 4
    g = torch.from_numpy(np.random.RandomState(5).randn(B, O, ho, W))
    whole_g = torch.zeros(B, O, H, W, dtype=torch.float64)
    whole_g[:, :, row0:row0 + ho] = g
    if bf16:
        x, w, b, g, whole_g = (t.bfloat16() for t in (x, w, b, g, whole_g))
        off, mask = off.float(), mask.float()

    def grads(offset, msk, grad, **kw):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, offset, msk, w, b)]
        out = dcn.deform_conv2d(*leaves, **kw)
        out.backward(grad)
        return [t.grad.float() for t in leaves]

    whole = grads(off, mask, whole_g)
    part = grads(_rows(off, row0, ho), _rows(mask, row0, ho), g, row0=row0)
    tol = 8e-3 if bf16 else 1e-10
    for i, (got, want) in enumerate(zip(part, whole)):
        if i in (1, 2):
            want = want[:, :, row0:row0 + ho]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_row_origin_refuses_rows_outside_x():
    x, off, mask, w, b = _dcn_case()
    for row0, ho in ((6, 4), (-1, 4)):
        with pytest.raises(ValueError, match="rows"):
            dcn._check_sampling(x.float(), _rows(off, 0, ho).float(),
                                _rows(mask, 0, ho).float(), None, row0=row0)


# --------------------------------------------- halo layers, two shards


class _Rows:
    """Shard ``index`` of a map whose whole is known: its halo rows and
    its gather read the whole map (the exchange of
    ``parallel/collectives.py:SpatialRows`` with the neighbours' rows at
    hand)."""

    def __init__(self, whole, index):
        self.whole, self.index = whole, index

    def row0(self, local_rows):
        return self.index * local_rows

    def halo(self, t, above, below):
        n = t.shape[2]
        r0 = self.index * n
        assert torch.equal(t, self.whole[:, :, r0:r0 + n])
        padded = F.pad(self.whole, (0, 0, above, below))
        return padded[:, :, r0:r0 + above + n + below]

    def gather(self, t):
        return self.whole


def _two_shards(layer, x):
    """``layer`` on each half of x's rows under its ``_Rows``, put
    together."""
    n = x.shape[2] // 2
    outs = []
    for i in range(2):
        with torch.no_grad(), layouts.row_shard(_Rows(x, i)):
            outs.append(layer(x[:, :, i * n:(i + 1) * n]))
    return torch.cat(outs, dim=2)


def _conv(cin, cout, k, stride=1, padding=None):
    kh, kw = (k, k) if isinstance(k, int) else k
    pad = (kh // 2, kw // 2) if padding is None else padding
    torch.manual_seed(0)
    return Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad).double()


@pytest.mark.parametrize("layer", [
    pytest.param(lambda: _conv(3, 4, 3), id="3x3"),
    pytest.param(lambda: _conv(3, 4, 3, 2), id="3x3-stride2"),
    pytest.param(lambda: _conv(3, 4, 7), id="7x7"),
    pytest.param(lambda: _conv(3, 4, (7, 1)), id="7x1"),
    pytest.param(lambda: _conv(3, 4, (1, 7)), id="1x7"),
    pytest.param(lambda: _conv(3, 4, 1, 2, 0), id="1x1-stride2"),
    pytest.param(lambda: bilinear_up(3, 2).double(), id="up2"),
    pytest.param(lambda: bilinear_up(3, 4).double(), id="up4"),
    pytest.param(lambda: bilinear_up(3, 8).double(), id="up8"),
    pytest.param(lambda: (lambda x: F.max_pool2d(x, 2, 2)), id="maxpool"),
])
def test_halo_layer_on_two_shards_is_the_whole_layers_slices(layer):
    layer = layer()
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 16, 10))
    with torch.no_grad():
        want = layer(x)
    _close(_two_shards(layer, x), want)


def test_deformconv_node_on_two_shards_is_the_whole_nodes_slices():
    torch.manual_seed(1)
    node = DeformConvNode(6, 5).double().eval()
    with torch.no_grad():  # offsets of a few pixels, across the shards
        node.conv_offset_mask.weight.normal_(0, 0.3)
        node.conv_offset_mask.bias.normal_(0, 1.0)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 6, 12, 9))
    with torch.no_grad():
        want = node(x)
    _close(_two_shards(node, x), want)


def test_misaligned_height_raises():
    cfg = load_config(opts=_opts("Conv"), num_classes=10)
    model = build_model(cfg, dtype=torch.float64).eval()
    image = torch.zeros(1, 3, 48, 128, dtype=torch.float64)  # 96 rows whole
    with layouts.layout(layouts.describe(1, 2, 1)), pytest.raises(
            ValueError, match="multiple of 32 x 2"):
        model(image, torch.zeros(1, 3, 24, 32, dtype=torch.float64),
              torch.zeros(1, 3, 4, dtype=torch.float64))


# ---------------------------------------- gloo ranks against one process


def _opts(node):
    return _small_opts(node)


@pytest.fixture(scope="module")
def conv_ref():
    return _JaxReference("Conv")


@pytest.fixture(scope="module")
def runs(conv_ref, tmp_path_factory):
    """Two ranks (spatial 2) forwarding, then four (1, 2, 2) stepping, each
    with Conv and DeformConv nodes on the Conv reference's batch; the JAX
    reference compiles while the ranks run."""
    batch = {k: v[:2] if not isinstance(v, dict) else
             {kk: vv[:2] for kk, vv in v.items()}
             for k, v in conv_ref.batch4.items()}
    sds = {"Conv": conv_ref.state_dict}
    cfg = load_config(opts=_opts("DeformConv"), num_classes=10)
    from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
        seeded_weights)

    dcn_model = build_model(cfg)
    seeded_weights(dcn_model, 3)
    sds["DeformConv"] = {k: v.clone() for k, v in
                         dcn_model.state_dict().items()}
    out = {"batch": batch, "sds": sds, "node_case": _node_case()}
    fwd = _start_ranks(
        {"device": "cpu", "dtype": "float64", "batch": batch,
         "state_dict": sds["Conv"],
         "forward": [{"opts": _opts("Conv") + ["TPU.MESH_SPATIAL", "2"]}]},
        tmp_path_factory.mktemp("fwd_conv"), world=2)
    fwd_dcn = _start_ranks(
        {"device": "cpu", "dtype": "float64", "batch": batch,
         "state_dict": sds["DeformConv"],
         "forward": [{"opts": _opts("DeformConv")
                      + ["TPU.MESH_SPATIAL", "2"]}]},
        tmp_path_factory.mktemp("fwd_dcn"), world=2)
    out["forward"] = {"Conv": fwd(), "DeformConv": fwd_dcn()}
    mesh = ["TPU.MESH_SPATIAL", "2", "TPU.MESH_MODEL", "2"]
    steps = {}
    for node in ("Conv", "DeformConv"):
        steps[node] = _start_ranks(
            {"device": "cpu", "dtype": "float64", "batch": batch,
             "state_dict": sds[node], "digests": True,
             "steps": [{"opts": _opts(node) + mesh, "tp": True,
                        "frozen": False, "accum": 1, "lr": LR}],
             **({"dcn_node": out["node_case"]} if node == "DeformConv"
                else {})},
            tmp_path_factory.mktemp(f"step_{node}"), world=4)
    # the one process against JAX: the unfrozen Conv step on these 2
    # images, compiled while the ranks run
    try:
        _compare_step(conv_ref, False, 1, 2)
        out["jax_step"] = None
    except AssertionError as e:
        out["jax_step"] = e
    out["steps"] = {node: collect() for node, collect in steps.items()}
    return out


def _node_case():
    """A DeformConv node's weights and a global x (2, 6, 12, 9) and output
    gradient from a numpy seed, offsets of a few pixels (across the two
    spatial ranks' boundary at row 6)."""
    rng = np.random.RandomState(8)
    node = DeformConvNode(6, 5).double()
    sd = {k: v.numpy().copy() for k, v in node.state_dict().items()}
    sd["weight"] = rng.randn(5, 6, 3, 3) / 7.0
    sd["bias"] = 0.1 * rng.randn(5)
    sd["conv_offset_mask.weight"] = 0.3 * rng.randn(27, 6, 3, 3)
    sd["conv_offset_mask.bias"] = rng.randn(27)
    return {"layout": (1, 2, 2), "state_dict": sd,
            "x": rng.randn(2, 6, 12, 9), "grad": rng.randn(2, 5, 12, 9)}


def _single(node, runs):
    cfg = load_config(opts=_opts(node), num_classes=10)
    model = build_model(cfg, dtype=torch.float64)
    model.load_state_dict(runs["sds"][node])
    return cfg, model


@pytest.mark.parametrize("node", ["Conv", "DeformConv"])
def test_two_spatial_ranks_forward_equals_one_process(runs, node):
    _, model = _single(node, runs)
    model.eval()
    b = to_device(runs["batch"], "cpu")
    with torch.no_grad():
        want = model(b["image"], b["pc_dep"], b["calib"])
    for rank in runs["forward"][node]:
        got = rank["forward"][0]
        assert got["image_rows"] == b["image"].shape[2] // 2
        for k, v in want.items():
            if k != "calib":
                _close(got["outputs"][k], v, 1e-10)


def test_one_process_step_equals_jax(runs):
    """The process the layout is held against steps as the JAX package's
    ``make_train_step`` does on the same weights and images (Conv nodes,
    ``test_torch_training.py:_compare_step``)."""
    assert runs["jax_step"] is None, runs["jax_step"]


def _one_step(node, runs):
    cfg, model = _single(node, runs)
    opt = make_optimizer(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = train_step(model, opt, GenericLoss(cfg),
                         to_device(runs["batch"], "cpu"), LR, False, 1)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads, before, model.state_dict()


@pytest.mark.parametrize("node", ["Conv", "DeformConv"])
def test_four_rank_layout_step_equals_one_process(runs, node):
    """(data 1, spatial 2, model 2), the wide towers split: every rank's
    loss parts, whole gradients and whole updated parameters equal one
    process's step on the same 2 images. A gradient below 1e-6 of the
    largest (a conv bias ahead of train-mode BatchNorm: zero but for
    rounding) moves its parameter by AdamW's normalised step either way:
    those parameters within 2 x LR."""
    metrics, grads, before, after = _one_step(node, runs)
    gmax = max(float(g.abs().max()) for g in grads.values())
    ranks = [r["steps"][0] for r in runs["steps"][node]]
    # every rank the same loss, whole gradients and weights (digests)
    for got in ranks[1:]:
        assert got["metrics"] == ranks[0]["metrics"]
        assert got["grads_digest"] == ranks[0]["grads_digest"]
        assert got["state_dict_digest"] == ranks[0]["state_dict_digest"]
    for got in ranks[:1]:
        assert set(got["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], float(v),
                                       rtol=1e-9, err_msg=k)
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            assert float((got["grads"][k] - g).abs().max()) <= 1e-8 * gmax, k
        for k, v in after.items():
            if k in grads and float(grads[k].abs().max()) < 1e-6 * gmax:
                atol = 2 * LR
            else:
                atol = 1e-9 * max(float(v.abs().max()), 1.0)
            np.testing.assert_allclose(got["state_dict"][k].numpy(),
                                       v.numpy(), rtol=1e-8, atol=atol,
                                       err_msg=k)
        assert any(not torch.equal(got["state_dict"][k], before[k])
                   for k in grads if k.startswith("base."))


@pytest.mark.parametrize("node", ["Conv", "DeformConv"])
def test_backbone_gradient_is_not_scaled_by_the_spatial_ranks(runs, node):
    """The features gathered before the heads: each spatial rank computes
    the whole loss, and a summing adjoint without the world's average (or
    a slicing one with it) would scale the backbone's gradient by 2."""
    _, grads, _, _ = _one_step(node, runs)
    got = runs["steps"][node][0]["steps"][0]["grads"]
    for prefix in ("base.", "dla_up.", "ida_up."):
        keys = [k for k in grads if k.startswith(prefix)]
        want = torch.cat([grads[k].flatten() for k in keys]).norm()
        mine = torch.cat([got[k].flatten() for k in keys]).norm()
        assert abs(float(mine / want) - 1.0) < 1e-9, prefix


def test_four_rank_dcn_node_equals_one_process(runs):
    """(data 1, spatial 2, model 2): a DeformConv node on each rank's rows
    (the offset conv with its halo, x gathered, the kernel's row origin,
    the gather's summing adjoint) equals the whole node: output rows,
    input rows' gradient, parameters' gradients summed over the spatial
    ranks."""
    case = runs["node_case"]
    node = DeformConvNode(6, 5).double()
    node.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case["state_dict"].items()})
    node.eval()
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = node(x)
    (y * torch.from_numpy(case["grad"])).sum().backward()
    got = [r["dcn_node"] for r in runs["steps"]["DeformConv"]]
    assert [g["row0"] for g in got] == [0, 0, 6, 6]
    for g in got:
        r0, h = g["row0"], g["y"].shape[2]
        _close(g["y"], y.detach()[:, :, r0:r0 + h])
        _close(g["x_grad"], x.grad[:, :, r0:r0 + h])
        for k, p in node.named_parameters():
            _close(g["grads"][k], p.grad)
