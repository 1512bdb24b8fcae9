"""The (data, spatial, model) layout's description (``parallel/mesh.py``)
against the JAX package's mesh, and the multi-chip dry run, on the CPU.

- Ranks lie on the layout as JAX's devices lie on its mesh
  (``reshape(n_data, n_spatial, n_model)``, model fastest), and the axes'
  process groups are the ranks that differ only along them.
- ``shard_batch``'s placement follows ``tests/test_spatial.py:40-62``: the
  image and the radar maps split H over 'spatial', a ``heatmap0`` of 6
  rows on 4 spatial ranks stays whole, the rest is the rank's data shard.
- ``tp_param_shardings`` splits the tensors that JAX's does on the same
  config (names mapped through ``weights.py``); ``shard_params_tp`` keeps
  each model rank's output channels.
- ``tools/dryrun_multichip.py 4 --device cpu`` passes (data 2 x model 2);
  the 8-rank run (data 2 x spatial 2 x model 2, in float64) is ``slow``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from centerfusiondetect3d_tpu import parallel as jax_parallel
from centerfusiondetect3d_tpu.config import load_config as jax_load_config
from centerfusiondetect3d_tpu.models import build_model as jax_build_model
from centerfusiondetect3d_tpu_torch import parallel
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.data.pipeline import to_device
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.parallel import mesh as layouts
from centerfusiondetect3d_tpu_torch.runtime.synthetic import MAIN_PATH_OPTS
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = (parallel.DATA_AXIS, parallel.SPATIAL_AXIS, parallel.MODEL_AXIS)


@pytest.mark.parametrize("shape", [(8, 1, 1), (2, 2, 2), (1, 2, 4),
                                   (2, 4, 1), (4, 1, 2)])
def test_ranks_lie_on_the_layout_as_jax_devices_on_its_mesh(shape,
                                                            devices8):
    n_data, n_spatial, n_model = shape
    mesh = jax_parallel.make_mesh(n_data=n_data, n_model=n_model,
                                  n_spatial=n_spatial, devices=devices8)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank in range(8):
        m = layouts.describe(n_data, n_spatial, n_model, rank)
        assert m.world == 8 and m.rank == rank
        assert ids[tuple(m.coords[a] for a in AXES)] == rank
    # each axis's groups: the ranks that differ only along it
    for axis, dim in zip(AXES, range(3)):
        want = sorted(sorted(np.moveaxis(ids, dim, -1).reshape(
            -1, shape[dim]).tolist()))
        assert sorted(layouts._members(dict(zip(AXES, shape)),
                                       (axis,))) == want
    stats = layouts._members(dict(zip(AXES, shape)), (parallel.DATA_AXIS,
                                                      parallel.SPATIAL_AXIS))
    assert sorted(stats) == sorted(ids[:, :, m].ravel().tolist()
                                   for m in range(n_model))


def test_make_mesh_in_one_process():
    mesh = parallel.make_mesh(-1, device="cpu")
    assert mesh.shape == dict(zip(AXES, (1, 1, 1)))
    assert mesh.data_parallel_only and mesh.rows() is None
    assert mesh.group(parallel.DATA_AXIS) is None
    for kw in ({"n_model": 2}, {"n_spatial": 2}, {"n_data": 2},
               {"n_model": 0}):
        with pytest.raises(ValueError, match="MESH"):
            parallel.make_mesh(device="cpu", **{"n_data": -1, **kw})


def _jax_batch_case():
    rng = np.random.RandomState(0)
    return {
        "image": rng.randn(2, 32, 48, 3).astype(np.float32),
        "pc_dep": rng.randn(2, 8, 12, 3).astype(np.float32),
        "calib": rng.randn(2, 3, 4).astype(np.float32),
        # H=6 does not divide spatial=4 -> stays whole
        "heatmap0": rng.randn(2, 6, 12, 10).astype(np.float32),
        "target": {"heatCenters": rng.randn(2, 8, 2).astype(np.float32)},
    }


def _nhwc(placement, ndim):
    """A port placement (NCHW maps) as the axes of each NHWC dim."""
    dims = {0: 0, 2: 1, 3: 2, 1: 3} if ndim == 4 else {d: d for d in
                                                        range(ndim)}
    out = [None] * ndim
    for dim, axis in placement.split.items():
        out[dims[dim]] = axis
    return tuple(out)


def test_shard_batch_placement_follows_jax(devices8):
    batch = _jax_batch_case()
    jmesh = jax_parallel.make_mesh(n_data=2, n_model=1, n_spatial=4,
                                   devices=devices8)
    jout = jax_parallel.shard_batch(batch, jmesh)
    dev_batch = to_device(batch, "cpu")
    for rank in range(8):
        mesh = layouts.describe(2, 4, 1, rank)
        where = parallel.batch_placement(dev_batch, mesh)
        assert where["image"] == parallel.spatial_sharding(mesh)
        assert where["pc_dep"] == parallel.spatial_sharding(mesh)
        assert where["heatmap0"] == parallel.batch_sharding(mesh)
        assert where["calib"] == parallel.batch_sharding(mesh)
        assert where["target"]["heatCenters"] == parallel.batch_sharding(
            mesh)
        for key in ("image", "pc_dep", "heatmap0", "calib"):
            spec = tuple(jout[key].sharding.spec)
            got = _nhwc(where[key], batch[key].ndim)
            assert got[:len(spec)] == spec and not any(got[len(spec):]), key
        out = parallel.shard_batch(dev_batch, mesh)
        s = mesh.coords[parallel.SPATIAL_AXIS]
        rows = slice(8 * s, 8 * s + 8)
        np.testing.assert_array_equal(
            out["image"].numpy(), batch["image"].transpose(0, 3, 1, 2)[
                :, :, rows])
        np.testing.assert_array_equal(
            out["pc_dep"].numpy(), batch["pc_dep"].transpose(0, 3, 1, 2)[
                :, :, 2 * s:2 * s + 2])
        assert out["heatmap0"].shape == (2, 10, 6, 12)  # whole
        assert out["calib"] is dev_batch["calib"]
        assert out["target"]["heatCenters"] is dev_batch["target"][
            "heatCenters"]
        # a numpy batch goes to the device first, as to_device lays it
        np.testing.assert_array_equal(
            parallel.shard_batch(batch, mesh)["image"].numpy(),
            out["image"].numpy())


def test_layout_height_check():
    layouts.check_spatial_height(64, 2)
    layouts.check_spatial_height(448, 2)
    layouts.check_spatial_height(50, 1)
    for h, n in ((448, 4), (96, 2), (64, 4)):
        with pytest.raises(ValueError, match=f"multiple of 32 x {n}"):
            layouts.check_spatial_height(h, n)
    mesh = layouts.describe(1, 2, 1)
    t = torch.zeros(1, 3, 8, 4)
    assert layouts.whole_rows(t, 8, mesh) is t
    with pytest.raises(ValueError, match="slice"):
        layouts.whole_rows(t, 12, mesh)


@pytest.fixture(scope="module")
def flagship():
    opts = MAIN_PATH_OPTS + ["MODEL.INPUT_SIZE", "(64, 128)",
                             "MIXED_PRECISION", "False"]
    cfg = jax_load_config(opts=opts, num_classes=10)
    model = jax_build_model(cfg)
    h, w = cfg.MODEL.INPUT_SIZE
    oh, ow = cfg.MODEL.OUTPUT_SIZE
    img = jax.ShapeDtypeStruct((1, h, w, 3), np.float32)
    pc = jax.ShapeDtypeStruct((1, oh, ow, 3), np.float32)
    calib = jax.ShapeDtypeStruct((1, 3, 4), np.float32)
    shapes = jax.eval_shape(
        lambda key, i, p, c: model.init(key, i, p, p, c, train=True),
        jax.random.PRNGKey(0), img, pc, calib)
    return opts, cfg, shapes


@pytest.mark.parametrize("n_model,min_width", [(2, 256), (4, 256),
                                               (2, 64), (2, 512), (1, 256)])
def test_tp_param_shardings_match_jax(flagship, devices8, n_model,
                                      min_width):
    opts, cfg, shapes = flagship
    jmesh = jax_parallel.make_mesh(n_data=8 // n_model, n_model=n_model,
                                   devices=devices8)
    marks = jax.tree.map(
        lambda s: np.float32(parallel.MODEL_AXIS in tuple(s.spec)),
        jax_parallel.tp_param_shardings(shapes["params"], jmesh, min_width))
    want = sorted(k for k, v in state_dict_from_jax(
        marks, {}, cfg.head_conv).items() if float(v) == 1.0)
    model = build_model(load_config(opts=opts, num_classes=10))
    mesh = layouts.describe(8 // n_model, 1, n_model)
    got = parallel.tp_param_shardings(model, mesh, min_width)
    assert sorted(got) == want
    if n_model == 2 and min_width == 256:
        # every head's tower_0, and the secondary heads' tower_1 and 2
        assert len(got) == 2 * (len(cfg.heads) + 2 * 4)


def test_shard_params_tp_keeps_each_ranks_channels(flagship):
    opts, _, _ = flagship
    cfg = load_config(opts=opts, num_classes=10)
    whole = build_model(cfg)
    sd = whole.state_dict()
    for m in range(2):
        model = build_model(cfg)
        model.load_state_dict(sd)
        names = parallel.shard_params_tp(model, layouts.describe(1, 1, 2, m))
        got = dict(model.named_parameters())
        for name in names:
            k = sd[name].shape[0] // 2
            assert torch.equal(got[name], sd[name][m * k:(m + 1) * k])
        assert model.detectHead_0.velocity[2].tp_shards == 2
        assert model.detectHead_0.velocity[6].tp_shards == 1  # out stays
        # a split conv runs only inside its layout
        with pytest.raises(RuntimeError, match="layout"):
            model.detectHead_0.heatmap[0](torch.zeros(1, 64, 4, 4))


def _dryrun(n):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m",
         "centerfusiondetect3d_tpu_torch.tools.dryrun_multichip", str(n),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=900)


def test_dryrun_multichip_4_on_the_cpu():
    proc = _dryrun(4)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("dryrun_multichip(4): train ok, loss=")
    assert "data 2 x spatial 1 x model 2" in lines[0]
    assert lines[1].startswith("dryrun_multichip(4): ok, loss=")
    assert "eval maps + sorted scores + 13 det keys match" in lines[1]


@pytest.mark.slow
def test_dryrun_multichip_8_on_the_cpu(capfd):
    from centerfusiondetect3d_tpu_torch.tools.dryrun_multichip import launch

    rc = launch(8, "cpu", float64=True)
    out, err = capfd.readouterr()
    assert rc == 0, (out[-3000:], err[-3000:])
    assert "data 2 x spatial 2 x model 2" in out
    assert "dryrun_multichip(8): ok" in out


def test_dryrun_layout_is_jaxs():
    from centerfusiondetect3d_tpu_torch.tools.dryrun_multichip import (
        layout_of)

    assert layout_of(1) == (1, 1, 1) and layout_of(2) == (2, 1, 1)
    assert layout_of(4) == (2, 1, 2) and layout_of(8) == (2, 2, 2)
    assert layout_of(6) == (3, 1, 2) and layout_of(16) == (4, 2, 2)
