"""Multi-process training and validation (``parallel/*``) on the CPU.

Two gloo processes (``tools/ddp_check.py``, a ``file://`` store in
``tmp_path``, a timeout each) against one process and the JAX package:

- ``all_gather_detections`` and ``is_main_process``, as the JAX package's
  ``test_two_process_all_gather``;
- ``BatchNorm2d`` in train mode over 2 ranks equals one process on the
  concatenated batch in float64 (outputs, running statistics, gradients);
- the float64 two-rank ``train_step`` (Conv nodes, train-mode BatchNorm),
  frozen and unfrozen with ``GRAD_ACCUM`` 1 and 2, against JAX
  ``make_train_step`` on the global batch under ``jax.enable_x64``, with
  the tolerances of ``test_torch_training.py::test_train_step_matches_jax_f64``;
  both ranks report the same global loss;
- two-rank sharded ``Trainer.val`` against single-process ``val`` on 6
  items, with and without ``meta`` (ids cover exactly 0..5), as JAX's
  ``test_two_process_sharded_validation`` (float64 here, so that the
  shards' other batch compositions cannot reorder near-equal peaks);
- ``main.py`` under ``torch.distributed.run --nproc_per_node 2 --device
  cpu``: one epoch and a validation on a handful of the repo's images,
  rank 0 alone writing the checkpoints and ``metrics.jsonl`` into one run
  directory.

The process group's refusals (a half-configured environment, two NCCL
ranks on one card, a layout that is not the world or whose height split
is misaligned) run in this process.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch import parallel
from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models.layers import BatchNorm2d
from centerfusiondetect3d_tpu_torch.parallel import distributed
from centerfusiondetect3d_tpu_torch.runtime.fit import Trainer
from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
    MAIN_PATH_OPTS,
    seeded_weights,
)
from centerfusiondetect3d_tpu_torch.tools.ddp_check import (
    SyntheticValSet,
    rank_rows,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600  # seconds, each subprocess


def _run_ranks(spec, tmp_path, world=2):
    """Runs ``tools/ddp_check.py`` as ``world`` gloo processes on ``spec``;
    returns what each rank wrote."""
    return _start_ranks(spec, tmp_path, world)()


def _start_ranks(spec, tmp_path, world=2):
    """Starts the ranks of ``_run_ranks``; returns the function that waits
    for them and reads what they wrote."""
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "centerfusiondetect3d_tpu_torch.tools.ddp_check",
         "--spec", str(path), "--rank", str(r), "--world", str(world),
         "--init-method", f"file://{store}", "--backend", "gloo",
         "--out", str(tmp_path / "out{rank}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]

    def collect():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
                for r in range(world)]
        for name in [f"out{r}.pt" for r in range(world)] + ["spec.pt"]:
            os.remove(tmp_path / name)  # a model's tensors a rank: 100s of MB
        return outs

    return collect


# ------------------------------------------------- the group's refusals


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for key in distributed.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    assert parallel.initialize() is False
    assert not torch.distributed.is_initialized()
    assert parallel.world_size() == 1 and parallel.is_main_process()
    assert not parallel.is_multiprocess() and not parallel.launched()


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"RANK": "0"},
                                 {"WORLD_SIZE": "2", "RANK": "0"},
                                 {"WORLD_SIZE": "2", "RANK": "2",
                                  "MASTER_ADDR": "localhost",
                                  "MASTER_PORT": "29500"}])
def test_initialize_refuses_a_half_configured_environment(monkeypatch, env):
    for key in distributed.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="parallel.initialize"):
        parallel.initialize(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        distributed._nccl_device(1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        distributed._nccl_device(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        distributed._nccl_device(0)


def test_mesh_is_data_parallel_only():
    """The default layout is the data axis alone (one process: 1 x 1 x 1,
    no layout for the step); the axes must multiply to the world size; a
    height split needs the input height to be a multiple of 32 x
    n_spatial."""
    mesh = parallel.make_mesh(-1, device="cpu")
    assert mesh.shape == {parallel.DATA_AXIS: 1, parallel.SPATIAL_AXIS: 1,
                          parallel.MODEL_AXIS: 1}
    assert mesh.device == torch.device("cpu") and mesh.rank == 0
    assert mesh.data_parallel_only
    cfg0 = load_config(opts=["MIXED_PRECISION", "False"], num_classes=10)
    trainer = Trainer(cfg0, device="cpu")
    assert trainer.mesh.data_parallel_only and trainer._layout() is None
    assert trainer._data_shard() is None
    for kw in ({"n_model": 2}, {"n_spatial": 2}):  # 2 ranks of a world of 1
        with pytest.raises(ValueError, match="world size 1"):
            parallel.make_mesh(-1, device="cpu", **kw)
    with pytest.raises(ValueError, match="MESH_DATA"):
        parallel.make_mesh(8, device="cpu")
    cfg = load_config(opts=["TPU.MESH_DATA", "4", "MIXED_PRECISION",
                            "False"], num_classes=10)
    with pytest.raises(ValueError, match="MESH_DATA"):
        Trainer(cfg, device="cpu")
    model = trainer.model.eval()
    with parallel.layout(parallel.describe(1, 2, 1)), pytest.raises(
            ValueError, match="multiple of 32 x 2 = 64"):
        model(torch.zeros(1, 3, 48, 128), torch.zeros(1, 3, 24, 32),
              torch.zeros(1, 3, 4))
    batch = {"image": np.zeros((2, 8, 8, 3), np.float32),
             "calib": np.zeros((2, 3, 4), np.float32)}
    put = parallel.shard_batch(batch, mesh)
    assert put["image"].shape == (2, 3, 8, 8)  # laid out as to_device lays it
    dets = {"scores": torch.ones(2, 3), "classIds": torch.zeros(2, 3)}
    got = parallel.gather_detections(dets)
    assert isinstance(got["scores"], np.ndarray)
    assert parallel.replicate(dets, mesh) is dets


def test_rank_rows_split_every_global_microbatch():
    assert rank_rows(4, 2, 0, 1) == [0, 1] and rank_rows(4, 2, 1, 1) == [2, 3]
    assert rank_rows(4, 2, 0, 2) == [0, 2] and rank_rows(4, 2, 1, 2) == [1, 3]
    assert sorted(rank_rows(12, 3, 0, 2) + rank_rows(12, 3, 1, 2)
                  + rank_rows(12, 3, 2, 2)) == list(range(12))


# ------------------------------------------- gather and BatchNorm, 2 ranks


def _bn_case():
    rng = np.random.RandomState(0)
    c = 5
    return {"x": rng.randn(6, c, 4, 3) * 2.0 + 1.5,
            "grad": rng.randn(6, c, 4, 3),
            "weight": rng.uniform(0.5, 1.5, c), "bias": 0.1 * rng.randn(c),
            "running_mean": 0.1 * rng.randn(c),
            "running_var": rng.uniform(0.5, 1.5, c)}


def test_gather_and_batchnorm_over_two_ranks(tmp_path):
    case = _bn_case()
    r0, r1 = _run_ranks({"device": "cpu", "gather": True,
                         "batchnorm": case}, tmp_path)
    # the gather: rank order, dtypes kept, every rank the same
    for out in (r0, r1):
        got = out["gather"]["gathered"]
        np.testing.assert_array_equal(
            got["scores"], np.repeat([0.0, 1.0], 2)[:, None] * np.ones(3))
        assert got["scores"].dtype == np.float32
        np.testing.assert_array_equal(got["ids"], [0, 1, 2, 10, 11, 12])
        assert got["ids"].dtype == np.int64
    assert r0["gather"]["main"] and not r1["gather"]["main"]
    assert r0["world"] == 2 and r0["backend"] == "gloo"

    # BatchNorm2d over the ranks = one process on the concatenated batch
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    bn = BatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(case[name]))
    y = bn(x)
    (y * torch.from_numpy(case["grad"])).sum().backward()
    a, b = r0["batchnorm"], r1["batchnorm"]
    assert a["rows"] + b["rows"] == list(range(6))
    np.testing.assert_allclose(np.concatenate([a["y"], b["y"]]),
                               y.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([a["x_grad"], b["x_grad"]]),
                               x.grad.numpy(), rtol=1e-10, atol=1e-12)
    for name in ("weight_grad", "bias_grad"):
        want = getattr(bn, name.split("_")[0]).grad.numpy()
        np.testing.assert_allclose(a[name] + b[name], want, rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_allclose(a[name], getattr(bn, name).numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=name)


# -------------------------------------------- train steps against JAX


@pytest.fixture(scope="module")
def conv_ref():
    pytest.importorskip("jax")
    from test_torch_training import _JaxReference

    return _JaxReference("Conv")


STEP_CASES = [(True, 1), (False, 1), (True, 2), (False, 2)]


def test_two_rank_train_steps_match_jax_on_the_global_batch(conv_ref,
                                                            tmp_path):
    from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

    lr = 2.0 ** -10
    spec = {"device": "cpu", "dtype": "float64",
            "state_dict": conv_ref.state_dict, "batch": conv_ref.batch4,
            "steps": [{"opts": conv_ref.opts, "frozen": f, "accum": a,
                       "lr": lr} for f, a in STEP_CASES]}
    collect = _start_ranks(spec, tmp_path)
    # the JAX steps compile while the ranks run
    wants = [conv_ref.step(conv_ref.state(), conv_ref.batch4, lr, frozen,
                           accum) for frozen, accum in STEP_CASES]
    r0, r1 = collect()
    for (frozen, accum), (state, want), got0, got1 in zip(
            STEP_CASES, wants, r0["steps"], r1["steps"]):
        label = f"frozen={frozen} accum={accum}"
        assert sorted(got0["rows"] + got1["rows"]) == [0, 1, 2, 3]
        # both ranks report the global loss and hold the same weights
        assert got0["metrics"] == got1["metrics"], label
        for k, v in got0["state_dict"].items():
            assert torch.equal(v, got1["state_dict"][k]), (label, k)
        assert set(want) == set(got0["metrics"])
        for k, v in want.items():
            np.testing.assert_allclose(got0["metrics"][k], v, rtol=1e-8,
                                       atol=1e-12, err_msg=f"{label} {k}")
        new_sd = state_dict_from_jax(state.params, state.batch_stats,
                                     conv_ref.cfg.head_conv)
        changed = {"base": 0, "detectHead_0": 0}
        for key, want_t in new_sd.items():
            got = got0["state_dict"][key].float().numpy()
            want_n = want_t.numpy()
            atol = (3e-7 * float(np.abs(want_n).max()) if "running" in key
                    else 1e-10)
            np.testing.assert_allclose(got, want_n, rtol=3e-7, atol=atol,
                                       err_msg=f"{label} {key}")
            top = key.split(".")[0]
            if top in changed and "running" not in key and not np.array_equal(
                    want_n, conv_ref.state_dict[key].numpy()):
                changed[top] += 1
        assert changed["detectHead_0"] > 0
        assert (changed["base"] == 0) == frozen, (label, changed)
        # train-mode BatchNorm: the statistics moved
        assert any(not torch.equal(got0["state_dict"][k],
                                   conv_ref.state_dict[k].to(
                                       got0["state_dict"][k].dtype))
                   for k in got0["state_dict"] if "running_mean" in k)


# --------------------------------------------------- sharded validation


VAL_OPTS = MAIN_PATH_OPTS + [
    "MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "Conv",
    "MIXED_PRECISION", "False", "MODEL.K", "8", "TEST.BATCH_SIZE", "2",
    "WORKERS", "0"]


def _digest(results):
    return {int(k): np.asarray([[float(d["class"]), float(d["score"]),
                                 float(d["yaw"])] + list(map(float,
                                                             d["location"]))
                                for d in v], np.float64)
            for k, v in results.items()}


def test_two_rank_sharded_validation_matches_one_process(tmp_path):
    cfg = load_config(opts=VAL_OPTS, num_classes=10)
    trainer = Trainer(cfg, device="cpu")
    seeded_weights(trainer.model, 3)
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.double()
    trainer.init_state(state_dict=sd)
    cases = []
    for meta in (True, False):
        cases.append({"opts": VAL_OPTS,
                      "output_dir": str(tmp_path / f"val_{meta}"),
                      "dataset": {"kind": "synthetic", "n": 6, "seed": 2,
                                  "meta": meta}})
    r0, r1 = _run_ranks({"device": "cpu", "dtype": "float64",
                         "state_dict": sd, "val": cases}, tmp_path)
    for i, meta in enumerate((True, False)):
        trainer.config.defrost()
        trainer.config.OUTPUT_DIR = str(tmp_path / f"single_{meta}")
        trainer.dataset_val = SyntheticValSet(cfg, 6, 2, meta, float64=True)
        single = _digest(trainer.val())
        d0, d1 = (_digest(r["val"][i]["results"]) for r in (r0, r1))
        assert sorted(d0) == sorted(d1) == sorted(single) == list(range(6))
        for k in single:
            np.testing.assert_array_equal(d0[k], d1[k])
            np.testing.assert_allclose(d0[k], single[k], rtol=1e-3,
                                       atol=1e-3, err_msg=f"meta={meta} {k}")


# ----------------------------------------------- main.py under torchrun


def test_main_under_torch_distributed_run_two_cpu_ranks(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    root = chip_smoke.tiny_root(str(tmp_path),
                                splits={"mini_train": 4, "mini_val": 2})
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "centerfusiondetect3d_tpu_torch.main",
           "--device", "cpu", "DATASET.ROOT", repr(root + "/"),
           "OUTPUT_DIR", repr(str(out)), "NAME", "ddp",
           "MODEL.INPUT_SIZE", "(64, 96)", "MODEL.DLA.NODE", "Conv",
           "MODEL.K", "8", "MIXED_PRECISION", "False",
           "DATASET.TRAIN_SPLIT", "mini_train",
           "DATASET.VAL_SPLIT", "mini_val", "TRAIN.BATCH_SIZE", "1",
           "TEST.BATCH_SIZE", "1", "TRAIN.EPOCHS", "1",
           "TRAIN.VAL_INTERVALS", "1", "TRAIN.WARM_EPOCHS", "0",
           "MODEL.FREEZE_BACKBONE", "True", "MODEL.DEFREEZE", "0",
           "WORKERS", "0"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-4000:])
    runs = sorted(glob.glob(str(out / "ddp" / "*")))
    assert len(runs) == 1, runs  # one run directory for both ranks
    run = runs[0]
    assert sorted(os.listdir(os.path.join(run, "ckpts"))) == [
        "model_0.pt", "model_last.pt"]
    assert os.path.exists(os.path.join(run, "config.json"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    # rank 0's events alone: one train/* record and one val/* record
    train = [e for e in events if any(k.startswith("train/") for k in e)]
    val = [e for e in events if "val/total" in e]
    assert len(train) == 1 and len(val) == 1, events
    log1 = os.path.join(run, "train.rank1.log")
    assert os.path.exists(os.path.join(run, "train.log"))
    assert os.path.exists(log1)
    with open(os.path.join(run, "train.log")) as f:
        assert "param census" in f.read()
    ckpt = torch.load(os.path.join(run, "ckpts", "model_last.pt"),
                      weights_only=False)
    assert not [k for k in ckpt["state_dict"] if k.startswith("module.")]
