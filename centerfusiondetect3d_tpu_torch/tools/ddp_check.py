"""One rank of a multi-process check: train steps, sharded validation and
the detection gather, run from a spec file, with the results written out.

    python -m centerfusiondetect3d_tpu_torch.tools.ddp_check --spec SPEC.pt
        --rank R --world N --init-method file:///tmp/store
        [--backend gloo|nccl] --out OUT.pt

Each of the N processes joins the process group (``parallel.initialize``)
and runs the spec's cases in order; rank R writes ``OUT.pt`` (``{out}``
with ``{rank}`` filled in where present). ``SPEC.pt`` (``torch.save``) holds:

- ``device``: every rank's device (``cuda:0`` for two gloo ranks on one
  card);
- ``dtype``: ``float64`` to run the model in float64, else None (a val
  case's own ``dtype`` overrides it);
- ``state_dict``: reference-named weights every case starts from;
- ``steps``: cases ``{"opts", "frozen", "accum", "lr"}`` run on ``batch``,
  the global numpy batch: data rank d takes its part of every global
  microbatch (``rank_rows``), so that the ranks step together on the global
  batch; each case writes the step's metrics, its gradients, the state_dict
  after it, the kernels' launches and its ms (``first_ms``, host clock); with ``checkpoint`` set rank 0 also
  writes the Trainer's checkpoint into that directory; then ``timed_steps``
  more steps are timed (``step_ms``). Where ``opts`` set ``TPU.MESH_SPATIAL``
  or ``TPU.MESH_MODEL``, the ranks take their rows through ``shard_batch``
  and step under the layout; with ``tp`` the head towers are split first
  (``shard_params_tp``), and the gradients and state_dict are written whole;
  a case's own ``dtype``, ``state_dict`` and ``batch`` override the spec's;
- ``val``: cases ``{"opts", "dataset", "output_dir"}``, ``Trainer.val`` of
  ``dataset``: ``{"kind": "synthetic", "n", "seed", "meta"}`` (a
  ``SyntheticValSet``) or ``{"kind": "nuscenes", "split"}`` (the config's
  ``DATASET.ROOT``); each writes the results dict and the summaries;
- ``gather``: rank-numbered detections through
  ``parallel.all_gather_detections`` and ``is_main_process``;
- ``batchnorm``: ``BatchNorm2d`` in train mode on the rank's rows of a
  global ``x``, forward and backward (``run_batchnorm``);
- ``forward``: cases ``{"opts", "tp"}``, the model's eval forward on the
  data rank's rows of ``batch`` under the Trainer's layout; each writes the
  outputs (whole maps) and the kernels' launches;
- ``dcn_node``: ``{"layout", "x", "grad", "state_dict"}``, a
  ``DeformConvNode`` in eval mode on the rank's rows of the global ``x``
  under the layout (data, spatial, model), forward and backward
  (``run_dcn_node``);
- ``digests``: ranks other than 0 write each step's gradients and
  state_dict as SHA-256 digests of their bytes (``digest``), rank 0 both
  (a model's float64 tensors a rank are hundreds of MB).

``chip_smoke.py`` (phase 20) and ``tests/test_torch_distributed.py`` run it
and compare what the ranks write with one process.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import parallel
from ..config import load_config
from ..data.pipeline import to_device
from ..parallel import mesh as layouts
from ..parallel.collectives import flat_all_reduce
from ..ops import dcn
from ..runtime.fit import Trainer
from ..runtime.synthetic import SyntheticTrainingSet
from ..training import make_optimizer, train_step

KERNELS = {"dcn_fwd": dcn.deform_conv2d, "dcn_fwd_bf16": dcn.dcn_fwd_bf16,
           **{k.__name__: k for k in (dcn.dcn_im2col, dcn.dcn_col2im,
                                      dcn.dcn_col2im_coord,
                                      dcn.dcn_im2col_bf16,
                                      dcn.dcn_col2im_bf16,
                                      dcn.dcn_col2im_coord_bf16)}}


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


class SyntheticValSet:
    """``n`` items of ``SyntheticTrainingSet`` for validation, with the
    ``meta`` of a nuScenes item (``img_id`` = the index, the centre and
    scale of the input frame) or, with ``meta`` False, without it; with
    ``float64`` their floating arrays in float64."""

    def __init__(self, config, n: int, seed: int = 0, meta: bool = True,
                 float64: bool = False):
        self.items = SyntheticTrainingSet(config, n, seed)
        self.meta = bool(meta)
        self.float64 = bool(float64)
        self.default_resolution = tuple(config.MODEL.INPUT_SIZE)

    def __len__(self):
        return len(self.items)

    def get_item(self, index: int, rng=None):
        item = self.items.get_item(index)
        if self.float64:
            item = _float64(item)
        if self.meta:
            h, w = self.default_resolution
            item["meta"] = {"img_id": np.int64(index),
                            "center": np.array([w / 2, h / 2], np.float32),
                            "scale": np.float32(max(h, w))}
        return item


def _float64(tree):
    return {k: _float64(v) if isinstance(v, dict) else (
        np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v)
        for k, v in tree.items()}


def rank_rows(n_rows: int, world: int, rank: int, accum: int) -> List[int]:
    """The rows of a global batch of ``n_rows`` that ``rank`` steps on:
    its share of each of the ``accum`` global microbatches (microbatch m
    is rows ``m * n_rows / accum`` on, split between the ranks in rank
    order), as the JAX package's step splits the global batch."""
    micro = n_rows // accum
    share = micro // world
    return [m * micro + rank * share + i
            for m in range(accum) for i in range(share)]


def _take(batch, rows):
    return {k: _take(v, rows) if isinstance(v, dict) else np.asarray(v)[rows]
            for k, v in batch.items()}


def _trainer(spec, opts, dtype=None, tp=False):
    cfg = load_config(opts=opts, num_classes=10)
    trainer = Trainer(cfg, device=spec["device"])
    if dtype == "float64":
        trainer.model.double()
    trainer.init_state(state_dict=spec["state_dict"])
    if tp:
        layouts.shard_params_tp(trainer.model, trainer.mesh)
        trainer.optimizer = make_optimizer(cfg, trainer.model)
    return trainer


def _local_batch(spec, trainer, accum: int):
    """(rows, device batch) of this rank: its data rank's rows of every
    global microbatch, through ``shard_batch`` under a layout."""
    mesh = trainer.mesh
    rows = rank_rows(len(spec["batch"]["image"]), mesh.n_data,
                     mesh.coords[layouts.DATA_AXIS], accum)
    batch = to_device(_take(spec["batch"], rows), trainer.device)
    if trainer._layout() is not None:
        batch = layouts.shard_batch(batch, trainer.mesh)
    return rows, batch


def _case_spec(spec, case):
    """The spec with a case's own ``dtype``, ``state_dict`` and ``batch``."""
    return {**spec, **{k: case[k] for k in ("dtype", "state_dict", "batch")
                       if k in case}}


def run_step(spec, case) -> dict:
    spec = _case_spec(spec, case)
    trainer = _trainer(spec, case["opts"], spec.get("dtype"),
                       case.get("tp", False))
    frozen, accum = bool(case["frozen"]), int(case["accum"])
    rows, batch = _local_batch(spec, trainer, accum)
    model = trainer._step_model(frozen)
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_step(model, trainer.optimizer, trainer.loss_fn, batch,
                         case["lr"], frozen, accum, trainer._layout())
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    first_ms = 1e3 * (time.perf_counter() - t0)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "launches": launches(), "rows": rows, "first_ms": first_ms,
           "grads": gradients(trainer.model, trainer.mesh),
           "state_dict": whole_state_dict(trainer.model, trainer.mesh)}
    if case.get("checkpoint"):
        trainer.config.defrost()
        trainer.config.OUTPUT_DIR = case["checkpoint"]
        out["checkpoint"] = trainer._save(0)
    out["step_ms"] = time_steps(model, trainer, batch, case, frozen, accum)
    return out


def gradients(model, mesh=None) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient after a step (the applied one: after
    DDP's average or ``reduce_gradients``), on the host, by reference name;
    a tensor-parallel slice's gathered whole over the model axis."""
    from ..parallel.collectives import all_gather

    tp = layouts.tp_parameters(model)
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if id(p) in tp:
            g = torch.cat(all_gather(g, mesh.group(layouts.MODEL_AXIS)), 0)
        out[n] = g.cpu().clone()
    return out


def digest(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """SHA-256 of each tensor's dtype, shape and bytes."""
    import hashlib

    return {k: hashlib.sha256(
        f"{v.dtype}{tuple(v.shape)}".encode()
        + v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    ).hexdigest() for k, v in tensors.items()}


def whole_state_dict(model, mesh) -> Dict[str, torch.Tensor]:
    """The state_dict on the host, tensor-parallel slices gathered whole."""
    return {k: v.cpu() for k, v in
            layouts.unshard_state_dict(model, mesh).items()}


def run_forward(spec, case) -> dict:
    """The eval forward of the data rank's rows under the layout."""
    trainer = _trainer(spec, case["opts"], spec.get("dtype"),
                       case.get("tp", False))
    _, batch = _local_batch(spec, trainer, 1)
    trainer.model.eval()
    reset_launches()
    with torch.no_grad(), layouts.layout(trainer._layout()):
        y = trainer.model(batch["image"], batch.get("pc_dep"),
                          batch.get("calib"))
    return {"outputs": {k: v.detach().cpu() for k, v in y.items()},
            "image_rows": int(batch["image"].shape[2]),
            "launches": launches()}


def time_steps(model, trainer, batch, case, frozen: bool, accum: int):
    """ms of each of ``case["timed_steps"]`` more steps on the same batch
    (host clock, the device synchronised after each)."""
    times = []
    for _ in range(int(case.get("timed_steps", 0))):
        t0 = time.perf_counter()
        train_step(model, trainer.optimizer, trainer.loss_fn, batch,
                   case["lr"], frozen, accum, trainer._layout())
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def run_val(spec, case) -> dict:
    opts = list(case["opts"]) + ["OUTPUT_DIR", repr(case["output_dir"])]
    dtype = case.get("dtype", spec.get("dtype"))
    trainer = _trainer(spec, opts, dtype)
    ds = case["dataset"]
    if ds["kind"] == "synthetic":
        trainer.dataset_val = SyntheticValSet(
            trainer.config, ds["n"], ds.get("seed", 0), ds.get("meta", True),
            dtype == "float64")
    else:
        from ..data.dataset import NuScenesDataset

        trainer.dataset_val = NuScenesDataset(trainer.config, ds["split"],
                                              device=trainer.device)
    reset_launches()
    results = trainer.val()
    return {"results": results, "summaries": trainer.summaries,
            "launches": launches()}


def run_batchnorm(case) -> dict:
    """``models/layers.py:BatchNorm2d`` in train mode on this rank's rows
    of ``x`` (N, C, H, W) with the given parameters and statistics, then
    the backward of ``<grad, y>``."""
    from ..models.layers import BatchNorm2d

    rows = rank_rows(len(case["x"]), parallel.world_size(), parallel.rank(),
                     1)
    x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
    bn = BatchNorm2d(x.shape[1]).to(x.dtype).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(case[name]))
    y = bn(x)
    (y * torch.from_numpy(case["grad"][rows])).sum().backward()
    return {"rows": rows, "y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def run_dcn_node(case, device) -> dict:
    """A ``DeformConvNode`` (eval mode, the weights of
    ``case["state_dict"]``) on this rank's rows of ``x`` (B, C, H, W) under
    the layout ``case["layout"]`` (every data rank takes the whole batch):
    its output rows, then the backward of ``<grad, y>`` summed over the
    spatial ranks, so that the parameters' gradients (summed over the
    spatial group) and the input rows' gradient are the whole node's."""
    from ..models.layers import DeformConvNode

    n_data, n_spatial, n_model = case["layout"]
    mesh = parallel.make_mesh(n_data, n_model, n_spatial, device)
    x, grad = (torch.from_numpy(case[k]) for k in ("x", "grad"))
    node = DeformConvNode(x.shape[1], grad.shape[1]).to(x.dtype)
    node.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case["state_dict"].items()})
    node.to(device).eval()
    h = x.shape[2] // n_spatial
    row0 = mesh.coords[layouts.SPATIAL_AXIS] * h
    local = x.narrow(2, row0, h).to(device).requires_grad_(True)
    reset_launches()
    with layouts.layout(mesh), layouts.row_shard(mesh.rows()):
        y = node(local)
        (y * grad.narrow(2, row0, h).to(device)).sum().backward()
    params = dict(node.named_parameters())
    if n_spatial > 1:
        flat_all_reduce([p.grad for p in params.values()],
                        mesh.group(layouts.SPATIAL_AXIS), 1.0)
    return {"row0": row0, "y": y.detach().cpu(), "x_grad": local.grad.cpu(),
            "grads": {k: p.grad.cpu() for k, p in params.items()},
            "launches": launches()}


def run_gather() -> dict:
    rank = parallel.rank()
    local = {"scores": torch.full((2, 3), float(rank)),
             "ids": torch.arange(3) + 10 * rank}
    out = parallel.all_gather_detections(local)
    return {"gathered": out, "main": parallel.is_main_process()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    spec = torch.load(args.spec, weights_only=False)
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(args.init_method, args.world, args.rank, args.backend)
    try:
        out = {"rank": parallel.rank(), "world": parallel.world_size(),
               "backend": torch.distributed.get_backend(),
               "steps": [run_step(spec, c) for c in spec.get("steps", [])],
               "val": [run_val(spec, c) for c in spec.get("val", [])]}
        if spec.get("gather"):
            out["gather"] = run_gather()
        if spec.get("batchnorm"):
            out["batchnorm"] = run_batchnorm(spec["batchnorm"])
        out["forward"] = [run_forward(spec, c)
                          for c in spec.get("forward", [])]
        if spec.get("dcn_node"):
            out["dcn_node"] = run_dcn_node(spec["dcn_node"], device)
        if spec.get("digests"):
            for step in out["steps"]:
                for key in ("grads", "state_dict"):
                    step[f"{key}_digest"] = digest(step[key])
                    if args.rank:
                        del step[key]
        torch.save(out, args.out.format(rank=args.rank))
        torch.distributed.barrier()  # every rank has written
    except BaseException:
        parallel.shutdown()
        raise
    print(f"ddp_check rank {args.rank}: ok", flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    # leave without the process group's teardown at exit: a rank whose peer
    # had already gone aborted there once ("terminate called without an
    # active exception") after writing all it had to
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
