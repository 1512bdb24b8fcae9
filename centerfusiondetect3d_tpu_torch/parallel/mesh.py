"""The data-parallel layout: one rank per device, each feeding its own
batch shard.

The port of ``centerfusiondetect3d_tpu/parallel/mesh.py``. The JAX package
builds a ``(data, spatial, model)`` device mesh and lets XLA's SPMD
partitioner place the batch; the port's layout is the data axis alone, one
process per device over the default process group
(``parallel/distributed.py``): ``n_data`` is the world size, each rank
loads its strided shard of the index stream (``data/pipeline.py:Loader``
with ``shard=(rank, world)``) and ``shard_batch`` puts it on the rank's
device. ``TPU.MESH_DATA``, ``TPU.MESH_MODEL`` and ``TPU.MESH_SPATIAL`` keep
their meaning: a model or spatial axis wider than 1 (tensor-parallel head
towers, height sharding with a halo for the DCN operator) is not ported
yet (``ROADMAP.md``, Queue 1) and raises.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist

from .distributed import all_gather_detections, local_device, rank, world_size

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    """This rank's place in the data-parallel layout."""
    shape: Dict[str, int]
    rank: int
    device: torch.device


def make_mesh(n_data: int = -1, n_model: int = 1, n_spatial: int = 1,
              device=None) -> Mesh:
    """The (data, spatial, model) layout: ``n_data`` -1 or the world size,
    the other axes 1; ``device`` this rank's (the CUDA card unless given;
    ``cuda`` means ``cuda:LOCAL_RANK`` under NCCL)."""
    if int(n_model) > 1 or int(n_spatial) > 1:
        raise NotImplementedError(
            f"make_mesh: n_model={n_model}, n_spatial={n_spatial}: tensor "
            "and spatial sharding are not ported yet (ROADMAP.md, Queue 1: "
            "tensor-parallel head towers and spatial sharding)")
    world = world_size()
    n_data = world if int(n_data) == -1 else int(n_data)
    if n_data != world:
        raise ValueError(f"TPU.MESH_DATA={n_data} must be -1 or the world "
                         f"size {world} (one rank per device)")
    return Mesh({DATA_AXIS: n_data, SPATIAL_AXIS: 1, MODEL_AXIS: 1}, rank(),
                local_device(device))


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The rank's local batch (its Loader shard) on the rank's device, laid
    out as ``data/pipeline.py:to_device`` lays it."""
    from ..data.pipeline import to_device

    return to_device(batch, mesh.device)


def replicate(module_or_state: Any, mesh: Mesh) -> Any:
    """Rank 0's parameters and buffers (a module) or tensors (a dict) on
    every rank, broadcast in place; returns its argument."""
    if mesh.shape[DATA_AXIS] == 1:
        return module_or_state
    if isinstance(module_or_state, torch.nn.Module):
        tensors = list(module_or_state.state_dict().values())
    else:
        tensors = list(module_or_state.values())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0)
    return module_or_state


def gather_detections(detections: Dict[str, Any]) -> Dict[str, Any]:
    """The fixed-size detection tensors of every rank on the host, in
    batch (rank) order."""
    return all_gather_detections(detections)
