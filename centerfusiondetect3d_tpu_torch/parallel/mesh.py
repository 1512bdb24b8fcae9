"""The (data, spatial, model) layout: one process a device, a process group
a mesh axis.

The port of ``centerfusiondetect3d_tpu/parallel/mesh.py``. The JAX package
builds a device mesh and lets XLA's SPMD partitioner place the batch,
insert the convolutions' halo exchanges and the tensor-parallel
collectives; the port runs ``n_data * n_spatial * n_model`` processes
(``parallel/distributed.py``), laid out as JAX lays its devices
(``reshape(n_data, n_spatial, n_model)``, model fastest), and writes those
collectives out (``parallel/collectives.py``):

- ``data``: each data rank loads its strided shard of the index stream
  (``data/pipeline.py:Loader`` with ``shard=(data_rank, n_data)``); the
  loss totals over the data group (``losses/primitives.py``);
- ``spatial``: ``shard_batch`` keeps the rank's rows of H of the
  ``SPATIAL_KEYS`` maps; the backbone and the neck run on them with halo
  rows from the neighbouring ranks (``models/layers.py``), each DeformConv
  node gathers its input's rows and writes its own output rows (the DCN
  kernels' row origin, ``ops/dcn.py``), and the stride-4 features are
  gathered whole before the heads (``models/detector.py``), so the heads,
  the frustum, the decode and the loss run on whole maps. BatchNorm totals
  over the data and spatial ranks (``stats`` group). The five stride-2
  reductions need the input height to be a multiple of 32 * n_spatial;
  XLA splits unevenly, the port raises;
- ``model``: ``shard_params_tp`` keeps each rank's output-channel slice of
  the head towers that are ``min_width`` wide or more (JAX's rule), whose
  outputs are all-gathered along C before the next conv.

A layout is active inside ``with layout(mesh):`` (the Trainer's step and
validation, ``tools/dryrun_multichip.py``); outside it a model runs as one
process. ``TPU.MESH_DATA``, ``TPU.MESH_SPATIAL`` and ``TPU.MESH_MODEL`` give
the axes; ``MESH_DATA`` -1 is the rest of the world.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from .collectives import SpatialRows, all_gather, flat_all_reduce
from .distributed import all_gather_detections, local_device, rank, world_size

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)
# the BatchNorm statistics' group: the ranks with this rank's model place
STATS_GROUP = "stats"

#: batch keys that carry (B, C, H, W) maps (NCHW after ``to_device``) and
#: may shard H over 'spatial'
SPATIAL_KEYS = ("image", "pc_hm", "pc_dep", "heatmap0")
# stride of the model's coarsest level: the input height must be a
# multiple of this times n_spatial
SPATIAL_ALIGN = 32


class Placement(NamedTuple):
    """Which dimension of a tensor is split over which mesh axis (the port's
    ``PartitionSpec``); an empty ``split`` is replicated."""
    split: Dict[int, str]


def batch_sharding(mesh=None) -> Placement:
    """Leading (batch) dim split over the data axis."""
    return Placement({0: DATA_AXIS})


def spatial_sharding(mesh=None) -> Placement:
    """(B, C, H, W) maps: batch over 'data', height over 'spatial'."""
    return Placement({0: DATA_AXIS, 2: SPATIAL_AXIS})


def replicated(mesh=None) -> Placement:
    return Placement({})


class Mesh:
    """This rank's place in the layout: ``shape`` (axis -> size),
    ``coords`` (axis -> this rank's index on it), ``rank``, ``device`` and
    ``groups`` (axis, or ``stats`` -> process group; None is the default
    group, which a group spanning the whole world is)."""

    def __init__(self, shape: Dict[str, int], rank: int, device,
                 groups: Optional[Dict[str, Any]] = None):
        self.shape = dict(shape)
        self.rank = int(rank)
        self.device = torch.device(device)
        n_spatial, n_model = shape[SPATIAL_AXIS], shape[MODEL_AXIS]
        self.coords = {DATA_AXIS: rank // (n_spatial * n_model),
                       SPATIAL_AXIS: rank // n_model % n_spatial,
                       MODEL_AXIS: rank % n_model}
        self.groups = dict(groups or {})

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, coords={self.coords}, "
                f"device={self.device})")

    @property
    def world(self) -> int:
        return (self.shape[DATA_AXIS] * self.shape[SPATIAL_AXIS]
                * self.shape[MODEL_AXIS])

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_spatial(self) -> int:
        return self.shape[SPATIAL_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def data_parallel_only(self) -> bool:
        return self.n_spatial == 1 and self.n_model == 1

    def group(self, name: str):
        """The process group of axis ``name`` (or ``stats``)."""
        return self.groups.get(name)

    def size(self, name: str) -> int:
        if name == STATS_GROUP:
            return self.n_data * self.n_spatial
        return self.shape[name]

    def rows(self) -> Optional[SpatialRows]:
        """This rank's rows of a height-sharded map, where H is split."""
        if self.n_spatial == 1:
            return None
        return SpatialRows(self.group(SPATIAL_AXIS), self.coords[SPATIAL_AXIS])


def _members(shape: Dict[str, int], names) -> List[List[int]]:
    """The partition of the ranks into the groups that vary only along the
    axes ``names``."""
    dims = [shape[a] for a in AXES]
    fixed = [a for a in AXES if a not in names]
    out: Dict[tuple, List[int]] = {}
    for r in range(dims[0] * dims[1] * dims[2]):
        c = {DATA_AXIS: r // (dims[1] * dims[2]),
             SPATIAL_AXIS: r // dims[2] % dims[1], MODEL_AXIS: r % dims[2]}
        out.setdefault(tuple(c[a] for a in fixed), []).append(r)
    return list(out.values())


def _groups(shape: Dict[str, int], world: int) -> Dict[str, Any]:
    """One process group an axis (and ``stats``: data x spatial), made on
    every rank in the same order; None where the group is the world (the
    default group) or where there is no process group."""
    groups = {}
    for name, axes in ((DATA_AXIS, (DATA_AXIS,)),
                       (SPATIAL_AXIS, (SPATIAL_AXIS,)),
                       (MODEL_AXIS, (MODEL_AXIS,)),
                       (STATS_GROUP, (DATA_AXIS, SPATIAL_AXIS))):
        members = _members(shape, axes)
        if world == 1 or len(members[0]) == world:
            groups[name] = None
            continue
        groups[name], _ = dist.new_subgroups_by_enumeration(members)
    return groups


def describe(n_data: int, n_spatial: int = 1, n_model: int = 1,
             rank: int = 0, device="cpu") -> Mesh:
    """A layout's description for rank ``rank``, without process groups
    (placements, ``shard_batch`` and ``tp_param_shardings`` read no
    group)."""
    return Mesh({DATA_AXIS: int(n_data), SPATIAL_AXIS: int(n_spatial),
                 MODEL_AXIS: int(n_model)}, rank, device)


def make_mesh(n_data: int = -1, n_model: int = 1, n_spatial: int = 1,
              device=None) -> Mesh:
    """The (data, spatial, model) layout of the process group's ranks:
    ``n_data`` -1 takes the world size over ``n_model * n_spatial``; the
    axes must multiply to the world size. ``device`` is this rank's (the
    CUDA card unless given; ``cuda`` means ``cuda:LOCAL_RANK`` under NCCL).
    Makes the axes' process groups (every rank must call it)."""
    world = world_size()
    n_model, n_spatial = int(n_model), int(n_spatial)
    if n_model < 1 or n_spatial < 1:
        raise ValueError(f"TPU.MESH_MODEL={n_model} and TPU.MESH_SPATIAL="
                         f"{n_spatial} must be at least 1")
    n_data = world // (n_model * n_spatial) if int(n_data) == -1 \
        else int(n_data)
    if n_data < 1 or n_data * n_spatial * n_model != world:
        raise ValueError(
            f"TPU.MESH_DATA={n_data} x MESH_SPATIAL={n_spatial} x "
            f"MESH_MODEL={n_model} must be the world size {world} (one rank "
            "per device; MESH_DATA -1 takes the rest)")
    shape = {DATA_AXIS: n_data, SPATIAL_AXIS: n_spatial, MODEL_AXIS: n_model}
    return Mesh(shape, rank(), local_device(device), _groups(shape, world))


_LAYOUT = contextvars.ContextVar("cfd3d_layout", default=None)


@contextlib.contextmanager
def layout(mesh: Optional[Mesh]):
    """Runs the block under ``mesh``: the model's height-sharded backbone,
    tensor-parallel towers and BatchNorm groups, and the loss's data group
    (None: one process's arithmetic, or the default group's data
    parallelism)."""
    token = _LAYOUT.set(mesh)
    try:
        yield mesh
    finally:
        _LAYOUT.reset(token)


def active_layout() -> Optional[Mesh]:
    return _LAYOUT.get()


_ROWS = contextvars.ContextVar("cfd3d_rows", default=None)


@contextlib.contextmanager
def row_shard(rows: Optional[SpatialRows]):
    """Runs the block on this rank's rows of its maps (``rows``; None:
    whole maps): ``models/layers.py``'s convolutions take halo rows and
    the DeformConv nodes gather their input's rows."""
    token = _ROWS.set(rows)
    try:
        yield rows
    finally:
        _ROWS.reset(token)


def current_rows() -> Optional[SpatialRows]:
    return _ROWS.get()


def check_spatial_height(height: int, n_spatial: int) -> None:
    """The model's five stride-2 reductions keep a height-sharded map
    aligned only where the input height is a multiple of 32 * n_spatial."""
    if n_spatial > 1 and height % (SPATIAL_ALIGN * n_spatial):
        raise ValueError(
            f"TPU.MESH_SPATIAL={n_spatial}: the input height {height} must "
            f"be a multiple of {SPATIAL_ALIGN} x {n_spatial} = "
            f"{SPATIAL_ALIGN * n_spatial} (five stride-2 reductions, an equal "
            "slice of rows a rank at every level)")


def batch_placement(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The placement ``shard_batch`` gives each key of a (nested) device
    batch: ``spatial_sharding`` for a ``SPATIAL_KEYS`` map whose H divides
    the spatial axis (where it is wider than 1), else ``batch_sharding``
    (every rank's batch is its own data shard)."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = batch_placement(value, mesh)
        elif (mesh.n_spatial > 1 and key in SPATIAL_KEYS
              and getattr(value, "ndim", 0) == 4
              and value.shape[2] % mesh.n_spatial == 0):
            out[key] = spatial_sharding(mesh)
        else:
            out[key] = batch_sharding(mesh)
    return out


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The rank's local batch (its Loader shard) on the rank's device,
    laid out as ``data/pipeline.py:to_device`` lays it, with the rank's
    rows of H of each map that ``batch_placement`` splits (the JAX
    package's rule: a map whose H does not divide stays whole)."""
    from ..data.pipeline import to_device

    put = batch if _on_device(batch) else to_device(batch, mesh.device)
    return _rows_of(put, batch_placement(put, mesh), mesh)


def _on_device(batch) -> bool:
    return all(isinstance(v, torch.Tensor) or (isinstance(v, dict)
                                               and _on_device(v))
               for v in batch.values())


def _rows_of(batch, placement, mesh: Mesh):
    out = {}
    for key, value in batch.items():
        where = placement[key]
        if isinstance(value, dict):
            out[key] = _rows_of(value, where, mesh)
        elif SPATIAL_AXIS in where.split.values():
            h = value.shape[2] // mesh.n_spatial
            out[key] = value.narrow(2, mesh.coords[SPATIAL_AXIS] * h,
                                    h).contiguous()
        else:
            out[key] = value
    return out


def whole_rows(t: Optional[torch.Tensor], height: int,
               mesh: Mesh) -> Optional[torch.Tensor]:
    """A (B, C, H, W) map of whole height ``height``: ``t`` itself where it
    is whole, its rows gathered where it is this rank's slice."""
    if t is None or t.shape[2] == height:
        return t
    if t.shape[2] * mesh.n_spatial != height:
        raise ValueError(f"a map of {t.shape[2]} rows is neither whole "
                         f"({height}) nor a rank's slice of it")
    return mesh.rows().gather(t)


def replicate(module_or_state: Any, mesh: Mesh) -> Any:
    """Rank 0's parameters and buffers (a module) or tensors (a dict) on
    every rank, broadcast in place; returns its argument."""
    if mesh.world == 1:
        return module_or_state
    if isinstance(module_or_state, torch.nn.Module):
        tensors = list(module_or_state.state_dict().values())
    else:
        tensors = list(module_or_state.values())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0)
    return module_or_state


# ------------------------------------------------- tensor-parallel towers


def _tp_convs(model, mesh: Mesh, min_width: int):
    """(module name, conv) of every conv under ``detectHead_0`` whose
    output channels are at least ``min_width`` and divide the model axis
    (JAX's rule on a kernel's last dimension, its output channels)."""
    from ..models.layers import Conv2d

    if mesh.n_model <= 1:
        return []
    out = []
    for name, m in model.named_modules():
        if (name.split(".")[0] == "detectHead_0" and isinstance(m, Conv2d)
                and m.out_channels >= min_width
                and m.out_channels % mesh.n_model == 0):
            out.append((name, m))
    return out


def tp_param_shardings(model, mesh: Mesh, min_width: int = 256
                       ) -> List[str]:
    """Tensor-parallel placement: the names of the parameters whose output
    channels split over the 'model' axis (weight and bias of each wide head
    tower conv); everything else replicates."""
    return [f"{name}.{leaf}" for name, conv in _tp_convs(model, mesh,
                                                        min_width)
            for leaf in ("weight", "bias") if getattr(conv, leaf) is not None]


def shard_params_tp(model, mesh: Mesh, min_width: int = 256) -> List[str]:
    """Keeps this rank's output-channel slice of each parameter that
    ``tp_param_shardings`` names (rank m of the model axis: channels
    [m * C/n, (m+1) * C/n)), marks its conv tensor-parallel and returns the
    names. Make the optimizer afterwards."""
    names = tp_param_shardings(model, mesh, min_width)
    m, n = mesh.coords[MODEL_AXIS], mesh.n_model
    for _, conv in _tp_convs(model, mesh, min_width):
        k = conv.out_channels // n
        with torch.no_grad():
            for leaf in ("weight", "bias"):
                p = getattr(conv, leaf)
                if p is not None:
                    setattr(conv, leaf, torch.nn.Parameter(
                        p[m * k:(m + 1) * k].clone(),
                        requires_grad=p.requires_grad))
        conv.tp_shards = n
    return names


def tp_parameters(model) -> set:
    """The ids of the tensor-parallel (sharded) parameters of ``model``."""
    return {id(p) for m in model.modules() if getattr(m, "tp_shards", 1) > 1
            for p in m.parameters(recurse=False)}


def unshard_state_dict(model, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict with every tensor-parallel slice gathered
    whole over the model axis (every rank of it must call it)."""
    sharded = {f"{name}.{leaf}" for name, m in model.named_modules()
               if getattr(m, "tp_shards", 1) > 1
               for leaf in ("weight", "bias")}
    out = {}
    for key, value in model.state_dict().items():
        if key in sharded:
            value = torch.cat(all_gather(value, mesh.group(MODEL_AXIS)), 0)
        out[key] = value.detach().clone()
    return out


def reduce_gradients(model, mesh: Mesh) -> None:
    """The applied gradient from each rank's backward
    (``parallel/collectives.py``): a replicated parameter's gradient summed
    over the world, a tensor-parallel slice's over the ranks that hold it
    (the data x spatial group), each divided by the world size."""
    if mesh.world == 1:
        return
    tp = tp_parameters(model)
    grads = [(id(p) in tp, p.grad) for p in model.parameters()
             if p.grad is not None]
    scale = 1.0 / mesh.world
    flat_all_reduce([g for s, g in grads if not s], None, scale)
    flat_all_reduce([g for s, g in grads if s], mesh.group(STATS_GROUP),
                    scale)


def gradient_norm(model, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global norm of the applied gradient: the replicated parameters'
    and every model rank's tensor-parallel slices'."""
    tp = tp_parameters(model) if mesh is not None else set()
    norms = [torch.linalg.vector_norm(p.grad) for p in model.parameters()
             if p.grad is not None and id(p) not in tp]
    total = torch.linalg.vector_norm(torch.stack(norms))
    shard = [torch.linalg.vector_norm(p.grad).square()
             for p in model.parameters() if p.grad is not None
             and id(p) in tp]
    if not shard:
        return total
    part = torch.stack(shard).sum().reshape(1)
    flat_all_reduce([part], mesh.group(MODEL_AXIS), 1.0)
    return (total.square() + part[0]).sqrt()


def gather_detections(detections: Dict[str, Any],
                      mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The fixed-size detection tensors of every data rank on the host, in
    batch (rank) order (the ranks of one data group hold the same ones)."""
    group = mesh.group(DATA_AXIS) if mesh is not None else None
    return all_gather_detections(detections, group=group)
