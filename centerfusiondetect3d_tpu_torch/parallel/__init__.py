"""Data parallelism over processes (``torch.distributed``): the port of
``centerfusiondetect3d_tpu/parallel``."""

from .distributed import (
    all_gather_detections,
    initialize,
    is_main_process,
    is_multiprocess,
    launched,
    rank,
    shutdown,
    world_size,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    Mesh,
    gather_detections,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "gather_detections",
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "initialize",
    "is_main_process",
    "is_multiprocess",
    "launched",
    "rank",
    "shutdown",
    "world_size",
    "all_gather_detections",
]
