"""Multi-process data parallelism: the process group, the rank's device and
the gather of detections.

The port of ``centerfusiondetect3d_tpu/parallel/distributed.py``. The JAX
package scales over hosts with ``jax.distributed`` and one SPMD program; the
port runs one process per card under ``torch.distributed``, launched by
``python -m torch.distributed.run --nproc_per_node N`` (torchrun), which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. Gradients are averaged by ``DistributedDataParallel``
(``training/state.py``); BatchNorm statistics and loss normalisers are
all-reduced over the ranks (``models/layers.py``, ``losses/primitives.py``),
so a step equals the JAX package's step on the global batch. Validation
detections are fixed-size (B, K, ...) arrays, so the ranks merge them with
one all-gather a batch (the reference's ``torch.distributed.all_gather``,
progressBar.py:85-93).

NCCL takes one card a rank; two ranks on one card run over gloo, which
all-reduces and broadcasts CUDA tensors too (the gather below goes through
host memory under gloo).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

#: what torch.distributed.run sets for each rank
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher (``torch.distributed.run``) started this process:
    ``WORLD_SIZE`` is set."""
    return "WORLD_SIZE" in os.environ


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start the default process group; returns whether one is up.

    Without arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``env://`` rendezvous on
    ``MASTER_ADDR:MASTER_PORT``). A plain single process (no launcher, no
    arguments) gets no group: a no-op, as is a second call. A launched
    single rank does get its group, so that one card runs the NCCL path.
    ``backend`` defaults to NCCL where a card is present and gloo
    elsewhere; NCCL sets this rank's card, ``cuda:LOCAL_RANK``, and refuses
    a rank without a card of its own. A half-configured environment raises:
    a process never trains alone by mistake (the JAX package's guard,
    ``distributed.py:36-43``).
    """
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and rank is None and init_method is None:
        return False  # one process, nothing asked
    if world_size is None or rank is None:
        raise RuntimeError(
            "parallel.initialize: a process group needs both a world size "
            f"and a rank (got world_size={world_size}, rank={rank}); launch "
            "with python -m torch.distributed.run or pass both")
    if not 0 <= rank < world_size:
        raise RuntimeError(f"parallel.initialize: rank {rank} is outside "
                           f"world size {world_size}")
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(
                f"parallel.initialize: {', '.join(missing)} not set and no "
                "init_method given; launch with python -m "
                "torch.distributed.run or pass init_method")
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_nccl_device(rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def shutdown() -> None:
    """End the default process group, where one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _nccl_device(rank: int) -> int:
    """``LOCAL_RANK`` (else the rank); raises where two ranks would share
    a card, which NCCL refuses."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    count = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
    if count == 0:
        raise RuntimeError("parallel.initialize: NCCL needs a CUDA card")
    if local >= count or local_world > count:
        raise RuntimeError(
            f"parallel.initialize: local rank {local} of {local_world} has "
            f"no card of its own ({count} visible); NCCL refuses two ranks "
            "on one card: run that many ranks over gloo (backend='gloo')")
    return local


def world_size() -> int:
    """Ranks of the default group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return rank() == 0


def is_multiprocess() -> bool:
    """More than one rank: where statistics and losses are all-reduced."""
    return world_size() > 1


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, with a CUDA one made
    ``cuda:LOCAL_RANK`` under NCCL (its set device) where it names no
    index."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def collective_device(group=None) -> torch.device:
    """Where a group's tensors must lie for a gather: the card under NCCL,
    host memory under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_detections(detections: Mapping[str, Any], group=None
                          ) -> Dict[str, np.ndarray]:
    """Every rank's (of ``group``, the default one if None) fixed-size
    detection arrays, concatenated on the batch axis in rank order, on
    every rank (rank 0 scores them).

    One process: a host fetch. Several: one all-gather of every array
    packed into one float64 vector (float32 values and integer ids up to
    2^53 round-trip exactly); every rank must hold the same keys, shapes
    and dtypes, as padded shards of fixed-size detections do.
    """
    host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in detections.items()}
    n = dist.get_world_size(group) if world_size() > 1 else 1
    if n == 1:
        return host
    keys = sorted(host)
    flat = np.concatenate([host[k].astype(np.float64).ravel() for k in keys])
    mine = torch.from_numpy(flat).to(collective_device(group))
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    parts = [p.cpu().numpy() for p in parts]
    out = {}
    offset = 0
    for k in keys:
        size = host[k].size
        out[k] = np.concatenate([
            p[offset:offset + size].reshape(host[k].shape).astype(
                host[k].dtype) for p in parts])
        offset += size
    return out
