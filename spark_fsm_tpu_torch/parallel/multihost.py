"""Multi-process wiring over ``torch.distributed`` — port of
``spark_fsm_tpu/parallel/multihost.py``.

The reference's multi-controller model: every process runs the SAME
program and the sequence-axis collectives span them; host-side
orchestration stays SPMD, each process running the identical DFS on
identical (all-reduced) supports, so no other cross-process messaging is
needed.  Here one process drives one rank, and
:func:`init_distributed` wires it into the world.

The rendezvous comes from the arguments or from torch's own environment
names (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as a
launcher such as torchrun sets them.  The backend is explicit: ``"nccl"``
for CUDA ranks, ``"gloo"`` for CPU ranks, or whatever the caller names.
A backend that fails to start raises: NCCL is never retried on gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: DeviceLike = None,
                     timeout_s: float = 600.0) -> None:
    """Wire this process into the default world (idempotent: a world
    already initialized, by this function or by a launcher, is kept).

    ``init_method`` defaults to ``tcp://$MASTER_ADDR:$MASTER_PORT``;
    ``world_size`` and ``rank`` default to ``$WORLD_SIZE`` and ``$RANK``.
    ``backend`` defaults to ``"nccl"`` when ``device`` (default: CUDA)
    is a CUDA device and ``"gloo"`` for the CPU.  A CUDA rank's device is
    made current before the world starts, as NCCL needs."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError(
                "init_distributed: pass init_method= or set MASTER_ADDR "
                "and MASTER_PORT")
        init_method = f"tcp://{addr}:{port}"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    import datetime

    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_multihost(mesh) -> bool:
    """True when ``mesh`` spans more than one process.  Every rank of a
    :class:`~parallel.mesh.SeqMesh` is its own process, so that is a mesh
    of more than one rank."""
    return mesh is not None and mesh.size > 1


def host_to_device(mesh, x) -> torch.Tensor:
    """Host array -> tensor on the mesh's device.  Every rank holds an
    identical host copy (SPMD), so this is a plain upload."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)
