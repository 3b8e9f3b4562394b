"""Sequence-axis meshes over ``torch.distributed`` — port of
``spark_fsm_tpu/parallel/mesh.py``.

The framework's parallel axis is the sequence-id axis of the vertical
bitmap store: joins are elementwise over sequences, so the only
communication is a SUM of the per-shard partial supports before each
global minsup prune.  The reference runs one program over a device mesh
(``shard_map`` + ``jax.lax.psum``); the port runs one process per rank
(SPMD: every rank runs the same host loop), and :func:`all_reduce_sum`
takes the place of the ``psum``.  After it every rank holds the same
supports, so every host loop takes the same branches.

- :class:`SeqMesh` holds the process group, this process's rank, the
  world size and the rank's explicit ``torch.device``.
- :func:`shard_bounds` is the rank's contiguous block of the (padded)
  sequence axis, as the reference's ``store_sharding`` splits it.
- ``mesh=None`` keeps every single-device path exactly as it is:
  :func:`all_reduce_sum` returns its tensor untouched.

Each mesh counts its collectives (``all_reduces``) and their time: CUDA
events around the call under NCCL (the reduce stays on the stream, no
host sync), the host clock otherwise.  :meth:`SeqMesh.reduce_stats`
reads them.
"""

from __future__ import annotations

import datetime
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.parallel.multihost import world_timeout

SEQ_AXIS = "seq"
# the control group's wait: a service's follower waits for the leader's
# next mesh call as long as the service idles, which can outlast the
# world's timeout; a rank whose process dies closes its connections,
# which ends the wait with an error
CONTROL_TIMEOUT = datetime.timedelta(days=3650)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-int(n) // int(k)) * int(k)


class SeqMesh:
    """A 1-D mesh over the sequence axis: one rank per process.

    ``group`` is an initialized process group (the default world, or any
    ``ProcessGroup``); ``device`` is where this rank's shard lives."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = device
        self.backend = group.name().lower()   # "gloo" or "nccl"
        # n_parts -> each partition row's process group
        # (``partition.submeshes`` makes them once a mesh)
        self.row_groups: dict = {}
        self._control = self._exchange = None
        self.reset_counters()

    def __repr__(self) -> str:
        return (f"SeqMesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")

    def _host_groups(self) -> None:
        """Make the mesh's two gloo groups for host objects, which never
        stage through a card (a rank whose card failed can still join).
        Made at the first call, which every rank of the world makes at
        the same point (``new_group`` is collective over the world)."""
        if self._control is None:
            ranks = dist.get_process_group_ranks(self.group)
            self._control = dist.new_group(ranks, backend="gloo",
                                           timeout=CONTROL_TIMEOUT)
            self._exchange = dist.new_group(ranks, backend="gloo",
                                            timeout=world_timeout())

    def control_group(self):
        """The gloo group of the service's mesh calls
        (``service/meshcall.py``), with ``CONTROL_TIMEOUT``: a follower
        waits on it for the leader's next call."""
        self._host_groups()
        return self._control

    def exchange_group(self):
        """The gloo group of a partitioned mine's exchanges, with the
        world's timeout: a row that never comes to the exchange ends the
        others' wait with an error, not a hang."""
        self._host_groups()
        return self._exchange

    def reset_counters(self) -> None:
        self.all_reduces = 0
        self._host_s = 0.0
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def reduce_stats(self) -> dict:
        """``{"all_reduces": n, "all_reduce_ms": t}`` since the last
        :meth:`reset_counters`.  Under NCCL the time is read from CUDA
        events, so this waits for the last recorded one."""
        ms = 1e3 * self._host_s
        if self._events:
            self._events[-1][1].synchronize()
            ms += sum(a.elapsed_time(b) for a, b in self._events)
        return {"all_reduces": self.all_reduces, "all_reduce_ms": ms}


def make_mesh(n_devices: Optional[int] = None, group=None,
              device: DeviceLike = None) -> SeqMesh:
    """The sequence mesh of ``group`` (default: the initialized default
    world, see ``multihost.init_distributed``; a partition row's group,
    see ``partition.submeshes``) with this rank's shard on ``device``
    (default: the current CUDA device; raises without one).
    ``n_devices``, when given, must equal the group's size."""
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh: torch.distributed is not initialized; call "
                "parallel.multihost.init_distributed() or pass group=")
        group = dist.group.WORLD
    rank, size = group.rank(), group.size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the group "
                         f"has {size} ranks")
    return SeqMesh(group, rank, size, resolve_device(device))


def local_mesh(device: DeviceLike = None) -> SeqMesh:
    """A 1-rank gloo mesh inside this process (an in-memory store, no
    rendezvous and no default world): the mesh path with no other
    process, as the tests drive it."""
    group = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    return SeqMesh(group, 0, 1, resolve_device(device))


def mesh_size(mesh: Optional[SeqMesh]) -> int:
    return 1 if mesh is None else mesh.size


def shard_bounds(n_seq: int, mesh: Optional[SeqMesh]) -> Tuple[int, int]:
    """This rank's contiguous block ``[r*n_seq/N, (r+1)*n_seq/N)`` of a
    sequence axis already padded to a multiple of the mesh size (the
    engines' geometry pads it)."""
    if mesh is None:
        return 0, int(n_seq)
    if n_seq % mesh.size:
        raise ValueError(f"sequence axis {n_seq} is not a multiple of the "
                         f"mesh size {mesh.size}")
    shard = n_seq // mesh.size
    return mesh.rank * shard, (mesh.rank + 1) * shard


def _reduce(t: torch.Tensor, mesh: SeqMesh) -> None:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)


def all_reduce_sum(t: torch.Tensor, mesh: Optional[SeqMesh]) -> torch.Tensor:
    """SUM ``t`` over the mesh in place on its device and return it
    (``jax.lax.psum`` over ``SEQ_AXIS``); ``mesh=None`` returns ``t`` as
    it is.  Under NCCL the reduce is ordered on the current stream and
    makes no host sync."""
    if mesh is None:
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce_sum needs a contiguous tensor")
    mesh.all_reduces += 1
    if t.is_cuda and mesh.backend == "nccl":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        _reduce(t, mesh)
        b.record()
        mesh._events.append((a, b))
    else:
        t0 = time.perf_counter()
        _reduce(t, mesh)
        mesh._host_s += time.perf_counter() - t0
    return t


def rank0_decides(flag: bool, mesh: Optional[SeqMesh]) -> bool:
    """Rank 0's value of a host decision, on every rank: a decision that
    gates a collective (the time-based checkpoint trigger) must be the
    same everywhere, or the ranks' collectives fall out of step.  One
    one-int reduce in which only rank 0 contributes; not counted in the
    support reduces."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag)) if mesh.rank == 0 else 0],
                     dtype=torch.int32, device=mesh.device)
    _reduce(t, mesh)
    return bool(int(t.item()))
