"""Boot the service on a world of ranks, one process a rank.

The reference's service is one controller over a device mesh
(``[engine] mesh_devices``, and with ``[distributed]`` one controller a
host).  The port's mesh is a ``torch.distributed`` world, one process a
rank (``parallel/mesh.py``), so a meshed boot starts the world first:

- ``[engine] mesh_devices = N`` on one host: ``app.main`` is rank 0 and
  starts ranks 1 .. N-1 on this host (the ``spawn`` start method: this
  process may hold a CUDA context, which a forked child cannot use),
  over a free localhost port;
- ``[distributed] enabled``: every host runs ``app.main`` as rank
  ``process_id`` of ``num_processes``, with ``coordinator_address`` as
  the rendezvous (or torch's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
  and ``MASTER_PORT``).

Each rank's device comes from the boot's ``--device`` as
``parallel.launch.rank_device`` resolves it (``cuda``: rank r on card
r % cards; ``cuda:i``: every rank on card i; ``cpu``).  The backend is
NCCL where each rank has a card of its own, and gloo otherwise (ranks
that share a card, or CPU ranks).  Rank 0 leads: it boots the HTTP
server, the Master and the Miner.  The other ranks follow
(``service/meshcall.follow``): they bind no port, replay the leader's
mesh calls and leave when the leader stops.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from spark_fsm_tpu_torch import config as cfgmod
from spark_fsm_tpu_torch.config import ConfigError


@dataclasses.dataclass(frozen=True)
class World:
    """Where this process stands in the service's world."""

    size: int
    rank: int
    init_method: str   # the rendezvous, ``tcp://host:port``
    backend: str       # "nccl" or "gloo"
    device: str        # the boot's device, resolved per rank


def plan(cfg: cfgmod.Config, device: Optional[str]) -> Optional[World]:
    """The world ``cfg`` asks for, or None for a one-process boot.
    ``ConfigError`` for a combination that cannot form a world."""
    from spark_fsm_tpu_torch.parallel.launch import free_port

    n = cfg.engine.mesh_devices
    d = cfg.distributed
    device = device or "cuda"
    if d.enabled:
        size = d.num_processes or _env_int("WORLD_SIZE")
        rank = d.process_id if d.process_id is not None else _env_int("RANK")
        addr = d.coordinator_address or (
            f"{os.environ.get('MASTER_ADDR', '')}:"
            f"{os.environ.get('MASTER_PORT', '')}")
        if addr.startswith(":") or addr.endswith(":"):
            raise ConfigError(
                "[distributed] needs coordinator_address or MASTER_ADDR "
                "and MASTER_PORT")
        if n not in (0, size):
            raise ConfigError(
                f"engine.mesh_devices = {n} cannot form the world of "
                f"{size} processes (one process a rank)")
        if not 0 <= rank < size:
            raise ConfigError(f"rank {rank} is not a rank of a world of "
                              f"{size}")
        return World(size, rank, f"tcp://{addr}", _backend(device, size,
                                                           True), device)
    if n <= 0:
        return None
    return World(n, 0, f"tcp://127.0.0.1:{free_port()}",
                 _backend(device, n, False), device)


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ConfigError(f"[distributed] needs its field or ${name}")
    return int(value)


def _backend(device: str, size: int, one_per_host: bool) -> str:
    """NCCL where each rank has a card of its own, gloo otherwise."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    if one_per_host:
        return "nccl"
    own = dev.index is None and torch.cuda.device_count() >= size
    return "nccl" if own else "gloo"


def _join(cfg: cfgmod.Config, world: World, rank: int) -> None:
    """Wire this process in as ``rank``: its device, the world, the mesh
    calls and the shared safe points."""
    from spark_fsm_tpu_torch.parallel.launch import rank_device
    from spark_fsm_tpu_torch.parallel.multihost import init_distributed
    from spark_fsm_tpu_torch.service import meshcall, plugins
    from spark_fsm_tpu_torch.utils import jobctl

    dev = plugins.set_device(rank_device(world.device, rank))
    init_distributed(world.backend, world.init_method, world.size, rank,
                     dev)
    jobctl.share_with_ranks()
    meshcall.start(cfgmod.get_mesh(), leader=rank == 0)


def lead(cfg: cfgmod.Config, world: World) -> Callable[[], None]:
    """Rank 0: start this host's other ranks (one-host worlds), join the
    world and lead its mesh calls.  Returns the teardown: the followers
    leave, the world ends and every process started is joined."""
    import multiprocessing as mp

    procs = []
    if not cfg.distributed.enabled:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_follower, args=(cfg, world, r),
                             daemon=True, name=f"fsm-rank-{r}")
                 for r in range(1, world.size)]
        for p in procs:
            p.start()
    try:
        _join(cfg, world, world.rank)
    except BaseException:
        _end(procs)
        raise

    def stop() -> None:
        from spark_fsm_tpu_torch.parallel.multihost import \
            shutdown_distributed
        from spark_fsm_tpu_torch.service import meshcall

        try:
            meshcall.stop()
            shutdown_distributed()
        finally:
            _end(procs)

    return stop


def _end(procs) -> None:
    for p in procs:
        p.join(timeout=30)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def follow(cfg: cfgmod.Config, world: World, rank: int) -> None:
    """A follower rank: join the world and replay the leader's mesh calls
    until it stops.  The meshguard is installed as the leader's Miner
    installs it, so a partitioned mine's rows agree on health."""
    from spark_fsm_tpu_torch.parallel.multihost import shutdown_distributed
    from spark_fsm_tpu_torch.service import meshcall, meshguard

    _join(cfg, world, rank)
    if cfg.meshguard.enabled:
        meshguard.install(cfg.meshguard)
    try:
        meshcall.follow()
    finally:
        shutdown_distributed()


def _follower(cfg: cfgmod.Config, world: World, rank: int) -> None:
    """The spawned process of a one-host world's follower rank."""
    from spark_fsm_tpu_torch.utils.jitcache import enable_compile_cache

    cfgmod.set_config(cfg)
    enable_compile_cache()
    follow(cfg, world, rank)
