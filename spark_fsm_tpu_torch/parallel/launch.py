"""Start a world of ranks on this machine — the port's counterpart of the
reference's multi-process test worker (``tests/_multihost_worker.py``)
and of a launcher such as torchrun.

:func:`spawn_world` starts ``world_size`` processes with the ``spawn``
start method (the parent may already hold a CUDA context, which a forked
child cannot use), wires them into one ``torch.distributed`` world over
a free localhost port, calls ``target(mesh, *args)`` in every rank and
returns each rank's result in rank order.  Any rank's exception fails the
call with that rank's traceback, and a rank that dies without an answer
fails it too; nothing is swallowed, and every process started is ended
before the call returns.  ``target`` and its arguments and results must
pickle (a module-level function).
"""

from __future__ import annotations

import queue as _queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int):
    """The rank's device: ``"cpu"``; ``"cuda"`` without an index puts rank
    r on card ``r % device_count``; ``"cuda:i"`` puts every rank on card
    i (ranks that share a card)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("rank_device: no CUDA device")
        dev = torch.device("cuda", rank % n)
    return dev


def _rank_main(rank: int, world_size: int, port: int, backend: str,
               device: str, target: Callable, args: tuple, out_q,
               threads: Optional[int]) -> None:
    from spark_fsm_tpu_torch.parallel.mesh import make_mesh
    from spark_fsm_tpu_torch.parallel.multihost import (
        init_distributed, shutdown_distributed)

    try:
        import torch

        if threads:
            torch.set_num_threads(int(threads))
        dev = rank_device(device, rank)
        init_distributed(backend, f"tcp://127.0.0.1:{port}", world_size,
                         rank, dev)
        mesh = make_mesh(device=dev)
        result = target(mesh, *args)
        out_q.put((rank, True, result))
    except Exception:  # the rank's boundary: report to the parent
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown_distributed()
        except Exception:
            pass


def spawn_world(target: Callable, world_size: int, backend: str,
                device: str, args: Sequence = (), *,
                timeout_s: float = 900.0,
                threads: Optional[int] = None) -> List:
    """Run ``target(mesh, *args)`` on every rank of a fresh
    ``world_size``-rank world and return the results in rank order.

    ``backend`` is the caller's choice ("nccl", "gloo"); ``device`` is
    resolved per rank by :func:`rank_device`; ``threads`` caps each
    rank's torch CPU threads (ranks on one host share its cores).
    Raises ``RuntimeError`` when a rank fails, dies or the world
    outlives ``timeout_s``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, int(world_size), port, backend, str(device), target,
              tuple(args), out_q, threads), daemon=True)
        for r in range(int(world_size))]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < len(procs):
            try:
                rank, ok, value = out_q.get(timeout=0.5)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    try:  # an answer still in the pipe names the fault
                        rank, ok, value = out_q.get(timeout=2.0)
                    except _queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world_size} died with exit "
                            f"code {procs[dead[0]].exitcode} before "
                            f"answering") from None
                elif time.monotonic() > deadline:
                    raise RuntimeError(
                        f"world of {world_size} ranks did not finish in "
                        f"{timeout_s} s ({len(results)} answered)")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == len(procs) else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out_q.close()
    return [results[r] for r in range(len(procs))]
