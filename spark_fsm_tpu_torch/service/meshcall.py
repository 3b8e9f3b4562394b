"""Mesh calls: the service on a world of ranks, one process a rank.

The reference's service is one controller over a device mesh.  The
port's mesh is a world of ranks, one process each
(``service/launch.py`` starts it), so every rank must make the same
collectives in the same order.  Rank 0 leads: it serves HTTP and runs
the Master, the Miner, the result store and cache, leases and
``/predict``.  The other ranks follow: they bind no port and replay every
call of the leader's that reaches the mesh.

A mesh-bound call goes through :func:`call` on the leader, which
broadcasts a small descriptor (what to run: the plugin and the request's
data with its database, or the stream push, or the prewarm spec) over
the mesh's gloo control group (``SeqMesh.control_group``, whose timeout
outlasts an idle spell) and then runs the call itself; a follower
in :func:`follow` receives it, runs the same call with its own rank's
mesh and drops the result.  One lock on the leader keeps the calls in
broadcast order: two jobs of ``[service] miner_workers > 1`` would
otherwise interleave their collectives differently on different ranks.
A call made inside another on the same thread (a plugin under a stream
push) is part of the outer one and broadcasts nothing.

The mesh-bound calls are the device plugins' ``extract`` (the engine
caches' builds happen inside it), the incremental stream miner's pushes
(a topic's miner is made on a follower at its first push, refilled as
the leader's restored window was) and ``prewarm.run``.  The leader's
job-control checks are shared with the ranks
(``utils/jobctl.check_shared``), so a cancel or a deadline ends a mine
on every rank at the same launch boundary.  Without a world
:func:`call` just calls.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, Dict, Optional

from spark_fsm_tpu_torch.utils.obs import log_event

_lock = threading.Lock()
_local = threading.local()
_mesh = None        # this rank's mesh while the service runs on a world
_leader = False
_devices: list = []
_streams: Dict[str, object] = {}   # a follower's stream miners, by topic
_REPLAY: Dict[str, Callable[[dict], None]] = {}


def start(mesh, leader: bool) -> None:
    """Serve on ``mesh``'s world: ``leader`` for rank 0.  Every rank
    calls it at boot, together (it gathers the ranks' devices)."""
    global _mesh, _leader, _devices
    import torch.distributed as dist

    devices: list = [None] * mesh.size
    dist.all_gather_object(devices, str(mesh.device),
                           group=mesh.control_group())
    _mesh, _leader, _devices = mesh, bool(leader), devices


def active() -> bool:
    """True while the service runs on a world of ranks."""
    return _mesh is not None


def devices() -> list:
    """Each rank's device, in rank order (empty off a world)."""
    return list(_devices)


def _broadcast(desc: Optional[tuple]):
    import torch.distributed as dist

    box = [desc]
    dist.broadcast_object_list(box, src=0, group=_mesh.control_group())
    return box[0]


def call(op: str, payload: dict, fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` as mesh call ``op``: on a world's
    leader, after broadcasting ``(op, payload)`` to the followers, under
    the one lock; otherwise, or inside another mesh call, as it is."""
    if not _leader or getattr(_local, "inside", False):
        return fn(*args, **kwargs)
    with _lock:
        _broadcast((op, payload))
        _local.inside = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.inside = False


def stop() -> None:
    """The leader's last call: every follower leaves :func:`follow`."""
    global _mesh, _leader, _devices
    if _leader:
        with _lock:
            _broadcast(None)
    _mesh, _leader, _devices = None, False, []


def follow() -> None:
    """A follower's loop: replay each mesh call the leader broadcasts,
    until :func:`stop`.  A replay that raises is logged and dropped (the
    leader's own call raises the same error, or a shared job-control
    check ended the mine on every rank)."""
    while True:
        desc = _broadcast(None)
        if desc is None:
            return
        op, payload = desc
        _local.inside = True
        try:
            _REPLAY[op](payload)
        except Exception:  # the follower's boundary: it must keep serving
            log_event("mesh_call_failed", op=op,
                      error=traceback.format_exc(limit=4))
        finally:
            _local.inside = False


# ------------------------------------------------------------ the calls


class _Pinned:
    """A checkpoint whose ``load`` answers one state read up front, so the
    leader's engine resumes from exactly the state its followers get;
    ``save`` (``None`` on a follower: saves are the leader's) and
    ``every_s`` are the job's."""

    def __init__(self, state, every_s: float, save=None):
        self._state, self.every_s, self._save = state, every_s, save

    def load(self):
        return self._state

    def save(self, state) -> None:
        if self._save is not None:
            self._save(state)


def extract(fn: Callable, req, db, stats=None, checkpoint=None):
    """Device plugin ``fn``'s extract as a mesh call: the followers mine
    the same request over the same database, and resume the same
    checkpointed frontier (their snapshot triggers are rank 0's)."""
    if not _leader or getattr(_local, "inside", False):
        return fn(req, db, stats, checkpoint=checkpoint)
    ckpt = None
    if checkpoint is not None:
        checkpoint = _Pinned(checkpoint.load(),
                             getattr(checkpoint, "every_s", 30.0),
                             checkpoint.save)
        ckpt = (checkpoint.load(), checkpoint.every_s)
    # the database travels parsed; an INLINE request's text stays here
    data = {k: v for k, v in req.data.items() if k != "sequences"}
    payload = {"plugin": fn.__name__, "service": req.service,
               "task": req.task, "data": data, "db": db,
               "checkpoint": ckpt}
    return call("extract", payload, fn, req, db, stats,
                checkpoint=checkpoint)


def _replay_extract(p: dict) -> None:
    from spark_fsm_tpu_torch.service import plugins
    from spark_fsm_tpu_torch.service.model import ServiceRequest

    ckpt = None if p["checkpoint"] is None else _Pinned(*p["checkpoint"])
    getattr(plugins, p["plugin"])(
        ServiceRequest(p["service"], p["task"], p["data"]), p["db"], {},
        checkpoint=ckpt)


def stream_push(topic: str, miner, text: str, batch, make: dict,
                refill: list):
    """An incremental stream miner's push of ``batch`` (SPMF ``text``) as
    a mesh call.  ``make`` holds the miner's arguments and ``refill`` the
    restored window's batch texts, for a follower that has no miner for
    the topic yet."""
    return call("stream", {"topic": topic, "text": text, "make": make,
                           "refill": refill}, miner.push, batch)


def _replay_stream(p: dict) -> None:
    from spark_fsm_tpu_torch import config
    from spark_fsm_tpu_torch.data.spmf import parse_spmf
    from spark_fsm_tpu_torch.service import plugins
    from spark_fsm_tpu_torch.streaming.incremental import \
        IncrementalWindowMiner

    miner = _streams.get(p["topic"])
    if miner is None:
        miner = IncrementalWindowMiner(
            device=plugins.service_device(), mesh=config.get_mesh(),
            **p["make"])
        for text in p["refill"]:
            miner.window.push(parse_spmf(text))
        _streams[p["topic"]] = miner
    miner.push(parse_spmf(p["text"]))


def prewarm(spec, engine_kwargs: dict):
    """``prewarm.run`` on the service's mesh and device, as a mesh call."""
    return call("prewarm", {"spec": spec, "engine_kwargs": engine_kwargs},
                _prewarm, spec, engine_kwargs)


def _prewarm(spec, engine_kwargs: dict):
    from spark_fsm_tpu_torch import config
    from spark_fsm_tpu_torch.service import plugins, prewarm as PW

    return PW.run(spec, mesh=config.get_mesh(), engine_kwargs=engine_kwargs,
                  device=plugins.service_device())


_REPLAY.update({
    "extract": _replay_extract,
    "stream": _replay_stream,
    "prewarm": lambda p: _prewarm(p["spec"], p["engine_kwargs"]),
})
