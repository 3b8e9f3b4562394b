"""Per-job deadlines and cancellation — the admission layer's abort seam.

A train job used to be unstoppable once submitted: no deadline, no
cancel, and a worker burning device time on a job whose client gave up
long ago.  This module is the process-global registry of LIVE jobs
(one :class:`JobControl` per submitted uid, registered by
``Miner.submit`` and released on every terminal status) carrying the
two abort signals:

- **deadline**: stamped at submit as an absolute monotonic instant
  (``now + deadline_s``), so time spent WAITING in the admission queue
  spends the budget exactly like time spent mining;
- **cancelled**: flipped by ``POST /admin/cancel/{uid}`` (or
  :func:`cancel`) at any point of the job's life.

The signals are enforced at the engines' existing safe points — the
spots between device launches where the dispatch watchdog and the OOM
degradation ladder already live (models/tsr.py pipeline loop,
models/spade_queue.py segment loop) plus the Miner's own step
boundaries — via :func:`check`, which raises :class:`JobCancelled` /
:class:`JobDeadlineExceeded` (both :class:`JobAborted`).  Job
supervision treats a JobAborted as TERMINAL: no retry, a durable
``failure`` status whose error text leads with ``CANCELLED`` /
``DEADLINE_EXCEEDED``, and a trace event in the flight recorder.

Cost contract (the same pin as utils/faults and the flight recorder):
with no deadline set and no cancel pending anywhere in the process,
:func:`check` is ONE module-global read — scripts/bench_smoke.sh's
byte-identical dispatch counters hold.  The current job rides a
contextvar (set by ``Miner._loop`` around the run), so engine code
calls :func:`check` with zero plumbing, exactly like obs spans.

Port: a copy of ``spark_fsm_tpu/utils/jobctl.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
On a service's world of ranks (one process a rank) only the leader holds
the jobs, so the engines' safe points call :func:`check_shared`: every
rank takes rank 0's verdict and leaves the mine at the same launch
boundary, where a rank left in a collective would wait out the world's
timeout.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Optional

from spark_fsm_tpu_torch.utils import obs

_CANCELLED_TOTAL = obs.REGISTRY.counter(
    "fsm_jobs_cancelled_total",
    "jobs aborted by /admin/cancel (queued or mid-mine)")
_DEADLINE_TOTAL = obs.REGISTRY.counter(
    "fsm_jobs_deadline_exceeded_total",
    "jobs aborted because their deadline_s budget ran out")
_LEASE_LOST_TOTAL = obs.REGISTRY.counter(
    "fsm_jobs_lease_lost_total",
    "jobs self-fenced because their replica lease expired or was "
    "superseded (service/lease.py)")


class JobAborted(RuntimeError):
    """Base of the two abort signals.  TERMINAL for supervision: the
    Miner records a durable failure instead of retrying (a retry would
    just re-spend a budget the client already exhausted)."""

    code = "ABORTED"

    def __init__(self, uid: str, detail: str):
        self.uid = uid
        super().__init__(f"{self.code}: job {uid!r} {detail}")


class JobCancelled(JobAborted):
    code = "CANCELLED"


class JobDeadlineExceeded(JobAborted):
    code = "DEADLINE_EXCEEDED"


class JobLeaseLost(JobAborted):
    """The multi-replica fence signal (service/lease.py): this replica's
    lease on the job expired or was superseded by a peer, so continuing
    to mine — and above all continuing to WRITE — risks double-commit
    against the adopting replica's run.  Terminal like every JobAborted;
    the failure-settling path additionally refuses the store writes when
    the lease is confirmed superseded."""

    code = "LEASE_LOST"


class RankAborted(JobAborted):
    """A follower rank's side of an abort that its leader decided at a
    shared safe point (:func:`check_shared`)."""


class JobControl:
    """The live-job record.  ``cancelled`` is a plain bool flipped under
    the module lock and read lock-free at check sites (a stale read
    costs one extra launch, never a missed abort — the next check sees
    it)."""

    __slots__ = ("uid", "deadline", "cancelled", "running", "priority",
                 "lease_lost", "submitted_t", "started_t", "dataset_fp",
                 "follower_of", "stalled", "tenant", "ephemeral", "usage")

    def __init__(self, uid: str, deadline: Optional[float],
                 priority: str = "normal"):
        self.uid = uid
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.cancelled = False
        self.running = False  # False = still queued (set by activate())
        # result-reuse tier (service/resultcache.py): the content-
        # addressed fingerprint of the job's resolved dataset, stamped
        # once at dataset load (None until then / when the tier is off)
        self.dataset_fp: Optional[str] = None
        # follower linkage: set to the leader uid when this entry is a
        # coalesced follower awaiting fan-out instead of a queued job —
        # its deadline/cancel signals are honored at fan-out time
        self.follower_of: Optional[str] = None
        # admission class ("high"/"normal"/"low") — read by the fusion
        # broker's window rule (a high job's waves never wait for fill)
        self.priority = priority
        # flipped by the lease heartbeat (service/lease.py) when this
        # replica can no longer prove it owns the job — same read
        # discipline as ``cancelled``: lock-free at check sites, a stale
        # read costs one extra launch, never a missed fence
        self.lease_lost = False
        # store-outage stall (service/storeguard.py): while True, the
        # job PAUSES at its next safe point (frontier kept in memory)
        # instead of raising — cleared by the guard on store return, or
        # superseded by ``lease_lost`` when the outage ends badly
        self.stalled = False
        # multi-tenant identity (service/fairness.py): the admission
        # tenant, stamped at submit — the fsm_job_*_seconds tenant label
        self.tenant = "default"
        # storeguard ephemeral admission: True marks a loudly-flagged
        # NO-JOURNAL job admitted during a store outage — its durable
        # writes ride the spool ungated (no lease, no journal intent)
        self.ephemeral = False
        # usage metering (service/usage.py): the live per-job device-
        # cost accumulator, attached by the meter's first deposit —
        # None when the plane is off or nothing was dispatched yet
        self.usage = None
        # SLO accounting stamps (service/obsplane.py): submit instant
        # and FIRST worker pickup — e2e = terminal - submitted_t,
        # queue wait = started_t - submitted_t (retries re-activate but
        # keep the first pickup; the client waited once)
        self.submitted_t = time.monotonic()
        self.started_t: Optional[float] = None


_lock = threading.Lock()
_jobs: Dict[str, JobControl] = {}
# Fast-path flag: True only while some live job carries a deadline or a
# pending cancel — check() returns on this one global read otherwise.
_active = False

# the job whose worker thread this is (None on handler/stream threads)
_cur: contextvars.ContextVar[Optional[JobControl]] = contextvars.ContextVar(
    "fsm_jobctl", default=None)


def _recompute_active_locked() -> None:
    global _active
    _active = any(c.deadline is not None or c.cancelled or c.lease_lost
                  or c.stalled for c in _jobs.values())


def register(uid: str, deadline_s: Optional[float] = None,
             priority: str = "normal") -> JobControl:
    """Register a submitted job; the deadline budget starts NOW (queue
    wait spends it).  Re-registering a uid replaces the old entry — the
    admission layer's 409 conflict check guarantees the old incarnation
    is dead by then."""
    ctl = JobControl(uid, None if deadline_s is None
                     else time.monotonic() + float(deadline_s),
                     priority=priority)
    with _lock:
        _jobs[uid] = ctl
        _recompute_active_locked()
    return ctl


def release(uid: str) -> None:
    """Drop a job's entry on ANY terminal status (idempotent)."""
    with _lock:
        _jobs.pop(uid, None)
        _recompute_active_locked()


def release_entry(ctl: Optional[JobControl]) -> None:
    """Drop a job's entry ONLY if the registry still maps its uid to
    THIS control object.  The victim side of a work steal must use
    this: in a multi-replica-in-one-process topology the thief's
    re-register has replaced the uid's entry, and a release-by-uid from
    the victim would strip the thief's live job of its deadline/cancel/
    fence signals."""
    if ctl is None:
        return
    with _lock:
        if _jobs.get(ctl.uid) is ctl:
            _jobs.pop(ctl.uid, None)
            _recompute_active_locked()


def get(uid: str) -> Optional[JobControl]:
    with _lock:
        return _jobs.get(uid)


def cancel(uid: str) -> Optional[str]:
    """Request cancellation of a live job.  Returns ``"running"`` /
    ``"queued"`` (what the job was doing when flagged) or None when no
    live job owns the uid (unknown, or already terminal) — the 404
    case.  The abort lands at the job's next safe point."""
    global _active
    with _lock:
        ctl = _jobs.get(uid)
        if ctl is None:
            return None
        ctl.cancelled = True
        _active = True
        return "running" if ctl.running else "queued"


# stalled job threads wait here; the storeguard notifies on every
# unstall so a healed outage resumes jobs within one wait quantum
_stall_cond = threading.Condition()


def stall_entry(ctl: Optional[JobControl]) -> None:
    """Flip a job's outage-stall flag (service/storeguard.py calls this
    on the control OBJECT captured at lease-attach time): the job
    PAUSES at its next safe point — frontier kept in memory — until
    :func:`unstall_entry` or a fence/cancel/deadline supersedes."""
    global _active
    if ctl is None:
        return
    with _lock:
        ctl.stalled = True
        _active = True


def unstall_entry(ctl: Optional[JobControl]) -> None:
    """Release a stalled job (store returned, or the guard fenced it —
    in the fenced case ``lease_lost`` is already set and the woken
    check raises terminal LEASE_LOST instead of resuming)."""
    if ctl is None:
        return
    with _lock:
        ctl.stalled = False
        _recompute_active_locked()
    with _stall_cond:
        _stall_cond.notify_all()


def fence_lost(ctl: Optional[JobControl]) -> None:
    """Flip a job's lease-lost flag (lease heartbeat / fence checks call
    this on the CONTROL OBJECT they captured at attach time, never by
    uid lookup: in multi-replica-in-one-process tests two miners may
    register the same uid, and the flag must land on the incarnation
    that actually lost its lease)."""
    global _active
    if ctl is None:
        return
    with _lock:
        ctl.lease_lost = True
        _active = True


def live_count() -> int:
    with _lock:
        return len(_jobs)


@contextlib.contextmanager
def activate(ctl: Optional[JobControl]):
    """Bind ``ctl`` as the current job for this thread/context (the
    Miner wraps each run in this), so engine-level :func:`check` calls
    see it with no plumbing."""
    if ctl is None:
        yield
        return
    ctl.running = True
    if ctl.started_t is None:
        ctl.started_t = time.monotonic()
    token = _cur.set(ctl)
    try:
        yield
    finally:
        _cur.reset(token)


def check_entry(ctl: Optional[JobControl]) -> None:
    """Raise the abort owed by ``ctl``, if any — or BLOCK while the
    job is outage-stalled (service/storeguard.py): the safe point the
    abort signals land on doubles as the pause point a store outage
    parks the job at, frontier kept in memory.  Cancel, deadline and
    fence signals are re-checked every wait quantum, so a stall never
    shadows an abort the client is owed.  Used directly by the Miner on
    dequeue (the queued-job path, where no context is bound)."""
    if ctl is None:
        return
    while ctl.stalled:
        _check_signals(ctl)
        with _stall_cond:
            if ctl.stalled:  # re-check under the condition: an unstall
                _stall_cond.wait(0.05)  # between the reads must not
                # strand this thread for a full quantum more than once
    _check_signals(ctl)


def _check_signals(ctl: JobControl) -> None:
    if ctl.cancelled:
        _CANCELLED_TOTAL.inc()
        obs.trace_event("job_cancelled", uid=ctl.uid)
        raise JobCancelled(ctl.uid, "cancelled via /admin/cancel")
    if ctl.lease_lost:
        _LEASE_LOST_TOTAL.inc()
        obs.trace_event("job_lease_lost", uid=ctl.uid)
        raise JobLeaseLost(
            ctl.uid, "lost its replica lease (expired or superseded); "
                     "self-fencing instead of risking a double-commit")
    if ctl.deadline is not None and time.monotonic() > ctl.deadline:
        _DEADLINE_TOTAL.inc()
        obs.trace_event("job_deadline_exceeded", uid=ctl.uid)
        raise JobDeadlineExceeded(
            ctl.uid, "outran its deadline_s budget (includes queue wait)")


def check() -> None:
    """The engine-side safe-point probe: one module-global read when no
    deadline/cancel exists anywhere; otherwise consult the current
    job's entry and raise its abort."""
    if not _active:
        return
    check_entry(_cur.get())


_shared = False


def share_with_ranks() -> None:
    """Turn on the shared safe points of :func:`check_shared` (every rank
    of a service's world, at boot)."""
    global _shared
    _shared = True


def check_shared(mesh=None) -> None:
    """:func:`check` at a safe point that every rank of ``mesh`` reaches
    together.  On a service's world rank 0's verdict is every rank's (a
    one-int reduce, ``parallel.mesh.rank0_decides``), and a rank that owes
    no abort of its own raises :class:`RankAborted`; elsewhere, or without
    a mesh, it is :func:`check`."""
    if not _shared or mesh is None:
        check()
        return
    from spark_fsm_tpu_torch.parallel.mesh import rank0_decides

    owed = None
    try:
        check()
    except JobAborted as exc:
        owed = exc
    if rank0_decides(owed is not None, mesh):
        raise owed if owed is not None else RankAborted(
            "", "aborted by rank 0 of the mesh")


def current() -> Optional[JobControl]:
    """The job bound to this thread/context (None outside a mine run) —
    how the fusion broker learns a wave's uid and admission class with
    zero engine plumbing."""
    return _cur.get()
