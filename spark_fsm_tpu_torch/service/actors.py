"""Actor-style orchestration — the reference's L5 without Akka.

``FSMMaster`` routes ``ServiceRequest``s to workers (SURVEY.md sec 1 L5,
sec 3 call stacks): miner (train), questor (get), tracker (track),
registrar (register/index), status.  Here the master is a plain router;
the miner runs jobs on a worker thread (the mailbox is a queue — the
actor model's useful property, serialized mutation, without a JVM), and
supervision = per-job exception capture into the ``failure`` status, the
reference's error contract.

Port: a copy of ``spark_fsm_tpu/service/actors.py`` with its imports
pointed at ``spark_fsm_tpu_torch``; the stream miners and the predictor
run on the service's device (``plugins.service_device()``).  On a world
of ranks an incremental stream's push is a mesh call
(``service/meshcall.py``), as the device plugins' mines are.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
import traceback
import uuid
from typing import Dict, List, Optional

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.service import (autoscale, fairness, integrity, lease,
                                   meshcall, meshguard, model, obsplane,
                                   planner, plugins, predictor, resultcache,
                                   sources, storeguard, usage)
from spark_fsm_tpu_torch.service.model import ServiceRequest, ServiceResponse, Status
from spark_fsm_tpu_torch.service.store import ResultStore
from spark_fsm_tpu_torch.utils import envelope, faults, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event, profile_trace
from spark_fsm_tpu_torch.utils.retry import RetryPolicy


def _sink_results(store: ResultStore, uid: str, kind: str, results,
                  guard=None, gate=None) -> None:
    """Persist a mine's output under ``uid`` — the single result sink used
    by batch train jobs and stream pushes alike.  With a storeguard the
    write rides the guard (spooled during a store outage, replayed under
    the fencing gate on reconnect)."""
    if kind == "patterns":
        key, payload = f"fsm:pattern:{uid}", model.serialize_patterns(results)
    else:
        key, payload = f"fsm:rule:{uid}", model.serialize_rules(results)
    if guard is None:
        store.set(key, payload)
    else:
        guard.set(uid, key, payload, gate=gate)


def _record_failure(store: ResultStore, uid: str, exc: Exception,
                    metric: str = "jobs_failed",
                    keep_frontier: bool = False,
                    lease_mgr: Optional[lease.LeaseManager] = None,
                    rescache=None, guard=None) -> None:
    """The supervision contract: error text + traceback under the error
    key, status -> failure (SURVEY.md sec 5 failure-detection row).
    ``metric`` keeps batch-job and stream-push failure counters distinct
    (jobs_failed must never exceed jobs_submitted).  ``keep_frontier``
    preserves the checkpoint keys for failures that do NOT implicate the
    mine itself (deadline/cancel aborts, shutdown drain, a recovery
    resubmit that shed): the persisted progress stays resumable by a
    later checkpointed resubmit instead of being destroyed by an abort
    the job never asked for.

    With a lease manager, the durable write is FENCED: a replica whose
    lease on ``uid`` was superseded (the adopting peer owns the uid's
    keys now) records nothing in the store — its failure stays local
    (log + counters) instead of clobbering the adopter's run.  The
    settle check is one atomic NX reacquire when the lease merely
    expired unclaimed, so the no-adopter case still lands its durable
    failure."""
    if lease_mgr is not None and not lease_mgr.settle_for_failure(uid):
        # release OUR control object by identity: the adopter (possibly
        # in this very process, in test topologies) may have
        # re-registered the uid and its live entry must keep its
        # deadline/cancel/fence signals
        ctl = lease_mgr.attached_ctl(uid)
        lease_mgr.forget(uid)
        jobctl.release_entry(ctl)
        # the fenced epoch's buffered spans must not reach the adopter's
        # spine either: tombstone first, then drain the buffer through
        # the (now refusing) flush so the rejection is COUNTED
        obsplane.mark_fenced(uid)
        log_event("job_failed_fenced", uid=uid, error=str(exc))
        with obs.span("job.failed_fenced", trace_id=uid, error=str(exc)):
            pass
        obs.flush_trace(uid)
        if rescache is not None:
            # the adopter finishes the job elsewhere — coalesced
            # followers waiting HERE re-dispatch as cold mines
            rescache.on_leader_terminal(uid)
        # fenced: the adopter owns the uid's attribution from its
        # checkpoint-adopted snapshot — dropping (not settling) our
        # stale accumulator is what keeps the ledger single-billed
        usage.drop(uid)
        return
    try:
        if guard is None:
            store.set(f"fsm:error:{uid}", f"{exc}\n{traceback.format_exc()}")
            store.add_status(uid, Status.FAILURE)
            store.incr(f"fsm:metric:{metric}")
            if not keep_frontier:
                # a job that FAILED mid-mine after its retries leaves a
                # frontier of unknown quality — drop it, don't leak it
                store.delete(f"fsm:frontier:{uid}")
                store.delete(f"fsm:frontier:results:{uid}")
            # failure is TERMINAL: the journal intent is settled (the
            # restart recovery pass must not resurrect a job that
            # failed durably)
            store.journal_clear(uid)
        else:
            # storeguard route: spooled during an outage, replayed
            # under the fencing gate on reconnect — a store blip no
            # longer turns "record the failure" into a dead worker
            guard.set(uid, f"fsm:error:{uid}",
                      f"{exc}\n{traceback.format_exc()}")
            guard.status(uid, Status.FAILURE)
            guard.incr(uid, f"fsm:metric:{metric}")
            if not keep_frontier:
                guard.delete(uid, f"fsm:frontier:{uid}")
                guard.delete(uid, f"fsm:frontier:results:{uid}")
            guard.delete(uid, f"fsm:journal:{uid}")
    except Exception as wexc:
        # the store failed while recording the failure: the journal
        # intent survives, so recovery settles the uid after the store
        # returns — log loudly instead of killing the worker thread
        log_event("job_failure_record_failed", uid=uid, error=str(wexc))
    # failed or not, the device work already happened — settle it into
    # the tenant rollup so the ledger conserves against the dispatch
    # counters (a failure is not a refund)
    usage.settle(uid)
    # the job-control entry is released regardless (stream uids have
    # neither journal nor entry — no-ops)
    jobctl.release(uid)
    log_event("job_failed", uid=uid, error=str(exc))
    # stamp the terminal failure into the job's flight-recorder ring
    # (explicit trace_id: failures land from threads with no active
    # trace context — the drain path, the submit-after-shutdown path),
    # then flush the spine BEFORE releasing the lease so the final
    # chunk still rides the fenced write path
    with obs.span("job.failed", trace_id=uid, error=str(exc)):
        pass
    obs.lifecycle(uid, "settled", outcome="failure",
                  code=getattr(exc, "code", type(exc).__name__))
    obs.flush_trace(uid)
    if lease_mgr is not None:
        lease_mgr.release(uid)
    if rescache is not None:
        # a leader's abort is its client's decision, not the followers':
        # re-dispatch any coalesced followers through normal admission
        rescache.on_leader_terminal(uid)


def _profile_dir(req: ServiceRequest, uid: str) -> str:
    """Trace dir for this job, or "" (no profiling).

    ``profile`` request param: a path = trace there; any other truthy
    value = trace under the boot config's ``profile_dir`` (required then).
    """
    value = req.param("profile")
    if value is None or value.lower() in ("", "0", "false", "no", "off"):
        return ""
    if "/" in value or value.startswith("."):
        return value
    root = config.get_config().profile_dir
    if not root:
        raise ValueError(
            "profile=1 requested but no profile_dir configured at boot "
            "(set profile_dir in the config file, or pass profile=<path>)")
    return os.path.join(root, uid)


class StoreCheckpoint:
    """Frontier checkpoint persisted in the result store — the optional
    long-mine half of SURVEY.md sec 5's checkpoint row (results-at-job-end
    remain the primary contract).  The engine fingerprints each snapshot,
    so a retry against changed data safely restarts fresh instead of
    resuming garbage.

    Two keys: ``fsm:frontier:{uid}`` holds the frontier snapshot,
    ``fsm:frontier:results:{uid}`` is an APPEND-ONLY list of result-delta
    chunks — each save writes only the patterns found since the previous
    one, so checkpoint cost tracks the frontier, not the full output.

    A ``results_done=0`` save (a fresh mine's first snapshot, or EVERY
    snapshot of a full-rewrite engine like TSR, whose accepted set shrinks
    as minsup rises) embeds its results INSIDE the meta value instead: one
    atomic SET.  A delete-list-then-rewrite scheme would reintroduce the
    torn-snapshot hazard the count check cannot catch — consecutive top-k
    rewrites routinely have the SAME length, so an old meta paired with a
    newer list would pass ``results_total`` and resume duplicated rules.

    Failure posture (the chaos-suite contract): every store verb runs
    under the shared bounded-backoff RetryPolicy (utils/retry.py, site
    ``store.checkpoint``), so a transient store hiccup never fails a
    save; ``save`` works on a SHALLOW COPY of the caller's state dict,
    so a save that dies mid-way leaves the engine's state intact and a
    retried save writes the correct ``results_total``; and ``load``
    HEALS a kill between the delta ``rpush`` and the meta ``set`` — the
    meta names the last GOOD snapshot, trailing chunks newer than it
    (including a retried rpush that had actually landed) are trimmed
    away, and only a list that cannot be reconciled at a chunk boundary
    is refused outright."""

    def __init__(self, store: ResultStore, uid: str,
                 every_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 lease_mgr: Optional[lease.LeaseManager] = None,
                 guard=None) -> None:
        self.store, self.uid, self.every_s = store, uid, every_s
        self._meta_key = f"fsm:frontier:{uid}"
        self._results_key = f"fsm:frontier:results:{uid}"
        self._inline: list = []  # results_done=0 part of the loaded snapshot
        self._retry = retry if retry is not None else RetryPolicy(seed=0)
        # multi-replica fence: every save re-proves lease ownership
        # BEFORE writing — a stale holder's snapshot must never land
        # over the adopting replica's (service/lease.py)
        self._lease = lease_mgr
        # store-outage guard (service/storeguard.py): saves during a
        # proven outage spool instead of failing the job; None = the
        # pre-guard posture at one `is None` read per save
        self._guard = guard

    def _io(self, fn, *args):
        return self._retry.run(fn, *args, site="store.checkpoint")

    def load(self) -> Optional[dict]:
        raw = self._io(self.store.get, self._meta_key)
        if not raw:
            return None
        meta_payload, verdict = integrity.open_value(raw, "checkpoint")
        if verdict == "corrupt":
            # corrupt META: the snapshot's identity itself is
            # unverifiable — quarantine the bytes for the post-mortem
            # and restart the mine fresh, LOUDLY
            integrity.quarantine(self.store, self._meta_key, raw,
                                 "checkpoint", move=True)
            self._io(self.store.delete, self._results_key)
            log_event("frontier_checkpoint_corrupt_meta", uid=self.uid)
            return None
        state = json.loads(meta_payload)
        inline = state.pop("results_inline", [])
        total = state.pop("results_total", -1)
        chunks = self._io(self.store.lrange, self._results_key)
        results = list(inline)
        used = 0
        # (embedded snapshot state, chunks kept, results at that point)
        # for the corrupt-delta heal: every enveloped chunk embeds the
        # frontier state as of its OWN save, so a later chunk's
        # corruption truncates back to here instead of restarting
        last_good = None
        for chunk in chunks:
            if len(results) == total:
                break  # later chunks postdate this meta (torn tail)
            payload, cv = integrity.open_value(chunk, "checkpoint")
            delta, emb = None, None
            if cv != "corrupt":
                try:
                    obj = json.loads(payload)
                except ValueError:
                    obj = None
                if (isinstance(obj, dict)
                        and isinstance(obj.get("delta"), list)):
                    delta, emb = obj["delta"], obj.get("state")
                elif isinstance(obj, list):
                    delta = obj  # legacy chunk: bare delta, no state
            if delta is None:
                return self._heal_corrupt_delta(chunk, inline, results,
                                                used, last_good)
            results.extend(delta)
            used += 1
            if (isinstance(emb, dict)
                    and emb.get("results_total") == len(results)):
                last_good = (emb, used, len(results))
        if len(results) != total:
            return None  # torn snapshot (killed mid-save): refuse to resume
        if used < len(chunks):
            # a save died between its delta rpush and its meta set: the
            # meta is the LAST GOOD snapshot and the trailing chunks are
            # orphans — trim them so resumed append-mode saves stay
            # consistent with results_total (leaving them would corrupt
            # the NEXT load: a fresh delta lands after the orphan)
            self._io(self.store.ltrim, self._results_key, used)
            log_event("frontier_checkpoint_healed", uid=self.uid,
                      trimmed_chunks=len(chunks) - used)
        # append-mode saves after this resume must re-embed the inline part
        # (their meta overwrites the one that carried it)
        self._inline = inline
        state["results"] = results
        return self._adopt_usage(state)

    def _adopt_usage(self, state: Optional[dict]) -> Optional[dict]:
        """Strip the checkpoint's usage snapshot (the engine's resume
        contract knows nothing of it) and hand it to the meter —
        REPLACING any live accumulator for the uid."""
        if state is not None:
            snap = state.pop("usage", None)
            if snap:
                usage.resume(self.uid, snap)
        return state

    def _heal_corrupt_delta(self, bad_chunk, inline, results, used,
                            last_good) -> Optional[dict]:
        """A delta chunk INSIDE the used prefix failed verification: the
        meta's snapshot is unreachable, but every enveloped chunk embeds
        the frontier state as of its own save — so truncate the list to
        the last good embedded snapshot, rewrite the meta to it, and
        RESUME from there: the corruption costs only the work mined
        after that chunk.  With no embedded predecessor (first chunk
        corrupt, or a legacy pre-envelope prefix) the snapshot is
        unreconstructable — quarantine and restart fresh, loudly."""
        integrity.quarantine(self.store, f"{self._results_key}#{used}",
                             bad_chunk, "checkpoint")
        if last_good is None:
            self._io(self.store.delete, self._meta_key)
            self._io(self.store.delete, self._results_key)
            log_event("frontier_checkpoint_corrupt_restart", uid=self.uid)
            return None
        emb, keep, n = last_good
        self._io(self.store.ltrim, self._results_key, keep)
        meta = dict(emb)  # embedded state carries results_total already
        meta["results_inline"] = inline
        self._io(self.store.set, self._meta_key,
                 envelope.wrap(json.dumps(meta)))
        log_event("frontier_checkpoint_corrupt_delta_healed",
                  uid=self.uid, kept_chunks=keep, results=n)
        self._inline = inline
        state = dict(emb)
        state.pop("results_total", None)
        state["results"] = results[:n]
        return self._adopt_usage(state)

    def save(self, state: dict) -> None:
        with obs.span("checkpoint.save", trace_id=self.uid):
            self._save(state)
        # a successful save is a durable milestone: mark it and flush
        # the trace spine so a kill -9 loses at most the spans since
        # the last checkpoint — exactly the window the frontier itself
        # bounds (the replica_smoke failover timeline reads off this)
        obs.lifecycle(self.uid, "checkpointed")
        obs.flush_trace(self.uid)

    def _save(self, state: dict) -> None:
        g = self._guard
        outage = g is not None and g.skip_fence(self.uid)
        if self._lease is not None and not outage:
            # during a PROVEN outage the fence is deferred to the
            # spool's replay gate (the journal-gated NX reacquire) —
            # verifying against an unreachable store here
            # would just fence a job the outage semantics say may stall
            self._lease.fence(self.uid)  # raises JobLeaseLost when stale
        faults.fault_site("checkpoint.save", uid=self.uid)
        # NON-DESTRUCTIVE: pop from a shallow copy, never the caller's
        # dict — a store failure mid-save must leave the engine's state
        # whole so a retried save recomputes the same results_total
        state = dict(state)
        delta = state.pop("results")
        done = state.pop("results_done")
        # usage-attribution snapshot (service/usage.py): rides the meta
        # AND every delta chunk's embedded state, so an adopter resumes
        # the job's device-cost accumulator from wherever load() lands —
        # resume REPLACES, so re-mined work never double-bills
        snap = usage.checkpoint_snapshot(self.uid)
        if snap is not None:
            state["usage"] = snap
        if outage:
            self._save_spooled(g, state, delta, done)
            return
        try:
            self._save_direct(state, delta, done)
        except Exception as exc:
            # a transport failure the guard's probe confirms as an
            # outage converts the save into a spool append mid-flight
            # (an ack-lost rpush that actually landed would make the
            # chunk list non-reconcilable — load() REFUSES such a list
            # and the mine restarts fresh: slower, never corrupt)
            if g is None or not g.note_error(exc):
                raise
            self._save_spooled(g, state, delta, done)

    def _save_direct(self, state: dict, delta, done: int) -> None:
        if done == 0:
            # single atomic meta SET; the chunk list (possibly stale from a
            # crashed earlier incarnation) is dropped
            self._io(self.store.delete, self._results_key)
            self._inline = delta
            state["results_total"] = len(delta)
        else:
            if delta:
                # each chunk embeds the frontier state AS OF THIS SAVE
                # (sans the inline part, which the meta re-embeds every
                # save anyway): the corrupt-delta heal resumes from the
                # newest intact chunk's embedded snapshot
                emb = dict(state)
                emb["results_total"] = done + len(delta)
                payload = envelope.wrap(
                    json.dumps({"delta": delta, "state": emb}))
                n0 = self._io(self.store.llen, self._results_key)

                def _push_delta():
                    # idempotent under retry: an append that LANDED but
                    # raised (ack lost) must not land twice — one writer
                    # per uid, so the length check is race-free
                    if self.store.llen(self._results_key) <= n0:
                        self.store.rpush(self._results_key, payload)

                self._io(_push_delta)
            state["results_total"] = done + len(delta)
        state["results_inline"] = self._inline
        # meta written LAST: results_total only matches inline+list once
        # the delta is in, so a kill between writes reads as torn (and
        # load() heals back to THIS meta's snapshot), never as valid
        self._io(self.store.set, self._meta_key,
                 envelope.wrap(json.dumps(state)))
        log_event("frontier_checkpoint", uid=self.uid,
                  stack=len(state["stack"]), results=state["results_total"])

    def _save_spooled(self, g, state: dict, delta, done: int) -> None:
        """The outage-mode save: the same write sequence (delta first,
        meta LAST — so any replayed prefix reads as torn and load()
        heals back to the previous good snapshot, exactly the existing
        contract) appended to the write-behind spool.  No llen
        idempotence check: one writer per uid plus strictly in-order
        replay makes the spooled sequence exact by construction."""
        uid = self.uid
        if done == 0:
            g.delete(uid, self._results_key)
            self._inline = delta
            state["results_total"] = len(delta)
        else:
            if delta:
                emb = dict(state)
                emb["results_total"] = done + len(delta)
                g.rpush(uid, self._results_key, envelope.wrap(
                    json.dumps({"delta": delta, "state": emb})))
            state["results_total"] = done + len(delta)
        state["results_inline"] = self._inline
        g.set(uid, self._meta_key, envelope.wrap(json.dumps(state)))
        log_event("frontier_checkpoint_spooled", uid=uid,
                  stack=len(state["stack"]),
                  results=state["results_total"])

    def clear(self) -> None:
        g = self._guard
        if g is not None:
            g.delete(self.uid, self._meta_key)
            g.delete(self.uid, self._results_key)
            return
        self.store.delete(self._meta_key)
        self.store.delete(self._results_key)


class AdmissionShed(RuntimeError):
    """A submit refused with HTTP 429 + ``Retry-After: retry_after_s``.
    Default message = the global-queue-full case; ``why`` overrides it
    for the other shed scopes (a tenant over its fairness cap, a
    draining replica, a dataset already in flight on a peer)."""

    def __init__(self, uid: str, depth: int, queued: int,
                 retry_after_s: int, why: Optional[str] = None):
        self.retry_after_s = retry_after_s
        super().__init__(
            why or f"admission queue full ({queued}/{depth} jobs "
                   f"queued); retry in ~{retry_after_s}s")


class UidConflict(RuntimeError):
    """A submit naming a uid that is currently queued or running — the
    HTTP layer maps it to 409.  Accepting it would wipe the live job's
    state from under its worker (the old clear-at-submit hazard)."""

    def __init__(self, uid: str):
        super().__init__(
            f"uid {uid!r} is live (queued or running); resubmitting would "
            "wipe its state — wait for a terminal status or use a new uid")


class QuarantinedUid(UidConflict):
    """A submit naming a crash-loop-quarantined uid ([cluster]
    max_adoptions exhausted).  Subclasses :class:`UidConflict` so every
    handler maps it to the same 409 — but the message points the
    operator at the release path instead of at a live job."""

    def __init__(self, uid: str, adoptions: Optional[int] = None):
        tag = "" if adoptions is None else f" after {adoptions} adoptions"
        RuntimeError.__init__(
            self,
            f"uid {uid!r} is quarantined as a poison job{tag}; inspect "
            f"fsm:quarantine:{uid} and release via "
            "/admin/quarantine?action=release before resubmitting")


# the ONE priority vocabulary (admission classes, SLO label seeding)
# lives in obsplane — actors imports it so the two can never drift
PRIORITIES = obsplane.PRIORITIES

_QUEUE_DEPTH = obs.REGISTRY.gauge(
    "fsm_service_queue_depth",
    "train jobs queued for a miner worker (excludes the running ones)")
_SHEDS_TOTAL = obs.REGISTRY.counter(
    "fsm_service_sheds_total",
    "train submits refused with 429 because the admission queue was full")
for _p in PRIORITIES:
    _SHEDS_TOTAL.seed(priority=_p)
_DRAINS_TOTAL = (obs.REGISTRY.counter(
    "fsm_replica_drains_total",
    "scale-down drains of this replica, by outcome (clean = queue fully "
    "stolen/finished before the timeout; timeout = leftovers handed to "
    "the peers' recovery protocol)")
    .seed(outcome="clean").seed(outcome="timeout"))


class AdmissionQueue:
    """Bounded, priority-classed mailbox replacing the unbounded
    ``queue.Queue`` — the admission-control half of the overload story.

    Three strict priority classes (``high`` > ``normal`` > ``low``);
    within a class, FIFO — or, with a fairness scheduler installed
    (``[fairness] enabled``, service/fairness.py), deficit-weighted
    round-robin across tenants with per-tenant occupancy caps; the
    classes stay strict ABOVE fairness either way.  ``depth`` bounds
    the QUEUED jobs (running jobs have already left the queue; 0 =
    unbounded).  Admission is a two-phase reserve/put so the bound is
    exact under concurrent submitters even though the store writes
    between reservation and enqueue take time: ``try_reserve``
    atomically claims a slot (or reports the shed), ``put`` converts
    it, ``abort`` returns it.

    Worker sentinels (shutdown) are counted separately and handed out
    only once every queued job has been drained — backlog jobs always
    reach a worker, which gives them their durable drain failure.
    ``pause`` (the scale-down drain) stops workers from picking up
    QUEUED work while sentinels still surface, so a drained replica's
    backlog is left for peers to steal instead of being started
    locally."""

    def __init__(self, depth: int,
                 fair: Optional[fairness.TenantScheduler] = None):
        self.depth = int(depth)
        self._fair = fair
        self._cond = threading.Condition()
        if fair is None:
            self._qs: Dict[str, object] = {
                p: collections.deque() for p in PRIORITIES}
        else:
            self._qs = {p: fairness.FairClass(fair) for p in PRIORITIES}
        self._reserved = 0
        self._tenant_reserved: Dict[str, int] = {}
        self._tenant_queued: Dict[str, int] = {}
        self._sentinels = 0
        self._paused = False
        _QUEUE_DEPTH.set(0)

    def _n_queued(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def size(self) -> int:
        with self._cond:
            return self._n_queued()

    def _tenant_total(self, tenant: str) -> int:
        return (self._tenant_queued.get(tenant, 0)
                + self._tenant_reserved.get(tenant, 0))

    def try_reserve(self, priority: str = "low",
                    tenant: str = fairness.DEFAULT_TENANT):
        """(admitted, queued_now, queued_ahead, scope): claim a queue
        slot, or report a shed (``admitted=False``) naming what refused
        it — ``"queue"`` (the global depth; ``queued_now``/``ahead``
        are the global counts) or ``"tenant"`` (the tenant's own
        occupancy cap; both counts are the TENANT's).  ``queued_ahead``
        is the shed submit's true queue position — jobs in classes at
        or above its priority, plus in-flight reservations (class
        unknown until ``put``, counted ahead conservatively) — the
        Retry-After estimator's input: a shed ``high`` submit behind
        200 ``low`` jobs waits for the running work, not the whole
        backlog."""
        with self._cond:
            if self._fair is not None and self._fair.tenant_depth > 0:
                # the tenant's token bucket: one token per queued slot,
                # consumed here, returned at dequeue/abort.  Checked
                # BEFORE the global bound so a flooding tenant sheds
                # with ITS OWN counts while the fleet still has room.
                tn = self._tenant_total(tenant)
                if tn >= self._fair.tenant_depth:
                    return False, tn, tn, "tenant"
            n = self._n_queued() + self._reserved
            if self.depth > 0 and n >= self.depth:
                rank = PRIORITIES.index(priority)
                ahead = sum(len(self._qs[p])
                            for p in PRIORITIES[:rank + 1])
                return False, n, ahead + self._reserved, "queue"
            self._reserved += 1
            if self._fair is not None:
                self._tenant_reserved[tenant] = \
                    self._tenant_reserved.get(tenant, 0) + 1
            return True, n, 0, ""

    def abort(self, tenant: str = fairness.DEFAULT_TENANT) -> None:
        with self._cond:
            self._reserved -= 1
            if self._fair is not None:
                self._tenant_reserved[tenant] = max(
                    0, self._tenant_reserved.get(tenant, 0) - 1)

    def _set_tenant_queued(self, tenant: str, delta: int) -> None:
        n = max(0, self._tenant_queued.get(tenant, 0) + delta)
        self._tenant_queued[tenant] = n
        fairness.set_depth(tenant, n)

    def put(self, req: ServiceRequest, priority: str,
            tenant: str = fairness.DEFAULT_TENANT) -> None:
        with self._cond:
            self._reserved -= 1
            if self._fair is not None:
                self._tenant_reserved[tenant] = max(
                    0, self._tenant_reserved.get(tenant, 0) - 1)
                self._qs[priority].append(req, tenant)
                self._set_tenant_queued(tenant, +1)
            else:
                self._qs[priority].append(req)
            _QUEUE_DEPTH.set(self._n_queued())
            self._cond.notify()

    def put_sentinel(self) -> None:
        with self._cond:
            self._sentinels += 1
            self._cond.notify()

    def get(self) -> Optional[ServiceRequest]:
        """Highest-priority queued request, or None (a sentinel) —
        sentinels only surface once the backlog is fully drained.
        While PAUSED (scale-down drain) queued work is invisible but
        sentinels still surface, so shutdown after a drain completes."""
        with self._cond:
            while True:
                if not self._paused:
                    for p in PRIORITIES:
                        if self._qs[p]:
                            if self._fair is not None:
                                req, tenant = self._qs[p].popleft()
                                self._set_tenant_queued(tenant, -1)
                                fairness.note_dequeued(tenant)
                            else:
                                req = self._qs[p].popleft()
                            _QUEUE_DEPTH.set(self._n_queued())
                            return req
                if self._sentinels:
                    self._sentinels -= 1
                    return None
                self._cond.wait()

    def remove(self, uid: str) -> Optional[ServiceRequest]:
        """Pull a QUEUED request out by uid (the cancel-while-queued
        path: its slot must return to the pool NOW, not when a worker
        eventually dequeues the dead work).  None when no queued request
        carries the uid — a worker already took it."""
        with self._cond:
            if self._fair is not None:
                for q in self._qs.values():
                    hit = q.remove_uid(uid)
                    if hit is not None:
                        req, tenant = hit
                        self._set_tenant_queued(tenant, -1)
                        _QUEUE_DEPTH.set(self._n_queued())
                        return req
                return None
            for q in self._qs.values():
                for req in q:
                    if req.uid == uid:
                        q.remove(req)
                        _QUEUE_DEPTH.set(self._n_queued())
                        return req
        return None

    # ------------------------------------------------- scale-down drain

    def pause(self) -> None:
        """Stop handing QUEUED work to workers (they finish their
        current job only) — the drain protocol's first step.  Sentinels
        still surface, so a later shutdown() completes normally."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def queued_uids(self) -> List[str]:
        """Snapshot of the queued uids (the drain loop's steal-reap
        input)."""
        with self._cond:
            if self._fair is not None:
                return [u for q in self._qs.values() for u in q.uids()]
            return [req.uid for q in self._qs.values() for req in q]

    def pop_all(self) -> List[ServiceRequest]:
        """Empty every class (the drain-timeout leftovers: jobs the
        peers did not steal in time, handed to the recovery protocol by
        the caller)."""
        with self._cond:
            out: List[ServiceRequest] = []
            for q in self._qs.values():
                if self._fair is not None:
                    for req, tenant in q.pop_all():
                        self._set_tenant_queued(tenant, -1)
                        out.append(req)
                else:
                    out.extend(q)
                    q.clear()
            _QUEUE_DEPTH.set(0)
            return out

    def tenant_depths(self) -> Dict[str, int]:
        """Per-tenant queued counts (empty without a fairness
        scheduler) — piggybacked on the lease heartbeat snapshot."""
        with self._cond:
            return {t: n for t, n in self._tenant_queued.items() if n > 0}


def _checkpoint_requested(req: ServiceRequest) -> bool:
    """One spelling of the checkpoint-param truthiness (Miner._run_traced
    and the admission layer's keep-frontier decision must agree)."""
    return (req.param("checkpoint") or "").lower() not in (
        "", "0", "false", "no", "off")


class Miner:
    """Train worker: source -> dataset -> plugin -> sink, with statuses.

    Mirrors SURVEY.md sec 3.1: status 'started' -> build dataset ->
    'dataset' -> mine -> sink patterns/rules -> 'trained' -> 'finished';
    failures land in 'failure' with the error recorded (the supervision
    contract of the reference's actor hierarchy).

    Supervision extends to retry: a failed job re-runs up to ``retries``
    times (request param; default from the boot config) before the failure
    status lands — the analog of Spark's task re-execution.  With
    ``checkpoint=1`` a retry resumes the mine from the last persisted
    frontier instead of starting over.

    Overload/restart posture: the mailbox is a bounded
    priority-classed :class:`AdmissionQueue` (``[service] queue_depth``;
    ``priority`` request param) — a full queue sheds the submit with
    :class:`AdmissionShed` (HTTP 429 + Retry-After from the cost-model
    estimate of the queued work) BEFORE any store write, so a shed
    leaves zero trace of the uid.  A ``deadline_s`` request param stamps
    a budget at submit (queue wait spends it) enforced at the engines'
    launch-boundary safe points via utils/jobctl; ``/admin/cancel``
    aborts the same way.  Every admitted job writes a journal intent
    record (``fsm:journal:{uid}``) cleared only on terminal status —
    the crash-restart recovery pass (:func:`recover_orphans`) reads it.
    """

    def __init__(self, store: ResultStore, workers: int = 1,
                 queue_depth: Optional[int] = None,
                 lease_mgr: Optional[lease.LeaseManager] = None) -> None:
        self.store = store
        if queue_depth is None:
            queue_depth = config.get_config().service.queue_depth
        # weighted-fair multi-tenant admission (earlier work,
        # service/fairness.py): None (the default) keeps the queue's
        # plain per-class deques and the tenant param ignored
        self._fair = fairness.build_scheduler()
        self._q = AdmissionQueue(queue_depth, fair=self._fair)
        # scale-down drain state: set by drain() — submits
        # shed with 429 pointing at the peers, workers stop picking up
        # queued work, and the backlog leaves via the steal/recovery
        # protocol instead of running here
        self._draining = False
        # multi-replica lease layer: explicit manager, or
        # built from the boot [cluster] section.  None (the default
        # single-replica deployment) keeps every guard below at one
        # ``is None`` read.
        if lease_mgr is None and config.get_config().cluster.enabled:
            lease_mgr = lease.LeaseManager.from_config(
                store, config.get_config().cluster)
        self._lease = lease_mgr
        # result-reuse tier: dataset
        # fingerprints + in-flight coalescing + dominance serving above
        # admission.  None (the default) keeps submit at ONE attribute
        # read — bench_smoke's dispatch counters stay byte-identical.
        self._rescache = resultcache.build_for(self)
        # store-outage survival:
        # health state machine + write-behind spool + outage stalls.
        # None (the default) keeps every durable-write guard below at
        # one ``is None`` read — bench_smoke dispatch counters stay
        # byte-identical.
        self._guard = None
        if config.get_config().storeguard.enabled:
            self._guard = storeguard.install(store, lease_mgr=self._lease)
            self._guard.start()
        # this Miner's incarnation id: journal entries carrying it are
        # LIVE (409 on resubmit); entries carrying any other id belong
        # to a dead incarnation and are recovery fodder
        self.incarnation = uuid.uuid4().hex
        self._stopping = False
        # guards the _stopping check-and-enqueue in submit() against
        # shutdown(): without it a submit could pass the check, lose the
        # CPU, and enqueue BEHIND the sentinels after the workers exited
        self._stop_lock = threading.Lock()
        # EWMA of measured job walls — the Retry-After estimator's input
        # once real jobs have run (the cost-model prior seeds it)
        self._wall_lock = threading.Lock()
        self._wall_ewma: Optional[float] = None
        # serializes the conflict-check -> journal-intent window of
        # submit(): without it two concurrent submits of the SAME uid
        # both pass the 409 check and both admit — the state-wipe race
        # the conflict check exists to close
        self._admit_lock = threading.Lock()
        # adoption counters staged by note_adoption() for the NEXT admit
        # of a uid (recovery resubmit / steal): the journal intent the
        # admit writes carries the count, so the crash-loop quarantine
        # budget ([cluster] max_adoptions) survives further crashes
        self._adoptions_pending: Dict[str, int] = {}
        # running-job count (distinct from queue depth): what the lease
        # heartbeat advertises and the steal scan's idle check reads
        self._running = 0
        self._running_lock = threading.Lock()
        # lifetime successful admissions (monotone): heartbeat-
        # piggybacked as "adm" so the autoscale leader can smooth the
        # fleet's admission RATE and its derivative (predictive
        # scale-up, [autoscale] up_rate_derivative)
        self._admitted = 0
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"fsm-miner-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()
        if self._lease is not None:
            # heartbeat starts with the workers; Master re-wires the
            # periodic-recovery callback after it exists (start() is
            # idempotent on the thread, updates the callback)
            self._lease.start(self)
            # cluster observability plane: durable trace
            # spine through the fenced write path + fsm_cluster_*
            # collector.  Last Miner wins, like the jobs collector;
            # solo deployments install nothing and the recorder's
            # spine probe stays one module-global read.
            obsplane.install(self.store, self._lease)
        # durable-state integrity plane:
        # the at-rest scrubber over this store (last Miner wins, like
        # obsplane).  Cluster mode drives it off the lease heartbeat
        # (integrity.tick inside LeaseManager.tick); solo service boots
        # start its cadence thread in app.main.  None when [integrity]
        # enabled = false — verify-on-READ stays unconditional either
        # way (it is a correctness property, not a feature flag).
        self._integrity = integrity.install(self.store)
        # usage metering plane: the
        # per-job/per-tenant device-cost meter over this store (last
        # Miner wins).  Cluster mode flushes the durable ledger off the
        # lease heartbeat (usage.tick inside LeaseManager.tick); solo
        # installs start the meter's private flush timer.  None when
        # [usage] enabled = false — every dispatch-surface deposit
        # probe is then one module-global read.
        self._usage = usage.install(self.store, self._lease)
        # degraded-topology survival plane (earlier work, service/
        # meshguard.py): per-partition-row health state machine +
        # topology epochs + crash-loop quarantine.  Cluster mode
        # gossips/probes off the lease heartbeat (meshguard tick phase
        # inside LeaseManager.tick).  [meshguard] enabled = false is a
        # strict no-op (a test-installed guard survives a Miner boot);
        # uninstalled, every epoch check and row-fault probe costs one
        # module-global read.
        if config.get_config().meshguard.enabled:
            meshguard.install(config.get_config().meshguard)

    # ------------------------------------------------------------ admission

    def queue_size(self) -> int:
        return self._q.size()

    def worker_count(self) -> int:
        return len(self._threads)

    def running_count(self) -> int:
        with self._running_lock:
            return self._running

    def idle_capacity(self) -> int:
        """Worker slots covered by neither running nor queued work — the
        steal scan's budget (and the heartbeat's ``free`` field)."""
        return max(0, self.worker_count() - self.running_count()
                   - self.queue_size())

    def sheds_total(self) -> float:
        """Lifetime 429 sheds (all priorities) — piggybacked on the
        lease heartbeat's metric snapshot."""
        return _SHEDS_TOTAL.total()

    def wall_ewma(self) -> Optional[float]:
        """EWMA of measured job walls (None before the first finish) —
        the heartbeat snapshot's load-cost hint."""
        with self._wall_lock:
            return self._wall_ewma

    def admitted_total(self) -> int:
        """Lifetime successful admissions — the heartbeat snapshot's
        "adm" field (the autoscaler's predictive-rate input)."""
        with self._running_lock:
            return self._admitted

    @property
    def draining(self) -> bool:
        return self._draining

    def tenant_depths(self) -> Dict[str, int]:
        """Per-tenant queued counts (empty without fairness) — the
        heartbeat snapshot's multi-tenant load view."""
        return self._q.tenant_depths() if self._fair is not None else {}

    def inflight_fps(self) -> List[str]:
        """Dataset fingerprints of in-flight coalescing leaders (empty
        without the result-reuse tier) — the heartbeat snapshot's
        cross-replica coalesce hint (ROADMAP 2c)."""
        rc = self._rescache
        return rc.inflight_fps() if rc is not None else []

    def drain(self, timeout_s: Optional[float] = None,
              reason: str = "scale-down") -> dict:
        """The scale-down drain protocol, on the substrate
        earlier work already built:

        1. stop admitting — submits shed with 429 whose Retry-After is
           the steal path (~2 heartbeats);
        2. stop STARTING queued work (workers finish their current job
           only; the queue pauses) and advertise ``draining`` with zero
           free capacity, so idle peers steal the queued backlog off
           our admission namespace exactly as they would off a loaded
           healthy replica;
        3. wait until the queue has been stolen empty and the running
           jobs finished, or ``timeout_s`` elapses;
        4. leftovers (peers too busy to steal in time) keep their
           journal intent + admission marker but have their LEASE
           released, so the survivors' steal scans and periodic
           recovery adopt them immediately — slower than a steal,
           never lost, never run twice.

        The caller (service/autoscale.py directive, /admin/drain, or
        an operator) shuts the process down afterwards; this method
        only guarantees that by its return every job this replica ever
        admitted is finished, stolen, adoptable, or durably settled.
        Lifecycle ``draining``/``drained`` spans land on the durable
        trace spine under ``replica:{id}`` so the fleet timeline shows
        the drain even after the process exits."""
        with self._stop_lock:
            if self._draining:
                return {"state": "already-draining"}
            self._draining = True
        if timeout_s is None:
            timeout_s = config.get_config().autoscale.drain_timeout_s
        rid = (self._lease.replica_id if self._lease is not None
               else "solo")
        trace_id = f"replica:{rid}"
        t0 = time.monotonic()
        queued0, running0 = self.queue_size(), self.running_count()
        log_event("replica_draining", replica=rid, queued=queued0,
                  running=running0, reason=reason)
        with obs.span("lifecycle.draining", trace_id=trace_id,
                      replica=rid, reason=reason, queued=queued0,
                      running=running0):
            pass
        obs.flush_trace(trace_id)
        self._q.pause()
        if self._lease is not None:
            # heartbeat flips to draining/free=0/steal=false and
            # publishes immediately: peers must stop counting on us
            # (and start stealing from us) within one heartbeat
            self._lease.set_draining(True)
        deadline = t0 + max(0.1, float(timeout_s))
        stolen = 0
        while time.monotonic() < deadline:
            stolen += self._reap_stolen()
            if self.queue_size() == 0 and self.running_count() == 0:
                break
            time.sleep(0.02)
        stolen += self._reap_stolen()
        leftovers = self._q.pop_all()
        for req in leftovers:
            if self._lease is not None:
                # journal intent + admission marker stay (the survivors'
                # steal scan or periodic recovery picks each up exactly
                # once); releasing the lease makes adoption IMMEDIATE
                # instead of a TTL wait.  Local control state dies here.
                ctl = self._lease.attached_ctl(req.uid)
                self._lease.release(req.uid)
                jobctl.release_entry(ctl)
                if self._rescache is not None:
                    # local followers cannot wait for a fan-out that
                    # will now happen on the adopting replica
                    self._rescache.on_leader_terminal(req.uid)
            else:
                # solo deployment: nobody can adopt — settle durably,
                # keep_frontier so a checkpointed resubmit resumes
                _record_failure(self.store, req.uid,
                                RuntimeError("replica draining"),
                                keep_frontier=True, lease_mgr=None,
                                rescache=self._rescache,
                                guard=self._guard)
        running_left = self.running_count()
        outcome = ("clean" if not leftovers and running_left == 0
                   else "timeout")
        _DRAINS_TOTAL.inc(outcome=outcome)
        report = {"outcome": outcome, "reason": reason,
                  "replica": rid, "waited_s": round(
                      time.monotonic() - t0, 3),
                  "queued_at_start": queued0,
                  "running_at_start": running0,
                  "stolen_by_peers": stolen,
                  "left_for_recovery": len(leftovers),
                  "running_left": running_left}
        log_event("replica_drained", **report)
        with obs.span("lifecycle.drained", trace_id=trace_id,
                      replica=rid, outcome=outcome,
                      left_for_recovery=len(leftovers)):
            pass
        obs.flush_trace(trace_id)
        return report

    def _reap_stolen(self) -> int:
        """Drain-loop victim bookkeeping: with the queue PAUSED the
        worker-side drop (retract_admission at dequeue) never runs, so
        the drain polls the admission markers itself — a marker a
        thief claimed means the job runs on the thief now and leaves
        our queue here.  Returns how many entries were reaped."""
        if self._lease is None:
            return 0
        reaped = 0
        for uid in self._q.queued_uids():
            try:
                if not self._lease.admission_claimed(uid):
                    continue
            except Exception:
                continue  # store hiccup: the next poll retries
            req = self._q.remove(uid)
            if req is None:
                continue
            ctl = self._lease.attached_ctl(uid)
            self._lease.stolen_from_us(uid)
            jobctl.release_entry(ctl)
            if self._rescache is not None:
                self._rescache.on_leader_terminal(uid)
            reaped += 1
        return reaped

    def settle_cancelled_queued(self, uid: str) -> bool:
        """Settle a job cancelled while still QUEUED: remove it from the
        admission queue (freeing its slot for new submits immediately)
        and record its durable CANCELLED failure here, instead of
        leaving dead work occupying capacity until a worker gets to it.
        False when a worker already dequeued it — the worker's own
        check_entry settles it then (the removal is atomic under the
        queue lock, so exactly one side ever settles)."""
        req = self._q.remove(uid)
        if req is None:
            return False
        if self._lease is not None and not self._lease.retract_admission(uid):
            # a peer stole the job between the cancel request and this
            # settle: it runs there now — local cancel state is moot.
            # Release OUR control object by identity, never the uid (a
            # same-process thief may have re-registered it already).
            ctl = self._lease.attached_ctl(uid)
            self._lease.stolen_from_us(uid)
            jobctl.release_entry(ctl)
            if self._rescache is not None:
                # the thief runs (and fans out) elsewhere: local
                # followers re-dispatch as cold mines
                self._rescache.on_leader_terminal(uid)
            return True
        try:
            # route through check_entry so the cancel counter and trace
            # event fire exactly like a worker-side abort
            jobctl.check_entry(jobctl.get(uid))
            exc: jobctl.JobAborted = jobctl.JobCancelled(
                uid, "cancelled while queued")
        except jobctl.JobAborted as caught:
            exc = caught
        _record_failure(self.store, uid, exc, keep_frontier=True,
                        lease_mgr=self._lease, rescache=self._rescache,
                        guard=self._guard)
        return True

    @property
    def queue_depth(self) -> int:
        return self._q.depth

    def _observe_wall(self, wall_s: float) -> None:
        with self._wall_lock:
            self._wall_ewma = (wall_s if self._wall_ewma is None
                               else 0.3 * wall_s + 0.7 * self._wall_ewma)

    def _per_job_s(self) -> float:
        """One job's estimated wall: the EWMA of measured walls, seeded
        — before any job has finished — by the ragged planner's cost
        model over the declared prewarm envelope (8 full-width launches
        at the configured sequence scale: the same KERNELS.json-
        anchored arithmetic the watchdog deadlines use)."""
        with self._wall_lock:
            per_job = self._wall_ewma
        if per_job is None:
            pw = config.get_config().prewarm
            n_seq = pw.sequences or 100_000
            per_job = RB.estimate_seconds(8 * 8192, 8, n_seq,
                                          max(1, pw.words or 1))
        return per_job

    def _steal_path_retry_s(self) -> int:
        """~Two heartbeats: the time for an idle peer's steal scan to
        pick a queued job up — the Retry-After whenever the fastest
        path to service is a PEER (free capacity advertised, or this
        replica draining)."""
        hb = self._lease.heartbeat_s if self._lease is not None else 1.0
        return max(1, math.ceil(2 * max(hb, 0.5)))

    def _retry_after_s(self, queued_ahead: int) -> int:
        """Seconds until a shed submit plausibly fits: the submit's true
        QUEUE POSITION (jobs queued at or above its priority class —
        work below it would be overtaken, not waited for) divided over
        the workers, priced per job by :meth:`_per_job_s`.

        CLUSTER OVERRIDE: when peers advertise free capacity in their
        heartbeat records, the shed submit's fastest path is the STEAL
        path — an idle peer claims our queued backlog within a
        heartbeat or two, so the local-EWMA pessimum would overstate
        the wait by orders of magnitude.  Point the client at roughly
        two heartbeats instead."""
        if self._lease is not None and self._lease.peer_free_total() > 0:
            return self._steal_path_retry_s()
        est = self._per_job_s() * (queued_ahead + 1) \
            / max(1, len(self._threads))
        return max(1, min(3600, math.ceil(est)))

    def submit(self, req: ServiceRequest) -> Optional[dict]:
        """Admit a train request; returns response extras (e.g. the
        ephemeral-admission flag) or None."""
        faults.fault_site("service.admit", uid=req.uid)
        priority = (req.param("priority") or "normal").lower()
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r} "
                             f"(valid: {'/'.join(PRIORITIES)})")
        # multi-tenant identity (service/fairness.py): validated +
        # registered against the bounded vocabulary when fairness is
        # on; accepted-but-ignored otherwise (the queue stays FIFO)
        tenant = fairness.DEFAULT_TENANT
        if self._fair is not None:
            tenant = self._fair.resolve(req.param("tenant"))
        deadline_s = None
        raw_deadline = req.param("deadline_s")
        if raw_deadline is not None:
            deadline_s = float(raw_deadline)  # ValueError -> failure reply
            # non-finite values pass a naive `<= 0` check: nan compares
            # False to everything, so the "deadline" would silently never
            # expire while pinning every safe-point probe onto the slow
            # path for the job's whole life
            if not math.isfinite(deadline_s) or deadline_s <= 0:
                raise ValueError(f"deadline_s must be a finite value > 0 "
                                 f"(got {raw_deadline!r})")
        if self._draining:
            # scale-down drain: this replica is leaving the fleet — no
            # new work, and the honest Retry-After is the steal path
            # (peers will have adopted our backlog by then too)
            retry = self._steal_path_retry_s()
            _SHEDS_TOTAL.inc(priority=priority)
            if self._fair is not None:
                fairness.note_shed(tenant)
            log_event("job_shed_draining", uid=req.uid, priority=priority)
            raise AdmissionShed(
                req.uid, self._q.depth, self._q.size(), retry,
                why=f"replica is draining for scale-down; peers serve "
                    f"new work — retry in ~{retry}s")
        g = self._guard
        if g is not None and g.is_down():
            # STORE OUTAGE: the submit cannot be journaled, so it
            # cannot be made durable.  Default: shed 429 (the honest
            # Retry-After is the probe cadence — how fast the service
            # can notice the store back).  Opt-in ephemeral admission
            # runs the job loudly flagged NO-JOURNAL instead: results
            # ride the spool, a crash before the store returns loses
            # them, and the response says so.
            if not g.ephemeral_admission:
                retry = g.shed_outage_admission()
                _SHEDS_TOTAL.inc(priority=priority)
                if self._fair is not None:
                    fairness.note_shed(tenant)
                log_event("job_shed_store_outage", uid=req.uid,
                          priority=priority)
                raise AdmissionShed(
                    req.uid, self._q.depth, self._q.size(), retry,
                    why=f"store outage: durable admission is "
                        f"unavailable; retry in ~{retry}s")
            return self._admit_ephemeral(req, priority, deadline_s,
                                         tenant)
        rc = self._rescache
        if rc is not None:
            # result-reuse tier (service/resultcache.py): a request
            # served from a completed cache entry, or coalesced onto an
            # identical in-flight job, never reaches the queue; a miss
            # registers it as a prospective coalescing leader and falls
            # through to normal cold admission
            out = rc.intercept(req, priority, deadline_s)
            if out == "peer-inflight":
                # cross-replica coalesce HINT (ROADMAP 2c): an identical
                # dataset fingerprint is in flight on a peer — point the
                # client at the cache entry that peer is about to
                # publish instead of admitting a duplicate cold mine.
                # Hint only: replica-local coalescing semantics are
                # unchanged, and any error upstream degraded to a miss.
                retry = self._steal_path_retry_s()
                _SHEDS_TOTAL.inc(priority=priority)
                if self._fair is not None:
                    fairness.note_shed(tenant)
                raise AdmissionShed(
                    req.uid, self._q.depth, self._q.size(), retry,
                    why=f"an identical dataset mine is in flight on a "
                        f"peer replica; retry in ~{retry}s to hit the "
                        f"shared result cache")
            if out is not None:
                return
        enqueued = False
        try:
            enqueued = self._admit(req, priority, deadline_s, tenant)
        finally:
            if rc is not None and not enqueued:
                # the prospective-leader registration from intercept()
                # must die with the failed admission, or later identical
                # requests would attach to a uid that never runs
                rc.admit_aborted(req.uid)
        if enqueued:
            return None
        # shutdown() already enqueued the worker sentinels; a request
        # enqueued now would never be dequeued (workers exit on the
        # sentinel) and would sit "started" forever — the exact state
        # the drain exists to prevent.  Record the durable failure
        # here, same status shape as the drained-backlog path.
        if self._lease is not None:
            try:
                self._lease.retract_admission(req.uid)
            except Exception:
                pass
        _record_failure(self.store, req.uid,
                        RuntimeError("service shutting down"),
                        keep_frontier=True, lease_mgr=self._lease,
                        rescache=rc, guard=self._guard)
        return None

    def _admit_ephemeral(self, req: ServiceRequest, priority: str,
                         deadline_s: Optional[float],
                         tenant: str) -> Optional[dict]:
        """Outage-mode admission under ``[storeguard]
        ephemeral_admission``: NO journal intent, NO lease, NO
        admission marker — the job exists only in this process, its
        statuses/results ride the write-behind spool ungated
        (``gate="none"``: no peer can know the uid, so replay cannot
        double-commit), and the submit response carries
        ``ephemeral: "1"`` so the client knows a crash before the
        store returns loses the job.  Every durable-admission
        guarantee (409 conflict vs peers, steal, adoption) is
        explicitly OUT: that is the flag's meaning.  Two duplicate-uid
        defenses remain even here: a uid live IN THIS PROCESS 409s
        (below), and the replay gate refuses a gate="none" spool whose
        uid acquired any durable trace (journal/lease/status) during
        the outage — a client that reused the uid against a healthy
        peer keeps that peer's results."""
        g = self._guard
        if jobctl.get(req.uid) is not None:
            raise UidConflict(req.uid)
        admitted, queued, ahead, scope = self._q.try_reserve(
            priority, tenant)
        if not admitted:
            _SHEDS_TOTAL.inc(priority=priority)
            if self._fair is not None:
                fairness.note_shed(tenant)
            raise AdmissionShed(req.uid, self._q.depth, queued,
                                self._retry_after_s(ahead))
        enqueued = False
        try:
            ctl = jobctl.register(req.uid, deadline_s, priority=priority)
            ctl.tenant = tenant
            ctl.ephemeral = True
            g.note_ephemeral_admission()
            g.status(req.uid, Status.STARTED, gate="none")
            g.incr(req.uid, "fsm:metric:jobs_submitted", gate="none")
            log_event("job_admitted_ephemeral", uid=req.uid,
                      priority=priority)
            obs.trace_begin(req.uid,
                            algorithm=req.param("algorithm", "SPADE_TPU"),
                            source=req.param("source", "FILE"))
            obs.lifecycle(req.uid, "admitted", priority=priority,
                          ephemeral=True)
            with self._stop_lock:
                if not self._stopping:
                    self._q.put(req, priority, tenant)
                    if self._fair is not None:
                        fairness.note_admitted(tenant)
                    enqueued = True
        except BaseException:
            jobctl.release(req.uid)
            raise
        finally:
            if not enqueued:
                self._q.abort(tenant)
        if not enqueued:
            _record_failure(self.store, req.uid,
                            RuntimeError("service shutting down"),
                            keep_frontier=True, lease_mgr=None,
                            rescache=self._rescache, guard=g)
            return None
        with self._running_lock:
            self._admitted += 1
        return {"ephemeral": "1"}

    def note_adoption(self, uid: str, count: int) -> None:
        """Stage adoption number ``count`` for the NEXT admit of
        ``uid``: the journal intent the admit writes carries the
        counter, so the crash-loop budget is durable across the very
        crashes it is counting."""
        self._adoptions_pending[str(uid)] = int(count)

    def adopt_or_poison(self, uid: str, entry: Dict, raw=None) -> bool:
        """Crash-loop quarantine gate, shared by boot/periodic recovery
        and the steal path.  Returns True when ``uid`` may be adopted
        once more (and pre-stamps the bumped counter for the resubmit);
        False when the budget ([cluster] max_adoptions) is exhausted —
        the job is settled instead as a durable ``POISON:`` terminal
        plus an fsm:quarantine:{uid} record, and every resubmit 409s
        until ``/admin/quarantine`` releases it."""
        try:
            n = int(entry.get("adoptions") or 0)
        except (TypeError, ValueError):
            n = 0
        limit = config.get_config().cluster.max_adoptions
        if n < limit:
            self.note_adoption(uid, n + 1)
            return True
        self._settle_poison(uid, n, limit, raw=raw)
        return False

    def _settle_poison(self, uid: str, adoptions: int, limit: int,
                       raw=None) -> None:
        """Durable poison settle: quarantine record first (evidence =
        the dead holders' trace-spine tail, so the operator sees WHERE
        the crash loop bit without replaying it), then the normal
        fenced failure path — no client ever polls a forever-pending
        poison uid."""
        evidence = None
        try:
            evidence = obsplane.spine_chunks(self.store, uid)[-3:]
        except Exception:
            evidence = None
        meshguard.poison_record(
            self.store, uid,
            reason=(f"adoption budget exhausted: {adoptions} adoptions "
                    f">= [cluster] max_adoptions={limit}"),
            adoptions=adoptions, evidence=evidence, raw_intent=raw)
        # keep_frontier: the preserved checkpoint is evidence too, and
        # an operator release + resubmit resumes instead of re-mining
        _record_failure(
            self.store, uid,
            RuntimeError(
                f"POISON: job crashed its holder {adoptions} times "
                f"([cluster] max_adoptions={limit}); quarantined — "
                "release via /admin/quarantine to resubmit"),
            keep_frontier=True, lease_mgr=self._lease,
            rescache=self._rescache, guard=self._guard)

    def _admit(self, req: ServiceRequest, priority: str,
               deadline_s: Optional[float],
               tenant: str = fairness.DEFAULT_TENANT) -> bool:
        """The cold admission path (conflict check → lease → queue slot
        → journal intent → enqueue), split out of :meth:`submit` so the
        result-reuse bookkeeping wraps it in one try/finally.  Returns
        whether the request was enqueued (False only while shutting
        down)."""
        enqueued = False
        with self._admit_lock:
            # crash-loop quarantine gate (meshguard): a poison record
            # refuses the uid outright — 409 until an operator releases
            # it via /admin/quarantine.  Integrity quarantines (other
            # surfaces under the same prefix) do NOT block.
            poison = meshguard.poisoned(self.store, req.uid)
            if poison is not None:
                meshguard.note_refused(req.uid)
                raise QuarantinedUid(req.uid,
                                     adoptions=poison.get("adoptions"))
            # the conflict check and the journal intent that makes the
            # uid LIVE must be one atomic step: two racing submits of
            # the same uid must serialize here so exactly one admits
            # and the other sees the fresh intent and 409s
            entry = self.store.journal_get(req.uid)
            if entry is not None:
                try:
                    live = (json.loads(entry).get("incarnation")
                            == self.incarnation)
                except ValueError:
                    live = False  # corrupt record: treat as a dead orphan
                if live:
                    raise UidConflict(req.uid)
            fresh_lease = False
            if self._lease is not None:
                # cluster-wide liveness: the lease generalizes the
                # incarnation check across replicas.  Held by a peer ->
                # the job is live THERE (409); protocol failure -> 503
                # with zero store trace of the uid (LeaseUnavailable
                # propagates).  Acquisition happens BEFORE the journal
                # intent so a refused submit leaves nothing behind.
                # A PRE-HELD lease (adoption/steal resubmit) is kept on
                # failure paths below: the caller settles the failure
                # under it, journal-first, so no adopt-vs-settle window
                # opens between a release and the durable record.
                fresh_lease = self._lease.token_of(req.uid) is None
                try:
                    self._lease.acquire(req.uid)
                except lease.LeaseHeld as exc:
                    raise UidConflict(req.uid) from exc
            admitted, queued, ahead, scope = self._q.try_reserve(
                priority, tenant)
            if not admitted:
                if self._lease is not None and fresh_lease:
                    self._lease.release(req.uid)
                _SHEDS_TOTAL.inc(priority=priority)
                if self._fair is not None:
                    fairness.note_shed(tenant)
                log_event("job_shed", uid=req.uid, queued=queued,
                          queued_ahead=ahead, depth=self._q.depth,
                          priority=priority, tenant=tenant, scope=scope)
                if scope == "tenant":
                    # the tenant's own bucket refused the slot: the
                    # Retry-After is how long ITS backlog takes at ITS
                    # weight-fair share of the service rate, not the
                    # global estimate (service/fairness.py)
                    cap = self._fair.tenant_depth
                    retry = self._fair.retry_after_s(
                        tenant, queued, self._per_job_s(),
                        len(self._threads))
                    raise AdmissionShed(
                        req.uid, cap, queued, retry,
                        why=f"tenant {tenant!r} queue cap reached "
                            f"({queued}/{cap} jobs queued); retry in "
                            f"~{retry}s")
                raise AdmissionShed(req.uid, self._q.depth, queued,
                                    self._retry_after_s(ahead))
            try:
                # A client-supplied uid may collide with a finished/
                # failed job; clear its stale error and results so
                # /status and /get reflect THIS job.  A checkpointed
                # submit KEEPS the frontier keys: live uids were
                # rejected above, so a surviving frontier belongs to a
                # dead incarnation and resuming it is exactly the
                # crash-recovery contract (a frontier for different
                # data fails the fingerprint check and the mine
                # restarts fresh).
                self.store.clear_job(
                    req.uid, keep_frontier=_checkpoint_requested(req))
                self.store.journal_set(req.uid, json.dumps({
                    "uid": req.uid,
                    "incarnation": self.incarnation,
                    "replica": (self._lease.replica_id
                                if self._lease is not None else None),
                    "ts": round(time.time(), 3),
                    "checkpoint": _checkpoint_requested(req),
                    "priority": priority,
                    "adoptions": self._adoptions_pending.pop(req.uid, 0),
                    "request": dict(req.data),
                }))
                if self._lease is not None:
                    # mirror the queued job into this replica's admission
                    # namespace — the steal scan's menu; retracted (by us
                    # OR a thief, exclusively) at dequeue
                    self._lease.publish_admission(req.uid)
            except BaseException:
                self._q.abort(tenant)  # reservation never became queued
                try:
                    # OUR journal intent may have landed before the
                    # failure (e.g. the admission-marker write died): a
                    # surviving live-looking record would 409 every
                    # future resubmit.  Clear ONLY a record carrying
                    # this incarnation — when journal_set itself failed,
                    # the surviving record is a PREDECESSOR's (a dead
                    # replica's checkpointed orphan, a stolen victim's
                    # intent) and destroying it would destroy the very
                    # recoverability the journal exists for.
                    raw = self.store.journal_get(req.uid)
                    if raw is not None and json.loads(raw).get(
                            "incarnation") == self.incarnation:
                        self.store.journal_clear(req.uid)
                except Exception:
                    pass
                if self._lease is not None and fresh_lease:
                    self._lease.release(req.uid)
                raise
        try:
            # priority rides the control entry so the fusion broker's
            # window rule sees the admission class at dispatch time
            ctl = jobctl.register(req.uid, deadline_s, priority=priority)
            # tenant too: the fsm_job_*_seconds SLO label at finish
            ctl.tenant = tenant
            if self._lease is not None:
                # heartbeat-detected lease loss self-fences the job at
                # its next safe point via this control entry
                self._lease.attach(req.uid, ctl)
            self.store.add_status(req.uid, Status.STARTED)
            self.store.incr("fsm:metric:jobs_submitted")
            log_event("job_submitted", uid=req.uid,
                      algorithm=req.param("algorithm", "SPADE_TPU"),
                      source=req.param("source", "FILE"),
                      priority=priority)
            # the flight-recorder trace opens AT SUBMIT (handler thread):
            # the queue wait before a worker picks the job up is part of
            # the job's story under load.  The admission lifecycle mark
            # flushes to the durable spine immediately — admission is
            # the one event a failover timeline cannot reconstruct from
            # anywhere else once the admitting replica is dead.
            obs.trace_begin(req.uid,
                            algorithm=req.param("algorithm", "SPADE_TPU"),
                            source=req.param("source", "FILE"))
            obs.lifecycle(req.uid, "admitted", priority=priority,
                          replica=(self._lease.replica_id
                                   if self._lease is not None else None))
            obs.flush_trace(req.uid)
            with self._stop_lock:
                if not self._stopping:
                    if self._rescache is not None:
                        # promote the prospective coalescing leader
                        # strictly BEFORE the enqueue: a follower may
                        # attach the instant the key is visible, and
                        # the worker that will run this request is
                        # guaranteed to fan out (or re-dispatch) it
                        self._rescache.leader_admitted(req.uid)
                    # enqueued strictly BEFORE the sentinels (the lock
                    # orders us against shutdown), so a worker will
                    # dequeue it: either it runs, or the drain check
                    # gives it a durable failure
                    self._q.put(req, priority, tenant)
                    if self._fair is not None:
                        fairness.note_admitted(tenant)
                    enqueued = True
        except BaseException:
            # the submit died between its journal intent and its
            # enqueue: settle the intent (a live-looking record would
            # 409 every future resubmit of this uid) and drop the
            # control entry — best-effort, the store may be the thing
            # that just failed
            try:
                self.store.journal_clear(req.uid)
            except Exception:
                pass
            if self._lease is not None:
                try:
                    self._lease.retract_admission(req.uid)
                except Exception:
                    pass
                self._lease.release(req.uid)
            jobctl.release(req.uid)
            raise
        finally:
            if not enqueued:
                self._q.abort(tenant)  # reservation never became queued
        if enqueued:
            # lifetime admission counter (heartbeat-piggybacked as
            # "adm"): the autoscaler's predictive rate-derivative
            # signal differentiates the fleet SUM of these; locked —
            # concurrent submit threads racing a bare += lose counts
            # under exactly the burst load the signal exists to see
            with self._running_lock:
                self._admitted += 1
        return enqueued

    def _loop(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            try:
                self._loop_one(req)
            except Exception as exc:
                # the worker thread must NEVER die: a dead worker
                # strands the whole queue behind it (jobs pinned at
                # 'started' forever, leases renewed by a heartbeat
                # that thinks they are fine).  Settle the job as a
                # durable failure (best effort — the journal intent
                # survives for recovery if even that fails) and move
                # on to the next dequeue.
                log_event("worker_loop_error", uid=req.uid,
                          error=str(exc))
                try:
                    _record_failure(self.store, req.uid, exc,
                                    keep_frontier=True,
                                    lease_mgr=self._lease,
                                    rescache=self._rescache,
                                    guard=self._guard)
                except Exception as rexc:
                    log_event("worker_loop_settle_failed", uid=req.uid,
                              error=str(rexc))

    def _loop_one(self, req: ServiceRequest) -> None:
        ctl0 = jobctl.get(req.uid)
        if self._lease is not None and not (
                ctl0 is not None and ctl0.ephemeral):
            try:
                claimed = self._lease.retract_admission(req.uid)
            except Exception as exc:
                g = self._guard
                if g is not None and g.note_error(exc):
                    # store outage at dequeue: defer the marker
                    # retraction into the spool and run the job —
                    # a post-heal thief racing the replayed DEL
                    # loses either way: whoever loses the arbiter
                    # is fenced by token, never double-commits
                    self._lease.retract_admission_deferred(req.uid, g)
                    claimed = True
                else:
                    # UNPROVEN blip (store answered the probe, or
                    # no guard): run the job anyway — if a thief
                    # actually won the marker, the fencing token
                    # refuses the loser's commits; wasting one
                    # mine beats stranding the queue.  The marker is
                    # retried at release and on each heartbeat, so no
                    # phantom entry is left for a steal scan
                    # (ROADMAP Queue C 10)
                    log_event("retract_admission_failed",
                              uid=req.uid, error=str(exc))
                    self._lease.note_unretracted(req.uid)
                    # a thief that won the DEL overwrites the lease: its
                    # token on the store means the job is its (the drop
                    # below); otherwise run, proving the lease on the
                    # store at every fence, a failure's included, as a
                    # thief may still claim the marker (ROADMAP Queue
                    # C 12)
                    self._lease.distrust(req.uid)
                    claimed = self._lease.held_by_us(req.uid) is not False
            if not claimed:
                # the admission marker is GONE: an idle peer won
                # the atomic DEL claim and owns the job (lease +
                # journal) now — drop it silently; running it here
                # would be the double-execution the two-phase claim
                # exists to prevent (release OUR control object by
                # identity — the uid may already map to the thief's
                # live entry in-process)
                ctl = self._lease.attached_ctl(req.uid)
                self._lease.stolen_from_us(req.uid)
                jobctl.release_entry(ctl)
                if self._rescache is not None:
                    # the thief runs (and fans out) elsewhere: local
                    # followers re-dispatch as cold mines
                    self._rescache.on_leader_terminal(req.uid)
                return
        if self._stopping:
            # draining: do NOT start queued backlog jobs — give each a
            # durable failure status (visible through /status) instead
            # of leaving it "started" forever or dying with the process
            # (keep_frontier: a drained checkpointed job's persisted
            # progress stays resumable after the restart)
            _record_failure(self.store, req.uid,
                            RuntimeError("service shutting down"),
                            keep_frontier=True, lease_mgr=self._lease,
                            rescache=self._rescache, guard=self._guard)
            return
        ctl = jobctl.get(req.uid)
        try:
            # a deadline spent ENTIRELY on queue wait (or a cancel
            # that landed while queued) aborts before any work
            jobctl.check_entry(ctl)
        except jobctl.JobAborted as exc:
            _record_failure(self.store, req.uid, exc,
                            keep_frontier=True, lease_mgr=self._lease,
                            rescache=self._rescache, guard=self._guard)
            return
        # Clear again at run start: with a reused uid, an EARLIER job
        # with the same uid may have written its error/results after
        # submit()'s clear (it was still queued/running then).  The
        # last job to *start* owns the uid's keys from here on.
        try:
            self.store.clear_job(req.uid, keep_status_log=True,
                                 keep_frontier=_checkpoint_requested(req))
        except Exception as exc:
            g = self._guard
            if g is None or not g.note_error(exc):
                raise
            # store outage: the clear is cosmetic for a FRESH uid
            # (this run's writes overwrite the live keys anyway) —
            # skipping it beats failing the job, and the log line
            # flags the one visible residue (a reused uid's stale
            # error key may shadow through /status until then)
            log_event("job_clear_skipped_outage", uid=req.uid)
        try:
            retries = int(req.param(
                "retries",
                str(config.get_config().service.job_retries)))
        except ValueError as exc:  # malformed param: fail like any
            _record_failure(self.store, req.uid, exc,  # other bad param
                            lease_mgr=self._lease,
                            rescache=self._rescache, guard=self._guard)
            return
        with self._running_lock:
            self._running += 1
        try:
            self._attempts(req, ctl, retries)
        finally:
            with self._running_lock:
                self._running -= 1

    def _attempts(self, req: ServiceRequest, ctl, retries: int) -> None:
        attempt = 0
        while True:
            try:
                # re-checked between attempts too: a deadline that
                # expired during a failed attempt must not buy a
                # retry it can never finish
                jobctl.check_entry(ctl)
                with jobctl.activate(ctl):
                    self._run(req)
                break
            except jobctl.JobAborted as exc:
                # TERMINAL, never retried: durable failure whose error
                # text leads with CANCELLED/DEADLINE_EXCEEDED/
                # LEASE_LOST.  The frontier survives: progress an abort
                # cut short resumes on a later checkpointed resubmit
                # (for LEASE_LOST the adopting replica is already
                # resuming it — the fenced _record_failure writes
                # nothing there)
                _record_failure(self.store, req.uid, exc,
                                keep_frontier=True, lease_mgr=self._lease,
                                rescache=self._rescache, guard=self._guard)
                break
            except ValueError as exc:  # bad params / bad source: the
                # failure is deterministic (SourceError included) — a
                # re-run would just repeat it, so fail immediately
                _record_failure(self.store, req.uid, exc,
                                lease_mgr=self._lease,
                                rescache=self._rescache, guard=self._guard)
                break
            except Exception as exc:  # supervision: retry, then failure
                attempt += 1
                if attempt > max(0, retries):
                    _record_failure(self.store, req.uid, exc,
                                    lease_mgr=self._lease,
                                    rescache=self._rescache,
                                    guard=self._guard)
                    break
                try:
                    self.store.incr("fsm:metric:jobs_retried")
                except Exception:
                    pass  # counter only; a down store must not veto a retry
                log_event("job_retry", uid=req.uid, attempt=attempt,
                          error=str(exc))
                with obs.span("job.retry", trace_id=req.uid,
                              attempt=attempt, error=str(exc)):
                    pass

    def _run(self, req: ServiceRequest) -> None:
        # the job's root flight-recorder span: every engine/planner/IO
        # span below threads under it via the contextvar — no plumbing
        try:
            with obs.trace(req.uid, site="job",
                           algorithm=req.param("algorithm", "SPADE_TPU"),
                           source=req.param("source", "FILE")) as job_sp:
                self._run_traced(req, job_sp)
        finally:
            # the root span closes on trace exit, AFTER the terminal
            # flush inside — push it too, so the spine's last chunk
            # carries the job's whole-wall span (post-release, so it
            # lands unfenced: the uid was settled by this replica)
            obs.flush_trace(req.uid)

    def _run_traced(self, req: ServiceRequest, job_sp) -> None:
        t0 = time.perf_counter()
        ctl = jobctl.current()
        # first-pickup lifecycle mark with the measured queue wait —
        # the observation point the per-priority SLO split reads
        obs.lifecycle(req.uid, "started",
                      queue_wait_s=(
                          None if ctl is None or ctl.started_t is None
                          else round(ctl.started_t - ctl.submitted_t, 6)))
        with obs.span("job.dataset"):
            db = sources.get_db(req, self.store)
        # coarse safe point shared by every algorithm: a cancel/deadline
        # that landed during the dataset build aborts before the mine
        # (the engines' own launch-boundary checks take over from here);
        # the lease fence rides the same boundary — a job whose lease
        # lapsed during a long dataset build self-fences before mining
        jobctl.check()
        g = self._guard
        gate = ("none" if ctl is not None and ctl.ephemeral else None)
        if self._lease is not None and (g is None
                                        or not g.skip_fence(req.uid)):
            # the fence is skipped only during a PROVEN outage — the
            # spool's replay gate re-proves the token before any
            # deferred write lands (docs/DESIGN.md "Spool replay"), and
            # a write that lands directly once the store is back proves
            # the lease first (ROADMAP Queue C 13)
            self._lease.fence(req.uid)
        if self._rescache is not None:
            # content-addressed dataset fingerprint, once per load:
            # stamped on the control entry (the cache-entry key) and
            # learned into the stable-source map (never raises)
            self._rescache.note_dataset(req, db, ctl)
        if g is None:
            self.store.add_status(req.uid, Status.DATASET)
        else:
            g.status(req.uid, Status.DATASET, gate=gate)
        plugin = plugins.get_plugin(req)
        if plugin.name != "AUTO":
            # fsm_engine_selected_total counts the engine that actually
            # mines; AUTO bumps its RESOLVED engine inside the planner
            planner.count_selected(plugin.name)
        stats: Dict[str, object] = {
            "algorithm": plugin.name,
            "sequences": len(db),
            "dataset_s": round(time.perf_counter() - t0, 4),
        }
        job_sp.set(algorithm=plugin.name, sequences=len(db))
        ckpt: Optional[StoreCheckpoint] = None
        if _checkpoint_requested(req):
            ckpt = StoreCheckpoint(
                self.store, req.uid,
                every_s=float(req.param("checkpoint_every_s", "30")),
                lease_mgr=self._lease, guard=self._guard)
        trace_dir = _profile_dir(req, req.uid)
        t1 = time.perf_counter()
        with profile_trace(trace_dir), obs.span("job.mine"):
            results = plugin.extract(req, db, stats, checkpoint=ckpt)
        mine_s = time.perf_counter() - t1
        stats["mine_s"] = round(mine_s, 4)
        stats["results"] = len(results)
        stats["results_per_s"] = round(len(results) / mine_s, 2) if mine_s else 0.0
        if trace_dir:
            stats["profile_trace"] = trace_dir
        # settle the job's device-cost accumulator BEFORE the stats
        # write: the usage block rides fsm:stats:{uid} AND (via
        # rescache.on_finished below) the cache entry, which is what
        # prices a future serve's avoided-cost credit
        u = usage.settle(req.uid)
        if u:
            stats["usage"] = u
        with obs.span("job.sink", results=len(results)):
            outage = g is not None and g.skip_fence(req.uid)
            if self._lease is not None and not outage:
                # the split-brain gate: a stale holder that somehow
                # mined to completion (expired mid-run, adopter already
                # re-running) must NOT commit its result set over the
                # adopter's — raises JobLeaseLost, terminal, fenced.
                # During a PROVEN outage the same gate moves to the
                # spool replay (the journal-gated NX reacquire) —
                # refused there, these writes are dropped
                # and counted, never committed over the adopter's
                self._lease.fence(req.uid)
            if g is None:
                self.store.set(f"fsm:stats:{req.uid}", json.dumps(stats))
                _sink_results(self.store, req.uid, plugin.kind, results)
                self.store.add_status(req.uid, Status.TRAINED)
                self.store.add_status(req.uid, Status.FINISHED)
            else:
                g.set(req.uid, f"fsm:stats:{req.uid}", json.dumps(stats),
                      gate=gate)
                _sink_results(self.store, req.uid, plugin.kind, results,
                              guard=g, gate=gate)
                g.status(req.uid, Status.TRAINED, gate=gate)
                g.status(req.uid, Status.FINISHED, gate=gate)
        if self._rescache is not None:
            # result-reuse tier: publish the cache entry and fan the
            # durable result out to coalesced followers — while the
            # leader's lease is STILL HELD, so both ride the fenced
            # write path; never raises (the job is already green)
            self._rescache.on_finished(req, ctl, plugin, results, stats)
        if ckpt is not None:
            # only AFTER the results are durable: a sink failure retried
            # mid-way must resume from the final frontier, not re-mine.
            # Best-effort — the job has already succeeded, and a cleanup
            # hiccup must not fail/re-run it (uid reuse reclaims the keys).
            try:
                ckpt.clear()
            except Exception as exc:
                log_event("frontier_clear_failed", uid=req.uid,
                          error=str(exc))
        # FINISHED is terminal: settle the journal intent and release
        # the job-control entry (order matters — the terminal status is
        # already durable, so a crash right here leaves an orphan whose
        # recovery pass sees 'finished' and just clears the journal).
        # Ephemeral jobs never wrote a journal intent — nothing to clear.
        if ctl is None or not ctl.ephemeral:
            if g is None:
                self.store.journal_clear(req.uid)
            else:
                g.delete(req.uid, f"fsm:journal:{req.uid}", gate=gate)
        jobctl.release(req.uid)
        # SLO accounting (submit -> durable result, per priority and
        # tenant) + the settled lifecycle mark, flushed to the spine
        # while the lease is STILL HELD so the final chunk rides the
        # fenced write path
        if ctl is not None:
            now_m = time.monotonic()
            e2e_s = now_m - ctl.submitted_t
            queue_wait_s = max(0.0, (ctl.started_t or now_m)
                               - ctl.submitted_t)
            obsplane.observe_job(ctl.priority, e2e_s, queue_wait_s,
                                 max(0.0, e2e_s - queue_wait_s),
                                 tenant=ctl.tenant)
        obs.lifecycle(req.uid, "settled", outcome="finished")
        obs.flush_trace(req.uid)
        if self._lease is not None:
            self._lease.release(req.uid)
        if g is None:
            self.store.incr("fsm:metric:jobs_finished")
        else:
            g.incr(req.uid, "fsm:metric:jobs_finished", gate=gate)
        self._observe_wall(time.perf_counter() - t0)
        log_event("job_finished", uid=req.uid, **stats)

    def shutdown(self, join_timeout_s: float = 30.0) -> None:
        """Drain: workers finish their CURRENT job only — queued backlog
        jobs get a durable "service shutting down" failure status instead
        of starting (the ``_stopping`` flag), and the threads are joined
        against ONE shared deadline so shutdown wall time is bounded by
        ``join_timeout_s`` total, not per worker.  A job outrunning the
        deadline is abandoned loudly (logged; daemon threads die with the
        process; a checkpointed job resumes on restart — the
        torn-snapshot-safe StoreCheckpoint contract).  Backlog jobs are
        drained BEFORE the sentinels surface (AdmissionQueue.get), so
        every queued job's durable failure lands and its journal entry
        clears; submits racing the drain still shed with 429 when the
        queue is full, or land the durable failure when it is not."""
        if self._lease is not None:
            # BEFORE the drain: no new work may be pulled in (a steal
            # or periodic adoption landing now would meet the drain and
            # get a bogus durable failure); renewals keep running so
            # the draining jobs stay fenced-safe to their end
            self._lease.quiesce()
        with self._stop_lock:
            self._stopping = True
            for _ in self._threads:
                self._q.put_sentinel()
        deadline = time.monotonic() + join_timeout_s
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                log_event("shutdown_abandoned_worker", thread=t.name)
        if self._lease is not None:
            # after the drain: every backlog job has settled (and
            # released its lease); stop the heartbeat and retract the
            # replica record so peers adopt anything left promptly
            self._lease.stop()
        if (self._integrity is not None
                and integrity.get() is self._integrity):
            # stop OUR scrubber only — a later Miner's install owns the
            # module-global slot now (last-wins, same as obsplane)
            self._integrity.stop()
        if self._guard is not None:
            self._guard.stop()
            if storeguard.get() is self._guard:
                storeguard.uninstall()


class Questor:
    """Query worker: serve mined patterns/rules from the store.

    Supports the reference's rule-filtering queries for prediction
    (SURVEY.md sec 3.2): 'antecedent'/'consequent' params restrict rules
    to those whose side intersects the given items, and
    ``/get/prediction?items=...`` returns ranked next-item candidates
    (best rule per item, confidence-ordered).
    """

    def __init__(self, store: ResultStore) -> None:
        self.store = store

    def handle(self, req: ServiceRequest, subject: str) -> ServiceResponse:
        uid = req.uid
        status = self.store.status(uid)
        if status is None:
            return model.response(req, Status.FAILURE, error="unknown uid")
        if status != Status.FINISHED:
            return model.response(req, status,
                                  error="job not finished; results pending")
        if subject == "patterns":
            payload = self.store.patterns(uid)
            if payload is None:
                return model.response(req, Status.FAILURE, error="no patterns")
            return model.response(req, Status.FINISHED, patterns=payload)
        if subject == "rules":
            payload = self.store.rules(uid)
            if payload is None:
                return model.response(req, Status.FAILURE, error="no rules")
            rules = model.deserialize_rules(payload)
            ante = req.param("antecedent")
            cons = req.param("consequent")
            if ante:
                want = {int(i) for i in ante.split(",")}
                rules = [r for r in rules if want & set(r[0])]
            if cons:
                want = {int(i) for i in cons.split(",")}
                rules = [r for r in rules if want & set(r[1])]
            return model.response(req, Status.FINISHED,
                                  rules=model.serialize_rules(rules))
        if subject == "prediction":
            # Next-item prediction (SURVEY.md sec 3.2): rules whose
            # antecedent is CONTAINED in the observed item set vote for
            # their consequent items; each candidate keeps its best rule
            # (confidence first, support as tie-break) and items already
            # observed are excluded.  This is the ranked form of the
            # antecedent filter above — the reference ecosystem's use of
            # mined rules.
            payload = self.store.rules(uid)
            if payload is None:
                return model.response(req, Status.FAILURE, error="no rules")
            items_param = req.param("items")
            if not items_param:
                return model.response(
                    req, Status.FAILURE,
                    error="prediction needs 'items' (comma-separated item "
                          "ids observed so far)")
            try:
                have = {int(i) for i in items_param.split(",")}
            except ValueError:
                return model.response(
                    req, Status.FAILURE,
                    error=f"bad 'items' value {items_param!r}")
            best: Dict[int, tuple] = {}
            for x, y, sup, supx in model.deserialize_rules(payload):
                if supx <= 0 or not set(x) <= have:
                    continue
                conf = sup / supx
                for it in y:
                    if it in have:
                        continue
                    cur = best.get(it)
                    if cur is None or (conf, sup) > (cur[0], cur[1]):
                        best[it] = (conf, sup, supx, x, y)
            ranked = sorted(best.items(),
                            key=lambda kv: (-kv[1][0], -kv[1][1], kv[0]))
            # entry shape mirrors serialize_rules (exact sup/supx kept
            # integral, confidence the same float division) so a
            # prediction cross-references its /get/rules entry exactly
            return model.response(
                req, Status.FINISHED, predictions=json.dumps([
                    {"item": it, "confidence": conf, "support": sup,
                     "antecedent_support": supx,
                     "antecedent": list(x), "consequent": list(y)}
                    for it, (conf, sup, supx, x, y) in ranked]))
        return model.response(req, Status.FAILURE,
                              error=f"unknown subject {subject!r}")


class Tracker:
    """Ingest worker: /track events into the store (SURVEY.md sec 3.3).

    Validation honors the topic's registered field spec: the required
    'item' role may live under any event field name the spec maps it to.
    """

    def __init__(self, store: ResultStore) -> None:
        self.store = store

    def handle(self, req: ServiceRequest, topic: str) -> ServiceResponse:
        event = {k: v for k, v in req.data.items() if k != "uid"}
        item_field = sources.field_map(self.store, topic)["item"]
        if item_field not in event:
            return model.response(req, Status.FAILURE,
                                  error=f"missing field {item_field!r} "
                                        f"(the registered 'item' role)")
        self.store.track(topic, json.dumps(event))
        return model.response(req, Status.FINISHED)


class Registrar:
    """Field-spec registration (SURVEY.md sec 3.4)."""

    def __init__(self, store: ResultStore) -> None:
        self.store = store

    def handle(self, req: ServiceRequest, topic: str) -> ServiceResponse:
        spec = {k: v for k, v in req.data.items() if k != "uid"}
        self.store.add_fields(topic, json.dumps(spec))
        return model.response(req, Status.FINISHED)


class Streamer:
    """Streaming micro-batch worker (SURVEY.md sec 2.5, eval config #5).

    Each topic owns a sliding window of sequence micro-batches.  A push
    (``/stream/{topic}`` with an SPMF micro-batch in ``sequences``)
    appends the batch, evicts expired ones, and re-mines the window
    through the SAME AlgorithmPlugin boundary as batch train jobs — so
    SPADE/SPADE_TPU (with or without maxgap/maxwindow) and TSR all work
    incrementally.  Results land in the store under uid
    ``stream:{topic}`` with a ``finished`` status, so ``/get/patterns``
    (or ``/get/rules``) serves the window's current result set exactly
    like a batch job's.

    Window config (``support``, ``algorithm``, ``max_batches``,
    ``max_sequences``, constraints) is fixed by the first push to the
    topic; later pushes may omit it.  Relative ``support`` is recomputed
    against the *current* window size on every push.

    Window state survives restarts (SURVEY.md sec 5 checkpoint row's
    streaming half): the topic config and the window's raw micro-batch
    texts persist in the store (``fsm:stream:cfg/window:{topic}``), and a
    restarted service rebuilds the window on the topic's first touch — so
    the push after a restart mines the true window, not a truncated one.
    Mined results were already durable (``fsm:pattern:stream:{topic}``).
    """

    def __init__(self, store: ResultStore) -> None:
        self.store = store
        self._lock = threading.Lock()
        self._topics: Dict[str, dict] = {}

    def _build_state(self, data: Dict[str, str],
                     mb: Optional[int], ms: Optional[int]) -> dict:
        """Topic state from a (validated-here) config; shared by first-push
        creation and restart restore."""
        from spark_fsm_tpu_torch.streaming.window import WindowMiner

        base = ServiceRequest("fsm", "stream", data)
        # Validate the WHOLE config before caching: a bad first push must
        # not poison the topic forever.
        plugin = plugins.get_plugin(base)
        support = float(data["support"])
        for p in ("maxgap", "maxwindow", "k", "max_side"):
            if base.param(p) is not None:
                int(base.param(p))
        if base.param("minconf") is not None:
            float(base.param("minconf"))

        def plugin_mine(db, minsup_abs, _plugin=plugin, _base=base):
            # WindowMiner computes the window-relative absolute minsup;
            # hand it to the plugin as an absolute count (plugins._minsup
            # treats support >= 1 as absolute).
            d = dict(_base.data)
            d["support"] = str(int(minsup_abs))
            return _plugin.extract(
                ServiceRequest(_base.service, _base.task, d), db)

        # Streaming route: true incremental mining (count the arriving
        # batch + border repair — streaming/incremental.py) is the
        # default for plain SPADE_TPU windows, single-device OR meshed
        # (the incremental miner shards each batch store's sequence
        # axis, SURVEY sec 2.2 x 2.5); everything else (TSR,
        # constraints, CPU oracle) re-mines the window
        # (streaming/window.py, the SURVEY sec 7 fallback).
        # ``incremental=0`` pins the re-mine path.
        algo = (data.get("algorithm") or "SPADE_TPU").upper()
        # same falsy spellings as the checkpoint param (Miner._run)
        # str() first: clients may send a JSON number/boolean and the
        # falsy-spelling contract must hold regardless of value type
        inc_param = str(data.get("incremental", "1") or "").lower()
        use_inc = (plugin.kind == "patterns"
                   and algo == "SPADE_TPU"
                   and base.param("maxgap") is None
                   and base.param("maxwindow") is None
                   and inc_param not in ("", "0", "false", "no", "off"))
        if use_inc:
            from spark_fsm_tpu_torch.streaming.incremental import \
                IncrementalWindowMiner
            # stream_seq_floor (boot [prewarm] section): pin batch-store
            # buckets to the declared steady-state size so the first
            # pushes land on prewarmed shapes instead of compiling
            # throwaway small-bucket programs
            make = dict(min_support=support, max_batches=mb,
                        max_sequences=ms,
                        seq_floor=config.get_config().prewarm.stream_seq_floor)
            miner = IncrementalWindowMiner(
                device=plugins.service_device(), mesh=config.get_mesh(),
                **make)
        else:
            make = None
            miner = WindowMiner(support, max_batches=mb, max_sequences=ms,
                                mine=plugin_mine,
                                device=plugins.service_device())

        return {
            "miner": miner,
            # the incremental miner's arguments: on a world of ranks each
            # push is a mesh call, and a follower makes its miner alike
            "make": make,
            "kind": plugin.kind,
            "cfg": {"data": data, "max_batches": mb, "max_sequences": ms},
            # held across push + result sink + response-field reads
            # so concurrent pushes cannot sink an older window's
            # results over a newer one's (push alone is serialized
            # inside WindowMiner, but the store write is not)
            "lock": threading.Lock(),
        }

    def _restore(self, topic: str) -> Optional[dict]:
        """Rebuild a topic from its persisted config + window batches."""
        from spark_fsm_tpu_torch.data.spmf import parse_spmf

        raw = self.store.get(f"fsm:stream:cfg:{topic}")
        if not raw:
            return None
        cfg = json.loads(raw)
        state = self._build_state(cfg["data"], cfg["max_batches"],
                                  cfg["max_sequences"])
        window = state["miner"].window
        win_key = f"fsm:stream:window:{topic}"
        try:
            texts = self.store.lrange(win_key)
        except Exception:  # real Redis: WRONGTYPE on a pre-delta-format key
            texts = []
        if not texts:
            raw = None
            try:
                raw = self.store.get(win_key)
            except Exception:
                pass
            if raw:  # migrate the old whole-window-JSON format in place
                try:
                    texts = json.loads(raw)
                except ValueError:
                    texts = []
                if not (isinstance(texts, list)
                        and all(isinstance(t, str) for t in texts)):
                    texts = []  # corrupt old value: start a fresh window
                self.store.delete(win_key)
                for t in texts:
                    self.store.rpush(win_key, t)
        for text in texts:
            # refill WITHOUT re-mining: results are already durable, and
            # the next push re-mines the full window anyway.  Replaying
            # through push() re-applies the eviction caps, so even a
            # persisted list with stale head entries (a crash between the
            # append and its trim) converges to the correct window.
            window.push(parse_spmf(text))
        # a follower refills its miner alike at the first mesh-call push
        state["refill"] = list(texts)
        sraw = self.store.get(f"fsm:stats:stream:{topic}")
        if sraw:
            # cumulative counters survive the restart; the refill pushes
            # above must not inflate them
            prev = json.loads(sraw)
            for key in ("pushes", "mines", "evicted_batches"):
                if key in prev:
                    state["miner"].stats[key] = int(prev[key])
            window.pushed_batches = int(prev.get("pushes",
                                                 window.pushed_batches))
            window.evicted_batches = int(prev.get("evicted_batches",
                                                  window.evicted_batches))
        log_event("stream_topic_restored", topic=topic,
                  batches=window.n_batches, sequences=window.n_sequences)
        return state

    def _topic_state(self, req: ServiceRequest, topic: str) -> dict:
        with self._lock:
            state = self._topics.get(topic)
            if state is None:
                state = self._restore(topic)
            if state is None:
                mb = req.param("max_batches")
                ms = req.param("max_sequences")
                if mb is None and ms is None:
                    mb = "4"
                # the cached base request keeps only mining params — never
                # the first micro-batch's payload
                data = {k: v for k, v in req.data.items()
                        if k not in ("sequences", "uid")}
                data.setdefault("algorithm", "SPADE_TPU")
                data.setdefault("support", "0.1")
                state = self._build_state(
                    data,
                    int(mb) if mb is not None else None,
                    int(ms) if ms is not None else None)
                self.store.set(f"fsm:stream:cfg:{topic}",
                               json.dumps(state["cfg"]))
            self._topics[topic] = state
            return state

    def handle(self, req: ServiceRequest, topic: str) -> ServiceResponse:
        from spark_fsm_tpu_torch.data.spmf import parse_spmf

        if not topic:
            return model.response(req, Status.FAILURE,
                                  error="stream needs a topic: /stream/{topic}")
        text = req.param("sequences")
        if text is None:
            return model.response(req, Status.FAILURE,
                                  error="stream push needs a 'sequences' "
                                        "parameter (SPMF micro-batch)")
        try:
            batch = parse_spmf(text)
            if not batch:
                raise ValueError("empty micro-batch: 'sequences' parsed to "
                                 "zero sequences")
            state = self._topic_state(req, topic)
        except ValueError as exc:
            # config/parse rejections count as stream failures too, so
            # /admin/stats reflects every failed push
            self.store.incr("fsm:metric:stream_failures")
            return model.response(req, Status.FAILURE, error=str(exc))
        uid = f"stream:{topic}"
        miner = state["miner"]
        win_key = f"fsm:stream:window:{topic}"
        # one flight-recorder trace per topic (uid "stream:{topic}"),
        # a root span per push: the window re-mine's engine spans
        # thread under it exactly like a batch job's
        with state["lock"], obs.trace(uid, site="stream.push",
                                      topic=topic, sequences=len(batch)):
            try:
                try:
                    if state["make"] is None:
                        results = miner.push(batch)
                    else:
                        results = meshcall.stream_push(
                            topic, miner, text, batch, state["make"],
                            state.pop("refill", []))
                finally:
                    # persist the DELTA (append the batch, trim evictions to
                    # the live batch count) — the window mutates before the
                    # mine runs, so this happens even for a failed mine, or
                    # a restart would restore a window diverged from the
                    # live one.  Cost is O(batch), not O(window).
                    self.store.rpush(win_key, text)
                    while self.store.llen(win_key) > miner.window.n_batches:
                        self.store.lpop(win_key)
                # a prior failed push's error must not shadow this success
                # in /status (the batch path clears via clear_job)
                self.store.delete(f"fsm:error:{uid}")
                _sink_results(self.store, uid, state["kind"], results)
                self.store.set(f"fsm:stats:{uid}", json.dumps(miner.stats))
                self.store.add_status(uid, Status.FINISHED)
                self.store.incr("fsm:metric:stream_pushes")
            except Exception as exc:
                _record_failure(self.store, uid, exc,
                                metric="stream_failures")
                return model.response(req, Status.FAILURE, error=str(exc))
            window = miner.window
            return model.response(
                req, Status.FINISHED, uid=uid,
                window_batches=str(window.n_batches),
                window_sequences=str(window.n_sequences),
                evicted_batches=str(miner.stats["evicted_batches"]),
                results=str(len(results)))


def _jobs_collector(store: ResultStore):
    """Scrape-time bridge from the store's job counters to canonical
    fsm_* names — the /admin/stats ``jobs`` block keys are aliases of
    these.  A store that is down (or chaos-armed) skips its rows: the
    scrape must stay readable during the drill it is diagnosing."""
    names = ("jobs_submitted", "jobs_finished", "jobs_failed",
             "jobs_retried", "stream_pushes", "stream_failures")

    def collect():
        rows = []
        for n in names:
            try:
                # peek, not get: a scrape must never trip (or consume)
                # an armed store.get injection, or a pinned-seed chaos
                # drill goes nondeterministic under concurrent scraping
                v = int(store.peek(f"fsm:metric:{n}") or 0)
            except Exception:
                continue
            rows.append((f"fsm_{n}_total", "counter", "", [({}, v)]))
        return rows

    return collect


class Master:
    """Routes tasks to workers — the reference's FSMMaster."""

    def __init__(self, store: Optional[ResultStore] = None,
                 miner_workers: int = 1,
                 queue_depth: Optional[int] = None,
                 lease_mgr: Optional[lease.LeaseManager] = None) -> None:
        self.store = store if store is not None else ResultStore()
        # the registry keys one "jobs" collector process-wide: the last
        # Master built owns it (tests build many; the service builds one)
        obs.REGISTRY.register_collector("jobs", _jobs_collector(self.store))
        self.miner = Miner(self.store, workers=miner_workers,
                           queue_depth=queue_depth, lease_mgr=lease_mgr)
        if self.miner._lease is not None:
            # upgrade the heartbeat with the PERIODIC recovery pass:
            # a peer's crash is healed within ~one lease TTL without
            # waiting for anyone to reboot (start() is idempotent on
            # the thread; this call only installs the callback)
            self.miner._lease.start(self.miner,
                                    recover=lambda: recover_orphans(self))
        self.questor = Questor(self.store)
        # the read plane: /predict
        # compiles finished mines into device-resident rule tries and
        # micro-batches concurrent scoring into fused waves
        self.predictor = predictor.Predictor(
            self.store, device=plugins.service_device())
        self.tracker = Tracker(self.store)
        self.registrar = Registrar(self.store)
        self.streamer = Streamer(self.store)
        # elastic control plane: one
        # controller per replica, leader-elected over the store; None
        # unless [autoscale] enabled (config requires [cluster] too)
        self.autoscaler = autoscale.build_for(self.miner)
        if self.autoscaler is not None:
            self.autoscaler.start()

    def cancel(self, uid: str) -> Optional[str]:
        """Cancel a live job (``/admin/cancel/{uid}``): returns what it
        was doing ("queued"/"running") or None when no live job owns the
        uid.  A RUNNING job aborts at its next safe point; a QUEUED job
        is settled immediately — its admission slot returns to the pool
        now instead of when a worker reaches the dead work."""
        state = jobctl.cancel(uid)
        if state is not None:
            log_event("job_cancel_requested", uid=uid, was=state)
        if state == "queued":
            self.miner.settle_cancelled_queued(uid)
        return state

    def handle(self, req: ServiceRequest) -> ServiceResponse:
        task, _, subject = req.task.partition(":")
        if task == "train":
            if not req.uid:
                req.data["uid"] = ServiceRequest.fresh_uid()
            try:  # validate algorithm/source names before going async
                plugins.get_plugin(req)
                src = (req.param("source") or "FILE").upper()
                if src not in sources.SOURCES:
                    raise ValueError(f"unknown source {src!r}")
                extras = self.miner.submit(req) or {}
            except plugins.UnknownAlgorithm as exc:
                # structured 400 BEFORE anything went async: the body
                # names the supported registry (derived from the
                # planner's view of plugins.ALGORITHMS, never a
                # docstring), so a client typo is one round trip to fix
                # instead of a failure buried deep in dispatch
                return model.response(
                    req, Status.FAILURE, error=str(exc),
                    http_status="400",
                    supported=json.dumps(exc.supported))
            except AdmissionShed as exc:
                # overload shed: protocol-mapped to 429 + Retry-After by
                # the HTTP layer (remote clients read retry_after_s).
                # In cluster mode the body carries the same cached peer
                # view the Retry-After hint consulted, so the client can
                # see whether the hint means "steal path" or "local
                # EWMA" (docs/OPERATIONS.md).
                extra: Dict[str, str] = {}
                if self.miner._lease is not None:
                    try:
                        extra["cluster"] = json.dumps(
                            self.miner._lease.shed_view())
                    except Exception:
                        pass
                return model.response(req, Status.FAILURE, error=str(exc),
                                      http_status="429",
                                      retry_after_s=str(exc.retry_after_s),
                                      **extra)
            except UidConflict as exc:
                return model.response(req, Status.FAILURE, error=str(exc),
                                      http_status="409")
            except lease.LeaseUnavailable as exc:
                # the lease protocol itself failed (store down, injected
                # lease.acquire fault): the submit cannot be made safe —
                # clean 503 with zero store trace of the uid
                return model.response(req, Status.FAILURE, error=str(exc),
                                      http_status="503")
            except (ValueError, faults.FaultInjected) as exc:
                # bad submit params, or a chaos-armed admission/journal
                # site: a clean synchronous failure envelope either way
                return model.response(req, Status.FAILURE, error=str(exc))
            # extras: e.g. ephemeral="1" — the LOUD no-journal flag a
            # store-outage admission carries ([storeguard])
            return model.response(req, Status.STARTED, **extras)
        if task == "status":
            status = self.store.status(req.uid)
            if status is None:
                return model.response(req, Status.FAILURE, error="unknown uid")
            extra: Dict[str, str] = {}
            error = self.store.get(f"fsm:error:{req.uid}")
            if error:
                extra["error"] = error
            stats = self.store.get(f"fsm:stats:{req.uid}")
            if stats:  # engine + timing counters (SURVEY.md sec 5 metrics)
                extra["stats"] = stats
            return model.response(req, status, **extra)
        if task == "get":
            return self.questor.handle(req, subject or "patterns")
        if task == "predict":
            return self.predictor.handle(req)
        if task == "track":
            return self.tracker.handle(req, subject or "item")
        if task == "stream":
            return self.streamer.handle(req, subject)
        if task in ("register", "index"):
            return self.registrar.handle(req, subject or "item")
        return model.response(req, Status.FAILURE,
                              error=f"unknown task {req.task!r}")

    def shutdown(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.predictor.shutdown()
        self.miner.shutdown()


_RECOVERY_TOTAL = obs.REGISTRY.counter(
    "fsm_recovery_jobs_total",
    "journal orphans handled by the boot recovery pass, by outcome")
# zero-seed the outcome vocabulary (obs_smoke's no-orphan contract):
# "quarantined" is the earlier poison-intent report bucket; "corrupt"
# counts the same records once they ALSO settle as durable failures
for _outcome in ("cleared", "resumed", "failed", "quarantined", "corrupt"):
    _RECOVERY_TOTAL.seed(outcome=_outcome)
del _outcome


def recover_orphans(master: Master) -> Dict[str, List[str]]:
    """Boot-time crash-restart recovery (service/app.py runs this before
    accepting traffic): heal every journal intent record left by a DEAD
    incarnation.

    - already-terminal orphan (the crash hit between the terminal status
      write and the journal clear): settle the journal — ``cleared``;
    - checkpointed orphan: resubmit the journaled request through the
      normal admission path; the mine resumes from its persisted
      frontier (zero duplicated results — the fingerprint check restarts
      fresh if the data changed) — ``resumed``;
    - anything else: durable ``failure: interrupted by restart`` so no
      client ever polls a forever-pending uid — ``failed``.

    MULTI-REPLICA (``[cluster] enabled``): liveness is proven by the
    JOB LEASE, not inferred from the incarnation tag — a foreign
    journal entry is an orphan ONLY once its lease has expired, and
    adoption itself is an atomic NX re-acquisition, so N replicas may
    run this pass concurrently (boot + periodic) and each orphan is
    adopted exactly once.  Without the lease layer the earlier work
    single-writer assumption still holds: exactly ONE service instance
    may own a store, because a sibling's live jobs would read as dead
    orphans here (docs/OPERATIONS.md states the same constraint).
    """
    store, miner = master.store, master.miner
    mgr = miner._lease
    report: Dict[str, List[str]] = {"resumed": [], "failed": [],
                                    "cleared": [], "quarantined": []}
    for uid in store.journal_uids():
        raw = store.journal_get(uid)
        if not raw:
            continue  # settled between the scan and this read
        try:
            entry = json.loads(raw)
            if not isinstance(entry, dict):
                raise ValueError("journal intent must be an object")
        except ValueError:
            # poison intent (bitrot or a torn write — journal_get hands
            # back the RAW bytes on a failed envelope so this parse
            # fails): move it to fsm:quarantine:{uid} and keep
            # recovering the REMAINING orphans — one bad record must
            # not wedge boot recovery for every other job.
            # An undecodable intent can never be resumed, so the uid
            # ALSO settles as a durable failure (lease-fenced: a live
            # holder elsewhere keeps settling rights) — no client polls
            # a forever-pending uid whose intent rotted.
            integrity.quarantine(store, f"fsm:journal:{uid}", raw,
                                 "journal", move=True)
            if ((mgr is None or mgr.adopt_expired(uid))
                    and store.status(uid) not in (Status.FINISHED,
                                                  Status.FAILURE)):
                _record_failure(
                    store, uid,
                    RuntimeError("journal intent corrupt (quarantined "
                                 f"at fsm:quarantine:{uid}); re-submit "
                                 "to re-mine"),
                    keep_frontier=True, lease_mgr=mgr,
                    rescache=miner._rescache, guard=miner._guard)
            report["quarantined"].append(uid)
            _RECOVERY_TOTAL.inc(outcome="corrupt")
            log_event("restart_recovery_quarantined", uid=uid)
            continue
        if entry.get("incarnation") == miner.incarnation:
            continue  # live in THIS incarnation (a concurrent submit)
        if mgr is not None and not mgr.adopt_expired(uid):
            continue  # lease still live on a replica (the job is merely
            # running/queued elsewhere), or a sibling recovery pass won
            # the adoption race — either way: not ours to touch
        if mgr is not None and entry.get("replica"):
            # reap the dead replica's admission marker for this uid —
            # markers have no TTL (a TTL'd marker would make the
            # victim's dequeue misread an expiry as a steal), so
            # adoption is where a crashed replica's markers get
            # collected instead of leaking forever
            try:
                store.delete(f"fsm:admission:{entry['replica']}:{uid}")
            except Exception:
                pass
        status = store.status(uid)
        if status in (Status.FINISHED, Status.FAILURE):
            store.journal_clear(uid)
            if mgr is not None:
                mgr.release(uid)
            report["cleared"].append(uid)
            _RECOVERY_TOTAL.inc(outcome="cleared")
            continue
        # failover latency candidate, measured BEFORE the resubmit (the
        # resubmit's own spine flush would reset the reference): the
        # dead owner's last provable sign of life (its final spine
        # flush; journal intent ts when it never flushed) to now.
        # Bounded by lease_ttl_s + recover_every_s (+ the owner's flush
        # cadence) on a healthy cluster — replica_smoke asserts it.
        # Observed into the histogram only on a SUCCESSFUL adoption
        # resume below: an orphan settled as a durable failure was not
        # adopted in the sense the metric's alert contract promises.
        adoption_s = None
        if mgr is not None:
            ref_ts = obsplane.last_activity_ts(store, uid)
            if ref_ts is None:
                try:
                    ref_ts = float(entry.get("ts") or 0) or None
                except (TypeError, ValueError):
                    ref_ts = None
            if ref_ts is not None:
                adoption_s = max(0.0, time.time() - ref_ts)
        if entry.get("checkpoint"):
            # crash-loop quarantine gate ([cluster] max_adoptions): a
            # job whose every holder dies would otherwise ping-pong
            # through adoption forever.  Past the budget it settles as
            # a durable POISON: terminal + fsm:quarantine:{uid} record
            # (409 on resubmit until /admin/quarantine releases it).
            if not miner.adopt_or_poison(uid, entry, raw=raw):
                report["failed"].append(uid)
                _RECOVERY_TOTAL.inc(outcome="failed")
                log_event("restart_recovery_poisoned", uid=uid)
                continue
            req = ServiceRequest("fsm", "train", {
                str(k): str(v) for k, v in entry.get("request", {}).items()})
            try:
                miner.submit(req)
                report["resumed"].append(uid)
                _RECOVERY_TOTAL.inc(outcome="resumed")
                log_event("restart_recovery_resumed", uid=uid)
                if mgr is not None:
                    if adoption_s is not None:
                        obsplane.observe_adoption(adoption_s)
                    # the resubmit re-opened the trace ring: stamp the
                    # adoption onto the spine so the merged timeline
                    # shows owner-death -> adoption in one place
                    obs.lifecycle(
                        uid, "adopted", replica=mgr.replica_id,
                        time_to_adoption_s=(
                            None if adoption_s is None
                            else round(adoption_s, 3)))
                    obs.flush_trace(uid)
                continue
            except Exception as exc:  # shed (tiny queue at boot) or a
                # store hiccup: fall through to the durable failure —
                # recovery must never leave the orphan pending (and the
                # staged adoption counter must not leak onto a future
                # fresh submit of the same uid)
                miner._adoptions_pending.pop(uid, None)
                failure = RuntimeError(
                    f"interrupted by restart; recovery resubmit failed: "
                    f"{exc}")
        else:
            failure = RuntimeError(
                "interrupted by restart (job was not checkpointed; "
                "re-submit to re-mine)")
        # keep_frontier: a recovery resubmit that shed (tiny queue at
        # boot) must not destroy the very progress it failed to resume
        _record_failure(store, uid, failure, keep_frontier=True,
                        lease_mgr=mgr, rescache=miner._rescache,
                        guard=miner._guard)
        report["failed"].append(uid)
        _RECOVERY_TOTAL.inc(outcome="failed")
    if any(report.values()):
        log_event("restart_recovery",
                  resumed=len(report["resumed"]),
                  failed=len(report["failed"]),
                  cleared=len(report["cleared"]),
                  quarantined=len(report["quarantined"]))
    return report
