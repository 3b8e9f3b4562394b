"""Store-outage survival — make a store outage a STALL,
not a failure.

Every durable artifact (journal, leases, checkpoints, result sink,
trace spine, rescache, autoscale records) lives in ONE Redis namespace,
so before this module a store blip was the single fault that degraded
correctness posture fleet-wide: running jobs terminally failed at their
next fenced write, every replica self-fenced as renewals lapsed, and
the control plane went leaderless.  This module is the guard between
the durable-write paths and that fate:

- **Health state machine** (healthy → flaky → down): driven by the
  transport-error streaks the write paths report (``note_error``) plus
  an ACTIVE probe on its own short-timeout connection
  (``store.probe``).  DOWN requires the probe's confirmation — a
  single write failure, or a store that answers the probe but errors
  on writes (sick, not gone), keeps today's conservative posture:
  raise, retry, fence.  When in doubt, fence.

- **Write-behind spool**: while DOWN, a running job's fenced writes
  (checkpoint deltas, result sink, statuses, spine chunks) append to a
  bounded per-job local spool instead of raising.  On store return the
  spool replays IN ORDER once the replay gate proves the spool's
  fencing token is still the job's: the lease still carries it, or it
  expired unclaimed and one journal-gated NX reacquire re-takes it under
  a fresh token (:meth:`~spark_fsm_tpu_torch.service.
  lease.LeaseManager.reacquire_for_spool`) — if the lease was
  legitimately taken during the outage (an adopter owns the uid now),
  the replay is REFUSED and counted, preserving the earlier work
  no-double-commit invariant verbatim (docs/DESIGN.md proves it).
  Spool overflow fences the job — the current terminal-failure path,
  never silent loss, never a partial replay accepted.

- **Outage-aware stalls**: a lease holder whose renewals fail while
  the probe proves the store unreachable PAUSES at its next jobctl
  safe point (``jobctl.stall_entry``) with the frontier kept in memory
  + spool, instead of raising terminal ``LEASE_LOST``; on store return
  it re-acquires through the journal-gated NX path and resumes.  A
  replica that cannot prove a global outage (probe says the store is
  alive) self-fences conservatively, and ``stall_max_s`` bounds how
  long optimism may run.

- **Admission during an outage** sheds 429 by default (the submit
  cannot be journaled, so it cannot be made durable); under
  ``[storeguard] ephemeral_admission`` the Miner instead admits
  loudly-flagged NO-JOURNAL jobs whose writes ride the spool ungated.

Fault sites: ``storeguard.probe`` (an injected raise IS a failed
probe — drives the machine to DOWN deterministically) and
``storeguard.replay`` (wraps every replayed write — injection must
degrade to the terminal-failure path, never corrupt).

Disabled (``[storeguard] enabled = false``, the default): no guard
objects exist, :func:`get` returns None, and every durable-write path
pays exactly one ``is None`` read — scripts/bench_smoke.sh's dispatch
counters stay byte-identical.

Integrity envelopes need no handling here: callers compose
the checksum envelope at value-production time, BEFORE the spool-vs-
direct dispatch, so a spooled write replays the already-enveloped bytes
verbatim and verify-on-read sees one format either way.

Port: a copy of ``spark_fsm_tpu/service/storeguard.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.utils import faults, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event

HEALTHY, FLAKY, DOWN = "healthy", "flaky", "down"
_STATE_NUM = {HEALTHY: 0, FLAKY: 1, DOWN: 2}

_HEALTH = obs.REGISTRY.gauge(
    "fsm_store_health_state",
    "store health as seen by the guard (0 healthy, 1 flaky, 2 down)")
_HEALTH.set(0)
_TRANSITIONS = (obs.REGISTRY.counter(
    "fsm_storeguard_transitions_total",
    "store health state transitions, by destination state")
    .seed(state=HEALTHY).seed(state=FLAKY).seed(state=DOWN))
_PROBES = (obs.REGISTRY.counter(
    "fsm_storeguard_probes_total",
    "active store health probes, by outcome (unreachable = transport "
    "failure; error = the store answered but is sick — fence posture)")
    .seed(outcome="ok").seed(outcome="unreachable").seed(outcome="error"))
_SPOOLED = (obs.REGISTRY.counter(
    "fsm_storeguard_spooled_writes_total",
    "durable writes deferred into the write-behind spool, by verb")
    .seed(verb="set").seed(verb="rpush").seed(verb="delete")
    .seed(verb="incr").seed(verb="spine").seed(verb="status"))
_SPOOL_ENTRIES = obs.REGISTRY.gauge(
    "fsm_storeguard_spool_entries",
    "writes currently held in the write-behind spool (must drain to 0 "
    "after every outage)")
_SPOOL_ENTRIES.set(0)
_REPLAYS = (obs.REGISTRY.counter(
    "fsm_storeguard_replays_total",
    "per-job spool replays after an outage, by outcome (refused = the "
    "lease was legitimately taken during the outage — each one is a "
    "double-commit that did NOT happen)")
    .seed(outcome="ok").seed(outcome="refused").seed(outcome="error"))
_REPLAYED_WRITES = obs.REGISTRY.counter(
    "fsm_storeguard_replayed_writes_total",
    "individual spooled writes applied on store return")
_DROPPED = (obs.REGISTRY.counter(
    "fsm_storeguard_dropped_writes_total",
    "spooled writes dropped without landing, by why (overflow = the "
    "per-job bound; refused = replay gate; error = replay failure)")
    .seed(why="overflow").seed(why="refused").seed(why="error"))
_STALLS = (obs.REGISTRY.counter(
    "fsm_storeguard_stalls_total",
    "outage stalls at jobctl safe points, by outcome")
    .seed(outcome="entered").seed(outcome="resumed").seed(outcome="fenced"))
_OUTAGE_SHEDS = obs.REGISTRY.counter(
    "fsm_storeguard_outage_sheds_total",
    "train submits shed with 429 because the store was down (durable "
    "admission impossible)")
_EPHEMERAL = obs.REGISTRY.counter(
    "fsm_storeguard_ephemeral_admissions_total",
    "loudly-flagged no-journal jobs admitted during a store outage "
    "([storeguard] ephemeral_admission)")


class _JobSpool:
    """One job's ordered write-behind spool.  ``token`` is the fencing
    token held when the spool opened — the replay gate re-proves it;
    ``gate = "none"`` (ephemeral/no-lease jobs) replays unconditionally
    (no other replica can know the uid)."""

    __slots__ = ("uid", "token", "gate", "entries", "overflowed",
                 "started")

    def __init__(self, uid: str, token: Optional[int], gate: str):
        self.uid = uid
        self.token = token
        self.gate = gate
        self.entries: List[Tuple] = []
        self.overflowed = False
        # True once the first entry has been applied: a partially
        # replayed spool ("again" residue) must not re-run its gate
        # checks against its OWN landed prefix
        self.started = False


class StoreGuard:
    """One per process (module-installed, like the obsplane): owns the
    health state machine, the spool, the stall registry and the probe
    thread.  ``clock`` is injectable (tests drive virtual time);
    ``probe_every_s = 0`` means manual ticks."""

    def __init__(self, store, lease_mgr=None, scfg=None,
                 clock=time.monotonic) -> None:
        scfg = scfg if scfg is not None else config.get_config().storeguard
        self.store = store
        self._mgr = lease_mgr
        self.probe_every_s = float(scfg.probe_every_s)
        self.down_after = int(scfg.down_after)
        self.spool_max_entries = int(scfg.spool_max_entries)
        self.stall_max_s = float(scfg.stall_max_s)
        self.ephemeral_admission = bool(scfg.ephemeral_admission)
        self._clock = clock
        self._state = HEALTHY
        self._consecutive = 0
        self._down_since: Optional[float] = None
        self._next_probe = 0.0
        # insertion-ordered: replay walks jobs in first-spooled order,
        # and each job's entries strictly FIFO
        self._spools: Dict[str, _JobSpool] = {}
        # uids whose gate="none" spool ALREADY replayed here: their
        # store trace is our own, so a later outage's spool for the
        # same uid must not read it as foreign (an ephemeral job
        # spanning two outages would otherwise refuse itself)
        self._own_none_uids: set = set()
        # uids whose job skipped its lease fence while the store was
        # DOWN (:meth:`skip_fence`): the first of its writes that goes
        # straight to the store again proves the lease first
        self._unfenced: set = set()
        # id(ctl) -> (ctl, stalled_since) — strong refs until unstall
        self._stalled: Dict[int, Tuple[object, float]] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- state

    @property
    def state(self) -> str:
        return self._state

    def is_down(self) -> bool:
        return self._state == DOWN

    def skip_fence(self, uid: str) -> bool:
        """May a job skip its lease fence at this point?  True during a
        PROVEN outage (DOWN): its writes spool and the replay gate
        re-proves its token, and should the store come back before its
        next write, that write proves the lease before it lands
        (:meth:`_write`).  False: fence as usual.  Without the second
        half a job whose fence was skipped wrote its next status
        straight to a store that had come back, after an adopter had
        settled the uid (ROADMAP Queue C 13; the reference only reads
        :meth:`is_down`)."""
        with self._lock:
            if self._state != DOWN:
                return False
            if len(self._unfenced) > 4096:
                self._unfenced.clear()
            self._unfenced.add(uid)
            return True

    def _to(self, state: str, why: str = "") -> None:
        if state == self._state:
            return
        self._state = state
        _HEALTH.set(_STATE_NUM[state])
        _TRANSITIONS.inc(state=state)
        self._down_since = self._clock() if state == DOWN else None
        log_event("storeguard_state", state=state, why=why,
                  spooled=self.spool_entries())
        obs.trace_event("storeguard_state", state=state, why=why)

    @staticmethod
    def _is_transport(exc: BaseException) -> bool:
        # OSError covers ConnectionError, socket.timeout, TimeoutError
        # and RespProtocolError; RespError (the store ANSWERED with an
        # error) and injected FaultInjected are deliberately excluded —
        # a store that talks back is sick, not gone: fence posture
        return isinstance(exc, OSError)

    def note_error(self, exc: BaseException) -> bool:
        """Classify one durable-write failure; True when the store is
        (now confirmed) DOWN and the caller should spool instead of
        raising."""
        if not self._is_transport(exc):
            return False
        with self._lock:
            self._consecutive += 1
            streak = self._consecutive
            if self._state == DOWN:
                return True
            if self._state == HEALTHY:
                self._to(FLAKY, why=f"{type(exc).__name__}: {exc}")
            if streak < self.down_after:
                return False
        # streak long enough: consult the probe for the DOWN verdict
        return self.probe_once() == "unreachable"

    def _note_ok(self) -> None:
        if self._consecutive:
            with self._lock:
                self._consecutive = 0
                if self._state == FLAKY and not self._spools:
                    self._to(HEALTHY, why="write succeeded")

    # ------------------------------------------------------------- probe

    def probe_once(self) -> str:
        """One active probe round-trip; drives the state machine.
        Returns "ok" / "unreachable" / "error"."""
        try:
            faults.fault_site("storeguard.probe")
            outcome = "ok" if self.store.probe() else "unreachable"
        except faults.FaultInjected:
            # an injected raise IS a failed probe — the site exists to
            # drive the machine to DOWN deterministically
            outcome = "unreachable"
        except Exception as exc:
            outcome = "unreachable" if self._is_transport(exc) else "error"
        _PROBES.inc(outcome=outcome)
        if outcome == "ok":
            self._on_store_ok()
        elif outcome == "unreachable":
            with self._lock:
                if self._state != DOWN:
                    self._to(DOWN, why="probe unreachable")
        else:
            # the store answered but is sick: NOT an outage — keep the
            # conservative fence posture (flaky at most)
            with self._lock:
                if self._state == DOWN:
                    self._to(FLAKY, why="probe error (store answers)")
        return outcome

    def tick(self) -> None:
        """One maintenance step (the lease heartbeat calls this; the
        probe thread calls it on its own cadence; tests call it
        directly): probe when unhealthy, enforce the stall bound,
        replay any residue, and reap stranded stalls."""
        now = self._clock()
        if self._state != HEALTHY or self._spools:
            if self.probe_every_s <= 0 or now >= self._next_probe:
                self._next_probe = now + max(0.0, self.probe_every_s)
                self.probe_once()
        if self._state == HEALTHY and self._stalled:
            # a stall registered in the race window AFTER a heal's
            # release pass would otherwise park its job forever (the
            # lease keeps renewing, so nothing else ever wakes it) —
            # a healthy guard has no business holding stalls
            self._release_stalls()
        self._enforce_stall_bound(now)

    def start(self) -> None:
        if self.probe_every_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fsm-storeguard")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.probe_every_s):
            try:
                self.tick()
            except Exception as exc:  # the guard thread must never die
                log_event("storeguard_tick_failed", error=str(exc))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(max(2.0, 2 * self.probe_every_s))
            self._thread = None

    # ----------------------------------------------------- durable writes
    # One helper per verb; each: direct while not DOWN (same store fault
    # sites as an unguarded deployment — chaos determinism preserved),
    # spool while DOWN, and a direct transport failure that the probe
    # confirms as an outage converts into a spool append instead of a
    # raise — the write is DEFERRED, the job lives.

    def set(self, uid: str, key: str, value: str,
            gate: Optional[str] = None) -> bool:
        return self._write(uid, ("set", key, value), gate)

    def rpush(self, uid: str, key: str, value: str,
              gate: Optional[str] = None) -> bool:
        return self._write(uid, ("rpush", key, value), gate)

    def delete(self, uid: str, key: str, gate: Optional[str] = None) -> bool:
        return self._write(uid, ("delete", key), gate)

    def incr(self, uid: str, key: str, gate: Optional[str] = None) -> bool:
        return self._write(uid, ("incr", key), gate)

    def status(self, uid: str, status: str,
               gate: Optional[str] = None) -> bool:
        """``add_status`` through the guard: ONE logical spool entry
        for the key-set + log-append pair, so a replay can never tear
        a terminal status from its log entry (the storm checker's
        exactly-once-settlement evidence).  The log timestamp is
        stamped at WRITE time (spool time during an outage), so the
        replayed status log tells the true timeline."""
        ts = int(time.time() * 1000)
        return self._write(uid, ("status", uid, status, ts), gate)

    def spine(self, uid: str, chunk_json: str,
              gate: Optional[str] = None) -> bool:
        return self._write(uid, ("spine", uid, chunk_json), gate)

    def _apply(self, entry: Tuple, replaying: bool = False) -> None:
        verb = entry[0]
        if verb == "set":
            self.store.set(entry[1], entry[2])
        elif verb == "rpush":
            self.store.rpush(entry[1], entry[2])
        elif verb == "delete":
            self.store.delete(entry[1])
        elif verb == "incr":
            self.store.incr(entry[1])
        elif verb == "spine":
            self.store.spine_append(entry[1], entry[2])
        elif verb == "status":
            # the set + log-append pair as one replay unit, idempotent
            # under RE-application (a mid-pair transport failure keeps
            # the whole entry for the next attempt; the tail check
            # keeps an ack-lost append from landing twice).  The tail
            # read is replay-only: the healthy direct path stays the
            # same two verbs add_status always was
            _, uid, status, ts = entry
            payload = f"{ts}:{status}"
            self.store.set(f"fsm:status:{uid}", status)
            log_key = f"fsm:status:log:{uid}"
            if replaying:
                tail = self.store.lrange(log_key)
                if tail and tail[-1] == payload:
                    return
            self.store.rpush(log_key, payload)
        else:  # a spool this process cannot replay would silently lose
            raise ValueError(f"unknown spool verb {verb!r}")

    def _write(self, uid: str, entry: Tuple, gate: Optional[str]) -> bool:
        """Apply (False) or spool (True) one durable write.  A uid with
        a PENDING spool keeps spooling even after the store is back —
        in-order is the invariant, and only the replay may drain it.
        The first direct write of a job that skipped its fence in an
        outage fences it first (raises ``JobLeaseLost`` when an adopter
        took the uid meanwhile)."""
        if self._state != DOWN and uid not in self._spools:
            if uid in self._unfenced:
                with self._lock:
                    self._unfenced.discard(uid)
                if self._mgr is not None:
                    self._mgr.fence(uid)
            try:
                self._apply(entry)
                self._note_ok()
                return False
            except Exception as exc:
                if not self.note_error(exc):
                    raise
        self._spool_write(uid, entry, gate)
        return True

    def _ctl_of(self, uid: str):
        if self._mgr is not None:
            ctl = self._mgr.attached_ctl(uid)
            if ctl is not None:
                return ctl
        return jobctl.get(uid)

    def _spool_write(self, uid: str, entry: Tuple,
                     gate: Optional[str]) -> None:
        with self._lock:
            spool = self._spools.get(uid)
            if spool is None:
                if gate is None:
                    token = (self._mgr.token_of(uid)
                             if self._mgr is not None else None)
                    gate = "token" if token is not None else "none"
                else:
                    token = None
                spool = self._spools[uid] = _JobSpool(uid, token, gate)
            if spool.overflowed:
                _DROPPED.inc(why="overflow")
                return
            if len(spool.entries) >= self.spool_max_entries:
                # the bound is the honesty line: past it the job can no
                # longer be deferred losslessly — fence it (terminal at
                # its next safe point) and poison the spool so replay
                # never applies a PARTIAL suffix
                spool.overflowed = True
                dropped = len(spool.entries) + 1
                spool.entries.clear()
                _DROPPED.inc(n=dropped, why="overflow")
                _SPOOL_ENTRIES.set(self.spool_entries())
                jobctl.fence_lost(self._ctl_of(uid))
                log_event("storeguard_spool_overflow", uid=uid,
                          dropped=dropped)
                return
            spool.entries.append(entry)
            _SPOOLED.inc(verb=entry[0])
            _SPOOL_ENTRIES.set(self.spool_entries())

    def spool_entries(self) -> int:
        return sum(len(s.entries) for s in self._spools.values())

    def drained(self) -> bool:
        return not self._spools

    # ------------------------------------------------------------- replay

    def _on_store_ok(self) -> None:
        with self._lock:
            if self._state == HEALTHY and not self._spools:
                return
            if (self._state == FLAKY and self._consecutive
                    and not self._spools and not self._stalled):
                # the probe answers but the WRITE path is failing: the
                # store is sick, not gone — a probe success must not
                # paper over a live failure streak (only a successful
                # write heals flaky, via _note_ok).  With a spool or a
                # stall pending the replay must still be ATTEMPTED —
                # the streak may be a relic of the outage that built
                # them (a DOWN -> flaky -> ok path sees no direct
                # writes to reset it: spooled uids keep spooling and
                # stalled jobs write nothing), and a failed replay
                # re-enters down/flaky on its own evidence anyway
                return
            ok = self._replay_all() if self._spools else True
            if ok:
                self._consecutive = 0
                self._to(HEALTHY, why="store back, spool drained")
                self._release_stalls()
            # not ok: a replay write hit transport again — the state
            # flipped back to DOWN inside _replay_all and the residue
            # (applied prefix popped) waits for the next probe

    def _replay_all(self) -> bool:
        """Replay every job spool in first-spooled order; True when the
        spool set fully drained (each job either applied or dropped
        with its job fenced)."""
        for uid in list(self._spools):
            spool = self._spools.get(uid)
            if spool is None:
                continue
            outcome = self._replay_spool(spool)
            if outcome == "again":
                return False  # store went away mid-replay: keep residue
            self._spools.pop(uid, None)
            _REPLAYS.inc(outcome=outcome)
            if outcome != "ok":
                # a dropped spool may hold THIS replica's deferred
                # admission-marker DEL (the dequeue-during-outage
                # path).  Markers have no TTL and are namespaced per
                # replica, so sweeping our own is always safe — and
                # skipping it would leak a phantom marker a later
                # steal scan could claim for an already-settled uid
                for entry in spool.entries:
                    if (entry[0] == "delete"
                            and entry[1].startswith("fsm:admission:")):
                        try:
                            self.store.delete(entry[1])
                        except Exception:
                            pass  # best effort; recovery adoption also
                            # reaps dead markers
                log_event("storeguard_replay_" + outcome, uid=uid)
        _SPOOL_ENTRIES.set(self.spool_entries())
        return True

    def _replay_spool(self, spool: _JobSpool) -> str:
        if spool.overflowed:
            # fenced at overflow time; nothing left to apply
            return "refused"
        if (spool.gate == "none" and self._mgr is not None
                and not spool.started
                and spool.uid not in self._own_none_uids):
            # ephemeral/no-lease spools replay ungated ONLY while the
            # uid is provably unknown to the durable world: a client
            # that reused the uid against a healthy peer during our
            # outage owns the uid's keys there (journal, lease, or a
            # status some OTHER writer landed), and clobbering them
            # would be the double-commit the token gate exists to
            # prevent.  When in doubt, refuse.
            try:
                foreign = (
                    self.store.peek(f"fsm:journal:{spool.uid}") is not None
                    or self.store.peek(f"fsm:lease:{spool.uid}") is not None
                    or self.store.peek(f"fsm:status:{spool.uid}")
                    is not None)
            except Exception as exc:
                if self._is_transport(exc):
                    self._to(DOWN, why="ephemeral gate transport failure")
                    return "again"
                foreign = True
            if foreign:
                _DROPPED.inc(n=len(spool.entries), why="refused")
                jobctl.fence_lost(self._ctl_of(spool.uid))
                return "refused"
        if spool.gate == "token" and self._mgr is not None:
            try:
                owned = self._mgr.reacquire_for_spool(spool.uid,
                                                      spool.token)
            except Exception as exc:
                if self._is_transport(exc):
                    self._to(DOWN, why="reacquire transport failure")
                    return "again"
                owned = None
            if owned is None:
                # the lease was legitimately taken during the outage:
                # an adopter owns the uid's keys — refusing the replay
                # IS the no-double-commit invariant (each refusal a
                # double-commit that did not happen)
                _DROPPED.inc(n=len(spool.entries), why="refused")
                jobctl.fence_lost(self._ctl_of(spool.uid))
                return "refused"
            # the token the lease now carries (a fresh one after a
            # re-take): a flap mid-replay re-enters the gate with it
            spool.token = owned
            self._unfenced.discard(spool.uid)
        while spool.entries:
            entry = spool.entries[0]
            try:
                faults.fault_site("storeguard.replay", uid=spool.uid,
                                  verb=entry[0])
                self._apply(entry, replaying=True)
            except Exception as exc:
                if self._is_transport(exc) and self.note_error(exc):
                    # store flapped mid-replay: the applied prefix is
                    # already popped, the residue replays next time —
                    # meta-last write ordering inside the spool keeps
                    # any prefix heal-able (StoreCheckpoint.load)
                    return "again"
                # non-transport (injected storeguard.replay, sick
                # store): degrade to the terminal-failure path — fence
                # the job, drop the rest of ITS spool; the store holds
                # a heal-able prefix, the journal intent (if any) still
                # stands for recovery.  Other jobs' spools still replay.
                _DROPPED.inc(n=len(spool.entries), why="error")
                jobctl.fence_lost(self._ctl_of(spool.uid))
                log_event("storeguard_replay_failed", uid=spool.uid,
                          verb=entry[0], error=str(exc))
                return "error"
            spool.entries.pop(0)
            spool.started = True
            _REPLAYED_WRITES.inc()
            _SPOOL_ENTRIES.set(self.spool_entries())
        if (spool.gate == "token" and self._mgr is not None
                and self._mgr.token_of(spool.uid) is None):
            # the job settled locally during the outage (its release
            # already ran and was a no-op store-side): the replay-time
            # reacquire left a store lease under our token — clean it
            self._mgr.release_token(spool.uid, spool.token)
        if spool.gate == "none":
            # this uid's store trace is now OUR OWN: a later outage's
            # spool for it skips the foreign-uid check (bounded — the
            # set only ever holds this process's ephemeral uids)
            if len(self._own_none_uids) > 4096:
                self._own_none_uids.clear()
            self._own_none_uids.add(spool.uid)
        return "ok"

    # -------------------------------------------------------------- stalls

    def stall_job(self, ctl, uid: str) -> bool:
        """The lease layer's outage hook: called when a holder's
        renewal verification failed past its TTL.  True = the job is
        (now) stalled instead of fenced — only when the probe proves a
        transport-level outage and the stall budget is not exhausted;
        False = keep today's conservative fence."""
        if ctl is None:
            return False
        if self._state != DOWN and self.probe_once() != "unreachable":
            return False  # store alive (or sick): when in doubt, fence
        now = self._clock()
        if (self.stall_max_s and self._down_since is not None
                and now - self._down_since > self.stall_max_s):
            return False
        with self._lock:
            # registry entry and jobctl flag flip ATOMICALLY under the
            # guard lock: a release pass serializes against this, so a
            # stall can never be registered flag-less (or flagged
            # registry-less) in the window around a heal — either the
            # release sees it whole, or the next tick's reap does
            if id(ctl) not in self._stalled:
                self._stalled[id(ctl)] = (ctl, now)
                jobctl.stall_entry(ctl)
                _STALLS.inc(outcome="entered")
                log_event("storeguard_stall", uid=uid)
                obs.trace_event("storeguard_stall", uid=uid)
            else:
                jobctl.stall_entry(ctl)
        return True

    def _enforce_stall_bound(self, now: float) -> None:
        if not self.stall_max_s:
            return
        with self._lock:
            # any unhealthy state counts against the bound: a stall
            # that survives a DOWN -> flaky drift (store answering but
            # sick) must still fence at its deadline, or the config
            # contract ("longest a job may stall before it fences
            # conservatively") silently becomes "forever"
            expired = [(k, ctl) for k, (ctl, since) in self._stalled.items()
                       if now - since > self.stall_max_s
                       and self._state != HEALTHY]
            for k, ctl in expired:
                self._stalled.pop(k, None)
                # optimism budget spent: fence conservatively — the
                # journal intent survives for recovery, nothing is lost
                jobctl.fence_lost(ctl)
                jobctl.unstall_entry(ctl)
                _STALLS.inc(outcome="fenced")
                log_event("storeguard_stall_fenced",
                          uid=getattr(ctl, "uid", "?"))

    def _release_stalls(self) -> None:
        with self._lock:
            stalled = list(self._stalled.values())
            self._stalled.clear()
            for ctl, _ in stalled:
                outcome = ("fenced" if getattr(ctl, "lease_lost", False)
                           else "resumed")
                jobctl.unstall_entry(ctl)
                _STALLS.inc(outcome=outcome)
                log_event("storeguard_stall_" + outcome,
                          uid=getattr(ctl, "uid", "?"))

    # ------------------------------------------------------------- surface

    def shed_outage_admission(self) -> int:
        """Count one outage shed; returns the Retry-After hint (the
        probe cadence is how fast the service can notice the store
        back — two probe periods is the honest earliest)."""
        _OUTAGE_SHEDS.inc()
        return max(1, int(2 * max(self.probe_every_s, 0.5)) + 1)

    def note_ephemeral_admission(self) -> None:
        _EPHEMERAL.inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_errors": self._consecutive,
                "down_since_s": (None if self._down_since is None
                                 else round(self._clock()
                                            - self._down_since, 3)),
                "spool_jobs": len(self._spools),
                "spool_entries": self.spool_entries(),
                "stalled_jobs": len(self._stalled),
                "probe_every_s": self.probe_every_s,
                "down_after": self.down_after,
                "spool_max_entries": self.spool_max_entries,
                "stall_max_s": self.stall_max_s,
                "ephemeral_admission": self.ephemeral_admission,
            }


# ---------------------------------------------------------------------------
# Process-global installation (the same last-wins posture as the
# obsplane: tests build many Miners; the service builds one)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_guard: Optional[StoreGuard] = None


def install(store, lease_mgr=None, scfg=None, clock=time.monotonic
            ) -> StoreGuard:
    global _guard
    guard = StoreGuard(store, lease_mgr=lease_mgr, scfg=scfg, clock=clock)
    with _lock:
        _guard = guard
    if lease_mgr is not None:
        lease_mgr.attach_guard(guard)
    return guard


def uninstall() -> None:
    """Remove the guard (test isolation); resets the health gauge."""
    global _guard
    with _lock:
        g, _guard = _guard, None
    if g is not None:
        g.stop()
    _HEALTH.set(0)


def get() -> Optional[StoreGuard]:
    """The installed guard, or None — the one read every durable-write
    path pays on a [storeguard]-disabled deployment."""
    return _guard
