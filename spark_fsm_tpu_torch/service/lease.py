"""Lease-fenced multi-replica job ownership — the scale-out unlock.

the earlier journal recovery documented its own ceiling: liveness was
inferred from a process-local incarnation id, so exactly ONE service
instance could own a store ("one store per instance until a
lease/heartbeat exists").  This module is that lease.  N replicas share
one Redis namespace safely; the failure of any replica degrades
CAPACITY (its jobs are adopted after a bounded TTL) instead of
CORRECTNESS (no double-commit, ever) — the reference's actor-routed
orchestration generalized across processes, the partitioned-worker
shape of DIMSpan/the parallel-SPM survey applied to job ownership.

The protocol, in store verbs the MiniRedis test server also speaks:

- **Acquire** (admission): ``SET fsm:lease:{uid} {replica,token} PX ttl
  NX``.  The FENCING TOKEN comes from ``INCR fsm:lease:token`` — one
  monotonic sequence per store, so any later acquisition of the same
  uid (adoption after expiry, work steal) holds a STRICTLY larger
  token than every earlier one.
- **Renew**: a per-replica heartbeat thread re-arms every held lease
  with ``PEXPIRE`` at ``lease_ttl/3``.  Why /3: two full renewal
  attempts can fail outright before the TTL lapses, so a single slow
  store round-trip never costs a healthy replica its leases.
- **Fence**: every journal/checkpoint/result write path consults the
  local lease record first (one dict read while the TTL is provably
  live — the adopter must outwait STORE expiry, which postdates our
  conservative local deadline) and verifies against the store once the
  local record lapses.  A superseded holder raises
  :class:`~spark_fsm_tpu_torch.utils.jobctl.JobLeaseLost` and its writes are
  REFUSED — a replica that wakes from a GC pause/SIGSTOP after its TTL
  cannot double-commit against the adopting replica's run.
- **Release** (terminal): compare-and-delete — GET, compare our token,
  DEL.  The GET→DEL window is the classic CAD caveat; it is bounded by
  one round-trip against a TTL thousands of times longer, and the
  fencing token backstops the residual race (a wrongly deleted lease
  only ever ACCELERATES adoption, never permits double-commit).
- **Steal** (two-phase claim): each replica mirrors its QUEUED jobs as
  ``fsm:admission:{replica}:{uid}`` markers.  An idle replica claims a
  loaded peer's marker with ``DEL`` — the store's atomic "exactly one
  caller sees 1" arbiter — then takes the lease over with a fresh
  (larger) token and resubmits the journaled request through its own
  admission path.  The victim's worker runs the SAME ``DEL`` at
  dequeue: whoever wins the delete owns the job, the loser walks away,
  so a queued job is never run twice.  A thief that dies between claim
  and resubmit leaves a journal orphan whose lease expires — the
  periodic recovery pass (below) re-adopts it; nothing is ever lost.
- **Adopt** (boot + periodic recovery): ``recover_orphans`` treats a
  foreign journal entry as dead ONLY once its lease has expired, and
  adoption itself is an NX acquire — two replicas booting into the same
  wreckage race the atomic SET, exactly one adopts each orphan.

Fault sites: ``lease.acquire`` / ``lease.renew`` / ``lease.steal``
(utils/faults KNOWN_SITES) wrap the protocol's store round-trips;
the lease layer reads raw keys via ``store.peek`` so chaos drills on
``store.get`` never alias onto lease verification.

Disabled (``[cluster] enabled = false``, the default) costs the
single-replica deployment nothing: no manager is built and every guard
in the Miner is one ``is None`` check.

Port: a copy of ``spark_fsm_tpu/service/lease.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from spark_fsm_tpu_torch.service import obsplane
from spark_fsm_tpu_torch.utils import envelope, faults, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event

_HELD = obs.REGISTRY.gauge(
    "fsm_lease_held", "job leases this replica currently holds")
_PEERS = obs.REGISTRY.gauge(
    "fsm_replica_peers", "peer replicas with a live heartbeat record")
_ACQUIRE_TOTAL = (obs.REGISTRY.counter(
    "fsm_lease_acquired_total", "lease acquisition attempts, by outcome")
    .seed(outcome="ok").seed(outcome="held").seed(outcome="error"))
_RENEW_TOTAL = (obs.REGISTRY.counter(
    "fsm_lease_renewals_total", "heartbeat lease renewals, by outcome")
    .seed(outcome="ok").seed(outcome="lost").seed(outcome="error"))
_REACQUIRED_TOTAL = obs.REGISTRY.counter(
    "fsm_lease_reacquired_total",
    "expired-but-unclaimed leases seamlessly reacquired by their holder")
_LOST_TOTAL = obs.REGISTRY.counter(
    "fsm_lease_lost_total",
    "leases this replica lost (expired unrecoverably or superseded)")
_FENCE_REJECTED_TOTAL = obs.REGISTRY.counter(
    "fsm_lease_fence_rejections_total",
    "store writes refused because the writer's lease was superseded — "
    "each one is a double-commit that did NOT happen")
_STEAL_TOTAL = (obs.REGISTRY.counter(
    "fsm_steal_attempts_total", "work-steal claims on peers' queued "
    "jobs, by outcome").seed(outcome="stolen").seed(outcome="lost_race")
    .seed(outcome="error"))
_VICTIM_DROPS_TOTAL = obs.REGISTRY.counter(
    "fsm_steal_victim_drops_total",
    "queued jobs this replica dropped at dequeue because a peer had "
    "already claimed them (the victim side of a successful steal)")
_HEARTBEATS_TOTAL = obs.REGISTRY.counter(
    "fsm_replica_heartbeats_total",
    "heartbeat records published by this replica")

_TOKEN_KEY = "fsm:lease:token"
# the longest the heartbeat thread waits for the GIL after each store
# reply while workers run Python (ROADMAP Queue C 14): CPython's default
# switch interval is 5 ms
HEARTBEAT_SWITCH_S = 0.001


class LeaseHeld(RuntimeError):
    """Acquisition refused: another replica holds a live lease on the
    uid.  The admission layer maps it to the same 409 surface as a
    process-local live-uid conflict — the job IS live, just elsewhere."""

    def __init__(self, uid: str, holder: Optional[str]):
        self.holder = holder
        super().__init__(
            f"uid {uid!r} is leased by replica {holder or 'unknown'!r}; "
            "resubmitting would race a live job — wait for a terminal "
            "status or use a new uid")


class LeaseUnavailable(RuntimeError):
    """The lease protocol itself failed (store down, injected fault):
    the submit cannot be made safe, so it is refused with HTTP 503
    BEFORE any store trace of the uid exists."""


class _Held:
    """This replica's record of one held lease.  ``expires`` is a LOCAL
    monotonic deadline computed from the instant just before the store
    round-trip, so it is always <= the store's own expiry — while
    ``clock() < expires`` no adopter can exist yet and the fence is one
    dict read."""

    __slots__ = ("uid", "token", "expires", "ctl", "lost")

    def __init__(self, uid: str, token: int, expires: float):
        self.uid = uid
        self.token = token
        self.expires = expires
        self.ctl: Optional[jobctl.JobControl] = None
        self.lost = False


class LeaseManager:
    """One per service replica: owns the replica id, the held-lease
    table, and the heartbeat thread (renewal + heartbeat record +
    steal scan + periodic orphan recovery)."""

    def __init__(self, store, replica_id: Optional[str] = None,
                 lease_ttl_s: float = 10.0,
                 heartbeat_s: Optional[float] = None,
                 steal: bool = True,
                 recover_every_s: Optional[float] = None,
                 clock=time.monotonic) -> None:
        if lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s must be > 0 (got {lease_ttl_s})")
        self._store = store
        self.replica_id = replica_id or uuid.uuid4().hex[:12]
        self.lease_ttl_s = float(lease_ttl_s)
        self._ttl_ms = max(1, int(self.lease_ttl_s * 1000))
        # ttl/3 so two consecutive renewal failures still leave one
        # attempt before the TTL lapses (DESIGN.md "Lease protocol").
        # None = the default cadence; 0 = MANUAL-TICK mode (no thread —
        # tests drive tick()/renew_all() deterministically)
        self.heartbeat_s = (self.lease_ttl_s / 3.0 if heartbeat_s is None
                            else float(heartbeat_s))
        self.steal_enabled = bool(steal)
        self.recover_every_s = (float(recover_every_s) if recover_every_s
                                else self.lease_ttl_s)
        self._clock = clock
        # store-outage guard (service/storeguard.py): attached by
        # storeguard.install when [storeguard] is enabled — None keeps
        # every outage hook below at one `is None` read
        self._guard = None
        self._lock = threading.Lock()
        # serializes _verify: the heartbeat's renew_all and a worker's
        # stale fence() may race the expired-unclaimed NX reacquire —
        # unserialized, the loser of the replica's OWN two-thread race
        # would read "claimed by someone" and spuriously self-fence
        self._verify_lock = threading.Lock()
        # set during shutdown drain: stop pulling NEW work (steal,
        # periodic adoption) while held leases keep renewing so the
        # draining jobs stay fenced-safe to their end
        self._quiesced = False
        # scale-down drain: advertised in the heartbeat so
        # peers steal our backlog and stop counting our capacity
        self._draining = False
        # peers cache refreshed on the heartbeat cadence: peer_free_total
        # sits on the 429 shed path, and a shed storm must not turn into
        # a KEYS storm against the shared store
        self._peers_cache: tuple = (-1e18, [])
        self._held: Dict[str, _Held] = {}
        # admission markers of jobs this replica dequeued whose marker
        # DEL failed on a store blip the guard had not proven (the
        # worker runs the job anyway): retried at every release and on
        # every heartbeat until one lands (ROADMAP Queue C 10).  The
        # lock orders the retries against a re-publish of the same uid
        self._unretracted: set = set()
        self._adm_lock = threading.Lock()
        # held uids whose every fence proves the lease on the store, not
        # the local TTL: the marker DEL failed, so a thief may claim the
        # job at any time (ROADMAP Queue C 12)
        self._distrusted: set = set()
        self._miner = None  # set by start(); duck-typed (Miner)
        self._recover: Optional[Callable[[], object]] = None
        self._next_recover = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, store, ccfg) -> "LeaseManager":
        return cls(store,
                   replica_id=ccfg.replica_id or None,
                   lease_ttl_s=ccfg.lease_ttl_s,
                   heartbeat_s=ccfg.heartbeat_s or None,
                   steal=ccfg.steal,
                   recover_every_s=ccfg.recover_every_s or None)

    # ------------------------------------------------------------- keys

    @staticmethod
    def _lease_key(uid: str) -> str:
        return f"fsm:lease:{uid}"

    def _adm_key(self, uid: str) -> str:
        return f"fsm:admission:{self.replica_id}:{uid}"

    @property
    def _hb_key(self) -> str:
        return f"fsm:replica:{self.replica_id}"

    def _payload(self, token: int) -> str:
        return json.dumps({"replica": self.replica_id, "token": token})

    @staticmethod
    def _parse(raw: Optional[str]) -> dict:
        """Envelope-aware tolerant decode: journal intents and heartbeat
        records now ride checksum envelopes (utils/envelope.py); legacy
        bare JSON still parses, corrupt bytes read as absent ({}) — the
        lease plane's degradation for a rotten record is simply to not
        trust it."""
        if not raw:
            return {}
        payload, _verdict = envelope.unwrap(raw)
        if payload is None:
            return {}
        try:
            out = json.loads(payload)
            return out if isinstance(out, dict) else {}
        except ValueError:
            return {}

    def _journal_ours(self, uid: str) -> bool:
        """Does the journal intent still name THIS replica?  The
        reacquire gate: a lease that expired *unclaimed* may be
        re-taken only while the intent is ours — an adopter/thief
        rewrites the journal under its own replica id at resubmit, and
        every terminal path clears it BEFORE releasing the lease, so a
        stale holder that slept through the entire adopted run (lease
        long released again) still cannot reacquire and double-commit."""
        entry = self._parse(self._store.peek(f"fsm:journal:{uid}"))
        return entry.get("replica") == self.replica_id

    def _set_held(self, uid: str, token: int, expires: float) -> _Held:
        with self._lock:
            h = self._held.get(uid)
            if h is None:
                h = self._held[uid] = _Held(uid, token, expires)
            else:
                h.token, h.expires, h.lost = token, expires, False
            _HELD.set(len(self._held))
            return h

    def _mark_lost(self, h: _Held, why: str) -> None:
        if h.lost:
            return
        h.lost = True
        _LOST_TOTAL.inc()
        jobctl.fence_lost(h.ctl)
        # tombstone the uid on the trace spine too: a stale holder's
        # buffered spans must never flush onto the adopter's timeline
        obsplane.mark_fenced(h.uid)
        log_event("lease_lost", uid=h.uid, token=h.token, why=why,
                  replica=self.replica_id)
        # explicit trace id: the heartbeat thread carries no span context
        with obs.span("lifecycle.fenced", trace_id=h.uid, token=h.token,
                      why=why, replica=self.replica_id):
            pass

    # --------------------------------------------------------- protocol

    def acquire(self, uid: str) -> int:
        """Acquire (or re-enter) the lease for ``uid``; returns the
        fencing token.  Raises :class:`LeaseHeld` when a peer holds a
        live lease (the 409 surface) and :class:`LeaseUnavailable` when
        the protocol itself failed (the 503 surface — zero store trace
        of the uid exists yet)."""
        h = self._held.get(uid)
        if h is not None and not h.lost:
            # re-entrant: adoption/steal acquired before the resubmit
            if self._clock() < h.expires:
                return h.token
            try:
                if self._verify(h):
                    return h.token
            except Exception:
                pass  # fall through to a fresh acquisition
        try:
            faults.fault_site("lease.acquire", uid=uid)
            t0 = self._clock()
            token = int(self._store.incr(_TOKEN_KEY))
            key = self._lease_key(uid)
            ok = self._store.set_px(key, self._payload(token), self._ttl_ms,
                                    nx=True)
            holder = None
            if not ok:
                raw = self._store.peek(key)
                if raw is None:  # expired between the NX and this read
                    ok = self._store.set_px(key, self._payload(token),
                                            self._ttl_ms, nx=True)
                else:
                    holder = self._parse(raw).get("replica")
        except Exception as exc:
            _ACQUIRE_TOTAL.inc(outcome="error")
            raise LeaseUnavailable(
                f"lease acquisition for uid {uid!r} failed: {exc}") from exc
        if not ok:
            _ACQUIRE_TOTAL.inc(outcome="held")
            raise LeaseHeld(uid, holder)
        _ACQUIRE_TOTAL.inc(outcome="ok")
        self._set_held(uid, token, t0 + self.lease_ttl_s)
        return token

    def attach(self, uid: str, ctl: Optional[jobctl.JobControl]) -> None:
        """Bind the job's control entry so a heartbeat-detected loss
        self-fences the job at its next safe point.  Binds the OBJECT,
        not the uid: in multi-replica tests two miners in one process
        may register the same uid and the flag must land on the
        incarnation that lost its lease."""
        h = self._held.get(uid)
        if h is not None:
            h.ctl = ctl

    def _verify(self, h: _Held) -> bool:
        """One store round-trip re-proving ownership of ``h`` and
        re-arming its TTL.  False = lost (marked, control entry
        fenced).  Raises on store failure — the caller decides whether
        an UNVERIFIABLE lease is survivable (heartbeat: yes, until the
        TTL lapses) or not (a stale fence check: no)."""
        with self._verify_lock:
            return self._verify_locked(h)

    def _verify_locked(self, h: _Held) -> bool:
        faults.fault_site("lease.renew", uid=h.uid)
        key = self._lease_key(h.uid)
        t0 = self._clock()
        raw = self._store.peek(key)
        if raw is not None:
            if int(self._parse(raw).get("token", -1)) == h.token:
                if self._store.pexpire(key, self._ttl_ms):
                    h.expires = t0 + self.lease_ttl_s
                    return True
                raw = None  # expired between the read and the renew
            else:
                self._mark_lost(h, "superseded")
                return False
        if raw is None:
            # expired but UNCLAIMED: one atomic NX reacquire decides
            # between seamless continuation and self-fencing — gated on
            # the journal intent still being OURS (an absent/foreign
            # intent means the job was adopted, and possibly already
            # finished, elsewhere; "the lease key is free again" is NOT
            # proof nobody superseded us in between)
            if self._journal_ours(h.uid):
                token = int(self._store.incr(_TOKEN_KEY))
                if self._store.set_px(key, self._payload(token),
                                      self._ttl_ms, nx=True):
                    h.token = token
                    h.expires = t0 + self.lease_ttl_s
                    h.lost = False
                    _REACQUIRED_TOTAL.inc()
                    log_event("lease_reacquired", uid=h.uid, token=token)
                    return True
                self._mark_lost(h, "expired_and_claimed")
                return False
            self._mark_lost(h, "expired_and_disowned")
            return False
        self._mark_lost(h, "superseded")
        return False

    def fence(self, uid: str) -> None:
        """The write-path guard: raise
        :class:`~spark_fsm_tpu_torch.utils.jobctl.JobLeaseLost` unless this
        replica can prove it still owns ``uid``.  One dict read while
        the local TTL is live; a store verification once it lapses.
        Uids never leased here (stream pushes) pass untouched."""
        h = self._held.get(uid)
        if h is None:
            return
        if (not h.lost and self._clock() < h.expires
                and uid not in self._distrusted):
            return
        if not h.lost:
            try:
                if self._verify(h):
                    return
            except Exception as exc:
                if (self._guard is not None
                        and self._guard.note_error(exc)):
                    # PROVEN store outage: the write this fence guards
                    # is about to ride the spool, whose replay gate
                    # re-proves the token before anything lands — allow
                    # it (stall semantics), don't fence
                    return
                # unverifiable at a point where the TTL may already have
                # lapsed: refusing the write is the only safe answer
                self._mark_lost(h, f"unverifiable: {exc}")
        _FENCE_REJECTED_TOTAL.inc()
        raise jobctl.JobLeaseLost(
            uid, "its replica lease expired or was superseded; refusing "
                 "the write to avoid double-commit")

    def attach_guard(self, guard) -> None:
        """Bind the store-outage guard (service/storeguard.py): renewal
        failures past the TTL during a PROVEN store outage stall the
        job at its next safe point instead of fencing it."""
        self._guard = guard

    def renew_all(self) -> None:
        """Heartbeat renewal of every held lease.  A renewal FAILURE is
        survivable until the TTL lapses (the job keeps running); past
        it the job is fenced at its next safe point — unless the
        storeguard probe proves the store GLOBALLY unreachable, in
        which case the job STALLS there instead (frontier kept in
        memory + spool) and the journal-gated NX reacquire decides its
        fate when the store returns.  A replica that cannot prove the
        outage (store answers the probe) fences as before: when in
        doubt, fence.

        A STALLED job's lease is not renewed: the spool replay proves
        the spool's token is still the job's, re-takes the lease under a
        fresh token and un-stalls the job.  A renewal that saw the store
        back first would re-take the expired lease under a fresh token
        the spool does not know, and the replay, gated on the spool's
        token, would then refuse the writes and fence the job (the
        reference renews it; ROADMAP Queue C 7)."""
        for h in list(self._held.values()):
            if h.lost or (h.ctl is not None and h.ctl.stalled):
                continue
            try:
                if self._verify(h):
                    _RENEW_TOTAL.inc(outcome="ok")
                else:
                    _RENEW_TOTAL.inc(outcome="lost")
            except Exception as exc:
                _RENEW_TOTAL.inc(outcome="error")
                if self._clock() >= h.expires:
                    if (self._guard is not None
                            and self._guard.stall_job(h.ctl, h.uid)):
                        continue
                    self._mark_lost(h, f"renewal failed past TTL: {exc}")

    def settle_for_failure(self, uid: str) -> bool:
        """May this replica durably record ``uid``'s failure?  True for
        never-leased uids and live leases.  For a lost/expired lease,
        ONE atomic NX reacquire decides: success means nobody adopted
        (safe to settle durably — a client polling the uid deserves the
        terminal status); refusal means the adopter owns the uid's keys
        and this replica's failure must stay local."""
        h = self._held.get(uid)
        if h is None:
            return True
        if (not h.lost and self._clock() < h.expires
                and uid not in self._distrusted):
            return True
        key = self._lease_key(uid)
        try:
            raw = self._store.peek(key)
            if raw is not None:
                if int(self._parse(raw).get("token", -1)) == h.token:
                    return True
                _FENCE_REJECTED_TOTAL.inc()
                log_event("lease_failure_write_fenced", uid=uid,
                          replica=self.replica_id)
                return False
            # same reacquire gate as _verify: only settle an expired
            # lease while the journal intent is still OURS — otherwise
            # an adopter ran (and may have finished + released) and the
            # uid's keys are its, not ours
            if self._journal_ours(uid):
                t0 = self._clock()
                token = int(self._store.incr(_TOKEN_KEY))
                if self._store.set_px(key, self._payload(token),
                                      self._ttl_ms, nx=True):
                    self._set_held(uid, token, t0 + self.lease_ttl_s)
                    return True
        except Exception as exc:
            log_event("lease_settle_unverifiable", uid=uid, error=str(exc))
        _FENCE_REJECTED_TOTAL.inc()
        return False

    def reacquire_for_spool(self, uid: str,
                            token: Optional[int]) -> Optional[int]:
        """The write-behind spool's replay gate (service/storeguard.py):
        may the spooled writes for ``uid`` — taken under fencing
        ``token`` before/during the outage — land now?

        Returns the token the replay now holds the lease under, in
        exactly two cases: the store lease STILL carries ``token`` (the
        outage was shorter than the TTL; ``token`` itself), or the lease
        expired UNCLAIMED and the journal intent still names this
        replica — then one atomic NX re-take resumes the job under a
        FRESH token, which the caller keeps as the spool's token (a
        replay that resumes after a flap then finds its own token on the
        lease).  Not the spool's own: a later token may have been
        written for the uid meanwhile and be gone again (this replica's
        renewal re-take whose reply was lost as the store went away, a
        thief whose resubmit failed and released), and a re-take under
        the older token would make the uid's tokens fall (ROADMAP Queue
        C 11; the reference re-takes under the spool's token).  None in
        any other state: the lease was legitimately taken during the
        outage — the adopter owns the uid's keys and the replay must be
        REFUSED.  Transport errors propagate (the guard re-enters DOWN
        and keeps the spool)."""
        if token is None:
            return None
        key = self._lease_key(uid)
        with self._verify_lock:
            t0 = self._clock()
            raw = self._store.peek(key)
            if raw is not None:
                if int(self._parse(raw).get("token", -1)) == int(token):
                    if self._store.pexpire(key, self._ttl_ms):
                        h = self._held.get(uid)
                        if h is not None and h.token == token:
                            h.expires = t0 + self.lease_ttl_s
                            h.lost = False
                        return int(token)
                    raw = None  # expired between the read and the renew
                else:
                    _FENCE_REJECTED_TOTAL.inc()
                    h = self._held.get(uid)
                    if h is not None and h.token == token:
                        self._mark_lost(h, "outage_superseded")
                    return None
            if not self._journal_ours(uid):
                # adopted (and possibly finished + settled) elsewhere
                # during the outage — the uid's keys are the adopter's
                _FENCE_REJECTED_TOTAL.inc()
                h = self._held.get(uid)
                if h is not None and h.token == token:
                    self._mark_lost(h, "outage_adopted")
                return None
            take = int(self._store.incr(_TOKEN_KEY))
            if self._store.set_px(key, self._payload(take),
                                  self._ttl_ms, nx=True):
                h = self._held.get(uid)
                if h is not None:
                    h.token = take
                    h.expires = t0 + self.lease_ttl_s
                    h.lost = False
                _REACQUIRED_TOTAL.inc()
                log_event("lease_reacquired_for_replay", uid=uid,
                          token=token, take=take)
                return take
            _FENCE_REJECTED_TOTAL.inc()
            h = self._held.get(uid)
            if h is not None and h.token == token:
                self._mark_lost(h, "outage_claimed")
            return None

    def release_token(self, uid: str, token: int) -> None:
        """Compare-and-delete by EXPLICIT token — the spool replay's
        cleanup for a job that settled locally during the outage (its
        normal release already ran as a store-side no-op, so no
        ``_held`` record exists to release through)."""
        key = self._lease_key(uid)
        try:
            if int(self._parse(self._store.peek(key)).get("token", -1)) \
                    == int(token):
                self._store.delete(key)
        except Exception as exc:
            log_event("lease_release_failed", uid=uid, error=str(exc))

    def release(self, uid: str) -> None:
        """Terminal-status release: compare-and-delete (best effort —
        the TTL reaps anything this misses, and the fencing token keeps
        even a misdelete harmless).  A marker the dequeue could not
        retract goes first, while the lease still bars a re-admission
        of the uid."""
        self.sweep_unretracted()
        with self._lock:
            h = self._held.pop(uid, None)
            _HELD.set(len(self._held))
            self._distrusted.discard(uid)
        if h is None:
            return
        key = self._lease_key(uid)
        try:
            if int(self._parse(self._store.peek(key)).get("token", -1)) \
                    == h.token:
                self._store.delete(key)
        except Exception as exc:
            log_event("lease_release_failed", uid=uid, error=str(exc))

    def forget(self, uid: str) -> None:
        """Drop the local record WITHOUT touching the store — the victim
        side of a steal (the thief owns the store lease now)."""
        with self._lock:
            self._held.pop(uid, None)
            _HELD.set(len(self._held))
            self._distrusted.discard(uid)

    def attached_ctl(self, uid: str) -> Optional[jobctl.JobControl]:
        """The control object bound at attach time — the victim-drop
        paths release THIS object (jobctl.release_entry), never the
        uid, which in an in-process multi-replica topology may already
        map to the thief's live entry."""
        h = self._held.get(uid)
        return None if h is None else h.ctl

    def held_uids(self) -> List[str]:
        with self._lock:
            return sorted(self._held)

    def token_of(self, uid: str) -> Optional[int]:
        h = self._held.get(uid)
        return None if h is None else h.token

    def is_lost(self, uid: str) -> bool:
        """True while the local record says the uid's lease was lost —
        the trace spine's cheap pre-check (one dict read) before it
        even builds a chunk."""
        h = self._held.get(uid)
        return h is not None and h.lost

    # ------------------------------------------------- adoption (recovery)

    def adopt_expired(self, uid: str) -> bool:
        """Boot/periodic recovery's adoption gate: True only when the
        orphan's lease has EXPIRED and this replica won the atomic NX
        re-acquisition.  A live lease means the job is merely running on
        a peer — the earlier recovery would have called it dead and
        double-submitted it; this check is the multi-replica fix."""
        key = self._lease_key(uid)
        try:
            if self._store.peek(key) is not None:
                return False  # live on some replica (possibly us)
            t0 = self._clock()
            token = int(self._store.incr(_TOKEN_KEY))
            if not self._store.set_px(key, self._payload(token),
                                      self._ttl_ms, nx=True):
                return False  # another recovering replica won the race
        except Exception as exc:
            log_event("lease_adopt_failed", uid=uid, error=str(exc))
            return False
        self._set_held(uid, token, t0 + self.lease_ttl_s)
        log_event("lease_adopted", uid=uid, token=token,
                  replica=self.replica_id)
        return True

    # ------------------------------------------------------ work stealing

    def publish_admission(self, uid: str) -> None:
        """Mirror a QUEUED job into this replica's admission namespace —
        the steal scan's menu.  The marker is live again, so a retry of
        an earlier incarnation's failed retraction is dropped."""
        with self._adm_lock:
            self._store.set(self._adm_key(uid), "1")
            self._unretracted.discard(uid)

    def retract_admission(self, uid: str) -> bool:
        """Atomically claim the queued job for LOCAL execution (the
        worker's dequeue step).  False = a thief already claimed it."""
        return self._store.delete(self._adm_key(uid)) >= 1

    def retract_admission_deferred(self, uid: str, guard) -> None:
        """Outage spelling of :meth:`retract_admission`: spool the
        marker DEL through the storeguard so it lands at replay — the
        marker-key layout stays this class's private knowledge.  A
        post-heal thief racing the replayed DEL loses either way:
        whoever loses the arbiter is fenced by token."""
        guard.delete(uid, self._adm_key(uid))

    def note_unretracted(self, uid: str) -> None:
        """The dequeue's marker DEL failed and the job runs anyway (an
        unproven store blip): keep the marker for
        :meth:`sweep_unretracted`.  This replica alone writes its
        namespace, so deleting its own marker of a dequeued job is
        always safe; a thief that won the DEL meanwhile still owns the
        job, and its larger token fences this replica's run."""
        with self._adm_lock:
            self._unretracted.add(uid)

    def held_by_us(self, uid: str) -> Optional[bool]:
        """Does the store's lease on ``uid`` carry this replica's token?
        None when it cannot say (no local record, an expired lease, or a
        store that does not answer)."""
        h = self._held.get(uid)
        if h is None:
            return None
        try:
            raw = self._store.peek(self._lease_key(uid))
        except Exception:
            return None
        if raw is None:
            return None
        return int(self._parse(raw).get("token", -1)) == h.token

    def distrust(self, uid: str) -> None:
        """Make every :meth:`fence` and :meth:`settle_for_failure` of
        ``uid`` until its release prove the lease against the store
        instead of trusting the local TTL: after a marker DEL this
        replica could not prove, a thief may claim the job and overwrite
        the lease with a larger token (ROADMAP Queue C 12)."""
        self._distrusted.add(uid)

    def sweep_unretracted(self) -> int:
        """Retry the marker DELs :meth:`note_unretracted` kept; returns
        how many landed.  Stops at the first failure (the store is
        still away; the next heartbeat or release retries)."""
        if not self._unretracted:
            return 0
        done = 0
        with self._adm_lock:
            for uid in sorted(self._unretracted):
                try:
                    self._store.delete(self._adm_key(uid))
                except Exception as exc:
                    log_event("retract_admission_retry_failed", uid=uid,
                              error=str(exc))
                    break
                self._unretracted.discard(uid)
                done += 1
                log_event("retract_admission_retried", uid=uid,
                          replica=self.replica_id)
        return done

    def admission_claimed(self, uid: str) -> bool:
        """Has a thief already claimed this queued job's marker?  The
        DRAIN loop's poll: with the queue paused, the worker-side
        victim drop never runs, so the drain reaps stolen entries
        itself.  Read-only (peek) — the atomic arbiter stays the DEL."""
        return self._store.peek(self._adm_key(uid)) is None

    def stolen_from_us(self, uid: str) -> None:
        """Victim-side bookkeeping when retract_admission lost the DEL
        race: drop local state, count, leave the thief's journal/lease
        untouched."""
        self.forget(uid)
        _VICTIM_DROPS_TOTAL.inc()
        log_event("job_stolen_from_us", uid=uid, replica=self.replica_id)
        with obs.span("lifecycle.stolen", trace_id=uid, side="victim",
                      replica=self.replica_id):
            pass

    def publish_heartbeat(self) -> None:
        """Advertise this replica's load (PX = lease TTL, so a dead
        replica's record vanishes with its leases).  ``free`` — worker
        slots not covered by running or queued work — is what peers'
        Retry-After estimators and steal scans read.  The record also
        piggybacks a COMPACT metric snapshot (held leases, lifetime
        sheds/acquire/loss counters, EWMA job wall) so any replica can
        serve the aggregated cluster view (/admin/cluster,
        fsm_cluster_*) without touching its peers directly."""
        m = self._miner
        self._store.set_px(self._hb_key, envelope.wrap(json.dumps({
            "replica": self.replica_id,
            "queued": m.queue_size() if m is not None else 0,
            "running": m.running_count() if m is not None else 0,
            "workers": m.worker_count() if m is not None else 0,
            # the ONE derivation of free capacity — also the steal
            # scan's budget (Miner.idle_capacity).  A DRAINING replica
            # advertises zero: its slots are leaving the fleet.
            "free": (0 if self._draining else
                     m.idle_capacity() if m is not None else 0),
            # whether this replica WILL actually steal: peers' 429
            # Retry-After hints must not point at a steal path that is
            # disabled or quiescing for shutdown
            "steal": bool(self.steal_enabled and not self._quiesced),
            # scale-down drain state: peers steal a draining
            # replica's queue and the autoscaler excludes it from the
            # fleet's capacity arithmetic
            "draining": bool(self._draining),
            # per-tenant queued depths (fairness scheduler; {} without
            # one) — the /admin/cluster multi-tenant load view
            "tenants": (getattr(m, "tenant_depths", dict)()
                        if m is not None else {}),
            # in-flight coalescing-leader dataset fingerprints (ROADMAP
            # 2c; [] without the result-reuse tier): peers consult this
            # before admitting a duplicate cold mine, bounded so the
            # heartbeat record stays compact
            "fps": (list(getattr(m, "inflight_fps", list)())[:32]
                    if m is not None else []),
            # metric snapshot: lifetime counters are summed
            # by readers; a dead replica's contribution vanishes with
            # its record — the aggregate view is of LIVE replicas
            "held": len(self._held),
            "sheds": int(m.sheds_total()) if m is not None else 0,
            "ewma_s": (round(m.wall_ewma(), 4)
                       if m is not None and m.wall_ewma() is not None
                       else None),
            # compact per-replica SLO digest: the
            # worst local e2e p99 + sample count — the autoscale leader
            # scales on the FLEET max of these instead of its own
            # (possibly idle, therefore blind) local window
            "slo": obsplane.slo_digest(),
            # lifetime successful admissions: the
            # autoscale leader differentiates the fleet sum of these
            # for the predictive rate-derivative scale-up signal
            "adm": (int(getattr(m, "admitted_total", lambda: 0)())
                    if m is not None else 0),
            "acq": int(_ACQUIRE_TOTAL.total()),
            "lost": int(_LOST_TOTAL.total()),
            # degraded-topology gossip:
            # {"epoch", "dead"} so peers converge on the fleet-max
            # topology epoch and the union dead-row set; None when the
            # guard is off
            "mesh": self._mesh_payload(),
            "ts": round(time.time(), 3)})), self._ttl_ms)
        _HEARTBEATS_TOTAL.inc()

    @staticmethod
    def _mesh_payload() -> Optional[dict]:
        try:
            from spark_fsm_tpu_torch.service import meshguard
            g = meshguard.get()
            return None if g is None else g.heartbeat_payload()
        except Exception:
            return None

    def peers(self, max_age_s: Optional[float] = None) -> List[dict]:
        """Live peer heartbeat records.  ``max_age_s`` serves a cached
        scan no older than that — the store walk must stay OFF hot
        paths (the 429 shed estimator, scrape-time collectors); None
        forces a fresh cursor scan (the heartbeat tick / steal path)."""
        if max_age_s is not None:
            ts, cached = self._peers_cache
            if self._clock() - ts < max_age_s:
                return cached
        out = []
        for key in self._store.scan_iter("fsm:replica:", count=256):
            rid = key[len("fsm:replica:"):]
            if rid == self.replica_id:
                continue
            p = self._parse(self._store.peek(key))
            if p:
                out.append(p)
        _PEERS.set(len(out))
        self._peers_cache = (self._clock(), out)
        return out

    def cluster_view(self, max_age_s: Optional[float] = None) -> dict:
        """The /admin/cluster body (and the fsm_cluster_* collector's
        input): this replica's live row + every un-expired peer
        heartbeat, with cluster totals.  Peers come from the heartbeat-
        cadence cache by default — any replica can serve this under a
        scrape storm without driving store scans."""
        m = self._miner
        self_row = {
            "replica": self.replica_id, "self": True,
            "queued": m.queue_size() if m is not None else 0,
            "running": m.running_count() if m is not None else 0,
            "workers": m.worker_count() if m is not None else 0,
            "free": (0 if self._draining else
                     m.idle_capacity() if m is not None else 0),
            "steal": bool(self.steal_enabled and not self._quiesced),
            "draining": bool(self._draining),
            "tenants": (getattr(m, "tenant_depths", dict)()
                        if m is not None else {}),
            "held": len(self._held),
            "sheds": int(m.sheds_total()) if m is not None else 0,
            "ewma_s": (round(m.wall_ewma(), 4)
                       if m is not None and m.wall_ewma() is not None
                       else None),
            "slo": obsplane.slo_digest(),
            "adm": (int(getattr(m, "admitted_total", lambda: 0)())
                    if m is not None else 0),
            "acq": int(_ACQUIRE_TOTAL.total()),
            "lost": int(_LOST_TOTAL.total()),
        }
        try:
            peers = self.peers(
                max_age_s=(max_age_s if max_age_s is not None
                           else max(self.heartbeat_s, 1.0)))
        except Exception:
            peers = []
        rows = [self_row] + [dict(p) for p in peers]

        def tot(key: str) -> int:
            return sum(int(r.get(key) or 0) for r in rows)

        totals = {"replicas": len(rows), "queued": tot("queued"),
                  "running": tot("running"), "workers": tot("workers"),
                  "free": tot("free"), "held": tot("held"),
                  "sheds": tot("sheds"),
                  "draining": sum(1 for r in rows if r.get("draining")),
                  "lease_churn": tot("acq") + tot("lost")}
        return {"replica": self.replica_id, "lease_ttl_s": self.lease_ttl_s,
                "heartbeat_s": self.heartbeat_s, "totals": totals,
                "replicas": rows, "ts": round(time.time(), 3)}

    def shed_view(self) -> dict:
        """Compact cluster context for 429 bodies — the same cached
        peer data the Retry-After hint consults, so a shed client can
        see WHY the hint says what it says (peers with free capacity =
        the steal path will likely pick the job up)."""
        try:
            peers = self.peers(max_age_s=max(self.heartbeat_s, 1.0))
        except Exception:
            peers = []
        return {"replica": self.replica_id,
                "replicas": 1 + len(peers),
                "peer_free": sum(max(0, int(p.get("free", 0) or 0))
                                 for p in peers if p.get("steal")),
                "peer_queued": sum(max(0, int(p.get("queued", 0) or 0))
                                   for p in peers)}

    def peer_free_total(self) -> int:
        """Cluster-wide advertised free capacity — the Retry-After
        estimator's steal-path signal (0 on any store hiccup: fail
        toward the conservative local estimate).  Served from the
        heartbeat-cadence peer cache: a shed storm must not become a
        KEYS storm."""
        try:
            return sum(max(0, int(p.get("free", 0) or 0))
                       for p in self.peers(
                           max_age_s=max(self.heartbeat_s, 1.0))
                       if p.get("steal"))
        except Exception:
            return 0

    def steal_once(self) -> int:
        """One steal scan: when this replica is idle, claim queued jobs
        from the most loaded peer's admission namespace, up to our idle
        capacity.  Returns how many were stolen."""
        m = self._miner
        if m is None or not self.steal_enabled or self._quiesced:
            return 0
        budget = m.idle_capacity()
        if budget <= 0 or m.queue_size() > 0:
            return 0
        try:
            peers = self.peers()
        except Exception:
            return 0
        stolen = 0
        for p in sorted(peers,
                        key=lambda q: -int(q.get("queued", 0) or 0)):
            if stolen >= budget or int(p.get("queued", 0) or 0) <= 0:
                continue
            prefix = f"fsm:admission:{p.get('replica', '')}:"
            try:
                # cursor scan, early-terminated at the budget: the walk
                # reads at most one extra batch past what it can claim.
                # The scan's wire round-trips happen lazily INSIDE this
                # loop, so the whole iteration sits in the try — a
                # store hiccup walking one peer's namespace moves on to
                # the next peer instead of aborting the pass
                for key in self._store.scan_iter(prefix, count=64):
                    if stolen >= budget:
                        break
                    uid = key[len(prefix):]
                    try:
                        if self._steal_one(key, uid,
                                           p.get("replica", "")):
                            stolen += 1
                    except Exception as exc:
                        _STEAL_TOTAL.inc(outcome="error")
                        log_event("job_steal_failed", uid=uid,
                                  error=str(exc))
            except Exception as exc:
                log_event("job_steal_scan_failed",
                          victim=p.get("replica", ""), error=str(exc))
                continue
        return stolen

    def _steal_one(self, marker_key: str, uid: str, victim: str) -> bool:
        """The two-phase claim.  Phase 1: win the marker DEL (exclusive
        against the victim's dequeue AND other thieves).  Phase 2: take
        the lease over with a fresh, larger fencing token and resubmit
        the journaled request through our own admission path.  A failure
        after phase 1 releases the lease and leaves a journal orphan the
        periodic recovery pass re-adopts — loud, slow, never lost."""
        from spark_fsm_tpu_torch.service.model import ServiceRequest

        faults.fault_site("lease.steal", uid=uid, victim=victim)
        if self._store.delete(marker_key) < 1:
            _STEAL_TOTAL.inc(outcome="lost_race")
            return False
        raw = self._store.peek(f"fsm:journal:{uid}")
        entry = self._parse(raw)
        if not entry.get("request"):
            _STEAL_TOTAL.inc(outcome="lost_race")  # settled under us
            return False
        t0 = self._clock()
        token = int(self._store.incr(_TOKEN_KEY))
        # unconditional overwrite: the victim's queued-job lease is live,
        # but the marker DEL above already guarantees it will DROP the
        # job at dequeue — and our larger token fences any interleaving
        self._store.set_px(self._lease_key(uid), self._payload(token),
                           self._ttl_ms)
        self._set_held(uid, token, t0 + self.lease_ttl_s)
        # a steal IS an adoption: stage the bumped counter so the
        # resubmit's journal intent carries it — the crash-loop
        # quarantine budget ([cluster] max_adoptions) counts holders
        # lost to steals and crashes alike
        bump = getattr(self._miner, "note_adoption", None)
        if bump is not None:
            try:
                n = int(entry.get("adoptions") or 0)
            except (TypeError, ValueError):
                n = 0
            bump(uid, n + 1)
        req = ServiceRequest("fsm", "train", {
            str(k): str(v) for k, v in entry["request"].items()})
        try:
            self._miner.submit(req)
        except Exception as exc:
            # we could not admit it after all (filled up between the
            # idle check and here, uid conflict, store hiccup): UNDO the
            # claim so nothing is lost — restore the victim's journal
            # intent verbatim and its admission marker, then release our
            # lease.  If the victim's worker has not reached the uid
            # yet, it wins the restored marker at dequeue and simply
            # runs the job (the heartbeat's journal-gated NX reacquire
            # re-owns the lease seamlessly); if it already dropped it,
            # marker+journal form an orphan the next steal scan or
            # recovery pass picks up.  Either way: slower, never lost.
            try:
                self._store.set(f"fsm:journal:{uid}", raw)
                self._store.set(marker_key, "1")
            except Exception as restore_exc:
                log_event("job_steal_restore_failed", uid=uid,
                          error=str(restore_exc))
            # the staged adoption counter must not leak onto an
            # unrelated future admit of the same uid
            getattr(self._miner, "_adoptions_pending", {}).pop(uid, None)
            self.release(uid)
            _STEAL_TOTAL.inc(outcome="error")
            log_event("job_steal_resubmit_failed", uid=uid, victim=victim,
                      error=str(exc))
            return False
        _STEAL_TOTAL.inc(outcome="stolen")
        # steal latency: victim's admission (journal intent ts) to this
        # successful claim + resubmit — the histogram the ROADMAP's
        # "jobs/sec at fixed p99" story reads load-balancing lag from
        try:
            ts0 = float(entry.get("ts") or 0)
            if ts0 > 0:
                obsplane.observe_steal_latency(time.time() - ts0)
        except (TypeError, ValueError):
            pass
        log_event("job_stolen", uid=uid, victim=victim,
                  replica=self.replica_id)
        obs.lifecycle(uid, "stolen", side="thief", victim=victim,
                      replica=self.replica_id)
        obs.flush_trace(uid)
        return True

    # ---------------------------------------------------------- lifecycle

    def start(self, miner, recover: Optional[Callable[[], object]] = None
              ) -> None:
        """Wire the manager to its Miner and start the heartbeat thread
        (``heartbeat_s`` <= 0 means manual ticks — tests drive
        :meth:`tick` directly for determinism)."""
        self._miner = miner
        self._recover = recover
        if self.heartbeat_s <= 0 or self._thread is not None:
            return
        # a tick is a dozen or more store round trips, and the thread
        # takes the GIL back after each reply only when a CPU-bound
        # worker (a FILE source's parse) hands it over, once a switch
        # interval: at 5 ms a tick took 1.3 s on an H100 host and the
        # renewals came 2 s apart, a whole 2 s lease (ROADMAP Queue C
        # 14; the reference keeps the default).  Process-wide, as the
        # interval is
        if sys.getswitchinterval() > HEARTBEAT_SWITCH_S:
            sys.setswitchinterval(HEARTBEAT_SWITCH_S)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fsm-lease-{self.replica_id[:8]}")
        self._thread.start()

    def _loop(self) -> None:
        # a beat that comes later than half the TTL after the one before
        # is logged with the earlier tick's own wall: a long tick is a
        # slow store or pass, a short one a thread that did not get to
        # run (the leases of this replica lapse past the TTL)
        last, tick_s = time.monotonic(), 0.0
        while not self._stop.wait(self.heartbeat_s):
            t0 = time.monotonic()
            if t0 - last > self.lease_ttl_s / 2:
                log_event("lease_heartbeat_late", replica=self.replica_id,
                          gap_s=round(t0 - last, 3),
                          tick_s=round(tick_s, 3), ttl_s=self.lease_ttl_s)
            self.tick()
            last, tick_s = t0, time.monotonic() - t0

    def tick(self) -> None:
        """One heartbeat: publish load, renew held leases, and (on
        cadence) steal + recover.  Each phase is isolated — a store
        hiccup in one must not starve the others, and the thread must
        never die."""
        if self._guard is not None:
            # outage guard first: a healed store replays the spool (and
            # un-stalls jobs) BEFORE renewals re-prove the leases the
            # replay just reacquired
            try:
                self._guard.tick()
            except Exception as exc:
                log_event("storeguard_tick_failed", error=str(exc))
        try:
            self.publish_heartbeat()
        except Exception as exc:
            log_event("lease_heartbeat_failed", error=str(exc))
        self.sweep_unretracted()  # logs its own store failures
        try:
            self.renew_all()
        except Exception as exc:
            log_event("lease_renew_pass_failed", error=str(exc))
        try:
            self.steal_once()
        except Exception as exc:
            log_event("lease_steal_pass_failed", error=str(exc))
        if self._recover is not None and not self._quiesced:
            now = self._clock()
            if now >= self._next_recover:
                self._next_recover = now + self.recover_every_s
                try:
                    self._recover()
                except Exception as exc:
                    log_event("lease_periodic_recovery_failed",
                              error=str(exc))
        # background integrity scrub rides the heartbeat
        # cadence in clustered boots — next-due gating lives inside the
        # scrubber, this is one cheap global read per tick when idle
        try:
            from spark_fsm_tpu_torch.service import integrity
            integrity.tick()
        except Exception as exc:
            log_event("integrity_scrub_failed", error=str(exc))
        # usage-ledger flush rides the same cadence: settled
        # job vectors and avoided-cost credits land in the durable
        # fsm:usage:{tenant} records through the fenced write path —
        # min-interval gating lives inside the meter, one global read
        # per tick when idle or disabled
        try:
            from spark_fsm_tpu_torch.service import usage
            usage.tick()
        except Exception as exc:
            log_event("usage_flush_failed", error=str(exc))
        # degraded-topology gossip + probe rides the same
        # cadence: adopt peers' advertised mesh views (monotone merge —
        # max epoch, union dead rows) and run the cadenced zero-width
        # row probe.  One module-global read per tick when the guard is
        # off; probe cadence gating lives inside the guard.
        try:
            from spark_fsm_tpu_torch.service import meshguard
            g = meshguard.get()
            if g is not None:
                for p in self.peers(max_age_s=self.heartbeat_s or None):
                    g.merge_peer(p.get("mesh"))
                g.maybe_probe()
        except Exception as exc:
            log_event("meshguard_tick_failed", error=str(exc))

    def quiesce(self) -> None:
        """Stop pulling NEW work (steal scans, periodic adoption) while
        renewals continue — called at the START of the shutdown drain.
        Without it, a draining replica could steal a healthy peer's
        queued job only to give it a durable 'service shutting down'
        failure the client never deserved."""
        self._quiesced = True

    @property
    def draining(self) -> bool:
        return self._draining

    def set_draining(self, flag: bool = True) -> None:
        """Flip the scale-down drain state (Miner.drain): the heartbeat
        advertises ``draining`` with zero free capacity and the steal/
        adoption pulls stop — a departing replica must shed load, not
        attract it.  Publishes a fresh heartbeat immediately (best
        effort) so peers see the transition within one round-trip, not
        one heartbeat period."""
        self._draining = bool(flag)
        if flag:
            self._quiesced = True
        try:
            self.publish_heartbeat()
        except Exception as exc:
            log_event("lease_drain_heartbeat_failed", error=str(exc))

    def peer_inflight_fp(self, fp: str) -> bool:
        """Is ``fp`` (a dataset fingerprint) currently in flight as a
        coalescing leader on some peer?  Served from the heartbeat-
        cadence peer cache (the submit hot path must not scan the
        store); False on any error — the hint only ever costs a
        duplicate mine, never correctness."""
        try:
            for p in self.peers(max_age_s=max(self.heartbeat_s, 1.0)):
                if fp in (p.get("fps") or ()):
                    return True
        except Exception:
            pass
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(max(2.0, 2 * self.heartbeat_s))
            self._thread = None
        try:  # retract the heartbeat record so peers stop seeing us
            self._store.delete(self._hb_key)
        except Exception:
            pass

    def stats(self) -> dict:
        """The /admin/stats ``cluster`` block.  Peers come from the
        heartbeat-cadence cache — a stats poller must not drive KEYS
        scans against the shared store."""
        try:
            n_peers = len(self.peers(
                max_age_s=max(self.heartbeat_s, 1.0)))
        except Exception:
            n_peers = None
        return {"replica": self.replica_id,
                "lease_ttl_s": self.lease_ttl_s,
                "heartbeat_s": self.heartbeat_s,
                "steal": self.steal_enabled,
                "held": len(self._held),
                "peers": n_peers}
