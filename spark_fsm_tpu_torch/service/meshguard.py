"""Topology-survival plane: partition-row health, mesh epochs, and the
crash-loop (poison-job) quarantine ledger.

Every committed failure domain so far — store blips (storeguard),
replica crashes (lease), corrupt durable state (integrity) — assumed
the device topology itself is immortal: a TPU host dropping out of the
partitioned 2-D mesh (or one partition row wedging past its watchdog)
failed the whole mine.  This module is the registry that turns "a chip
died" into "a slower mine":

- **Row health state machine** (healthy -> suspect -> dead): fed by the
  engines' existing failure surfaces — dispatch watchdog timeouts,
  ``device.dispatch`` / ``device.resident`` fault trips — plus an
  active zero-width probe per row (a ``device_put`` of an empty array
  on the row's own devices, riding the lease heartbeat).  The FIRST
  device-shaped trip only marks a row suspect; ``[meshguard]
  dead_after`` trips kill it.  A suspect row that answers a probe (or
  completes a round) heals back to healthy; a dead row never heals in
  place — operators replace hardware, they do not resurrect it.

- **Topology epochs**: every row death bumps a monotonic
  ``topology_epoch``.  Engines capture the epoch at construction and
  re-check it at each dispatch entry (``check_epoch``); the fusion
  broker does the same per wave — a launch planned against a stale
  mesh is REFUSED (``StaleTopology``) before it touches dead silicon,
  counted in ``fsm_mesh_stale_epoch_refused_total``.  Epoch + dead-row
  set publish on the lease heartbeat (``heartbeat_payload``) and merge
  from peers (``merge_peer``: max epoch wins, dead sets union), so the
  fleet agrees which rows are dead without a coordinator.

- **Poison-job quarantine ledger**: a job whose dataset
  deterministically crashes its holder rides lease adoption forever,
  burning every replica in turn.  ``recover_orphans`` counts adoption
  resubmits in the journal intent; past ``[cluster] max_adoptions``
  the job settles as a durable ``POISON:`` failure and this module
  writes the ``fsm:quarantine:{uid}`` record (surface ``"poison"``,
  enveloped, with the last holder's trace-spine tail as evidence).
  Admission refuses a quarantined uid with 409 until
  ``/admin/quarantine`` releases it — the helpers here are shared by
  service/actors.py and service/app.py.

Cost contract (the utils/faults pin): with ``[meshguard]`` disabled
(the default) every engine-side probe — ``note_row_fault``,
``note_row_ok``, ``current_epoch``, ``check_epoch`` — is ONE
module-global read, and dispatch behavior is byte-identical to a
build without the plane.

Port: a copy of ``spark_fsm_tpu/service/meshguard.py`` with its imports
pointed at ``spark_fsm_tpu_torch``; the row probe allocates a zero-size
tensor on each device and synchronizes the card.  ``[meshguard] enabled``
is refused at boot until the partitioned engines adopt a failed row
(ROADMAP A13b).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from spark_fsm_tpu_torch.utils import envelope, faults, obs
from spark_fsm_tpu_torch.utils.obs import log_event

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

#: the quarantine surface that marks a crash-loop poison record (the
#: integrity plane's quarantines use "journal"/"checkpoint"/... — only
#: ``poison`` records block re-admission)
POISON_SURFACE = "poison"

QUARANTINE_PREFIX = "fsm:quarantine:"

_EPOCH = obs.REGISTRY.gauge(
    "fsm_mesh_epoch",
    "current topology epoch (bumps on every partition-row death)")
_ROWS_DEAD = obs.REGISTRY.gauge(
    "fsm_mesh_rows_dead", "partition rows currently fenced as dead")
_TRANSITIONS = obs.REGISTRY.counter(
    "fsm_mesh_row_transitions_total",
    "partition-row health transitions, by destination state")
_PROBES = obs.REGISTRY.counter(
    "fsm_mesh_probes_total",
    "active zero-width row probes, by outcome")
_REPLANS = obs.REGISTRY.counter(
    "fsm_mesh_replans_total",
    "degraded re-plans (replan_surviving adoptions of dead rows' "
    "classes onto survivors)")
_STALE_REFUSED = obs.REGISTRY.counter(
    "fsm_mesh_stale_epoch_refused_total",
    "dispatches refused because they were planned against a stale "
    "topology epoch")
_QUARANTINE_TOTAL = obs.REGISTRY.counter(
    "fsm_quarantine_jobs_total",
    "crash-loop quarantine events, by outcome (poisoned = settled as "
    "durable POISON past max_adoptions; refused = admission 409 on a "
    "quarantined uid; released = operator release via "
    "/admin/quarantine)")
_EPOCH.set(0.0)
_ROWS_DEAD.set(0.0)
for _to in (HEALTHY, SUSPECT, DEAD):
    _TRANSITIONS.seed(to=_to)
for _o in ("ok", "failed"):
    _PROBES.seed(outcome=_o)
for _o in ("poisoned", "refused", "released"):
    _QUARANTINE_TOTAL.seed(outcome=_o)


class StaleTopology(RuntimeError):
    """A dispatch (or fused wave) was planned against a topology epoch
    that a row death has since invalidated.  Raised at the dispatch /
    broker entry — BEFORE any device work — so the orchestrator's
    adoption loop rebuilds against the surviving mesh instead of
    launching on dead silicon."""

    def __init__(self, planned: int, current: int):
        self.planned = int(planned)
        self.current = int(current)
        super().__init__(
            f"stale topology epoch: launch planned at epoch {planned} "
            f"but the mesh is at epoch {current} (a partition row died "
            f"in between); re-plan against the surviving topology")


def _device_shaped(exc: BaseException) -> bool:
    """Only DEVICE failures move a row's health — a store blip or a
    cancelled job says nothing about silicon.  Fault-injected trips
    (chaos drills), dispatch-watchdog timeouts, and XLA runtime errors
    (matched by name: jaxlib's class path moves across versions)
    qualify; everything else is ignored."""
    if isinstance(exc, faults.FaultInjected):
        return True
    try:
        from spark_fsm_tpu_torch.utils.watchdog import WatchdogTimeout
        if isinstance(exc, WatchdogTimeout):
            return True
    except Exception:
        pass
    name = type(exc).__name__
    return "XlaRuntimeError" in name or "RuntimeError" == name and (
        "RESOURCE_EXHAUSTED" in str(exc) or "device" in str(exc).lower())


class MeshGuard:
    """Per-partition-row health registry + epoch counter.  One instance
    per process (module singleton via :func:`install`); all state under
    one lock — transitions are rare (a row death is an outage, not a
    hot path) and reads take the lock only on the slow paths."""

    def __init__(self, dead_after: int = 2, probe_every_s: float = 0.0,
                 max_retries: int = 4,
                 clock=time.monotonic) -> None:
        self.dead_after = max(1, int(dead_after))
        self.probe_every_s = float(probe_every_s)
        self.max_retries = max(1, int(max_retries))
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[int, str] = {}
        self._trips: Dict[int, int] = {}
        self._epoch = 0
        # row -> tuple of jax devices, registered by the partitioned
        # orchestrator so the active probe knows what to touch
        self._row_devices: Dict[int, tuple] = {}
        self._next_probe = 0.0

    # -- health state machine ---------------------------------------------

    def state_of(self, row: int) -> str:
        with self._lock:
            return self._state.get(int(row), HEALTHY)

    def dead_rows(self) -> frozenset:
        with self._lock:
            return frozenset(r for r, s in self._state.items() if s == DEAD)

    def note_row_fault(self, row: int, exc: Optional[BaseException] = None
                       ) -> Optional[str]:
        """Record one device-shaped failure against ``row``; returns the
        row's new state.  Non-device exceptions are IGNORED (state
        unchanged, returns None — the caller's signal to re-raise
        rather than retry); callers may pass ``exc=None`` when they
        have already classified the failure as device-shaped."""
        if exc is not None and not _device_shaped(exc):
            return None
        row = int(row)
        with self._lock:
            if self._state.get(row) == DEAD:
                return DEAD
            self._trips[row] = self._trips.get(row, 0) + 1
            if self._trips[row] >= self.dead_after:
                return self._kill_locked(row)
            if self._state.get(row) != SUSPECT:
                self._state[row] = SUSPECT
                _TRANSITIONS.inc(to=SUSPECT)
                log_event("mesh_row_suspect", row=row,
                          trips=self._trips[row])
            return SUSPECT

    def note_row_ok(self, row: int) -> None:
        """A row answered (probe returned, round completed): a suspect
        row heals; a dead row stays dead."""
        row = int(row)
        with self._lock:
            if self._state.get(row) == SUSPECT:
                self._state[row] = HEALTHY
                self._trips[row] = 0
                _TRANSITIONS.inc(to=HEALTHY)
                log_event("mesh_row_healed", row=row)

    def mark_dead(self, row: int) -> str:
        """Operator/peer-driven fence: kill a row unconditionally."""
        with self._lock:
            return self._kill_locked(int(row))

    def _kill_locked(self, row: int) -> str:
        if self._state.get(row) != DEAD:
            self._state[row] = DEAD
            self._epoch += 1
            _TRANSITIONS.inc(to=DEAD)
            _EPOCH.set(float(self._epoch))
            _ROWS_DEAD.set(float(
                sum(1 for s in self._state.values() if s == DEAD)))
            log_event("mesh_row_dead", row=row, epoch=self._epoch)
        return DEAD

    # -- topology epochs ---------------------------------------------------

    def current_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def check_epoch(self, planned: Optional[int]) -> None:
        """Refuse a launch planned against a stale epoch.  ``None``
        passes (the launch predates the plane or partitioning is off)."""
        if planned is None:
            return
        with self._lock:
            current = self._epoch
        if int(planned) != current:
            _STALE_REFUSED.inc()
            raise StaleTopology(int(planned), current)

    # -- active probe ------------------------------------------------------

    def register_rows(self, row_devices: Dict[int, tuple]) -> None:
        """The partitioned orchestrator hands over each row's device
        tuple so :meth:`probe` knows what to touch."""
        with self._lock:
            self._row_devices.update(
                {int(r): tuple(d) for r, d in row_devices.items()})

    def probe(self, rows: Optional[Iterable[int]] = None) -> Dict[int, str]:
        """Zero-width dispatch on each registered (or given) row's own
        devices: a ``device_put`` of an empty array, blocked to
        completion.  Cheap enough to ride the heartbeat — no math, no
        compile — but it exercises the same transfer path a real launch
        does.  Returns row -> resulting state."""
        with self._lock:
            targets = {r: self._row_devices.get(int(r), ())
                       for r in (rows if rows is not None
                                 else list(self._row_devices))}
        out: Dict[int, str] = {}
        for row, devs in targets.items():
            if self.state_of(row) == DEAD:
                out[row] = DEAD
                continue
            try:
                faults.fault_site("device.dispatch", point="probe",
                                  part=f"part{row}")
                if devs:
                    import torch
                    for dev in devs:
                        dev = torch.device(dev)
                        torch.empty(0, dtype=torch.int32, device=dev)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                _PROBES.inc(outcome="ok")
                self.note_row_ok(row)
                out[row] = self.state_of(row)
            except Exception as exc:  # noqa: BLE001 — probe failures fence
                _PROBES.inc(outcome="failed")
                st = self.note_row_fault(row, None if _device_shaped(exc)
                                         else exc)
                out[row] = st if st is not None else self.state_of(row)
        return out

    def maybe_probe(self) -> None:
        """Cadenced probe for the lease tick: runs at most every
        ``probe_every_s`` (0 = passive trips only, never probes)."""
        if self.probe_every_s <= 0:
            return
        now = self._clock()
        with self._lock:
            if now < self._next_probe:
                return
            self._next_probe = now + self.probe_every_s
        self.probe()

    # -- fleet agreement (heartbeat payload) -------------------------------

    def heartbeat_payload(self) -> dict:
        with self._lock:
            dead = sorted(r for r, s in self._state.items() if s == DEAD)
            return {"epoch": self._epoch, "dead": dead}

    def merge_peer(self, payload: Optional[dict]) -> None:
        """Adopt a peer's view: dead sets union (a row any replica
        proved dead is dead for everyone), epoch converges to the max —
        monotone in both coordinates, so gossip order cannot matter."""
        if not isinstance(payload, dict):
            return
        try:
            peer_epoch = int(payload.get("epoch", 0))
            peer_dead = [int(r) for r in payload.get("dead", ())]
        except (TypeError, ValueError):
            return
        with self._lock:
            for row in peer_dead:
                if self._state.get(row) != DEAD:
                    self._state[row] = DEAD
                    _TRANSITIONS.inc(to=DEAD)
                    log_event("mesh_row_dead_peer", row=row)
            self._epoch = max(self._epoch, peer_epoch)
            _EPOCH.set(float(self._epoch))
            _ROWS_DEAD.set(float(
                sum(1 for s in self._state.values() if s == DEAD)))

    def stats(self) -> dict:
        with self._lock:
            return {"epoch": self._epoch,
                    "rows": dict(sorted(self._state.items())),
                    "dead_after": self.dead_after,
                    "probe_every_s": self.probe_every_s}


# -- module singleton ------------------------------------------------------

_guard: Optional[MeshGuard] = None


def install(cfg=None, clock=time.monotonic) -> Optional[MeshGuard]:
    """Install the process guard from a MeshguardConfig (None/disabled
    uninstalls — every probe then costs one module-global read)."""
    global _guard
    if cfg is None or not getattr(cfg, "enabled", False):
        _guard = None
        return None
    _guard = MeshGuard(dead_after=getattr(cfg, "dead_after", 2),
                       probe_every_s=getattr(cfg, "probe_every_s", 0.0),
                       max_retries=getattr(cfg, "max_retries", 4),
                       clock=clock)
    return _guard


def get() -> Optional[MeshGuard]:
    return _guard


def reset() -> None:
    """Test hook: drop the singleton (module metrics keep their counts —
    the registry owns those)."""
    global _guard
    _guard = None


# engine-side fast paths: one module-global read when the plane is off

def current_epoch() -> Optional[int]:
    g = _guard
    return None if g is None else g.current_epoch()


def check_epoch(planned: Optional[int]) -> None:
    g = _guard
    if g is not None:
        g.check_epoch(planned)


def note_row_fault(row: Optional[int],
                   exc: Optional[BaseException] = None) -> Optional[str]:
    g = _guard
    if g is None or row is None:
        return None
    return g.note_row_fault(row, exc)


def note_row_ok(row: Optional[int]) -> None:
    g = _guard
    if g is not None and row is not None:
        g.note_row_ok(row)


def note_replan(dead_rows: Iterable[int]) -> None:
    _REPLANS.inc()
    log_event("mesh_replan", dead=sorted(int(r) for r in dead_rows))


# -- crash-loop (poison) quarantine ledger ---------------------------------

def quarantine_key(uid: str) -> str:
    return QUARANTINE_PREFIX + str(uid)


def poison_record(store, uid: str, *, reason: str, adoptions: int,
                  evidence: Optional[list] = None,
                  raw_intent: Optional[str] = None) -> str:
    """Write the durable poison record for ``uid`` (enveloped,
    idempotent: re-settling an already-quarantined uid neither rewrites
    nor recounts).  ``evidence`` is the last holder's trace-spine tail;
    ``raw_intent`` preserves the journal bytes the way integrity
    quarantines do."""
    qkey = quarantine_key(uid)
    if store.peek(qkey) is None:
        rec = json.dumps({
            "key": f"fsm:journal:{uid}", "surface": POISON_SURFACE,
            "uid": str(uid), "ts": round(time.time(), 3),
            "reason": str(reason), "adoptions": int(adoptions),
            "evidence": evidence or [], "value": raw_intent,
        })
        store.set(qkey, envelope.wrap(rec))
        _QUARANTINE_TOTAL.inc(outcome="poisoned")
        log_event("quarantine_poisoned", uid=uid, adoptions=adoptions)
    return qkey


def poisoned(store, uid: str) -> Optional[dict]:
    """The admission gate's peek: the poison record for ``uid``, or
    None.  Integrity quarantines (surface journal/checkpoint/...) do
    NOT block re-admission — only crash-loop poison does."""
    raw = store.peek(quarantine_key(uid))
    if raw is None:
        return None
    payload, verdict = envelope.unwrap(raw)
    if verdict == "corrupt" or payload is None:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    if isinstance(rec, dict) and rec.get("surface") == POISON_SURFACE:
        return rec
    return None


def note_refused(uid: str) -> None:
    _QUARANTINE_TOTAL.inc(outcome="refused")
    log_event("quarantine_refused", uid=uid)


def quarantine_list(store, limit: int = 100) -> List[dict]:
    """The ``/admin/quarantine`` listing: every ``fsm:quarantine:*``
    record (poison AND integrity surfaces — one place to see all
    preserved damage), poison fields surfaced when present."""
    out: List[dict] = []
    for qkey in itertools.islice(store.scan_iter(QUARANTINE_PREFIX),
                                 int(limit)):
        row = {"quarantine_key": qkey}
        payload, verdict = envelope.unwrap(store.peek(qkey))
        if verdict != "corrupt" and payload is not None:
            try:
                rec = json.loads(payload)
                if isinstance(rec, dict):
                    for k in ("uid", "key", "surface", "ts", "reason",
                              "adoptions"):
                        if rec.get(k) is not None:
                            row[k] = rec[k]
            except ValueError:
                pass
        out.append(row)
    return out


def quarantine_release(store, uid: str) -> bool:
    """Operator release: delete the quarantine record so the uid may be
    resubmitted.  Returns False when no record existed (the 404 case)."""
    qkey = quarantine_key(uid)
    if store.peek(qkey) is None:
        return False
    store.delete(qkey)
    _QUARANTINE_TOTAL.inc(outcome="released")
    log_event("quarantine_released", uid=uid)
    return True
