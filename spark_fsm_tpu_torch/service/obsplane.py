"""Cluster observability plane — the flight recorder's
durable spine, the cross-replica metrics view, and SLO accounting.

earlier work made the service multi-replica, but every observability substrate
stayed process-local: the trace ring and /metrics die with the replica,
which is exactly when the lease protocol's failovers need evidence.
This module is the cluster-side counterpart of utils/obs.py:

- **Trace spine** (:class:`TraceSpine`): completed spans flush from the
  flight recorder's per-trace buffers (obs.set_spine) into
  ``fsm:trace:{uid}`` — an append-only list of JSON chunks, each tagged
  with the writing replica's id and fencing token.  The write rides the
  SAME fenced path as results/checkpoints: a holder whose lease was
  superseded has its spine appends REFUSED (counted in
  ``fsm_lease_fence_rejections_total`` next to the prevented result
  double-commits) and is tombstoned so even post-settle stragglers stay
  off the adopter's timeline.  A refused or failed spine write never
  fails the job — observability must not alter control flow.
- **Merged timeline** (:func:`merged_timeline`): the spine chunks plus
  the serving replica's local ring, de-duplicated by
  ``(replica, span_id)`` and ordered by wall-clock ``ts`` (monotonic
  clocks are per-process) — so after a kill -9 the SURVIVOR can show
  admission-on-A → adoption-on-B in one response.
- **Cluster metrics plane**: a scrape-time collector aggregating the
  lease heartbeat records' piggybacked metric snapshots into
  ``fsm_cluster_*`` gauges (total depth, in-flight, free capacity,
  leases held, sheds, lease churn, live replicas) — served identically
  from ANY replica, from the heartbeat-cadence peer cache (a scrape
  must never turn into a store scan storm).
- **SLO layer**: per-priority end-to-end latency (submit → durable
  result) split into queue-wait and execution components, observed into
  fixed-bucket ``fsm_job_*_seconds`` histograms (alertable rates) AND
  sliding-window quantiles (:class:`~spark_fsm_tpu_torch.utils.obs.
  SlidingQuantiles`) behind ``/admin/slo`` — the service-side
  counterpart of bench_throughput's offline p50/p99.

Disabled cost: with ``[cluster]`` off nothing here is installed and the
flight recorder's spine probe is one module-global read; with tracing
off no spans exist to flush.  The SLO histograms are always-on metrics
(per finished JOB, not per dispatch — the bench_smoke dispatch counters
cannot see them).

Port: a copy of ``spark_fsm_tpu/service/obsplane.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from spark_fsm_tpu_torch.service import storeguard
from spark_fsm_tpu_torch.utils import envelope, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event

# THE priority vocabulary: admission classes AND the SLO label seeding.
# Spelled here (the lowest service layer that needs it) and aliased by
# service/actors.PRIORITIES, so there is exactly one copy to extend.
PRIORITIES = ("high", "normal", "low")

_SPINE_WRITES = (obs.REGISTRY.counter(
    "fsm_trace_spine_writes_total",
    "durable trace-spine chunk appends, by outcome (fenced = a stale "
    "holder's spans refused — the observability analog of a prevented "
    "double-commit; spooled = deferred into the storeguard write-behind "
    "spool during a store outage)")
    .seed(outcome="ok").seed(outcome="fenced").seed(outcome="error")
    .seed(outcome="spooled"))
# the SAME counter service/lease.py registers — get-or-create returns
# the shared object, so spine refusals land next to the refused
# result/checkpoint writes they are the trace-plane analog of
_FENCE_REJECTED = obs.REGISTRY.counter("fsm_lease_fence_rejections_total")

_ADOPTION_S = obs.REGISTRY.histogram(
    "fsm_job_time_to_adoption_seconds",
    "failover latency: last durable activity of the dead owner (spine "
    "chunk ts, journal ts fallback) to a survivor's adoption — bounded "
    "by lease_ttl_s + recover_every_s when the cluster is healthy"
).seed()
_STEAL_LATENCY_S = obs.REGISTRY.histogram(
    "fsm_job_steal_latency_seconds",
    "work-steal latency: victim's admission (journal ts) to the "
    "thief's successful claim + resubmit").seed()

# the tenant label: bounded vocabulary — "default"
# from boot, fairness-registered tenants via seed_tenant — so per-tenant
# SLO quantiles exist and the scrape never shows no-data for a tenant
# that simply has not finished a job yet
DEFAULT_TENANT = "default"
_tenant_lock = threading.Lock()
_tenants = {DEFAULT_TENANT}

_E2E_S = obs.REGISTRY.histogram(
    "fsm_job_e2e_seconds",
    "end-to-end job latency, submit to durable result, per priority "
    "and tenant")
_QUEUE_WAIT_S = obs.REGISTRY.histogram(
    "fsm_job_queue_wait_seconds",
    "admission-queue wait, submit to first worker pickup, per priority "
    "and tenant")
_EXEC_S = obs.REGISTRY.histogram(
    "fsm_job_exec_seconds",
    "execution component of the end-to-end latency, per priority "
    "and tenant")
for _p in PRIORITIES:
    _E2E_S.seed(priority=_p, tenant=DEFAULT_TENANT)
    _QUEUE_WAIT_S.seed(priority=_p, tenant=DEFAULT_TENANT)
    _EXEC_S.seed(priority=_p, tenant=DEFAULT_TENANT)

# the read-path signal class: /predict latencies are ms-scale
# where mining jobs are seconds-scale, so they get their own histogram
# families (sub-ms buckets) and their own sliding-quantile block in
# /admin/slo — a flood of fast predicts must not drown the mining p99,
# and a mining stall must not hide a read-path regression
_PREDICT_E2E_S = obs.REGISTRY.histogram(
    "fsm_predict_e2e_seconds",
    "end-to-end /predict latency (request in -> predictions out), per "
    "priority", buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                         0.05, 0.1, 0.25, 1.0, 5.0))
_PREDICT_WINDOW_S = obs.REGISTRY.histogram(
    "fsm_predict_window_wait_seconds",
    "micro-batch window wait component (submit -> wave dispatch), per "
    "priority", buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                         0.05, 0.1, 0.25, 1.0, 5.0))
_PREDICT_EXEC_S = obs.REGISTRY.histogram(
    "fsm_predict_exec_seconds",
    "scoring-wave execution component (device launch + demux), per "
    "priority", buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                         0.05, 0.1, 0.25, 1.0, 5.0))
for _p in PRIORITIES:
    _PREDICT_E2E_S.seed(priority=_p, tenant=DEFAULT_TENANT)
    _PREDICT_WINDOW_S.seed(priority=_p, tenant=DEFAULT_TENANT)
    _PREDICT_EXEC_S.seed(priority=_p, tenant=DEFAULT_TENANT)


def seed_tenant(tenant: str) -> None:
    """Zero-seed the fsm_job_*_seconds, fsm_predict_*_seconds and
    fsm_usage_*_total series for a (fairness-registered, bounded)
    tenant across every priority class — the obs_smoke no-orphan check
    covers the result."""
    from spark_fsm_tpu_torch.service import usage as _usage

    with _tenant_lock:
        if tenant in _tenants:
            return
        _tenants.add(tenant)
    for p in PRIORITIES:
        _E2E_S.seed(priority=p, tenant=tenant)
        _QUEUE_WAIT_S.seed(priority=p, tenant=tenant)
        _EXEC_S.seed(priority=p, tenant=tenant)
        _PREDICT_E2E_S.seed(priority=p, tenant=tenant)
        _PREDICT_WINDOW_S.seed(priority=p, tenant=tenant)
        _PREDICT_EXEC_S.seed(priority=p, tenant=tenant)
    _usage.seed_tenant(tenant)


def known_tenants() -> List[str]:
    with _tenant_lock:
        return sorted(_tenants)


# sliding-window twins of the three histograms — the /admin/slo p50/p95/
# p99 source ([observability] slo_window_s); the per-priority windows
# keep their label shape, the per-tenant e2e window serves the tenant
# SLO block
_slo = {
    "e2e": obs.SlidingQuantiles(),
    "queue_wait": obs.SlidingQuantiles(),
    "exec": obs.SlidingQuantiles(),
}
_slo_tenant_e2e = obs.SlidingQuantiles()
# the read path's own sliding windows — same window knob, separate
# samples (see the fsm_predict_* histogram comment above)
_slo_predict = {
    "e2e": obs.SlidingQuantiles(),
    "window_wait": obs.SlidingQuantiles(),
    "exec": obs.SlidingQuantiles(),
}
# per-tenant read-path e2e window — the tenant
# twin of _slo_tenant_e2e for the /admin/slo predict block
_slo_predict_tenant = obs.SlidingQuantiles()

_lock = threading.Lock()
_plane: Optional["TraceSpine"] = None
_max_chunks = 256  # [observability] spine_max_chunks (0 = unbounded)


def spine_key(uid: str) -> str:
    return f"fsm:trace:{uid}"


class TraceSpine:
    """One replica's writer/reader of the durable trace spine.

    ``flush(uid, spans)`` is the obs.set_spine sink: it proves lease
    ownership the same way the result sink does (one local dict read on
    the fast path, a store verification once the local TTL lapses),
    wraps the batch in a chunk tagged ``{replica, token, ts}`` and
    appends it to ``fsm:trace:{uid}``.  Refusal rules, in order:

    1. this replica holds a LIVE lease on the uid → fence() and write
       under its token (the normal mid-job flush);
    2. the lease is marked LOST, or the uid is tombstoned from an
       earlier fencing → REFUSE (counted; the stale-epoch spans must
       never reach the adopter's timeline — the satellite test pins it);
    3. the uid was never leased here and is not tombstoned → write with
       ``token: null`` (stream pushes, solo deployments, and the final
       root-span flush that lands after a terminal release — the uid
       was settled BY US then, so the append is rightful).

    The residual race (fence passes, lease lapses before the rpush
    lands) is the same bounded CAD caveat the lease release documents:
    at worst a few stale SPANS — never results — land, tagged with the
    superseded token the merge exposes.
    """

    def __init__(self, store, lease_mgr=None,
                 max_chunks: Optional[int] = None):
        self._store = store
        self._mgr = lease_mgr
        self._max_chunks = max_chunks  # None = follow the module knob
        self._fenced: set = set()
        self.replica_id = (lease_mgr.replica_id if lease_mgr is not None
                           else "solo")
        # per-BOOT nonce: span_ids restart at 1 in every process, so a
        # crash-restarted replica with a config-pinned replica_id would
        # otherwise collide with its pre-crash chunks' span_ids and the
        # merge's dedup would silently drop the resumed incarnation's
        # spans — the exact post-mortem spans that matter
        self.boot_id = uuid.uuid4().hex[:8]

    def mark_fenced(self, uid: str) -> None:
        """Tombstone a uid whose lease this replica lost: later flushes
        (including the post-settle root-span flush) are refused until a
        fresh lease on the uid is proven."""
        self._fenced.add(uid)

    def flush(self, uid: str, spans: List[dict]) -> str:
        """Append one chunk; returns the outcome ("ok"/"fenced"/
        "error") — the obs sink ignores it, tests read it."""
        if not spans:
            return "ok"
        mgr = self._mgr
        token = None
        guard = storeguard.get()
        outage = guard is not None and guard.is_down()
        try:
            if mgr is not None:
                token = mgr.token_of(uid)
                if mgr.is_lost(uid) or (token is None
                                        and uid in self._fenced):
                    self._fenced.add(uid)
                    _FENCE_REJECTED.inc()
                    _SPINE_WRITES.inc(outcome="fenced")
                    return "fenced"
                if token is not None and not outage:
                    # during a proven outage the fence is deferred to
                    # the spool's replay gate (the journal-gated NX
                    # reacquire under the same token)
                    mgr.fence(uid)  # raises JobLeaseLost when superseded
                    self._fenced.discard(uid)
        except jobctl.JobLeaseLost:
            # fence() already counted the rejection
            self._fenced.add(uid)
            _SPINE_WRITES.inc(outcome="fenced")
            return "fenced"
        except Exception as exc:
            _SPINE_WRITES.inc(outcome="error")
            log_event("trace_spine_fence_error", uid=uid, error=str(exc))
            return "error"
        chunk = envelope.wrap(json.dumps(
            {"replica": self.replica_id, "boot": self.boot_id,
             "token": token, "ts": round(time.time(), 3), "spans": spans}))
        cap = self._max_chunks if self._max_chunks is not None \
            else _max_chunks
        try:
            if guard is not None:
                spooled = guard.spine(
                    uid, chunk, gate=("none" if token is None else None))
                if spooled:
                    _SPINE_WRITES.inc(outcome="spooled")
                    return "spooled"
            else:
                self._store.spine_append(uid, chunk)
            if cap:
                self._store.spine_trim(uid, cap)
            _SPINE_WRITES.inc(outcome="ok")
            return "ok"
        except Exception as exc:
            _SPINE_WRITES.inc(outcome="error")
            log_event("trace_spine_write_failed", uid=uid, error=str(exc))
            return "error"


def install(store, lease_mgr, flush_spans: Optional[int] = None) -> TraceSpine:
    """Build and activate this process's plane: spine sink into the
    flight recorder + the fsm_cluster_* collector.  The LAST install
    wins (tests build many Miners), same posture as the jobs
    collector."""
    global _plane
    plane = TraceSpine(store, lease_mgr)
    with _lock:
        _plane = plane
    obs.set_spine(plane.flush, flush_spans=flush_spans)
    if lease_mgr is not None:
        obs.REGISTRY.register_collector(
            "cluster", _cluster_collector(lease_mgr))
    return plane


def uninstall() -> None:
    """Remove the plane (test isolation): no spine sink, inert cluster
    collector."""
    global _plane
    with _lock:
        _plane = None
    obs.set_spine(None)
    obs.REGISTRY.register_collector("cluster", lambda: [])


def plane() -> Optional[TraceSpine]:
    return _plane


def mark_fenced(uid: str) -> None:
    """Module-level tombstone hook (lease._mark_lost and the fenced
    settle path call this; the hermetic tests use plane instances)."""
    p = _plane
    if p is not None:
        p.mark_fenced(uid)


def configure(ocfg) -> None:
    """Apply the boot ``[observability]`` knobs owned by this plane
    (config.set_config calls it alongside the tracing/watchdog/fusion
    wiring)."""
    global _max_chunks
    _max_chunks = int(ocfg.spine_max_chunks)
    obs.set_spine_flush(int(ocfg.spine_flush_spans))
    for sq in _slo.values():
        sq.set_window(float(ocfg.slo_window_s))
    _slo_tenant_e2e.set_window(float(ocfg.slo_window_s))
    for sq in _slo_predict.values():
        sq.set_window(float(ocfg.slo_window_s))
    _slo_predict_tenant.set_window(float(ocfg.slo_window_s))


# ---------------------------------------------------------------- timeline

def spine_chunks_verified(store, uid: str) -> "Tuple[List[dict], int]":
    """The uid's verified spine chunks + how many were dropped as
    corrupt.  Each chunk rides a checksum envelope (legacy bare-JSON
    chunks still parse); a chunk that fails the envelope OR json.loads
    OR isn't a dict is skipped and counted — one rotten chunk must
    never abort a timeline dump."""
    from spark_fsm_tpu_torch.service import integrity

    try:
        raws = store.spine_chunks(uid)
    except Exception:
        return [], 0
    out: List[dict] = []
    corrupt = 0
    for raw in raws:
        payload, verdict = envelope.unwrap(raw)
        c = None
        if verdict != "corrupt":
            try:
                c = json.loads(payload)
            except (ValueError, TypeError):
                c = None
            if not isinstance(c, dict):
                c, verdict = None, "corrupt"
        integrity.note_read("spine", verdict)
        if c is None:
            corrupt += 1
            continue
        out.append(c)
    return out, corrupt


def spine_chunks(store, uid: str) -> List[dict]:
    """The uid's parsed spine chunks (malformed entries skipped)."""
    return spine_chunks_verified(store, uid)[0]


def last_activity_ts(store, uid: str) -> Optional[float]:
    """Wall timestamp of the uid's most recent spine chunk — the
    adopter's reference point for time-to-adoption (the dead owner's
    last durable flush is its last provable sign of life)."""
    ts = []
    for c in spine_chunks(store, uid):
        try:
            ts.append(float(c.get("ts") or 0))
        except (TypeError, ValueError):
            pass
    ts = [t for t in ts if t > 0]
    return max(ts) if ts else None


def merged_timeline(store, uid: str, local_dump: Optional[dict] = None,
                    replica_id: Optional[str] = None,
                    boot_id: Optional[str] = None) -> Optional[dict]:
    """One monotonic cross-replica timeline: spine chunks + the local
    ring, de-duplicated by ``(replica, boot, span_id)`` (the local
    ring's spans were themselves flushed to the spine, but span_ids
    restart per process — the boot nonce keeps a crash-restarted
    replica's resumed spans distinct from its pre-crash ones), ordered
    by wall ``ts``.  ``boot_id`` is the serving replica's current boot
    nonce (its local ring was flushed under it); None when neither
    source knows the uid."""
    chunks, corrupt_chunks = spine_chunks_verified(store, uid)
    spans: List[dict] = []
    seen = set()
    replicas = set()
    for c in chunks:
        rid = c.get("replica") or "?"
        boot = c.get("boot")
        for s in c.get("spans", ()):
            if not isinstance(s, dict):
                continue
            key = (rid, boot, s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            s = dict(s)
            s["replica"] = rid
            if c.get("token") is not None:
                s["token"] = c["token"]
            spans.append(s)
            replicas.add(rid)
    if local_dump:
        rid = replica_id or "local"
        for s in local_dump.get("spans", ()):
            key = (rid, boot_id, s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            s = dict(s)
            s["replica"] = rid
            spans.append(s)
            replicas.add(rid)
    if not spans and local_dump is None and not corrupt_chunks:
        return None

    def _order(s: dict):
        # damaged chunks can smuggle mixed-type ts/span_id values past
        # json.loads; the sort must not TypeError on them
        try:
            ts = float(s.get("ts") or 0.0)
        except (TypeError, ValueError):
            ts = 0.0
        sid = s.get("span_id")
        if isinstance(sid, (int, float)):
            return (ts, 0, sid, "")
        return (ts, 1, 0, str(sid))

    spans.sort(key=_order)
    return {"trace_id": uid, "merged": True,
            "replicas": sorted(replicas),
            "n_spans": len(spans), "spine_chunks": len(chunks),
            "corrupt_chunks": corrupt_chunks,
            "attrs": dict((local_dump or {}).get("attrs", {})),
            "dropped_spans": (local_dump or {}).get("dropped_spans", 0),
            "spans": spans}


# ------------------------------------------------------- failover metrics

def observe_adoption(seconds: float) -> None:
    _ADOPTION_S.observe(max(0.0, float(seconds)))


def observe_steal_latency(seconds: float) -> None:
    _STEAL_LATENCY_S.observe(max(0.0, float(seconds)))


# ---------------------------------------------------------------- SLO layer

def observe_job(priority: str, e2e_s: float, queue_wait_s: float,
                exec_s: float, tenant: str = DEFAULT_TENANT) -> None:
    """One finished job's latency decomposition (submit → durable
    result = queue wait + execution), into both the fixed-bucket
    histograms (labelled by priority AND tenant) and the sliding SLO
    windows.  An unregistered tenant folds into "default" — the label
    vocabulary stays bounded by the fairness registry."""
    if priority not in PRIORITIES:
        priority = "normal"
    with _tenant_lock:
        if tenant not in _tenants:
            tenant = DEFAULT_TENANT
    _E2E_S.observe(e2e_s, priority=priority, tenant=tenant)
    _QUEUE_WAIT_S.observe(queue_wait_s, priority=priority, tenant=tenant)
    _EXEC_S.observe(exec_s, priority=priority, tenant=tenant)
    _slo["e2e"].observe(e2e_s, priority=priority)
    _slo["queue_wait"].observe(queue_wait_s, priority=priority)
    _slo["exec"].observe(exec_s, priority=priority)
    _slo_tenant_e2e.observe(e2e_s, tenant=tenant)


def observe_predict(priority: str, e2e_s: float, window_wait_s: float,
                    exec_s: float,
                    tenant: str = DEFAULT_TENANT) -> None:
    """One served /predict's latency decomposition (request in ->
    predictions out = window wait + wave execution) into the read-path
    histogram families and sliding SLO windows — the second signal
    class next to observe_job's mining-path one.  An unregistered
    tenant folds into "default", same bounded-vocabulary rule as
    observe_job."""
    if priority not in PRIORITIES:
        priority = "normal"
    with _tenant_lock:
        if tenant not in _tenants:
            tenant = DEFAULT_TENANT
    _PREDICT_E2E_S.observe(e2e_s, priority=priority, tenant=tenant)
    _PREDICT_WINDOW_S.observe(window_wait_s, priority=priority,
                              tenant=tenant)
    _PREDICT_EXEC_S.observe(exec_s, priority=priority, tenant=tenant)
    _slo_predict["e2e"].observe(e2e_s, priority=priority)
    _slo_predict["window_wait"].observe(window_wait_s, priority=priority)
    _slo_predict["exec"].observe(exec_s, priority=priority)
    _slo_predict_tenant.observe(e2e_s, tenant=tenant)


def slo_snapshot() -> dict:
    """The /admin/slo body: per-priority p50/p95/p99 (+count/max) of
    each latency component over the sliding window."""
    out: Dict[str, object] = {
        "window_s": _slo["e2e"].window_s,
        "ts": round(time.time(), 3),
        "priorities": {},
    }
    for p in PRIORITIES:
        out["priorities"][p] = {
            kind: sq.stats(priority=p) for kind, sq in _slo.items()}
    # per-tenant e2e quantiles: every registered
    # tenant gets a row — {"count": 0} until it finishes a job
    out["tenants"] = {t: _slo_tenant_e2e.stats(tenant=t)
                      for t in known_tenants()}
    # read-path quantiles: /predict's own per-priority block
    # so a dashboard can alert on serving p99 independently of mining
    out["predict"] = {
        p: {kind: sq.stats(priority=p)
            for kind, sq in _slo_predict.items()}
        for p in PRIORITIES}
    # per-tenant read-path e2e quantiles: every
    # registered tenant gets a row — {"count": 0} until it predicts
    out["predict_tenants"] = {t: _slo_predict_tenant.stats(tenant=t)
                              for t in known_tenants()}
    return out


def slo_digest() -> dict:
    """COMPACT per-replica SLO digest piggybacked on the lease
    heartbeat (the fleet-wide up_p99 merge): the worst per-priority e2e
    p99 over the local sliding window plus the sample count behind it.
    The autoscale leader scales on the FLEET max of these, so an idle
    leader is no longer blind to a saturating peer."""
    worst, n = None, 0
    for p in PRIORITIES:
        st = _slo["e2e"].stats(priority=p)
        c = int(st.get("count") or 0)
        n += c
        p99 = st.get("p99")
        if c and p99 is not None:
            worst = p99 if worst is None else max(worst, p99)
    return {"p99": (None if worst is None else round(float(worst), 4)),
            "n": n}


def clear_slo() -> None:
    """Drop the sliding windows (test isolation)."""
    for sq in _slo.values():
        sq.clear()
    _slo_tenant_e2e.clear()
    for sq in _slo_predict.values():
        sq.clear()
    _slo_predict_tenant.clear()


# ------------------------------------------------------ cluster collector

def _cluster_collector(mgr):
    """Scrape-time fsm_cluster_* gauges from the heartbeat-cadence peer
    cache (never a fresh store scan — a scrape storm must not become a
    SCAN storm)."""

    def collect():
        view = mgr.cluster_view()
        t = view["totals"]

        def g(name, help, value):
            return (name, "gauge", help, [({}, float(value))])

        return [
            g("fsm_cluster_replicas",
              "live replicas (self + un-expired heartbeat records)",
              t["replicas"]),
            g("fsm_cluster_queue_depth",
              "queued train jobs across live replicas", t["queued"]),
            g("fsm_cluster_in_flight",
              "running train jobs across live replicas", t["running"]),
            g("fsm_cluster_free_capacity",
              "advertised idle worker slots across live replicas",
              t["free"]),
            g("fsm_cluster_leases_held",
              "job leases held across live replicas", t["held"]),
            g("fsm_cluster_sheds",
              "429 sheds across live replicas (sum of advertised "
              "lifetime counters)", t["sheds"]),
            g("fsm_cluster_lease_churn",
              "lease acquisitions + losses across live replicas — "
              "rising churn at stable job volume means flapping "
              "ownership (TTL too tight)", t["lease_churn"]),
        ]

    return collect
