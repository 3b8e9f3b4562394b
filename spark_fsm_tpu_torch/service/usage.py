"""Resource attribution & usage metering plane.

Every unit of device work the platform dispatches — broker launches,
direct engine evals, resident-frontier segments, SPAM waves, predict
scoring waves — is attributed to the JOB that caused it, and through
the job's ``JobControl.tenant`` to the tenant, under a *conservation
invariant*: summed per-job attribution equals the existing global
dispatch counters exactly.

Integer quantities (launches, traffic units) are split across the jobs
sharing a launch by **lane share** with largest-remainder apportionment
(:func:`split_integral`) — the per-lane ``Launch.jobs`` tags the fusion
broker already plans with are the ground truth of who occupied the
device, and integer apportionment sums back to the launch total
EXACTLY, which re-running the cost model per job would not (per-job
re-plans see different pad/overhead and their sum drifts from what was
actually dispatched).  Float quantities (estimated and measured device
seconds) split proportionally to traffic share.

Attribution lands in three places:

* live per-job accumulators (``deposit``), mirrored onto the owning
  ``JobControl.usage`` and carried across kill -9/adoption inside the
  ``frontier_state`` checkpoint (``checkpoint_snapshot`` / ``resume``
  — resume REPLACES, never adds, so an adopter re-depositing its own
  work can never double-bill);
* per-tenant windowed rollups (``settle``), credited with the *avoided*
  cost of rescache exact/dominated/coalesced serves priced from the
  cached entry's recorded usage (``credit_avoided``);
* a durable per-tenant ledger — enveloped ``fsm:usage:{tenant}``
  records flushed on the lease heartbeat (cluster) or a private timer
  (solo).  Job entries inside a ledger record are keyed by uid and
  REPLACED on re-flush, so an adopter's final settle overwrites the
  dead replica's partial entry instead of double-billing; a job whose
  lease is lost at flush time is fenced out of the flush entirely (the
  adopter owns its ledger row now).

Disabled posture (``[usage] enabled = false``, the default off state):
every probe returns after ONE module-global read (``_meter is None``)
— the same contract as ``fusion.dispatch_wave`` and ``faults._active``,
pinned by test_usage.py and bench_smoke's byte-identical counters.

Port: a copy of ``spark_fsm_tpu/service/usage.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from spark_fsm_tpu_torch.utils import envelope, jobctl, obs
from spark_fsm_tpu_torch.utils.obs import log_event

#: durable key prefix for the per-tenant ledger records
LEDGER_PREFIX = "fsm:usage:"

#: the per-job attribution vector — every surface deposits these five
FIELDS = ("device_seconds_est", "device_seconds_measured", "launches",
          "traffic_units", "readback_bytes")

#: ledger records keep at most this many per-uid job entries per tenant;
#: older entries age out with their contribution FROZEN into the
#: record's totals (they can no longer be replaced by an adopter —
#: adoption happens within seconds, eviction after dozens of jobs)
LEDGER_JOBS_CAP = 64

# -- zero-seeded metric families (always registered, even disabled) -------
_DEVICE_SECONDS = obs.REGISTRY.counter(
    "fsm_usage_device_seconds_total",
    "measured device-seconds attributed to jobs, by tenant").seed(
        tenant="default")
_LAUNCHES = obs.REGISTRY.counter(
    "fsm_usage_launches_total",
    "device launches attributed to jobs, by tenant — sums exactly to "
    "the global dispatch counters (conservation invariant)").seed(
        tenant="default")
_TRAFFIC = obs.REGISTRY.counter(
    "fsm_usage_traffic_units_total",
    "cost-model traffic units attributed to jobs, by tenant").seed(
        tenant="default")
_AVOIDED = obs.REGISTRY.counter(
    "fsm_usage_avoided_device_seconds_total",
    "device-seconds NOT spent thanks to rescache serves, priced from "
    "the cached entry's recorded usage, by tenant").seed(
        tenant="default")
_FLUSHES = obs.REGISTRY.counter(
    "fsm_usage_flushes_total",
    "durable ledger flushes, by tenant").seed(tenant="default")


def seed_tenant(tenant: str) -> None:
    """Zero-seed every fsm_usage_* family for ``tenant`` (called from
    obsplane.seed_tenant so the fairness vocabulary and the usage
    vocabulary can never drift apart)."""
    for c in (_DEVICE_SECONDS, _LAUNCHES, _TRAFFIC, _AVOIDED, _FLUSHES):
        c.seed(tenant=tenant)


def split_integral(total: int, weights: Sequence[float]) -> List[int]:
    """Deterministic largest-remainder apportionment of an integer
    ``total`` across ``weights``: the result sums to ``total`` EXACTLY.

    Quotas are ``total * w/sum(w)``; every share gets its floor, and
    the leftover units go to the largest fractional remainders
    (ties broken by lowest index, so callers passing weights in sorted
    job order get a stable plurality winner).  Degenerate weights
    (empty sum) fall back to equal shares."""
    n = len(weights)
    if n == 0:
        return []
    total = int(total)
    wsum = float(sum(weights))
    if wsum <= 0:
        weights = [1.0] * n
        wsum = float(n)
    quotas = [total * (float(w) / wsum) for w in weights]
    out = [int(q) for q in quotas]
    rem = total - sum(out)
    if rem > 0:
        order = sorted(range(n), key=lambda i: (out[i] - quotas[i], i))
        for i in order[:rem]:
            out[i] += 1
    return out


def _zero_vector() -> Dict[str, float]:
    return {"device_seconds_est": 0.0, "device_seconds_measured": 0.0,
            "launches": 0, "traffic_units": 0, "readback_bytes": 0}


def _tenant_zero() -> dict:
    z = _zero_vector()
    z.update(avoided_device_seconds=0.0, jobs_settled=0)
    return z


def _add(dst: dict, src: dict, sign: int = 1) -> None:
    for f in FIELDS:
        v = src.get(f) or 0
        dst[f] = dst.get(f, 0) + sign * (float(v) if "seconds" in f
                                         else int(v))


class _JobUsage:
    """Live per-job accumulator (one per in-flight uid)."""

    __slots__ = ("tenant", "device_seconds_est", "device_seconds_measured",
                 "launches", "traffic_units", "readback_bytes")

    def __init__(self, tenant: str = "default"):
        self.tenant = tenant
        self.device_seconds_est = 0.0
        self.device_seconds_measured = 0.0
        self.launches = 0
        self.traffic_units = 0
        self.readback_bytes = 0

    def as_dict(self) -> dict:
        return {"tenant": self.tenant,
                "device_seconds_est": round(self.device_seconds_est, 9),
                "device_seconds_measured": round(
                    self.device_seconds_measured, 9),
                "launches": self.launches,
                "traffic_units": self.traffic_units,
                "readback_bytes": self.readback_bytes}

    @classmethod
    def from_dict(cls, d: dict) -> "_JobUsage":
        j = cls(str(d.get("tenant") or "default"))
        j.device_seconds_est = float(d.get("device_seconds_est") or 0.0)
        j.device_seconds_measured = float(
            d.get("device_seconds_measured") or 0.0)
        j.launches = int(d.get("launches") or 0)
        j.traffic_units = int(d.get("traffic_units") or 0)
        j.readback_bytes = int(d.get("readback_bytes") or 0)
        return j


class Meter:
    """The process-wide usage meter: live job accumulators, per-tenant
    rollups + sliding window, avoided-cost credits, and the durable
    ledger flusher."""

    def __init__(self, *, window_s: float = 300.0,
                 flush_every_s: float = 15.0, top_jobs: int = 10,
                 max_recent: int = 512):
        self._lock = threading.Lock()
        self._jobs: Dict[str, _JobUsage] = {}
        self._tenants: Dict[str, dict] = {"default": _tenant_zero()}
        # settled-but-unflushed job vectors, keyed by uid (the durable
        # flush unit); replaced wholesale if the same uid settles again
        self._pending: Dict[str, dict] = {}
        self._recent: "OrderedDict[str, dict]" = OrderedDict()
        self._avoided_delta: Dict[str, float] = {}
        # read-path (jobless) deposits awaiting durable flush — the
        # predict plane's waves have no JobControl/lease, so their cost
        # folds straight into the tenant, keyed for append-only merge
        self._read_delta: Dict[str, dict] = {}
        self._window = obs.SlidingQuantiles(window_s=window_s)
        self.flush_every_s = float(flush_every_s)
        self.top_jobs = int(top_jobs)
        self.max_recent = int(max_recent)
        self.store = None
        self.mgr = None
        self._last_flush = 0.0
        self.flushes = 0
        self.flush_errors = 0
        self.fenced = 0
        self.ledger_corrupt = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------- attribution

    def _tenant_of(self, uid: str) -> str:
        ctl = jobctl.get(uid)
        return getattr(ctl, "tenant", None) or "default"

    def deposit(self, uid: str, *, launches: int = 0,
                traffic_units: int = 0, seconds_est: float = 0.0,
                seconds_measured: float = 0.0,
                readback_bytes: int = 0) -> None:
        ctl = jobctl.get(uid)
        tenant = (getattr(ctl, "tenant", None) or "default")
        with self._lock:
            j = self._jobs.get(uid)
            if j is None:
                j = self._jobs[uid] = _JobUsage(tenant)
                if ctl is not None:
                    ctl.usage = j
            j.tenant = tenant
            j.launches += int(launches)
            j.traffic_units += int(traffic_units)
            j.device_seconds_est += float(seconds_est)
            j.device_seconds_measured += float(seconds_measured)
            j.readback_bytes += int(readback_bytes)
        if launches:
            _LAUNCHES.inc(int(launches), tenant=tenant)
        if traffic_units:
            _TRAFFIC.inc(int(traffic_units), tenant=tenant)
        if seconds_measured:
            _DEVICE_SECONDS.inc(float(seconds_measured), tenant=tenant)

    def deposit_tenant(self, tenant_raw: Optional[str], *,
                       launches: int = 0, traffic_units: int = 0,
                       seconds_est: float = 0.0,
                       seconds_measured: float = 0.0,
                       readback_bytes: int = 0) -> None:
        """Attribute JOBLESS device work (the predict read path)
        straight to a tenant: no JobControl, no lease, no per-job
        ledger entry — the cost folds into the tenant rollup live and
        rides the next durable flush as an append-only delta."""
        from spark_fsm_tpu_torch.service import obsplane

        tenant = (tenant_raw if tenant_raw in obsplane.known_tenants()
                  else obsplane.DEFAULT_TENANT)
        vec = {"device_seconds_est": float(seconds_est),
               "device_seconds_measured": float(seconds_measured),
               "launches": int(launches),
               "traffic_units": int(traffic_units),
               "readback_bytes": int(readback_bytes)}
        with self._lock:
            roll = self._tenants.setdefault(tenant, _tenant_zero())
            _add(roll, vec)
            delta = self._read_delta.setdefault(tenant, _zero_vector())
            _add(delta, vec)
        if launches:
            _LAUNCHES.inc(int(launches), tenant=tenant)
        if traffic_units:
            _TRAFFIC.inc(int(traffic_units), tenant=tenant)
        if seconds_measured:
            _DEVICE_SECONDS.inc(float(seconds_measured), tenant=tenant)

    def settle(self, uid: str) -> Optional[dict]:
        """Fold ``uid``'s accumulator into its tenant rollup and queue
        it for the durable ledger; returns the job's usage vector (the
        ``stats["usage"]`` block) or None when nothing was deposited."""
        with self._lock:
            j = self._jobs.pop(uid, None)
            if j is None:
                return None
            vec = j.as_dict()
            roll = self._tenants.setdefault(j.tenant, _tenant_zero())
            _add(roll, vec)
            roll["jobs_settled"] += 1
            self._pending[uid] = dict(vec, ts=round(time.time(), 3))
            self._recent[uid] = vec
            while len(self._recent) > self.max_recent:
                self._recent.popitem(last=False)
        self._window.observe(
            vec["device_seconds_measured"] or vec["device_seconds_est"],
            tenant=j.tenant)
        return vec

    def job_view(self, uid: str) -> Optional[dict]:
        with self._lock:
            j = self._jobs.get(uid)
            return j.as_dict() if j is not None else None

    def checkpoint_snapshot(self, uid: str) -> Optional[dict]:
        return self.job_view(uid)

    def resume(self, uid: str, snap: dict) -> None:
        """Adopt a checkpointed accumulator: REPLACE, never add — the
        dead holder's deposits are inside ``snap``, and the adopter's
        own re-deposits land on top of it.  Prometheus counters are NOT
        replayed (they count THIS process's dispatches only, which is
        what the conservation invariant compares them against)."""
        if not isinstance(snap, dict):
            return
        j = _JobUsage.from_dict(snap)
        with self._lock:
            self._jobs[uid] = j
        ctl = jobctl.get(uid)
        if ctl is not None:
            ctl.usage = j

    def drop(self, uid: str) -> None:
        """Forget a live accumulator without settling (fenced holder:
        the adopter owns the job's attribution now)."""
        with self._lock:
            self._jobs.pop(uid, None)

    def credit_avoided(self, tenant_raw: Optional[str], seconds: float,
                       mode: str) -> None:
        from spark_fsm_tpu_torch.service import obsplane

        seconds = max(0.0, float(seconds or 0.0))
        tenant = (tenant_raw if tenant_raw in obsplane.known_tenants()
                  else obsplane.DEFAULT_TENANT)
        with self._lock:
            roll = self._tenants.setdefault(tenant, _tenant_zero())
            roll["avoided_device_seconds"] += seconds
            self._avoided_delta[tenant] = (
                self._avoided_delta.get(tenant, 0.0) + seconds)
        _AVOIDED.inc(seconds, tenant=tenant)
        log_event("usage_avoided_credit", tenant=tenant, mode=mode,
                  device_seconds=round(seconds, 6))

    # ---------------------------------------------------- durable ledger

    def tick(self) -> None:
        """Heartbeat-cadence flush hook (lease.LeaseManager.tick in
        cluster mode, the private timer thread solo)."""
        now = time.monotonic()
        if now - self._last_flush < self.flush_every_s:
            return
        with self._lock:
            dirty = (bool(self._pending) or bool(self._avoided_delta)
                     or bool(self._read_delta))
        if dirty:
            self.flush_now()
        else:
            self._last_flush = now

    def flush_now(self) -> int:
        """Merge every pending settled job into its tenant's durable
        ledger record.  Per-uid fencing: a pending job whose lease this
        replica has lost is dropped, not written — the adopter owns its
        ledger row.  Returns the number of tenants flushed."""
        store = self.store
        if store is None:
            return 0
        with self._lock:
            pending = self._pending
            self._pending = {}
            avoided = self._avoided_delta
            self._avoided_delta = {}
            read_delta = self._read_delta
            self._read_delta = {}
        self._last_flush = time.monotonic()
        mgr = self.mgr
        by_tenant: Dict[str, Dict[str, dict]] = {}
        for uid, vec in pending.items():
            if mgr is not None:
                try:
                    if mgr.is_lost(uid):
                        self.fenced += 1
                        log_event("usage_flush_fenced", uid=uid)
                        continue
                except Exception:
                    pass
            by_tenant.setdefault(
                str(vec.get("tenant") or "default"), {})[uid] = vec
        for t in list(avoided) + list(read_delta):
            by_tenant.setdefault(t, {})
        flushed = 0
        for tenant, jobs in by_tenant.items():
            try:
                self._flush_tenant(store, tenant, jobs,
                                   avoided.get(tenant, 0.0),
                                   read_delta.get(tenant))
                flushed += 1
            except Exception as exc:
                self.flush_errors += 1
                log_event("usage_flush_error", tenant=tenant,
                          error=str(exc))
                # put the jobs back so the next flush retries them (an
                # adopter's later settle for the same uid still wins —
                # pending is keyed by uid and setdefault keeps newest)
                with self._lock:
                    for uid, vec in jobs.items():
                        self._pending.setdefault(uid, vec)
                    if avoided.get(tenant):
                        self._avoided_delta[tenant] = (
                            self._avoided_delta.get(tenant, 0.0)
                            + avoided[tenant])
                    if read_delta.get(tenant):
                        rd = self._read_delta.setdefault(
                            tenant, _zero_vector())
                        _add(rd, read_delta[tenant])
        return flushed

    def _flush_tenant(self, store, tenant: str, jobs: Dict[str, dict],
                      avoided_delta: float,
                      read_delta: Optional[dict] = None) -> None:
        key = LEDGER_PREFIX + tenant
        rec = None
        payload, verdict = envelope.unwrap(store.peek(key))
        if verdict == "corrupt":
            self.ledger_corrupt += 1
            log_event("usage_ledger_corrupt", tenant=tenant)
        elif payload is not None:
            try:
                rec = json.loads(payload)
                if not isinstance(rec, dict):
                    rec = None
            except ValueError:
                self.ledger_corrupt += 1
                rec = None
        if rec is None:
            rec = {"tenant": tenant, "totals": _zero_vector(),
                   "avoided_device_seconds": 0.0, "jobs": {},
                   "jobs_settled": 0}
        totals = rec.setdefault("totals", _zero_vector())
        led_jobs = rec.setdefault("jobs", {})
        for uid, vec in jobs.items():
            old = led_jobs.get(uid)
            if old is not None:
                # adoption re-settle: REPLACE the dead holder's row —
                # subtract it from totals first, so nothing is billed
                # twice
                _add(totals, old, sign=-1)
            else:
                rec["jobs_settled"] = int(rec.get("jobs_settled") or 0) + 1
            _add(totals, vec)
            led_jobs[uid] = vec
        # age out beyond the cap, oldest settle first; their share is
        # already frozen into totals
        if len(led_jobs) > LEDGER_JOBS_CAP:
            for uid in sorted(led_jobs,
                              key=lambda u: led_jobs[u].get("ts") or 0.0)[
                    :len(led_jobs) - LEDGER_JOBS_CAP]:
                del led_jobs[uid]
        if read_delta is not None:
            # jobless read-path work: append-only merge into totals
            # plus its own sub-vector for visibility
            _add(totals, read_delta)
            rp = rec.setdefault("read_path", _zero_vector())
            _add(rp, read_delta)
        rec["avoided_device_seconds"] = (
            float(rec.get("avoided_device_seconds") or 0.0)
            + float(avoided_delta))
        rec["replica"] = getattr(self.mgr, "replica_id", None)
        rec["ts"] = round(time.time(), 3)
        store.set(key, envelope.wrap(json.dumps(rec)))
        self.flushes += 1
        _FLUSHES.inc(tenant=tenant)

    # --------------------------------------------------- solo flush loop

    def start_solo(self) -> None:
        """Private flush timer for solo boots (no lease heartbeat to
        ride)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="usage-flush", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(min(self.flush_every_s, 2.0)):
            try:
                self.tick()
            except Exception as exc:
                log_event("usage_flush_error", tenant="*",
                          error=str(exc))

    # ------------------------------------------------------------ admin

    def ledger_rows(self, store=None) -> Dict[str, dict]:
        """The merged durable view: one row per ``fsm:usage:{tenant}``
        record (corrupt records skipped + counted)."""
        store = store if store is not None else self.store
        rows: Dict[str, dict] = {}
        if store is None:
            return rows
        for key in store.scan_iter(LEDGER_PREFIX):
            tenant = key[len(LEDGER_PREFIX):]
            payload, verdict = envelope.unwrap(store.peek(key))
            if verdict == "corrupt" or payload is None:
                if verdict == "corrupt":
                    self.ledger_corrupt += 1
                continue
            try:
                rec = json.loads(payload)
            except ValueError:
                self.ledger_corrupt += 1
                continue
            if isinstance(rec, dict):
                rows[tenant] = rec
        return rows

    def report(self, store=None) -> dict:
        """The ``/admin/usage`` body: durable per-tenant table (flushed
        first, so the response is read-your-writes), live in-flight
        jobs, windowed rollups, and the top-N settled jobs by measured
        device seconds."""
        try:
            self.flush_now()
        except Exception:
            pass
        with self._lock:
            tenants = {t: dict(r) for t, r in self._tenants.items()}
            live = {u: j.as_dict() for u, j in self._jobs.items()}
            recent = list(self._recent.items())
        ledger = self.ledger_rows(store)
        for t in tenants:
            tenants[t]["window"] = self._window.stats(tenant=t)
            led = ledger.get(t)
            if led is not None:
                tenants[t]["ledger"] = {
                    "totals": led.get("totals"),
                    "avoided_device_seconds": led.get(
                        "avoided_device_seconds"),
                    "jobs_settled": led.get("jobs_settled"),
                    "ts": led.get("ts"), "replica": led.get("replica")}
        for t, led in ledger.items():
            if t not in tenants:
                # settled by another replica: durable-only row
                row = _tenant_zero()
                row["window"] = self._window.stats(tenant=t)
                row["ledger"] = {
                    "totals": led.get("totals"),
                    "avoided_device_seconds": led.get(
                        "avoided_device_seconds"),
                    "jobs_settled": led.get("jobs_settled"),
                    "ts": led.get("ts"), "replica": led.get("replica")}
                tenants[t] = row
        top = sorted(recent, key=lambda kv: -(
            kv[1].get("device_seconds_measured")
            or kv[1].get("device_seconds_est") or 0.0))[:self.top_jobs]
        totals = _tenant_zero()
        for r in tenants.values():
            _add(totals, r)
            totals["avoided_device_seconds"] += float(
                r.get("avoided_device_seconds") or 0.0)
            totals["jobs_settled"] += int(r.get("jobs_settled") or 0)
        return {"enabled": True, "tenants": tenants, "totals": totals,
                "top_jobs": [dict(v, uid=u) for u, v in top],
                "live_jobs": live, "stats": self.stats()}

    def stats(self) -> dict:
        with self._lock:
            n_live = len(self._jobs)
            n_pending = len(self._pending)
            tenants = len(self._tenants)
        return {"live_jobs": n_live, "pending_flush": n_pending,
                "tenants": tenants, "flushes": self.flushes,
                "flush_errors": self.flush_errors, "fenced": self.fenced,
                "ledger_corrupt": self.ledger_corrupt,
                "flush_every_s": self.flush_every_s}


# -- module wiring (the integrity/obsplane install pattern) ---------------

_cfg = None  # UsageConfig from the boot config; None = defaults (off)
_meter: Optional[Meter] = None


def configure(ucfg) -> None:
    """Adopt the ``[usage]`` boot config (config.set_config).  The
    meter itself is built at :func:`install` — configure only decides
    whether one will exist and with what knobs."""
    global _cfg
    _cfg = ucfg
    m = _meter
    if m is not None and ucfg is not None:
        m.flush_every_s = float(ucfg.flush_every_s)
        m.top_jobs = int(ucfg.top_jobs)
        m._window.set_window(float(ucfg.window_s))


def install(store, lease_mgr=None) -> Optional[Meter]:
    """Install the process-wide meter over ``store`` (Miner init; last
    install wins, mirroring obsplane).  Returns None when the usage
    plane is disabled — every deposit probe then costs one module-
    global read."""
    global _meter
    if _meter is not None:
        _meter.stop()
    if _cfg is None or not _cfg.enabled:
        _meter = None
        return None
    m = Meter(window_s=float(_cfg.window_s),
              flush_every_s=float(_cfg.flush_every_s),
              top_jobs=int(_cfg.top_jobs))
    m.store = store
    m.mgr = lease_mgr
    if lease_mgr is None:
        m.start_solo()
    _meter = m
    return m


def uninstall() -> None:
    global _meter
    if _meter is not None:
        _meter.stop()
    _meter = None


def get() -> Optional[Meter]:
    return _meter


def enabled() -> bool:
    return _meter is not None


# -- one-global-read probes (the fusion.dispatch_wave contract) -----------

def deposit(uid: str, *, launches: int = 0, traffic_units: int = 0,
            seconds_est: float = 0.0, seconds_measured: float = 0.0,
            readback_bytes: int = 0) -> None:
    m = _meter
    if m is None:
        return
    m.deposit(uid, launches=launches, traffic_units=traffic_units,
              seconds_est=seconds_est, seconds_measured=seconds_measured,
              readback_bytes=readback_bytes)


def deposit_tenant(tenant_raw: Optional[str], *, launches: int = 0,
                   traffic_units: int = 0, seconds_est: float = 0.0,
                   seconds_measured: float = 0.0,
                   readback_bytes: int = 0) -> None:
    m = _meter
    if m is None:
        return
    m.deposit_tenant(tenant_raw, launches=launches,
                     traffic_units=traffic_units, seconds_est=seconds_est,
                     seconds_measured=seconds_measured,
                     readback_bytes=readback_bytes)


def settle(uid: str) -> Optional[dict]:
    m = _meter
    if m is None:
        return None
    return m.settle(uid)


def job_view(uid: str) -> Optional[dict]:
    m = _meter
    if m is None:
        return None
    return m.job_view(uid)


def checkpoint_snapshot(uid: str) -> Optional[dict]:
    m = _meter
    if m is None:
        return None
    return m.checkpoint_snapshot(uid)


def resume(uid: str, snap: dict) -> None:
    m = _meter
    if m is None:
        return
    m.resume(uid, snap)


def drop(uid: str) -> None:
    m = _meter
    if m is None:
        return
    m.drop(uid)


def credit_avoided(tenant_raw: Optional[str], seconds: float,
                   mode: str) -> None:
    m = _meter
    if m is None:
        return
    m.credit_avoided(tenant_raw, seconds, mode)


def tick() -> None:
    """Heartbeat-cadence hook (lease.LeaseManager.tick): one global
    read when nothing is installed."""
    m = _meter
    if m is not None:
        m.tick()


def flush_now() -> int:
    m = _meter
    if m is None:
        return 0
    return m.flush_now()


def report(store=None) -> dict:
    m = _meter
    if m is None:
        return {"enabled": False}
    return m.report(store)


def stats() -> Optional[dict]:
    m = _meter
    if m is None:
        return None
    return m.stats()
