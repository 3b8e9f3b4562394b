"""Weighted-fair multi-tenant admission — per-tenant token
buckets layered UNDER the strict priority classes.

the earlier admission queue solved overload (a full queue sheds 429s) but
not FAIRNESS: classes are strict and FIFO within, so one flooding
client occupies every admission slot on every replica and a well-
behaved tenant's submits either shed or queue behind the whole flood.
This module adds the missing dimension without touching the class
semantics the fusion broker and SLO layer already key on:

- **Tenant identity**: requests gain a ``tenant`` param (default
  ``"default"``).  The live vocabulary is BOUNDED (``[fairness]
  max_tenants``) because tenant names label the ``fsm_tenant_*``
  metric families — an attacker minting tenant names must not mint
  unbounded series; a new tenant past the bound is refused with a
  clean failure envelope, never silently remapped.

- **Token buckets (occupancy)**: each tenant's QUEUED jobs are capped
  at ``tenant_depth`` — the bucket: a token is consumed when a submit
  reserves a queue slot and returned when the job is dequeued (or the
  submit aborts).  A tenant out of tokens sheds with 429 even while
  the global queue has room, which is exactly what keeps the flood
  from occupying every slot.  The bucket's REFILL rate is the
  tenant's weight-fair share of the measured service rate, and the
  shed's ``Retry-After`` is derived from it (how long until this
  tenant's own backlog drains at its share), not from the global EWMA
  — a flooding tenant is told the truth about its own queue, not the
  fleet's.

- **Deficit-weighted round-robin**: within each priority class, queued
  jobs are served DRR across tenants — every round, each backlogged
  tenant earns a quantum proportional to its weight and spends one
  deficit per job served.  Weights come from ``[fairness.weights]``
  (unlisted tenants get ``default_weight``).  Priority classes stay
  STRICT above fairness: a ``high`` job from any tenant still beats
  every ``normal`` job — fairness layers UNDER the classes, never
  beside them (docs/DESIGN.md "Fairness under priority classes").

Disabled (``[fairness] enabled = false``, the default) the admission
queue holds no scheduler and every queue operation takes its original
plain-deque path — bench_smoke's dispatch counters stay byte-identical.

Port: a copy of ``spark_fsm_tpu/service/fairness.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import collections
import math
import re
import threading
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.utils import obs

DEFAULT_TENANT = "default"

# tenant names become metric label values and store-key components:
# bounded charset, bounded length
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

_TENANT_DEPTH = obs.REGISTRY.gauge(
    "fsm_tenant_queue_depth",
    "queued train jobs per tenant (fairness scheduler view)")
_TENANT_DEPTH.set(0, tenant=DEFAULT_TENANT)
_TENANT_ADMITTED = obs.REGISTRY.counter(
    "fsm_tenant_admitted_total",
    "train jobs admitted per tenant").seed(tenant=DEFAULT_TENANT)
_TENANT_SHEDS = obs.REGISTRY.counter(
    "fsm_tenant_sheds_total",
    "train submits shed per tenant (429): the tenant's own queue cap, "
    "or the global bound while the tenant was over its fair share"
).seed(tenant=DEFAULT_TENANT)
_TENANT_SERVED = obs.REGISTRY.counter(
    "fsm_tenant_dequeued_total",
    "train jobs handed to a worker per tenant — the DRR service "
    "order's observable").seed(tenant=DEFAULT_TENANT)


def build_scheduler() -> Optional["TenantScheduler"]:
    """The Miner's constructor hook: a scheduler when the boot config
    enables fairness, else None (the admission queue keeps its plain
    deques and the disabled path costs nothing)."""
    fcfg = config.get_config().fairness
    if not fcfg.enabled:
        return None
    return TenantScheduler(fcfg)


class TenantScheduler:
    """Process-wide tenant registry: weights, the bounded vocabulary,
    and the per-tenant Retry-After estimator.  Queue-side state (the
    per-class DRR lists, the occupancy buckets) lives in
    :class:`FairClass` / the AdmissionQueue, which call back into this
    for weights."""

    def __init__(self, fcfg=None) -> None:
        fcfg = fcfg if fcfg is not None else config.get_config().fairness
        self.tenant_depth = int(fcfg.tenant_depth)
        self.max_tenants = int(fcfg.max_tenants)
        self.default_weight = float(fcfg.default_weight)
        self._weights: Dict[str, float] = {
            str(k): float(v) for k, v in dict(fcfg.weights).items()}
        self._lock = threading.Lock()
        self._known = {DEFAULT_TENANT} | set(self._weights)
        for t in sorted(self._known):
            self._seed_tenant(t)

    @staticmethod
    def _seed_tenant(tenant: str) -> None:
        # zero-seed the tenant's label series so a fresh scrape shows
        # every registered tenant
        _TENANT_DEPTH.set(0, tenant=tenant)
        _TENANT_ADMITTED.seed(tenant=tenant)
        _TENANT_SHEDS.seed(tenant=tenant)
        _TENANT_SERVED.seed(tenant=tenant)
        # and the SLO vocabulary: per-tenant
        # fsm_job_*_seconds series + /admin/slo tenant quantiles exist
        # from registration, not from the first finished job
        from spark_fsm_tpu_torch.service import obsplane

        obsplane.seed_tenant(tenant)

    def resolve(self, raw: Optional[str]) -> str:
        """Validate + register a request's tenant.  Raises ValueError
        for malformed names and for NEW tenants past the bounded
        vocabulary (the metric-cardinality guard) — the submit fails
        with a clean envelope, nothing is silently remapped."""
        if raw is None or raw == "":
            return DEFAULT_TENANT
        if not _NAME_RE.match(raw):
            raise ValueError(
                f"invalid tenant {raw!r} (letters, digits, '.', '_', "
                f"'-', max 64 chars)")
        with self._lock:
            if raw not in self._known:
                if len(self._known) >= self.max_tenants:
                    raise ValueError(
                        f"tenant vocabulary full ({self.max_tenants} "
                        f"live tenants); new tenant {raw!r} refused — "
                        f"raise [fairness] max_tenants or reuse an "
                        f"existing tenant")
                self._known.add(raw)
                self._seed_tenant(raw)
        return raw

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def share(self, tenant: str,
              active: Optional[Iterable[str]] = None) -> float:
        """The tenant's weight-fair share of service capacity among
        ``active`` tenants (all known ones when None)."""
        with self._lock:
            pool = list(active) if active is not None \
                else sorted(self._known)
        if tenant not in pool:
            pool = pool + [tenant]
        total = sum(self.weight(t) for t in pool)
        return self.weight(tenant) / total if total > 0 else 1.0

    def retry_after_s(self, tenant: str, tenant_queued: int,
                      per_job_s: float, workers: int,
                      active: Optional[Iterable[str]] = None) -> int:
        """Seconds until a shed tenant's submit plausibly fits: its OWN
        backlog divided by its bucket's refill rate — the weight-fair
        share of the measured service rate (``workers / per_job_s``).
        This replaces the global-EWMA estimate for tenant sheds: a
        flooding tenant must be told how long ITS queue takes at ITS
        share, not how long the fleet's next free slot takes."""
        refill_per_s = (max(1, workers) / max(1e-6, per_job_s)) \
            * self.share(tenant, active)
        est = (tenant_queued + 1) / max(1e-9, refill_per_s)
        return max(1, min(3600, math.ceil(est)))

    def known_tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._known)

    def stats(self) -> dict:
        with self._lock:
            known = sorted(self._known)
        return {"enabled": True,
                "tenant_depth": self.tenant_depth,
                "max_tenants": self.max_tenants,
                "tenants": known,
                "weights": {t: self.weight(t) for t in known}}


class FairClass:
    """One priority class's queued jobs, served deficit-weighted
    round-robin across tenants.  NOT thread-safe on its own — every
    method runs under the owning AdmissionQueue's condition lock,
    exactly like the plain deques it replaces.

    DRR with unit job cost: ``_active`` is the round-robin ring of
    backlogged tenants; a visit to the tenant at the head serves jobs
    while its deficit lasts, then grants the next quantum (weight
    normalized so every round adds >= 1 somewhere) and rotates.  A
    tenant whose queue drains leaves the ring and forfeits its deficit
    (standard DRR — banked credit must not let an idle-then-bursty
    tenant starve the ring later)."""

    def __init__(self, sched: TenantScheduler):
        self._sched = sched
        self._qs: Dict[str, Deque] = {}
        self._active: Deque[str] = collections.deque()
        self._deficit: Dict[str, float] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def append(self, req, tenant: str) -> None:
        q = self._qs.get(tenant)
        if q is None:
            q = self._qs[tenant] = collections.deque()
        if not q:
            if tenant not in self._active:
                self._active.append(tenant)
            self._deficit[tenant] = 0.0
        q.append(req)

    def _quantum(self, tenant: str) -> float:
        # normalize by the smallest ACTIVE weight so one full rotation
        # always grants at least one whole job's deficit somewhere —
        # the loop in popleft() provably terminates
        wmin = min(self._sched.weight(t) for t in self._active)
        return self._sched.weight(tenant) / max(1e-9, wmin)

    def popleft(self) -> Tuple[object, str]:
        """(request, tenant) per DRR order.  Caller guarantees the
        class is non-empty (same contract as deque.popleft)."""
        while True:
            t = self._active[0]
            if self._deficit[t] >= 1.0:
                self._deficit[t] -= 1.0
                q = self._qs[t]
                req = q.popleft()
                if not q:
                    self._active.popleft()
                    self._deficit[t] = 0.0
                return req, t
            self._deficit[t] += self._quantum(t)
            self._active.rotate(-1)

    def remove_uid(self, uid: str):
        """(request, tenant) pulled out by uid (the cancel-while-queued
        path), or None."""
        for t, q in self._qs.items():
            for req in q:
                if req.uid == uid:
                    q.remove(req)
                    if not q and t in self._active:
                        self._active.remove(t)
                        self._deficit[t] = 0.0
                    return req, t
        return None

    def uids(self) -> List[str]:
        return [req.uid for q in self._qs.values() for req in q]

    def pop_all(self) -> List[Tuple[object, str]]:
        out = []
        for t, q in self._qs.items():
            out.extend((req, t) for req in q)
            q.clear()
        self._active.clear()
        self._deficit.clear()
        return out

    def tenant_depths(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._qs.items() if q}

    def backlogged(self) -> List[str]:
        return [t for t, q in self._qs.items() if q]


# ------------------------------------------------------------------ metrics

def note_admitted(tenant: str) -> None:
    _TENANT_ADMITTED.inc(tenant=tenant)


def note_shed(tenant: str) -> None:
    _TENANT_SHEDS.inc(tenant=tenant)


def note_dequeued(tenant: str) -> None:
    _TENANT_SERVED.inc(tenant=tenant)


def set_depth(tenant: str, depth: int) -> None:
    _TENANT_DEPTH.set(depth, tenant=tenant)
