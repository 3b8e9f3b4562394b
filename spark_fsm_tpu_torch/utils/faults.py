"""Deterministic fault injection — the chaos seam every recovery path
is proven against.

The reference inherits Spark's lineage re-execution and actor
supervision; this rebuild supplies that layer itself (Miner retry,
StoreCheckpoint, queue->classic downgrades), and none of it counts as
*proven* until an injected failure exercises it.  This module is a
process-global registry of NAMED fault sites — every place the
framework touches a device, a store, a broker, or a compile pipeline
declares one — with seeded, scriptable triggers, so a test (or an
operator via ``/admin/faults``) can make exactly one dispatch hang,
every third store write fail, or a device launch OOM, deterministically.

Contract:

- ``fault_site(name, **ctx)`` is woven into the REAL call sites
  (ops/ragged_batch consumers, models/tsr, models/spade_queue,
  service/{actors,store,devcache,prewarm}, streaming/{kafka,consumer}).
  With nothing armed it is a single module-global read — the hardening
  layer costs nothing on the happy path.
- Sites must come from :data:`KNOWN_SITES`: an unknown name is a typo
  that would silently never fire, so ``arm`` refuses it.
- Triggers are deterministic: nth-call, every-k, or seeded probability.
  ``delay_s`` simulates a HANG (the call sleeps before returning or
  raising — what the dispatch watchdog exists to bound); ``exc`` picks
  the raised type (``"oom"`` raises :class:`InjectedOom`, whose text
  matches the engines' RESOURCE_EXHAUSTED detection; ``"none"`` only
  delays).
- ``match`` restricts a spec to calls whose context carries the given
  substring (e.g. only ``store.set`` calls for ``fsm:frontier:`` keys),
  so one site guard can serve many callers without collateral damage.

tests/conftest.py asserts the registry is DISARMED at session start and
end, so injections can never leak between tests or into a live suite.

Port: a copy of ``spark_fsm_tpu/utils/faults.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from spark_fsm_tpu_torch.utils import obs


class FaultInjected(RuntimeError):
    """Raised by :func:`fault_site` when an armed trigger fires."""


class InjectedOom(FaultInjected):
    """Injected device OOM.  The message carries RESOURCE_EXHAUSTED so
    the engines' OOM detection (ops/ragged_batch.is_oom)
    treats it exactly like a real XLA allocation failure."""

    def __init__(self, site: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM at fault site "
            f"{site!r}")


# The registered fault sites.  Adding a call-site guard for a NEW name
# requires listing it here (arm refuses unknowns) — and tests/test_chaos.py
# asserts it sweeps this exact set, so a new site cannot ship untested.
KNOWN_SITES = (
    "device.dispatch",   # device launch/readback (TSR ragged + queue)
    "device.oom",        # allocation failure on a device launch
    "store.get",         # result-store reads
    "store.set",         # result-store writes
    "store.rpush",       # result-store list appends (checkpoint deltas)
    "kafka.poll",        # broker poll (streaming/kafka.KafkaFetch)
    "checkpoint.save",   # whole-snapshot save (service/actors)
    "prewarm.compile",   # per-shape-key AOT compile (service/prewarm)
    "devcache.put",      # engine-cache device build/insert (service/devcache)
    "service.admit",     # train-submit admission (service/actors.Miner.submit)
    "service.journal",   # write-ahead job-journal intent write (service/store)
    "fusion.dispatch",   # cross-job fusion broker launch (service/fusion) —
                         # injection must DEGRADE to unfused per-job
                         # dispatch, never lose a wave
    "device.resident",   # resident-frontier segment dispatch/readback
                         # (models/tsr._mine_resident) — the port has no
                         # resident-round fallback: injection raises out
                         # of the mine, and a checkpointed mine resumes
                         # its last persisted frontier with full parity
    "lease.acquire",     # per-job lease acquisition at admission
                         # (service/lease.py) — injection must be a clean
                         # synchronous 503 with ZERO journal/store trace
    "lease.renew",       # heartbeat renewal + stale-fence verification —
                         # injection lets the job keep running until its
                         # TTL lapses, then it self-fences at the next
                         # safe point (terminal LEASE_LOST, no retry)
    "lease.steal",       # work-steal claim on a peer's queued job —
                         # injection must abort the steal cleanly: the
                         # job stays with (and finishes on) the victim
    "rescache.lookup",   # result-reuse lookup at admission
                         # (service/resultcache.py) — injection must
                         # degrade the request to a plain cold mine
                         # with oracle parity, never fail the submit
    "rescache.store",    # cache-entry store / fingerprint learn after a
                         # finished mine — injection must leave the job
                         # green (results already durable); only the
                         # reuse entry is lost
    "storeguard.probe",  # active store health probe (service/storeguard)
                         # — an injected raise IS a failed probe (the
                         # site's whole purpose: drive the health state
                         # machine to DOWN deterministically); recovery
                         # on disarm must replay the spool and heal
    "storeguard.replay", # per-write spool replay after an outage —
                         # injection must degrade to the current
                         # terminal-failure path (job fenced, spool
                         # dropped, store left heal-able), NEVER a
                         # corrupt/partial state accepted on resume
    "store.corrupt",     # bitrot simulation on durable READS
                         # (service/store get/lrange/spine_chunks, via
                         # :func:`corrupt_value`) — fires by RETURNING
                         # deterministically damaged bytes (odd
                         # injections byte-flip the middle character,
                         # even injections truncate to the first half)
                         # instead of raising; ``exc``/``delay_s`` are
                         # ignored.  The envelope layer
                         # (utils/envelope.py) must detect every hit
                         # and each surface must degrade per its
                         # integrity posture (service/integrity.py),
                         # never parse the damage
)

_EXC_BY_NAME = {"fault": FaultInjected, "oom": InjectedOom, "none": None}


class _Spec:
    __slots__ = ("site", "nth", "every", "p", "seed", "times", "delay_s",
                 "exc", "match", "rng", "calls", "injected")

    def __init__(self, site, nth, every, p, seed, times, delay_s, exc,
                 match):
        self.site = site
        self.nth = nth
        self.every = every
        self.p = p
        self.seed = seed
        self.times = times
        self.delay_s = delay_s
        self.exc = exc
        self.match = match
        self.rng = random.Random(seed)
        self.calls = 0
        self.injected = 0

    def describe(self) -> dict:
        out = {"calls": self.calls, "injected": self.injected,
               "exc": next((k for k, v in _EXC_BY_NAME.items()
                            if v is self.exc), getattr(self.exc, "__name__",
                                                       str(self.exc)))}
        for k in ("nth", "every", "p", "seed", "times", "delay_s", "match"):
            v = getattr(self, k)
            if v not in (None, 0, 0.0):
                out[k] = v
        return out


_lock = threading.Lock()
_armed: Dict[str, _Spec] = {}
# lifetime per-site counters (survive disarm — /admin/health reads them)
_counters: Dict[str, Dict[str, int]] = {}
_active = False  # fast-path flag: fault_site returns on one global read


def _collect_metrics():
    """fsm_fault_site_* families for the unified registry.  EVERY
    registered site emits series (zero-valued until touched): an armed
    site with no metric would be an orphan counter, which
    scripts/obs_smoke.sh exists to catch."""
    with _lock:
        per_site = {s: dict(c) for s, c in _counters.items()}
        n_armed = len(_armed)
    for s in KNOWN_SITES:
        per_site.setdefault(s, {"calls": 0, "injected": 0})
    return [
        ("fsm_fault_site_calls_total", "counter",
         "guarded calls observed while the site was armed",
         [({"site": s}, c["calls"]) for s, c in sorted(per_site.items())]),
        ("fsm_fault_site_injected_total", "counter",
         "injections actually fired",
         [({"site": s}, c["injected"]) for s, c in sorted(per_site.items())]),
        ("fsm_fault_sites_armed", "gauge",
         "armed fault sites (should be 0 outside a chaos drill)",
         [({}, n_armed)]),
    ]


obs.REGISTRY.register_collector("faults", _collect_metrics)


def arm(site: str, *, nth: Optional[int] = None, every: Optional[int] = None,
        p: Optional[float] = None, seed: int = 0,
        times: Optional[int] = None, delay_s: float = 0.0,
        exc="fault", match: Optional[str] = None) -> None:
    """Arm ``site`` with one trigger (re-arming replaces the spec).

    Exactly one of ``nth`` (fire on the nth matching call), ``every``
    (fire on every k-th matching call), ``p`` (fire with probability p,
    seeded — deterministic per arm) must be given.  ``times`` bounds the
    total injections (default unbounded).  ``delay_s`` sleeps before
    acting (a hang); ``exc`` is "fault"/"oom"/"none" or an Exception
    subclass.  ``match`` restricts to calls whose context contains it.
    """
    global _active
    if site not in KNOWN_SITES:
        raise ValueError(f"unknown fault site {site!r} "
                         f"(known: {sorted(KNOWN_SITES)})")
    if sum(x is not None for x in (nth, every, p)) != 1:
        raise ValueError("arm needs exactly one of nth/every/p")
    if nth is not None and nth < 1:
        raise ValueError(f"nth must be >= 1 (got {nth}; calls are 1-based)")
    if every is not None and every < 1:
        raise ValueError(f"every must be >= 1 (got {every})")
    if p is not None and not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1] (got {p})")
    if exc == "fault" and site == "device.oom":
        exc = "oom"  # the OOM site injects OOM semantics by default
    if isinstance(exc, str):
        if exc not in _EXC_BY_NAME:
            raise ValueError(f"exc must be one of {sorted(_EXC_BY_NAME)} "
                             f"or an Exception subclass, got {exc!r}")
        exc = _EXC_BY_NAME[exc]
    if exc is None and not delay_s:
        raise ValueError("exc='none' needs delay_s (an injection that "
                         "neither raises nor delays is a no-op)")
    with _lock:
        _armed[site] = _Spec(site, nth, every, p, int(seed), times,
                             float(delay_s), exc, match)
        _active = True


def disarm(site: Optional[str] = None) -> list:
    """Disarm one site (or all when None); returns the disarmed names."""
    global _active
    with _lock:
        names = [site] if site is not None else list(_armed)
        out = [n for n in names if _armed.pop(n, None) is not None]
        _active = bool(_armed)
        return out


def armed() -> Dict[str, dict]:
    """Snapshot of armed sites -> spec description (JSON-able)."""
    with _lock:
        return {s: spec.describe() for s, spec in _armed.items()}


def counters() -> Dict[str, Dict[str, int]]:
    """Lifetime per-site call/injection counters (survive disarm)."""
    with _lock:
        return {s: dict(c) for s, c in _counters.items()}


def reset_counters() -> None:
    with _lock:
        _counters.clear()


def _ctx_matches(match: str, ctx: dict) -> bool:
    """Spec-``match`` predicate: substring over the call's string ctx
    values, PLUS the ambient job identity — a ``match`` of the exact
    form ``uid=<job uid>`` matches any guarded call made on that job's
    worker thread (utils/jobctl contextvar), so a chaos drill can arm a
    poison DATASET (every holder of the job crashes at dispatch, on
    every replica that adopts it) without the engines threading uids
    into every site's ctx."""
    if any(match in v for v in ctx.values() if isinstance(v, str)):
        return True
    if match.startswith("uid="):
        from spark_fsm_tpu_torch.utils import jobctl  # lazy: no import cycle
        ctl = jobctl.current()
        return ctl is not None and match == f"uid={ctl.uid}"
    return False


def fault_site(site: str, **ctx) -> None:
    """The guard woven into real call sites; raises/delays when armed.

    Context values are matched as substrings against the spec's
    ``match`` (all calls match when unset; a ``uid=...`` match also
    consults the ambient job identity — see :func:`_ctx_matches`).
    Counting happens only while the site is armed — the disarmed path
    is one global read.
    """
    if not _active:
        return
    with _lock:
        spec = _armed.get(site)
        if spec is None:
            return
        if spec.match is not None and not _ctx_matches(spec.match, ctx):
            return
        spec.calls += 1
        c = _counters.setdefault(site, {"calls": 0, "injected": 0})
        c["calls"] += 1
        fire = ((spec.nth is not None and spec.calls == spec.nth)
                or (spec.every is not None
                    and spec.calls % spec.every == 0)
                or (spec.p is not None and spec.rng.random() < spec.p))
        if not fire or (spec.times is not None
                        and spec.injected >= spec.times):
            return
        spec.injected += 1
        c["injected"] += 1
        delay_s, exc = spec.delay_s, spec.exc
    # sleep OUTSIDE the lock: a simulated hang must not block every
    # other site's bookkeeping (or the watchdog's own log path)
    obs.trace_event("fault_injected", site=site,
                    delay_s=delay_s, raises=exc is not None)
    if delay_s:
        time.sleep(delay_s)
    if exc is not None:
        raise exc(site) if exc is InjectedOom else exc(
            f"injected fault at site {site!r} (ctx {ctx!r})")


def corrupt_value(site: str, value, **ctx):
    """The value-TRANSFORMING sibling of :func:`fault_site`, woven into
    durable read verbs for the ``store.corrupt`` bitrot site: when the
    armed trigger fires, the read returns a deterministically damaged
    copy of ``value`` instead of raising.

    Damage alternates by injection parity so one arm exercises both
    envelope failure modes: odd injections BYTE-FLIP (xor 0x01 on the
    middle character — digest mismatch at intact length), even
    injections TRUNCATE to the first half (length mismatch).  ``None``
    and empty values pass through WITHOUT counting a call, so ``nth``
    deterministically addresses the nth damageable read of a matched
    key.  ``exc``/``delay_s`` on the spec are ignored.  Disarmed cost:
    one module-global read.
    """
    if not _active:
        return value
    if value is None or value == "":
        return value
    with _lock:
        spec = _armed.get(site)
        if spec is None:
            return value
        if spec.match is not None and not _ctx_matches(spec.match, ctx):
            return value
        spec.calls += 1
        c = _counters.setdefault(site, {"calls": 0, "injected": 0})
        c["calls"] += 1
        fire = ((spec.nth is not None and spec.calls == spec.nth)
                or (spec.every is not None
                    and spec.calls % spec.every == 0)
                or (spec.p is not None and spec.rng.random() < spec.p))
        if not fire or (spec.times is not None
                        and spec.injected >= spec.times):
            return value
        spec.injected += 1
        c["injected"] += 1
        flip = spec.injected % 2 == 1
    obs.trace_event("fault_injected", site=site,
                    mode="flip" if flip else "truncate")
    if flip:
        i = len(value) // 2
        return value[:i] + chr(ord(value[i]) ^ 0x01) + value[i + 1:]
    return value[:max(1, len(value) // 2)]


def corrupt_list(site: str, values, **ctx):
    """`corrupt_value` over a list read (lrange / spine_chunks): each
    element is one trigger call, so ``nth`` addresses a specific chunk
    of a matched key (e.g. the 2nd checkpoint delta).  Disarmed cost:
    one module-global read — the list is returned untouched."""
    if not _active:
        return values
    return [corrupt_value(site, v, **ctx) for v in values]


@contextmanager
def injected(site: str, **kwargs):
    """Scoped arm/disarm for tests: the site is disarmed on exit even
    when the body raises — the no-leak contract conftest enforces."""
    arm(site, **kwargs)
    try:
        yield
    finally:
        disarm(site)
