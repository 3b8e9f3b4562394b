"""Prediction serving plane, engine-facing half — port of
``spark_fsm_tpu/service/predictor.py``.

- **Artifact cache** (:class:`ArtifactCache`): rule tries
  (``ops/rule_trie.build_trie``) keyed by ``(rules_digest(payload),
  depth)`` — content-addressed, so a re-mine that changes the rules is a
  miss by construction — with the reference's LRU byte-bounding: an
  entry cap, a byte budget, and no caching of an artifact larger than
  half the budget.  One cache per device.
- **Micro-batch broker** (:class:`PredictBroker`): concurrent requests
  against the same ``(digest, F, D, m)`` park in a window of a few
  milliseconds and dispatch as one scoring wave (``rule_trie.score_wave``),
  demuxed positionally.  ``high`` priority makes the group due at once,
  a full window dispatches in the last joiner's thread, and a disabled
  window gives every request a solo launch.
- :func:`predict_rules`: what the reference's ``Predictor.handle`` does
  between resolving a rule payload and answering — the digest, the
  staleness note, the pattern-to-rule lowering, the ``depth_need`` rule,
  the cache and the broker — answering in the Questor entry spelling.
- **Serving surface** (:class:`Predictor`): the actor Master routes
  ``predict`` tasks to ``Predictor.handle``, which validates the request,
  resolves the payload from the result store (a finished job uid) or the
  result-reuse tier (a dataset fingerprint), scores it through the same
  path as :func:`predict_rules` on the service's device, and answers in
  the reference's envelope.

``configure`` takes the reference's ``[predict]`` fields
(``config.PredictConfig``) from a plain object or a dict.  The cache and
broker counts live on the reference's ``fsm_predict_*`` registry families
(``utils/obs.REGISTRY``); :func:`tallies` is a view of them.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import json

import torch

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.ops import rule_trie
from spark_fsm_tpu_torch.service import model, obsplane, usage
from spark_fsm_tpu_torch.service.model import (ServiceRequest,
                                               ServiceResponse, Status)
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.obs import log_event

# the reference's request priorities (``service/obsplane.PRIORITIES``)
PRIORITIES = obsplane.PRIORITIES

# ---------------------------------------------------------------------------
# Metrics — the reference's families, every one zero-seeded
# ---------------------------------------------------------------------------

_REQS = obs.REGISTRY.counter(
    "fsm_predict_requests_total", "predict requests by outcome")
for _o in ("served", "failure", "no_rules"):
    _REQS.seed(outcome=_o)
_WAVES = obs.REGISTRY.counter(
    "fsm_predict_waves_total", "scoring waves launched, by fusion mode")
for _m in ("fused", "solo"):
    _WAVES.seed(mode=_m)
_WAVE_JOBS = obs.REGISTRY.histogram(
    "fsm_predict_wave_jobs", "requests fused per scoring wave",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)).seed()
_BUILDS = obs.REGISTRY.counter(
    "fsm_predict_artifact_builds_total", "rule-trie artifact compiles")
_STALE = obs.REGISTRY.counter(
    "fsm_predict_artifact_stale_rebuilds_total",
    "artifact rebuilds because the source's rule set changed (re-mine "
    "invalidation observed through the content-addressed key)")
_EVICTS = obs.REGISTRY.counter(
    "fsm_predict_artifact_evictions_total", "artifact cache LRU evictions")
_HITS = obs.REGISTRY.counter(
    "fsm_predict_artifact_cache_hits_total", "artifact cache hits")
_MISSES = obs.REGISTRY.counter(
    "fsm_predict_artifact_cache_misses_total", "artifact cache misses")

_TALLY = {"hits": _HITS, "misses": _MISSES, "builds": _BUILDS,
          "evictions": _EVICTS, "stale": _STALE}

_stats_lock = threading.Lock()
_stats = {"requests": 0, "served": 0, "failures": 0, "waves": 0,
          "fused_waves": 0, "fused_jobs": 0, "solo_jobs": 0,
          "stale_rebuilds": 0, "exec_s": 0.0}


def _bump(**kw) -> None:
    with _stats_lock:
        for k, v in kw.items():
            _stats[k] = _stats.get(k, 0) + v


def _tally(key: str) -> None:
    _TALLY[key].inc()


def tallies() -> dict:
    """The artifact cache's hits, misses, builds and evictions and the
    stale rebuilds, over the process's lifetime (a view of the
    ``fsm_predict_artifact_*`` registry counters)."""
    return {k: int(c.total()) for k, c in _TALLY.items()}


def _collect_metrics():
    hits, misses = _HITS.total(), _MISSES.total()
    ratio = hits / (hits + misses) if (hits + misses) else 0.0
    with _stats_lock:
        fused = float(_stats["fused_jobs"])
        solo = float(_stats["solo_jobs"])
    total_jobs = fused + solo
    now = time.time()
    age = 0.0
    entries = bytes_ = 0
    with _caches_lock:
        caches = list(_CACHES.values())
    for cache in caches:
        with cache._lock:
            entries += len(cache._entries)
            bytes_ += cache._bytes
            if cache._entries:
                age = max(age, max(now - trie.built_ts
                                   for trie, _ in cache._entries.values()))
    return [
        ("fsm_predict_artifact_cache_hit_ratio", "gauge",
         "artifact cache hits / lookups (process lifetime)",
         [({}, round(ratio, 6))]),
        ("fsm_predict_fused_ratio", "gauge",
         "share of predict requests served by a fused (>=2 job) wave",
         [({}, round(fused / total_jobs, 6) if total_jobs else 0.0)]),
        ("fsm_predict_artifact_entries", "gauge",
         "resident rule-trie artifacts", [({}, entries)]),
        ("fsm_predict_artifact_bytes", "gauge",
         "resident rule-trie artifact bytes", [({}, bytes_)]),
        ("fsm_predict_artifact_age_seconds", "gauge",
         "age of the OLDEST resident artifact (staleness horizon: an "
         "artifact never outlives its digest, so age only measures how "
         "long a rule set has gone without re-mining)",
         [({}, round(age, 3))]),
    ]


obs.REGISTRY.register_collector("predictor", _collect_metrics)


# ---------------------------------------------------------------------------
# Config (the reference's ``[predict]`` section and defaults)
# ---------------------------------------------------------------------------

_DEFAULTS = {
    "enabled": True,
    "window_ms": 2.0,
    "max_wave": 16,
    "topm": 8,
    "lanes_floor": 1024,
    "depth_floor": 16,
    "artifact_entries": 8,
    "artifact_bytes": 256 << 20,
}


def _section(pcfg) -> dict:
    """The module config from a ``[predict]`` section: an object with the
    reference's ``PredictConfig`` fields or a dict of them (a missing one
    takes its default)."""
    def get(name):
        if isinstance(pcfg, Mapping):
            return pcfg.get(name, _DEFAULTS[name])
        return getattr(pcfg, name, _DEFAULTS[name])

    return {"enabled": bool(get("enabled")),
            "window_ms": float(get("window_ms")),
            "max_wave": int(get("max_wave")),
            "topm": int(get("topm")),
            "lanes_floor": int(get("lanes_floor")),
            "depth_floor": int(get("depth_floor")),
            "cache_entries": int(get("artifact_entries")),
            "cache_bytes": int(get("artifact_bytes"))}


_cfg_lock = threading.Lock()
_cfg = _section(_DEFAULTS)


def configure(pcfg) -> None:
    """Apply a ``[predict]`` section (see ``_section``); drops every
    artifact cache, as the reference does."""
    with _cfg_lock:
        _cfg.update(_section(pcfg))
    with _caches_lock:
        _CACHES.clear()


def _cfg_get(key: str):
    with _cfg_lock:
        return _cfg[key]


# ---------------------------------------------------------------------------
# Artifact cache
# ---------------------------------------------------------------------------

class ArtifactCache:
    """LRU rule-trie cache keyed ``(digest, depth geometry)``: entry cap,
    byte budget, and never cache a single artifact over half the budget
    (one giant rule set must not flush the working set).  Builds its
    tries on ``device``."""

    def __init__(self, max_entries: int, max_bytes: int, *,
                 device: DeviceLike = None) -> None:
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        self.device = device
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, int], Tuple[rule_trie.RuleTrie, int]]" = OrderedDict()
        self._bytes = 0

    def get_or_build(self, digest: str, depth_need: int,
                     rules_provider: Callable[[], list],
                     lanes_floor: int) -> rule_trie.RuleTrie:
        key = (digest, int(depth_need))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                _tally("hits")
                return hit[0]
        _tally("misses")
        trie = rule_trie.build_trie(rules_provider(),
                                    lanes_floor=int(lanes_floor),
                                    depth_floor=int(depth_need),
                                    device=self.device)
        _tally("builds")
        nbytes = trie.nbytes()
        if nbytes > self.max_bytes // 2:
            # oversized artifacts serve this request but are never cached
            return trie
        with self._lock:
            if key not in self._entries:
                self._entries[key] = (trie, nbytes)
                self._bytes += nbytes
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                _, (_, old_bytes) = self._entries.popitem(last=False)
                self._bytes -= old_bytes
                _tally("evictions")
        return trie

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "resident": [
                    {"digest": k[0][:16], "depth": k[1],
                     "lanes": t.lanes, "F": t.F, "D": t.D,
                     "bytes": b, "rules": len(t.rules),
                     "age_s": round(time.time() - t.built_ts, 3)}
                    for k, (t, b) in self._entries.items()],
            }


_caches_lock = threading.Lock()
_CACHES: Dict[torch.device, ArtifactCache] = {}


def _cache(device: DeviceLike = None) -> ArtifactCache:
    """The process's artifact cache for ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``), made at the configured budgets."""
    dev = resolve_device(device)
    with _caches_lock:
        cache = _CACHES.get(dev)
        if cache is None:
            cache = _CACHES[dev] = ArtifactCache(
                _cfg_get("cache_entries"), _cfg_get("cache_bytes"),
                device=dev)
        return cache


# ---------------------------------------------------------------------------
# Micro-batch broker
# ---------------------------------------------------------------------------

class _Ticket:
    __slots__ = ("prefix", "priority", "event", "entries", "error",
                 "submit_t", "dispatch_t", "exec_s", "wave_jobs", "tag",
                 "tenant")

    def __init__(self, prefix: List[int], priority: str, tag: str,
                 tenant: str = "default") -> None:
        self.prefix = prefix
        self.priority = priority
        self.tag = tag
        self.tenant = tenant
        self.event = threading.Event()
        self.entries: Optional[List[dict]] = None
        self.error: Optional[BaseException] = None
        self.submit_t = time.monotonic()
        self.dispatch_t = self.submit_t
        self.exec_s = 0.0
        self.wave_jobs = 1


class _Group:
    __slots__ = ("key", "trie", "m", "tickets", "due_t")

    def __init__(self, key, trie, m: int, due_t: float) -> None:
        self.key = key
        self.trie = trie
        self.m = m
        self.tickets: List[_Ticket] = []
        self.due_t = due_t


class PredictBroker:
    """Windowed same-geometry wave fusion for predict requests.

    Groups key on ``(digest, F, D, m)``.  The window is per group from
    its first joiner; ``high`` priority or a full window makes it due at
    once.  Due groups dispatch in the scheduler thread, or, when full, in
    the last joiner's thread.  Every row's bytes are independent of its
    wave-mates (``rule_trie.score_wave``'s per-row reductions).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._groups: Dict[tuple, _Group] = {}
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    # -- scheduling ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        # lazy: a process that never predicts never pays a thread
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="fsm-predict-window",
                                            daemon=True)
            self._stopped = False
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
                now = time.monotonic()
                due = [k for k, g in self._groups.items() if g.due_t <= now]
                groups = [self._groups.pop(k) for k in due]
                if not groups:
                    nxt = min((g.due_t for g in self._groups.values()),
                              default=now + 0.05)
                    self._wake.wait(timeout=max(0.0005, nxt - now))
            for g in groups:
                self._run_group(g)

    def shutdown(self) -> None:
        with self._lock:
            self._stopped = True
            leftovers = list(self._groups.values())
            self._groups.clear()
            self._wake.notify_all()
        for g in leftovers:
            self._run_group(g)

    # -- submission ---------------------------------------------------------

    def submit(self, trie: rule_trie.RuleTrie, prefix: List[int], m: int,
               priority: str, tag: str,
               tenant: str = "default") -> _Ticket:
        """Score one observed prefix; blocks until its wave lands.
        Returns the completed ticket: ``entries`` plus the window-wait
        and exec timings."""
        window_s = max(0.0, float(_cfg_get("window_ms"))) / 1000.0
        max_wave = max(1, int(_cfg_get("max_wave")))
        t = _Ticket(prefix, priority, tag, tenant)
        if (not _cfg_get("enabled")) or window_s <= 0.0 or max_wave <= 1:
            g = _Group(None, trie, m, 0.0)
            g.tickets.append(t)
            self._run_group(g)
            if t.error is not None:
                raise t.error
            return t
        key = (trie.digest, trie.F, trie.D, int(m))
        run_now: Optional[_Group] = None
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group(
                    key, trie, int(m), time.monotonic() + window_s)
            g.tickets.append(t)
            if priority == "high":
                # a high-priority joiner makes the whole group due now:
                # riders already parked get the fast launch too
                g.due_t = 0.0
            if len(g.tickets) >= max_wave or g.due_t <= time.monotonic():
                self._groups.pop(key, None)
                run_now = g
            else:
                self._ensure_thread()
                self._wake.notify_all()
        if run_now is not None:
            self._run_group(run_now)
        t.event.wait(timeout=30.0)
        if not t.event.is_set():
            raise TimeoutError("predict wave never dispatched")
        if t.error is not None:
            raise t.error
        return t

    # -- execution ----------------------------------------------------------

    def _run_group(self, g: _Group) -> None:
        n = len(g.tickets)
        t0 = time.monotonic()
        try:
            waves = rule_trie.score_wave(
                g.trie, [t.prefix for t in g.tickets], g.m)
            exec_s = time.monotonic() - t0
            mode = "fused" if n >= 2 else "solo"
            _WAVES.inc(mode=mode)
            _WAVE_JOBS.observe(float(n))
            _bump(waves=1, fused_waves=1 if n >= 2 else 0, exec_s=exec_s,
                  **{("fused_jobs" if n >= 2 else "solo_jobs"): n})
            log_event("predict_wave", jobs=n, mode=mode,
                      wave_ms=round(exec_s * 1000.0, 3),
                      tags=[t.tag for t in g.tickets])
            # per-rider attribution (service/usage.py): the wave is one
            # launch streaming the artifact's lanes once, split across
            # riders by largest remainder, wall split equally
            if usage.get() is not None:
                one = usage.split_integral(1, [1.0] * n)
                lanes = usage.split_integral(
                    int(getattr(g.trie, "lanes", 0) or 0), [1.0] * n)
                for i, t in enumerate(g.tickets):
                    usage.deposit_tenant(
                        t.tenant, launches=one[i],
                        traffic_units=lanes[i],
                        seconds_measured=exec_s / n)
            for i, t in enumerate(g.tickets):
                t.entries = waves[i]
                t.dispatch_t = t0
                t.exec_s = exec_s
                t.wave_jobs = n
                t.event.set()
        except BaseException as exc:
            for t in g.tickets:
                t.error = exc
                t.event.set()


_BROKER = PredictBroker()


def broker() -> PredictBroker:
    return _BROKER


# ---------------------------------------------------------------------------
# The seam the request surface calls
# ---------------------------------------------------------------------------

_src_lock = threading.Lock()
_src_digest: "OrderedDict[str, str]" = OrderedDict()


def _note_staleness(src: str, digest: str) -> None:
    """A source whose rule set changed since its last request counts a
    stale rebuild (the content-addressed key makes it a cache miss)."""
    with _src_lock:
        prev = _src_digest.get(src)
        if prev is not None and prev != digest:
            _tally("stale")
            _bump(stale_rebuilds=1)
        _src_digest[src] = digest
        _src_digest.move_to_end(src)
        while len(_src_digest) > 256:
            _src_digest.popitem(last=False)


def _score(payload: str, kind: str, prefix: List[int], m: int, *,
           priority: str, source: Optional[str], device: DeviceLike,
           tenant: str = "default"):
    """Digest, staleness note, artifact and broker ride of one request:
    returns ``(digest, trie, ticket)``.  Raises on a build or wave
    failure."""
    digest = rule_trie.rules_digest(payload)
    if source is not None:
        _note_staleness(source, digest)

    def rules_provider() -> list:
        if kind == "patterns":
            return rule_trie.rules_from_patterns(
                model.deserialize_patterns(payload))
        return model.deserialize_rules(payload)

    depth_floor = int(_cfg_get("depth_floor"))
    depth_need = max(depth_floor, rule_trie._next_pow2(max(1, len(prefix))))
    trie = _cache(device).get_or_build(digest, depth_need, rules_provider,
                                       _cfg_get("lanes_floor"))
    ticket = _BROKER.submit(trie, prefix, m, priority,
                            tag=source or digest[:16], tenant=tenant)
    return digest, trie, ticket


def predict_rules(payload: str, kind: str, prefix: Sequence[int], m: int, *,
                  priority: str = "normal", source: Optional[str] = None,
                  device: DeviceLike = None) -> List[dict]:
    """Top-m next-item predictions for one observed prefix against a
    serialized mine: ``kind`` ``"rules"`` (a TSR payload) or
    ``"patterns"`` (a SPADE/SPAM payload, lowered by
    ``rules_from_patterns``).  The artifact comes from the device's cache
    at ``depth_need = max(depth_floor, pow2(len(prefix)))`` and the
    request rides the broker.  ``source`` names where the payload came
    from (a job uid or a fingerprint), for the stale-rebuild tally.
    Raises on an unknown priority and on any failure of the build or the
    wave."""
    if priority not in PRIORITIES:
        _bump(requests=1, failures=1)
        raise ValueError(f"unknown priority {priority!r} "
                         f"(have: {', '.join(PRIORITIES)})")
    prefix = sorted({int(i) for i in prefix})
    m = max(1, min(int(m), 256))
    try:
        _, _, ticket = _score(payload, kind, prefix, m, priority=priority,
                              source=source, device=device)
    except BaseException:
        _bump(requests=1, failures=1)
        raise
    _bump(requests=1, served=1)
    return ticket.entries or []


# ---------------------------------------------------------------------------
# Serving surface
# ---------------------------------------------------------------------------

class Predictor:
    """``predict`` task handler: resolve rules, ride the broker, answer
    in the Questor prediction spelling, on ``device`` (the service's)."""

    def __init__(self, store, device: DeviceLike = None) -> None:
        self.store = store
        self.device = device

    # -- rule resolution ----------------------------------------------------

    def _resolve_payload(self, req: ServiceRequest
                         ) -> Tuple[Optional[str], Optional[str], str]:
        """-> (payload, kind, source key) or (None, error message, "")."""
        uid = req.uid
        fp = req.param("fingerprint")
        if uid:
            status = self.store.status(uid)
            if status is None:
                return None, "unknown uid", ""
            if status != Status.FINISHED:
                return None, "job not finished; results pending", ""
            payload = self.store.rules(uid)
            if payload is not None:
                return payload, "rules", f"uid:{uid}"
            payload = self.store.patterns(uid)
            if payload is not None:
                return payload, "patterns", f"uid:{uid}"
            return None, "no rules", ""
        if fp:
            from spark_fsm_tpu_torch.service import resultcache

            algo = (req.param("algorithm") or "TSR_TPU").upper()
            # verified read + rules_digest cross-check: the artifact
            # cache keys compiled tries on that digest, so never build
            # from bytes the digest does not vouch for
            opened = resultcache.open_entry(self.store, fp, algo,
                                            check_digest=True)
            if opened is None:
                return None, "no rescache entry for fingerprint", ""
            ent, _size = opened
            return (ent.get("payload") or "[]",
                    ent.get("kind") or "rules", f"fp:{fp}:{algo}")
        return None, "predict needs 'uid' (finished job) or 'fingerprint'", ""

    # -- request handling ---------------------------------------------------

    def _fail(self, req: ServiceRequest, error: str,
              outcome: str = "failure") -> ServiceResponse:
        _REQS.inc(outcome=outcome)
        _bump(requests=1, failures=1)
        return model.response(req, Status.FAILURE, error=error)

    def handle(self, req: ServiceRequest) -> ServiceResponse:
        t_start = time.monotonic()
        priority = (req.param("priority") or "normal").lower()
        if priority not in PRIORITIES:
            return self._fail(req, f"unknown priority {priority!r} "
                                   f"(have: {', '.join(PRIORITIES)})")
        # an unknown tenant reads as "default", never a failure (the
        # label space stays bounded)
        tenant = (req.param("tenant") or obsplane.DEFAULT_TENANT)
        if tenant not in obsplane.known_tenants():
            tenant = obsplane.DEFAULT_TENANT
        items_param = req.param("items")
        if items_param is None:
            return self._fail(
                req, "predict needs 'items' (comma-separated item ids "
                     "observed so far; empty allowed)")
        try:
            prefix = sorted({int(i) for i in items_param.split(",") if i})
        except ValueError:
            return self._fail(req, f"bad 'items' value {items_param!r}")
        try:
            m = int(req.param("m") or _cfg_get("topm"))
        except ValueError:
            m = int(_cfg_get("topm"))
        m = max(1, min(m, 256))

        payload, kind, src = self._resolve_payload(req)
        if payload is None:
            outcome = "no_rules" if kind in (
                "no rules", "no rescache entry for fingerprint") \
                else "failure"
            return self._fail(req, kind, outcome)
        try:
            digest, trie, ticket = _score(
                payload, kind, prefix, m, priority=priority, source=src,
                device=self.device, tenant=tenant)
        except Exception as exc:
            log_event("predict_failed", source=src, error=str(exc))
            return self._fail(req, f"predict failed: {exc}")
        e2e_s = time.monotonic() - t_start
        window_wait_s = max(0.0, ticket.dispatch_t - ticket.submit_t)
        # read-path SLO: the obsplane's second signal class
        obsplane.observe_predict(priority, e2e_s, window_wait_s,
                                 ticket.exec_s, tenant=tenant)
        _REQS.inc(outcome="served")
        _bump(requests=1, served=1)
        return model.response(
            req, Status.FINISHED,
            predictions=json.dumps(ticket.entries or []),
            stats=json.dumps({
                "shape_key": f"predict:f{trie.F}d{trie.D}",
                "artifact_digest": digest[:16],
                "artifact_lanes": trie.lanes,
                "source": src,
                "fused": ticket.wave_jobs >= 2,
                "wave_jobs": ticket.wave_jobs,
                "m": m,
                "priority": priority,
                "tenant": tenant,
                "e2e_ms": round(e2e_s * 1000.0, 3),
                "window_wait_ms": round(window_wait_s * 1000.0, 3),
                "exec_ms": round(ticket.exec_s * 1000.0, 3),
            }))

    def stats(self) -> dict:
        with _stats_lock:
            s = dict(_stats)
        s["exec_s"] = round(s["exec_s"], 6)
        s["cache"] = _cache(self.device).snapshot()
        with _cfg_lock:
            s["config"] = dict(_cfg)
        return s

    def shutdown(self) -> None:
        _BROKER.shutdown()
