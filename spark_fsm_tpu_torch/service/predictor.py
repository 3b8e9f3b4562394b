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

``configure`` takes the reference's ``[predict]`` fields
(``config.PredictConfig``) from a plain object or a dict.  The registry
metric families, usage deposits, event log, the request surface
(``Predictor.handle``) and its store, result cache and observability
planes belong to the service seam, which is not ported: the cache's
hits, misses, builds, evictions and stale rebuilds are plain integers
here (:func:`tallies`).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from collections.abc import Mapping
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.ops import rule_trie
from spark_fsm_tpu_torch.service import model

# the reference's request priorities (``service/obsplane.PRIORITIES``)
PRIORITIES = ("high", "normal", "low")

_stats_lock = threading.Lock()
_stats = {"requests": 0, "served": 0, "failures": 0, "waves": 0,
          "fused_waves": 0, "fused_jobs": 0, "solo_jobs": 0,
          "stale_rebuilds": 0, "exec_s": 0.0}
# the reference's registry counters, as plain integers
_tallies = {"hits": 0, "misses": 0, "builds": 0, "evictions": 0, "stale": 0}


def _bump(**kw) -> None:
    with _stats_lock:
        for k, v in kw.items():
            _stats[k] = _stats.get(k, 0) + v


def _tally(key: str) -> None:
    with _stats_lock:
        _tallies[key] += 1


def tallies() -> dict:
    """The artifact cache's hits, misses, builds and evictions and the
    stale rebuilds, over the process's lifetime."""
    with _stats_lock:
        return dict(_tallies)


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
            _bump(waves=1, fused_waves=1 if n >= 2 else 0, exec_s=exec_s,
                  **{("fused_jobs" if n >= 2 else "solo_jobs"): n})
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
    try:
        trie = _cache(device).get_or_build(digest, depth_need, rules_provider,
                                           _cfg_get("lanes_floor"))
        ticket = _BROKER.submit(trie, prefix, m, priority,
                                tag=source or digest[:16])
    except BaseException:
        _bump(requests=1, failures=1)
        raise
    _bump(requests=1, served=1)
    return ticket.entries or []
