"""Bounded exponential backoff + jitter, and a device circuit breaker.

The reference gets I/O retry for free from its runtime (Spark task
re-execution, Akka supervision backoff); this rebuild's store and broker
seams had none — a single Redis hiccup mid-checkpoint failed the whole
job.  This module is the ONE retry policy those seams share
(:class:`RetryPolicy`: StoreCheckpoint's store I/O, the consumer loop's
error backoff), plus :class:`CircuitBreaker` for the devcache's
device-put seam — N consecutive failures stop paying the failing path's
cost and fall back to the host path, with an automatic half-open probe
after a cooldown.

Every retry/give-up is counted per site (module-global, surfaced by
``/admin/health``), and jitter is SEEDED so chaos runs are reproducible.

Port: a copy of ``spark_fsm_tpu/utils/retry.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.obs import log_event

_lock = threading.Lock()
_counters: Dict[str, Dict[str, int]] = {}

# Retry-policy sites wired into the framework itself (callers may add
# ad-hoc sites; these are the ones scripts/obs_smoke.sh asserts have
# registry series even before their first use — a policy with no
# metric would be invisible exactly when it matters).
KNOWN_SITES = ("store.checkpoint",)


def _collect_metrics():
    """fsm_retry_* families for the unified registry; every KNOWN_SITES
    policy emits zero-valued series from boot (no orphan counters)."""
    with _lock:
        per_site = {s: dict(c) for s, c in _counters.items()}
    for s in KNOWN_SITES:
        per_site.setdefault(s, {"attempts": 0, "retries": 0, "gave_up": 0})
    fams = []
    for key in ("attempts", "retries", "gave_up"):
        fams.append((f"fsm_retry_{key}_total", "counter", "",
                     [({"site": s}, c.get(key, 0))
                      for s, c in sorted(per_site.items())]))
    return fams


obs.REGISTRY.register_collector("retry", _collect_metrics)


def _count(site: str, key: str, n: int = 1) -> None:
    with _lock:
        c = _counters.setdefault(
            site, {"attempts": 0, "retries": 0, "gave_up": 0})
        c[key] += n


def retry_counters() -> Dict[str, Dict[str, int]]:
    """Per-site attempt/retry/give-up counters (``/admin/health``)."""
    with _lock:
        return {s: dict(c) for s, c in _counters.items()}


def reset_retry_counters() -> None:
    with _lock:
        _counters.clear()


class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``delay_s(attempt)`` for attempt n (1-based) is
    ``base_s * factor**(n-1)`` scaled UP by a jitter factor in
    ``[1, 1+jitter]`` (a retry never waits less than the un-jittered
    schedule — a backoff that can undercut the base interval would
    hammer the failing dependency harder than the happy path), then
    clamped to ``max_s`` (the documented hard bound, jitter included).
    Seeded, so a chaos run's schedule is reproducible.
    """

    def __init__(self, retries: int = 3, base_s: float = 0.05,
                 max_s: float = 2.0, factor: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 no_retry: Tuple[type, ...] = ()) -> None:
        if retries < 0:
            raise ValueError(f"retries must be >= 0 (got {retries})")
        self.retries = int(retries)
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.no_retry = tuple(no_retry)

    def delay_s(self, attempt: int) -> float:
        d = self.base_s * self.factor ** max(0, attempt - 1)
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.random()
        return min(self.max_s, max(0.0, d))

    def run(self, fn: Callable, *args, site: str = "retry", **kwargs):
        """Call ``fn`` with up to ``retries`` re-runs on exception.

        ``no_retry`` exception types fail immediately (deterministic
        errors — re-running would just repeat them, the Miner's
        ValueError convention).  The final failure re-raises the last
        exception after counting a give-up.
        """
        attempt = 0
        while True:
            _count(site, "attempts")
            try:
                return fn(*args, **kwargs)
            except self.no_retry:
                _count(site, "gave_up")
                raise
            except Exception as exc:
                attempt += 1
                if attempt > self.retries:
                    _count(site, "gave_up")
                    raise
                _count(site, "retries")
                wait_s = self.delay_s(attempt)
                log_event("io_retry", site=site, attempt=attempt,
                          error=f"{type(exc).__name__}: {exc}")
                obs.trace_event("io_retry", site=site, attempt=attempt,
                                wait_s=round(wait_s, 4),
                                error=f"{type(exc).__name__}: {exc}")
                self._sleep(wait_s)


class CircuitBreaker:
    """closed -> open after N consecutive failures -> half-open probe.

    ``allow()`` gates the protected path: True while closed; False while
    open (callers take their fallback — counted as ``short_circuited``);
    after ``cooldown_s`` the next ``allow()`` lets exactly ONE probe
    through (half-open) while concurrent callers keep falling back.  The
    probe's ``success()`` closes the breaker; its ``failure()`` reopens
    it for another cooldown.  Callers must pair every True ``allow()``
    with exactly one ``success()``/``failure()`` — but a probe that dies
    without reporting (a hung device, a BaseException skipping the
    caller's handler) EXPIRES after another ``cooldown_s``, so a lost
    probe degrades to one more cooldown of fallbacks instead of wedging
    the breaker open for the life of the process.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str, threshold: int = 3,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1 (got {threshold})")
        self.name = name
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0
        self._counts = {"successes": 0, "failures": 0, "opens": 0,
                        "short_circuited": 0}

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if (self._state == self.OPEN
                    and now - self._opened_at >= self.cooldown_s):
                self._state = self.HALF_OPEN
                self._probing = False
            if self._state == self.HALF_OPEN:
                if (self._probing
                        and now - self._probe_started >= self.cooldown_s):
                    self._probing = False  # lost probe: expire it
                if not self._probing:
                    self._probing = True  # this caller IS the probe
                    self._probe_started = now
                    return True
            self._counts["short_circuited"] += 1
            return False

    def success(self) -> None:
        with self._lock:
            self._counts["successes"] += 1
            self._consecutive = 0
            self._probing = False
            if self._state != self.CLOSED:
                log_event("breaker_closed", breaker=self.name)
                obs.trace_event("breaker_closed", breaker=self.name)
            self._state = self.CLOSED

    def failure(self) -> None:
        with self._lock:
            self._counts["failures"] += 1
            self._consecutive += 1
            was = self._state
            if (self._state == self.HALF_OPEN
                    or self._consecutive >= self.threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False
                if was != self.OPEN:
                    self._counts["opens"] += 1
                    log_event("breaker_opened", breaker=self.name,
                              consecutive=self._consecutive)
                    obs.trace_event("breaker_opened", breaker=self.name,
                                    consecutive=self._consecutive)

    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    **self._counts}
