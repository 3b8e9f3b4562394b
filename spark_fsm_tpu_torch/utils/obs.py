"""Observability: unified metrics registry + per-job flight recorder
(plus the structured-log / profiler seams that predate them).

The reference gets logging from log4j/slf4j, metrics from the Spark web
UI and profiling from Spark's event timeline (SURVEY.md sec 5 tracing +
metrics rows).  The rebuild grew deep machinery those analogs cannot
see: the ragged planner picks launch geometries from a cost model, the
watchdog derives deadlines from the same model, and the recovery paths
(retry/backoff, OOM degradation ladder, devcache breaker) fire with no
record of WHEN or in what order — lifetime counters cannot show a
straggler launch or a retry storm.  This module is the one
zero-dependency substrate for all of it:

- **metrics registry** (:data:`REGISTRY`): process-global counters,
  gauges, and fixed-bucket latency histograms under ONE naming scheme
  (``fsm_<subsystem>_<name>``, counters suffixed ``_total``), rendered
  in Prometheus text exposition format by ``GET /metrics``
  (service/app.py).  Subsystems that already keep their own counters
  (utils/retry, utils/watchdog, utils/faults, service/devcache,
  streaming/consumer, the job counters in the result store) register
  scrape-time COLLECTORS that read those counters into canonical
  ``fsm_*`` names — the existing dicts stay the source of truth, the
  registry is the one window onto them, and ``/admin/stats`` /
  ``/admin/health`` keep their old JSON keys as aliases (the mapping is
  tabled in docs/OPERATIONS.md).
- **flight recorder**: a per-job bounded ring of structured SPANS
  (``trace_id`` = job uid, site, monotonic t_start/t_end, a wall-clock
  ``ts`` for cross-process merging, attrs, and point-in-time EVENTS for
  fault trips, retry waits, watchdog timeouts, OOM downgrades, breaker
  transitions).  A trace opens at mine submit (service/actors.Miner),
  or at a library mine's entry when none is active (:func:`mine_trace`),
  and threads through engine dispatch, ragged-planner launches, device
  readback, and store/checkpoint/Kafka I/O via a contextvar — no
  constructor plumbing.  An open span is also a ``torch.profiler``
  range, so a profiled mine's trace names the host work between the
  kernels.  Each launch span carries the planner's
  PREDICTED seconds next to the measured wall, so cost-model residuals
  become a first-class gauge (``fsm_costmodel_drift_ratio``) that
  calibrates the watchdog slack.  ``GET /admin/trace/<job_id>`` dumps a
  trace; ``/admin/trace/last`` the most recent one.
- **trace spine hook**: when a SPINE SINK is installed
  (:func:`set_spine` — service/obsplane.py wires it to the result
  store through the lease-fenced write path), completed spans also
  buffer per trace and flush to the sink in batches: at the configured
  span count, at every :func:`flush_trace` call (checkpoint saves and
  terminal paths), and on trace eviction.  The recorder stays the
  in-memory truth; the spine is the durable, cross-replica copy that
  survives a kill -9.  No sink installed (the solo default) costs one
  module-global read per probe.
- **sliding-window quantiles** (:class:`SlidingQuantiles`): bounded
  (wall-ts, value) samples per label set with exact quantiles over a
  trailing window — the /admin/slo substrate (fixed-bucket histograms
  cannot answer "p99 over the last five minutes").

Tracing is config-gated (``[observability] trace``) and the DISABLED
path costs one module-global read per probe — the same pin as the fault
registry (scripts/bench_smoke.sh asserts the dispatch-shape counters
stay byte-identical).  Metrics are always on: registry writes are a
lock + dict update, and ``/metrics`` must serve even when tracing is
off.

Port: a copy of ``spark_fsm_tpu/utils/obs.py`` with its imports pointed
at ``spark_fsm_tpu_torch``; :func:`profile_trace` runs ``torch.profiler``
where the reference runs ``jax.profiler``.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import itertools
import json
import logging
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("spark_fsm_tpu_torch")


def engine_route(stats: dict) -> str:
    """Canonical route label from a SPADE engine stats dict: the
    ``fused`` key is False (classic DFS), True (dense fused engine) or
    an engine name string ("queue").  One definition so every artifact
    (BENCH_SUITE, BENCH_SCALE, service stats) records identical labels —
    a new engine name must not drift between them."""
    f = stats.get("fused")
    if isinstance(f, str):
        return f
    return "fused" if f else "classic"


def log_event(event: str, **fields) -> None:
    """Emit one JSON object per line: {"event": ..., "ts": ..., **fields}.

    Quiet unless the host app configures the ``spark_fsm_tpu_torch`` logger (or
    logging.basicConfig); the service CLI enables INFO by default.
    """
    payload = {"event": event, "ts": round(time.time(), 3)}
    payload.update(fields)
    logger.info(json.dumps(payload, default=str, sort_keys=True))


_trace_lock = threading.Lock()


@contextlib.contextmanager
def profile_trace(trace_dir: str):
    """``torch.profiler`` scope when ``trace_dir`` is set; no-op else.

    The scope traces the host and, when a card is present, CUDA
    activity, and writes one Chrome trace (``trace_<pid>_<ns>.json``)
    under ``trace_dir`` on exit.  One trace at a time per process:
    concurrently profiled jobs serialize on a lock rather than failing
    the second job.
    """
    if not trace_dir:
        yield
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with _trace_lock:
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ===========================================================================
# Metrics registry
# ===========================================================================

# One naming scheme for every exported series: fsm_<subsystem>_<name>,
# counters suffixed _total.  The registry REFUSES other spellings — a
# metric that drifts off the scheme would silently fork the namespace
# the Prometheus scrape (and the OPERATIONS.md table) is keyed on.
_NAME_RE = re.compile(r"^fsm_[a-z][a-z0-9_]*$")

# Default latency bucket edges (seconds): sub-ms store ops through
# minutes-long prewarm compiles share one ladder so cross-metric
# comparisons read off the same edges.
LATENCY_BUCKETS_S = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                     30.0, 60.0)


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: thread-safe {label-key: value} map."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the fsm_<subsystem>_<name> "
                "scheme (lowercase, fsm_ prefix)")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def _set(self, value: float, labels: dict) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def _add(self, n: float, labels: dict) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        """[(suffix, label_key, value)] — suffix appended to the family
        name in exposition ("" for plain counters/gauges)."""
        with self._lock:
            return [("", k, v) for k, v in self._values.items()]

    def snapshot(self):
        """JSON-able value view: scalar for the unlabelled series, else
        {"k=v,...": value}."""
        with self._lock:
            if list(self._values) == [()]:
                return self._values[()]
            return {",".join(f"{k}={v}" for k, v in key): val
                    for key, val in self._values.items()}


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        # seed the unlabelled series at 0: a scrape must distinguish
        # "zero events" from "metric missing" (the orphan-counter
        # failure mode the collectors' KNOWN_SITES zero-seeding guards
        # against, applied to the registry's own counters) — rate()
        # alerts on never-touched counters read 0, not no-data
        self._values[()] = 0.0

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self._add(n, labels)

    def seed(self, **labels) -> "Counter":
        """Zero-seed one LABELLED series (idempotent; never clobbers a
        live count).  The labelled analog of the unlabelled seed above:
        a subsystem with a known outcome vocabulary (lease acquire
        ok/held/error, steal stolen/lost_race/error) seeds every outcome
        at registration so a scrape reads 0, not no-data, for outcomes
        that simply have not happened yet — the same orphan-series
        posture as the fault registry's KNOWN_SITES zero-seeding."""
        key = _label_key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)
        return self

    def total(self) -> float:
        """Sum over every series of this counter — what the lease
        heartbeat piggybacks into its compact metric snapshot."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._set(float(value), labels)


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus semantics: bucket
    edges are INCLUSIVE upper bounds, ``+Inf`` is implicit, ``_sum`` and
    ``_count`` ride along)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        super().__init__(name, help)
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: bucket edges must be a "
                             f"nonempty strictly increasing tuple ({buckets})")
        self.buckets = edges
        # label_key -> [per-edge counts..., +Inf count, sum]
        self._h: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        key = _label_key(labels)
        i = bisect.bisect_left(self.buckets, v)  # first edge >= v
        with self._lock:
            row = self._h.get(key)
            if row is None:
                row = self._h[key] = [0.0] * (len(self.buckets) + 1) + [0.0]
            row[min(i, len(self.buckets))] += 1
            row[-1] += v

    def seed(self, **labels) -> "Histogram":
        """Zero-seed one series (all-zero buckets, count 0) — the
        histogram analog of :meth:`Counter.seed`, so a fresh scrape
        shows ``_count 0`` for a label vocabulary (e.g. every priority
        class) instead of no data."""
        key = _label_key(labels)
        with self._lock:
            if key not in self._h:
                self._h[key] = [0.0] * (len(self.buckets) + 1) + [0.0]
        return self

    def samples(self):
        out = []
        with self._lock:
            rows = {k: list(v) for k, v in self._h.items()}
        for key, row in rows.items():
            cum = 0.0
            for edge, n in zip(self.buckets, row):
                cum += n
                out.append(("_bucket", key + (("le", _fmt(edge)),), cum))
            cum += row[len(self.buckets)]
            out.append(("_bucket", key + (("le", "+Inf"),), cum))
            out.append(("_count", key, cum))
            out.append(("_sum", key, row[-1]))
        return out

    def snapshot(self):
        with self._lock:
            return {
                (",".join(f"{k}={v}" for k, v in key) or "all"): {
                    "count": sum(row[:-1]), "sum": round(row[-1], 6)}
                for key, row in self._h.items()}


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)


class MetricsRegistry:
    """Process-global metric store + scrape-time collector list.

    ``counter``/``gauge``/``histogram`` are get-or-create (re-requesting
    a name returns the same object; a kind mismatch is a bug and
    raises).  ``register_collector(name, fn)`` installs a callable run
    at scrape time that returns a list of
    ``(name, kind, help, [(labels_dict, value), ...])`` families —
    the bridge for subsystems that already keep counters elsewhere
    (retry/watchdog/faults/devcache/consumer/job counters); registering
    the same collector name again REPLACES it (tests build many masters).
    A collector that raises is skipped — ``/metrics`` must stay
    readable during a chaos drill, same posture as /admin/health.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._collectors: "OrderedDict[str, Callable]" = OrderedDict()

    def _get_or_make(self, cls, name, help, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif type(m) is not cls:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            elif ("buckets" in kw
                  and tuple(float(b) for b in kw["buckets"]) != m.buckets):
                # a silent edge mismatch would bin the second caller's
                # observations against a ladder it never asked for
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}, requested {tuple(kw['buckets'])}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def register_collector(self, name: str, fn: Callable) -> None:
        with self._lock:
            self._collectors[name] = fn

    def _collected(self):
        with self._lock:
            collectors = list(self._collectors.items())
        fams = []
        for cname, fn in collectors:
            try:
                fams.extend(fn())
            except Exception as exc:  # scrape survives a failing subsystem
                log_event("metrics_collector_failed", collector=cname,
                          error=f"{type(exc).__name__}: {exc}")
        return fams

    def render_prometheus(self) -> str:
        """The full registry + collectors in Prometheus text exposition
        format (version 0.0.4)."""
        lines: List[str] = []

        def emit(name, kind, help, samples):
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for suffix, key, value in samples:
                lbl = ("{" + ",".join(
                    f'{k}="{_escape(v)}"' for k, v in key) + "}"
                    if key else "")
                lines.append(f"{name}{suffix}{lbl} {_fmt(float(value))}")

        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            emit(m.name, m.kind, m.help, m.samples())
        for name, kind, help, rows in self._collected():
            if not _NAME_RE.match(name):
                continue  # a collector cannot fork the namespace either
            emit(name, kind, help,
                 [("", _label_key(labels), value) for labels, value in rows])
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {canonical name: value} view of the whole registry
        (collectors included) — what /admin/stats and /admin/health
        embed so their old JSON keys become documented aliases of these
        names."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out[m.name] = m.snapshot()
        for name, kind, help, rows in self._collected():
            vals = {(",".join(f"{k}={v}" for k, v in _label_key(labels))):
                    value for labels, value in rows}
            out[name] = vals.pop("", None) if list(vals) == [""] else vals
        return out


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


REGISTRY = MetricsRegistry()

# -- registry-native metrics owned by this module ---------------------------

_SPANS_TOTAL = REGISTRY.counter(
    "fsm_trace_spans_total", "flight-recorder spans completed")
_SPANS_DROPPED = REGISTRY.counter(
    "fsm_trace_spans_dropped_total",
    "spans evicted from per-job rings (ring full)")
_COSTMODEL_SAMPLES = REGISTRY.counter(
    "fsm_costmodel_samples_total",
    "dispatch walls compared against the ragged planner's estimate")
_COSTMODEL_DRIFT = REGISTRY.gauge(
    "fsm_costmodel_drift_ratio",
    "EWMA of measured/predicted dispatch wall — the watchdog-slack "
    "calibration input (slack should exceed this with margin)")
_COSTMODEL_RESIDUAL = REGISTRY.histogram(
    "fsm_costmodel_residual_ratio",
    "distribution of measured/predicted dispatch wall",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0, 256.0))

_DRIFT_ALPHA = 0.2  # EWMA weight for the newest residual
_drift_lock = threading.Lock()
_drift_ewma: Optional[float] = None

#: per-shape-family drift: the single global EWMA above
#: stays the ``drift_factor`` recalibration input, unchanged; these
#: labeled gauges break the same residuals out per dispatch family so
#: the hardware-recalibration session can see WHICH shape family the
#: planner misprices.  The vocabulary is closed (shapes.py families) —
#: unknown families are dropped, keeping the label space bounded.
COSTMODEL_FAMILIES = ("tsr-eval", "tsr-fused", "tsr-resident", "spam",
                      "predict")
_COSTMODEL_FAMILY_DRIFT = REGISTRY.gauge(
    "fsm_costmodel_family_drift_ratio",
    "EWMA of measured/predicted dispatch wall per shape family")
for _f in COSTMODEL_FAMILIES:
    _COSTMODEL_FAMILY_DRIFT.set(0.0, family=_f)
del _f
_family_ewma: Dict[str, float] = {}


def observe_costmodel_family(family: str, predicted_s: float,
                             measured_s: float) -> None:
    """Feed one (predicted, measured) pair into a FAMILY drift gauge
    only — for dispatch surfaces (resident segments, SPAM waves) whose
    residuals must NOT perturb the global recalibration EWMA that
    ``drift_factor`` consumes (pinned byte-identical by bench_smoke)."""
    if predicted_s <= 0 or family not in COSTMODEL_FAMILIES:
        return
    ratio = measured_s / predicted_s
    with _drift_lock:
        prev = _family_ewma.get(family)
        cur = (ratio if prev is None
               else _DRIFT_ALPHA * ratio + (1 - _DRIFT_ALPHA) * prev)
        _family_ewma[family] = cur
        _COSTMODEL_FAMILY_DRIFT.set(cur, family=family)


def observe_costmodel(predicted_s: float, measured_s: float,
                      family: Optional[str] = None) -> None:
    """Feed one (predicted, measured) dispatch-wall pair into the
    cost-model calibration gauge.  Ratios are measured/predicted, so a
    drifting gauge reads directly as "the planner underestimates by
    Nx" — the number ``[engine] watchdog_slack`` must stay above.
    Pairs with a degenerate prediction are dropped (a zero-traffic
    dispatch says nothing about the model).  ``family`` additionally
    routes the pair into that family's labeled drift gauge; the global
    EWMA path is byte-identical with or without it."""
    global _drift_ewma
    if predicted_s <= 0:
        return
    ratio = measured_s / predicted_s
    _COSTMODEL_SAMPLES.inc()
    _COSTMODEL_RESIDUAL.observe(ratio)
    with _drift_lock:
        _drift_ewma = (ratio if _drift_ewma is None
                       else _DRIFT_ALPHA * ratio
                       + (1 - _DRIFT_ALPHA) * _drift_ewma)
        _COSTMODEL_DRIFT.set(_drift_ewma)
    if family is not None:
        observe_costmodel_family(family, predicted_s, measured_s)


def costmodel_drift() -> Optional[float]:
    """Current measured/predicted EWMA (None until the first sample)."""
    with _drift_lock:
        return _drift_ewma


def costmodel_family_drift() -> Dict[str, float]:
    """Per-family measured/predicted EWMAs (families with samples)."""
    with _drift_lock:
        return dict(_family_ewma)


# ===========================================================================
# Flight recorder
# ===========================================================================

# Fast-path flag: every probe (span(), trace_event(), trace()) returns
# after ONE module-global read when tracing is off — the same contract
# as utils/faults._active, and pinned the same way (test_obs.py asserts
# zero span allocations + bench_smoke asserts byte-identical dispatch
# counters).
_trace_on = False

# the torch.profiler range an open span holds (see Span), bound by the
# first configure_tracing(True): a process that never traces never
# imports the profiler.  torch's own fast range where it has one (under
# 1 us a span), else the public record_function (about 10 us)
_profiler_range: Optional[Callable] = None

_cfg_lock = threading.Lock()
_max_spans = 512   # per-job completed-span ring bound
_max_jobs = 16     # job traces kept (oldest evicted)

_span_ids = itertools.count(1)

# the active trace/span of THIS logical context (worker thread / task):
# engine internals record into whatever job is mining on their thread
# without any constructor plumbing
_cur_trace: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "fsm_trace", default=None)
_cur_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "fsm_span", default=None)


class Span:
    """One timed unit of work inside a trace.  ``event`` records a
    point-in-time marker (fault trip, retry wait, OOM downgrade,
    breaker transition); ``set`` attaches/overrides attrs (e.g. the
    measured wall next to the predicted one).  Close via the context
    manager — the span enters its trace's ring only on exit.  While it
    is open it is also a ``torch.profiler`` range named ``site``, so
    under any profiler session the span is a host event on the same
    clock as the kernels it launched."""

    __slots__ = ("trace_id", "span_id", "parent_id", "site", "t0", "t0w",
                 "t1", "attrs", "events", "error", "_token", "_range")

    def __init__(self, trace_id: str, parent_id: Optional[int], site: str,
                 attrs: dict):
        self.trace_id = trace_id
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.site = site
        self.t0 = time.monotonic()
        # wall-clock twin of t0: monotonic clocks are PER-PROCESS, so
        # the cross-replica merged timeline (service/obsplane.py) can
        # only order spans from different replicas by wall time
        self.t0w = time.time()
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.events: List[dict] = []
        self.error: Optional[str] = None
        self._token = None
        self._range = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs) -> None:
        e = {"name": name, "t": round(time.monotonic() - self.t0, 6)}
        if attrs:
            e.update(attrs)
        self.events.append(e)

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def __enter__(self) -> "Span":
        self._token = _cur_span.set(self)
        self._range = _profiler_range(self.site)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _cur_span.reset(self._token)
            self._token = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.t1 = time.monotonic()
        if exc is not None:
            self.error = f"{type(exc).__name__}: {exc}"
        _recorder.record(self)

    def to_dict(self) -> dict:
        d = {"span_id": self.span_id, "parent_id": self.parent_id,
             "site": self.site, "t_start": round(self.t0, 6),
             "ts": round(self.t0w, 6),
             "t_end": None if self.t1 is None else round(self.t1, 6),
             "duration_s": (None if self.t1 is None
                            else round(self.t1 - self.t0, 6))}
        if self.attrs:
            d["attrs"] = {k: v for k, v in self.attrs.items()}
        if self.events:
            d["events"] = list(self.events)
        if self.error:
            d["error"] = self.error
        return d


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op and
    ``span()`` returns THIS SINGLETON when tracing is off — no
    allocation, no clock read (the disabled-cost pin in test_obs.py)."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()

# -- trace spine hook ---------------------------------------------
# The sink is a callable ``fn(trace_id, [span_dict, ...])`` installed by
# service/obsplane.py when the cluster observability plane is active; it
# owns durability, fencing and failure handling (a sink error must never
# fail the recorded work).  None (the default) keeps every probe at one
# module-global read — the same disabled-cost pin as ``_trace_on``.
_spine: Optional[Callable[[str, List[dict]], None]] = None
_spine_flush_spans = 32


def set_spine(sink: Optional[Callable[[str, List[dict]], None]],
              flush_spans: Optional[int] = None) -> None:
    """Install (or remove, with None) the process-wide spine sink.
    ``flush_spans`` sets how many completed spans buffer per trace
    before an automatic flush."""
    global _spine, _spine_flush_spans
    with _cfg_lock:
        if flush_spans is not None:
            if flush_spans < 1:
                raise ValueError(
                    f"flush_spans must be >= 1 (got {flush_spans})")
            _spine_flush_spans = int(flush_spans)
        _spine = sink


def set_spine_flush(flush_spans: int) -> None:
    """Adjust the per-trace flush threshold without touching the sink
    (the boot config's ``[observability] spine_flush_spans`` knob)."""
    set_spine(_spine, flush_spans=flush_spans)


def _spine_send(trace_id: str, batch: List[dict]) -> None:
    sink = _spine
    if sink is None or not batch:
        return
    try:
        sink(trace_id, batch)
    except Exception as exc:  # the sink must never fail the work
        log_event("trace_spine_sink_failed", trace=trace_id,
                  error=f"{type(exc).__name__}: {exc}")


class _Trace:
    __slots__ = ("trace_id", "spans", "dropped", "started_wall", "attrs",
                 "pending")

    def __init__(self, trace_id: str, max_spans: int, attrs: dict):
        self.trace_id = trace_id
        self.spans: "deque[Span]" = deque(maxlen=max_spans)
        self.dropped = 0
        self.started_wall = time.time()
        self.attrs = attrs
        # spans completed since the last spine flush (only populated
        # while a spine sink is installed — see set_spine)
        self.pending: List[dict] = []


class FlightRecorder:
    """Bounded ring-of-rings: at most ``_max_jobs`` traces, each a
    deque of at most ``_max_spans`` COMPLETED spans (completion order;
    oldest evicted first — the straggler hunt cares about the tail of
    a job, not its warmup).  Spans record on close, under one lock —
    concurrent miner workers interleave safely."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self._last: Optional[str] = None
        self._sinks: List[Callable] = []

    def begin(self, trace_id: str, attrs: dict) -> None:
        evicted: List[_Trace] = []
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                # a re-run/retried uid keeps ONE ring: the old spans stay
                # until evicted, so a retry's trace shows the failed
                # attempt's tail next to the re-run — the order of
                # recovery events is the point of the recorder
                t = self._traces[trace_id] = _Trace(trace_id, _max_spans,
                                                    attrs)
                while len(self._traces) > _max_jobs:
                    evicted.append(self._traces.popitem(last=False)[1])
            else:
                t.attrs.update(attrs)
            self._traces.move_to_end(trace_id)
            self._last = trace_id
        for old in evicted:  # outside the lock: the sink does store I/O
            if old.pending:
                _spine_send(old.trace_id, old.pending)

    def record(self, span: Span) -> None:
        sinks = None
        flush: Optional[List[dict]] = None
        with self._lock:
            t = self._traces.get(span.trace_id)
            if t is not None:
                if len(t.spans) == t.spans.maxlen:
                    t.dropped += 1
                    _SPANS_DROPPED.inc()
                t.spans.append(span)
                self._last = span.trace_id
                if _spine is not None:
                    # buffer for the durable spine; flush in batches so
                    # the store pays one append per N spans, not per span
                    t.pending.append(span.to_dict())
                    if len(t.pending) >= _spine_flush_spans:
                        flush, t.pending = t.pending, []
            if self._sinks:
                sinks = list(self._sinks)
        _SPANS_TOTAL.inc()
        if flush is not None:
            _spine_send(span.trace_id, flush)
        if sinks:
            for fn in sinks:
                try:
                    fn(span)
                except Exception:
                    pass  # a reporting sink must never fail the work

    def take_pending(self, trace_id: str) -> List[dict]:
        """Pop the trace's un-flushed spine batch (empty when no spine
        is installed or nothing accumulated)."""
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None or not t.pending:
                return []
            batch, t.pending = t.pending, []
            return batch

    def dump(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            spans = [s.to_dict() for s in t.spans]
            return {"trace_id": t.trace_id, "started_ts": t.started_wall,
                    "attrs": dict(t.attrs), "spans": spans,
                    "dropped_spans": t.dropped, "n_spans": len(spans)}

    def last_trace_id(self) -> Optional[str]:
        with self._lock:
            return self._last

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def stats(self) -> dict:
        with self._lock:
            return {"traces": len(self._traces),
                    "spans": sum(len(t.spans) for t in
                                 self._traces.values()),
                    "dropped": sum(t.dropped for t in
                                   self._traces.values())}

    def add_sink(self, fn: Callable) -> None:
        with self._lock:
            self._sinks.append(fn)

    def remove_sink(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._last = None


_recorder = FlightRecorder()


def configure_tracing(enabled: bool, max_spans: Optional[int] = None,
                      max_jobs: Optional[int] = None) -> None:
    """Set the process-wide tracing policy (the boot config's
    ``[observability]`` block owns it via config.set_config; tests may
    call directly).  Ring bounds apply to traces begun AFTER the call."""
    global _trace_on, _max_spans, _max_jobs, _profiler_range
    if enabled and _profiler_range is None:
        try:
            from torch._C._profiler import _RecordFunctionFast as rng
        except ImportError:
            from torch.profiler import record_function as rng
        _profiler_range = rng
    with _cfg_lock:
        if max_spans is not None:
            if max_spans < 1:
                raise ValueError(f"max_spans must be >= 1 (got {max_spans})")
            _max_spans = int(max_spans)
        if max_jobs is not None:
            if max_jobs < 1:
                raise ValueError(f"max_jobs must be >= 1 (got {max_jobs})")
            _max_jobs = int(max_jobs)
        _trace_on = bool(enabled)


def tracing_enabled() -> bool:
    return _trace_on


@contextlib.contextmanager
def trace(trace_id: str, site: str = "job", **attrs):
    """Activate ``trace_id`` for this context and open its root span.
    No-op (one global read) when tracing is off."""
    if not _trace_on:
        yield _NOOP
        return
    _recorder.begin(trace_id, dict(attrs))
    token = _cur_trace.set(trace_id)
    try:
        with Span(trace_id, None, site, dict(attrs)) as sp:
            yield sp
    finally:
        _cur_trace.reset(token)


_entry_ids = itertools.count(1)


def mine_trace(site: str, **attrs):
    """The span of one library mine entry (``mine_spade_torch``,
    ``mine_cspade_torch``, the engine caches' ``mine``): inside an active
    trace (a service job's) a span of it; with tracing on and no trace
    active, the root span of a trace of the mine's own, ``{site}-{n}``.
    The no-op singleton (one global read) when tracing is off."""
    if not _trace_on:
        return _NOOP
    if _cur_trace.get() is not None:
        return span(site, **attrs)
    return trace(f"{site}-{next(_entry_ids)}", site=site, **attrs)


def trace_begin(trace_id: str, **attrs) -> None:
    """Create the trace ring (idempotent) and stamp a zero-length
    ``submit`` span — called from the HTTP handler thread at mine
    submit, before the worker thread opens the job's root span."""
    if not _trace_on:
        return
    _recorder.begin(trace_id, dict(attrs))
    with Span(trace_id, None, "job.submit", dict(attrs)):
        pass


def span(site: str, trace_id: Optional[str] = None, **attrs):
    """Open a span under the current trace (or an explicit one).
    Returns the no-op singleton when tracing is off OR no trace is
    active — engine code calls this unconditionally and pays one global
    read outside a traced job."""
    if not _trace_on:
        return _NOOP
    tid = trace_id if trace_id is not None else _cur_trace.get()
    if tid is None:
        return _NOOP
    parent = _cur_span.get()
    return Span(tid, parent.span_id if parent is not None else None,
                site, dict(attrs))


def trace_event(name: str, **attrs) -> None:
    """Record a point-in-time event on the current innermost span —
    the one-liner fault/retry/watchdog/breaker call sites use.  One
    global read when tracing is off or no span is open."""
    if not _trace_on:
        return
    sp = _cur_span.get()
    if sp is not None:
        sp.event(name, **attrs)


def lifecycle(trace_id: str, event: str, **attrs) -> None:
    """Record a first-class job lifecycle event (admitted / started /
    checkpointed / stolen / adopted / fenced / settled) as a zero-length
    ``lifecycle.{event}`` span on the job's trace — and therefore on the
    durable spine, where these markers are the observation points for
    the failover/steal latency histograms.  One global read when
    tracing is off."""
    if not _trace_on:
        return
    with span(f"lifecycle.{event}", trace_id=trace_id, **attrs):
        pass


def flush_trace(trace_id: str) -> None:
    """Flush the trace's buffered spans to the spine sink NOW — called
    at the durable milestones (admission, checkpoint saves, terminal
    paths) so a kill -9 loses at most the spans since the last
    milestone.  One module-global read when no spine is installed."""
    if _spine is None:
        return
    batch = _recorder.take_pending(trace_id)
    if batch:
        _spine_send(trace_id, batch)


def trace_dump(trace_id: str) -> Optional[dict]:
    return _recorder.dump(trace_id)


def last_trace_id() -> Optional[str]:
    return _recorder.last_trace_id()


def trace_ids() -> List[str]:
    return _recorder.trace_ids()


def recorder_stats() -> dict:
    return _recorder.stats()


def add_span_sink(fn: Callable) -> None:
    """Register a callable invoked with every COMPLETED span (tracing
    on only).  Used by the opt-in test-suite slow-span report
    (tests/conftest.py, SPARKFSM_TRACE_TESTS=1)."""
    _recorder.add_sink(fn)


def remove_span_sink(fn: Callable) -> None:
    _recorder.remove_sink(fn)


def clear_traces() -> None:
    """Drop every recorded trace (test isolation helper)."""
    _recorder.clear()


# ===========================================================================
# Sliding-window quantiles (the /admin/slo substrate)
# ===========================================================================

class SlidingQuantiles:
    """Exact quantiles over a trailing wall-clock window, per label set.

    A fixed-bucket histogram answers "how many ever fell under 1 s";
    an SLO report needs "what was p99 over the last five minutes".
    This keeps a bounded deque of ``(wall_ts, value)`` per label key —
    at most ``max_samples``, pruned to ``window_s`` on every observe and
    snapshot — and sorts on demand (snapshot-time cost, bounded by
    ``max_samples``; /admin/slo is an operator poll, not a hot path).
    ``clock`` is injectable (tests drive a virtual clock)."""

    def __init__(self, window_s: float = 300.0, max_samples: int = 2048,
                 clock=time.time):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1 (got {max_samples})")
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[Tuple[str, str], ...],
                            "deque[Tuple[float, float]]"] = {}

    def set_window(self, window_s: float) -> None:
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        with self._lock:
            self.window_s = float(window_s)

    def _prune(self, dq, now: float) -> None:
        horizon = now - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        now = self._clock()
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = deque(maxlen=self.max_samples)
            dq.append((now, float(value)))
            self._prune(dq, now)

    def stats(self, quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99),
              **labels) -> dict:
        """{"count": n, "p50": ..., "p95": ..., "p99": ..., "max": ...}
        over the live window ({"count": 0} when it is empty)."""
        key = _label_key(labels)
        now = self._clock()
        with self._lock:
            dq = self._samples.get(key)
            if dq is not None:
                self._prune(dq, now)
            values = sorted(v for _, v in dq) if dq else []
        if not values:
            return {"count": 0}
        out = {"count": len(values), "max": round(values[-1], 6)}
        for q in quantiles:
            idx = min(len(values) - 1, int(q * (len(values) - 1) + 0.5))
            out[f"p{int(q * 100)}"] = round(values[idx], 6)
        return out

    def label_keys(self) -> List[Tuple[Tuple[str, str], ...]]:
        with self._lock:
            return list(self._samples)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()
