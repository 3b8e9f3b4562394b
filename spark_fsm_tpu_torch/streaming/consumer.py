"""Pull-based micro-batch consumer loop (the Kafka-consumer shape).

SURVEY.md sec 2.5 names "Kafka micro-batches" as the reference ecosystem's
streaming feed and sec 7 step 9 makes the consumer "optional behind the
source interface".  No broker is assumed reachable (no network),
so what the framework ships is the consumer SHAPE, not a Kafka client: a
user-supplied ``fetch() -> Optional[SequenceDB]`` callable — poll one
micro-batch, return None when the broker has nothing right now — driven
by a poll loop that feeds every batch to a sink (``WindowMiner.push``, a
service Streamer topic, or any callable).  A production deployment plugs
a real client in without touching the framework::

    consumer = kafka.KafkaConsumer(...)          # external library
    def fetch():
        recs = consumer.poll(timeout_ms=500)
        batch = [parse_spmf_line(r.value) for rs in recs.values() for r in rs]
        return batch or None
    PollConsumer(fetch, miner.push).run()

Semantics:

- ``None`` from fetch = idle: sleep ``poll_interval_s`` and poll again
  (a blocking fetch can always return batches back-to-back; the interval
  then never applies).
- An EMPTY batch from fetch is treated as idle too — the window layer
  rejects empty pushes (they would evict real data while adding none).
- ``StopConsumer`` raised by fetch ends the loop cleanly (the
  end-of-partition signal); ``stop()`` ends it from another thread.
- fetch/sink exceptions do NOT kill the loop by default: they are
  counted, reported through ``on_error``, and polling continues after a
  BOUNDED EXPONENTIAL BACKOFF with seeded jitter (the shared
  utils/retry.py policy: ``poll_interval_s`` doubling per consecutive
  error up to ``max_backoff_s``) — a flaky broker must not tear down
  the mining service (the reference's supervision contract, SURVEY.md
  sec 5 failure row) and must not be hammered at full poll rate either.
  ``max_consecutive_errors`` bounds that patience; crossing it stops
  the loop with ``stats["stopped"] = "errors"``.
- ``stop()`` that fails to join its worker thread counts the leak
  (``stats["leaked_threads"]`` + the module-wide :func:`consumer_health`
  counter ``/admin/health`` reports) and logs it, instead of returning
  silently with a zombie poll loop still attached to the broker.
- BACKPRESSURE: with ``queue_depth_fn``/``pause_at``/
  ``resume_at`` set, the consumer PAUSES polling when the downstream
  queue (e.g. ``Miner.queue_size``) reaches the high watermark and
  resumes once it drains to the low one — windows wait at the broker
  (which retains them) instead of being submitted into an admission
  queue that would shed them with 429.  Pause/resume transitions are
  counted per instance (``stats``) and process-wide
  (:func:`consumer_health` / ``fsm_consumer_backpressure_pauses_total``).

Port: a copy of ``spark_fsm_tpu/streaming/consumer.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.obs import log_event
from spark_fsm_tpu_torch.utils.retry import RetryPolicy

FetchFn = Callable[[], Optional[SequenceDB]]

_health_lock = threading.Lock()
_health = {"leaked_threads": 0, "backpressure_pauses": 0}
# consume-side freshness: wall clock of the last poll and the last
# NON-IDLE poll across every consumer in the process.  The scrape-time
# gauge fsm_consumer_poll_lag_seconds = now - last consumed batch — the
# pull-loop notion of consumer lag (a healthy idle topic grows it too,
# so read it next to fsm_consumer_batches_total; a growing lag WITH
# busy polls means the sink, not the broker, is behind).
_last_poll_ts: Optional[float] = None
_last_batch_ts: Optional[float] = None

_POLL_SECONDS = obs.REGISTRY.histogram(
    "fsm_consumer_poll_seconds", "fetch() wall per poll")
_POLLS_TOTAL = obs.REGISTRY.counter("fsm_consumer_polls_total")
_BATCHES_TOTAL = obs.REGISTRY.counter("fsm_consumer_batches_total")
_ERRORS_TOTAL = obs.REGISTRY.counter("fsm_consumer_errors_total")


def _collect_metrics():
    health = consumer_health()
    fams = [("fsm_consumer_leaked_threads_total", "counter",
             "poll threads that outran stop()'s join deadline",
             [({}, health["leaked_threads"])]),
            ("fsm_consumer_backpressure_pauses_total", "counter",
             "poll loops paused at the downstream-queue high watermark",
             [({}, health["backpressure_pauses"])])]
    now = time.monotonic()
    for name, ts in (("fsm_consumer_poll_age_seconds", _last_poll_ts),
                     ("fsm_consumer_poll_lag_seconds", _last_batch_ts)):
        if ts is not None:
            fams.append((name, "gauge",
                         "seconds since the last poll / consumed batch",
                         [({}, round(now - ts, 3))]))
    return fams


obs.REGISTRY.register_collector("consumer", _collect_metrics)


def consumer_health() -> dict:
    """Process-wide consumer counters for ``/admin/health`` (consumers
    are free-standing objects, so per-instance stats alone would be
    invisible to the service's health surface)."""
    with _health_lock:
        return dict(_health)


def _count_leak() -> None:
    with _health_lock:
        _health["leaked_threads"] += 1


def _count_pause() -> None:
    with _health_lock:
        _health["backpressure_pauses"] += 1


class StopConsumer(Exception):
    """Raised by a fetch callable to end the poll loop cleanly."""


class PollConsumer:
    """Drives a pull-based micro-batch source into a push-based sink.

    Args:
      fetch: poll one micro-batch; ``None``/empty = nothing available.
      sink: called with each non-empty batch (e.g. ``WindowMiner.push``).
        Its return value is handed to ``on_result`` when given.
      poll_interval_s: sleep between polls after an idle poll or an error.
      max_consecutive_errors: stop after this many back-to-back
        fetch/sink failures (None = keep retrying forever).
      on_result: optional callback with the sink's return value (e.g. the
        window's new pattern set) after every consumed batch.
      on_error: optional callback with the exception; exceptions raised
        BY this callback are swallowed (reporting must not kill the loop).
    """

    def __init__(self, fetch: FetchFn, sink: Callable, *,
                 poll_interval_s: float = 1.0,
                 max_consecutive_errors: Optional[int] = None,
                 max_backoff_s: float = 30.0,
                 on_result: Optional[Callable] = None,
                 on_error: Optional[Callable] = None,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 pause_at: Optional[int] = None,
                 resume_at: Optional[int] = None) -> None:
        if poll_interval_s < 0:
            raise ValueError(f"poll_interval_s must be >= 0 "
                             f"(got {poll_interval_s})")
        if max_consecutive_errors is not None and max_consecutive_errors < 1:
            raise ValueError(f"max_consecutive_errors must be >= 1 or None "
                             f"(got {max_consecutive_errors})")
        if queue_depth_fn is not None:
            if pause_at is None or pause_at < 1:
                raise ValueError("queue_depth_fn needs pause_at >= 1 "
                                 f"(got {pause_at})")
            if resume_at is None:
                resume_at = pause_at // 2
            if not 0 <= resume_at < pause_at:
                raise ValueError(f"resume_at must satisfy 0 <= resume_at < "
                                 f"pause_at (got {resume_at} vs {pause_at})")
        elif pause_at is not None or resume_at is not None:
            raise ValueError("pause_at/resume_at need queue_depth_fn")
        self._fetch = fetch
        self._sink = sink
        self._depth_fn = queue_depth_fn
        self.pause_at = pause_at
        self.resume_at = resume_at
        self._paused = False
        self.poll_interval_s = float(poll_interval_s)
        self.max_consecutive_errors = max_consecutive_errors
        self.max_backoff_s = float(max_backoff_s)
        # the shared I/O backoff policy, used only for its seeded
        # delay_s schedule — the retry LOOP here is the poll loop itself
        self._backoff = RetryPolicy(base_s=self.poll_interval_s,
                                    max_s=self.max_backoff_s, seed=0)
        self._on_result = on_result
        self._on_error = on_error
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._leak_counted: Optional[threading.Thread] = None
        self._consecutive_errors = 0
        self.stats = {"polls": 0, "idle_polls": 0, "batches": 0,
                      "sequences": 0, "errors": 0, "backoff_waits": 0,
                      "leaked_threads": 0, "stopped": None,
                      "backpressure_pauses": 0, "backpressure_resumes": 0,
                      "paused_polls": 0}

    # ------------------------------------------------------------- polling

    def poll_once(self) -> bool:
        """One fetch->sink cycle; True when a batch was consumed.

        Raises StopConsumer through (the run loop turns it into a clean
        stop); other exceptions are absorbed into the error counters.
        """
        global _last_poll_ts, _last_batch_ts
        self.stats["polls"] += 1
        _POLLS_TOTAL.inc()
        t0 = time.monotonic()
        try:
            try:
                batch = self._fetch()
            finally:
                # poll latency covers the FETCH only (the broker seam);
                # sink time is the window miner's own story
                _POLL_SECONDS.observe(time.monotonic() - t0)
                _last_poll_ts = time.monotonic()
            if not batch:
                self.stats["idle_polls"] += 1
                return False
            result = self._sink(batch)
        except StopConsumer:
            raise
        except Exception as exc:
            self._report_error(exc)
            self._consecutive_errors += 1
            return False
        self._consecutive_errors = 0
        self.stats["batches"] += 1
        self.stats["sequences"] += len(batch)
        _BATCHES_TOTAL.inc()
        _last_batch_ts = time.monotonic()
        if self._on_result is not None:
            try:
                self._on_result(result)
            except Exception as exc:
                # the batch WAS consumed (the sink advanced), so this is a
                # reporting failure, not a consume failure: count + surface
                # it, never kill the loop (the supervision contract), and
                # leave the consecutive-error streak reset by the consume
                self._report_error(exc)
        return True

    def _backpressure_hold(self) -> bool:
        """True when this loop iteration was spent paused at the
        downstream high watermark instead of polling.  The depth probe
        failing is reported but FAILS OPEN (polling continues): a broken
        gauge must not silently starve the topic forever."""
        if self._depth_fn is None:
            return False
        try:
            depth = int(self._depth_fn())
        except Exception as exc:
            self._report_error(exc)
            if self._paused:
                # failing open FROM a pause is a resume transition: count
                # + log it, or pause/resume stats diverge and the fail-
                # open is invisible to an operator pairing them
                self._paused = False
                self.stats["backpressure_resumes"] += 1
                log_event("consumer_resumed", depth=None,
                          reason="depth probe failed (fail open)")
            return False
        if self._paused:
            if depth <= self.resume_at:
                self._paused = False
                self.stats["backpressure_resumes"] += 1
                log_event("consumer_resumed", depth=depth,
                          resume_at=self.resume_at)
                return False
        elif depth >= self.pause_at:
            self._paused = True
            self.stats["backpressure_pauses"] += 1
            _count_pause()
            obs.trace_event("consumer_paused", depth=depth,
                            pause_at=self.pause_at)
            log_event("consumer_paused", depth=depth, pause_at=self.pause_at)
        if self._paused:
            self.stats["paused_polls"] += 1
            # wake immediately on stop(); poll the gauge at the idle
            # cadence (floored so interval 0 cannot spin on the gauge)
            self._stop.wait(self.poll_interval_s or 0.05)
        return self._paused

    def _report_error(self, exc: Exception) -> None:
        """Count + surface an error; the reporting callback itself must
        never kill the loop."""
        self.stats["errors"] += 1
        _ERRORS_TOTAL.inc()
        obs.trace_event("consumer_error",
                        error=f"{type(exc).__name__}: {exc}")
        if self._on_error is not None:
            try:
                self._on_error(exc)
            except Exception:
                pass  # reporting must not kill the loop

    def run(self, max_polls: Optional[int] = None) -> dict:
        """Poll until stopped; returns the stats dict.

        ``max_polls`` bounds the loop for tests/drains (None = until
        ``stop()``, ``StopConsumer``, or the error bound).

        The stop event is NOT cleared here: ``start()`` clears it before
        launching the thread, so a ``stop()`` racing a fresh ``start()``
        can never be erased by the new thread entering this loop (it
        would spin unstoppably).  A direct ``run()`` call after a
        ``stop()`` therefore returns immediately with
        ``stopped="stop"`` — restart via ``start()``.
        """
        self._consecutive_errors = 0
        polls = 0
        while not self._stop.is_set():
            if max_polls is not None and polls >= max_polls:
                self.stats["stopped"] = "max_polls"
                break
            polls += 1
            # backpressure: a paused iteration burns a poll slot (so
            # bounded runs stay bounded) but never touches the broker
            if self._backpressure_hold():
                continue
            try:
                consumed = self.poll_once()
            except StopConsumer:
                self.stats["stopped"] = "end_of_stream"
                break
            if (self.max_consecutive_errors is not None
                    and self._consecutive_errors
                    >= self.max_consecutive_errors):
                self.stats["stopped"] = "errors"
                break
            if not consumed and self.poll_interval_s:
                # idle: wait out the interval; errored: exponential
                # backoff (interval doubling per consecutive error, up
                # to max_backoff_s, seeded jitter) — either way waking
                # immediately on stop()
                wait = self.poll_interval_s
                if self._consecutive_errors:
                    wait = self._backoff.delay_s(self._consecutive_errors)
                    self.stats["backoff_waits"] += 1
                self._stop.wait(wait)
        else:
            self.stats["stopped"] = "stop"
        return self.stats

    # ----------------------------------------------------- thread wrapper

    def start(self, max_polls: Optional[int] = None) -> "PollConsumer":
        """Run the poll loop in a daemon thread (idempotent while live)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()  # before the spawn: see run()'s docstring
        self._thread = threading.Thread(
            target=self.run, kwargs={"max_polls": max_polls},
            name="fsm-poll-consumer", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Signal the loop to end; joins the thread when one is running.

        A worker that outruns the join deadline (a sink wedged in a
        device call, a fetch stuck in a socket) is counted and logged as
        a LEAKED thread — the zombie keeps its broker connection and
        must show up in ``/admin/health``, not vanish silently."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(join_timeout_s)
            # count each wedged worker ONCE: a second stop() on the same
            # still-alive thread must not inflate the zombie count
            if t.is_alive() and t is not self._leak_counted:
                self._leak_counted = t
                self.stats["leaked_threads"] += 1
                _count_leak()
                log_event("consumer_thread_leaked", thread=t.name,
                          join_timeout_s=join_timeout_s)
