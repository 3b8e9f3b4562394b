"""Dispatch watchdog: bound a blocking device readback with a deadline.

A hung XLA dispatch (runtime wedge, tunnel drop, collective deadlock)
used to block a Miner worker FOREVER — the job never reached a failure
status and the worker was lost to the pool.  The watchdog runs the
blocking readback on a helper thread and waits at most a deadline
derived from the ragged planner's own cost model (the KERNELS.json-
anchored lane-time estimate in ops/ragged_batch.estimate_seconds, times
a configurable slack): past it, the launch FAILS with
:class:`WatchdogTimeout` — the engines' existing fault handling turns
that into a jnp downgrade or a supervised job retry — instead of
hanging.  The abandoned reader thread is daemon and counted
(``leaked_threads``, surfaced by ``/admin/health``): Python cannot kill
a thread stuck in a C extension, so leaking-loudly is the honest
contract (the same one Miner.shutdown uses for overrunning jobs).

Disabled by default (``slack = None``): the happy path stays a direct
call with zero thread overhead.  Enable via the boot config
(``[engine] watchdog_slack``) or :func:`configure`.  The estimate is
anchored on TPU kernel walls — on slower backends pick a generous slack
(the CPU test backend runs orders of magnitude off the anchor, which is
why the default is off rather than a guessed floor).

Port: a copy of ``spark_fsm_tpu/utils/watchdog.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.obs import log_event


class WatchdogTimeout(TimeoutError):
    """A guarded dispatch/readback outran its deadline."""


_lock = threading.Lock()
_cfg = {"slack": None, "floor_s": 2.0}
_stats = {"guarded": 0, "timeouts": 0, "leaked_threads": 0}


def _collect_metrics():
    """Canonical fsm_watchdog_* names for the unified registry — the
    /admin/health ``watchdog`` block keys are aliases of these
    (docs/OPERATIONS.md tables the mapping)."""
    with _lock:
        st = dict(_stats)
        slack = _cfg["slack"]
    fams = [(f"fsm_watchdog_{k}_total", "counter", "", [({}, v)])
            for k, v in st.items()]
    fams.append(("fsm_watchdog_slack", "gauge",
                 "configured deadline slack (0 = watchdog disabled)",
                 [({}, 0.0 if slack is None else slack)]))
    return fams


obs.REGISTRY.register_collector("watchdog", _collect_metrics)


def configure(slack: Optional[float] = None, floor_s: float = 2.0) -> None:
    """Set the process-wide watchdog policy.  ``slack`` multiplies the
    cost-model estimate (None disables the watchdog entirely);
    ``floor_s`` is the minimum deadline, so tiny estimates (small-S
    mines, where one OS scheduling hiccup exceeds the modeled wall)
    don't produce hair-trigger timeouts."""
    with _lock:
        _cfg["slack"] = None if slack is None else float(slack)
        _cfg["floor_s"] = float(floor_s)


def configured_slack() -> Optional[float]:
    with _lock:
        return _cfg["slack"]


def deadline_s(estimate_s: float) -> Optional[float]:
    """Deadline for a dispatch whose cost model predicts ``estimate_s``
    of device time; None when the watchdog is disabled."""
    with _lock:
        slack = _cfg["slack"]
        if slack is None:
            return None
        return max(_cfg["floor_s"], float(estimate_s) * slack)


def stats() -> dict:
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = 0


def run_with_deadline(fn: Callable, deadline: Optional[float],
                      site: str = "device.dispatch"):
    """Run ``fn()`` bounded by ``deadline`` seconds (None = direct call,
    no thread).  On timeout the reader thread is abandoned (daemon,
    counted) and :class:`WatchdogTimeout` raises in the caller."""
    if deadline is None:
        return fn()
    with _lock:
        _stats["guarded"] += 1
    box: list = []

    def worker():
        try:
            box.append((True, fn()))
        except BaseException as exc:  # noqa: BLE001 - relayed to caller
            box.append((False, exc))

    t = threading.Thread(target=worker, name=f"fsm-watchdog-{site}",
                         daemon=True)
    t.start()
    t.join(deadline)
    if t.is_alive():
        with _lock:
            _stats["timeouts"] += 1
            _stats["leaked_threads"] += 1
        log_event("watchdog_timeout", site=site, deadline_s=deadline)
        obs.trace_event("watchdog_timeout", site=site,
                        deadline_s=round(deadline, 4))
        raise WatchdogTimeout(
            f"dispatch at {site!r} outran its {deadline:.3f}s watchdog "
            f"deadline (reader thread abandoned)")
    ok, value = box[0]
    if not ok:
        raise value
    return value
