"""The traced window (``--trace 1``): ``torch.profiler`` over the window,
read into the device's activity and the host's operations.

The device is busy where any kernel, copy or set runs: the union of those
intervals (``records.union_seconds``), not a sum of per-op times, which
counts overlapping streams twice.  An idle gap is named by what the host
was doing at its middle: the innermost profiled host operation open there,
else the benchmark's own span (a wrapper's), else ``host``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from fsmbench.records import DeviceEvent, Records, gaps

TOP = 10
# host operations searched back from a gap's middle for one that covers it
_LOOKBACK = 32


class Tracer:
    """``torch.profiler`` over the window; ``events()`` after ``stop()``."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def events(self) -> Tuple[List[DeviceEvent], List[DeviceEvent]]:
        """(device events, host operations), each with epoch-ns bounds."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if end > start:
                    dev.append(DeviceEvent(e.name(), start, end))
            elif e.device_type() == DeviceType.CPU:
                host.append(DeviceEvent(e.name(), start, end))
        return dev, host


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def device_ops(rec: Records) -> List[list]:
    """The device operations that took most time in the window:
    ``[name, seconds]``, summed over launches of one name."""
    lo, hi = rec.window_ns
    tot: Dict[str, int] = {}
    for e in rec.device_events or ():
        d = min(e.end_ns, hi) - max(e.start_ns, lo)
        if d > 0:
            tot[e.name] = tot.get(e.name, 0) + d
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
    return [[_short(n), ns / 1e9] for n, ns in top]


def idle_gaps(rec: Records, host: List[DeviceEvent],
              host_spans: List[Tuple[str, int, int]]) -> List[list]:
    """The device's idle time in the window by what the host was doing:
    ``[name, seconds]`` summed over the gaps of one name, largest first."""
    lo, hi = rec.window_ns
    host = sorted(host, key=lambda e: e.start_ns)
    starts = [e.start_ns for e in host]
    spans = sorted(host_spans, key=lambda s: s[1])
    span_starts = [s[1] for s in spans]
    tot: Dict[str, int] = {}
    for g0, g1 in gaps(rec.device_intervals(), lo, hi):
        mid = (g0 + g1) // 2
        name = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - _LOOKBACK), -1):
            if host[j].end_ns >= mid:
                name = host[j].name
                break
        if name is None:
            k = bisect.bisect_right(span_starts, mid) - 1
            if k >= 0 and spans[k][2] >= mid:
                name = spans[k][0]
        name = name or "host"
        tot[name] = tot.get(name, 0) + (g1 - g0)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
    return [[_short(n), ns / 1e9] for n, ns in top]


def breakdown(rec: Records, host: List[DeviceEvent],
              host_spans: List[Tuple[str, int, int]]) -> Optional[dict]:
    if not rec.device_events:
        return None
    return {"device_ops": device_ops(rec),
            "idle_gaps": idle_gaps(rec, host, host_spans)}
