"""What a run records for its metric readers, and the arithmetic they share.

:class:`Records` holds, for the measured window: each mine's wall and the
statistics the entry reported (``mines``), the host-clock spans and kernel
launches that the readers' wrappers took (``spans``, ``launches``), the
device's activity from the profiler (``device_events``, only with
``--trace 1`` on a card), the set-up time and the device's memory peak.
A reader (``metrics/<name>.py``) reads these and returns one number, or
``None`` when there is nothing to read in this cell.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

# Card peaks for B1's bound, frozen from chip_smoke.py (lines 420-431 at
# commit af584b40603189c27f03b8d906643a82cdb45648; H100 SXM data sheet):
# 3.35 TB/s of device memory, and 32-bit integer work at 128 lanes per SM
# per clock, half of the 67 TFLOP/s fp32 rate (which counts two operations
# per fused multiply-add).  128 lanes is the most any mix can dispatch:
# logic ops run on 64 of them and adds on the others.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2


def pair_bound_ms(P: int, NI: int, S: int, W: int,
                  n_live: Optional[int] = None) -> Tuple[float, str]:
    """Least time for one pair-support launch (kernel B1), a frozen copy of
    ``chip_smoke.py:pair_bound_ms`` at commit
    af584b40603189c27f03b8d906643a82cdb45648: each parent row and each
    live item row read once and the [P, NI] output written once, against
    the fewest integer operations the function needs per live pair and
    sequence: one three-input logic op per word and one predicated add,
    W + 1 in all.  ``n_live`` (default NI) is how many leading item rows
    can be nonzero.  Returns the bound in ms and which of the two sets it."""
    n_live = NI if n_live is None else n_live
    nbytes = (P + n_live) * S * W * 4 + P * NI * 4
    ops = P * n_live * S * (W + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def union_seconds(intervals: List[Tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of [lo, hi] (ns) covered by the union of ``intervals`` (ns):
    overlapping activity on several streams counts once."""
    busy = 0
    end = lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e9


def gaps(intervals: List[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi] (ns) that no interval covers."""
    out = []
    end = lo
    for s, e in sorted(intervals):
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


@dataclasses.dataclass
class Mine:
    wall_s: float
    stats: dict


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


class Records:
    """The window's records; wrappers add to them only while ``on``."""

    def __init__(self):
        self.on = False
        self.setup_s: float = 0.0
        self.window_s: float = 0.0
        self.window_ns: Tuple[int, int] = (0, 0)
        self.mines: List[Mine] = []
        # name -> [(perf_counter at the start, seconds)]
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        # one instant on both clocks: (perf_counter, epoch ns)
        self.clock0: Tuple[float, int] = (0.0, 0)
        self.launches: Dict[str, List[tuple]] = {}
        self.device_events: Optional[List[DeviceEvent]] = None
        self.memory_peak_bytes: Optional[int] = None

    def span(self, name: str, t0: float, seconds: float) -> None:
        if self.on:
            self.spans.setdefault(name, []).append((t0, seconds))

    def epoch_spans(self) -> List[Tuple[str, int, int]]:
        """Every span as ``(name, start ns, end ns)`` on the epoch clock
        the profiler's events carry."""
        p0, n0 = self.clock0
        return [(name, n0 + int((t - p0) * 1e9),
                 n0 + int((t + d - p0) * 1e9))
                for name, ss in self.spans.items() for t, d in ss]

    def launch(self, name: str, shape: tuple) -> None:
        if self.on:
            self.launches.setdefault(name, []).append(shape)

    def wrap(self, module, attr: str, span: str) -> Callable[[], None]:
        """Replace ``module.attr`` by a wrapper that times each call under
        ``span``; returns the undo."""
        orig = getattr(module, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.span(span, t0, time.perf_counter() - t0)

        setattr(module, attr, timed)
        return lambda: setattr(module, attr, orig)

    def per_mine(self, total: float) -> Optional[float]:
        return total / len(self.mines) if self.mines else None

    def stat_per_mine(self, key: str) -> Optional[float]:
        """The mean of a statistic the entry reports, over the window's
        mines; ``None`` where no mine reports it."""
        vals = [m.stats[key] for m in self.mines if key in m.stats]
        if not vals or len(vals) != len(self.mines):
            return None
        return sum(vals) / len(vals)

    def span_ms_per_mine(self, name: str) -> Optional[float]:
        if name not in self.spans:
            return None
        return self.per_mine(sum(d for _, d in self.spans[name]) * 1e3)

    def device_intervals(self, match: str = "") -> List[Tuple[int, int]]:
        return [(e.start_ns, e.end_ns) for e in self.device_events or ()
                if match in e.name]

    def device_busy_s(self) -> Optional[float]:
        if not self.device_events:
            return None
        return union_seconds(self.device_intervals(), *self.window_ns)
