"""The program's own spans in the window's records.

The port's flight recorder (``spark_fsm_tpu_torch/utils/obs.py``) records
a span at each phase of a mine once tracing is on; a library mine opens
a trace of its own.  :func:`install` turns tracing on and adds one span
sink that copies every finished span into ``rec.spans`` under its site,
on the host clock the records keep (``time.perf_counter``).  Readers share
it: however many install it on one record, each span lands once, and the
sink goes (and the tracing setting returns to what it was) with the last
reader's undo.  ``Records.span`` keeps spans only while the window is on.

A program without these spans (an older commit) records none here, and
the readers that read them return ``None``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional


def install(rec) -> Callable[[], None]:
    """Copy the program's spans into ``rec`` (see the module docstring);
    returns this reader's undo."""
    state = getattr(rec, "program_spans", None)
    if state is None:
        from spark_fsm_tpu_torch.utils import obs

        was = obs.tracing_enabled()
        # the spans' clock (time.monotonic) onto the records'
        offset = time.perf_counter() - time.monotonic()

        def sink(span):
            if span.t1 is not None:
                rec.span(span.site, span.t0 + offset, span.t1 - span.t0)

        def remove():
            obs.remove_span_sink(sink)
            obs.configure_tracing(was)

        obs.configure_tracing(True)
        obs.add_span_sink(sink)
        state = rec.program_spans = {"readers": 0, "remove": remove}
    state["readers"] += 1

    def undo():
        state["readers"] -= 1
        if state["readers"] == 0:
            del rec.program_spans
            state["remove"]()

    return undo


def ms_per_mine(rec, sites: Iterable[str]) -> Optional[float]:
    """The summed wall of the spans at ``sites`` a mine, in ms; ``None``
    where the window recorded none of them."""
    found = [d for s in sites for _, d in rec.spans.get(s, ())]
    if not found:
        return None
    return rec.per_mine(sum(found) * 1e3)
