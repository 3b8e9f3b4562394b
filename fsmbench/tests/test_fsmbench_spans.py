"""The readers of the program's own spans (``fsmbench/spans.py``):
``engine_host_ms``, ``engine_wait_ms`` and ``engine_build_ms`` on records
made by hand, and their one shared sink on the port's flight recorder."""

import pytest

from fsmbench.harness import Bench
from fsmbench.records import Mine, Records

READ = Bench().module


def _rec(walls):
    rec = Records()
    rec.window_s = sum(walls)
    rec.mines = [Mine(w, {}) for w in walls]
    return rec


def test_engine_span_readers():
    rec = _rec([1.0, 1.0])
    for name in ("engine_host_ms", "engine_wait_ms", "engine_build_ms"):
        assert READ("metrics", name).read(rec) is None
    rec.on = True
    for site, seconds in (("spade.roots", 0.001), ("spade.candidates", 0.01),
                          ("spade.prune", 0.02), ("cspade.prune", 0.004),
                          ("mine.sort", 0.005), ("spade.wait", 0.1),
                          ("cspade.wait", 0.2), ("cspade.engine", 0.03),
                          ("spade.dispatch", 9.0), ("cspade.pool", 7.0)):
        rec.span(site, 0.0, seconds)
    rec.span("spade.prune", 5.0, 0.02)
    assert READ("metrics", "engine_host_ms").read(rec) == pytest.approx(
        (0.001 + 0.01 + 0.04 + 0.004 + 0.005) * 1e3 / 2)
    assert READ("metrics", "engine_wait_ms").read(rec) == pytest.approx(
        150.0)
    assert READ("metrics", "engine_build_ms").read(rec) == pytest.approx(
        15.0)


def test_program_spans_recorded_once_by_three_readers():
    """The three span readers share one sink: a span lands once, only in
    the window, on the records' clock; the last undo removes the sink
    and restores the tracing setting."""
    import time

    from spark_fsm_tpu_torch.utils import obs

    def mine_step():
        with obs.mine_trace("mine.spade"):
            with obs.span("mine.sort"):
                pass

    was = obs.tracing_enabled()
    rec = Records()
    undo = [READ("metrics", name).install(rec)
            for name in ("engine_host_ms", "engine_wait_ms",
                         "engine_build_ms")]
    try:
        assert obs.tracing_enabled()
        mine_step()                      # before the window: not kept
        rec.on = True
        t0 = time.perf_counter()
        mine_step()
        t1 = time.perf_counter()
        rec.on = False
        mine_step()                      # after it: not kept
        assert len(rec.spans["mine.sort"]) == 1
        assert len(rec.spans["mine.spade"]) == 1
        start, seconds = rec.spans["mine.sort"][0]
        assert t0 <= start and start + seconds <= t1
        undo.pop()()
        undo.pop()()
        rec.on = True
        mine_step()                      # one reader still installed
        assert len(rec.spans["mine.sort"]) == 2
        undo.pop()()
        assert obs.tracing_enabled() is was
        mine_step()
        assert len(rec.spans["mine.sort"]) == 2
    finally:
        for u in reversed(undo):
            u()
        obs.configure_tracing(was)
        obs.clear_traces()
