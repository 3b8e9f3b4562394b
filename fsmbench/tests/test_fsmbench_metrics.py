"""The metric arithmetic: B1's bound from shapes, the device's idle share
as a union of overlapping intervals, and the readers on records made by
hand."""

import pytest

from fsmbench.harness import Bench
from fsmbench.records import (DeviceEvent, Mine, Records, gaps, pair_bound_ms,
                              union_seconds)

READ = Bench().module


def test_pair_bound_ms_from_shapes():
    # the queue route's wide and late waves over BMS's 360 live items of
    # 384 rows (chip_smoke.py's WIDE_WAVE and LATE_WAVE): operations bound
    wide = pair_bound_ms(1024, 384, 77504, 1, 360)
    late = pair_bound_ms(128, 384, 77504, 1, 360)
    assert wide[1] == late[1] == "operations"
    assert wide[0] == pytest.approx(1024 * 360 * 77504 * 2 / 33.5e12 * 1e3)
    assert round(wide[0], 4) == 1.7057 and round(late[0], 4) == 0.2132
    # one parent row over few live items: the bytes bound
    t, which = pair_bound_ms(2, 64, 100000, 3, 1)
    assert which == "bytes"
    assert t == pytest.approx(((2 + 1) * 100000 * 3 * 4 + 2 * 64 * 4)
                              / 3.35e12 * 1e3)
    # n_live defaults to every item row
    assert pair_bound_ms(8, 16, 64, 1) == pair_bound_ms(8, 16, 64, 1, 16)


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25)]
    assert union_seconds(iv, 0, 40) == pytest.approx(25e-9)
    # a sum of per-op times would read 33 ns here
    assert sum(e - s for s, e in iv) == 33
    assert union_seconds([(-5, 5), (8, 50)], 0, 10) == pytest.approx(7e-9)
    assert union_seconds([], 0, 10) == 0.0


def test_gaps_are_the_uncovered_parts():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert gaps([(0, 10)], 0, 10) == []


def _rec(walls, stats=None):
    rec = Records()
    rec.window_s = sum(walls)
    rec.mines = [Mine(w, dict(stats or {})) for w in walls]
    return rec


def test_mine_s_is_window_over_mines():
    rec = _rec([0.1, 0.3])
    rec.window_s = 0.5                          # the loop's own time counts
    assert READ("metrics", "mine_s").read(rec) == 0.25


def test_idle_share_reader():
    rec = _rec([1.0])
    rec.window_ns = (0, 1_000_000_000)
    rec.device_events = [DeviceEvent("a", 0, 300_000_000),
                         DeviceEvent("b", 100_000_000, 400_000_000),
                         DeviceEvent("c", 900_000_000, 1_200_000_000)]
    assert READ("metrics", "device_idle_share").read(rec) == pytest.approx(50.0)
    rec.device_events = []
    assert READ("metrics", "device_idle_share").read(rec) is None


def test_b1_roofline_reader():
    rec = _rec([1.0])
    shape = (1024, 384, 77504, 1, 360)
    rec.launches = {"b1": [shape, shape]}
    bound_ns = pair_bound_ms(*shape)[0] * 1e6
    k = "void (anonymous namespace)::pair_support_kernel<Tile<8> >(int*)"
    rec.device_events = [DeviceEvent(k, 0, int(bound_ns / 0.7)),
                         DeviceEvent(k, 10**9, 10**9 + int(bound_ns / 0.7)),
                         DeviceEvent("other_kernel", 0, 10**8)]
    assert READ("metrics", "b1_roofline").read(rec) == pytest.approx(70.0,
                                                                    rel=1e-6)
    rec.launches = {"b1": [shape]}             # a launch the wrapper missed
    assert READ("metrics", "b1_roofline").read(rec) is None
    rec.launches = {}
    assert READ("metrics", "b1_roofline").read(rec) is None


def test_counter_readers():
    rec = _rec([0.1, 0.1], {"kernel_launches": 40})
    assert READ("metrics", "spade_launches").read(rec) == 40
    assert READ("metrics", "cspade_launches").read(rec) == 40
    assert READ("metrics", "fingerprint_ms").read(rec) is None
    rec.on = True
    rec.span("db_fingerprint", 0.0, 0.04)
    rec.span("db_fingerprint", 1.0, 0.02)
    assert READ("metrics", "fingerprint_ms").read(rec) == pytest.approx(30.0)


def test_wrappers_record_only_in_the_window():
    import types

    mod = types.SimpleNamespace(f=lambda x: x + 1)
    rec = Records()
    undo = rec.wrap(mod, "f", "f")
    assert mod.f(1) == 2 and rec.spans == {}
    rec.on = True
    assert mod.f(2) == 3 and len(rec.spans["f"]) == 1
    undo()
    assert mod.f(3) == 4 and len(rec.spans["f"]) == 1
