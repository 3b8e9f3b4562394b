"""Port parity for the prediction plane's engine-facing half
(``spark_fsm_tpu_torch/service/predictor.py`` against
``spark_fsm_tpu/service/predictor.py``), on the CPU.

Both packages' ``ArtifactCache`` take the same request sequence: hits,
misses, builds, evictions, the half-budget refusal and the resident
snapshot agree.  Both packages' ``PredictBroker`` take the same
submissions: a full window fuses into one wave whose rows equal solo
scoring, a ``high`` joiner makes the group due, a disabled window gives
solo launches, and the module ``_stats`` move key for key.
``predict_rules`` answers as the reference's trie and ``predict_host``
do, at the service's ``depth_need``.
"""

import json
import random
import threading
import time

import pytest

from spark_fsm_tpu import config as cfgmod
from spark_fsm_tpu.ops import rule_trie as R
from spark_fsm_tpu.service import predictor as RP
from spark_fsm_tpu_torch.ops import rule_trie as T
from spark_fsm_tpu_torch.service import model as TM
from spark_fsm_tpu_torch.service import predictor as TP

from tests.test_torch_rule_trie import random_rules


def _json(x):
    return json.dumps(x, sort_keys=True)


@pytest.fixture(autouse=True)
def _defaults():
    """The port's predictor at the ``[predict]`` defaults around each
    test (its config, caches and tallies are process-wide)."""
    TP.configure({})
    yield
    TP.configure({})


@pytest.fixture
def window(monkeypatch):
    """Set the broker's window knobs in both packages' module config."""
    def set_(**kw):
        for mod in (RP, TP):
            for k, v in kw.items():
                monkeypatch.setitem(mod._cfg, k, v)
    return set_


def _port_build(rules, **kw):
    return T.build_trie(rules, device="cpu", **kw)


# ---------------------------------------------------------- artifact cache


def _ref_counts():
    return {"hits": RP._HITS.total(), "misses": RP._MISSES.total(),
            "builds": RP._BUILDS.total(), "evictions": RP._EVICTS.total()}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _snapshot(cache):
    snap = cache.snapshot()
    for r in snap["resident"]:
        r.pop("age_s")
    return snap


SETS = [random_rules(random.Random(s), n, 10) for s, n in
        ((1, 10), (2, 25), (3, 40))]


@pytest.mark.parametrize("max_entries,max_bytes,requests", [
    # LRU by entry cap: the fourth distinct key evicts the least recent
    (3, 1 << 30, [(0, 8), (1, 8), (0, 8), (2, 8), (0, 16), (1, 8), (0, 8)]),
    # byte budget: three F=1024 D=16 artifacts (~84 KiB each) in 200 KiB
    (8, 200 << 10, [(0, 16), (1, 16), (2, 16), (0, 16), (1, 16), (2, 16)]),
    # half-budget refusal: an artifact over half the budget is served but
    # never cached, so it misses every time
    (8, 100 << 10, [(0, 16), (0, 16), (1, 8), (1, 8)]),
])
def test_cache_hits_misses_evictions_equal_reference(max_entries, max_bytes,
                                                     requests):
    ref = RP.ArtifactCache(max_entries, max_bytes)
    port = TP.ArtifactCache(max_entries, max_bytes, device="cpu")
    r0, p0 = _ref_counts(), TP.tallies()
    for i, (s, depth) in enumerate(requests):
        payload = TM.serialize_rules(SETS[s])
        digest = R.rules_digest(payload)
        r_before, p_before = _ref_counts(), TP.tallies()
        a = ref.get_or_build(digest, depth, lambda: SETS[s], 1024)
        b = port.get_or_build(digest, depth, lambda: SETS[s], 1024)
        assert b.nbytes() == a.nbytes() and (b.F, b.D) == (a.F, a.D)
        step = _delta(TP.tallies(), p_before)
        step.pop("stale")
        assert step == _delta(_ref_counts(), r_before), (i, s, depth)
        assert _snapshot(port) == _snapshot(ref), i
    total = _delta(TP.tallies(), p0)
    assert total.pop("stale") == 0
    assert total == _delta(_ref_counts(), r0)
    assert total["misses"] == total["builds"] > 0


# ------------------------------------------------------------------ broker


def _submit_threads(broker, trie, prefixes, m, priority="normal"):
    tickets = [None] * len(prefixes)

    def go(i):
        tickets[i] = broker.submit(trie, prefixes[i], m, priority, tag=str(i))

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prefixes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return tickets


def _stats_delta(mod, before):
    with mod._stats_lock:
        now = dict(mod._stats)
    assert set(now) == set(before)
    return {k: now[k] - before[k] for k in now if k != "exec_s"}


def _stats_now(mod):
    with mod._stats_lock:
        return dict(mod._stats)


_RULES = random_rules(random.Random(7), 40, 10)
_PREFIXES = [sorted(random.Random(i).sample(range(10), i % 5))
             for i in range(8)]


def _tries():
    return (R.build_trie(_RULES, depth_floor=8),
            _port_build(_RULES, depth_floor=8))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_full_window_fuses_into_one_wave_equal_to_solo(window, n):
    window(window_ms=60_000.0, max_wave=n)
    ref_t, port_t = _tries()
    prefixes = _PREFIXES[:n]
    out = {}
    for mod, trie in ((RP, ref_t), (TP, port_t)):
        broker = mod.PredictBroker()
        before = _stats_now(mod)
        tickets = _submit_threads(broker, trie, prefixes, 5)
        broker.shutdown()
        assert [t.wave_jobs for t in tickets] == [n] * n
        assert _stats_delta(mod, before) == {
            "requests": 0, "served": 0, "failures": 0, "waves": 1,
            "fused_waves": 1, "fused_jobs": n, "solo_jobs": 0,
            "stale_rebuilds": 0}
        out[mod] = [t.entries for t in tickets]
    for i, p in enumerate(prefixes):
        solo = T.score_wave(port_t, [p], 5)[0]
        assert _json(out[TP][i]) == _json(out[RP][i]) == _json(solo) \
            == _json(T.predict_host(_RULES, p, 5)), i


def _wait_parked(broker, n):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with broker._lock:
            if sum(len(g.tickets) for g in broker._groups.values()) == n:
                return
        time.sleep(0.001)
    raise AssertionError(f"{n} tickets never parked")


def test_high_priority_makes_the_group_due(window):
    window(window_ms=60_000.0, max_wave=16)
    out = {}
    for mod, trie in zip((RP, TP), _tries()):
        broker = mod.PredictBroker()
        before = _stats_now(mod)
        parked = [None, None]

        def go(i):
            parked[i] = broker.submit(trie, _PREFIXES[i], 4, "normal",
                                      tag=str(i))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        _wait_parked(broker, 2)
        t0 = time.monotonic()
        high = broker.submit(trie, _PREFIXES[2], 4, "high", tag="h")
        assert time.monotonic() - t0 < 30   # not the 60 s window
        for t in threads:
            t.join(30)
        broker.shutdown()
        assert high.wave_jobs == 3 and [t.wave_jobs for t in parked] == [3, 3]
        assert _stats_delta(mod, before)["fused_jobs"] == 3
        out[mod] = [parked[0].entries, parked[1].entries, high.entries]
    assert _json(out[TP]) == _json(out[RP])


@pytest.mark.parametrize("knob", [{"window_ms": 0.0}, {"max_wave": 1},
                                  {"enabled": False}])
def test_disabled_window_gives_solo_launches(window, knob):
    window(window_ms=2.0, max_wave=16)
    window(**knob)
    out = {}
    for mod, trie in zip((RP, TP), _tries()):
        broker = mod.PredictBroker()
        before = _stats_now(mod)
        tickets = _submit_threads(broker, trie, _PREFIXES[:4], 3)
        assert broker._thread is None         # no window, no scheduler
        assert [t.wave_jobs for t in tickets] == [1] * 4
        assert _stats_delta(mod, before) == {
            "requests": 0, "served": 0, "failures": 0, "waves": 4,
            "fused_waves": 0, "fused_jobs": 0, "solo_jobs": 4,
            "stale_rebuilds": 0}
        out[mod] = [t.entries for t in tickets]
    assert _json(out[TP]) == _json(out[RP])


def test_stats_move_key_for_key_with_the_reference(window):
    """One request sequence through both packages: solo, a fused wave of
    three by a full window, a high joiner, a window that expires."""
    out = {}
    for mod, trie in zip((RP, TP), _tries()):
        broker = mod.PredictBroker()
        before = _stats_now(mod)
        window(window_ms=0.0, max_wave=16)
        broker.submit(trie, _PREFIXES[0], 4, "normal", tag="solo")
        window(window_ms=60_000.0, max_wave=3)
        _submit_threads(broker, trie, _PREFIXES[1:4], 4)
        broker.submit(trie, _PREFIXES[4], 4, "high", tag="high")
        window(window_ms=5.0, max_wave=16)
        late = broker.submit(trie, _PREFIXES[5], 4, "low", tag="late")
        broker.shutdown()
        assert late.wave_jobs == 1 and late.dispatch_t >= late.submit_t
        out[mod] = _stats_delta(mod, before)
        assert _stats_now(mod)["exec_s"] > before["exec_s"]
    assert out[TP] == out[RP] == {
        "requests": 0, "served": 0, "failures": 0, "waves": 4,
        "fused_waves": 1, "fused_jobs": 3, "solo_jobs": 3,
        "stale_rebuilds": 0}


def test_wave_error_reaches_every_rider(window):
    window(window_ms=60_000.0, max_wave=2)
    trie = _port_build([((1,), (2,), 3, 4)], depth_floor=4)
    broker = TP.PredictBroker()
    errors = []

    def go(p):
        try:
            broker.submit(trie, p, 2, "normal", tag="x")
        except ValueError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=go, args=(p,))
               for p in ([1], [1, 2, 3, 4, 5])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    broker.shutdown()
    assert len(errors) == 2 and all("exceeds trie depth" in e for e in errors)


# ------------------------------------------------------------ the seam


def test_configure_takes_an_object_or_a_dict():
    TP.configure(cfgmod.PredictConfig())
    want = dict(TP._cfg)
    assert want == {"enabled": True, "window_ms": 2.0, "max_wave": 16,
                    "topm": 8, "lanes_floor": 1024, "depth_floor": 16,
                    "cache_entries": 8, "cache_bytes": 256 << 20}
    TP.configure({"window_ms": 0.5, "artifact_entries": 2})
    assert TP._cfg == dict(want, window_ms=0.5, cache_entries=2)
    cache = TP._cache("cpu")
    assert (cache.max_entries, cache.max_bytes) == (2, 256 << 20)
    TP.configure(cfgmod.PredictConfig(max_wave=4, artifact_bytes=1 << 20))
    assert TP._cache("cpu") is not cache
    assert TP._cfg == dict(want, max_wave=4, cache_bytes=1 << 20)


@pytest.mark.parametrize("kind", ["rules", "patterns"])
def test_predict_rules_equals_reference_at_depth_need(window, kind):
    window(window_ms=0.0)
    if kind == "rules":
        rules = _RULES
        payload = TM.serialize_rules(rules)
    else:
        pats = [(((1,),), 9), (((1,), (2,)), 6), (((1,), (3,)), 4),
                (((1,), (2, 3)), 3), (((2,),), 8), (((2,), (5,)), 4)]
        rules = R.rules_from_patterns(pats)
        payload = TM.serialize_patterns(pats)
    t0 = TP.tallies()
    for items in ([], [1], [3, 1, 1], [2, 5], list(range(40, 57))):
        prefix = sorted(set(items))
        depth = max(16, R._next_pow2(max(1, len(prefix))))
        ref = R.build_trie(rules, lanes_floor=1024, depth_floor=depth)
        want = R.score_wave(ref, [prefix], 8)[0]
        got = TP.predict_rules(payload, kind, items, 8, device="cpu",
                               source="uid:a")
        assert _json(got) == _json(want) == _json(
            T.predict_host(rules, prefix, 8)), items
    # depth 16 built once and hit three times; the 17-item prefix builds 32
    t = TP.tallies()
    assert (t["misses"] - t0["misses"], t["hits"] - t0["hits"]) == (2, 3)
    resident = TP._cache("cpu").snapshot()["resident"]
    assert sorted(r["depth"] for r in resident) == [16, 32]
    assert all(r["F"] == 1024 for r in resident)


def test_predict_rules_counts_stale_rebuilds_and_failures(window):
    window(window_ms=0.0)
    s0, t0 = _stats_now(TP), TP.tallies()
    a = TM.serialize_rules([((1,), (2,), 3, 4)])
    b = TM.serialize_rules([((1,), (3,), 3, 4)])
    assert TP.predict_rules(a, "rules", [1], 4, device="cpu",
                            source="uid:s")[0]["item"] == 2
    assert TP.predict_rules(a, "rules", [1], 4, device="cpu",
                            source="uid:s")[0]["item"] == 2
    assert TP.predict_rules(b, "rules", [1], 4, device="cpu",
                            source="uid:s")[0]["item"] == 3
    with pytest.raises(ValueError, match="unknown priority"):
        TP.predict_rules(a, "rules", [1], 4, priority="urgent", device="cpu")
    s = _stats_now(TP)
    assert TP.tallies()["stale"] - t0["stale"] == 1
    assert {k: s[k] - s0[k] for k in ("requests", "served", "failures",
                                      "stale_rebuilds", "solo_jobs")} == {
        "requests": 4, "served": 3, "failures": 1, "stale_rebuilds": 1,
        "solo_jobs": 3}
