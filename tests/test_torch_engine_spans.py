"""The engine-phase spans of the port's SPADE, cSPADE and engine-cache
paths (``spark_fsm_tpu_torch/utils/obs.py`` and its sites), on the CPU.

A library mine with tracing on opens one trace of its own and records a
span at each phase: per batch the dispatch (slots, prep, candidates,
supports, B1's launch) and the resolve (wait, prune, materialize); per
mine the roots and the sort; the vertical build, the store build, the
cSPADE engine's construction and pool fill; the engine cache's
fingerprint, checkout and build.  The census holds the sites, their
nesting and the launch accounting to ``kernel_launches``; tracing moves
no result and no counter; with tracing off no span is made and no
profiler range entered; with it on every span is a ``torch.profiler``
range of its own.
"""

import collections

import pytest

from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.models import spade_fused, spade_queue
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
from spark_fsm_tpu_torch.service.devcache import SpadeEngineCache
from spark_fsm_tpu_torch.utils import obs
from spark_fsm_tpu_torch.utils.canonical import patterns_text

# each site's parent site in a library mine's trace
SPADE_TREE = {
    "mine.spade": None, "vertical.build": "mine.spade",
    "store.build": "mine.spade", "spade.mine": "mine.spade",
    "spade.roots": "spade.mine", "spade.dispatch": "spade.mine",
    "spade.slots": "spade.dispatch", "spade.prep": "spade.dispatch",
    "spade.candidates": "spade.dispatch",
    "spade.supports": "spade.dispatch", "b1.launch": "spade.supports",
    "spade.resolve": "spade.mine", "spade.wait": "spade.resolve",
    "spade.prune": "spade.resolve", "spade.materialize": "spade.resolve",
    "mine.sort": "spade.mine",
}
CSPADE_TREE = {
    "mine.cspade": None, "vertical.build": "mine.cspade",
    "cspade.engine": "mine.cspade", "store.build": "cspade.engine",
    "cspade.pool": "cspade.engine", "cspade.mine": "mine.cspade",
    "cspade.roots": "cspade.mine", "cspade.dispatch": "cspade.mine",
    "cspade.slots": "cspade.dispatch", "cspade.prep": "cspade.dispatch",
    "cspade.candidates": "cspade.dispatch",
    "cspade.supports": "cspade.dispatch", "b1.launch": "cspade.supports",
    "cspade.resolve": "cspade.mine", "cspade.wait": "cspade.resolve",
    "cspade.prune": "cspade.resolve",
    "cspade.materialize": "cspade.resolve", "mine.sort": "cspade.mine",
}
# the classic engine's sites under a cache hit: no vertical or store build
CACHED_TREE = {
    "devcache.mine": None, "devcache.fingerprint": "devcache.mine",
    "devcache.checkout": "devcache.mine", "spade.mine": "devcache.mine",
    **{k: v for k, v in SPADE_TREE.items()
       if v not in (None, "mine.spade")},
}
# one of each a batch, in both engines (``spade.*``, ``cspade.*``)
PER_BATCH = ("dispatch", "slots", "prep", "candidates", "supports",
             "resolve", "wait", "prune", "materialize")
# a pool of a few slots and small batches: recompute, reclaim and several
# materialize launches happen on a tiny database
SMALL = dict(node_batch=4, pool_bytes=64 << 10)
CSMALL = dict(node_batch=4, pool_bytes=32 << 10)


@pytest.fixture(autouse=True)
def _tracing_reset():
    was = obs.tracing_enabled()
    obs.clear_traces()
    yield
    obs.configure_tracing(was, max_spans=512, max_jobs=16)
    obs.clear_traces()


@pytest.fixture
def classic_cache(monkeypatch):
    """An engine cache whose ``auto`` route ends on the classic engine, as
    the queue engine's overflow makes it at the published BMS widths."""
    monkeypatch.setattr(spade_queue, "queue_eligible", lambda *a, **k: False)
    monkeypatch.setattr(spade_fused, "fused_eligible", lambda *a, **k: False)
    return SpadeEngineCache()


def _db(seed=7, n=200):
    return synthetic_db(seed=seed, n_sequences=n, n_items=12,
                        mean_itemsets=3.0, mean_itemset_size=1.3)


def _spade(db, stats):
    return mine_spade_torch(db, 3, device="cpu", fused="never",
                            stats_out=stats, **SMALL)


def _cspade(db, stats):
    return mine_cspade_torch(db, 2, maxgap=2, maxwindow=5, device="cpu",
                             stats_out=stats, **CSMALL)


def _traced(run, mines=1):
    """``run(stats)``, which makes ``mines`` library mines, with tracing
    on: (result, stats, the spans of the last mine's trace); one trace a
    mine."""
    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    before = set(obs.trace_ids())
    stats: dict = {}
    res = run(stats)
    assert len(set(obs.trace_ids()) - before) == mines
    dump = obs.trace_dump(obs.last_trace_id())
    assert dump["dropped_spans"] == 0
    return res, stats, dump["spans"]


def _check_tree(spans, tree):
    by_id = {s["span_id"]: s for s in spans}
    sites = collections.Counter(s["site"] for s in spans)
    assert set(sites) == set(tree), sorted(set(sites) ^ set(tree))
    for s in spans:
        parent = by_id.get(s["parent_id"])
        assert (parent and parent["site"]) == (tree[s["site"]] or None), s
        if parent is not None:  # a child lies inside its parent
            assert parent["t_start"] <= s["t_start"]
            assert s["t_end"] <= parent["t_end"]
    return sites


def _launches(spans):
    """The device steps the spans account for: a span's ``launches`` attr
    and one for each ``b1.launch``."""
    return sum(s.get("attrs", {}).get("launches", 0) for s in spans) \
        + sum(1 for s in spans if s["site"] == "b1.launch")


@pytest.mark.parametrize("engine", ["spade", "cspade"])
def test_library_mine_span_census(engine):
    """One trace a library mine, every site in it under its parent, one
    of each per-batch site a batch, and the launch accounting equal to
    the engine's ``kernel_launches``."""
    run, tree = ((_spade, SPADE_TREE) if engine == "spade"
                 else (_cspade, CSPADE_TREE))
    res, stats, spans = _traced(lambda st: run(_db(), st))
    assert res
    sites = _check_tree(spans, tree)
    batches = sites[f"{engine}.dispatch"]
    assert batches > 1
    assert all(sites[f"{engine}.{p}"] == batches for p in PER_BATCH)
    for one in (f"mine.{engine}", f"{engine}.mine", f"{engine}.roots",
                "mine.sort", "vertical.build", "store.build"):
        assert sites[one] == 1, one
    assert stats["recomputed_nodes"] > 0
    # one B1 launch a batch, with its geometry (cSPADE: over each node's
    # two window masks)
    launch = [s["attrs"] for s in spans if s["site"] == "b1.launch"]
    assert len(launch) == batches
    assert all(set(a) == {"point", "P", "NI", "n_live", "S", "W"}
               and a["point"] == "plain" for a in launch)
    assert [a["P"] for a in launch] == [
        2 * s["attrs"]["nodes"] for s in spans
        if s["site"] == f"{engine}.dispatch"]
    if engine == "spade":
        assert _launches(spans) == stats["kernel_launches"]
    else:
        # the supports' ``launches`` count the reference's dispatches, and
        # B1 runs beside them; the kernels' own counters stay at 0 here
        assert _launches(spans) == stats["kernel_launches"] + batches
        sup = [s["attrs"] for s in spans if s["site"] == "cspade.supports"]
        assert all(a["masks"] == a["b1"] == 0 for a in sup)


def test_cached_repeat_mine_span_census(classic_cache):
    """A repeat mine through the engine cache on its classic engine:
    fingerprint, a checkout that hits, the search, no build; the first
    mine's checkout misses and builds."""
    db = _db()
    _, first, cold = _traced(lambda st: classic_cache.mine(
        db, 3, device="cpu", stats_out=st))
    res, again, spans = _traced(lambda st: classic_cache.mine(
        db, 3, device="cpu", stats_out=st))
    assert first["store_cache_hit"] is False and again["fused"] is False
    assert again["store_cache_hit"] is True
    cold_sites = collections.Counter(s["site"] for s in cold)
    assert cold_sites["devcache.build"] == 1
    assert [s["attrs"]["outcome"] for s in cold
            if s["site"] == "devcache.checkout"] == ["miss"]
    sites = _check_tree(spans, CACHED_TREE)
    assert [s["attrs"]["outcome"] for s in spans
            if s["site"] == "devcache.checkout"] == ["hit"]
    assert sites["devcache.fingerprint"] == 1
    assert _launches(spans) == again["kernel_launches"]
    assert patterns_text(res) == patterns_text(
        mine_spade_torch(db, 3, device="cpu", fused="never"))


def test_mine_inside_a_job_trace_joins_it():
    """Inside an active trace (a service job's) the entry opens a span of
    that trace, not a trace of its own."""
    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    with obs.trace("job-1"):
        _spade(_db(), {})
    assert obs.trace_ids() == ["job-1"]
    spans = obs.trace_dump("job-1")["spans"]
    root = [s for s in spans if s["site"] == "job"]
    entry = [s for s in spans if s["site"] == "mine.spade"]
    assert len(entry) == 1 and entry[0]["parent_id"] == root[0]["span_id"]


@pytest.mark.parametrize("path", ["spade", "cspade", "cached"])
def test_results_and_counters_equal_with_tracing_on_and_off(path,
                                                            classic_cache):
    db = _db(11, 160)
    if path == "cached":
        def run(stats):
            classic_cache.mine(db, 3, device="cpu", stats_out={})
            return classic_cache.mine(db, 3, device="cpu", stats_out=stats)
    else:
        run = (lambda st: _spade(db, st)) if path == "spade" \
            else (lambda st: _cspade(db, st))
    obs.configure_tracing(False)
    plain_stats: dict = {}
    plain = run(plain_stats)
    classic_cache.clear()
    traced, traced_stats, spans = _traced(run, 2 if path == "cached" else 1)
    assert spans
    assert patterns_text(traced) == patterns_text(plain)
    assert traced == plain
    assert traced_stats == plain_stats


class _Counting:
    """A stand-in for the profiler range that counts what enters it."""

    entered = 0
    names: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        type(self).names.append(self.name)

    def __exit__(self, *exc):
        pass


def test_disabled_cost_pin_on_the_engine_paths(monkeypatch, classic_cache):
    """Tracing off: the engine paths make no ``Span`` and enter no
    profiler range.  On: one range a span, under the span's site."""
    made = []
    init = obs.Span.__init__

    def counting_init(self, *a, **k):
        made.append(1)
        init(self, *a, **k)

    monkeypatch.setattr(obs.Span, "__init__", counting_init)
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(_Counting, "names", [])
    obs.configure_tracing(True)  # binds the range; then swap in the counter
    monkeypatch.setattr(obs, "_profiler_range", _Counting)
    obs.configure_tracing(False)
    db = _db()
    _spade(db, {})
    _cspade(db, {})
    for _ in range(2):
        classic_cache.mine(db, 3, device="cpu", stats_out={})
    assert made == [] and _Counting.entered == 0
    assert obs.trace_ids() == []

    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    got = []
    obs.add_span_sink(got.append)
    try:
        _spade(db, {})
    finally:
        obs.remove_span_sink(got.append)
    assert _Counting.entered == len(got) == len(made)
    assert sorted(_Counting.names) == sorted(s.site for s in got)


def test_spans_are_profiler_ranges():
    """Under a ``torch.profiler`` session every span is a host event of
    the profile, named by its site, once a span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    got = []
    obs.add_span_sink(got.append)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _spade(_db(), {})
    finally:
        obs.remove_span_sink(got.append)
    events = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CPU)
    want = collections.Counter(s.site for s in got)
    assert want and all(events[site] == n for site, n in want.items())
