"""The port's engine cache (``spark_fsm_tpu_torch/service/devcache.py``)
on the CPU, against the reference's (``spark_fsm_tpu/service/devcache.py``)
on the same calls: the content fingerprint, hits and misses, the key's
coverage, eviction by the byte budget and by count, the uncached fall
throughs, and a checkpointed mine resumed on the cached engine.

Every cached engine is mined a second time on the same object, as a
cache hit does (``_mine_checked_out`` zeroes its numeric stats first):
the text and the counters must equal a fresh engine's."""

import json
import time
import urllib.parse
import urllib.request

import pytest
import torch

from spark_fsm_tpu.service import devcache as JD
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.data.spmf import format_spmf
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.models.oracle import mine_cspade, mine_spade
from spark_fsm_tpu_torch.models.spade import SpadeTorch
from spark_fsm_tpu_torch.models.spade_constrained import ConstrainedSpadeTorch
from spark_fsm_tpu_torch.models.spade_queue import QueueSpadeTorch
from spark_fsm_tpu_torch.models.tsr import TsrTorch, mine_tsr_cpu
from spark_fsm_tpu_torch.service import devcache as TD
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

CPU = torch.device("cpu")
# timing stats differ run to run; everything else must repeat exactly
TIMING = ("wait_s",)


def _db(seed=5, n=120):
    return synthetic_db(seed=seed, n_sequences=n, n_items=12,
                        mean_itemsets=3.0)


def _counters(stats):
    return {k: v for k, v in stats.items() if k not in TIMING}


def test_fingerprint_is_content_exact_and_equals_reference():
    a, b = _db(5), _db(5)
    assert TD.db_fingerprint(a) == TD.db_fingerprint(b)
    assert TD.db_fingerprint(a) != TD.db_fingerprint(_db(6))
    c = [list(map(list, s)) for s in _db(5)]
    c[3][0][0] += 1
    assert TD.db_fingerprint(c) != TD.db_fingerprint(a)
    for db in (a, _db(6), c):
        assert TD.db_fingerprint(db) == JD.db_fingerprint(db)


# --------------------------------------------------- each engine, twice

def _spade_engines():
    db = _db(7, 200)
    vdb8 = TV.build_vertical(db, min_item_support=8)
    vdb3 = TV.build_vertical(db, min_item_support=3)
    return [
        ("queue", lambda: QueueSpadeTorch(vdb8, 8, device=CPU),
         mine_spade(db, 8)),
        # a pool of 41 slots for 108 patterns: the first mine recomputes
        # and reclaims, so the second starts from a used slot pool
        ("classic", lambda: SpadeTorch(vdb3, 3, device=CPU, node_batch=4,
                                       pool_bytes=64 << 10),
         mine_spade(db, 3)),
    ]


def _remine_through_cache(make):
    """Mine a fresh engine, then mine it again the way a cache hit does;
    returns (first result, first stats, second result, second stats)."""
    eng = make()
    first = eng.mine()
    first_stats = dict(eng.stats)
    cache = TD.SpadeEngineCache(budget_bytes=1 << 40)
    entry = TD._Entry(eng, TD.engine_bytes(eng))
    entry.busy = True
    second, snap = cache._mine_checked_out(entry)
    assert entry.busy is False
    return first, first_stats, second, snap


@pytest.mark.parametrize("name", ["queue", "classic"])
def test_spade_engine_mined_twice_equals_a_fresh_engine(name):
    make, want = {n: (m, w) for n, m, w in _spade_engines()}[name]
    first, s1, second, s2 = _remine_through_cache(make)
    assert patterns_text(first) == patterns_text(second) \
        == patterns_text(want)
    assert _counters(s2) == _counters(s1)
    if name == "classic":
        assert s1["recomputed_nodes"] > 0 and s1["reclaimed_slots"] > 0


@pytest.mark.parametrize("maxgap,maxwindow,minsup", [(2, 5, 2), (1, None, 6),
                                                    (None, 3, 6)])
def test_cspade_engine_mined_twice_equals_a_fresh_engine(maxgap, maxwindow,
                                                         minsup):
    db = _db(21)
    vdb = TV.build_vertical(db, min_item_support=minsup)
    first, s1, second, s2 = _remine_through_cache(
        lambda: ConstrainedSpadeTorch(vdb, minsup, maxgap=maxgap,
                                      maxwindow=maxwindow, device=CPU,
                                      pool_bytes=32 << 10))
    assert patterns_text(first) == patterns_text(second) == patterns_text(
        mine_cspade(db, minsup, maxgap=maxgap, maxwindow=maxwindow))
    assert _counters(s2) == _counters(s1)
    if minsup == 2:
        assert s1["reclaimed_slots"] > 0


@pytest.mark.parametrize("engine", ["classic", "cspade"])
def test_engine_reclaim_count_restarts_with_each_mine(engine):
    """``reclaimed_slots`` is the mine's own count: a second ``mine()`` on
    the same engine starts from a whole slot pool, so it reclaims (and
    reports) exactly what the first did."""
    db = _db(7, 200) if engine == "classic" else _db(21)
    minsup = 3 if engine == "classic" else 2
    vdb = TV.build_vertical(db, min_item_support=minsup)
    if engine == "classic":
        eng = SpadeTorch(vdb, minsup, device=CPU, node_batch=4,
                         pool_bytes=64 << 10)
    else:
        eng = ConstrainedSpadeTorch(vdb, minsup, maxgap=2, maxwindow=5,
                                    device=CPU, pool_bytes=32 << 10)
    eng.mine()
    first = eng.stats["reclaimed_slots"]
    eng.mine()
    assert first > 0 and eng.stats["reclaimed_slots"] == first


@pytest.mark.parametrize("kw", [dict(max_side=2),
                                dict(max_side=None, resident="always"),
                                dict(max_side=None, resident="never")])
def test_tsr_engine_mined_twice_equals_a_fresh_engine(kw):
    db = _db(9)
    vdb = TV.build_vertical(db, min_item_support=1)
    first, s1, second, s2 = _remine_through_cache(
        lambda: TsrTorch(vdb, 10, 0.4, device=CPU, **kw))
    assert rules_text(first) == rules_text(second) == rules_text(
        mine_tsr_cpu(db, 10, 0.4, max_side=kw["max_side"]))
    assert _counters(s2) == _counters(s1)
    assert s1.get("resident", False) is (kw.get("resident") == "always")


def test_tsr_engine_keeps_no_tensor_between_mines():
    """What the TSR cache's scrub would drop: after a round the engine
    holds no tensor, so a cached entry costs no device memory."""
    cache = TD.TsrEngineCache()
    cache.mine(_db(9), 10, 0.4, device="cpu", stats_out={})
    (entry,) = cache._entries.values()
    assert TD.engine_bytes(entry.engine) == 0
    assert not [k for k, v in vars(entry.engine).items()
                if isinstance(v, torch.Tensor)]


# ------------------------------------------- the reference's cache calls

def test_repeat_mine_hits_and_matches_oracle():
    cache = TD.SpadeEngineCache()
    db = _db()
    want = mine_spade(db, 6)
    s1, s2 = {}, {}
    r1 = cache.mine(db, 6, device="cpu", stats_out=s1)
    r2 = cache.mine(db, 6, device="cpu", stats_out=s2)
    assert patterns_text(r1) == patterns_text(r2) == patterns_text(want)
    assert s1["store_cache_hit"] is False
    assert s2["store_cache_hit"] is True
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1
    assert s2["fused"] == "queue"


def test_key_covers_minsup_and_data():
    cache = TD.SpadeEngineCache()
    db = _db()
    cache.mine(db, 6, device="cpu", stats_out={})
    s = {}
    cache.mine(db, 8, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is False
    s = {}
    cache.mine(_db(9), 6, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is False
    assert cache.stats["hits"] == 0
    s = {}
    got = cache.mine(db, 8, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is True
    assert patterns_text(got) == patterns_text(mine_spade(db, 8))


def test_budget_evicts_lru():
    # the reference's calls: a budget nothing fits never caches
    ref, port = JD.SpadeEngineCache(budget_bytes=1), \
        TD.SpadeEngineCache(budget_bytes=1)
    db = _db()
    for cache, kw in ((ref, {}), (port, {"device": "cpu"})):
        s1, s2 = {}, {}
        cache.mine(db, 6, stats_out=s1, **kw)
        cache.mine(db, 6, stats_out=s2, **kw)
        assert s2["store_cache_hit"] is False
        assert cache.stats["misses"] == 2 and not cache._entries


def test_budget_evicts_the_least_recently_used_engine():
    probe = TD.SpadeEngineCache(budget_bytes=1 << 40)
    probe.mine(_db(), 6, device="cpu", stats_out={})
    (entry,) = probe._entries.values()
    assert entry.nbytes == TD.engine_bytes(entry.engine) > 0
    # room for one engine of this geometry, not two
    cache = TD.SpadeEngineCache(budget_bytes=entry.nbytes + 1)
    cache.mine(_db(), 6, device="cpu", stats_out={})
    cache.mine(_db(), 7, device="cpu", stats_out={})
    assert cache.stats["evictions"] == 1 and len(cache._entries) == 1
    s = {}
    cache.mine(_db(), 7, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is True
    s = {}
    cache.mine(_db(), 6, device="cpu", stats_out=s)
    assert s["store_cache_hit"] is False


def test_explicit_engine_kwargs_fall_through_uncached():
    cache = TD.SpadeEngineCache()
    db = _db()
    s = {}
    got = cache.mine(db, 6, device="cpu", stats_out=s, chunk=64)
    assert "store_cache_hit" not in s
    assert patterns_text(got) == patterns_text(mine_spade(db, 6))
    assert not cache.stats["hits"] and not cache.stats["misses"]


def test_queue_engine_is_reused_when_pinned():
    cache = TD.SpadeEngineCache()
    db = _db()
    cache.mine(db, 6, device="cpu", stats_out={}, fused="queue")
    s2 = {}
    cache.mine(db, 6, device="cpu", stats_out=s2, fused="queue")
    assert s2["store_cache_hit"] is True and s2.get("fused") == "queue"


def test_tsr_repeat_mine_hits_and_matches():
    cache = TD.TsrEngineCache()
    db = _db()
    want = mine_tsr_cpu(db, 10, 0.4, max_side=2)
    s1, s2 = {}, {}
    r1 = cache.mine(db, 10, 0.4, max_side=2, device="cpu", stats_out=s1)
    r2 = cache.mine(db, 10, 0.4, max_side=2, device="cpu", stats_out=s2)
    assert rules_text(r1) == rules_text(r2) == rules_text(want)
    assert s1["store_cache_hit"] is False
    assert s2["store_cache_hit"] is True
    s3: dict = {}
    cache.mine(db, 11, 0.4, max_side=2, device="cpu", stats_out=s3)
    assert s3["store_cache_hit"] is False
    assert cache.stats == {"hits": 1, "misses": 2, "busy_misses": 0,
                           "evictions": 0, "breaker_fallbacks": 0}
    cache.mine(db, 12, 0.4, max_side=2, device="cpu")
    assert cache.stats["evictions"] == 1


def test_cspade_repeat_mine_hits_and_key_folds_constraints():
    cache = TD.CSpadeEngineCache()
    db = _db(seed=22)
    s1, s2 = {}, {}
    r1 = cache.mine(db, 6, maxgap=2, maxwindow=5, device="cpu",
                    stats_out=s1)
    r2 = cache.mine(db, 6, maxgap=2, maxwindow=5, device="cpu",
                    stats_out=s2)
    want = mine_cspade(db, 6, maxgap=2, maxwindow=5)
    assert patterns_text(r1) == patterns_text(r2) == patterns_text(want)
    assert (s1["store_cache_hit"], s2["store_cache_hit"]) == (False, True)
    for mg, mw in ((1, 5), (2, None)):
        s = {}
        cache.mine(db, 6, maxgap=mg, maxwindow=mw, device="cpu",
                   stats_out=s)
        assert s["store_cache_hit"] is False
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 3


def test_cspade_checkpoint_and_kwargs_fall_through():
    class Ckpt:
        every_s = 30.0

        def load(self):
            return None

        def save(self, state):
            pass

    cache = TD.CSpadeEngineCache()
    db = _db(seed=23)
    s = {}
    cache.mine(db, 6, maxgap=2, device="cpu", stats_out=s,
               checkpoint=Ckpt())
    assert "store_cache_hit" not in s
    s = {}
    cache.mine(db, 6, maxgap=2, device="cpu", stats_out=s, chunk=64)
    assert "store_cache_hit" not in s
    assert not cache.stats["hits"] and not cache.stats["misses"]


def test_checkpointed_mine_reuses_cached_engine():
    from spark_fsm_tpu_torch.data.vertical import abs_minsup

    db = _db(seed=24, n=240)
    minsup = abs_minsup(0.05, len(db))
    cache = TD.SpadeEngineCache()
    want = mine_spade(db, minsup)
    s0 = {}
    r0 = cache.mine(db, minsup, device="cpu", stats_out=s0)
    assert patterns_text(r0) == patterns_text(want)
    assert s0["store_cache_hit"] is False

    class Crash(Exception):
        pass

    class CrashingCkpt:
        every_s = 0.0

        def __init__(self):
            self.saved, self.merged, self.crash = [], [], True

        def load(self):
            if not self.saved:
                return None
            state = dict(self.saved[-1])
            state["results"] = list(self.merged)
            return state

        def save(self, state):
            assert state["results_done"] == len(self.merged)
            self.merged.extend(state.pop("results"))
            state["results"] = None
            self.saved.append(state)
            if self.crash and len(self.saved) == 1:
                raise Crash

    ckpt = CrashingCkpt()
    with pytest.raises(Crash):
        cache.mine(db, minsup, device="cpu", stats_out={}, checkpoint=ckpt)
    assert ckpt.saved and ckpt.saved[-1]["stack"]
    ckpt.crash = False
    s2 = {}
    r2 = cache.mine(db, minsup, device="cpu", stats_out=s2, checkpoint=ckpt)
    assert s2["store_cache_hit"] is True, s2
    assert s2.get("resumed_nodes", 0) > 0, s2
    assert patterns_text(r2) == patterns_text(want)
    # the failed checkpointed mine counted against the breaker, the
    # resumed one closed it again: no fallback was taken
    assert cache.stats["breaker_fallbacks"] == 0


def test_engine_cache_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        TD.SpadeEngineCache().mine(_db(), 6)


# ------------------------------------------------------- over HTTP

@pytest.fixture(scope="module")
def server():
    from spark_fsm_tpu_torch.service.app import serve_background

    srv = serve_background(device="cpu")
    yield srv
    srv.master.shutdown()
    srv.shutdown()


def _post(server, endpoint, **params):
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{server.server_port}{endpoint}"
    with urllib.request.urlopen(url, data=data, timeout=60) as resp:
        return resp.read().decode()


def _train(server, uid, **params):
    r = json.loads(_post(server, "/train", uid=uid, **params))
    assert r["status"] == "started", r
    for _ in range(600):
        st = json.loads(_post(server, "/status/" + uid))
        if st["status"] in ("finished", "failure"):
            assert st["status"] == "finished", st
            return json.loads(st["data"]["stats"])
        time.sleep(0.05)
    raise AssertionError("job did not finish")


@pytest.mark.parametrize("params,get", [
    (dict(algorithm="SPADE_TPU", support="6"), "patterns"),
    (dict(algorithm="SPADE_TPU", support="6", maxgap="2", maxwindow="5"),
     "patterns"),
    (dict(algorithm="TSR_TPU", k="10", minconf="0.4", max_side="2"),
     "rules"),
])
def test_train_twice_hits_the_cache_with_an_identical_body(server, params,
                                                           get):
    seqs = format_spmf(_db(seed=31))
    tag = "-".join(sorted(params.values()))
    s1 = _train(server, "dc1" + tag, source="INLINE", sequences=seqs,
                **params)
    s2 = _train(server, "dc2" + tag, source="INLINE", sequences=seqs,
                **params)
    assert (s1["store_cache_hit"], s2["store_cache_hit"]) == (False, True)
    body = [json.loads(_post(server, f"/get/{get}", uid=u + tag))
            for u in ("dc1", "dc2")]
    assert body[0]["data"][get] == body[1]["data"][get]
    stats = json.loads(_post(server, "/admin/stats"))
    cache = {"SPADE_TPU": "cspade_cache" if "maxgap" in params
             else "store_cache", "TSR_TPU": "tsr_cache"}[params["algorithm"]]
    assert stats[cache]["hits"] >= 1
