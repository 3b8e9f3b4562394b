"""Port parity for ``shape_buckets=True``: each geometry function of the
port returns the reference's numbers over a grid with the buckets both
ways (host arithmetic only), the routing tests judge the bucketed sequence
axis as the reference's do, and SPADE (every route), SPAM, TSR (every
``resident`` value) and cSPADE mined with ``shape_buckets=True`` on the
CPU give the reference's output, routing keys and stats (the port's
counter waits aside)."""

import itertools
import types

import pytest

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models import spade_constrained as JC
from spark_fsm_tpu.models import spade_fused as JF
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models import spade_tpu as JS
from spark_fsm_tpu.models import spam_bitmap as JB
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.models.oracle import mine_cspade, mine_spade
from spark_fsm_tpu.streaming import incremental as JI
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.models import _common as TCM
from spark_fsm_tpu_torch.models import spade as TS
from spark_fsm_tpu_torch.models import spade_constrained as TC
from spark_fsm_tpu_torch.models import spade_fused as TF
from spark_fsm_tpu_torch.models import spade_queue as TQ
from spark_fsm_tpu_torch.models import spam_bitmap as TB
from spark_fsm_tpu_torch.models import tsr as TT
from spark_fsm_tpu_torch.streaming import incremental as TI
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

# sequence counts that are multiples of the port's sequence tile (32), so
# the two packages' unbucketed axes agree too; pool budgets from 1 byte
# (every floor binds) to an H100's SPADE pool
SEQS = (96, 4000, 77504, 990016)
ITEMS = (7, 61, 300)
WORDS = (1, 3)
POOLS = (1, 8 << 20, 64 << 20, 4 << 30, 26 << 30)
GRID = list(itertools.product(SEQS, ITEMS, WORDS, POOLS))


def _rows_match(got, want, buckets):
    """The port keeps no scratch row unless the buckets round the rows."""
    return got["total_rows"] == want["total_rows"] - (0 if buckets else 1)


@pytest.mark.parametrize("buckets", [False, True])
def test_classic_geometry_equals_reference(buckets):
    changed = 0
    for n, ni, w, pool in GRID:
        kw = dict(pool_bytes=pool, shape_buckets=buckets)
        got = TS.classic_geometry(n, ni, w, **kw)
        want = JS.classic_geometry(n, ni, w, **kw)
        for key in ("n_seq", "chunk", "recompute_chunk", "pipeline_depth",
                    "node_batch", "pool_slots"):
            assert got[key] == want[key], (key, n, ni, w, pool)
        assert _rows_match(got, want, buckets), (n, ni, w, pool)
        flat = TS.classic_geometry(n, ni, w, pool_bytes=pool)
        changed += (flat["node_batch"], flat["pool_slots"]) != (
            got["node_batch"], got["pool_slots"])
    if buckets:
        # small pools make the buckets move node_batch or pool_slots
        assert changed > 0


@pytest.mark.parametrize("buckets", [False, True])
def test_spam_geometry_equals_reference(buckets):
    changed = 0
    for n, ni, w, pool in GRID:
        kw = dict(pool_bytes=pool, node_batch=64, shape_buckets=buckets)
        got = TB.spam_geometry(n, ni, w, **kw)
        want = JB.spam_geometry(n, ni, w, **kw)
        for key in ("n_seq", "ni_pad", "node_batch", "pipeline_depth",
                    "pool_slots", "chunk"):
            assert got[key] == want[key], (key, n, ni, w, pool)
        assert _rows_match(got, want, buckets), (n, ni, w, pool)
        flat = TB.spam_geometry(n, ni, w, pool_bytes=pool, node_batch=64)
        changed += (flat["node_batch"], flat["pool_slots"]) != (
            got["node_batch"], got["pool_slots"])
    if buckets:
        assert changed > 0


@pytest.mark.parametrize("buckets", [False, True])
def test_cspade_geometry_equals_reference(buckets):
    for n, ni, w, pool in GRID:
        kw = dict(pool_bytes=pool, shape_buckets=buckets)
        got = TC.cspade_geometry(n, ni, w, **kw)
        want = JC.cspade_geometry(n, ni, w, **kw)
        for key in ("n_seq", "item_rows", "n_pos", "state_bits", "chunk",
                    "recompute_chunk", "pipeline_depth", "node_batch",
                    "pool_slots"):
            assert got[key] == want[key], (key, n, ni, w, pool)


@pytest.mark.parametrize("buckets", [False, True])
def test_tsr_and_sweep_geometry_equal_reference(buckets):
    for n, _, w, _ in GRID:
        assert (TT.tsr_geometry(n, shape_buckets=buckets)["n_seq"]
                == JT.tsr_geometry(n, w, shape_buckets=buckets)["n_seq"])
    for n, w, pallas in itertools.product(
            (1, 99, 129, 5000, 99000), (1, 2, 3, 5), (False, True)):
        got = TI.sweep_geometry(n, w)
        want = JI.sweep_geometry(n, w, use_pallas=pallas)
        assert (got["n_seq"], got["n_words"]) == (want["n_seq"],
                                                  want["n_words"])


def _pin_budget(monkeypatch, budget):
    """Both packages' whole-mine engines read one device budget."""
    for mod in (JQ, JF, TQ, TF):
        monkeypatch.setattr(mod, "device_hbm_budget", lambda *_: budget,
                            raising=False)
    from spark_fsm_tpu.models import _common as JCM
    monkeypatch.setattr(JCM, "device_hbm_budget", lambda *_: budget)


@pytest.mark.parametrize("buckets", [False, True])
@pytest.mark.parametrize("budget", [1 << 30, 6 << 30, 76 << 30])
def test_whole_mine_geometry_and_eligibility_equal_reference(
        monkeypatch, buckets, budget):
    _pin_budget(monkeypatch, budget)
    for n, ni, w, _ in GRID:
        got = TQ.queue_geometry(n, ni, w, device="cpu", shape_buckets=buckets)
        want = JQ.queue_geometry(n, ni, w, shape_buckets=buckets)
        assert (got["n_seq"], got["ni_pad"], got["nb_late"]) == (
            want["n_seq"], want["ni_pad"], want["nb_late"])
        assert (got["caps"].ring, got["caps"].nb) == (want["caps"].ring,
                                                      want["caps"].nb)
        got = TF.fused_geometry(n, ni, w, shape_buckets=buckets)
        want = JF.fused_geometry(n, ni, w, shape_buckets=buckets)
        assert (got["n_seq"], got["ni_pad"], got["caps"].f_cap) == (
            want["n_seq"], want["ni_pad"], want["caps"].f_cap)
    # the routing tests judge the bucketed axis: sizes just past a power
    # of two are where the buckets flip a decision
    flips = 0
    for n, ni, w in itertools.product(
            (4000, 65537, 300000, 524289, 990000), (7, 61, 300, 1100),
            (1, 3)):
        vdb = types.SimpleNamespace(n_sequences=n, n_items=ni, n_words=w)
        q = TQ.queue_eligible(vdb, "cpu", shape_buckets=buckets)
        f = TF.fused_eligible(vdb, "cpu", shape_buckets=buckets)
        assert q == JQ.queue_eligible(vdb, shape_buckets=buckets), (n, ni, w)
        assert f == JF.fused_eligible(vdb, shape_buckets=buckets), (n, ni, w)
        flips += (q, f) != (TQ.queue_eligible(vdb, "cpu"),
                            TF.fused_eligible(vdb, "cpu"))
    if buckets and budget == 6 << 30:
        assert flips > 0


def test_bucket_helpers_equal_reference():
    from spark_fsm_tpu.models import _common as JCM

    import numpy as np
    for n in (0, 1, 127, 128, 129, 99000, 990000):
        assert TCM.bucket_seq(n) == JCM.bucket_seq(n)
    rng = np.random.default_rng(3)
    for n in (0, 1, 5, 64, 100):
        toks = [rng.integers(0, 9, n).astype(np.int32) for _ in range(4)]
        for a, b in zip(TCM.pad_tokens_pow2(*toks),
                        JCM.pad_tokens_pow2(*toks)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------ whole mines

ROUTING = ("fused", "fused_overflow", "fused_waves", "fused_levels",
           "fused_skipped")
# the counters each route shares with the reference (the whole-mine
# engines count launches per wave or level, a known difference)
ROUTE_COUNTERS = {
    "queue": ("waves", "late_waves", "candidates", "patterns"),
    True: ("levels", "patterns"),
}


def _db():
    return synthetic_db(seed=7, n_sequences=300, n_items=30,
                        mean_itemsets=4.0, mean_itemset_size=1.5)


@pytest.mark.parametrize("fused,kw", [
    ("auto", {}), ("queue", {}), ("dense", {}), ("never", {}),
    # a pool of a few slots: the buckets' row rounding sets the pool and
    # node_batch, and the classic engine recomputes and reclaims
    ("never", dict(pool_bytes=40 * 128 * 4, node_batch=8, chunk=16,
                   recompute_chunk=4)),
])
def test_spade_routes_with_buckets_equal_reference(fused, kw):
    db = _db()
    ms = JV.abs_minsup(0.03, len(db))
    ref_stats, stats = {}, {}
    want = JS.mine_spade_tpu(db, ms, fused=fused, shape_buckets=True,
                             stats_out=ref_stats, **kw)
    got = TS.mine_spade_torch(db, ms, device="cpu", fused=fused,
                              shape_buckets=True, stats_out=stats, **kw)
    assert patterns_text(got) == j_patterns_text(want) == j_patterns_text(
        mine_spade(db, ms))
    assert ({k: stats[k] for k in ROUTING if k in stats}
            == {k: ref_stats[k] for k in ROUTING if k in ref_stats})
    route = stats["fused"]
    if fused == "auto":
        assert route == "queue"
    if route is False:
        # the reference's route without its Pallas kernel gathers the
        # supports in launches of `chunk` candidates, B1 takes a batch in
        # one: launches agree only while a batch fits one chunk
        skip = ("shape_key", "kernel_launches") if kw else ("shape_key",)
        assert ({k: v for k, v in stats.items() if k not in skip}
                == {k: v for k, v in ref_stats.items() if k not in skip})
    else:
        for key in ROUTE_COUNTERS[route]:
            assert stats[key] == ref_stats[key], key
    if kw:
        assert stats["recomputed_nodes"] > 0


@pytest.mark.parametrize("kw", [
    dict(node_batch=4, pool_bytes=64 << 20),
    dict(node_batch=64, pool_bytes=24 * 300 * 4, density_crossover=0.5),
])
def test_spam_with_buckets_equals_reference(kw):
    db = _db()
    ms = JV.abs_minsup(0.05, len(db))
    ref_stats, stats = {}, {}
    want = JB.mine_spam_tpu(db, ms, shape_buckets=True, stats_out=ref_stats,
                            **kw)
    got = TB.mine_spam_torch(db, ms, device="cpu", shape_buckets=True,
                             stats_out=stats, **kw)
    assert patterns_text(got) == j_patterns_text(want) == j_patterns_text(
        mine_spade(db, ms))
    assert stats == ref_stats


@pytest.mark.parametrize("resident", ["auto", "always", "never"])
def test_tsr_with_buckets_equals_reference(resident):
    db = synthetic_db(seed=5, n_sequences=120, n_items=10, mean_itemsets=3.0)
    ref_stats, stats = {}, {}
    want = JT.mine_tsr_tpu(db, 8, 0.5, max_side=None, resident=resident,
                           shape_buckets=True, stats_out=ref_stats)
    got = TT.mine_tsr_torch(db, 8, 0.5, max_side=None, resident=resident,
                            shape_buckets=True, device="cpu", stats_out=stats)
    assert rules_text(got) == j_rules_text(want)
    assert {k: v for k, v in stats.items() if k != "wait_s"} == ref_stats
    assert stats.get("resident", False) == (resident != "never")


def test_cspade_with_buckets_equals_reference():
    db = synthetic_db(seed=31, n_sequences=150, n_items=20, mean_itemsets=5.0)
    ms = JV.abs_minsup(0.05, len(db))
    kw = dict(maxgap=3, maxwindow=6, pool_bytes=1, node_batch=8, chunk=32,
              recompute_chunk=4)
    ref = JC.ConstrainedSpadeTPU(JV.build_vertical(db, min_item_support=ms),
                                 ms, shape_buckets=True, **kw)
    stats = {}
    got = TC.mine_cspade_torch(db, ms, device="cpu", shape_buckets=True,
                               stats_out=stats, **kw)
    want = ref.mine()
    assert patterns_text(got) == j_patterns_text(want) == j_patterns_text(
        mine_cspade(db, ms, maxgap=3, maxwindow=6))
    assert ({k: v for k, v in stats.items() if k != "geometry"}
            == ref.stats)
    assert stats["recomputed_nodes"] > 0
    assert (ref.n_seq, ref.item_rows) == (256, 32)
