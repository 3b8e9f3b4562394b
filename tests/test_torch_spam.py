"""Port parity for the SPAM slice as a whole: ``mine_spam_torch`` on the CPU
against the reference engine (``mine_spam_tpu``) and the oracle on the
``tests/test_spam.py`` fixtures; with the geometry pinned, the engine's
counters equal the reference's; the port's ``mine_spam_cpu`` and its stats
equal the reference's; frontier checkpoints resume across both packages'
SPAM and SPADE engines; and the entry point's refusals."""

import json

import pytest

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.synth import kosarak_like, synthetic_db
from spark_fsm_tpu.models import spam_bitmap as JS
from spark_fsm_tpu.models.oracle import mine_spade
from spark_fsm_tpu.models.spade_tpu import SpadeTPU
from spark_fsm_tpu.utils.canonical import diff_patterns, patterns_text
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import spam_bitmap as TS
from spark_fsm_tpu_torch.models.spade import SpadeTorch

# the counters that must equal the reference engine's
COUNTERS = ("waves", "candidates", "evaluated_lanes", "pair_launches",
            "diffset_nodes", "wave_survivors", "rep_dense", "rep_idlist",
            "diffset_depth", "representation", "patterns", "engine")
# a pool large enough that neither package's sequence padding moves the
# geometry (node_batch, chunk) off the pinned node_batch
POOL = 64 << 20


def _db_small():
    return synthetic_db(seed=7, n_sequences=60, n_items=10,
                        mean_itemsets=3.0, mean_itemset_size=1.3)


def _db_mid():
    return synthetic_db(seed=3, n_sequences=80, n_items=12,
                        mean_itemsets=4.0, mean_itemset_size=1.4)


def _db_kosarak():
    return kosarak_like(scale=0.0003, fast=True)


def _db_mixed():
    return synthetic_db(seed=401, n_sequences=90, n_items=24,
                        mean_itemsets=4.0, mean_itemset_size=1.3,
                        zipf_s=2.2)


def _parity(db, ms, **kw):
    want = patterns_text(mine_spade(db, ms, kw.get("max_pattern_itemsets")))
    ref_stats, stats = {}, {}
    ref = JS.mine_spam_tpu(db, ms, stats_out=ref_stats, **kw)
    got = TS.mine_spam_torch(db, ms, device="cpu", stats_out=stats, **kw)
    assert patterns_text(got) == want, diff_patterns(mine_spade(db, ms), got)
    assert patterns_text(ref) == want
    return stats, ref_stats


@pytest.mark.parametrize("fixture,sup,kw", [
    (_db_small, 0.05, {}), (_db_small, 0.2, {}),
    (_db_mid, 0.1, {}), (_db_mid, 0.2, {}),
    (_db_kosarak, 0.03, {}),
    (_db_mid, 0.1, {"max_pattern_itemsets": 2}),
    (_db_mixed, 0.08, {"density_crossover": 0.5}),
    (_db_mixed, 0.08, {"representation": "bitmap"}),
    (_db_mixed, 0.08, {"representation": "idlist"}),
    (_db_mixed, 0.08, {"density_crossover": 0.5, "diffset_depth": 0}),
    (_db_mixed, 0.08, {"density_crossover": 0.5, "diffset_depth": 1}),
])
def test_parity_and_counters_with_pinned_geometry(fixture, sup, kw):
    db = fixture()
    ms = JV.abs_minsup(sup, len(db))
    stats, ref_stats = _parity(db, ms, node_batch=4, pool_bytes=POOL, **kw)
    for key in COUNTERS:
        assert stats[key] == ref_stats[key], (key, stats[key], ref_stats[key])
    assert stats["waves"] >= 1 or kw.get("representation") == "idlist"


def test_hybrid_plan_runs_both_halves_at_default_geometry():
    db = _db_mixed()
    ms = JV.abs_minsup(0.08, len(db))
    stats, ref_stats = _parity(db, ms, density_crossover=0.5)
    assert stats["rep_dense"] > 0 and stats["rep_idlist"] > 0
    assert stats["pair_launches"] > 0 and stats["diffset_nodes"] > 0
    assert stats["wave_survivors"] > 0
    assert stats["waves"] == ref_stats["waves"]


@pytest.mark.parametrize("fixture,sup,kw,hybrid", [
    (_db_mid, 0.1, {}, False),
    (_db_mixed, 0.08, {"density_crossover": 0.5}, True),
])
def test_wave_hint_names_the_live_item_rows(monkeypatch, fixture, sup, kw,
                                            hybrid):
    """Every wave passes ``n_live`` = the real item count (``n_items`` on the
    pure-bitmap plan, ``n_dense`` on the hybrid one), and the wave's item
    rows from ``n_live`` to ``nd_pad`` are all zero, so the kernel may skip
    them."""
    from spark_fsm_tpu_torch.ops import spam_bitops as SB

    db = fixture()
    ms = JV.abs_minsup(sup, len(db))
    seen = []
    real = SB.wave_extend_prune

    def spy(pt, items, thr, use_diff, *, n_words, nd_pad, n_live=None):
        seen.append((n_live, nd_pad, bool(items[n_live:nd_pad].any())))
        return real(pt, items, thr, use_diff, n_words=n_words, nd_pad=nd_pad,
                    n_live=n_live)

    monkeypatch.setattr(SB, "wave_extend_prune", spy)
    eng = TS.SpamBitmapTorch(TV.build_vertical(db, min_item_support=ms), ms,
                             device="cpu", node_batch=4, pool_bytes=POOL, **kw)
    got = eng.mine()
    assert patterns_text(got) == patterns_text(mine_spade(db, ms))
    assert (eng.stats["rep_idlist"] > 0) == hybrid
    live = eng.n_dense if hybrid else eng.n_items
    assert 0 < live < eng.nd_pad
    assert seen and all(s == (live, eng.nd_pad, False) for s in seen)


def test_tiny_pool_forces_one_node_waves():
    db = _db_mid()
    ms = JV.abs_minsup(0.1, len(db))
    eng = TS.SpamBitmapTorch(TV.build_vertical(db, min_item_support=ms), ms,
                             device="cpu", node_batch=2, pipeline_depth=1,
                             pool_bytes=1)
    assert eng.node_batch == 1 and eng.pool_slots <= 64
    got = eng.mine()
    assert patterns_text(got) == patterns_text(mine_spade(db, ms))
    assert eng.stats["waves"] > 5


def test_empty_projection():
    db = [((1,),), ((2,),)]
    assert TS.mine_spam_torch(db, 2, device="cpu") == []
    assert TS.mine_spam_cpu(db, 2) == []


@pytest.mark.parametrize("fixture,sup,kw", [
    (_db_small, 0.1, {}),
    (_db_mid, 0.1, {"max_pattern_itemsets": 2}),
    (_db_mixed, 0.08, {"density_crossover": 0.5}),
    (_db_mixed, 0.08, {"representation": "idlist", "diffset_depth": 1}),
])
def test_mine_spam_cpu_and_stats_equal_reference(fixture, sup, kw):
    db = fixture()
    ms = JV.abs_minsup(sup, len(db))
    stats, ref_stats = {}, {}
    got = TS.mine_spam_cpu(db, ms, stats_out=stats, **kw)
    assert got == JS.mine_spam_cpu(db, ms, stats_out=ref_stats, **kw)
    assert stats == ref_stats
    assert patterns_text(got) == patterns_text(
        mine_spade(db, ms, kw.get("max_pattern_itemsets")))


def test_geometry_equals_reference_where_the_sequence_axes_agree():
    for n_seq, n_items, W, nb, pool in ((1024, 10, 1, 64, 32 << 20),
                                        (4096, 300, 2, 64, 1 << 30),
                                        (990016, 17, 1, 64, 26_600_000_000),
                                        (96, 7, 1, 4, POOL)):
        got = TS.spam_geometry(n_seq, n_items, W, node_batch=nb,
                               pool_bytes=pool)
        want = JS.spam_geometry(n_seq, n_items, W, node_batch=nb,
                                pool_bytes=pool)
        for key in ("n_seq", "ni_pad", "node_batch",
                    "pipeline_depth", "pool_slots", "chunk"):
            assert got[key] == want[key], (key, n_seq)


# ------------------------------------------------------- checkpoint/resume


def _mid_snapshot(make_engine):
    """A mid-mine snapshot of per-wave checkpoints, with every earlier
    delta's results merged in (what a checkpoint store hands back)."""
    snaps = []
    make_engine().mine(checkpoint_cb=snaps.append, checkpoint_every_s=0.0)
    assert len(snaps) >= 3
    k = len(snaps) // 2
    snap = json.loads(json.dumps(snaps[k]))
    snap["results"] = [r for s in snaps[:k + 1] for r in s["results"]]
    snap["results_done"] = 0
    assert snap["stack"]
    return snap


def _engines(db, ms):
    jv = JV.build_vertical(db, min_item_support=ms)
    tv = TV.build_vertical(db, min_item_support=ms)
    small = dict(node_batch=2, pipeline_depth=1)
    return {
        "port_spam": (lambda **k: TS.SpamBitmapTorch(tv, ms, device="cpu", **k)),
        "ref_spam": (lambda **k: JS.SpamBitmapTPU(jv, ms, **k)),
        "port_spade": (lambda **k: SpadeTorch(tv, ms, device="cpu", **k)),
        "ref_spade": (lambda **k: SpadeTPU(jv, ms, **k)),
    }, small


@pytest.mark.parametrize("src,dst", [
    ("port_spam", "ref_spam"), ("ref_spam", "port_spam"),
    ("port_spam", "port_spade"), ("port_spade", "port_spam"),
    ("port_spam", "ref_spade"), ("ref_spade", "port_spam"),
])
def test_checkpoints_resume_across_engines_and_packages(src, dst):
    db = _db_mid()
    ms = JV.abs_minsup(0.1, len(db))
    make, small = _engines(db, ms)
    snap = _mid_snapshot(lambda: make[src](**small))
    eng = make[dst]()
    got = eng.mine(resume=snap)
    assert patterns_text(got) == patterns_text(mine_spade(db, ms))
    assert eng.stats["resumed_nodes"] == len(snap["stack"])
    # resumed nodes carry no slot: their bitmaps are recomputed
    assert eng.stats["recomputed_nodes"] > 0


def test_fingerprints_agree_across_engines_and_packages():
    db = _db_mid()
    make, _ = _engines(db, 8)
    prints = {name: json.dumps(m().frontier_fingerprint())
              for name, m in make.items()}
    assert len(set(prints.values())) == 1, prints


def test_stale_fingerprint_refused():
    db = _db_mid()
    ms = JV.abs_minsup(0.1, len(db))
    make, small = _engines(db, ms)
    snap = _mid_snapshot(lambda: make["port_spam"](**small))
    other = TS.SpamBitmapTorch(TV.build_vertical(db, min_item_support=ms),
                               ms + 1, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.mine(resume=snap)


def test_entry_point_resumes_a_checkpoint():
    db = _db_mixed()
    ms = JV.abs_minsup(0.08, len(db))
    jv = JV.build_vertical(db, min_item_support=ms)
    snap = _mid_snapshot(lambda: JS.SpamBitmapTPU(
        jv, ms, node_batch=2, pipeline_depth=1, representation="bitmap"))
    saved = []

    class Ckpt:  # the entry point's checkpoint contract
        every_s = 0.0

        def load(self):
            return snap

        def save(self, state):
            saved.append(state)

    stats = {}
    got = TS.mine_spam_torch(db, ms, device="cpu", checkpoint=Ckpt(),
                             density_crossover=0.5, stats_out=stats)
    assert patterns_text(got) == patterns_text(mine_spade(db, ms))
    assert stats["resumed_nodes"] == len(snap["stack"]) and saved


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("kw,item", [({"mesh": "local"}, "item 6"),
                                     ({"partition_parts": 2}, "item 11"),
                                     ({"shape_buckets": True}, "item 9")])
def test_unported_options_raise(kw, item):
    if item == "item 6":
        # ported: a 1-rank mesh mines what one device does, B1 then the
        # reduce and the threshold (the hybrid store's pairs too)
        from spark_fsm_tpu_torch.parallel.mesh import local_mesh
        mesh = local_mesh("cpu")
        for extra in ({}, {"density_crossover": 0.5}):
            stats, want_stats = {}, {}
            got = TS.mine_spam_torch(_db_small(), 3, mesh=mesh,
                                     stats_out=stats, **extra)
            want = TS.mine_spam_torch(_db_small(), 3, device="cpu",
                                      stats_out=want_stats, **extra)
            assert patterns_text(got) == patterns_text(want)
            assert stats == want_stats
        assert mesh.reduce_stats()["all_reduces"] > 0
        return
    if item == "item 9":
        # ported: shape_buckets mines the oracle's patterns
        got = TS.mine_spam_torch(_db_small(), 3, device="cpu", **kw)
        assert patterns_text(got) == patterns_text(mine_spade(_db_small(), 3))
        return
    # ported: two class slices mine what the reference's partitioned mine
    # and one device mine, with equal stats
    for extra in ({}, {"density_crossover": 0.5}):
        stats, ref_stats = {}, {}
        got = TS.mine_spam_torch(_db_small(), 3, device="cpu",
                                 stats_out=stats, **extra, **kw)
        ref = JS.mine_spam_tpu(_db_small(), 3, stats_out=ref_stats, **extra,
                               **kw)
        one = TS.mine_spam_torch(_db_small(), 3, device="cpu", **extra)
        assert patterns_text(got) == patterns_text(ref) == patterns_text(one)
        assert stats == ref_stats


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.mine_spam_torch(_db_small(), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.SpamBitmapTorch(TV.build_vertical(_db_small(), min_item_support=3), 3)
