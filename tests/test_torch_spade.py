"""Port parity for the slice as a whole: ``mine_spade_torch`` on the CPU
against the reference oracle and the reference classic engine
(``mine_spade_tpu(..., fused="never")``) on the ``tests/test_spade_tpu.py``
fixtures, both through the default route (the queue engine) and pinned to
the classic engine; frontier snapshots resumed across the two packages;
and the entry point's device and routing rules, its routing keys held
against ``mine_spade_tpu``'s for every ``fused`` value."""

import json

import numpy as np
import pytest

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.spmf import parse_spmf
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models.oracle import mine_spade
from spark_fsm_tpu.models.spade_tpu import SpadeTPU, mine_spade_tpu
from spark_fsm_tpu.utils.canonical import diff_patterns, patterns_text
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import oracle as TO
from spark_fsm_tpu_torch.models.spade import SpadeTorch, mine_spade_torch
from tests.test_oracle import ZAKI_DB, random_db


def assert_parity(db, minsup, max_pattern_itemsets=None, **kw):
    """The default route (the queue engine on these small inputs) and the
    classic engine pinned with ``fused="never"`` both give the oracle's
    patterns."""
    want = mine_spade(db, minsup, max_pattern_itemsets=max_pattern_itemsets)
    ref = mine_spade_tpu(db, minsup, max_pattern_itemsets=max_pattern_itemsets,
                         fused="never")
    text = patterns_text(want)
    assert patterns_text(ref) == text
    assert patterns_text(TO.mine_spade(db, minsup, max_pattern_itemsets)) == text
    qstats, stats = {}, {}
    routed = mine_spade_torch(db, minsup, device="cpu",
                              max_pattern_itemsets=max_pattern_itemsets,
                              stats_out=qstats, **kw)
    assert patterns_text(routed) == text, diff_patterns(want, routed)
    got = mine_spade_torch(db, minsup, device="cpu", fused="never",
                           max_pattern_itemsets=max_pattern_itemsets,
                           stats_out=stats, **kw)
    assert patterns_text(got) == text, diff_patterns(want, got)
    if want:
        assert qstats["fused"] == "queue" and qstats["patterns"] == len(want)
        for key in ("candidates", "kernel_launches", "recomputed_nodes",
                    "reclaimed_slots", "patterns"):
            assert key in stats, key
        assert stats["patterns"] == len(want) and stats["fused"] is False
    return got


def test_parity_zaki():
    assert_parity(ZAKI_DB, 2)


@pytest.mark.parametrize("seed", range(5))
def test_parity_randomized(seed):
    rng = np.random.default_rng(seed)
    db = random_db(rng, n_seq=30, n_items=6, max_itemsets=5, max_set=3)
    assert_parity(db, 3)


def test_parity_synthetic():
    db = synthetic_db(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
                      mean_itemset_size=1.4)
    assert_parity(db, JV.abs_minsup(0.02, len(db)))


def test_parity_multiword():
    db = synthetic_db(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
                      max_itemsets=80)
    assert TV.build_vertical(db).n_words >= 2
    assert_parity(db, JV.abs_minsup(0.5, len(db)), max_pattern_itemsets=3)


def test_parity_tiny_pool_exercises_recompute():
    db = synthetic_db(seed=9, n_sequences=200, n_items=25, mean_itemsets=4.0,
                      mean_itemset_size=1.3)
    minsup = JV.abs_minsup(0.03, len(db))
    knobs = dict(pool_bytes=1, node_batch=16, chunk=64, recompute_chunk=8)
    eng = SpadeTorch(TV.build_vertical(db, min_item_support=minsup), minsup,
                     device="cpu", **knobs)
    assert eng.pool_slots <= 64
    got = eng.mine()
    assert eng.stats["recomputed_nodes"] > 0 and eng.stats["reclaimed_slots"] > 0
    ref = SpadeTPU(JV.build_vertical(db, min_item_support=minsup), minsup,
                   **knobs).mine()
    want = mine_spade(db, minsup)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)
    assert patterns_text(ref) == patterns_text(want)


def test_parity_max_itemsets_cap():
    assert_parity(ZAKI_DB, 2, max_pattern_itemsets=2)


def test_empty_and_trivial():
    assert mine_spade_torch(parse_spmf("1 -2\n2 -2\n"), 2, device="cpu") == []
    res = mine_spade_torch(parse_spmf("1 -2\n1 -2\n"), 2, device="cpu")
    assert res == [(((1,),), 2)]
    assert res == mine_spade_tpu(parse_spmf("1 -2\n1 -2\n"), 2, fused="never")


def _merged_snapshot(snaps, k):
    """Snapshot ``k`` with the results of every earlier delta merged in —
    what a checkpoint store hands back on resume."""
    snap = json.loads(json.dumps(snaps[k]))
    snap["results"] = [r for s in snaps[:k + 1] for r in s["results"]]
    snap["results_done"] = 0
    return snap


_CKPT_DB = dict(seed=9, n_sequences=200, n_items=25, mean_itemsets=4.0,
                mean_itemset_size=1.3)


def test_frontier_from_reference_resumes_in_port():
    db = synthetic_db(**_CKPT_DB)
    minsup = JV.abs_minsup(0.03, len(db))
    snaps = []
    SpadeTPU(JV.build_vertical(db, min_item_support=minsup), minsup,
             node_batch=4, pipeline_depth=2).mine(
        checkpoint_cb=snaps.append, checkpoint_every_s=0)
    assert len(snaps) > 4
    snap = _merged_snapshot(snaps, len(snaps) // 2)
    assert snap["stack"], "mid-mine snapshot should hold unexplored nodes"
    eng = SpadeTorch(TV.build_vertical(db, min_item_support=minsup), minsup,
                     device="cpu", node_batch=4)
    got = eng.mine(resume=snap)
    assert eng.stats["resumed_nodes"] == len(snap["stack"])
    want = mine_spade(db, minsup)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)

    class Ckpt:  # the entry point's checkpoint contract
        every_s = 1e9

        def load(self):
            return snap

        def save(self, state):
            pass

    got = mine_spade_torch(db, minsup, device="cpu", checkpoint=Ckpt())
    assert patterns_text(got) == patterns_text(want)


def test_frontier_from_port_resumes_in_reference():
    db = synthetic_db(**_CKPT_DB)
    minsup = JV.abs_minsup(0.03, len(db))
    snaps = []
    SpadeTorch(TV.build_vertical(db, min_item_support=minsup), minsup,
               device="cpu", node_batch=4, pipeline_depth=2).mine(
        checkpoint_cb=snaps.append, checkpoint_every_s=0)
    assert len(snaps) > 4
    snap = _merged_snapshot(snaps, len(snaps) // 3)
    assert snap["stack"]
    ref = SpadeTPU(JV.build_vertical(db, min_item_support=minsup), minsup,
                   node_batch=4)
    got = ref.mine(resume=snap)
    want = mine_spade(db, minsup)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)


def test_fingerprints_agree_across_packages():
    db = synthetic_db(**_CKPT_DB)
    for cap in (None, 3):
        a = SpadeTPU(JV.build_vertical(db, min_item_support=6), 6,
                     max_pattern_itemsets=cap).frontier_fingerprint()
        b = SpadeTorch(TV.build_vertical(db, min_item_support=6), 6,
                       device="cpu",
                       max_pattern_itemsets=cap).frontier_fingerprint()
        assert json.dumps(a) == json.dumps(b)


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        mine_spade_torch(ZAKI_DB, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpadeTorch(TV.build_vertical(ZAKI_DB, min_item_support=2), 2)


@pytest.mark.parametrize("kw", [{"partition_parts": 2}, {"mesh": "local"}])
def test_unported_routes_raise(kw):
    if "mesh" in kw:
        # ported (Queue A item 6): a 1-rank mesh mines what one device does
        from spark_fsm_tpu_torch.parallel.mesh import local_mesh
        mesh = local_mesh("cpu")
        for fused in ("auto", "never", "dense"):
            stats, want_stats = {}, {}
            got = mine_spade_torch(ZAKI_DB, 2, mesh=mesh, fused=fused,
                                   stats_out=stats)
            want = mine_spade_torch(ZAKI_DB, 2, device="cpu", fused=fused,
                                    stats_out=want_stats)
            assert patterns_text(got) == patterns_text(want)
            assert stats["fused"] == want_stats["fused"]
        assert mesh.reduce_stats()["all_reduces"] > 0
        return
    # ported (Queue A item 11): two class slices mine what the reference's
    # partitioned mine and one device mine, for every fused value
    want = patterns_text(mine_spade_torch(ZAKI_DB, 2, device="cpu"))
    for fused in ("auto", "never", "dense", "always", "queue"):
        stats, ref_stats = {}, {}
        got = mine_spade_torch(ZAKI_DB, 2, device="cpu", fused=fused,
                               stats_out=stats, **kw)
        ref = mine_spade_tpu(ZAKI_DB, 2, fused=fused, stats_out=ref_stats,
                             **kw)
        assert patterns_text(got) == patterns_text(ref) == want, fused
        assert stats["fused"] == ref_stats["fused"] == "partitioned"
        assert stats["partition_exchanges"] == 1


def test_shape_buckets_raise():
    # Queue A item 9 is ported: shape_buckets no longer raises, it mines
    # the oracle's patterns (tests/test_torch_shape_buckets.py holds the
    # geometry, routes and stats against the reference)
    got = mine_spade_torch(ZAKI_DB, 2, device="cpu", shape_buckets=True)
    assert patterns_text(got) == patterns_text(mine_spade(ZAKI_DB, 2))


# ------------------------------------------------------------- routing

ROUTING = ("fused", "fused_overflow", "fused_waves", "fused_levels",
           "fused_skipped")
_SYN7 = dict(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
             mean_itemset_size=1.6)
# default caps forced small in both packages: a ring that holds the roots
# but overflows its per-wave emissions, and a ring below the root count
# that queue_eligible refuses; the dense engine overflows in both
_OVERFLOW = {
    "emissions": (dict(nb=16, ring=64, c_cap=32, r_cap=16384),
                  dict(f_cap=16, c_cap=32, r_cap=64, l_max=8)),
    "ring": (dict(nb=16, ring=32, c_cap=32, r_cap=64, i_max=8),
             dict(f_cap=16, c_cap=32, r_cap=64, l_max=8)),
}


class _Ckpt:
    """The entry point's checkpoint contract: nothing to resume, every
    save kept."""

    every_s = 0.0

    def __init__(self):
        self.saved = []

    def load(self):
        return None

    def save(self, state):
        self.saved.append(state)


def _pin_default_caps(monkeypatch, qcaps, fcaps):
    from spark_fsm_tpu.models import spade_fused as JF
    from spark_fsm_tpu.models import spade_queue as JQ
    from spark_fsm_tpu_torch.models import spade_fused as TF
    from spark_fsm_tpu_torch.models import spade_queue as TQ

    for mod in (JQ, TQ):
        monkeypatch.setattr(mod.QueueCaps, "for_budget", classmethod(
            lambda cls, *a, **k: cls(**qcaps)))
    for mod in (JF, TF):
        monkeypatch.setattr(mod.FusedCaps, "for_mesh", classmethod(
            lambda cls, *a, **k: cls(**fcaps)))


@pytest.mark.parametrize("ckpt", [False, True])
@pytest.mark.parametrize("fixture", ["zaki", "emissions", "ring"])
@pytest.mark.parametrize("fused", ["auto", "always", "queue", "dense",
                                   "never"])
def test_routing_keys_equal_reference(monkeypatch, fused, fixture, ckpt):
    if fixture == "zaki":
        db, minsup = ZAKI_DB, 2
    else:
        db, minsup = synthetic_db(**_SYN7), 8
        _pin_default_caps(monkeypatch, *_OVERFLOW[fixture])
    ref_stats, stats = {}, {}
    ref = mine_spade_tpu(db, minsup, fused=fused, stats_out=ref_stats,
                         checkpoint=_Ckpt() if ckpt else None)
    ckpt_obj = _Ckpt() if ckpt else None
    got = mine_spade_torch(db, minsup, device="cpu", fused=fused,
                           stats_out=stats, checkpoint=ckpt_obj)
    assert patterns_text(got) == patterns_text(ref)
    assert ({k: stats[k] for k in ROUTING if k in stats}
            == {k: ref_stats[k] for k in ROUTING if k in ref_stats})
    if fixture == "zaki" and fused in ("auto", "always", "queue"):
        assert stats["fused"] == "queue"
    if fixture != "zaki" and fused != "never":
        # every whole-mine engine tried overflowed, or was skipped for the
        # checkpoint: the classic engine mined
        assert stats["fused"] is False
        assert stats.get("fused_overflow") or stats.get("fused_skipped")
    if ckpt and stats["fused"] == "queue":
        assert ckpt_obj.saved  # the queue engine ran in segments


def test_bad_fused_value_raises():
    with pytest.raises(ValueError):
        mine_spade_torch(ZAKI_DB, 2, device="cpu", fused="sometimes")
