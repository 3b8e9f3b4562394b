"""Port parity for the slice as a whole: ``mine_spade_torch`` on the CPU
against the reference oracle and the reference classic engine
(``mine_spade_tpu(..., fused="never")``) on the ``tests/test_spade_tpu.py``
fixtures, frontier snapshots resumed across the two packages, and the
entry point's device and routing rules."""

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
    want = mine_spade(db, minsup, max_pattern_itemsets=max_pattern_itemsets)
    ref = mine_spade_tpu(db, minsup, max_pattern_itemsets=max_pattern_itemsets,
                         fused="never")
    stats = {}
    got = mine_spade_torch(db, minsup, device="cpu",
                           max_pattern_itemsets=max_pattern_itemsets,
                           stats_out=stats, **kw)
    text = patterns_text(want)
    assert patterns_text(got) == text, diff_patterns(want, got)
    assert patterns_text(ref) == text
    assert patterns_text(TO.mine_spade(db, minsup, max_pattern_itemsets)) == text
    if want:
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


@pytest.mark.parametrize("kw", [{"fused": "queue"}, {"fused": "dense"},
                                {"fused": "always"}, {"partition_parts": 2},
                                {"mesh": object()}])
def test_unported_routes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mine_spade_torch(ZAKI_DB, 2, device="cpu", **kw)


def test_bad_fused_value_raises():
    with pytest.raises(ValueError):
        mine_spade_torch(ZAKI_DB, 2, device="cpu", fused="sometimes")
