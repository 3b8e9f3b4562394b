"""The port's class partitioning against the reference's, in one process.

``spark_fsm_tpu_torch/parallel/partition.py``'s host half (the class
hash, plans, degraded re-plans and adopters, the threshold board, the
composite checkpoint format) is held against
``spark_fsm_tpu.parallel.partition`` on the same seeded inputs.  Then the
partitioned mines run on ``device="cpu"`` without a mesh (every partition
in turn in this process) against the reference's ``partition_parts``
mines on the fixtures of ``tests/test_partition.py`` and
``tests/test_spam.py``: the text must equal the reference's and the
port's unpartitioned mine, and the stats must equal the reference's key
for key but for the known differences in ``ROADMAP.md`` (``shape_key``,
``wait_s``, and ``kernel_launches`` of the queue engine's slices).
Composite checkpoints resume across the two packages both ways, and a
changed layout restarts fresh.
"""

import json

import numpy as np
import pytest

from spark_fsm_tpu.data.synth import kosarak_like, synthetic_db
from spark_fsm_tpu.data.vertical import abs_minsup
from spark_fsm_tpu.models.spade_constrained import mine_cspade_tpu
from spark_fsm_tpu.models.spade_tpu import mine_spade_tpu
from spark_fsm_tpu.models.spam_bitmap import mine_spam_tpu
from spark_fsm_tpu.models.tsr import mine_tsr_tpu
from spark_fsm_tpu.parallel import partition as JPN
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
from spark_fsm_tpu_torch.models.tsr import TsrTorch, mine_tsr_torch
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import local_mesh
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

# stats the port does not keep as the reference does (ROADMAP.md)
UNSHARED = ("shape_key", "wait_s")


def _db(seed=33, n=300, items=40):
    """``tests/test_partition._db``."""
    return synthetic_db(seed=seed, n_sequences=n, n_items=items,
                        mean_itemsets=5.0, mean_itemset_size=1.4)


def _shared(stats, drop=()):
    return {k: v for k, v in stats.items() if k not in UNSHARED + drop}


def _plan_inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.choice(100000, size=n, replace=False),
            rng.integers(1, 1000, size=n))


def _same_plan(a, b):
    assert (a.n_parts, a.n_classes) == (b.n_parts, b.n_classes)
    assert a.owner.dtype == b.owner.dtype and (a.owner == b.owner).all()
    assert np.array_equal(a.part_costs, b.part_costs)
    assert np.array_equal(a.class_costs, b.class_costs)
    assert a.imbalance_ratio == b.imbalance_ratio
    assert a.fingerprint() == b.fingerprint()


# ------------------------------------------------------------ host half


def test_class_of_equals_reference():
    rng = np.random.default_rng(5)
    ids = np.concatenate([
        rng.integers(0, 2 ** 40, 5000, dtype=np.int64).astype(np.uint64),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63,
                  2 ** 64 - 1], dtype=np.uint64)])
    for n_classes in (1, 2, 7, 64, 1000):
        got = PN.class_of(ids, n_classes)
        assert got.dtype == np.int64
        assert np.array_equal(got, JPN.class_of(ids, n_classes))


@pytest.mark.parametrize("parts,classes", [(1, 1), (2, 64), (3, 64),
                                           (4, 16), (8, 64), (5, 7)])
def test_plan_partitions_equals_reference(parts, classes):
    ids, sups = _plan_inputs(7, 500)
    got = PN.plan_partitions(ids, sups, parts, classes)
    want = JPN.plan_partitions(ids, sups, parts, classes, record=False)
    _same_plan(got, want)
    assert np.array_equal(got.owner_of(ids), want.owner_of(ids))
    roots = list(range(0, 500, 3))
    for p in range(parts):
        assert (got.owned_slice(roots, ids, p)
                == want.owned_slice(roots, ids, p))
    assert got.owned_slice([], ids, 0) == []
    assert PN.tallies()["imbalance"] == got.imbalance_ratio


def test_plan_partitions_refuses_what_the_reference_refuses():
    ids, sups = _plan_inputs(7, 50)
    for parts, classes in ((0, 64), (8, 4)):
        with pytest.raises(ValueError):
            JPN.plan_partitions(ids, sups, parts, classes, record=False)
        with pytest.raises(ValueError):
            PN.plan_partitions(ids, sups, parts, classes)


@pytest.mark.parametrize("seed,n,dead", [
    (11, 400, [1, 3]), (11, 400, [3, 1]), (11, 400, []), (3, 300, [1, 2]),
    (3, 300, [2, 1]), (3, 300, [0])])
def test_replan_and_adopters_equal_reference(seed, n, dead):
    """The degraded re-plan and the adopter map on
    ``tests/test_meshguard.py``'s fixtures."""
    ids, sups = _plan_inputs(seed, n)
    got = PN.plan_partitions(ids, sups, 4, 64, record=False)
    want = JPN.plan_partitions(ids, sups, 4, 64, record=False)
    _same_plan(PN.replan_surviving(got, dead),
               JPN.replan_surviving(want, dead))
    assert PN.adopters_for(got, dead) == JPN.adopters_for(want, dead)
    # a plan without class costs re-plans at uniform cost
    bare = PN.PartitionPlan(4, 64, got.owner, got.part_costs)
    jbare = JPN.PartitionPlan(4, 64, want.owner, want.part_costs)
    a, b = PN.replan_surviving(bare, dead), JPN.replan_surviving(jbare, dead)
    assert (a.owner == b.owner).all()
    assert np.array_equal(a.part_costs, b.part_costs)
    for fn, jfn in ((PN.replan_surviving, JPN.replan_surviving),
                    (PN.adopters_for, JPN.adopters_for)):
        with pytest.raises(ValueError):
            jfn(want, [0, 1, 2, 3])
        with pytest.raises(ValueError):
            fn(got, [0, 1, 2, 3])


@pytest.mark.parametrize("seed", range(4))
def test_threshold_board_equals_reference(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 8))
    floor = int(rng.integers(0, 5))
    got, want = PN.ThresholdBoard(k, floor), JPN.ThresholdBoard(k, floor)
    assert got.floor() == want.floor()
    for _ in range(12):
        sups = rng.integers(1, 60, size=int(rng.integers(0, 6))).tolist()
        assert got.merge(sups) == want.merge(sups)
        assert got.floor() == want.floor()


def test_composite_format_equals_reference():
    pats = [(((1,), (2, 3)), 7), (((4,),), 9)]
    assert PN.encode_patterns(pats) == JPN.encode_patterns(pats)
    rows = json.loads(json.dumps(PN.encode_patterns(pats)))
    assert PN.decode_patterns(rows) == JPN.decode_patterns(rows) == pats
    fp = {"minsup": 3, "partition": {"parts": 2, "classes": 64,
                                     "owner_sum": 30}}
    done = {1: [[[1], [2], 5, 6]], 0: [[[3], [1], 4, 4]]}
    state = {"version": 1, "stack": [], "results": [], "results_done": 0}
    for active in ((None, None), (1, state)):
        got = PN.composite_state(fp, done, *active, m=8, minsup=3)
        want = JPN.composite_state(fp, done, *active, m=8, minsup=3)
        assert json.dumps(got) == json.dumps(want)
        snap = json.loads(json.dumps(got))
        assert PN.decode_composite(snap, fp) == JPN.decode_composite(snap, fp)
    assert PN.decode_composite(snap, dict(fp, minsup=4)) == ({}, {})
    assert PN.decode_composite(None, fp) == ({}, {})
    a, b = {"x": 1}, {"x": 1}
    src = {"x": 2, "y": 1.5, "flag": True, "name": "q", "rows": [1]}
    PN.fold_numeric_stats(a, src)
    JPN.fold_numeric_stats(b, src)
    assert a == b == {"x": 3, "y": 1.5}


def test_device_half_without_a_mesh():
    plan = PN.plan_partitions(*_plan_inputs(1, 40), 3, 8)
    assert PN.submeshes(None, 3) == [None] * 3
    assert PN.submeshes("m", 1) == ["m"]
    assert PN.owned_parts(plan) == [0, 1, 2]
    before = PN.tallies()
    stats = {}
    payload = {"rows": [[[1], [2], 3, 4]], "floor": 2}
    assert PN.exchange_objects(payload, stats=stats) == [payload]
    assert PN.exchange_objects(payload, stats=stats, record=False) == [payload]
    nbytes = len(json.dumps(payload).encode())
    assert stats == {"partition_exchanges": 2,
                     "partition_cross_bytes": 2 * nbytes}
    after = PN.tallies()
    assert after["exchanges"] == before["exchanges"] + 1
    assert after["cross_bytes"] == before["cross_bytes"] + nbytes
    assert after["world_collectives"] == before["world_collectives"]
    # a mesh the rows do not divide: the reference's message
    with pytest.raises(ValueError, match="does not split into 2 equal"):
        PN.submeshes(local_mesh("cpu"), 2)
    assert PN.submeshes(local_mesh("cpu"), 1)[0].size == 1


def test_tsr_roots_owned_once_and_index_checked():
    vdb = build_vertical(_db(), min_item_support=1)
    plan = PN.plan_partitions(vdb.item_ids, vdb.item_supports, 3, 64)
    masks = [TsrTorch(vdb, 5, 0.5, device="cpu",
                      partition=(plan, p))._owned_mask(vdb.n_items)
             for p in range(3)]
    assert (np.sum(masks, axis=0) == 1).all()
    assert TsrTorch(vdb, 5, 0.5, device="cpu")._owned_mask(4) is None
    with pytest.raises(ValueError, match="out of range"):
        TsrTorch(vdb, 5, 0.5, device="cpu", partition=(plan, 3))


# ------------------------------------------------------------ the mines

TSR_CASES = {
    # tests/test_partition.py: config 3 and 3d, the multi-round mine,
    # one-device rows at parts = 4, a partition with no frequent class
    "config3": (lambda: kosarak_like(scale=0.002, fast=True), 100, 0.5,
                dict(max_side=2), 2),
    "config3d": (lambda: kosarak_like(scale=0.002, fast=True), 100, 0.5,
                 dict(max_side=None), 2),
    "multi_round": (_db, 10, 0.4, dict(max_side=2, item_cap=8), 2),
    "resident_rows": (lambda: _db(seed=34), 12, 0.4, dict(max_side=None), 4),
    # the same rows pinned to the resident route: owned root entries and
    # the floor on the device frontier
    "resident_always": (lambda: _db(seed=34), 12, 0.4,
                        dict(max_side=None, resident="always"), 4),
    "zero_root": (lambda: synthetic_db(seed=5, n_sequences=80, n_items=4,
                                       mean_itemsets=3.0,
                                       mean_itemset_size=1.2),
                  5, 0.3, dict(max_side=2), 4),
}


@pytest.mark.parametrize("name", list(TSR_CASES))
def test_tsr_partitioned_equals_reference(name):
    make_db, k, minconf, kw, parts = TSR_CASES[name]
    db = make_db()
    stats, ref_stats = {}, {}
    got = mine_tsr_torch(db, k, minconf, device="cpu", partition_parts=parts,
                         stats_out=stats, **kw)
    ref = mine_tsr_tpu(db, k, minconf, partition_parts=parts,
                       stats_out=ref_stats, **kw)
    one = mine_tsr_torch(db, k, minconf, device="cpu", **kw)
    assert rules_text(got) == j_rules_text(ref) == rules_text(one)
    assert _shared(stats) == _shared(ref_stats)
    assert stats["partition_exchanges"] == stats["deepening_rounds"]
    assert stats["partition_owned"] == list(range(parts))
    if name == "multi_round":
        assert stats["deepening_rounds"] >= 2
    if name == "resident_always":
        # the numeric route counters fold in; the bool "resident" does not
        assert stats["resident_rounds"] == 4 and stats["resident_waves"] > 0


@pytest.mark.parametrize("fused", ["auto", "never", "always", "dense",
                                   "queue"])
def test_spade_partitioned_equals_reference(fused):
    db = _db(seed=21, n=203, items=12)
    ms = abs_minsup(0.06, len(db))
    stats, ref_stats = {}, {}
    got = mine_spade_torch(db, ms, device="cpu", partition_parts=2,
                           fused=fused, stats_out=stats)
    ref = mine_spade_tpu(db, ms, partition_parts=2, fused=fused,
                         stats_out=ref_stats)
    assert patterns_text(got) == j_patterns_text(ref) == patterns_text(
        mine_spade_torch(db, ms, device="cpu"))
    # the queue engine's slices count one B1 launch a wave
    drop = ("kernel_launches",) if fused != "never" else ()
    assert _shared(stats, drop) == _shared(ref_stats, drop)
    assert stats["fused"] == "partitioned" and stats["partition_exchanges"] == 1


def test_spam_partitioned_equals_reference():
    """``tests/test_spam.py``'s partition fixture (16 classes)."""
    db = kosarak_like(scale=0.0003, fast=True)
    ms = abs_minsup(0.03, len(db))
    stats, ref_stats = {}, {}
    got = mine_spam_torch(db, ms, device="cpu", partition_parts=2,
                          partition_classes=16, stats_out=stats)
    ref = mine_spam_tpu(db, ms, partition_parts=2, partition_classes=16,
                        stats_out=ref_stats)
    assert patterns_text(got) == j_patterns_text(ref) == patterns_text(
        mine_spam_torch(db, ms, device="cpu"))
    assert _shared(stats) == _shared(ref_stats)
    assert stats["engine"] == "spam" and stats["partition_classes"] == 16


def test_cspade_partitioned_equals_reference():
    db = _db(seed=21, n=203, items=12)
    ms = abs_minsup(0.06, len(db))
    kw = dict(maxgap=2, maxwindow=5, partition_parts=2, chunk=64,
              node_batch=8, pool_bytes=1 << 20)
    stats, ref_stats = {}, {}
    got = mine_cspade_torch(db, ms, device="cpu", stats_out=stats, **kw)
    ref = mine_cspade_tpu(db, ms, stats_out=ref_stats, **kw)
    assert patterns_text(got) == j_patterns_text(ref) == patterns_text(
        mine_cspade_torch(db, ms, maxgap=2, maxwindow=5, device="cpu"))
    assert _shared(stats) == _shared(ref_stats)


# ---------------------------------------------------------- checkpoints


class Saves:
    """The engines' checkpoint contract: resumes ``state``, keeps every
    snapshot (JSON round-tripped, as a store would hold it)."""

    def __init__(self, state=None, every_s=0.0):
        self.state, self.every_s, self.saved = state, every_s, []

    def load(self):
        return self.state

    def save(self, state):
        self.saved.append(json.loads(json.dumps(state)))


def _mid_part(saved):
    mids = [s for s in saved if s["partition"]["active_part"] is not None
            and s["partition"]["active_state"] is not None
            and s["partition"]["active_state"]["stack"]]
    assert mids, "no mid-part composite was saved"
    return mids[len(mids) // 2]


TSR_CKPT = dict(max_side=2, item_cap=8, partition_parts=2)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_tsr_composite_resumes_across_packages(direction):
    db = _db()
    want = rules_text(mine_tsr_torch(db, 10, 0.4, device="cpu", max_side=2,
                                     item_cap=8))
    src = Saves()
    if direction == "port_to_ref":
        mine_tsr_torch(db, 10, 0.4, device="cpu", checkpoint=src, **TSR_CKPT)
    else:
        mine_tsr_tpu(db, 10, 0.4, checkpoint=src, **TSR_CKPT)
    mid = _mid_part(src.saved)
    assert {"fingerprint", "m", "minsup", "stack", "results"} <= set(
        mid["partition"]["active_state"])
    dst = Saves(mid, every_s=1e9)
    stats = {}
    if direction == "port_to_ref":
        got = j_rules_text(mine_tsr_tpu(db, 10, 0.4, checkpoint=dst,
                                        stats_out=stats, **TSR_CKPT))
    else:
        got = rules_text(mine_tsr_torch(db, 10, 0.4, device="cpu",
                                        checkpoint=dst, stats_out=stats,
                                        **TSR_CKPT))
    assert got == want
    assert stats["resumed_nodes"] == len(mid["partition"]["active_state"][
        "stack"])
    # another layout (32 classes) restarts fresh
    stats = {}
    again = mine_tsr_torch(db, 10, 0.4, device="cpu", checkpoint=dst,
                           partition_classes=32, stats_out=stats, **TSR_CKPT)
    assert rules_text(again) == want and "resumed_nodes" not in stats


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_spade_composite_resumes_across_packages(direction):
    db = _db(seed=21, n=203, items=12)
    ms = abs_minsup(0.06, len(db))
    want = patterns_text(mine_spade_torch(db, ms, device="cpu"))
    src = Saves()
    if direction == "port_to_ref":
        got = mine_spade_torch(db, ms, device="cpu", partition_parts=2,
                               checkpoint=src)
    else:
        got = mine_spade_tpu(db, ms, partition_parts=2, checkpoint=src)
    assert (patterns_text(got) if direction == "port_to_ref"
            else j_patterns_text(got)) == want
    # a part boundary: the first part's slice done, the second to mine
    boundary = next(s for s in src.saved
                    if len(s["partition"]["done"]) == 1
                    and s["partition"]["active_part"] is None)
    dst = Saves(boundary, every_s=1e9)
    if direction == "port_to_ref":
        got = j_patterns_text(mine_spade_tpu(db, ms, partition_parts=2,
                                             checkpoint=dst))
    else:
        got = patterns_text(mine_spade_torch(db, ms, device="cpu",
                                             partition_parts=2,
                                             checkpoint=dst))
    assert got == want
    # another layout restarts fresh
    assert patterns_text(mine_spade_torch(
        db, ms, device="cpu", partition_parts=2, partition_classes=32,
        checkpoint=dst)) == want


@pytest.mark.parametrize("fused", ["auto", "never"])
def test_spade_mid_slice_composite_resumes(fused):
    """The port nests the active slice's frontier with all of the
    slice's results so far (the engine's delta snapshots merged), so a
    composite taken mid-slice resumes in either package."""
    db = _db(seed=21, n=203, items=12)
    ms = abs_minsup(0.06, len(db))
    want = patterns_text(mine_spade_torch(db, ms, device="cpu"))
    src = Saves()
    mine_spade_torch(db, ms, device="cpu", partition_parts=2, fused=fused,
                     checkpoint=src, node_batch=4)
    mid = _mid_part(src.saved)
    assert mid["partition"]["active_state"]["results_done"] == 0
    assert mid["partition"]["active_state"]["stack"]
    dst = Saves(mid, every_s=1e9)
    assert patterns_text(mine_spade_torch(
        db, ms, device="cpu", partition_parts=2, fused=fused,
        checkpoint=dst)) == want
    assert j_patterns_text(mine_spade_tpu(
        db, ms, partition_parts=2, fused=fused, checkpoint=dst)) == want


def test_spam_and_spade_composites_interchange():
    """The partitioned SPAM and SPADE composites share one fingerprint,
    so each route resumes the other's."""
    db = _db(seed=21, n=203, items=12)
    ms = abs_minsup(0.06, len(db))
    want = patterns_text(mine_spade_torch(db, ms, device="cpu"))
    src = Saves()
    mine_spam_torch(db, ms, device="cpu", partition_parts=2, checkpoint=src,
                    node_batch=4)
    mid = _mid_part(src.saved)
    assert patterns_text(mine_spade_torch(
        db, ms, device="cpu", partition_parts=2, fused="never",
        checkpoint=Saves(mid, every_s=1e9))) == want
