"""Port parity for the queue engine (``models/spade_queue.py``):
``QueueSpadeTorch`` on the CPU against the reference's ``QueueSpadeTPU``
(its jnp path) and the oracle on ``tests/test_spade_queue.py``'s
fixtures, with the caps pinned so the counters compare; the routing
answers (``queue_eligible``, ``QueueCaps.for_budget``); and frontier
snapshots moving between the two packages' queue and classic engines."""

import json

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.spmf import parse_spmf
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models.oracle import mine_spade, mine_spade_vertical
from spark_fsm_tpu.models.spade_tpu import SpadeTPU
from spark_fsm_tpu.utils.canonical import diff_patterns, patterns_text
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import spade_queue as TQ
from spark_fsm_tpu_torch.models._common import nonzero_static
from spark_fsm_tpu_torch.models.spade import SpadeTorch

ZAKI = "1 -1 2 -1 3 -2\n1 4 -1 3 -2\n1 -1 2 -1 3 4 -2\n1 3 -1 5 -2\n"
CPU = torch.device("cpu")
# the reference's test geometries, reused so its compiles are shared
SMALL = dict(nb=32, ring=512, c_cap=2048, r_cap=16384)
SPLIT = dict(nb=16, ring=4096, c_cap=4096, r_cap=1 << 16)
TINY = dict(nb=16, ring=32, c_cap=32, r_cap=64, i_max=8)
COUNTERS = ("waves", "late_waves", "candidates", "patterns")

_SYN7 = dict(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
             mean_itemset_size=1.6)
_SYN9 = dict(seed=9, n_sequences=200, n_items=25, mean_itemsets=4.0,
             mean_itemset_size=2.5)
_SYN21 = dict(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
              mean_itemset_size=1.3)
_RING = dict(seed=13, n_sequences=60, n_items=40, mean_itemsets=6.0,
             mean_itemset_size=2.0, correlation=0.8)


def both(db, minsup, caps, max_its=None):
    """The same mine through both packages' queue engines."""
    ref = JQ.QueueSpadeTPU(JV.build_vertical(db, min_item_support=minsup),
                           minsup, caps=JQ.QueueCaps(**caps),
                           max_pattern_itemsets=max_its)
    port = TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=minsup),
                              minsup, device="cpu",
                              caps=TQ.QueueCaps(**caps),
                              max_pattern_itemsets=max_its)
    return ref, ref.mine(), port, port.mine()


def assert_same(ref, want, port, got, oracle_text=None):
    assert (want is None) == (got is None)
    if want is not None:
        assert patterns_text(got) == patterns_text(want), \
            diff_patterns(want, got)
        if oracle_text is not None:
            assert patterns_text(got) == oracle_text
    for key in COUNTERS:
        assert port.stats.get(key, 0) == ref.stats.get(key, 0), key
    assert port.stats.get("fused_overflow") == ref.stats.get("fused_overflow")


def test_parity_zaki():
    db = parse_spmf(ZAKI)
    ref, want, port, got = both(db, 2, SMALL)
    assert_same(ref, want, port, got, patterns_text(mine_spade(db, 2)))
    assert port.stats["waves"] > 0 and port.stats["candidates"] > 0
    assert port.stats["kernel_launches"] == port.stats["waves"]
    assert port.stats["fused"] == "queue"


@pytest.mark.parametrize("kw,minsup,caps", [
    (_SYN7, 8, SMALL), (_SYN9, 10, SMALL),
    (_SYN21, 6, {}),            # wide levels, the default caps
    (_SYN21, 6, SPLIT),         # nb far below the roots: waves split levels
])
def test_parity_synthetic(kw, minsup, caps):
    db = synthetic_db(**kw)
    ref, want, port, got = both(db, minsup, caps)
    assert_same(ref, want, port, got, patterns_text(mine_spade(db, minsup)))
    if caps is SPLIT:
        assert port.stats["waves"] > 8
    if not caps:  # the default nb = 512 has a late-wave ladder
        assert port.nb_late < port.caps.nb and port.stats["late_waves"] > 0


def test_parity_multiword():
    db = synthetic_db(seed=8, n_sequences=120, n_items=12,
                      mean_itemsets=40.0, mean_itemset_size=1.2)
    ref, want, port, got = both(db, 90, dict(nb=64, ring=4096, c_cap=8192,
                                             r_cap=1 << 17))
    assert port.n_words > 1
    assert_same(ref, want, port, got, patterns_text(mine_spade(db, 90)))


def test_max_pattern_itemsets():
    db = synthetic_db(**_SYN9)
    ref, want, port, got = both(db, 10, SMALL, max_its=2)
    want_o = mine_spade_vertical(JV.build_vertical(db, min_item_support=10),
                                 10, max_pattern_itemsets=2)
    assert_same(ref, want, port, got, patterns_text(want_o))


def test_overflow_returns_none():
    ref, want, port, got = both(synthetic_db(**_SYN7), 8, TINY)
    assert got is None and port.stats["fused_overflow"]
    assert_same(ref, want, port, got)


def test_ring_overflow_is_detected_not_corrupted():
    db = synthetic_db(**_RING)
    vdb = TV.build_vertical(db, min_item_support=2)
    n_roots = int((vdb.item_supports >= 2).sum())
    tight = dict(nb=16, ring=max(64, ((n_roots + 15) // 16) * 16),
                 c_cap=4096, r_cap=1 << 16)
    ref, want, port, got = both(db, 2, tight)
    assert got is None and port.stats["fused_overflow"]
    assert_same(ref, want, port, got)
    wide = TQ.QueueSpadeTorch(vdb, 2, device="cpu", caps=TQ.QueueCaps(
        nb=64, ring=16384, c_cap=8192, r_cap=1 << 17))
    assert patterns_text(wide.mine()) == patterns_text(mine_spade(db, 2))


def test_store_survives_repeat_mines():
    db = synthetic_db(**_SYN9)
    eng = TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=10), 10,
                             device="cpu", caps=TQ.QueueCaps(**SMALL))
    items = eng.store[:eng.ni_pad].clone()
    first, second = eng.mine(), eng.mine()
    assert first is not None and patterns_text(first) == patterns_text(second)
    assert torch.equal(eng.store[:eng.ni_pad], items)
    assert not eng.store[eng.ni_pad + eng.caps.ring].any()  # scratch row


def test_empty_and_single():
    for text, want in (("1 -2\n1 -2\n", [(((1,),), 2)]), ("1 -2\n", [])):
        db = parse_spmf(text)
        eng = TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=2), 2,
                                 device="cpu", caps=TQ.QueueCaps(**SMALL))
        assert eng.mine() == want


def test_eligibility_and_caps_equal_reference():
    class FakeVdb:
        n_items = 5
        n_sequences = 4
        n_words = 1

    cases = []
    for n_items, n_seq, n_words in ((5, 4, 1), (40, 400, 1), (360, 77_500, 1),
                                    (1000, 10_000, 2), (1025, 100, 1),
                                    (5000, 100, 1), (17, 300_000_000, 1),
                                    (300, 2_000_000, 3)):
        v = FakeVdb()
        v.n_items, v.n_sequences, v.n_words = n_items, n_seq, n_words
        cases.append(v)
    for v in cases:
        assert TQ.queue_eligible(v, CPU) == JQ.queue_eligible(v), vars(v)
    assert TQ.queue_eligible(cases[0], CPU)
    assert not TQ.queue_eligible(cases[5], CPU)  # a Kosarak-scale alphabet
    assert not TQ.queue_eligible(cases[6], CPU)  # a huge store
    db = parse_spmf(ZAKI)
    assert TQ.queue_eligible(TV.build_vertical(db, min_item_support=2), CPU)
    for row in (16, 80_000 * 4, 310_016, 4_000_000):
        for ni_pad in (128, 384, 1024):
            for budget in (1 << 20, 1 << 30, 8 << 30, int(0.45 * 80.8e9)):
                a = TQ.QueueCaps.for_budget(row, ni_pad, budget)
                b = JQ.QueueCaps.for_budget(row, ni_pad, budget)
                assert vars(a) == vars(b), (row, ni_pad, budget)
                assert (TQ.working_set_bytes(a, row, ni_pad)
                        == JQ.working_set_bytes(b, row, ni_pad))
    # the headline's geometry: ring 32,768 fits 45 % of an H100's budget
    h100 = TQ.QueueCaps.for_budget(310_016, 384, int(0.45 * 80.8e9))
    assert h100.ring == 32768
    for nb in (16, 32, 100, 512, 1000):
        a, b = TQ.QueueCaps(nb=nb), JQ.QueueCaps(nb=nb)
        assert vars(a) == vars(b)


def test_nonzero_static_equals_jnp():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for n, p, size in ((50, 0.3, 8), (50, 0.3, 64), (7, 0.0, 4), (9, 1.0, 9)):
        m = rng.random(n) < p
        got = nonzero_static(torch.from_numpy(m), size, -5)
        (want,) = jnp.nonzero(jnp.asarray(m), size=size, fill_value=-5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ checkpoints

_CKPT_CAPS = dict(nb=16, ring=4096, c_cap=4096, r_cap=1 << 16)


def _merged(snaps, k):
    """Snapshot ``k`` with every earlier delta's results merged in."""
    snap = json.loads(json.dumps(snaps[k]))
    snap["results"] = [r for s in snaps[:k + 1] for r in s["results"]]
    snap["results_done"] = 0
    return snap


@pytest.fixture(scope="module")
def ckpt_db():
    db = synthetic_db(**_SYN21)
    return db, 6, patterns_text(mine_spade(db, 6))


def _port_queue(db, minsup):
    return TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=minsup),
                              minsup, device="cpu",
                              caps=TQ.QueueCaps(**_CKPT_CAPS))


def _ref_queue(db, minsup):
    return JQ.QueueSpadeTPU(JV.build_vertical(db, min_item_support=minsup),
                            minsup, caps=JQ.QueueCaps(**_CKPT_CAPS))


def test_segmented_mine_equals_reference(ckpt_db):
    """Checkpointed mines run in segments of 1, 4, 16, ... waves; both
    packages take the same snapshots at the same waves."""
    db, minsup, text = ckpt_db
    port_snaps, ref_snaps = [], []
    port, ref = _port_queue(db, minsup), _ref_queue(db, minsup)
    got = port.mine(checkpoint_cb=port_snaps.append, checkpoint_every_s=0)
    want = ref.mine(checkpoint_cb=ref_snaps.append, checkpoint_every_s=0)
    assert patterns_text(got) == patterns_text(want) == text
    for key in COUNTERS + ("checkpoints",):
        assert port.stats.get(key, 0) == ref.stats.get(key, 0), key
    assert len(port_snaps) > 2
    assert json.dumps(port_snaps) == json.dumps(ref_snaps)


@pytest.mark.parametrize("k", [0, 2])
def test_port_snapshot_resumes_in_reference_engines(ckpt_db, k):
    db, minsup, text = ckpt_db
    snaps = []
    _port_queue(db, minsup).mine(checkpoint_cb=snaps.append,
                                 checkpoint_every_s=0)
    snap = _merged(snaps, k)
    assert snap["stack"]
    vdb = JV.build_vertical(db, min_item_support=minsup)
    assert patterns_text(SpadeTPU(vdb, minsup).mine(resume=snap)) == text
    assert patterns_text(_ref_queue(db, minsup).mine(resume=snap)) == text


@pytest.mark.parametrize("k", [0, 2])
def test_reference_snapshot_resumes_in_port_engines(ckpt_db, k):
    db, minsup, text = ckpt_db
    snaps = []
    _ref_queue(db, minsup).mine(checkpoint_cb=snaps.append,
                                checkpoint_every_s=0)
    snap = _merged(snaps, k)
    assert snap["stack"]
    eng = _port_queue(db, minsup)
    assert patterns_text(eng.mine(resume=snap)) == text
    assert eng.stats["resumed_nodes"] == len(snap["stack"])
    vdb = TV.build_vertical(db, min_item_support=minsup)
    assert patterns_text(SpadeTorch(vdb, minsup, device="cpu").mine(
        resume=snap)) == text


def test_classic_snapshot_resumes_in_both_queue_engines(ckpt_db):
    db, minsup, text = ckpt_db
    snaps = []
    SpadeTorch(TV.build_vertical(db, min_item_support=minsup), minsup,
               device="cpu", node_batch=4, pipeline_depth=2).mine(
        checkpoint_cb=snaps.append, checkpoint_every_s=0)
    snap = _merged(snaps, len(snaps) // 2)
    assert snap["stack"]
    assert patterns_text(_port_queue(db, minsup).mine(resume=snap)) == text
    assert patterns_text(_ref_queue(db, minsup).mine(resume=snap)) == text


def test_snapshot_past_the_ring_falls_back(ckpt_db):
    """A snapshot with more live nodes than the ring does not fit: the
    queue engine refuses it and the classic engine resumes it."""
    db, minsup, text = ckpt_db
    snaps = []
    SpadeTorch(TV.build_vertical(db, min_item_support=minsup), minsup,
               device="cpu", node_batch=4).mine(
        checkpoint_cb=snaps.append, checkpoint_every_s=0)
    snap = _merged(snaps, 0)
    ring = max(16, len(snap["stack"]) // 2)
    small = TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=minsup),
                               minsup, device="cpu",
                               caps=TQ.QueueCaps(nb=16, ring=ring))
    assert len(snap["stack"]) > ring
    assert small.mine(resume=snap) is None
    assert small.stats["fused_overflow"]
