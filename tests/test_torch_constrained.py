"""Port parity for constrained SPADE (cSPADE): the max-start ops
(``ops/maxstart_torch.py``) against the reference's ``maxstart_jax`` and
``maxstart_np``; the copied oracles; ``mine_cspade_torch(device="cpu")``
against the copied oracle on ``tests/test_constrained.py``'s fixtures,
and ``ConstrainedSpadeTorch`` against the reference's
``ConstrainedSpadeTPU`` at pinned geometries (pattern text and stats);
snapshots across the two packages; the refused options; and the
planner's constrained branch."""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_fsm_tpu import config as JCFG
from spark_fsm_tpu.data import synth as JS
from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.models import oracle as JO
from spark_fsm_tpu.models import spade_constrained as JC
from spark_fsm_tpu.ops import maxstart_jax as MJ
from spark_fsm_tpu.ops import maxstart_np as JMS
from spark_fsm_tpu.service import planner as JP
from spark_fsm_tpu.service.model import ServiceRequest
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu_torch.data import synth as TS
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import oracle as TO
from spark_fsm_tpu_torch.models import spade_constrained as TC
from spark_fsm_tpu_torch.ops import maxstart_masks as MM
from spark_fsm_tpu_torch.ops import maxstart_np as TMS
from spark_fsm_tpu_torch.ops import maxstart_torch as MT
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.service import planner as TP
from spark_fsm_tpu_torch.utils.canonical import diff_patterns, patterns_text
from tests.test_constrained import CONFIGS
from tests.test_oracle import ZAKI_DB, random_db


def _words(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _states(seed, *shape, dtype=np.int16):
    rng = np.random.default_rng(seed)
    hi = min(shape[-1], 127)
    return rng.integers(-1, hi, size=shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_expand_bits_and_root_state_equal_reference(n_words):
    w = _words(n_words, 4, 6, n_words)
    want = JMS.expand_bits(w)
    np.testing.assert_array_equal(np.asarray(MJ.expand_bits(jnp.asarray(w))),
                                  want)
    np.testing.assert_array_equal(MT.expand_bits(_t(w)).numpy(), want)
    root = MT.root_state(_t(w))
    assert root.dtype == torch.int16
    np.testing.assert_array_equal(root.numpy(), JMS.root_state(w))
    np.testing.assert_array_equal(root.numpy(),
                                  np.asarray(MJ.root_state(jnp.asarray(w))))
    if n_words <= 3:
        np.testing.assert_array_equal(
            MT.root_state(_t(w), torch.int8).numpy(), JMS.root_state(w))


@pytest.mark.parametrize("maxgap", [None, 0, 1, 2, 3, 31, 64, 100])
@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_prev_max_equals_reference(maxgap, dtype):
    m = _states(5, 4, 6, 64, dtype=dtype)
    got = MT.prev_max(torch.from_numpy(m), maxgap)
    assert got.dtype == torch.from_numpy(m).dtype
    want = JMS.prev_max(m, maxgap)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(MJ.prev_max(jnp.asarray(m.astype(np.int16)),
                                            maxgap)))


@pytest.mark.parametrize("maxgap", [None, 1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_s_and_i_extend_equal_reference(maxgap, dtype):
    m = _states(7, 4, 6, 64, dtype=dtype)
    w = _words(8, 4, 6, 2)
    mj = jnp.asarray(m.astype(np.int16))
    s = MT.s_extend(torch.from_numpy(m), _t(w), maxgap)
    i = MT.i_extend(torch.from_numpy(m), _t(w))
    assert s.dtype == i.dtype == torch.from_numpy(m).dtype
    np.testing.assert_array_equal(s.numpy(), JMS.s_extend(m, w, maxgap))
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(MJ.s_extend(mj, jnp.asarray(w), maxgap)))
    np.testing.assert_array_equal(i.numpy(), JMS.i_extend(m, w))
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(MJ.i_extend(mj, jnp.asarray(w))))


@pytest.mark.parametrize("maxwindow", [None, 0, 1, 5, 63, 64, 126, 200])
@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_support_with_window_equals_reference(maxwindow, dtype):
    m = _states(9, 4, 6, 64, dtype=dtype)
    got = MT.support(torch.from_numpy(m), maxwindow)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), JMS.support(
        m.astype(np.int16), maxwindow))
    np.testing.assert_array_equal(got.numpy(), np.asarray(MJ.support(
        jnp.asarray(m.astype(np.int16)), maxwindow)))


def test_copied_numpy_ops_equal_reference():
    m = _states(11, 3, 5, 64)
    w = _words(12, 3, 5, 2)
    for g in (None, 1, 3):
        np.testing.assert_array_equal(TMS.prev_max(m, g), JMS.prev_max(m, g))
        np.testing.assert_array_equal(TMS.s_extend(m, w, g),
                                      JMS.s_extend(m, w, g))
    for win in (None, 0, 5):
        np.testing.assert_array_equal(TMS.support(m, win),
                                      JMS.support(m, win))
    np.testing.assert_array_equal(TMS.root_state(w), JMS.root_state(w))
    np.testing.assert_array_equal(TMS.i_extend(m, w), JMS.i_extend(m, w))


@pytest.mark.parametrize("maxwindow", [None, 0, 3, "past"])
@pytest.mark.parametrize("maxgap", [None, 1, 2, "past"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_window_masks_through_b1_equal_child_supports(dtype, maxgap,
                                                      maxwindow):
    """A candidate's windowed support from its parent's window mask and
    B1 (both plain) equals ``MS.support`` of the engine's child state,
    for every (node, item, s/i) candidate, over a ragged sequence axis."""
    n_words = 3 if dtype == torch.int8 else 5
    n_pos, nb, S, n_items = 32 * n_words, 3, 37, 6
    maxgap = n_pos + 4 if maxgap == "past" else maxgap
    maxwindow = n_pos + 4 if maxwindow == "past" else maxwindow
    rng = np.random.default_rng(41)
    # sparse items (a bit in 16) and states that start 0..8 positions back
    # where a pattern ends (one position in 5)
    words = _t(np.bitwise_and.reduce(
        rng.integers(0, 2**32, (4, n_items, S, n_words), dtype=np.uint32)))
    pos = np.arange(n_pos)
    starts = np.maximum(pos - rng.integers(0, 9, (nb, S, n_pos)), 0)
    m = torch.from_numpy(np.where(rng.random((nb, S, n_pos)) < 0.2, starts,
                                  -1)).to(dtype)
    pm = MT.prev_max(m, maxgap)
    ref = np.repeat(np.arange(nb), 2 * n_items)
    item = np.tile(np.arange(n_items), 2 * nb)
    iss = np.tile(np.repeat([True, False], n_items), nb)
    engine = types.SimpleNamespace(_words=words)
    child = TC.ConstrainedSpadeTorch._child(
        engine, m, pm, torch.from_numpy(ref), torch.from_numpy(item),
        torch.from_numpy(iss))
    want = MT.support(child, maxwindow)
    assert want.max() > 0 and want.min() < S   # the cases are not trivial
    masks = MM.window_masks_plain(m, pm, maxwindow, n_words)
    assert masks.shape == (2 * nb, S * n_words)
    got = PS.batch_supports_plain(
        masks, words.view(n_items, -1), n_items,
        torch.from_numpy(2 * ref + np.where(iss, 0, 1)),
        torch.from_numpy(item), n_words)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    torch.testing.assert_close(MM.window_masks(m, pm, maxwindow, n_words),
                               masks, rtol=0, atol=0)


def test_state_dtype_and_gazelle_like_equal_reference():
    assert MT.state_dtype(96) == torch.int8
    assert MT.state_dtype(128) == torch.int16
    for fast in (False, True):
        assert TS.gazelle_like(scale=0.01, fast=fast) == \
            JS.gazelle_like(scale=0.01, fast=fast)


# ----------------------------------------------------------- the oracles


@pytest.mark.parametrize("maxgap,maxwindow", CONFIGS)
def test_copied_oracles_equal_reference(maxgap, maxwindow):
    rng = np.random.default_rng(42)
    db = random_db(rng, n_seq=14, n_items=5, max_itemsets=5, max_set=2)
    got = TO.mine_cspade(db, 3, maxgap=maxgap, maxwindow=maxwindow)
    assert patterns_text(got) == j_patterns_text(
        JO.mine_cspade(db, 3, maxgap=maxgap, maxwindow=maxwindow))
    assert patterns_text(TO.brute_force_mine_constrained(
        db, 3, maxgap=maxgap, maxwindow=maxwindow, max_pattern_itemsets=6,
        max_itemset_size=4)) == patterns_text(got)
    for seq in db:
        for pat in (((1,), (3,)), ((2,), (1, 4)), ((1,), (2,), (3,))):
            assert TO.contains_constrained(seq, pat, maxgap, maxwindow) == \
                JO.contains_constrained(seq, pat, maxgap, maxwindow)


# ------------------------------------------------------------- the engine


@pytest.mark.parametrize("maxgap,maxwindow", CONFIGS)
def test_engine_equals_oracle(maxgap, maxwindow):
    rng = np.random.default_rng(7)
    db = random_db(rng, n_seq=25, n_items=6, max_itemsets=6, max_set=2)
    want = TO.mine_cspade(db, 3, maxgap=maxgap, maxwindow=maxwindow)
    got = TC.mine_cspade_torch(db, 3, maxgap=maxgap, maxwindow=maxwindow,
                               device="cpu")
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)


def test_engine_unconstrained_equals_spade_oracle():
    assert patterns_text(TC.mine_cspade_torch(ZAKI_DB, 2, device="cpu")) == \
        patterns_text(TO.mine_spade(ZAKI_DB, 2))


def test_engine_gazelle_like_fixture_equals_oracle():
    db = JS.synthetic_db(seed=30, n_sequences=300, n_items=40,
                         mean_itemsets=5.0, mean_itemset_size=1.3)
    minsup = JV.abs_minsup(0.03, len(db))
    want = TO.mine_cspade(db, minsup, maxgap=2, maxwindow=5)
    stats: dict = {}
    got = TC.mine_cspade_torch(db, minsup, maxgap=2, maxwindow=5,
                               device="cpu", stats_out=stats)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)
    # the geometry the mine ran with, as the engine derived it
    vdb = TV.build_vertical(db, min_item_support=minsup)
    geo = TC.cspade_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                             device="cpu")
    assert stats["geometry"] == {
        "dtype": "int8", **{k: geo[k] for k in (
            "chunk", "node_batch", "pool_slots", "recompute_chunk",
            "pipeline_depth")}}


def _pinned_pair(db, minsup, **kw):
    ref = JC.ConstrainedSpadeTPU(JV.build_vertical(db, min_item_support=minsup),
                                 minsup, **kw)
    port = TC.ConstrainedSpadeTorch(
        TV.build_vertical(db, min_item_support=minsup), minsup, device="cpu",
        **kw)
    return ref, port


@pytest.mark.parametrize("case", ["tiny_pool_recompute", "int16"])
def test_engine_at_pinned_geometry_equals_reference_engine(case):
    if case == "tiny_pool_recompute":
        db = JS.synthetic_db(seed=31, n_sequences=150, n_items=20,
                             mean_itemsets=5.0)
        minsup = JV.abs_minsup(0.05, len(db))
        kw = dict(maxgap=3, maxwindow=6, pool_bytes=1, node_batch=8,
                  chunk=32, recompute_chunk=4)
    else:
        db = JS.synthetic_db(seed=33, n_sequences=60, n_items=10,
                             mean_itemsets=100.0, max_itemsets=150)
        minsup = JV.abs_minsup(0.5, len(db))
        kw = dict(maxgap=1, maxwindow=3, max_pattern_itemsets=3,
                  pool_bytes=64 << 20)
    ref, port = _pinned_pair(db, minsup, **kw)
    for attr in ("n_pos", "chunk", "recompute_chunk", "pipeline_depth",
                 "node_batch", "pool_slots"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.dtype == (torch.int16 if case == "int16" else torch.int8)
    want, got = ref.mine(), port.mine()
    assert patterns_text(got) == j_patterns_text(want)
    assert port.stats == ref.stats
    if case == "tiny_pool_recompute":
        assert port.pool_slots <= 32 and port.stats["recomputed_nodes"] > 0


def test_geometry_equals_reference():
    for n_seq, n_words in ((150, 1), (59000, 1), (60, 4), (990000, 3)):
        for pool in (1, 64 << 20, 4 << 30, 26 << 30):
            for kw in ({}, dict(chunk=32, node_batch=8, recompute_chunk=4)):
                got = TC.cspade_geometry(n_seq, 61, n_words,
                                         pool_bytes=pool, **kw)
                want = JC.cspade_geometry(n_seq, 61, n_words,
                                          pool_bytes=pool, **kw)
                for key in ("n_seq", "item_rows", "n_pos", "state_bits",
                            "chunk", "recompute_chunk", "pipeline_depth",
                            "node_batch", "pool_slots"):
                    assert got[key] == want[key], (key, n_seq, pool, kw)


class _Crash(Exception):
    pass


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_resumes_across_packages(direction):
    db = JS.synthetic_db(seed=31, n_sequences=150, n_items=20,
                         mean_itemsets=5.0)
    minsup = JV.abs_minsup(0.05, len(db))
    kw = dict(maxgap=2, maxwindow=5, node_batch=4)
    want = patterns_text(TO.mine_cspade(db, minsup, maxgap=2, maxwindow=5))
    ref, port = _pinned_pair(db, minsup, **kw)
    assert port.frontier_fingerprint() == ref.frontier_fingerprint()
    src = ref if direction == "ref_to_port" else port
    saved = []

    def cb(state):
        saved.append(state)
        if len(saved) == 3:
            raise _Crash

    with pytest.raises(_Crash):
        src.mine(checkpoint_cb=cb, checkpoint_every_s=0.0)
    snap = json.loads(json.dumps(saved[-1]))
    snap["results"] = [r for s in saved for r in s["results"]]
    snap["results_done"] = 0
    assert snap["stack"], "crash came after the frontier emptied"
    ref2, port2 = _pinned_pair(db, minsup, **kw)
    dst = port2 if direction == "ref_to_port" else ref2
    text = patterns_text if dst is port2 else j_patterns_text
    assert text(dst.mine(resume=snap)) == want
    assert dst.stats["resumed_nodes"] == len(snap["stack"])


@pytest.mark.parametrize("kw,what", [
    (dict(mesh="local"), "mesh"),
    (dict(partition_parts=2), "partition"),
    (dict(shape_buckets=True), "shape_buckets"),
])
def test_unported_options_raise(kw, what):
    if what == "mesh":
        # ported (Queue A item 6): a 1-rank mesh mines what one device does
        from spark_fsm_tpu_torch.parallel.mesh import local_mesh
        mesh = local_mesh("cpu")
        got = TC.mine_cspade_torch(ZAKI_DB, 2, maxgap=1, mesh=mesh)
        assert patterns_text(got) == patterns_text(
            TC.mine_cspade_torch(ZAKI_DB, 2, maxgap=1, device="cpu"))
        assert mesh.reduce_stats()["all_reduces"] > 0
        return
    if what == "shape_buckets":
        # ported (Queue A item 9): the bucketed mine equals the oracle's
        got = TC.mine_cspade_torch(ZAKI_DB, 2, maxgap=1, device="cpu", **kw)
        assert patterns_text(got) == j_patterns_text(
            JO.mine_cspade(ZAKI_DB, 2, maxgap=1))
        return
    # ported (Queue A item 11): two class slices mine what the reference's
    # partitioned mine and one device mine, with equal stats
    stats, ref_stats = {}, {}
    got = TC.mine_cspade_torch(ZAKI_DB, 2, maxgap=1, device="cpu",
                               stats_out=stats, **kw)
    ref = JC.mine_cspade_tpu(ZAKI_DB, 2, maxgap=1, stats_out=ref_stats, **kw)
    assert patterns_text(got) == j_patterns_text(ref) == patterns_text(
        TC.mine_cspade_torch(ZAKI_DB, 2, maxgap=1, device="cpu"))
    assert stats == ref_stats


# ------------------------------------------------------------ the planner


def test_planner_constrained_branch_equals_reference():
    pcfg = JCFG.PlannerConfig()
    db = JS.synthetic_db(seed=401, n_sequences=90, n_items=24,
                         mean_itemsets=4.0, mean_itemset_size=1.3, zipf_s=2.2)
    rows = [JV.dataset_stats(db, min_item_support=s) for s in (1, 5)]
    rows += [JV.DatasetStats(100, 400, 900, a, 9, 4.0, 1, d)
             for a in (17, 4000) for d in (0.0, 0.5)]
    for st in rows:
        for constrained in (False, True):
            want = JP.choose_patterns_engine(st, pcfg, constrained=constrained)
            got = TP.choose_patterns_engine(TV.DatasetStats(**st.as_dict()),
                                            constrained=constrained)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            if constrained:
                assert got.engine == "SPADE_TPU"


@pytest.mark.parametrize("engine", ["SPAM_TPU", "SPAM", "SPADE_TPU"])
def test_pinned_constrained_fallback_equals_reference(engine):
    saved = JCFG.get_config()
    JCFG.set_config(dataclasses.replace(saved, planner=JCFG.PlannerConfig(
        mode="pinned", pinned=engine)))
    try:
        for extra in ({}, {"maxgap": "2"}, {"maxwindow": "4"}):
            req = ServiceRequest("fsm", "train", {"algorithm": "AUTO",
                                                  "support": "0.2", **extra})
            want = JP.choose(req, ZAKI_DB)
            got = TP.choose_pinned(engine, "patterns", constrained=bool(extra))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    finally:
        JCFG.set_config(saved)
