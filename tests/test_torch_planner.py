"""The port's copies for SPAM's planner and hybrid store against the
reference modules they copy: ``rep_plan``, ``dataset_stats``,
``idlist_join_support`` and the id-list view of ``VerticalDB``, and the
planner's ``choose_representation`` and ``choose_patterns_engine``
routing table, with the reference's ``[planner]`` defaults."""

import dataclasses

import numpy as np
import pytest

from spark_fsm_tpu import config as JCFG
from spark_fsm_tpu.data import synth as JS
from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.ops import bitops_np as JBN
from spark_fsm_tpu.service import planner as JP
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.service import planner as TP


def _db_mixed():
    return JS.synthetic_db(seed=401, n_sequences=90, n_items=24,
                           mean_itemsets=4.0, mean_itemset_size=1.3,
                           zipf_s=2.2)


def _dbs():
    return [_db_mixed(), JS.msnbc_like(scale=0.0005),
            JS.bms_webview2_like(scale=0.01),
            JS.synthetic_db(seed=8, n_sequences=120, n_items=12,
                            mean_itemsets=40.0, max_itemsets=80),
            JS.sub_crossover_db()]


def test_planner_defaults_equal_the_reference_config():
    ref = JCFG.PlannerConfig()
    assert TP.DENSITY_CROSSOVER == ref.density_crossover
    assert TP.MAX_ALPHABET == ref.max_alphabet
    assert TP.REPRESENTATION == ref.representation
    assert TP.DIFFSET_DEPTH == ref.diffset_depth


@pytest.mark.parametrize("minsup", [1, 2, 5, 40])
def test_dataset_stats_equal_reference(minsup):
    for db in _dbs():
        got = TV.dataset_stats(db, min_item_support=minsup)
        want = JV.dataset_stats(db, min_item_support=minsup)
        assert dataclasses.asdict(got) == want.as_dict()
    assert TV.dataset_stats([]) == TV.DatasetStats(0, 0, 0, 0, 0, 0.0, 1, 0.0)


@pytest.mark.parametrize("pin", ["auto", "bitmap", "idlist"])
@pytest.mark.parametrize("crossover", [0.02, 0.3, 0.5])
def test_rep_plan_equals_reference(pin, crossover):
    rng = np.random.default_rng(3)
    sup = rng.integers(1, 100, 57)
    got = TV.rep_plan(sup, 120, crossover=crossover, pin=pin)
    want = JV.rep_plan(sup, 120, crossover=crossover, pin=pin)
    np.testing.assert_array_equal(got.rep, want.rep)
    np.testing.assert_array_equal(got.densities, want.densities)
    assert (got.pin, got.crossover, got.n_dense, got.n_sparse) == (
        want.pin, want.crossover, want.n_dense, want.n_sparse)


def test_rep_plan_refuses_an_unknown_pin():
    with pytest.raises(ValueError, match="representation"):
        TV.rep_plan(np.array([3]), 10, crossover=0.1, pin="dense")


@pytest.mark.parametrize("kw", [{}, {"pin": "bitmap"}, {"pin": "idlist"},
                                {"crossover": 0.5},
                                {"crossover": 0.5, "diffset_depth": 0},
                                {"diffset_depth": 1}])
def test_choose_representation_equals_reference(kw):
    vdb = JV.build_vertical(_db_mixed(), min_item_support=7)
    got, dd = TP.choose_representation(vdb.item_supports, vdb.n_sequences, **kw)
    want, ref_dd = JP.choose_representation(vdb.item_supports,
                                            vdb.n_sequences, **kw)
    assert dd == ref_dd
    np.testing.assert_array_equal(got.rep, want.rep)
    assert (got.pin, got.crossover) == (want.pin, want.crossover)


def test_patterns_routing_table_equals_reference():
    rows = []
    for db in _dbs():
        for minsup in (1, 2, 5, 40):
            rows.append(JV.dataset_stats(db, min_item_support=minsup))
    rows += [JV.DatasetStats(100, 400, 900, a, 9, 4.0, 1, d)
             for a in (0, 17, 512, 513, 4000)
             for d in (0.0, 0.0199, 0.02, 0.5, 1.0)]
    seen = set()
    pcfg = JCFG.PlannerConfig()
    for st in rows:
        want = JP.choose_patterns_engine(st, pcfg)
        got = TP.choose_patterns_engine(TV.DatasetStats(**st.as_dict()))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        seen.add(got.engine)
    assert seen == {"SPAM_TPU", "SPADE_TPU"}


def test_idlists_and_idlist_join_equal_reference():
    db = _db_mixed()
    jv = JV.build_vertical(db, min_item_support=2)
    tv = TV.build_vertical(db, min_item_support=2)
    np.testing.assert_array_equal(tv.idlist_lengths(), jv.idlist_lengths())
    rng = np.random.default_rng(9)
    bm = jv.bitmaps
    for i in range(tv.n_items):
        for got, want in zip(tv.idlist(i), jv.idlist(i)):
            np.testing.assert_array_equal(got, want)
        for trial in range(3):
            prefix = bm[rng.integers(tv.n_items)]
            if trial:
                prefix = JBN.sext_transform(prefix)
            got = TV.idlist_join_support(prefix, *tv.idlist(i))
            assert got == JV.idlist_join_support(prefix, *jv.idlist(i))
            assert got == int(JBN.support(prefix & bm[i]))
