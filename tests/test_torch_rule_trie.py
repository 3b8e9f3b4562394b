"""Port parity for prediction scoring (``spark_fsm_tpu_torch/ops/rule_trie.py``
against ``spark_fsm_tpu/ops/rule_trie.py``), on the CPU.

The same seeded rule sets go through both packages' ``build_trie``: every
plane equals the reference's as numpy, and ``nbytes()``, ``stats``,
``digest``, ``F`` and ``D`` are equal.  ``score_wave`` is byte-identical,
as JSON, to the reference's jitted scorer and to ``predict_host`` over
random rule sets with planted ties (the generator of
``tests/test_predict.py``, copied), and on the cases of that file.  The
port's three engines give the reference engines' rule sets and
predictions on ``synthetic_db(seed=21)``, and the payload strings and
their digests are the reference's.
"""

import json
import random

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.data.vertical import abs_minsup
from spark_fsm_tpu.models.spade_tpu import mine_spade_tpu
from spark_fsm_tpu.models.spam_bitmap import mine_spam_tpu
from spark_fsm_tpu.models.tsr import mine_tsr_tpu
from spark_fsm_tpu.ops import rule_trie as R
from spark_fsm_tpu.service import model as RM
from spark_fsm_tpu_torch import (
    build_trie, mine_spade_torch, mine_spam_torch, mine_tsr_torch,
    predict_host, rules_from_patterns, score_wave)
from spark_fsm_tpu_torch.ops import rule_trie as T
from spark_fsm_tpu_torch.service import model as TM
from spark_fsm_tpu_torch.service import predictor as TP


def _json(x):
    return json.dumps(x, sort_keys=True)


def random_rules(rng, n_rules, n_items, *, with_ties=True):
    """Copy of ``tests/test_predict.random_rules``: a random rule list
    with exact (sup, supx) collisions planted, so the (confidence,
    support) comparison exercises the tie-break order."""
    rules = []
    for _ in range(n_rules):
        xlen = rng.randint(1, 3)
        x = tuple(sorted(rng.sample(range(n_items), xlen)))
        rest = [i for i in range(n_items) if i not in x]
        y = tuple(sorted(rng.sample(rest,
                                    rng.randint(1, min(2, len(rest))))))
        supx = rng.randint(1, 12)
        sup = rng.randint(1, supx)
        rules.append((x, y, sup, supx))
    if with_ties and len(rules) >= 4:
        # equal conf AND equal sup on a different consequent: the
        # cross-item tie that falls through to ascending item id
        x, y, sup, supx = rules[0]
        rest = [i for i in range(n_items) if i not in x and i not in y]
        if rest:
            rules[1] = (x, (rest[0],), sup, supx)
        # and an equal-conf different-sup pair (2/4 == 3/6)
        rules[2] = (rules[2][0], rules[2][1], 2, 4)
        rules[3] = (rules[3][0], rules[3][1], 3, 6)
    return rules


def _both(rules, **kw):
    return R.build_trie(rules, **kw), build_trie(rules, device="cpu", **kw)


def _assert_tries_equal(ref, port):
    for f in T.PLANES:
        got = getattr(port, f)
        assert got.dtype == torch.int32 and got.device.type == "cpu", f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(port.h_lane_rule, ref.h_lane_rule)
    np.testing.assert_array_equal(port.h_lane_item, ref.h_lane_item)
    assert port.nbytes() == ref.nbytes()
    assert port.stats == ref.stats
    assert (port.digest, port.F, port.D, port.lanes, port.rules) == (
        ref.digest, ref.F, ref.D, ref.lanes, ref.rules)


def _assert_scores_equal(ref, port, rules, prefixes, m, **kw):
    """The port's wave equals the reference's wave and ``predict_host``
    (both packages'), row for row, as JSON strings."""
    got = score_wave(port, prefixes, m, **kw)
    want = R.score_wave(ref, prefixes, m, **kw)
    assert len(got) == len(prefixes)
    for p, g, w in zip(prefixes, got, want):
        host = predict_host(rules, p, m)
        assert _json(host) == _json(R.predict_host(rules, p, m))
        assert _json(g) == _json(w) == _json(host), (p, m)
    return got


@pytest.mark.parametrize("seed,n_rules,n_items,lanes_floor,depth_floor", [
    (1, 1, 4, 0, 0), (2, 12, 8, 0, 0), (3, 30, 12, 0, 8),
    (4, 40, 10, 256, 16), (5, 7, 5, 1024, 16), (6, 25, 40, 0, 3),
])
def test_planes_stats_and_nbytes_equal_reference(seed, n_rules, n_items,
                                                 lanes_floor, depth_floor):
    rules = random_rules(random.Random(seed), n_rules, n_items)
    rules.append(((1,), (2,), 3, 0))     # supx 0: dropped by both
    _assert_tries_equal(*_both(rules, lanes_floor=lanes_floor,
                               depth_floor=depth_floor))


def test_empty_rule_set_equals_reference():
    ref, port = _both([])
    _assert_tries_equal(ref, port)
    assert score_wave(port, [[], [1]], 4) == R.score_wave(ref, [[], [1]], 4) \
        == [[], []]


@pytest.mark.parametrize("trial", range(12))
def test_score_wave_random_parity(trial):
    rng = random.Random(0xF5A + trial)
    n_items = rng.randint(4, 12)
    rules = random_rules(rng, rng.randint(1, 30), n_items)
    ref, port = _both(rules, depth_floor=8)
    _assert_tries_equal(ref, port)
    prefixes = [sorted(rng.sample(range(n_items),
                                  rng.randint(0, min(6, n_items))))
                for _ in range(4)]
    for m in (1, 3, 8):
        _assert_scores_equal(ref, port, rules, prefixes, m)   # one wave
        for p in prefixes:
            _assert_scores_equal(ref, port, rules, [p], m)     # solo


# the cases of tests/test_predict.py, each scored by both packages


def _case_empty_prefix():
    rules = [((1,), (2,), 3, 4), ((), (5,), 2, 8), ((), (6,), 1, 2)]
    got = _assert_scores_equal(*_both(rules, depth_floor=8), rules, [[]], 8)
    assert [e["item"] for e in got[0]] == [6, 5]   # 0.5 > 0.25


def _case_no_match():
    rules = [((1, 2), (3,), 3, 4), ((4,), (5,), 2, 8)]
    got = _assert_scores_equal(*_both(rules, depth_floor=8), rules, [[9]], 8)
    assert got == [[]]


def _case_observed_never_predicted():
    rules = [((1,), (2, 3), 5, 5)]
    got = _assert_scores_equal(*_both(rules, depth_floor=8), rules,
                               [[1, 2]], 8)
    assert [e["item"] for e in got[0]] == [3]


def _case_topm_tiebreak_truncation():
    # three candidates with identical (conf, sup): ascending item id, and
    # m = 2 keeps the two smallest; (1/2, sup 1) sorts after all three
    rules = [((1,), (7,), 3, 6), ((1,), (5,), 3, 6), ((1,), (9,), 3, 6),
             ((1,), (4,), 1, 2)]
    ref, port = _both(rules, depth_floor=8)
    for m in (1, 2, 3, 8):
        got = _assert_scores_equal(ref, port, rules, [[1]], m)
    assert [e["item"] for e in score_wave(port, [[1]], 3)[0]] == [5, 7, 9]
    assert len(got[0]) == 4


def _case_first_wins():
    # two rules vote for item 5 with identical (conf, sup): the first seen
    # wins, and the entry carries its antecedent
    rules = [((1,), (5,), 2, 4), ((2,), (5,), 2, 4)]
    got = _assert_scores_equal(*_both(rules, depth_floor=8), rules,
                               [[1, 2]], 4)
    assert got[0][0]["antecedent"] == [1]


def _case_wave_fusion_invariant():
    rng = random.Random(7)
    rules = random_rules(rng, 40, 10)
    ref, port = _both(rules, depth_floor=8)
    prefixes = [sorted(rng.sample(range(10), rng.randint(0, 5)))
                for _ in range(7)]
    fused = _assert_scores_equal(ref, port, rules, prefixes, 5)
    padded = _assert_scores_equal(ref, port, rules, prefixes, 5, wave_pad=32)
    for i, p in enumerate(prefixes):
        solo = _assert_scores_equal(ref, port, rules, [p], 5)[0]
        assert _json(fused[i]) == _json(solo) == _json(padded[i])


def _case_floors_do_not_change_bytes():
    rng = random.Random(11)
    rules = random_rules(rng, 12, 8)
    tight = _both(rules, depth_floor=8)
    wide = _both(rules, lanes_floor=256, depth_floor=16)
    for p in ([], [1], [2, 3]):
        a = _assert_scores_equal(*tight, rules, [p], 6)
        b = _assert_scores_equal(*wide, rules, [p], 6)
        assert _json(a) == _json(b)


def _case_rules_from_patterns_prefix_closure():
    pats = [(((1,),), 4), (((1,), (2,)), 3), (((1,), (1, 2)), 2)]
    rules = rules_from_patterns(pats)
    assert rules == R.rules_from_patterns(pats)
    assert ((1,), (2,), 3, 4) in rules
    assert ((1,), (2,), 2, 4) in rules
    _assert_scores_equal(*_both(rules, depth_floor=8), rules, [[1], []], 4)


REFERENCE_CASES = {
    "empty_prefix": _case_empty_prefix,
    "no_match": _case_no_match,
    "observed_never_predicted": _case_observed_never_predicted,
    "topm_tiebreak_truncation": _case_topm_tiebreak_truncation,
    "first_wins": _case_first_wins,
    "wave_fusion_invariant": _case_wave_fusion_invariant,
    "floors_do_not_change_bytes": _case_floors_do_not_change_bytes,
    "rules_from_patterns_prefix_closure":
        _case_rules_from_patterns_prefix_closure,
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case(case):
    REFERENCE_CASES[case]()


@pytest.mark.parametrize("m", [5, 20, 256])
def test_m_wider_than_lanes_returns_at_most_F(m):
    # 3 lanes in F = 4: M = pow2(m) > F, the argsort slice keeps F columns
    rules = [((1,), (2,), 3, 4), ((1,), (3,), 2, 4), ((), (4, 6), 1, 2)]
    ref, port = _both(rules, depth_floor=4)
    assert port.F == 4 and port.lanes == 4
    got = _assert_scores_equal(ref, port, rules, [[1], [], [1, 2]], m)
    assert [len(r) for r in got] == [4, 2, 3]
    assert all(len(r) <= port.F for r in got)


def test_prefix_longer_than_depth_raises_reference_error():
    rules = [((1,), (2,), 3, 4)]
    ref, port = _both(rules, depth_floor=4)
    long = list(range(1, 6))
    with pytest.raises(ValueError) as want:
        R.score_wave(ref, [[1], long], 3)
    with pytest.raises(ValueError) as got:
        score_wave(port, [[1], long], 3)
    assert str(got.value) == str(want.value)
    assert "exceeds trie depth 4" in str(got.value)


def test_support_plane_cross_check_raises():
    rules = [((1,), (2,), 3, 4)]
    port = build_trie(rules, device="cpu")
    port.lane_sup[0] = 2      # a plane that disagrees with the host rule
    with pytest.raises(AssertionError, match="support planes disagree"):
        score_wave(port, [[1]], 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_cuda():
    rules = [((1,), (2,), 3, 4)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trie(rules)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.predict_rules(TM.serialize_rules(rules), "rules", [1], 4)


# ---------------------------------------------------------- engine parity

_DB = dict(seed=21, n_sequences=120, n_items=9, mean_itemsets=4.0)
_PREFIXES = ([], [1], [1, 2], [3, 4, 5], [99], [2, 6], [1, 3, 5, 7])


def _mines(engine, db):
    minsup = abs_minsup(0.1, len(db))     # the reference test's support
    if engine == "TSR":                   # k 25, minconf 0.2
        return (mine_tsr_tpu(db, 25, 0.2),
                mine_tsr_torch(db, 25, 0.2, device="cpu"), "rules")
    if engine == "SPADE":
        return (mine_spade_tpu(db, minsup),
                mine_spade_torch(db, minsup, device="cpu"), "patterns")
    return (mine_spam_tpu(db, minsup),
            mine_spam_torch(db, minsup, device="cpu"), "patterns")


@pytest.mark.parametrize("engine", ["TSR", "SPADE", "SPAM"])
def test_engine_rule_sets_and_predictions_equal_reference(engine):
    db = synthetic_db(**_DB)
    ref_out, port_out, kind = _mines(engine, db)
    assert port_out == ref_out
    if kind == "rules":
        ref_rules, rules = ref_out, port_out
        payload = TM.serialize_rules(rules)
        assert payload == RM.serialize_rules(ref_rules)
        assert TM.deserialize_rules(payload) == RM.deserialize_rules(payload)
    else:
        ref_rules = R.rules_from_patterns(ref_out)
        rules = rules_from_patterns(port_out)
        payload = TM.serialize_patterns(port_out)
        assert payload == RM.serialize_patterns(ref_out)
        assert TM.deserialize_patterns(payload) == RM.deserialize_patterns(payload)
    assert rules == ref_rules and rules, engine
    assert T.rules_digest(payload) == R.rules_digest(payload)
    ref, port = _both(rules, lanes_floor=64, depth_floor=8)
    _assert_tries_equal(ref, port)
    _assert_scores_equal(ref, port, rules, list(_PREFIXES), 8)


@pytest.mark.parametrize("kind", ["rules", "patterns"])
def test_payloads_and_digest_equal_reference(kind):
    rng = random.Random(3)
    if kind == "rules":
        obj = random_rules(rng, 20, 9)
        obj.append(((), (4,), 0, 0))       # supx 0: confidence 0.0
        got, want = TM.serialize_rules(obj), RM.serialize_rules(obj)
        assert TM.deserialize_rules(got) == RM.deserialize_rules(want)
    else:
        obj = [(tuple(tuple(sorted(rng.sample(range(9), rng.randint(1, 3))))
                      for _ in range(rng.randint(1, 4))), rng.randint(1, 50))
               for _ in range(20)]
        got, want = TM.serialize_patterns(obj), RM.serialize_patterns(obj)
        assert TM.deserialize_patterns(got) == RM.deserialize_patterns(want)
    assert got == want
    assert T.rules_digest(got) == R.rules_digest(want)
