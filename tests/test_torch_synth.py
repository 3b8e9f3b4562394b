"""The port's copies against the reference modules they copy: the fast
generator and the Kosarak and MSNBC shapes, the TSR and SPAM halves of
``bitops_np``, and the canonical rule ordering and text."""

import numpy as np
import pytest

from spark_fsm_tpu.data import synth as JS
from spark_fsm_tpu.ops import bitops_np as JBN
from spark_fsm_tpu.utils import canonical as JC
from spark_fsm_tpu_torch.data import synth as S
from spark_fsm_tpu_torch.ops import bitops_np as BN
from spark_fsm_tpu_torch.utils import canonical as C


def test_kosarak_like_fast_equals_reference():
    got = S.kosarak_like(scale=0.01, fast=True)
    assert len(got) == 9900
    assert got == JS.kosarak_like(scale=0.01, fast=True)


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_sequences=500, n_items=40, mean_itemsets=6.0,
         mean_itemset_size=1.7, zipf_s=1.1),
    dict(seed=9, n_sequences=50, n_items=4, mean_itemsets=30.0,
         max_itemsets=40, correlation=0.8),
])
def test_synthetic_db_fast_equals_reference(kw):
    assert S.synthetic_db_fast(**kw) == JS.synthetic_db_fast(**kw)


def test_bms_webview2_like_fast_flag_equals_reference():
    assert (S.bms_webview2_like(scale=0.01, fast=True)
            == JS.bms_webview2_like(scale=0.01, fast=True))
    assert (S.bms_webview2_like(scale=0.01)
            == JS.bms_webview2_like(scale=0.01))


@pytest.mark.parametrize("fast", [False, True])
def test_msnbc_like_equals_reference(fast):
    got = S.msnbc_like(scale=0.002, fast=fast)
    assert len(got) == 1980
    assert got == JS.msnbc_like(scale=0.002, fast=fast)


@pytest.mark.parametrize("W", [1, 3])
def test_spam_bitops_equal_reference(W):
    rng = np.random.default_rng(40 + W)
    b = (rng.integers(0, 2**32, (5, 77, W), dtype=np.uint32)
         & rng.integers(0, 2**32, (5, 77, W), dtype=np.uint32))
    b[:, ::7] = 0
    b[:, 3::11, -1] = np.uint32(1 << 31)
    item = b[::-1].copy()
    pairs = [("i_extend", (b, item)), ("s_extend", (b, item)),
             ("popcount", (b,)), ("support_popcount", (b,)),
             ("pack_seq_bits", (b[..., 0] != 0,)),
             ("diffset_count", (b, b & item)),
             ("support_from_diffset", (np.arange(5), np.arange(5)[::-1]))]
    for fn, args in pairs:
        got, want = getattr(BN, fn)(*args), getattr(JBN, fn)(*args)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    for n_valid in (0, 1, 31, 32, 33, 64, 95, 200):
        np.testing.assert_array_equal(BN.tail_mask(n_valid, 3),
                                      JBN.tail_mask(n_valid, 3))
    # the diffset spelling of a join's support is exact
    np.testing.assert_array_equal(
        BN.support_from_diffset(BN.support_popcount(b),
                                BN.diffset_count(b, b & item)),
        BN.support_popcount(b & item))


@pytest.mark.parametrize("fn", ["prefix_or_incl", "suffix_or_incl",
                                "shift_up_one", "suffix_or_word"])
@pytest.mark.parametrize("W", [1, 3])
def test_tsr_bitops_equal_reference(fn, W):
    rng = np.random.default_rng(W)
    b = (rng.integers(0, 2**32, (5, 64, W), dtype=np.uint32)
         & rng.integers(0, 2**32, (5, 64, W), dtype=np.uint32))
    b[:, ::7] = 0
    b[:, 3::11, 0] = np.uint32(1 << 31)
    got, want = getattr(BN, fn)(b), getattr(JBN, fn)(b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_rule_order_and_text_equal_reference():
    rng = np.random.default_rng(7)
    rules = []
    for _ in range(300):
        supx = int(rng.integers(1, 20))
        x = tuple(sorted(rng.choice(9, rng.integers(1, 3), replace=False).tolist()))
        y = tuple(sorted(rng.choice(9, rng.integers(1, 3), replace=False).tolist()))
        rules.append((x, y, int(rng.integers(1, supx + 1)), supx))
    assert C.sort_rules(rules) == JC.sort_rules(rules)
    assert C.rules_text(rules) == JC.rules_text(rules)
    assert C.rule_line(rules[0]) == JC.rule_line(rules[0])
