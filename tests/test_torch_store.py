"""Port parity for the data layer and the device store: the copied
``data``/``utils`` modules give what the reference gives, the torch
``scatter_build_store`` writes the same bytes as the reference's
``scatter_build_store(..., flat=True)``, and the interop helpers round-trip
the reference's store."""

import json

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data import spmf as JSPMF
from spark_fsm_tpu.data import synth as JSYN
from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.models import _common as JC
from spark_fsm_tpu.models import spade_tpu as JS
from spark_fsm_tpu.utils import canonical as JCAN
from spark_fsm_tpu_torch import interop
from spark_fsm_tpu_torch.data import spmf as TSPMF
from spark_fsm_tpu_torch.data import synth as TSYN
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import _common as TC
from spark_fsm_tpu_torch.models import spade as TS
from spark_fsm_tpu_torch.utils import canonical as TCAN
from tests.test_oracle import ZAKI_DB

DBS = {
    "zaki": lambda: ZAKI_DB,
    "synthetic": lambda: JSYN.synthetic_db(seed=7, n_sequences=300, n_items=40,
                                           mean_itemsets=4.0,
                                           mean_itemset_size=1.4),
    "multiword": lambda: JSYN.synthetic_db(seed=8, n_sequences=60, n_items=12,
                                           mean_itemsets=40.0, max_itemsets=80),
}

_FIELDS = ("item_ids", "seq_lengths", "item_supports", "tok_item", "tok_seq",
           "tok_word", "tok_mask")


@pytest.mark.parametrize("name", sorted(DBS))
def test_build_vertical_copy_matches_reference(name):
    db = DBS[name]()
    for minsup in (1, 3):
        a = JV.build_vertical(db, min_item_support=minsup)
        b = TV.build_vertical(db, min_item_support=minsup)
        assert (a.n_sequences, a.n_words, a.n_positions) == (
            b.n_sequences, b.n_words, b.n_positions)
        for f in _FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        np.testing.assert_array_equal(a.bitmaps, b.bitmaps)
    assert JV.abs_minsup(0.001, 77500) == TV.abs_minsup(0.001, 77500) == 78


def test_synth_copy_draws_the_same_database():
    kw = dict(seed=5, n_sequences=150, n_items=30, mean_itemsets=3.5,
              mean_itemset_size=1.6)
    assert TSYN.synthetic_db(**kw) == JSYN.synthetic_db(**kw)
    assert TSYN.bms_webview2_like(scale=0.01) == JSYN.bms_webview2_like(scale=0.01)


def test_spmf_and_canonical_copies_match_reference():
    db = DBS["synthetic"]()
    text = JSPMF.format_spmf(db)
    assert TSPMF.format_spmf(db) == text
    assert TSPMF.parse_spmf(text + "# comment\n\n5 -1 5 7 -2\n") == \
        JSPMF.parse_spmf(text + "# comment\n\n5 -1 5 7 -2\n")
    res = [(((3,), (1, 2)), 4), (((1,),), 9), (((2,), (2,)), 5)]
    assert TCAN.patterns_text(res) == JCAN.patterns_text(res)
    assert TCAN.sort_patterns(res) == JCAN.sort_patterns(res)
    other = [(((1,),), 8), (((4,),), 2)]
    assert TCAN.diff_patterns(res, other) == JCAN.diff_patterns(res, other)


@pytest.mark.parametrize("name", sorted(DBS))
def test_scatter_build_store_bytes_match_reference(name):
    db = DBS[name]()
    jv = JV.build_vertical(db, min_item_support=2)
    tv = TV.build_vertical(db, min_item_support=2)
    n_rows = jv.n_items + 9
    n_seq = TC.device_axes(jv.n_sequences)
    want = np.asarray(JC.scatter_build_store(jv, n_rows, n_seq, jv.n_words,
                                             flat=True))
    got = TC.scatter_build_store(tv, n_rows, n_seq, tv.n_words,
                                 torch.device("cpu"))
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (n_rows, n_seq * jv.n_words)
    np.testing.assert_array_equal(interop.store_to_numpy(got), want)
    # bit 31 is reachable and survives the int32 accumulate
    assert name != "multiword" or (want >> np.uint32(31)).any()


def test_interop_round_trips_the_reference_store():
    jv = JV.build_vertical(DBS["multiword"](), min_item_support=2)
    ref = np.asarray(JC.scatter_build_store(jv, jv.n_items + 3, jv.n_sequences,
                                            jv.n_words, flat=True))
    t = interop.store_from_numpy(ref, device="cpu")
    assert t.dtype == torch.int32
    back = interop.store_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, ref)
    with pytest.raises(ValueError):
        interop.store_from_numpy(ref.astype(np.int64), device="cpu")


def test_shared_host_helpers_match_reference():
    for n in (0, 1, 5, 64, 1000):
        assert TC.next_pow2(n) == JC.next_pow2(n)
    for args in ((1, 5, 8), (1 << 30, 311_000, 8), (64 << 20, 4096, 8)):
        assert TC.launch_width_cap(*args) == JC.launch_width_cap(*args)
    a, b = JC.SlotPool(range(3, 9)), TC.SlotPool(range(3, 9))
    assert [a.alloc() for _ in range(7)] == [b.alloc() for _ in range(7)]
    stack_a = [JC.FrontierNode(((1, True),), s, [], []) for s in (3, 4, 1)]
    stack_b = [TC.FrontierNode(((1, True),), s, [], []) for s in (3, 4, 1)]
    a.reclaim(stack_a, 2, lambda n: n.slot >= 3)
    b.reclaim(stack_b, 2, lambda n: n.slot >= 3)
    assert [n.slot for n in stack_a] == [n.slot for n in stack_b]
    assert a.reclaimed == b.reclaimed
    fp = {"minsup": 2}
    res = [(((1,), (2, 3)), 4)]
    enc_a = JC.encode_frontier(fp, stack_a, res)
    enc_b = TC.encode_frontier(fp, stack_b, res)
    assert json.dumps(enc_a) == json.dumps(enc_b)


def test_classic_geometry_sizes_the_headline_mine():
    # BMS-WebView-2 at minsup 0.1%: 77,500 sequences, 360 frequent items,
    # one word; an 80 GB card's pool budget caps at 32,768 slots
    g = TS.classic_geometry(77500, 360, 1, pool_bytes=int(80e9 * 0.95 * 0.35))
    assert g["n_seq"] == 77504 and g["n_seq"] % 32 == 0
    assert g["node_batch"] == 1024 and g["pipeline_depth"] == 4
    assert g["total_rows"] == 360 + 32768 - 2 * 4 * 1024
    r = JS.classic_geometry(77500, 360, 1, pool_bytes=int(80e9 * 0.95 * 0.35))
    for k in ("node_batch", "pipeline_depth", "pool_slots", "chunk",
              "recompute_chunk"):
        assert g[k] == r[k], k
