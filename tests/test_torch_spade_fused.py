"""Port parity for the dense whole-mine engine (``models/spade_fused.py``):
``FusedSpadeTorch`` on the CPU against the reference's ``FusedSpadeTPU``
(its jnp path) and the oracle on ``tests/test_spade_fused.py``'s
fixtures, with the caps pinned so ``levels``, ``candidates`` and
``patterns`` compare, and ``fused_eligible`` against the reference's."""

from types import SimpleNamespace

import pytest
import torch

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.spmf import parse_spmf
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models import spade_fused as JF
from spark_fsm_tpu.models.oracle import mine_spade, mine_spade_vertical
from spark_fsm_tpu.utils.canonical import diff_patterns, patterns_text
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import spade_fused as TF

ZAKI = "1 -1 2 -1 3 -2\n1 4 -1 3 -2\n1 -1 2 -1 3 4 -2\n1 3 -1 5 -2\n"
CPU = torch.device("cpu")
# the reference's test geometries, reused so its compiles are shared
SMALL = dict(f_cap=256, c_cap=2048, r_cap=16384)
TINY = dict(f_cap=16, c_cap=32, r_cap=64, l_max=8)
COUNTERS = ("levels", "candidates", "patterns")

_SYN7 = dict(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
             mean_itemset_size=1.6)
_SYN9 = dict(seed=9, n_sequences=200, n_items=25, mean_itemsets=4.0,
             mean_itemset_size=2.5)


def both(db, minsup, caps, max_its=None):
    """The same mine through both packages' dense engines."""
    ref = JF.FusedSpadeTPU(JV.build_vertical(db, min_item_support=minsup),
                           minsup, caps=JF.FusedCaps(**caps),
                           max_pattern_itemsets=max_its)
    port = TF.FusedSpadeTorch(TV.build_vertical(db, min_item_support=minsup),
                              minsup, device="cpu",
                              caps=TF.FusedCaps(**caps),
                              max_pattern_itemsets=max_its)
    want, got = ref.mine(), port.mine()
    assert (want is None) == (got is None)
    if want is not None:
        assert patterns_text(got) == patterns_text(want), \
            diff_patterns(want, got)
    for key in COUNTERS:
        assert port.stats.get(key, 0) == ref.stats.get(key, 0), key
    assert port.stats.get("fused_overflow") == ref.stats.get("fused_overflow")
    return port, got


def test_parity_zaki():
    db = parse_spmf(ZAKI)
    port, got = both(db, 2, SMALL)
    assert patterns_text(got) == patterns_text(mine_spade(db, 2))
    assert port.stats["fused"] is True
    assert port.stats["kernel_launches"] == port.stats["levels"] > 0


@pytest.mark.parametrize("kw,minsup,caps", [
    (_SYN7, 8, SMALL), (_SYN9, 10, SMALL),
    (dict(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
          mean_itemset_size=1.3), 6, {}),     # wide levels, the default caps
])
def test_parity_synthetic(kw, minsup, caps):
    db = synthetic_db(**kw)
    _, got = both(db, minsup, caps)
    assert patterns_text(got) == patterns_text(mine_spade(db, minsup))


def test_parity_multiword():
    db = synthetic_db(seed=8, n_sequences=120, n_items=12,
                      mean_itemsets=40.0, mean_itemset_size=1.2)
    port, got = both(db, 90, dict(f_cap=1024, c_cap=8192, r_cap=1 << 16))
    assert port.n_words > 1
    assert patterns_text(got) == patterns_text(mine_spade(db, 90))


def test_max_pattern_itemsets():
    db = synthetic_db(**_SYN9)
    _, got = both(db, 10, SMALL, max_its=2)
    want = mine_spade_vertical(JV.build_vertical(db, min_item_support=10),
                               10, max_pattern_itemsets=2)
    assert patterns_text(got) == patterns_text(want)


def test_overflow_returns_none():
    port, got = both(synthetic_db(**_SYN7), 8, TINY)
    assert got is None and port.stats["fused_overflow"]


def test_frontier_overflow_then_wide_caps():
    """A frontier past f_cap = 1024 overflows (the classic fallback's
    signal); a wider cap mines it byte-identically."""
    db = synthetic_db(seed=13, n_sequences=60, n_items=40, mean_itemsets=6.0,
                      mean_itemset_size=2.0, correlation=0.8)
    port, got = both(db, 2, {})
    assert got is None and port.stats["fused_overflow"]
    wide = TF.FusedSpadeTorch(TV.build_vertical(db, min_item_support=2), 2,
                              device="cpu", caps=TF.FusedCaps(f_cap=4096))
    assert patterns_text(wide.mine()) == patterns_text(mine_spade(db, 2))


def test_empty_and_single():
    for text, want in (("1 -2\n1 -2\n", [(((1,),), 2)]), ("1 -2\n", [])):
        db = parse_spmf(text)
        eng = TF.FusedSpadeTorch(TV.build_vertical(db, min_item_support=2), 2,
                                 device="cpu", caps=TF.FusedCaps(**SMALL))
        assert eng.mine() == want


def test_caps_and_eligibility_equal_reference():
    assert vars(TF.FusedCaps.for_mesh()) == vars(JF.FusedCaps.for_mesh(None))
    for f in (1, 7, 16, 100, 1024):
        assert vars(TF.FusedCaps(f_cap=f)) == vars(JF.FusedCaps(f_cap=f))
    # a 1-rank mesh takes the reference's make_mesh(1) caps, and the dense
    # engine on it mines what one device does
    from spark_fsm_tpu.parallel.mesh import make_mesh
    from spark_fsm_tpu_torch.parallel.mesh import local_mesh
    mesh = local_mesh("cpu")
    assert vars(TF.FusedCaps.for_mesh(mesh)) == vars(
        JF.FusedCaps.for_mesh(make_mesh(1)))
    db = parse_spmf(ZAKI)
    vdb = TV.build_vertical(db, min_item_support=2)
    on_mesh = TF.FusedSpadeTorch(vdb, 2, mesh=mesh).mine()
    assert patterns_text(on_mesh) == patterns_text(
        TF.FusedSpadeTorch(vdb, 2, device="cpu").mine())
    assert TF.fused_eligible(TV.build_vertical(db, min_item_support=2), CPU)
    for n_items, n_seq, n_words in ((17, 5000, 1), (17, 300_000, 3),
                                    (5000, 100, 1), (1025, 100, 1),
                                    (17, 300_000_000, 1), (360, 77_500, 1),
                                    (17, 700_000, 1), (17, 760_000, 1)):
        v = SimpleNamespace(n_items=n_items, n_sequences=n_seq,
                            n_words=n_words)
        assert TF.fused_eligible(v, CPU) == JF.fused_eligible(v), vars(v)
