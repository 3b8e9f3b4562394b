"""Port tests that need a CUDA card (marker ``cuda``); they skip elsewhere.

On the machine with the card (which has no jax, so the repository's
conftest is left out):

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel is held against its plain version exactly, and the engine's
mines against the port's CPU oracle, with the kernel's launches counted.
"""

import numpy as np
import pytest
import torch

from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.utils.canonical import diff_patterns, patterns_text

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    w |= rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("P,NI,S,W", [(1, 1, 1, 1), (64, 64, 32, 1),
                                      (130, 77, 1001, 1), (67, 129, 517, 2),
                                      (3, 5, 4099, 3), (9, 70, 40, 40),
                                      (5, 66, 7, 100)])
def test_kernel_equals_plain(card, P, NI, S, W):
    rng = np.random.default_rng(P * 7919 + S)
    pt = _words(rng, P, S * W).to(card)
    items = _words(rng, NI + 3, S * W).to(card)
    before = PS.pair_supports.launches
    got = PS.pair_supports(pt, items, NI, n_words=W)
    torch.cuda.synchronize()
    assert PS.pair_supports.launches == before + 1
    assert torch.equal(got, PS.pair_supports_plain(pt, items, NI, n_words=W))


@pytest.mark.parametrize("kw,minsup_rel,cap", [
    (dict(seed=7, n_sequences=400, n_items=40, mean_itemsets=4.0,
          mean_itemset_size=1.4), 0.02, None),
    (dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
          max_itemsets=80), 0.5, 3),
])
def test_engine_on_card_matches_oracle(card, kw, minsup_rel, cap):
    db = synthetic_db(**kw)
    minsup = abs_minsup(minsup_rel, len(db))
    before = PS.pair_supports.launches
    got = mine_spade_torch(db, minsup, device=card, max_pattern_itemsets=cap,
                           pool_bytes=1 << 20, node_batch=16)
    assert PS.pair_supports.launches > before
    want = mine_spade(db, minsup, max_pattern_itemsets=cap)
    assert patterns_text(got) == patterns_text(want), diff_patterns(want, got)
