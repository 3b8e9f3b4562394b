"""Port parity for ``streaming/window.py``: ``SlidingWindow``'s eviction by
batch count and by sequence cap, its item census and its rejections, as
``tests/test_streaming.py`` checks the reference's; and the re-mine
``WindowMiner`` on the CPU, whose patterns after every push equal the
reference ``WindowMiner``'s and the oracle's."""

import pytest
import torch

from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models.oracle import mine_spade
from spark_fsm_tpu.streaming.window import WindowMiner as JWindowMiner
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.streaming import SlidingWindow, WindowMiner
from spark_fsm_tpu_torch.utils.canonical import patterns_text


def _batches(seed, n, size, n_items=10):
    db = synthetic_db(seed=seed, n_sequences=n * size, n_items=n_items,
                      mean_itemsets=4.0)
    return [db[i * size:(i + 1) * size] for i in range(n)]


# ---------------------------------------------------------------- window


def test_window_count_eviction():
    w = SlidingWindow(max_batches=2)
    b1, b2, b3 = _batches(seed=1, n=3, size=5)
    assert w.push(b1) == 0 and w.n_sequences == 5
    assert w.push(b2) == 0 and w.n_sequences == 10
    assert w.push(b3) == 1  # b1 evicted
    assert w.n_batches == 2 and w.n_sequences == 10
    assert w.sequences() == list(b2) + list(b3)
    assert w.evicted_batches == 1 and w.pushed_batches == 3


def test_window_sequence_cap_eviction():
    w = SlidingWindow(max_sequences=12)
    b1, b2, b3 = _batches(seed=2, n=3, size=5)
    w.push(b1)
    w.push(b2)
    assert w.n_sequences == 10  # under cap, nothing evicted
    w.push(b3)
    assert w.n_sequences == 10 and w.n_batches == 2  # b1 evicted
    # a single oversized batch is kept (eviction never empties the window)
    w2 = SlidingWindow(max_sequences=3)
    w2.push(b1)
    assert w2.n_batches == 1 and w2.n_sequences == 5


def test_window_item_supports_match_rescan():
    w = SlidingWindow(max_batches=2)
    for b in _batches(seed=3, n=3, size=8):
        w.push(b)
        want = {}
        for seq in w.sequences():
            for it in {i for s in seq for i in s}:
                want[it] = want.get(it, 0) + 1
        assert dict(w.item_supports()) == want


@pytest.mark.parametrize("kw,match", [
    (dict(max_batches=0), "max_batches"),
    (dict(max_sequences=-1), "max_sequences"),
])
def test_window_rejects_nonpositive_caps(kw, match):
    with pytest.raises(ValueError, match=match):
        SlidingWindow(**kw)


def test_window_rejects_an_empty_batch_and_defaults_to_one_batch():
    w = SlidingWindow()
    assert w.max_batches == 1
    with pytest.raises(ValueError, match="empty micro-batch"):
        w.push([])
    b1, b2 = _batches(seed=9, n=2, size=4)
    w.push(b1)
    assert w.push(b2) == 1 and w.batches() == [list(b2)]


# ------------------------------------------------------- re-mine miner


@pytest.mark.parametrize("rel_support", [0.2, 3.0])
def test_window_miner_equals_reference_every_push(rel_support):
    """Each of 4 pushes (with eviction after the 2nd) mines a pattern set
    byte-identical to the reference miner's and to a fresh oracle mine of
    the window's sequences."""
    port = WindowMiner(rel_support, max_batches=2, device="cpu")
    ref = JWindowMiner(rel_support, max_batches=2)
    for b in _batches(seed=4, n=4, size=20):
        got = port.push(b)
        want = ref.push(b)
        seqs = port.window.sequences()
        minsup = (int(rel_support) if rel_support >= 1
                  else abs_minsup(rel_support, len(seqs)))
        assert port.minsup_abs() == ref.minsup_abs() == minsup
        assert patterns_text(got) == j_patterns_text(want) == j_patterns_text(
            mine_spade(seqs, minsup))
        assert port.stats == ref.stats
    assert port.window.evicted_batches == 2
    assert port.stats["mines"] == 4 and port.stats["route"] == "re-mine"


def test_window_miner_minsup_tracks_window_size():
    miner = WindowMiner(0.5, max_batches=3, device="cpu")
    miner.push(_batches(seed=5, n=1, size=10)[0])
    assert miner.minsup_abs() == 5
    miner.push(_batches(seed=6, n=1, size=30)[0])
    assert miner.minsup_abs() == 20  # 0.5 * 40


def test_window_miner_takes_a_custom_mine_and_resolves_its_device():
    calls = []

    def mine(db, minsup):
        calls.append((len(db), minsup))
        return []

    miner = WindowMiner(2, max_batches=2, mine=mine, device="cpu")
    miner.push(_batches(seed=7, n=1, size=6)[0])
    assert calls == [(6, 2)] and miner.device.type == "cpu"
    if torch.cuda.is_available():
        assert WindowMiner(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            WindowMiner(2)
