"""Port parity for ``streaming/incremental.py``: the port's
``IncrementalWindowMiner`` on the CPU and the reference's run the same
stream in lockstep, on the single-device fixtures of
``tests/test_incremental.py``.  After every push both pattern sets equal
the oracle's mine of the window, byte for byte, and the stats dicts are
equal key for key (``phase_s`` and ``push_wall_s``, which are walls, and
``shape_key`` and ``sweep_shape_keys``, which the port does not set,
aside).  The sweep's gather-join branch (``use_kernel=False``) runs
against the reference's (``use_pallas=False``); on a small multiword
stream B1's branch (``use_kernel=True``: its plain version on the CPU)
runs against the Pallas kernel in interpret mode.  Where the reference
builds a sweep store past the top prewarmed row bucket (its
``sweep_shape_keys``), the port sweeps that level in pieces (ROADMAP
Queue C 5): from then on its ``kernel_launches`` run ahead of the
reference's, and while such a store is live its ``store_cache_bytes`` is
the smaller; every other stat stays equal.  Also: the torch fold
against ``_fold_supports_fn``, the remap scatter against
``_inc_store_builder``, and the refused ``mesh``."""

import re

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data.spmf import parse_spmf
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models.oracle import mine_spade
from spark_fsm_tpu.streaming import incremental as JI
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu_torch.models._common import scatter_tokens_remap
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.streaming import (
    IncrementalWindowMiner, WindowMiner)
from spark_fsm_tpu_torch.streaming import incremental as TI
from spark_fsm_tpu_torch.utils.canonical import patterns_text

_UNSHARED = ("phase_s", "push_wall_s", "shape_key", "sweep_shape_keys")


def _shared(stats, skip=()):
    return {k: v for k, v in stats.items()
            if k not in _UNSHARED and k not in skip}


def _past_top_bucket(keys) -> bool:
    """A sweep key whose store rows pass the top of the row buckets a
    prewarm enumerates for its item rows."""
    for key in keys:
        rows, ni_rows = map(int, re.search(r"r(\d+)i(\d+)$", key).groups())
        top = TI.next_pow2(ni_rows + 1) << (TI.SWEEP_ROW_BUCKETS - 1)
        if rows > top:
            return True
    return False


def _batches(seed, n_batches, per_batch, n_items=12, mean_itemsets=3.0,
             mean_itemset_size=1.5):
    rng = np.random.default_rng(seed)
    return [synthetic_db(seed=int(rng.integers(1 << 30)),
                         n_sequences=per_batch, n_items=n_items,
                         mean_itemsets=mean_itemsets,
                         mean_itemset_size=mean_itemset_size)
            for _ in range(n_batches)]


class _Pair:
    """The port's and the reference's miner over one stream."""

    def __init__(self, min_support, use_kernel=False, **kw):
        self.port = IncrementalWindowMiner(min_support, device="cpu",
                                           use_kernel=use_kernel, **kw)
        self.ref = JI.IncrementalWindowMiner(min_support,
                                             use_pallas=use_kernel, **kw)
        self.split = False

    def push(self, batch):
        self.port.push(batch)
        self.ref.push(batch)
        self.check()

    def check(self):
        port, ref = self.port, self.ref
        want = mine_spade(port.window.sequences(), port.minsup_abs())
        assert port.minsup_abs() == ref.minsup_abs()
        assert patterns_text(port.patterns) == j_patterns_text(want), \
            f"push {port.stats['pushes']} diverged from the oracle"
        assert patterns_text(port.patterns) == j_patterns_text(ref.patterns)
        wide = _past_top_bucket(ref.stats.get("sweep_shape_keys", ()))
        self.split = self.split or wide
        skip = ()
        if self.split:
            skip += ("kernel_launches",)
            assert port.stats["kernel_launches"] > \
                ref.stats["kernel_launches"]
        if wide:
            skip += ("store_cache_bytes",)
            assert port.stats["store_cache_bytes"] < \
                ref.stats["store_cache_bytes"]
        assert _shared(port.stats, skip) == _shared(ref.stats, skip)


def _eviction(pair_of):
    p = pair_of(0.2, max_batches=3)
    for batch in _batches(7, 7, 60):
        p.push(batch)
    assert p.port.window.evicted_batches == 4
    assert p.port.stats["route"] == "incremental"


def _steady_state(pair_of):
    p = pair_of(30, max_batches=3)  # absolute minsup
    repaired = []
    for batch in _batches(11, 6, 80, n_items=8, mean_itemsets=2.5):
        before = p.port.stats["repaired_nodes"]
        p.push(batch)
        repaired.append(p.port.stats["repaired_nodes"] - before)
    assert repaired[0] > 0
    assert sum(repaired[3:]) < sum(repaired[:3])


def _minsup_drift(pair_of):
    p = pair_of(0.25, max_batches=None, max_sequences=None)
    for batch in _batches(13, 5, 50, n_items=10):
        p.push(batch)


def _late_item(pair_of):
    p = pair_of(2, max_batches=None)
    for text in ("1 -1 2 -2\n1 -2\n2 -1 1 -2\n", "9 -1 1 -2\n9 -2\n9 -1 9 -2\n",
                 "9 -1 1 -2\n9 -1 2 -2\n9 -2\n"):
        p.push(list(parse_spmf(text)))
    assert any(pat == ((9,),) for pat, _ in p.port.patterns)


def _falls_out_and_returns(pair_of):
    hot = parse_spmf("5 -1 6 -2\n5 -2\n5 -1 6 -2\n5 -2\n")
    cold = parse_spmf("1 -2\n2 -2\n1 -1 2 -2\n3 -2\n")
    p = pair_of(3, max_batches=2)
    for batch in (hot, cold, cold, hot, hot):
        p.push(list(batch))


def _iext(seed):
    def case(pair_of):
        p = pair_of(0.3, max_batches=2)
        for batch in _batches(seed, 4, 50, n_items=8, mean_itemset_size=2.5):
            p.push(batch)
    return case


def _multiword(pair_of):
    # > 32 itemsets a sequence: 2-word batch stores; minsup 0.85 keeps the
    # tree at thousands of nodes (as the reference's test does)
    p = pair_of(0.85, max_batches=2)
    for batch in _batches(8, 3, 40, n_items=6, mean_itemsets=40.0,
                          mean_itemset_size=1.1):
        p.push(batch)
    assert p.port.stats["repaired_nodes"] > 0
    assert p.split  # a level past the top row bucket: swept in pieces


def _restored_window(pair_of):
    batches = _batches(21, 3, 50)
    p = pair_of(0.2, max_batches=4)
    for b in batches[:2]:  # refill, bypassing the miners
        p.port.window.push(b)
        p.ref.window.push(b)
    p.push(batches[2])
    assert p.port.stats["swept_batches"] == 3


def _single_sequences_and_empty_f1(pair_of):
    p = pair_of(5, max_batches=2)
    p.push(parse_spmf("1 -2\n"))
    assert p.port.patterns == []
    p.push(parse_spmf("1 -2\n1 -2\n1 -2\n1 -2\n1 -2\n"))
    assert p.port.patterns == [(((1,),), 6)]


def _duplicate_object(pair_of):
    batch = _batches(23, 1, 50)[0]
    p = pair_of(0.3, max_batches=3)
    p.push(batch)
    p.push(batch)  # the same object again: two window entries
    assert p.port.window.n_sequences == 2 * len(batch)
    batch.clear()  # the counted content is frozen against mutation
    p.push(_batches(24, 1, 50)[0])


CASES = {
    "eviction": _eviction, "steady_state": _steady_state,
    "minsup_drift": _minsup_drift, "late_item": _late_item,
    "falls_out_and_returns": _falls_out_and_returns,
    "iext_seed3": _iext(3), "iext_seed4": _iext(4),
    "multiword": _multiword, "restored_window": _restored_window,
    "single_sequences_and_empty_f1": _single_sequences_and_empty_f1,
    "duplicate_object": _duplicate_object,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_join_branch_equals_reference_every_push(case):
    CASES[case](_Pair)


def test_b1_branch_equals_pallas_on_a_multiword_stream():
    """B1's branch (its plain version on CPU tensors) against the Pallas
    kernel in interpret mode: one support launch a level in both."""
    before = PS.pair_supports.launches
    p = _Pair(0.9, use_kernel=True, max_batches=2)
    assert p.port.use_kernel and p.ref.use_pallas
    for batch in _batches(5, 3, 16, n_items=6, mean_itemsets=40.0,
                          mean_itemset_size=1.1):
        p.push(batch)
    assert PS.pair_supports.launches == before  # no kernel on the CPU
    assert p.port.window.evicted_batches == 1
    assert p.port.stats["sweep_candidates"] > 0


def test_branches_differ_only_in_launches():
    """The two supports branches over one stream: the same patterns and
    counters; with ``support_chunk`` small, the gather-join launches a
    chunk where B1 launches once a level."""
    batches = _batches(17, 4, 60, n_items=10)
    a = IncrementalWindowMiner(0.2, max_batches=2, device="cpu",
                               use_kernel=True, support_chunk=8)
    b = IncrementalWindowMiner(0.2, max_batches=2, device="cpu",
                               use_kernel=False, support_chunk=8)
    for batch in batches:
        assert patterns_text(a.push(batch)) == patterns_text(b.push(batch))
    skip = _UNSHARED + ("kernel_launches",)
    assert ({k: v for k, v in a.stats.items() if k not in skip}
            == {k: v for k, v in b.stats.items() if k not in skip})
    assert a.stats["kernel_launches"] < b.stats["kernel_launches"]


def test_matches_remine_miners_exactly():
    batches = _batches(17, 5, 60, n_items=10)
    p = _Pair(0.25, max_batches=3)
    rem = WindowMiner(0.25, max_batches=3, device="cpu")
    for batch in batches:
        p.push(list(batch))
        assert patterns_text(p.port.patterns) == patterns_text(
            rem.push(list(batch)))


@pytest.mark.parametrize("batch,floor", [(100, 0), (100, 5000),
                                         (9000, 5000), (70, 130)])
def test_sweep_geometry_seq_floor_equals_reference(batch, floor):
    got = TI.sweep_geometry(batch, 1, seq_floor=floor)
    want = JI.sweep_geometry(batch, 1, seq_floor=floor)
    assert (got["n_seq"], got["n_words"]) == (want["n_seq"], want["n_words"])


def test_seq_floor_pins_the_batch_stores_and_keeps_the_answer():
    """``seq_floor`` sizes every batch store's sequence axis from the
    declared steady-state batch, as the reference's does; the patterns
    and counters do not move."""
    p = _Pair(0.2, max_batches=2, seq_floor=4096)
    for batch in _batches(19, 3, 60, n_items=10):
        p.push(batch)
    stores = list(p.port._states.values())
    assert stores and {st.n_seq for st in stores} == {
        TI.sweep_geometry(4096, 1)["n_seq"]}


def test_use_kernel_auto_resolves_by_device():
    assert IncrementalWindowMiner(0.5, device="cpu").use_kernel is False
    assert IncrementalWindowMiner(0.5, device="cpu",
                                  use_kernel=True).use_kernel is True


def test_mesh_raises():
    # ported (Queue A item 6): on a 1-rank mesh every push equals the
    # one-device miner's, with the kernel's branch and the gather-join
    from spark_fsm_tpu_torch.parallel.mesh import local_mesh
    mesh = local_mesh("cpu")
    for use_kernel in (True, False):
        on_mesh = IncrementalWindowMiner(0.2, max_batches=3, mesh=mesh,
                                         use_kernel=use_kernel)
        one = IncrementalWindowMiner(0.2, max_batches=3, device="cpu",
                                     use_kernel=use_kernel)
        for batch in _batches(7, 4, 40):
            assert patterns_text(on_mesh.push(batch)) == patterns_text(
                one.push(batch))
    assert mesh.reduce_stats()["all_reduces"] > 0


# ----------------------------------------------------------- device steps


def _seeded_store(rng, n_rows, n_seq, n_words):
    words = (rng.integers(0, 2**32, (n_rows, n_seq * n_words),
                          dtype=np.uint32)
             & rng.integers(0, 2**32, (n_rows, n_seq * n_words),
                            dtype=np.uint32))
    words[:, ::3] |= np.uint32(1 << 31)
    return words


@pytest.mark.parametrize("n_seq,n_words,k,m", [
    (128, 1, 2, 8), (256, 2, 4, 37), (128, 4, 3, 300),
])
def test_fold_equals_reference_fold(n_seq, n_words, k, m):
    import jax.numpy as jnp

    rng = np.random.default_rng(n_seq + k)
    n_rows = 24
    words = _seeded_store(rng, n_rows, n_seq, n_words)
    items = rng.integers(0, n_rows, (k, m)).astype(np.int32)
    iss = rng.random((k, m)) < 0.5
    valid = np.ones((k, m), bool)
    # ragged chains: a column's steps past its length are invalid
    for col, n in enumerate(rng.integers(2, k + 1, m)):
        valid[n:, col] = False
    want = np.asarray(JI._fold_supports_fn(n_words)(
        jnp.asarray(words), jnp.asarray(items), jnp.asarray(iss),
        jnp.asarray(valid)))
    got = TI.fold_supports(torch.from_numpy(words.view(np.int32)), items,
                           iss, valid, n_seq, n_words)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_local,n_rows,n_seq,n_words", [
    (17, 16, 128, 1), (40, 64, 256, 2), (5, 8, 128, 4),
])
def test_remap_scatter_equals_reference_builder(n_local, n_rows, n_seq,
                                                n_words):
    import jax.numpy as jnp

    from spark_fsm_tpu.models._common import pad_tokens_pow2

    rng = np.random.default_rng(n_local)
    n_tok = 3 * n_local * 7 + 1
    ti = rng.integers(0, n_local, n_tok).astype(np.int32)
    ts = rng.integers(0, n_seq, n_tok).astype(np.int32)
    tw = rng.integers(0, n_words, n_tok).astype(np.int32)
    bit = rng.integers(0, 32, n_tok)
    # one token per (item, sequence, word, bit): distinct bits, as built
    _, first = np.unique(np.stack([ti, ts, tw, bit]), axis=1,
                         return_index=True)
    ti, ts, tw, bit = (a[first] for a in (ti, ts, tw, bit))
    tm = (np.uint32(1) << bit.astype(np.uint32)).astype(np.uint32)
    ti, ts, tw, tm = pad_tokens_pow2(ti, ts, tw, tm)
    # present items get rows below n_rows - 1; the rest (and the remap's
    # pow2 pad entries) point past the store
    remap = np.full(1 << int(np.ceil(np.log2(n_local))), n_rows + 1, np.int32)
    present = rng.choice(n_local, min(n_local, n_rows - 1), replace=False)
    remap[present] = rng.permutation(n_rows - 1)[:len(present)]
    want = np.asarray(JI._inc_store_builder(n_rows, n_seq, n_words)(
        jnp.asarray(ti), jnp.asarray(ts), jnp.asarray(tw), jnp.asarray(tm),
        jnp.asarray(remap)))
    t64 = [torch.from_numpy(a.astype(np.int64)) for a in (ti, ts, tw, remap)]
    got = scatter_tokens_remap(t64[0], t64[1], t64[2],
                               torch.from_numpy(tm.view(np.int32)), t64[3],
                               n_rows, n_seq, n_words)
    assert got.shape == (n_rows, n_seq * n_words)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert not want[n_rows - 1].any()  # dropped tokens reach no row
