"""Port parity for the pair-support kernel's module: the plain PyTorch
version against the Pallas kernel (interpret mode, as the JAX package's own
tests run it on the CPU), W = 1 and W = 2, with and without the ``n_live``
hint, and the wrapper's device rules: plain version only for CPU tensors,
a raise for anything it cannot launch.  The callers' hints are checked on
the engines' own stores: every item row past the hint a caller passes is
all zero when B1 runs, and the mine equals the reference's.

The port reads the engine's flat ``[rows, S*W]`` (word minor) layout; the
Pallas kernel takes ``[rows, W, S]``, so the tests transpose for it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.models import spade_queue as JQ
from spark_fsm_tpu.models import spam_bitmap as JS
from spark_fsm_tpu.ops import pallas_support as JPS
from spark_fsm_tpu.streaming import incremental as JI
from spark_fsm_tpu.utils.canonical import patterns_text as j_patterns_text
from spark_fsm_tpu_torch.data import vertical as TV
from spark_fsm_tpu_torch.models import spade_queue as TQ
from spark_fsm_tpu_torch.models import spam_bitmap as TS
from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops import spam_bitops as SB
from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
from spark_fsm_tpu_torch.utils.canonical import patterns_text


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    return w | (rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("n_words", [1, 2])
def test_pair_supports_plain_matches_pallas(n_words):
    rng = np.random.default_rng(10 + n_words)
    sb = JPS.seq_block(n_words)
    P, NI, S, W = 2 * JPS.P_TILE, 21, sb, n_words
    pt = _words(rng, P, S, W)                       # engine layout [P, S, W]
    items = _words(rng, JPS.I_TILE, S, W)
    want = np.asarray(JPS.pair_supports(
        jnp.asarray(pt.transpose(0, 2, 1)), jnp.asarray(items.transpose(0, 2, 1)),
        NI, s_block=sb, interpret=True))[:, :NI]
    got = PS.pair_supports_plain(_t(pt.reshape(P, -1)),
                                 _t(items.reshape(len(items), -1)), NI,
                                 n_words=W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, NI)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_words", [1, 2])
def test_batch_supports_plain_matches_pallas(n_words):
    rng = np.random.default_rng(20 + n_words)
    sb = JPS.seq_block(n_words)
    P, NI, S, W = 20, 37, sb, n_words               # P off the Pallas tile
    pt = _words(rng, P, S * W)
    items = _words(rng, JPS.I_TILE, S * W)
    pref = rng.integers(0, P, 60).astype(np.int32)
    item = rng.integers(0, NI, 60).astype(np.int32)
    want = np.asarray(JPS.batch_supports(
        jnp.asarray(pt), jnp.asarray(items), NI, jnp.asarray(pref),
        jnp.asarray(item), s_block=sb, interpret=True, n_words=W))
    got = PS.batch_supports_plain(_t(pt), _t(items), NI,
                                  torch.from_numpy(pref).long(),
                                  torch.from_numpy(item).long(), n_words=W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    pt, items = _t(_words(rng, 7, 3 * 45)), _t(_words(rng, 11, 3 * 45))
    before = PS.pair_supports.launches
    got = PS.pair_supports(pt, items, 9, n_words=3)
    assert torch.equal(got, PS.pair_supports_plain(pt, items, 9, n_words=3))
    pref, item = torch.tensor([0, 6, 3]), torch.tensor([8, 0, 4])
    assert torch.equal(PS.batch_supports(pt, items, 9, pref, item, n_words=3),
                       got[pref, item])
    assert PS.pair_supports.launches == before


def test_plain_chunking_is_exact(monkeypatch):
    rng = np.random.default_rng(4)
    pt, items = _t(_words(rng, 13, 2 * 50)), _t(_words(rng, 6, 2 * 50))
    whole = PS.pair_supports_plain(pt, items, 6, n_words=2)
    monkeypatch.setattr(PS, "_CHUNK_BYTES", 1)      # one parent row a chunk
    tiny = PS.pair_supports_plain(pt, items, 6, n_words=2)
    assert torch.equal(whole, tiny)


def test_wrapper_never_quietly_uses_the_plain_version(monkeypatch):
    # a tensor that is neither on the CPU nor on CUDA: the wrapper raises
    # and the plain version is not reached
    calls = []
    monkeypatch.setattr(PS, "pair_supports_plain",
                        lambda *a, **k: calls.append(1))
    pt = torch.zeros(4, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        PS.pair_supports(pt, pt, 2)
    assert calls == []


def test_kernel_request_raises_on_a_box_without_cuda():
    # a CUDA request here cannot reach the plain version: torch refuses the
    # CUDA tensor, and the kernel cannot be built without nvcc
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the kernel path runs instead")
    with pytest.raises((AssertionError, RuntimeError)):
        torch.zeros(1, dtype=torch.int32, device="cuda")
    if _build.shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            PS._kernel()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "rows", "width",
                                 "device"])
def test_wrapper_rejects_bad_operands(bad):
    pt = torch.zeros(4, 64, dtype=torch.int32)
    items = torch.zeros(6, 64, dtype=torch.int32)
    n, w = 5, 2
    if bad == "dtype":
        pt = pt.to(torch.int64)
    elif bad == "shape":
        pt = pt.view(4, 32, 2)
    elif bad == "contig":
        pt = torch.zeros(64, 4, dtype=torch.int32).t()
    elif bad == "rows":
        n = 7
    elif bad == "width":
        w = 3
    elif bad == "device":
        items = items.to("meta")
    with pytest.raises((TypeError, ValueError)):
        PS.pair_supports(pt, items, n, n_words=w)


# (P, NI, n_live, W): SPAM's mesh wave shape, a ragged multiword shape,
# no live row, every row live
LIVE_CASES = [(12, 64, 17, 1), (130, 77, 33, 2), (12, 64, 0, 1),
              (130, 77, 77, 2)]


def _live_operands(P, NI, k, W):
    """Parent rows and a 128-row item block (the reference's i_tile) whose
    rows from ``k`` on are all zero, as the engines' stores are."""
    rng = np.random.default_rng(1000 * P + 10 * k + W)
    S = JPS.seq_block(W)
    pt = _words(rng, P, S, W)
    items = _words(rng, JPS.I_TILE, S, W)
    items[k:] = 0
    return pt, items, S


@pytest.mark.parametrize("P,NI,k,W", LIVE_CASES)
def test_pair_supports_plain_with_live_rows_matches_pallas(P, NI, k, W):
    pt, items, S = _live_operands(P, NI, k, W)
    p_pad = -(-P // JPS.P_TILE) * JPS.P_TILE
    ptp = np.zeros((p_pad, S, W), np.uint32)
    ptp[:P] = pt
    want = np.asarray(JPS.pair_supports(
        jnp.asarray(ptp.transpose(0, 2, 1)),
        jnp.asarray(items.transpose(0, 2, 1)), NI, s_block=S,
        p_tile=JPS.P_TILE, i_tile=JPS.I_TILE, interpret=True))[:P, :NI]
    tpt, titems = _t(pt.reshape(P, -1)), _t(items.reshape(len(items), -1))
    got = PS.pair_supports_plain(tpt, titems, NI, n_words=W, n_live=k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, NI)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, k:].any()
    # the hint changes no count when the rows past it are zero
    assert torch.equal(got, PS.pair_supports_plain(tpt, titems, NI,
                                                   n_words=W))
    assert torch.equal(got, PS.pair_supports(tpt, titems, NI, n_words=W,
                                             n_live=k))


@pytest.mark.parametrize("P,NI,k,W", LIVE_CASES)
def test_batch_supports_plain_with_live_rows_matches_pallas(P, NI, k, W):
    pt, items, S = _live_operands(P, NI, k, W)
    rng = np.random.default_rng(7 + k)
    pref = rng.integers(0, P, 90).astype(np.int32)
    item = rng.integers(0, NI, 90).astype(np.int32)
    flat_pt, flat_items = pt.reshape(P, -1), items.reshape(len(items), -1)
    want = np.asarray(JPS.batch_supports(
        jnp.asarray(flat_pt), jnp.asarray(flat_items), NI, jnp.asarray(pref),
        jnp.asarray(item), s_block=S, interpret=True, n_words=W))
    args = (_t(flat_pt), _t(flat_items), NI, torch.from_numpy(pref).long(),
            torch.from_numpy(item).long())
    got = PS.batch_supports_plain(*args, n_words=W, n_live=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(PS.batch_supports(*args, n_words=W, n_live=k), got)


@pytest.mark.parametrize("k", [-1, 78, 1.5, True])
def test_live_rows_outside_the_item_rows_raise(k):
    pt, items = torch.zeros(3, 64, dtype=torch.int32), torch.zeros(
        80, 64, dtype=torch.int32)
    for fn in (PS.pair_supports, PS.pair_supports_plain):
        with pytest.raises((TypeError, ValueError), match="n_live"):
            fn(pt, items, 77, n_live=k)
    with pytest.raises((TypeError, ValueError), match="n_live"):
        PS.batch_supports(pt, items, 77, torch.zeros(1, dtype=torch.long),
                          torch.zeros(1, dtype=torch.long), n_live=k)


def _queue_mine():
    db = synthetic_db(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
                      mean_itemset_size=1.3)
    caps = dict(nb=32, ring=512, c_cap=2048, r_cap=16384)
    want = JQ.QueueSpadeTPU(JV.build_vertical(db, min_item_support=6), 6,
                            caps=JQ.QueueCaps(**caps)).mine()
    got = TQ.QueueSpadeTorch(TV.build_vertical(db, min_item_support=6), 6,
                             device="cpu", caps=TQ.QueueCaps(**caps)).mine()
    return [patterns_text(got)], [j_patterns_text(want)]


def _spam_mine(kw):
    def mine():
        db = synthetic_db(seed=401, n_sequences=90, n_items=24,
                          mean_itemsets=4.0, mean_itemset_size=1.3,
                          zipf_s=2.2)
        ms = JV.abs_minsup(0.08, len(db))
        geo = dict(node_batch=4, pool_bytes=64 << 20, **kw)
        want = JS.mine_spam_tpu(db, ms, **geo)
        got = TS.mine_spam_torch(db, ms, device="cpu", **geo)
        return [patterns_text(got)], [j_patterns_text(want)]
    return mine


def _stream_mine():
    rng = np.random.default_rng(17)
    port = IncrementalWindowMiner(0.2, max_batches=2, device="cpu",
                                  use_kernel=True)
    ref = JI.IncrementalWindowMiner(0.2, max_batches=2, use_pallas=False)
    got, want = [], []
    for _ in range(4):
        batch = synthetic_db(seed=int(rng.integers(1 << 30)), n_sequences=60,
                             n_items=10, mean_itemsets=3.0,
                             mean_itemset_size=1.5)
        got.append(patterns_text(port.push(batch)))
        want.append(j_patterns_text(ref.push(batch)))
    return got, want


@pytest.mark.parametrize("engine", ["queue", "spam_bitmap", "spam_hybrid",
                                    "stream"])
def test_callers_pass_live_rows_whose_tail_is_zero(monkeypatch, engine):
    """Each B1 caller's store, built on the CPU: every item row from the
    hint it passes up to its ``n_item_rows`` is all zero when B1 runs, and
    the engine's output equals the reference's.  SPAM calls B1 on a mesh
    only, so its wave is sent through ``wave_prune_sharded`` with no mesh
    here, as a mesh rank's wave is."""
    hints = []
    real = PS.pair_supports

    def pair_supports(pt, items, n_item_rows, n_words=1, n_live=None):
        assert n_live is not None, "a caller passed no live-row hint"
        assert n_live < n_item_rows, "no pad rows: the fixture tests nothing"
        assert not items[n_live:n_item_rows].any(), (n_live, n_item_rows)
        hints.append((n_live, n_item_rows))
        return real(pt, items, n_item_rows, n_words, n_live)

    monkeypatch.setattr(PS, "pair_supports", pair_supports)
    if engine.startswith("spam"):
        def wave_extend_prune(pt, items, thr, use_diff, *, n_words, nd_pad,
                              n_live=None):
            return SB.wave_prune_sharded(pt, items, thr, n_words=n_words,
                                         nd_pad=nd_pad, mesh=None,
                                         n_live=n_live)
        monkeypatch.setattr(SB, "wave_extend_prune", wave_extend_prune)
    mine = {"queue": _queue_mine, "stream": _stream_mine,
            "spam_bitmap": _spam_mine({"representation": "bitmap"}),
            "spam_hybrid": _spam_mine({"density_crossover": 0.5})}[engine]
    got, want = mine()
    assert got == want
    assert hints, "B1 never ran"
