"""Port parity for the fused extension-count-prune module (kernel B3's
plain version): ``extend_count_prune_plain`` against the Pallas kernel in
interpret mode (as ``tests/test_pallas_extend.py`` runs it on the CPU) and
against the reference's ``extend_count_prune_jnp``, exactly — counts,
zeroed dead lanes and survivor-mask bits, pad lanes included — and the
wrapper's rules: the plain version only for CPU tensors, a raise for a
threshold below 1, a ragged mask word or anything it cannot launch.

The Pallas kernel takes ``[rows, W, S]`` and pads the item axis to 128
lanes; the port reads ``[rows, S, W]`` (flat ``[rows, S*W]`` in the wrapper)
with the item axis padded by the caller to a multiple of 32 (the engine
pads to 64), so the tests lay the same words out for each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_fsm_tpu.ops import pallas_extend as PE
from spark_fsm_tpu.ops.pallas_support import I_TILE, P_TILE, seq_block
from spark_fsm_tpu_torch.ops import _build
from spark_fsm_tpu_torch.ops import extend_prune as EP

ND_PAD = 64  # the port's item pad (the engine's ITEM_TILE)


def _words(rng, *shape):
    # sparse-ish bitmaps, bit 31 set in some words
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    return w | (rng.integers(0, 8, shape, dtype=np.uint32) == 0).astype(
        np.uint32) << np.uint32(31)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _operands(seed, P, NI, S, W):
    """[P, S, W] parent rows and [ND_PAD, S, W] item rows (rows NI.. zero)."""
    rng = np.random.default_rng(seed)
    p3 = _words(rng, P, S, W)
    items3 = _words(rng, ND_PAD, S, W)
    items3[NI:] = 0
    return p3, items3


def _direct(p3, items3, NI):
    return np.array([[np.count_nonzero((p3[p] & items3[i]).any(axis=-1))
                      for i in range(NI)] for p in range(p3.shape[0])])


def _thresholds(counts):
    return [1, int(np.median(counts)), int(counts.max()) + 1]


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("NI", [21, 33])
def test_plain_matches_pallas_interpret(W, NI):
    sb = seq_block(W)
    P, S = P_TILE, sb
    p3, items3 = _operands(10 * W + NI, P, NI, S, W)
    counts = _direct(p3, items3, NI)
    items_k = np.zeros((I_TILE, W, S), np.uint32)       # Pallas item tile
    items_k[:ND_PAD] = items3.transpose(0, 2, 1)
    for thr in _thresholds(counts):
        want_sup, want_mask = (np.asarray(a) for a in PE.extend_count_prune(
            jnp.asarray(p3.transpose(0, 2, 1)), jnp.asarray(items_k),
            jnp.int32(thr), NI, s_block=sb, interpret=True))
        for flag in (False, True):
            sup, mask = EP.extend_count_prune_plain(
                _t(p3), _t(items3), thr, torch.full((P,), flag))
            assert tuple(sup.shape) == (P, ND_PAD)
            assert tuple(mask.shape) == (P, ND_PAD // 32)
            np.testing.assert_array_equal(sup.numpy(), want_sup[:, :ND_PAD])
            np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                          want_mask[:, :ND_PAD // 32])
            # dead lanes read exactly 0, pad lanes never survive
            alive = counts >= thr
            np.testing.assert_array_equal(sup.numpy()[:, :NI],
                                          np.where(alive, counts, 0))
            assert not sup.numpy()[:, NI:].any()
            bits = (mask.numpy().view(np.uint32)[:, :, None]
                    >> np.arange(32, dtype=np.uint32)) & 1
            np.testing.assert_array_equal(bits.reshape(P, ND_PAD)[:, :NI], alive)
            assert not bits.reshape(P, ND_PAD)[:, NI:].any()


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("NI", [21, 33])
def test_plain_matches_jnp_reference_with_diffset_flags(W, NI):
    P, S = 13, 301                                      # ragged P and S
    p3, items3 = _operands(50 + 10 * W + NI, P, NI, S, W)
    counts = _direct(p3, items3, NI)
    use_diff = np.random.default_rng(W).integers(0, 2, P).astype(bool)
    n_w = -(-NI // 32)
    for thr in _thresholds(counts):
        want_sup, want_mask = (np.asarray(a) for a in PE.extend_count_prune_jnp(
            jnp.asarray(p3), jnp.asarray(items3[:NI]), thr,
            jnp.asarray(use_diff)))
        sup, mask = EP.extend_count_prune_plain(_t(p3), _t(items3), thr,
                                                torch.from_numpy(use_diff))
        np.testing.assert_array_equal(sup.numpy()[:, :NI], want_sup)
        np.testing.assert_array_equal(mask.numpy().view(np.uint32)[:, :n_w],
                                      want_mask)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    p3, items3 = _operands(3, 9, 40, 77, 2)
    pt, items = _t(p3).view(9, -1), _t(items3).view(ND_PAD, -1)
    before = EP.extend_count_prune.launches
    sup, mask = EP.extend_count_prune(pt, items, 5, ND_PAD, n_words=2)
    want = EP.extend_count_prune_plain(_t(p3), _t(items3), 5,
                                       torch.zeros(9, dtype=torch.bool))
    assert torch.equal(sup, want[0]) and torch.equal(mask, want[1])
    assert EP.extend_count_prune.launches == before


def test_plain_chunking_is_exact(monkeypatch):
    p3, items3 = _operands(4, 11, 30, 50, 2)
    ud = torch.from_numpy(np.arange(11) % 3 == 0)
    whole = EP.extend_count_prune_plain(_t(p3), _t(items3), 3, ud)
    monkeypatch.setattr(EP, "_CHUNK_BYTES", 1)         # one row a chunk
    part = EP.extend_count_prune_plain(_t(p3), _t(items3), 3, ud)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


@pytest.mark.parametrize("thr", [0, -3])
def test_threshold_below_one_raises(thr):
    pt = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="thr"):
        EP.extend_count_prune(pt, pt.repeat(16, 1), thr, 64)
    with pytest.raises(ValueError, match="thr"):
        EP.extend_count_prune_plain(pt.view(4, 64, 1), pt.view(4, 64, 1), thr,
                                    torch.zeros(4, dtype=torch.bool))


@pytest.mark.parametrize("ni", [21, 33, 48])
def test_ragged_mask_word_raises(ni):
    pt = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 32"):
        EP.extend_count_prune(pt, torch.zeros(64, 64, dtype=torch.int32), 2, ni)


def test_wrapper_never_quietly_uses_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(EP, "extend_count_prune_plain",
                        lambda *a, **k: calls.append(1))
    p = torch.zeros(3, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        EP.extend_count_prune(p, torch.zeros(64, 32, dtype=torch.int32,
                                             device="meta"), 1, 64)
    assert calls == []


def test_kernel_build_raises_on_a_box_without_nvcc():
    if _build.shutil.which("nvcc") is not None:
        pytest.skip("this box has nvcc; the build runs instead")
    EP._kernel.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        EP._kernel()


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("NI,n_live", [(21, 21), (21, 33), (33, 33),
                                       (33, 64), (1, 1)])
def test_hinted_wrapper_matches_pallas_and_jnp(W, NI, n_live):
    """The wrapper given ``n_live`` (rows from n_live on are all zero)
    reads only the live rows on the CPU and gives the Pallas kernel's and
    the jnp reference's bytes, pad lanes dead."""
    sb = seq_block(W)
    P, S = P_TILE, sb
    p3, items3 = _operands(70 + 10 * W + NI, P, NI, S, W)
    counts = _direct(p3, items3, NI)
    items_k = np.zeros((I_TILE, W, S), np.uint32)
    items_k[:ND_PAD] = items3.transpose(0, 2, 1)
    pt, items = _t(p3).view(P, -1), _t(items3).view(ND_PAD, -1)
    n_w = -(-NI // 32)
    for thr in _thresholds(counts):
        want_sup, want_mask = (np.asarray(a) for a in PE.extend_count_prune(
            jnp.asarray(p3.transpose(0, 2, 1)), jnp.asarray(items_k),
            jnp.int32(thr), NI, s_block=sb, interpret=True))
        ref_sup, ref_mask = (np.asarray(a) for a in PE.extend_count_prune_jnp(
            jnp.asarray(p3), jnp.asarray(items3[:NI]), thr,
            jnp.zeros(P, bool)))
        sup, mask = EP.extend_count_prune(pt, items, thr, ND_PAD, n_words=W,
                                          n_live=n_live)
        np.testing.assert_array_equal(sup.numpy(), want_sup[:, :ND_PAD])
        np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                      want_mask[:, :ND_PAD // 32])
        np.testing.assert_array_equal(sup.numpy()[:, :NI], ref_sup)
        np.testing.assert_array_equal(mask.numpy().view(np.uint32)[:, :n_w],
                                      ref_mask)
        unhinted = EP.extend_count_prune(pt, items, thr, ND_PAD, n_words=W)
        assert torch.equal(sup, unhinted[0]) and torch.equal(mask, unhinted[1])


def test_hint_of_zero_live_rows_leaves_every_lane_dead():
    p3, items3 = _operands(5, 7, 0, 40, 1)
    sup, mask = EP.extend_count_prune(_t(p3).view(7, -1),
                                      _t(items3).view(ND_PAD, -1), 1, ND_PAD,
                                      n_live=0)
    assert tuple(sup.shape) == (7, ND_PAD) and not sup.any()
    assert tuple(mask.shape) == (7, ND_PAD // 32) and not mask.any()


@pytest.mark.parametrize("n_live", [-1, 65])
def test_hint_outside_the_item_rows_raises(n_live):
    pt = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_live"):
        EP.extend_count_prune(pt, torch.zeros(64, 64, dtype=torch.int32), 2,
                              64, n_live=n_live)
