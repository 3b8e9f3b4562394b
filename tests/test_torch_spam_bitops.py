"""Port parity for ``ops/spam_bitops.py``: the wave passes, the dense-block
gather and the sparse pair prune against the reference's jitted
``*_fn(None, ...)`` (no mesh) on the same operands, exactly, and the mesh
forms on a 1-rank mesh against ``*_fn(make_mesh(1), ...)``.  Both take
the flat ``[rows, S*W]`` store layout; the port holds the uint32 words as
int32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_fsm_tpu.ops import spam_bitops as JSB
from spark_fsm_tpu_torch.ops import spam_bitops as SB


def _words(rng, *shape):
    w = (rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32)
         & rng.integers(0, 2**32, shape, dtype=np.uint32))
    return w | (rng.integers(0, 8, shape, dtype=np.uint32) == 0).astype(
        np.uint32) << np.uint32(31)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _operands(seed, P, n_rows, n_items, S, W):
    """[P, S*W] parent rows and an [n_rows, S*W] store whose rows
    n_items..63 are all-zero item pad rows (the engine contract)."""
    rng = np.random.default_rng(seed)
    pt = _words(rng, P, S * W)
    store = _words(rng, n_rows, S * W)
    store[n_items:max(n_items, 64)] = 0
    return pt, store


def test_pad_items_equals_reference():
    for n in list(range(0, 140)) + [360, 511, 512, 513]:
        assert SB.pad_items(n) == JSB.pad_items(n), n
    assert SB.ITEM_TILE == JSB.ITEM_TILE


@pytest.mark.parametrize("W,nd_pad", [(1, 64), (2, 64), (1, 128), (3, 128)])
def test_wave_extend_prune_equals_reference(W, nd_pad):
    P, S = 14, 203
    pt, store = _operands(W * 100 + nd_pad, P, nd_pad + 9, 50, S, W)
    use_diff = np.random.default_rng(W).integers(0, 2, P).astype(bool)
    ref_fn = JSB.wave_extend_prune_fn(None, W, nd_pad)
    for thr in (1, 40, 90, S + 1):
        want = ref_fn(jnp.asarray(pt), jnp.asarray(store), jnp.int32(thr),
                      jnp.asarray(use_diff))
        sup, mask = SB.wave_extend_prune(_t(pt), _t(store), thr,
                                         torch.from_numpy(use_diff),
                                         n_words=W, nd_pad=nd_pad)
        np.testing.assert_array_equal(sup.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                      np.asarray(want[1]))


@pytest.mark.parametrize("W", [1, 2])
def test_wave_supports_equals_reference(W):
    P, S, ni_pad = 10, 150, 64
    pt, store = _operands(7 + W, P, ni_pad + 5, 37, S, W)
    want = JSB.wave_supports_fn(None, W, ni_pad)(jnp.asarray(pt),
                                                 jnp.asarray(store))
    got = SB.wave_supports(_t(pt), _t(store), W, ni_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_equals_reference():
    _, store = _operands(5, 1, 90, 90, 77, 2)
    rows = np.full(64, -1, np.int32)
    rows[:26] = np.random.default_rng(5).choice(90, 26, replace=False)
    want = JSB.gather_rows_fn(None)(jnp.asarray(store), jnp.asarray(rows))
    got = SB.gather_rows(_t(store), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert not got[26:].any()


@pytest.mark.parametrize("W", [1, 2, 3])
def test_pair_prune_equals_reference(W):
    rng = np.random.default_rng(20 + W)
    P, S, C, n_rows = 12, 140, 128, 40
    pt, store = _operands(30 + W, P, n_rows, n_rows, S, W)
    pref = rng.integers(0, P, C).astype(np.int32)
    item = rng.integers(0, n_rows, C).astype(np.int32)
    item[100:] = -1                                     # pad lanes
    use_diff = rng.integers(0, 2, C).astype(bool)
    ref_fn = JSB.pair_prune_fn(None, W)
    for thr in (1, 20, 60):
        want = ref_fn(jnp.asarray(pt), jnp.asarray(store), jnp.asarray(pref),
                      jnp.asarray(item), jnp.int32(thr), jnp.asarray(use_diff))
        got = SB.pair_prune(_t(pt), _t(store), torch.from_numpy(pref),
                            torch.from_numpy(item), thr,
                            torch.from_numpy(use_diff), W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got[100:].any()


@pytest.mark.parametrize("W,nd_pad,n_live", [(1, 64, 50), (2, 64, 17),
                                             (1, 128, 100), (3, 128, 64)])
def test_wave_extend_prune_with_live_hint_equals_reference(W, nd_pad, n_live):
    P, S = 10, 171
    pt, store = _operands(W * 7 + n_live, P, nd_pad + 3, n_live, S, W)
    store[n_live:nd_pad] = 0
    use_diff = np.random.default_rng(n_live).integers(0, 2, P).astype(bool)
    ref_fn = JSB.wave_extend_prune_fn(None, W, nd_pad)
    for thr in (1, 30, S + 1):
        want = ref_fn(jnp.asarray(pt), jnp.asarray(store), jnp.int32(thr),
                      jnp.asarray(use_diff))
        sup, mask = SB.wave_extend_prune(_t(pt), _t(store), thr,
                                         torch.from_numpy(use_diff),
                                         n_words=W, nd_pad=nd_pad,
                                         n_live=n_live)
        np.testing.assert_array_equal(sup.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                      np.asarray(want[1]))


@pytest.mark.parametrize("W,nd_pad", [(1, 64), (2, 128)])
def test_mesh_forms_equal_reference_mesh_forms(W, nd_pad):
    """The sharded wave (B1, the all-reduce, the threshold and the pack)
    and the sharded pair prune on a 1-rank mesh against the reference's
    ``wave_extend_prune_fn(make_mesh(1), ...)`` and ``pair_prune_fn``."""
    from spark_fsm_tpu.parallel.mesh import make_mesh
    from spark_fsm_tpu_torch.parallel.mesh import local_mesh

    jm, tm = make_mesh(1), local_mesh("cpu")
    P, S, C = 12, 161, 96
    pt, store = _operands(W + nd_pad, P, nd_pad + 5, 45, S, W)
    rng = np.random.default_rng(W)
    use_diff = rng.integers(0, 2, P).astype(bool)
    pref = rng.integers(0, P, C).astype(np.int32)
    item = rng.integers(0, 45, C).astype(np.int32)
    item[80:] = -1
    c_diff = rng.integers(0, 2, C).astype(bool)
    wave_fn = JSB.wave_extend_prune_fn(jm, W, nd_pad)
    pair_fn = JSB.pair_prune_fn(jm, W)
    for thr in (1, 50, S + 1):
        want = wave_fn(jnp.asarray(pt), jnp.asarray(store), jnp.int32(thr),
                       jnp.asarray(use_diff))
        sup, mask = SB.wave_prune_sharded(_t(pt), _t(store), thr, n_words=W,
                                          nd_pad=nd_pad, mesh=tm)
        np.testing.assert_array_equal(sup.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                      np.asarray(want[1]))
        want = pair_fn(jnp.asarray(pt), jnp.asarray(store), jnp.asarray(pref),
                       jnp.asarray(item), jnp.int32(thr),
                       jnp.asarray(c_diff))
        got = SB.pair_prune(_t(pt), _t(store), torch.from_numpy(pref),
                            torch.from_numpy(item), thr,
                            torch.from_numpy(c_diff), W, tm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm.reduce_stats()["all_reduces"] == 6
