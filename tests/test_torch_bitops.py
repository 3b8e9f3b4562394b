"""Port parity: every ``bitops_torch`` function against its ``bitops_jax``
counterpart, bit-exact, on random words with bit 31 set and ragged tails.

Inputs are made with numpy from a seed and handed to both packages; the
port sees the same bits as int32 (``view(np.int32)``)."""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_fsm_tpu.ops import bitops_jax as BJ
from spark_fsm_tpu_torch.ops import bitops_torch as BT


def _words(rng, *shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    sparse = w & rng.integers(0, 2**32, shape, dtype=np.uint32)
    w = np.where(rng.random(shape) < 0.5, w, sparse)
    w = np.where(rng.random(shape) < 0.2, np.uint32(0), w)  # empty words too
    return (w | (rng.integers(0, 2, shape, dtype=np.uint32) << np.uint32(31))
            ).astype(np.uint32)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _bitmap(rng, W):
    return (_words(rng, 6, 37, W),)


def _pair(rng, W):
    return (_words(rng, 6, 37, W), _words(rng, 6, 37, W))


def _alive(rng, W):
    return (rng.random((5, 45)) < 0.4,)


# name -> (make_args(rng, W) -> args, whether the result holds uint32 bits)
CASES = {
    "prefix_or_word": (lambda rng, W: (_words(rng, 7, 33),), True),
    "suffix_or_word": (lambda rng, W: (_words(rng, 7, 33),), True),
    "sext_transform": (_bitmap, True),
    "prefix_or_incl": (_bitmap, True),
    "suffix_or_incl": (_bitmap, True),
    "shift_up_one": (_bitmap, True),
    "i_extend": (_pair, True),
    "s_extend": (_pair, True),
    "join": (lambda rng, W: _pair(rng, W) + (rng.random(6) < 0.5,), True),
    "popcount": (lambda rng, W: (_words(rng, 9, 31),), False),
    "tail_mask": (lambda rng, W: (32 * W - 5, W), True),
    "masked_popcount": (lambda rng, W: (_words(rng, 8, W), 32 * W - 7), False),
    "pack_seq_bits": (_alive, True),
    "support_popcount": (_bitmap, False),
    "alive_popcount": (_alive, False),
    "diffset_count": (lambda rng, W: (rng.random((5, 45)) < 0.6,
                                      rng.random((5, 45)) < 0.3), False),
    "support_from_diffset": (
        lambda rng, W: (rng.integers(0, 1000, 9).astype(np.int32),
                        rng.integers(0, 100, 9).astype(np.int32)), False),
    "contains_bits": (_bitmap, False),
    "support": (_bitmap, False),
}


@pytest.mark.parametrize("n_words", [1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bitops_torch_matches_jax(name, n_words):
    build, bits = CASES[name]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{n_words}".encode()))
    args = build(rng, n_words)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    want = np.asarray(getattr(BJ, name)(*jargs))
    got = getattr(BT, name)(*targs).numpy()
    if bits:
        if got.dtype == np.int32:
            got = got.view(np.uint32)
        assert want.dtype == np.uint32
    else:
        assert got.dtype in (np.int32, np.bool_), got.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))
