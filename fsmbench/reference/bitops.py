"""NumPy bitmap primitives the SPADE oracle needs: a frozen copy of
``prefix_or_word``, ``sext_transform`` and ``support`` from
``spark_fsm_tpu_torch/ops/bitops_np.py`` at commit
af584b40603189c27f03b8d906643a82cdb45648.

Bit order: position p lives in word p // 32, bit p % 32, LSB-first.
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32
FULL = np.uint32(0xFFFFFFFF)


def prefix_or_word(w: np.ndarray) -> np.ndarray:
    """Within-word inclusive prefix OR: out bit p = OR of bits 0..p of w."""
    w = w.astype(U32, copy=True)
    for shift in (1, 2, 4, 8, 16):
        w |= w << U32(shift)
    return w


def sext_transform(b: np.ndarray) -> np.ndarray:
    """First-occurrence postfix mask over the last (word) axis: out bit p
    = 1 iff some bit q < p of the same sequence is set in ``b``."""
    b = np.asarray(b, dtype=U32)
    out = np.empty_like(b)
    carry = np.zeros(b.shape[:-1], dtype=bool)
    for j in range(b.shape[-1]):
        w = b[..., j]
        out[..., j] = (prefix_or_word(w) << U32(1)) | np.where(carry, FULL, U32(0))
        carry |= w != 0
    return out


def support(bitmap: np.ndarray) -> np.ndarray:
    """Sequence-count support: #sequences with any set bit.
    bitmap: [..., n_seq, n_words] -> [...] int64."""
    return np.count_nonzero((np.asarray(bitmap) != 0).any(axis=-1), axis=-1)
