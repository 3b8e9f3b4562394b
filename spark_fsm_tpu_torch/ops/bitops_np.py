"""NumPy bitmap primitives the oracles need (copy of the
``sext_transform``/``support`` half of ``spark_fsm_tpu/ops/bitops_np.py``,
plus the TSR half: ``prefix_or_incl``, ``suffix_or_incl``, ``shift_up_one``).

- i-extension: bitmap AND at identical positions;
- s-extension: per sequence, set every bit strictly after the FIRST set bit
  ("first-occurrence postfix mask"), then AND with the item bitmap;
- support: number of sequences whose slice of the result is nonzero.

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


def prefix_or_incl(b: np.ndarray) -> np.ndarray:
    """Inclusive prefix OR: out bit p = 1 iff some bit q <= p is set (TSR:
    "x has occurred by position p")."""
    b = np.asarray(b, dtype=U32)
    out = np.empty_like(b)
    carry = np.zeros(b.shape[:-1], dtype=bool)
    for j in range(b.shape[-1]):
        w = b[..., j]
        out[..., j] = prefix_or_word(w) | np.where(carry, FULL, U32(0))
        carry |= w != 0
    return out


def suffix_or_word(w: np.ndarray) -> np.ndarray:
    """Within-word inclusive suffix OR: out bit p = OR of bits p..31 of w."""
    w = w.astype(U32, copy=True)
    for shift in (1, 2, 4, 8, 16):
        w |= w >> U32(shift)
    return w


def suffix_or_incl(b: np.ndarray) -> np.ndarray:
    """Inclusive suffix OR: out bit p = 1 iff some bit q >= p is set (TSR:
    "y occurs at or after position p")."""
    b = np.asarray(b, dtype=U32)
    out = np.empty_like(b)
    carry = np.zeros(b.shape[:-1], dtype=bool)
    for j in range(b.shape[-1] - 1, -1, -1):
        w = b[..., j]
        out[..., j] = suffix_or_word(w) | np.where(carry, FULL, U32(0))
        carry |= w != 0
    return out


def shift_up_one(b: np.ndarray) -> np.ndarray:
    """Shift each sequence's bitvector one position higher (bit p -> p+1),
    carrying across words.  ``(A << 1) & C != 0`` is the TSR rule test."""
    b = np.asarray(b, dtype=U32)
    out = np.empty_like(b)
    carry = np.zeros(b.shape[:-1], dtype=U32)
    for j in range(b.shape[-1]):
        w = b[..., j]
        out[..., j] = ((w << U32(1)) & FULL) | carry
        carry = w >> U32(31)
    return out
