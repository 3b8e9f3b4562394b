"""NumPy bitmap primitives the oracles need (copy of
``spark_fsm_tpu/ops/bitops_np.py``: the SPADE half ``sext_transform``,
``i_extend``, ``s_extend``, ``support``; the TSR half ``prefix_or_incl``,
``suffix_or_incl``, ``shift_up_one``; the SPAM half ``popcount``,
``tail_mask``, ``pack_seq_bits``, ``support_popcount``, ``diffset_count``,
``support_from_diffset``).

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


def i_extend(prefix_bitmap: np.ndarray, item_bitmap: np.ndarray) -> np.ndarray:
    """Itemset extension: both end at the same position."""
    return prefix_bitmap & item_bitmap


def s_extend(prefix_bitmap: np.ndarray, item_bitmap: np.ndarray) -> np.ndarray:
    """Sequence extension: item strictly after the prefix's first end."""
    return sext_transform(prefix_bitmap) & item_bitmap


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


def popcount(w: np.ndarray) -> np.ndarray:
    """Per-word population count (SWAR), uint32 -> int32 same shape."""
    w = np.asarray(w, dtype=U32).copy()
    w -= (w >> U32(1)) & U32(0x55555555)
    w = (w & U32(0x33333333)) + ((w >> U32(2)) & U32(0x33333333))
    w = (w + (w >> U32(4))) & U32(0x0F0F0F0F)
    return ((w * U32(0x01010101)) >> U32(24)).astype(np.int32)


def tail_mask(n_valid: int, n_words: int) -> np.ndarray:
    """[n_words] uint32 mask keeping only bits 0..n_valid-1 of the
    flattened bit axis (bit ``p`` lives in word ``p // 32``): a popcount
    over a padded bit axis must AND it in first."""
    out = np.zeros(n_words, dtype=U32)
    full = min(n_valid // 32, n_words)
    out[:full] = FULL
    rem = n_valid - full * 32
    if 0 < rem and full < n_words:
        out[full] = (U32(1) << U32(rem)) - U32(1)
    return out


def pack_seq_bits(active: np.ndarray) -> np.ndarray:
    """Pack a boolean per-sequence indicator [..., n_seq] into LSB-first
    uint32 words [..., ceil(n_seq/32)], zero-padding the tail word (the
    SPAM support formulation: support = popcount of the packed words)."""
    active = np.asarray(active, dtype=bool)
    n_seq = active.shape[-1]
    n_w = max(1, -(-n_seq // 32))
    pad = n_w * 32 - n_seq
    if pad:
        active = np.concatenate(
            [active, np.zeros(active.shape[:-1] + (pad,), bool)], axis=-1)
    bits = active.reshape(active.shape[:-1] + (n_w, 32)).astype(U32)
    weights = (U32(1) << np.arange(32, dtype=U32))
    return (bits * weights).sum(axis=-1).astype(U32)


def support_popcount(bitmap: np.ndarray) -> np.ndarray:
    """Sequence-count support via the SPAM popcount formulation: collapse
    words -> per-sequence alive bit -> pack over the sequence axis ->
    popcount.  Bit-identical to :func:`support`."""
    alive = (np.asarray(bitmap) != 0).any(axis=-1)
    packed = pack_seq_bits(alive)
    return popcount(packed).sum(axis=-1).astype(np.int64)


def diffset_count(parent_bitmap: np.ndarray,
                  child_bitmap: np.ndarray) -> np.ndarray:
    """dEclat diffset size: #sequences alive in the parent but dead in the
    child, [..., n_seq, n_words] -> [...] int64.  Every join ANDs the
    (possibly transformed) parent row, so the child's alive set is a subset
    of the parent row's and ``support(child) == support(parent_row) -
    diffset_count`` holds exactly."""
    pa = (np.asarray(parent_bitmap) != 0).any(axis=-1)
    ca = (np.asarray(child_bitmap) != 0).any(axis=-1)
    return popcount(pack_seq_bits(pa & ~ca)).sum(axis=-1).astype(np.int64)


def support_from_diffset(parent_support, diffset_size):
    """dEclat support: ``support(parent_row) - |diffset|``."""
    return parent_support - diffset_size
