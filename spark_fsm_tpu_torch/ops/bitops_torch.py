"""Torch bitmap primitives — port of ``spark_fsm_tpu/ops/bitops_jax.py``.

Bitmaps are ``torch.int32`` tensors holding the same bits as the
reference's ``uint32`` (torch's CPU ``uint32`` has no shifts, ``+`` or
``index_put_``).  Left shifts and ``&``/``|`` act on the bits exactly as on
uint32.  ``>>`` on int32 is ARITHMETIC (it copies bit 31), so every right
shift here goes through :func:`_shr`, which masks the copied sign bits off
to give the logical shift the reference's uint32 ``>>`` performs.

The word axis is the last axis.  Semantics:
- ``sext_transform``: per sequence, set all bits strictly after the first
  set bit (first-occurrence postfix mask) — a carry chain toward higher
  words;
- ``i_extend``: AND at identical positions;
- ``support``: #sequences with any surviving bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _shr(w: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words holding uint32 bits."""
    return (w >> k) & ((1 << (32 - k)) - 1)


def _fill(carry: torch.Tensor) -> torch.Tensor:
    """bool -> int32 all-ones (True) or zero (False) words."""
    return -carry.to(torch.int32)


def prefix_or_word(w: torch.Tensor) -> torch.Tensor:
    """Within-word inclusive prefix OR (bit p = OR of bits 0..p)."""
    for shift in (1, 2, 4, 8, 16):
        w = w | (w << shift)
    return w


def sext_transform(b: torch.Tensor) -> torch.Tensor:
    """First-occurrence postfix mask over the last (word) axis."""
    carry = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    outs = []
    for j in range(b.shape[-1]):
        w = b[..., j]
        outs.append((prefix_or_word(w) << 1) | _fill(carry))
        carry = carry | (w != 0)
    return torch.stack(outs, dim=-1)


def prefix_or_incl(b: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix OR (bit p = any bit q <= p)."""
    carry = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    outs = []
    for j in range(b.shape[-1]):
        w = b[..., j]
        outs.append(prefix_or_word(w) | _fill(carry))
        carry = carry | (w != 0)
    return torch.stack(outs, dim=-1)


def suffix_or_word(w: torch.Tensor) -> torch.Tensor:
    """Within-word inclusive suffix OR (bit p = OR of bits p..31)."""
    for shift in (1, 2, 4, 8, 16):
        w = w | _shr(w, shift)
    return w


def suffix_or_incl(b: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix OR (bit p = any bit q >= p)."""
    carry = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    outs = []
    for j in range(b.shape[-1] - 1, -1, -1):
        w = b[..., j]
        outs.append(suffix_or_word(w) | _fill(carry))
        carry = carry | (w != 0)
    return torch.stack(outs[::-1], dim=-1)


def shift_up_one(b: torch.Tensor) -> torch.Tensor:
    """Multiword shift toward higher positions by 1 (cross-word carries).
    The carry is bit 31 of the previous word: a logical ``>> 31``."""
    carry = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    outs = []
    for j in range(b.shape[-1]):
        w = b[..., j]
        outs.append((w << 1) | carry)
        carry = _shr(w, 31)
    return torch.stack(outs, dim=-1)


def i_extend(prefix_bitmap: torch.Tensor, item_bitmap: torch.Tensor) -> torch.Tensor:
    return prefix_bitmap & item_bitmap


def s_extend(prefix_bitmap: torch.Tensor, item_bitmap: torch.Tensor) -> torch.Tensor:
    return sext_transform(prefix_bitmap) & item_bitmap


def join(prefix_bitmap: torch.Tensor, item_bitmap: torch.Tensor, is_s) -> torch.Tensor:
    """Temporal join with per-candidate extension type: ``is_s``
    broadcasts against the leading (candidate) axes; True selects
    s-extension, False i-extension."""
    is_s = torch.as_tensor(is_s, dtype=torch.bool, device=prefix_bitmap.device)
    sel = is_s[(...,) + (None,) * (prefix_bitmap.dim() - is_s.dim())]
    return torch.where(sel, sext_transform(prefix_bitmap), prefix_bitmap) & item_bitmap


def popcount(w: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR), int32 bits -> int32 same shape.
    Every right shift is logical; the final multiply wraps like uint32."""
    w = w - (_shr(w, 1) & 0x55555555)
    w = (w & 0x33333333) + (_shr(w, 2) & 0x33333333)
    w = (w + _shr(w, 4)) & 0x0F0F0F0F
    return _shr(w * 0x01010101, 24)


def tail_mask(n_valid: int, n_words: int, device=None) -> torch.Tensor:
    """[n_words] mask of the valid bits (bit ``p`` lives in word
    ``p // 32``); popcount reductions must apply it because
    ``sext_transform`` saturates the tail word's padding bits."""
    out = np.zeros(n_words, dtype=np.uint32)
    full = min(n_valid // 32, n_words)
    out[:full] = 0xFFFFFFFF
    rem = n_valid - full * 32
    if 0 < rem and full < n_words:
        out[full] = (1 << rem) - 1
    return torch.from_numpy(out.view(np.int32)).to(device)


def masked_popcount(b: torch.Tensor, n_valid: int) -> torch.Tensor:
    """[..., n_words] -> [...] int32 set bits at VALID positions only."""
    mask = tail_mask(n_valid, b.shape[-1], device=b.device)
    return torch.sum(popcount(b & mask), dim=-1, dtype=torch.int32)


def pack_seq_bits(active: torch.Tensor) -> torch.Tensor:
    """Pack boolean [..., n_seq] into LSB-first words [..., ceil(n_seq/32)]
    with an all-zero tail pad.  The bits are distinct, so their int32 sum
    is their OR and cannot overflow."""
    n_seq = active.shape[-1]
    n_w = max(1, -(-n_seq // 32))
    pad = n_w * 32 - n_seq
    if pad:
        active = torch.cat(
            [active, torch.zeros(active.shape[:-1] + (pad,), dtype=torch.bool,
                                 device=active.device)], dim=-1)
    bits = active.reshape(active.shape[:-1] + (n_w, 32)).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=active.device)
    return torch.sum(bits << shifts, dim=-1, dtype=torch.int32)


def support_popcount(bitmap: torch.Tensor) -> torch.Tensor:
    """[..., n_seq, n_words] -> [...] int32 support via pack+popcount —
    bit-identical to :func:`support`."""
    packed = pack_seq_bits(contains_bits(bitmap))
    return torch.sum(popcount(packed), dim=-1, dtype=torch.int32)


def alive_popcount(alive: torch.Tensor) -> torch.Tensor:
    """[..., n_seq] bool -> [...] int32 count of alive sequences."""
    return torch.sum(popcount(pack_seq_bits(alive)), dim=-1, dtype=torch.int32)


def diffset_count(parent_alive: torch.Tensor, child_alive: torch.Tensor) -> torch.Tensor:
    """dEclat diffset size: #sequences alive in the parent row but dead
    in the child join, [..., n_seq] bool pair -> [...] int32."""
    return alive_popcount(parent_alive & ~child_alive)


def support_from_diffset(parent_support: torch.Tensor,
                         diffset_size: torch.Tensor) -> torch.Tensor:
    """dEclat support identity ``support(parent_row) - |diffset|``."""
    return parent_support - diffset_size


def contains_bits(bitmap: torch.Tensor) -> torch.Tensor:
    """[..., n_seq, n_words] -> [..., n_seq] bool: any bit set per sequence."""
    return torch.any(bitmap != 0, dim=-1)


def support(bitmap: torch.Tensor) -> torch.Tensor:
    """[..., n_seq, n_words] -> [...] int32 sequence-count support."""
    return torch.sum(contains_bits(bitmap), dim=-1, dtype=torch.int32)
