"""Torch mirrors of ``ops/maxstart_np.py`` (constrained-SPADE max-start
state) — port of ``spark_fsm_tpu/ops/maxstart_jax.py``.

The state ``M[..., p]`` is the latest start over occurrences of a pattern
that end at position p, or -1 (see ``maxstart_np``).  Every op is
elementwise work or a scan over the position axis (the minor axis).
Word bitmaps arrive as int32 words holding uint32 bits (the engines' store
layout).  States are int8 when positions fit (``n_pos <= 127``), else
int16 (:func:`state_dtype`); the functions keep their input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NONE = -1


def state_dtype(n_pos: int) -> torch.dtype:
    """int8 when every position fits, else int16 (the reference engine's
    choice)."""
    return torch.int8 if n_pos <= 127 else torch.int16


def expand_bits(words: torch.Tensor) -> torch.Tensor:
    """``[..., n_words]`` int32 words -> ``[..., n_words * 32]`` bool,
    position p = bit p % 32 of word p // 32 (LSB first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).bool()


def root_state(words: torch.Tensor,
               dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """M0 for a single item: its own position where it occurs, else -1."""
    occ = expand_bits(words)
    pos = torch.arange(occ.shape[-1], dtype=dtype, device=words.device)
    return torch.where(occ, pos, NONE).to(dtype)


def prev_max(m: torch.Tensor, maxgap: Optional[int]) -> torch.Tensor:
    """``out[p]`` = max over q in [p - maxgap, p - 1] of ``m[q]`` (every
    q < p when ``maxgap`` is None): a running max for the unbounded gap,
    ``maxgap`` shifted maxima otherwise."""
    p_axis = m.shape[-1]
    if maxgap is None or maxgap >= p_axis:
        run = torch.cummax(m, dim=-1).values
        return torch.cat([torch.full_like(m[..., :1], NONE), run[..., :-1]],
                         dim=-1)
    out = torch.full_like(m, NONE)
    for d in range(1, maxgap + 1):
        shifted = torch.cat([torch.full_like(m[..., :d], NONE),
                             m[..., :-d]], dim=-1)
        out = torch.maximum(out, shifted)
    return out


def s_extend(m: torch.Tensor, item_words: torch.Tensor,
             maxgap: Optional[int]) -> torch.Tensor:
    occ = expand_bits(item_words)
    pm = prev_max(m, maxgap)
    return torch.where(occ & (pm >= 0), pm, NONE).to(m.dtype)


def i_extend(m: torch.Tensor, item_words: torch.Tensor) -> torch.Tensor:
    occ = expand_bits(item_words)
    return torch.where(occ & (m >= 0), m, NONE).to(m.dtype)


def support(m: torch.Tensor, maxwindow: Optional[int]) -> torch.Tensor:
    """``[..., n_seq, n_pos]`` -> ``[...]`` int32 sequence counts under the
    window.  A span is at most ``n_pos``, so a wider window is clamped to
    it (the test is unchanged, and the bound stays inside the state's
    dtype)."""
    ok = m >= 0
    if maxwindow is not None:
        n_pos = m.shape[-1]
        pos = torch.arange(n_pos, dtype=m.dtype, device=m.device)
        ok = ok & ((pos - m) <= min(int(maxwindow), n_pos))
    return ok.any(-1).sum(-1, dtype=torch.int32)
