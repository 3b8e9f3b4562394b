"""NumPy max-start state for constrained (maxgap/maxwindow) SPADE: a frozen
copy of ``spark_fsm_tpu_torch/ops/maxstart_np.py`` at commit
af584b40603189c27f03b8d906643a82cdb45648.

The state is the max-start array M[..., p] (int16): the latest start
position over occurrences of the pattern that end at position p, or -1.
- i-extension by y: M'[p] = M[p] where y occurs at p, else -1;
- s-extension by y with maxgap g: M'[p] = max_{p-g <= q < p} M[q] where y
  occurs at p, else -1 (g=None: every q < p);
- support: #sequences with some p where M[p] >= 0 and p - M[p] <= w.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

NONE16 = np.int16(-1)


def expand_bits(words: np.ndarray) -> np.ndarray:
    """Unpack uint32 word bitmaps into a bool position axis.

    [..., n_words] uint32 -> [..., n_words*32] bool, position p = bit p%32
    of word p//32 (the layout of data/vertical.py).
    """
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).astype(bool)


def root_state(words: np.ndarray) -> np.ndarray:
    """M0 for a single item: its own position where it occurs, else -1."""
    occ = expand_bits(words)
    pos = np.arange(occ.shape[-1], dtype=np.int16)
    return np.where(occ, pos, NONE16)


def prev_max(m: np.ndarray, maxgap: Optional[int]) -> np.ndarray:
    """out[p] = max over q in [p-maxgap, p-1] of m[q] (all q<p if None)."""
    m = np.asarray(m, dtype=np.int16)
    p_axis = m.shape[-1]
    if maxgap is None or maxgap >= p_axis:
        run = np.maximum.accumulate(m, axis=-1)
        out = np.full_like(m, NONE16)
        out[..., 1:] = run[..., :-1]
        return out
    out = np.full_like(m, NONE16)
    for d in range(1, maxgap + 1):
        out[..., d:] = np.maximum(out[..., d:], m[..., :-d])
    return out


def s_extend(m: np.ndarray, item_words: np.ndarray, maxgap: Optional[int]) -> np.ndarray:
    occ = expand_bits(item_words)
    pm = prev_max(m, maxgap)
    return np.where(occ & (pm >= 0), pm, NONE16)


def i_extend(m: np.ndarray, item_words: np.ndarray) -> np.ndarray:
    occ = expand_bits(item_words)
    return np.where(occ & (m >= 0), m, NONE16)


def support(m: np.ndarray, maxwindow: Optional[int]) -> np.ndarray:
    """[..., n_seq, n_pos] -> [...] sequence counts under the window."""
    m = np.asarray(m)
    ok = m >= 0
    if maxwindow is not None:
        pos = np.arange(m.shape[-1], dtype=m.dtype)
        ok &= (pos - m) <= maxwindow
    return np.count_nonzero(ok.any(axis=-1), axis=-1)
