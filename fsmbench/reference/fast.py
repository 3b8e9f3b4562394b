"""The reference a run compares against: ``oracle.mine_spade_vertical`` and
``oracle.mine_cspade`` with the same enumeration (shared S/I candidate
lists per equivalence class, the cSPADE rule that under maxgap every
frequent root is an s-candidate), the same states and the same supports,
but each node's candidates counted in one array operation, and every
state kept only over the sequences where its pattern occurs (a row where
the pattern does not occur is all zero, or all -1, and no extension of it
can occur there).  The tests hold both miners to the frozen oracles.

``count`` turns a ``[candidates, rows]`` bool array (does the candidate
occur in that sequence) into the candidates' supports.  The default,
:func:`count_exact`, counts in int64; the control of ``control.py`` passes
:func:`count_fp16`.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from fsmbench.reference import maxstart_np as MS
from fsmbench.reference.bitops import sext_transform
from fsmbench.reference.canonical import PatternResult, sort_patterns
from fsmbench.reference.vertical import Vertical

# elements of the largest [candidates, rows, width] temporary
_BLOCK = 1 << 24

Count = Callable[[np.ndarray], np.ndarray]


def count_exact(live: np.ndarray) -> np.ndarray:
    return np.count_nonzero(live, axis=-1)


def count_fp16(live: np.ndarray) -> np.ndarray:
    """Supports held in float16: exact up to 2,048, rounded above it."""
    return np.count_nonzero(live, axis=-1).astype(np.float16)


def _supports(count: Count, live: np.ndarray) -> List[int]:
    return [int(s) for s in count(live)]


def _bitmap_children(base, rows, cands, bm, minsup, count):
    """Frequent children of a bitmap node: ``(item, rows, words, sup)`` of
    every candidate whose ``base & item`` support reaches ``minsup``."""
    out = []
    k, w = base.shape
    step = max(1, _BLOCK // max(1, k * w))
    for lo in range(0, len(cands), step):
        c = cands[lo:lo + step]
        x = bm[np.ix_(c, rows)] & base[None]
        live = (x != 0).any(axis=-1)
        for j, sup in enumerate(_supports(count, live)):
            if sup >= minsup:
                keep = live[j]
                out.append((c[j], rows[keep], x[j][keep], sup))
    return out


def mine_spade(vdb: Vertical, minsup: int,
               count: Count = count_exact) -> List[PatternResult]:
    """Every frequent sequential pattern of ``vdb`` at ``minsup``, with its
    support, in the canonical order."""
    bm, ids = vdb.bitmaps, vdb.item_ids
    root_items = [i for i in range(vdb.n_items)
                  if int(vdb.item_supports[i]) >= minsup]
    results: List[PatternResult] = []
    stack = []
    for i in reversed(root_items):
        rows = np.flatnonzero((bm[i] != 0).any(axis=-1))
        pat = ((int(ids[i]),),)
        results.append((pat, _supports(count, np.ones((1, len(rows)), bool))[0]))
        stack.append((pat, rows, bm[i][rows], root_items,
                      [j for j in root_items if j > i]))
    while stack:
        pat, rows, words, s_list, i_list = stack.pop()
        s_ok = (_bitmap_children(sext_transform(words), rows, s_list, bm,
                                 minsup, count) if s_list else [])
        i_ok = (_bitmap_children(words, rows, i_list, bm, minsup, count)
                if i_list else [])
        s_items = [c[0] for c in s_ok]
        i_items = [c[0] for c in i_ok]
        for i, r, x, sup in reversed(i_ok):
            child = pat[:-1] + (pat[-1] + (int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, r, x, s_items, [j for j in i_items if j > i]))
        for i, r, x, sup in reversed(s_ok):
            child = pat + ((int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, r, x, s_items, [j for j in s_items if j > i]))
    return sort_patterns(results)


def _state_children(base, rows, cands, bm, minsup, maxwindow, count):
    """Frequent children of a max-start node: ``(item, rows, state, sup)``
    of every candidate whose windowed support reaches ``minsup``; ``base``
    is the node's state (i-extension) or its ``prev_max`` (s-extension)."""
    out = []
    k, p = base.shape
    pos = np.arange(p, dtype=np.int16)
    step = max(1, _BLOCK // max(1, k * p))
    for lo in range(0, len(cands), step):
        c = cands[lo:lo + step]
        occ = MS.expand_bits(bm[np.ix_(c, rows)])
        nm = np.where(occ & (base >= 0)[None], base[None], MS.NONE16)
        ok = nm >= 0
        if maxwindow is not None:
            ok &= (pos - nm) <= maxwindow
        live = ok.any(axis=-1)
        for j, sup in enumerate(_supports(count, live)):
            if sup >= minsup:
                keep = (nm[j] >= 0).any(axis=-1)
                out.append((c[j], rows[keep], nm[j][keep], sup))
    return out


def mine_cspade(vdb: Vertical, minsup: int, maxgap: Optional[int],
                maxwindow: Optional[int],
                count: Count = count_exact) -> List[PatternResult]:
    """Every pattern of ``vdb`` whose support under maxgap/maxwindow
    reaches ``minsup``, with that support, in the canonical order."""
    bm, ids = vdb.bitmaps, vdb.item_ids
    root_items = [i for i in range(vdb.n_items)
                  if int(vdb.item_supports[i]) >= minsup]
    results: List[PatternResult] = []
    stack = []
    for i in reversed(root_items):
        rows = np.flatnonzero((bm[i] != 0).any(axis=-1))
        pat = ((int(ids[i]),),)
        results.append((pat, _supports(count, np.ones((1, len(rows)), bool))[0]))
        stack.append((pat, rows, MS.root_state(bm[i][rows]), root_items,
                      [j for j in root_items if j > i]))
    while stack:
        pat, rows, m, s_list, i_list = stack.pop()
        s_ok = (_state_children(MS.prev_max(m, maxgap), rows, s_list, bm,
                                minsup, maxwindow, count) if s_list else [])
        i_ok = (_state_children(m, rows, i_list, bm, minsup, maxwindow, count)
                if i_list else [])
        s_items = [c[0] for c in s_ok]
        i_items = [c[0] for c in i_ok]
        child_s = s_items if maxgap is None else root_items
        for i, r, nm, sup in reversed(i_ok):
            child = pat[:-1] + (pat[-1] + (int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, r, nm, child_s, [j for j in i_items if j > i]))
        for i, r, nm, sup in reversed(s_ok):
            child = pat + ((int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, r, nm, child_s, [j for j in s_items if j > i]))
    return sort_patterns(results)
