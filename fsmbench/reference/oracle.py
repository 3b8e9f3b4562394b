"""CPU oracle miners: a frozen copy of
``spark_fsm_tpu_torch/models/oracle.py`` at commit
af584b40603189c27f03b8d906643a82cdb45648 (``contains``,
``mine_spade_vertical``, ``mine_spade``, ``contains_constrained``,
``brute_force_mine_constrained``, ``mine_cspade``), changed only in its
imports: the vertical build, the bitmap primitives, the max-start ops and
the canonical order are the reference's own copies.

``mine_spade`` is a SPAM-style DFS over the vertical bitmaps; its
enumeration (shared S/I candidate lists per equivalence class, ascending
item order) defines the pattern universe.  ``mine_cspade`` is the same DFS
over the max-start state under maxgap/maxwindow, and
``brute_force_mine_constrained`` its independent ground truth by direct
containment checks.  One numpy call per candidate: the ground truth at
small sizes; ``fast.py`` is the reference at full size.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from fsmbench.reference import bitops as B
from fsmbench.reference.canonical import Pattern, PatternResult, sort_patterns
from fsmbench.reference.vertical import Vertical as VerticalDB
from fsmbench.reference.vertical import build_vertical

Sequence = Tuple[Tuple[int, ...], ...]
SequenceDB = List[Sequence]


def contains(seq: Sequence, pattern: Pattern) -> bool:
    """True iff ``pattern`` occurs in ``seq`` (ordered itemset-subset match).

    Greedy leftmost matching is correct for plain containment: taking the
    earliest itemset that covers the next pattern element never removes later
    options.
    """
    p = 0
    for itemset in seq:
        if p == len(pattern):
            return True
        if set(pattern[p]).issubset(itemset):
            p += 1
    return p == len(pattern)


def mine_spade_vertical(
    vdb: VerticalDB,
    minsup_abs: int,
    max_pattern_itemsets: Optional[int] = None,
) -> List[PatternResult]:
    """SPAM-style DFS over a prebuilt vertical DB.

    Equivalence-class candidate pruning per Ayres et al. 2002: at each node
    with candidate lists (S, I), the frequent s-extension items S' become
    every child's S list; an s-child by item i gets I = {j in S' : j > i};
    an i-child by item i gets I = {j in I' : j > i} where I' are the
    frequent i-extension items.
    """
    bm = vdb.bitmaps  # [n_items, n_seq, n_words]
    n_items = vdb.n_items
    ids = vdb.item_ids
    results: List[PatternResult] = []

    root_items = [i for i in range(n_items) if int(vdb.item_supports[i]) >= minsup_abs]

    # Stack-based DFS; node = (pattern, bitmap, s_list, i_list).
    stack: List[Tuple[Pattern, np.ndarray, List[int], List[int]]] = []
    for i in reversed(root_items):
        pat: Pattern = ((int(ids[i]),),)
        results.append((pat, int(vdb.item_supports[i])))
        stack.append((pat, bm[i], root_items, [j for j in root_items if j > i]))

    while stack:
        pat, bmp, s_list, i_list = stack.pop()
        if max_pattern_itemsets is not None and len(pat) >= max_pattern_itemsets and not i_list:
            continue
        s_ok: List[Tuple[int, np.ndarray, int]] = []
        allow_s = max_pattern_itemsets is None or len(pat) < max_pattern_itemsets
        if allow_s and s_list:
            trans = B.sext_transform(bmp)
            for i in s_list:
                nb = trans & bm[i]
                sup = int(B.support(nb))
                if sup >= minsup_abs:
                    s_ok.append((i, nb, sup))
        s_items = [i for i, _, _ in s_ok]
        i_ok: List[Tuple[int, np.ndarray, int]] = []
        for i in i_list:
            nb = bmp & bm[i]
            sup = int(B.support(nb))
            if sup >= minsup_abs:
                i_ok.append((i, nb, sup))
        i_items = [i for i, _, _ in i_ok]

        # Push in reverse so DFS visits ascending item order, s before i.
        for i, nb, sup in reversed(i_ok):
            child = pat[:-1] + (pat[-1] + (int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, nb, s_items, [j for j in i_items if j > i]))
        for i, nb, sup in reversed(s_ok):
            child = pat + ((int(ids[i]),),)
            results.append((child, sup))
            stack.append((child, nb, s_items, [j for j in s_items if j > i]))
    return sort_patterns(results)


def mine_spade(
    db: SequenceDB,
    minsup_abs: int,
    max_pattern_itemsets: Optional[int] = None,
) -> List[PatternResult]:
    vdb = build_vertical(db, min_item_support=minsup_abs)
    if vdb.n_items == 0:
        return []
    return mine_spade_vertical(vdb, minsup_abs, max_pattern_itemsets)


# ---------------------------------------------------------------------------
# Constrained mining (maxgap / maxwindow)
# ---------------------------------------------------------------------------

def contains_constrained(
    seq: Sequence,
    pattern: Pattern,
    maxgap: Optional[int] = None,
    maxwindow: Optional[int] = None,
) -> bool:
    """True iff ``pattern`` has an occurrence with consecutive itemset-
    position gaps <= maxgap and total span <= maxwindow.

    Exhaustive DFS over position assignments (greedy matching is NOT valid
    under constraints), so only for small fixtures.
    """
    sets = [set(s) for s in pattern]
    n = len(seq)

    def ok_at(p: int, j: int) -> bool:
        return sets[j].issubset(seq[p])

    def dfs(j: int, prev: int, start: int) -> bool:
        if j == len(sets):
            return True
        hi = n if maxgap is None else min(n, prev + maxgap + 1)
        for p in range(prev + 1, hi):
            if maxwindow is not None and p - start > maxwindow:
                break
            if ok_at(p, j) and dfs(j + 1, p, start):
                return True
        return False

    for p0 in range(n):
        if ok_at(p0, 0) and dfs(1, p0, p0):
            return True
    return False


def brute_force_mine_constrained(
    db: SequenceDB,
    minsup_abs: int,
    maxgap: Optional[int] = None,
    maxwindow: Optional[int] = None,
    max_pattern_itemsets: int = 5,
    max_itemset_size: int = 3,
) -> List[PatternResult]:
    """Level-wise constrained mining by direct (unpruned) counting.

    Note the candidate frontier must NOT prune on the constrained support:
    under maxgap a super-pattern can be frequent while a non-contiguous
    sub-pattern is not, so candidates extend patterns frequent under the
    UNCONSTRAINED count (apriori-safe superset) and constrained support
    only decides output membership.
    """
    items = sorted({i for seq in db for itemset in seq for i in itemset})

    def csup(pat: Pattern) -> int:
        return sum(1 for s in db if contains_constrained(s, pat, maxgap, maxwindow))

    def usup(pat: Pattern) -> int:
        return sum(1 for s in db if contains(s, pat))

    freq_items = [i for i in items if usup(((i,),)) >= minsup_abs]
    results: List[PatternResult] = []
    frontier: List[Pattern] = [((i,),) for i in freq_items]
    for pat in frontier:
        results.append((pat, csup(pat)))
    while frontier:
        nxt: List[Pattern] = []
        for pat in frontier:
            cands: List[Pattern] = []
            if len(pat) < max_pattern_itemsets:
                cands.extend(pat + ((i,),) for i in freq_items)
            last = pat[-1]
            if len(last) < max_itemset_size:
                cands.extend(
                    pat[:-1] + (tuple(sorted(last + (i,))),)
                    for i in freq_items if i > last[-1]
                )
            for c in cands:
                if usup(c) >= minsup_abs:
                    nxt.append(c)
                    s = csup(c)
                    if s >= minsup_abs:
                        results.append((c, s))
        frontier = nxt
    return sort_patterns([(p, s) for p, s in results if s >= minsup_abs])


def mine_cspade(
    db: SequenceDB,
    minsup_abs: int,
    maxgap: Optional[int] = None,
    maxwindow: Optional[int] = None,
    max_pattern_itemsets: Optional[int] = None,
) -> List[PatternResult]:
    """CPU oracle for constrained SPADE using the max-start state
    (ops/maxstart_np.py).

    Enumeration: under maxgap, s-candidates are ALL frequent root items
    (sibling S-list pruning is unsound there — cSPADE's F2-join
    observation); with no gap bound the sibling prune applies as usual.
    i-candidates always use sibling pruning, which stays valid
    (i-extension keeps every occurrence's positions).  The DFS prunes on
    the CONSTRAINED (gap- and window-checked) support: it is anti-monotone
    under prefix growth — a valid child occurrence contains a valid
    same-start prefix occurrence — so the prune is exact.
    """
    from fsmbench.reference import maxstart_np as MS

    vdb = build_vertical(db, min_item_support=minsup_abs)
    if vdb.n_items == 0:
        return []
    bm = vdb.bitmaps
    ids = vdb.item_ids
    n_items = vdb.n_items
    results: List[PatternResult] = []

    root_items = [i for i in range(n_items) if int(vdb.item_supports[i]) >= minsup_abs]
    stack: List[Tuple[Pattern, np.ndarray, List[int], List[int]]] = []
    for i in reversed(root_items):
        pat: Pattern = ((int(ids[i]),),)
        results.append((pat, int(vdb.item_supports[i])))
        m0 = MS.root_state(bm[i])
        stack.append((pat, m0, root_items, [j for j in root_items if j > i]))

    while stack:
        pat, m, s_list, i_list = stack.pop()
        allow_s = max_pattern_itemsets is None or len(pat) < max_pattern_itemsets
        s_ok: List[Tuple[int, np.ndarray, int]] = []
        if allow_s:
            pm = MS.prev_max(m, maxgap)
            for i in s_list:
                occ = MS.expand_bits(bm[i])
                nm = np.where(occ & (pm >= 0), pm, MS.NONE16)
                # windowed support is anti-monotone under prefix growth (a
                # valid child occurrence contains a valid prefix occurrence
                # with the same start), so pruning on it is exact
                csup = int(MS.support(nm, maxwindow))
                if csup >= minsup_abs:
                    s_ok.append((i, nm, csup))
        i_ok: List[Tuple[int, np.ndarray, int]] = []
        for i in i_list:
            occ = MS.expand_bits(bm[i])
            nm = np.where(occ & (m >= 0), m, MS.NONE16)
            csup = int(MS.support(nm, maxwindow))
            if csup >= minsup_abs:
                i_ok.append((i, nm, csup))
        i_items = [i for i, _, _ in i_ok]
        s_items = [i for i, _, _ in s_ok]
        child_s = s_items if maxgap is None else root_items
        for i, nm, csup in reversed(i_ok):
            child = pat[:-1] + (pat[-1] + (int(ids[i]),),)
            results.append((child, csup))
            stack.append((child, nm, child_s, [j for j in i_items if j > i]))
        for i, nm, csup in reversed(s_ok):
            child = pat + ((int(ids[i]),),)
            results.append((child, csup))
            stack.append((child, nm, child_s, [j for j in s_items if j > i]))
    return sort_patterns(results)
