"""CPU oracle miner (copy of ``mine_spade``/``mine_spade_vertical`` from
``spark_fsm_tpu/models/oracle.py``).

SPAM-style DFS over the vertical bitmap DB with numpy bitmaps.  Its
enumeration (shared S/I candidate lists per equivalence class, ascending
item order) defines the canonical pattern universe the engines reproduce;
``chip_smoke.py`` holds the port's GPU mine against it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import VerticalDB, build_vertical
from spark_fsm_tpu_torch.ops import bitops_np as B
from spark_fsm_tpu_torch.utils.canonical import Pattern, PatternResult, sort_patterns


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
