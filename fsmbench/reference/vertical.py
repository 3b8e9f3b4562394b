"""The reference's own vertical bitmap database, built from the sequence
database with plain Python and NumPy.

For each item whose sequence support reaches ``min_item_support``, in
ascending id order, a ``[n_seq, n_words]`` uint32 bitmap: bit ``p`` of
sequence ``s`` (word ``p // 32``, bit ``p % 32``) is set iff the item
occurs in itemset ``p`` of ``s``.  Positions are the itemsets' indices in
their sequence; dropping infrequent items renumbers nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WORD_BITS = 32


@dataclasses.dataclass
class Vertical:
    item_ids: np.ndarray       # [n_items] int64, ascending
    item_supports: np.ndarray  # [n_items] int64
    bitmaps: np.ndarray        # [n_items, n_seq, n_words] uint32

    @property
    def n_items(self) -> int:
        return int(self.item_ids.shape[0])


def build_vertical(db, min_item_support: int = 1) -> Vertical:
    n_seq = len(db)
    max_len = max((len(s) for s in db), default=0)
    n_words = max(1, -(-max_len // WORD_BITS))
    support = {}
    for seq in db:
        for item in {i for itemset in seq for i in itemset}:
            support[item] = support.get(item, 0) + 1
    kept = sorted(i for i, c in support.items() if c >= min_item_support)
    index = {item: k for k, item in enumerate(kept)}
    ks, ss, ws, bits = [], [], [], []
    for s, seq in enumerate(db):
        for p, itemset in enumerate(seq):
            for item in itemset:
                k = index.get(item)
                if k is not None:
                    ks.append(k)
                    ss.append(s)
                    ws.append(p // WORD_BITS)
                    bits.append(1 << (p % WORD_BITS))
    bm = np.zeros((len(kept), n_seq, n_words), np.uint32)
    np.bitwise_or.at(bm, (np.asarray(ks, np.int64), np.asarray(ss, np.int64),
                          np.asarray(ws, np.int64)),
                     np.asarray(bits, np.uint32))
    return Vertical(np.asarray(kept, np.int64),
                    np.asarray([support[i] for i in kept], np.int64), bm)
