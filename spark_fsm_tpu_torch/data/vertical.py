"""Vertical bitmap sequence database (copy of ``spark_fsm_tpu/data/vertical.py``).

Only ``VerticalDB``, ``build_vertical`` and ``abs_minsup`` are carried over,
plus the numpy tokenizer ``flatten_numpy`` from
``spark_fsm_tpu/data/fasttok.py`` (the reference's always-correct path; its
native C tokenizer produces the same bytes and is not copied).

For each kept item, a ``[n_seq, n_words]`` uint32 bitmap where bit ``p`` of
sequence ``s`` (word ``p // 32``, bit ``p % 32``, LSB-first) is set iff the
item occurs in itemset ``p`` of sequence ``s``.  Positions are the original
itemset indices: the frequent-item projection drops rows, never renumbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from spark_fsm_tpu_torch.data.spmf import SequenceDB

WORD_BITS = 32


@dataclasses.dataclass
class VerticalDB:
    """Dense vertical bitmap database over the frequent-item projection.

    The authoritative representation is the token table — one row per
    kept-item occurrence: ``tok_item`` (dense item index), ``tok_seq``,
    ``tok_word``/``tok_mask`` (bit address of the itemset position).  Device
    engines scatter-build their bitmap store from it; CPU consumers use the
    lazily-built dense ``bitmaps``.

    Attributes:
      item_ids:   [n_items] int32, original SPMF item ids, strictly ascending.
      seq_lengths:[n_seq] int32, number of itemsets per sequence.
      n_positions: padded position capacity = n_words * 32.
      item_supports: [n_items] int32 sequence-support of each kept item.
      tok_*: [n_tokens] int32/uint32 token table (see above).
    """

    item_ids: np.ndarray
    seq_lengths: np.ndarray
    n_positions: int
    item_supports: np.ndarray
    tok_item: np.ndarray
    tok_seq: np.ndarray
    tok_word: np.ndarray
    tok_mask: np.ndarray
    _n_seq: int
    _n_words: int
    _bitmaps: Optional[np.ndarray] = None

    @property
    def n_items(self) -> int:
        return int(self.item_ids.shape[0])

    @property
    def n_sequences(self) -> int:
        return self._n_seq

    @property
    def n_words(self) -> int:
        return self._n_words

    @property
    def bitmaps(self) -> np.ndarray:
        """Dense [n_items, n_seq, n_words] bitmaps, built on first use."""
        if self._bitmaps is None:
            bm = np.zeros(self.n_items * self._n_seq * self._n_words, np.uint32)
            flat = (self.tok_item.astype(np.int64) * self._n_seq
                    + self.tok_seq) * self._n_words + self.tok_word
            # distinct (seq,pos) per item occurrence => add == bitwise OR
            np.add.at(bm, flat, self.tok_mask)
            self._bitmaps = bm.reshape(self.n_items, self._n_seq, self._n_words)
        return self._bitmaps

    def nbytes(self) -> int:
        return self.n_items * self._n_seq * self._n_words * 4


def flatten_numpy(db) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(seq_lengths int32, itemset_counts int64, raw_items int64) for a
    SequenceDB — the one-pass tokenize ``build_vertical`` starts from."""
    lengths = np.fromiter((len(s) for s in db), np.int32, count=len(db))
    counts = np.fromiter((len(iset) for s in db for iset in s), np.int64)
    items = np.fromiter((it for s in db for iset in s for it in iset),
                        np.int64)
    return lengths, counts, items


def build_vertical(
    db: SequenceDB,
    min_item_support: int = 1,
    pad_sequences_to: Optional[int] = None,
    word_multiple: int = 1,
) -> VerticalDB:
    """Build the vertical bitmap DB, keeping only items with sequence-support
    >= ``min_item_support`` (the frequent-item projection; positions are NOT
    renumbered).

    ``pad_sequences_to`` pads the sequence axis with all-zero sequences;
    ``word_multiple`` pads n_words up.
    """
    n_seq = len(db)
    if n_seq == 0:
        raise ValueError("empty sequence database")

    seq_lengths, counts, raw_items = flatten_numpy(db)
    n_itemsets_total = len(counts)
    # position (itemset index within its sequence) per itemset, then per token
    seq_of_itemset = np.repeat(np.arange(n_seq, dtype=np.int64), seq_lengths)
    starts = np.concatenate(([0], np.cumsum(seq_lengths)))[seq_of_itemset]
    pos_of_itemset = np.arange(n_itemsets_total, dtype=np.int64) - starts
    tok_seq = np.repeat(seq_of_itemset, counts)
    tok_pos = np.repeat(pos_of_itemset, counts)

    max_len = int(seq_lengths.max())
    n_words = max(1, -(-max_len // WORD_BITS))
    if word_multiple > 1:
        n_words = -(-n_words // word_multiple) * word_multiple

    # Sequence-support per item: count unique (item, seq) pairs.
    pair = raw_items * n_seq + tok_seq
    uniq_pair = np.unique(pair)
    uniq_item = uniq_pair // n_seq
    items_all, sup_all = np.unique(uniq_item, return_counts=True)
    keep = sup_all >= min_item_support
    kept = items_all[keep]
    item_supports = sup_all[keep].astype(np.int32)
    n_items = len(kept)

    # Remap raw item ids -> dense kept index; drop tokens of dropped items.
    idx = np.searchsorted(kept, raw_items)
    idx_clip = np.minimum(idx, max(n_items - 1, 0))
    if n_items == 0:
        tok_keep = np.zeros(len(raw_items), dtype=bool)
    else:
        tok_keep = kept[idx_clip] == raw_items
    tok_item = idx_clip[tok_keep]
    tok_seq_k = tok_seq[tok_keep]
    tok_pos_k = tok_pos[tok_keep]
    # Dedup (item, seq, pos): the scatter-ADD consumers rely on each token
    # being a distinct bit.
    key = (tok_item * n_seq + tok_seq_k) * (np.int64(n_words) * WORD_BITS) + tok_pos_k
    uniq = np.unique(key)
    tok_pos_k = uniq % (np.int64(n_words) * WORD_BITS)
    rest = uniq // (np.int64(n_words) * WORD_BITS)
    tok_seq_k = (rest % n_seq).astype(np.int32)
    tok_item = (rest // n_seq).astype(np.int32)
    tok_word = (tok_pos_k // WORD_BITS).astype(np.int32)
    tok_mask = (np.uint32(1) << (tok_pos_k % WORD_BITS).astype(np.uint32))

    n_seq_padded = n_seq if pad_sequences_to is None else max(n_seq, pad_sequences_to)
    seq_lengths_padded = np.zeros(n_seq_padded, dtype=np.int32)
    seq_lengths_padded[:n_seq] = seq_lengths
    return VerticalDB(
        item_ids=kept.astype(np.int32),
        seq_lengths=seq_lengths_padded,
        n_positions=n_words * WORD_BITS,
        item_supports=item_supports,
        tok_item=tok_item,
        tok_seq=tok_seq_k,
        tok_word=tok_word,
        tok_mask=tok_mask,
        _n_seq=n_seq_padded,
        _n_words=n_words,
    )


def abs_minsup(rel_minsup: float, n_sequences: int) -> int:
    """Relative minsup (e.g. 0.001 = 0.1%) -> absolute sequence count:
    ``ceil(minsup * |DB|)``, floored at 1."""
    return max(1, int(np.ceil(rel_minsup * n_sequences)))
