"""Vertical bitmap sequence database (copy of ``spark_fsm_tpu/data/vertical.py``).

Carried over: ``VerticalDB`` (with its id-list view), ``build_vertical``,
``abs_minsup``, the hybrid store's ``idlist_join_support``, ``RepPlan`` and
``rep_plan``, the planner's ``DatasetStats`` and ``dataset_stats``.
``build_vertical`` and ``dataset_stats`` tokenize through
``data/fasttok.py``: the native C tokenizer, or the numpy flatten when it
cannot be built (the same bytes either way).

For each kept item, a ``[n_seq, n_words]`` uint32 bitmap where bit ``p`` of
sequence ``s`` (word ``p // 32``, bit ``p % 32``, LSB-first) is set iff the
item occurs in itemset ``p`` of sequence ``s``.  Positions are the original
itemset indices: the frequent-item projection drops rows, never renumbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from spark_fsm_tpu_torch.data.fasttok import tokenize
from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.utils import obs

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

    # The token table is item-major (sorted by (item, seq, pos) through the
    # dedup key of build_vertical), so each item's id-list is a contiguous
    # slice: the sparse half of the hybrid store reads these slices and
    # never builds the item's dense row.

    @property
    def _tok_ptr(self) -> np.ndarray:
        """[n_items + 1] row pointer into the item-major token table."""
        ptr = getattr(self, "_tok_ptr_cache", None)
        if ptr is None:
            ptr = np.searchsorted(
                self.tok_item, np.arange(self.n_items + 1, dtype=np.int64))
            self._tok_ptr_cache = ptr
        return ptr

    def idlist(self, i: int):
        """Item ``i``'s id-list: (tok_seq, tok_word, tok_mask) slices,
        one entry per (sequence, position) occurrence."""
        ptr = self._tok_ptr
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        return self.tok_seq[lo:hi], self.tok_word[lo:hi], self.tok_mask[lo:hi]

    def idlist_lengths(self) -> np.ndarray:
        """[n_items] int64 token count per item (id-list sizes)."""
        return np.diff(self._tok_ptr)


def idlist_join_support(prefix_bitmap: np.ndarray, tok_seq: np.ndarray,
                        tok_word: np.ndarray, tok_mask: np.ndarray) -> int:
    """Support of ``prefix AND item`` evaluated against the item's id-list
    (the sparse-representation join): a token survives iff the prefix
    bitmap (the plain row for an i-extension, the ``sext_transform``-ed row
    for an s-extension) has its bit set; the support is the count of
    distinct sequences with a survivor.  Equal to ``support(prefix &
    bitmaps[i])`` without touching the item's dense row."""
    hit = (prefix_bitmap[tok_seq, tok_word] & tok_mask) != 0
    return int(np.unique(tok_seq[hit]).size)


@dataclasses.dataclass(frozen=True)
class RepPlan:
    """Per-item vertical-representation choice for one mine: ``rep[i]``
    True holds item ``i`` as a dense bitmap row (a wave lane), False as an
    id-list (a sparse pair lane).  ``pin`` records whether the split was
    density-routed ("auto") or pinned ("bitmap"/"idlist").  The plan picks
    which path computes each support, never the support itself."""

    rep: np.ndarray          # [n_items] bool, True = dense bitmap
    densities: np.ndarray    # [n_items] float64 item support / n_seq
    crossover: float
    pin: str                 # "auto" | "bitmap" | "idlist"

    @property
    def n_dense(self) -> int:
        return int(np.count_nonzero(self.rep))

    @property
    def n_sparse(self) -> int:
        return int(self.rep.size) - self.n_dense

    def as_attrs(self) -> dict:
        """Flat numeric/str summary for the planner trace span."""
        d = self.densities
        return {
            "representation": self.pin,
            "density_crossover": round(float(self.crossover), 6),
            "dense_items": self.n_dense,
            "idlist_items": self.n_sparse,
            "min_item_density": round(float(d.min()), 6) if d.size else 0.0,
            "max_item_density": round(float(d.max()), 6) if d.size else 0.0,
        }


def rep_plan(item_supports: np.ndarray, n_sequences: int, *,
             crossover: float, pin: str = "auto") -> RepPlan:
    """Pick a representation per item: density (support over the sequence
    axis, the fill of its dense row) at or above ``crossover`` routes to
    the bitmap, below it to the id-list.  ``pin`` forces a uniform store."""
    sup = np.asarray(item_supports, dtype=np.int64)
    d = sup / float(max(1, int(n_sequences)))
    if pin == "bitmap":
        rep = np.ones(sup.shape, dtype=bool)
    elif pin == "idlist":
        rep = np.zeros(sup.shape, dtype=bool)
    elif pin == "auto":
        rep = d >= float(crossover)
    else:
        raise ValueError(
            f"representation must be auto|bitmap|idlist, got {pin!r}")
    return RepPlan(rep=rep, densities=d, crossover=float(crossover), pin=pin)


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
    ``word_multiple`` pads n_words up.  Traced, the build is one
    ``vertical.build`` span.
    """
    n_seq = len(db)
    if n_seq == 0:
        raise ValueError("empty sequence database")
    with obs.span("vertical.build", sequences=n_seq):
        return _build_vertical(db, min_item_support, pad_sequences_to,
                               word_multiple)


def _build_vertical(db: SequenceDB, min_item_support: int,
                    pad_sequences_to: Optional[int],
                    word_multiple: int) -> VerticalDB:
    n_seq = len(db)
    seq_lengths, counts, raw_items = tokenize(db)
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


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    """Shape and density summary of a SequenceDB, the engine planner's
    input (``service/planner.py``).  ``alphabet`` and ``density`` are taken
    over the frequent-item projection at ``min_item_support`` (1 = the raw
    alphabet): ``density`` is distinct (item, sequence) pairs over
    ``alphabet * n_sequences``, the expected fill of the vertical bitmaps."""

    n_sequences: int
    n_itemsets: int
    n_tokens: int
    alphabet: int
    max_len: int
    avg_len: float
    n_words: int
    density: float


def dataset_stats(db: SequenceDB,
                  min_item_support: int = 1) -> DatasetStats:
    """One vectorized pass over the horizontal DB; no bitmap is built.
    ``min_item_support`` applies the projection ``build_vertical`` will."""
    n_seq = len(db)
    if n_seq == 0:
        return DatasetStats(0, 0, 0, 0, 0, 0.0, 1, 0.0)
    seq_lengths, counts, raw_items = tokenize(db)
    n_itemsets = int(len(counts))
    n_tokens = int(len(raw_items))
    max_len = int(seq_lengths.max())
    n_words = max(1, -(-max_len // WORD_BITS))
    alphabet = 0
    density = 0.0
    if n_tokens:
        seq_of_itemset = np.repeat(np.arange(n_seq, dtype=np.int64),
                                   seq_lengths)
        tok_seq = np.repeat(seq_of_itemset, counts)
        uniq_pair = np.unique(raw_items.astype(np.int64) * n_seq
                              + tok_seq)
        _, sup_all = np.unique(uniq_pair // n_seq, return_counts=True)
        kept = sup_all >= max(1, int(min_item_support))
        alphabet = int(kept.sum())
        if alphabet:
            density = int(sup_all[kept].sum()) / float(alphabet * n_seq)
    return DatasetStats(
        n_sequences=n_seq, n_itemsets=n_itemsets, n_tokens=n_tokens,
        alphabet=alphabet, max_len=max_len,
        avg_len=round(n_itemsets / n_seq, 4), n_words=n_words,
        density=round(density, 6))


def abs_minsup(rel_minsup: float, n_sequences: int) -> int:
    """Relative minsup (e.g. 0.001 = 0.1%) -> absolute sequence count:
    ``ceil(minsup * |DB|)``, floored at 1."""
    return max(1, int(np.ceil(rel_minsup * n_sequences)))
