"""Deterministic synthetic sequence databases (copy of
``spark_fsm_tpu/data/synth.py``: ``synthetic_db`` and ``bms_webview2_like``).

The copy draws the same numbers from the same seed in the same order, so it
yields the same database as the reference generator.  Item popularity is
Zipfian, lengths Poisson, and each sequence draws part of its itemsets from
a small per-sequence working set so that real frequent patterns exist.
"""

from __future__ import annotations

import numpy as np

from spark_fsm_tpu_torch.data.spmf import SequenceDB


def synthetic_db(
    seed: int,
    n_sequences: int,
    n_items: int,
    mean_itemsets: float,
    mean_itemset_size: float = 1.0,
    zipf_s: float = 1.2,
    max_itemsets: int = 96,
    correlation: float = 0.35,
) -> SequenceDB:
    """Generate a clickstream-like sequence DB.

    Item popularity is Zipfian (rank-``zipf_s``); ``correlation`` is the
    probability that the next item is drawn from a small per-sequence
    working set instead of globally.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = ranks ** (-zipf_s)
    probs /= probs.sum()

    lengths = 1 + rng.poisson(max(mean_itemsets - 1.0, 0.0), size=n_sequences)
    lengths = np.minimum(lengths, max_itemsets)
    sizes_extra = rng.poisson(max(mean_itemset_size - 1.0, 0.0), size=int(lengths.sum()))

    db: SequenceDB = []
    k = 0
    for n in lengths:
        # Per-sequence working set of a few popular items -> shared patterns.
        wset = rng.choice(n_items, size=min(6, n_items), replace=False, p=probs) + 1
        seq = []
        for _ in range(int(n)):
            sz = 1 + int(sizes_extra[k])
            k += 1
            itemset = set()
            for _ in range(sz):
                if rng.random() < correlation:
                    itemset.add(int(wset[rng.integers(len(wset))]))
                else:
                    itemset.add(int(rng.choice(n_items, p=probs)) + 1)
            seq.append(tuple(sorted(itemset)))
        db.append(tuple(seq))
    return db


def bms_webview2_like(seed: int = 2, scale: float = 1.0) -> SequenceDB:
    """BMS-WebView-2 shape: 77,500 sequences over a 3,300-item Zipfian
    alphabet, mean 4.6 itemsets per sequence (at ``scale=1.0``)."""
    return synthetic_db(seed, int(77500 * scale), max(64, int(3300 * scale)),
                        mean_itemsets=4.6, zipf_s=1.15)
