"""Deterministic synthetic sequence databases (copy of
``spark_fsm_tpu/data/synth.py``: ``synthetic_db``, ``synthetic_db_fast``,
``bms_webview1_like``, ``bms_webview2_like``, ``msnbc_like``,
``kosarak_like``, ``gazelle_like`` and ``sub_crossover_db``).

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


def synthetic_db_fast(
    seed: int,
    n_sequences: int,
    n_items: int,
    mean_itemsets: float,
    mean_itemset_size: float = 1.0,
    zipf_s: float = 1.2,
    max_itemsets: int = 96,
    correlation: float = 0.35,
) -> SequenceDB:
    """Vectorized variant of :func:`synthetic_db` for full-size databases:
    the same distribution family, but every token is drawn with one
    inverse-CDF ``searchsorted`` pass (seconds for a Kosarak-shaped DB of
    990k sequences, where the exact generator takes tens of minutes).  Not
    seed-compatible with :func:`synthetic_db`: the two give different
    databases for the same seed."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = ranks ** (-zipf_s)
    probs /= probs.sum()
    cdf = np.cumsum(probs)

    lengths = 1 + rng.poisson(max(mean_itemsets - 1.0, 0.0), size=n_sequences)
    lengths = np.minimum(lengths, max_itemsets)
    n_itemsets = int(lengths.sum())
    sizes = 1 + rng.poisson(max(mean_itemset_size - 1.0, 0.0),
                            size=n_itemsets)
    n_tokens = int(sizes.sum())

    wside = min(6, n_items)
    wsets = np.searchsorted(cdf, rng.random((n_sequences, wside)),
                            side="right")
    seq_of_itemset = np.repeat(np.arange(n_sequences), lengths)
    seq_of_token = np.repeat(seq_of_itemset, sizes)
    use_wset = rng.random(n_tokens) < correlation
    from_wset = wsets[seq_of_token, rng.integers(0, wside, size=n_tokens)]
    from_global = np.searchsorted(cdf, rng.random(n_tokens), side="right")
    # plain Python ints, the SequenceDB contract
    items = (np.where(use_wset, from_wset, from_global) + 1).tolist()

    tok_bounds = np.concatenate(([0], np.cumsum(sizes))).tolist()
    set_bounds = np.concatenate(([0], np.cumsum(lengths))).tolist()
    itemsets = [tuple(sorted(set(items[tok_bounds[j]:tok_bounds[j + 1]])))
                for j in range(n_itemsets)]
    return [tuple(itemsets[set_bounds[i]:set_bounds[i + 1]])
            for i in range(n_sequences)]


def _generator(fast: bool):
    return synthetic_db_fast if fast else synthetic_db


def bms_webview1_like(seed: int = 1, scale: float = 1.0,
                      fast: bool = False) -> SequenceDB:
    return _generator(fast)(seed, int(59600 * scale), max(32, int(497 * scale)),
                            mean_itemsets=2.5, zipf_s=1.1)


def bms_webview2_like(seed: int = 2, scale: float = 1.0,
                      fast: bool = False) -> SequenceDB:
    """BMS-WebView-2 shape: 77,500 sequences over a 3,300-item Zipfian
    alphabet, mean 4.6 itemsets per sequence (at ``scale=1.0``)."""
    return _generator(fast)(seed, int(77500 * scale),
                            max(64, int(3300 * scale)),
                            mean_itemsets=4.6, zipf_s=1.15)


def msnbc_like(seed: int = 3, scale: float = 1.0,
               fast: bool = False) -> SequenceDB:
    """MSNBC shape: 990,000 sequences over 17 page categories, mean 5.7
    itemsets per sequence, long-tailed lengths (at ``scale=1.0``)."""
    return _generator(fast)(seed, int(990000 * scale), 17,
                            mean_itemsets=5.7, zipf_s=0.9, max_itemsets=96)


def kosarak_like(seed: int = 4, scale: float = 1.0,
                 fast: bool = False) -> SequenceDB:
    """Kosarak shape: 990,000 sequences over a 41,000-item Zipfian alphabet,
    mean 8.1 itemsets per sequence (at ``scale=1.0``)."""
    return _generator(fast)(seed, int(990000 * scale),
                            max(128, int(41000 * scale)),
                            mean_itemsets=8.1, zipf_s=1.3)


def gazelle_like(seed: int = 5, scale: float = 1.0,
                 fast: bool = False) -> SequenceDB:
    return _generator(fast)(seed, int(59000 * scale), max(64, int(498 * scale)),
                            mean_itemsets=2.5, zipf_s=1.1)


def sub_crossover_db(offset: int = 0, n_seq: int = 200) -> SequenceDB:
    """Deterministic SUB-crossover shape for the engine planner
    (service/planner.py): ~400 items each in exactly 2 of ``n_seq``
    sequences (frequent-projection density at minsup 2 ~ 2/n_seq =
    0.01 < the 0.02 crossover; alphabet ~ 402 < the 512 ceiling), plus
    two shared marker items so the mine is non-trivial.  ``offset``
    rotates the item assignment for distinct-but-identically-shaped
    pools.  ONE definition — tests/test_planner.py, spam_smoke and
    ``bench_throughput --mix engines`` all pin routing against this
    shape, and a crossover retune must move them together."""
    db: SequenceDB = []
    for s in range(n_seq):
        a = 1000 + ((s + offset) % 200) * 2
        c = 1000 + ((s + offset + 50) % 200) * 2
        seq = [(a,), (a + 1,), (c,), (c + 1,)]
        if s % 16 == 0:
            seq = [(3 + offset,)] + seq + [(5 + offset,)]
        db.append(tuple(seq))
    return db
