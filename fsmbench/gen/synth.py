"""Sequence databases drawn from a seed, in the shapes of public datasets.

``synthetic_db_fast`` is a frozen copy of
``spark_fsm_tpu_torch/data/synth.py:synthetic_db_fast`` at commit
af584b40603189c27f03b8d906643a82cdb45648, with the per-sequence working
set's size (6 there) made a parameter, and its body after the lengths
are drawn split out as ``_fill``.  Its Poisson lengths never reach the
long sessions of the public clickstreams, whose longest sequence sets the
width of every row on the device (bitmap words, state positions);
:func:`clickstream_db` draws the same items over lengths fitted to a
dataset's published mean and longest sequence.  The configurations'
``data`` blocks (``configs/*.json``) name a generator and its parameters;
:func:`make_db` reads such a block.

A run's seed does not draw a new database: the block's ``base_seed``
draws it, and the run's seed renames its items and shuffles the order of
its sequences (:func:`relabel`).  The new names are drawn in increasing
order, so the miners, which enumerate items by ascending id, visit the
same tree in the same order: every seed gets different inputs with the
same sizes, supports and patterns up to the names, and the work of a mine
does not change with the seed.  A database drawn from the run's seed
changed the number of frequent items and patterns, and with them a mine's
wall; a permutation of the names changed the order of the search, and
with it the device's memory peak.

A database is a list of sequences, a sequence a tuple of itemsets, an
itemset a sorted tuple of positive item ids (the SPMF ``SequenceDB``).
"""

from __future__ import annotations

from typing import List, Tuple

import math

import numpy as np

SequenceDB = List[Tuple[Tuple[int, ...], ...]]


def synthetic_db_fast(
    seed: int,
    n_sequences: int,
    n_items: int,
    mean_itemsets: float,
    mean_itemset_size: float = 1.0,
    zipf_s: float = 1.2,
    max_itemsets: int = 96,
    correlation: float = 0.35,
    working_set: int = 6,
) -> SequenceDB:
    """Zipfian item popularity (rank ** -``zipf_s``), Poisson lengths
    capped at ``max_itemsets``, and with probability ``correlation`` a
    token drawn from the sequence's own working set of ``working_set``
    popular items instead of the whole alphabet, so that real frequent
    patterns exist.  Every token is drawn with one inverse-CDF
    ``searchsorted`` pass."""
    rng = np.random.default_rng(seed)
    lengths = 1 + rng.poisson(max(mean_itemsets - 1.0, 0.0), size=n_sequences)
    lengths = np.minimum(lengths, max_itemsets)
    return _fill(rng, lengths, n_items, mean_itemset_size, zipf_s,
                 correlation, working_set)


def _fill(rng, lengths, n_items, mean_itemset_size, zipf_s, correlation,
          working_set) -> SequenceDB:
    """The itemsets of sequences of the given ``lengths`` (the body of
    ``synthetic_db_fast`` after its lengths are drawn)."""
    n_sequences = len(lengths)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = ranks ** (-zipf_s)
    probs /= probs.sum()
    cdf = np.cumsum(probs)

    n_itemsets = int(lengths.sum())
    sizes = 1 + rng.poisson(max(mean_itemset_size - 1.0, 0.0),
                            size=n_itemsets)
    n_tokens = int(sizes.sum())

    wside = min(working_set, n_items)
    wsets = np.searchsorted(cdf, rng.random((n_sequences, wside)),
                            side="right")
    seq_of_itemset = np.repeat(np.arange(n_sequences), lengths)
    seq_of_token = np.repeat(seq_of_itemset, sizes)
    use_wset = rng.random(n_tokens) < correlation
    from_wset = wsets[seq_of_token, rng.integers(0, wside, size=n_tokens)]
    from_global = np.searchsorted(cdf, rng.random(n_tokens), side="right")
    items = (np.where(use_wset, from_wset, from_global) + 1).tolist()

    tok_bounds = np.concatenate(([0], np.cumsum(sizes))).tolist()
    set_bounds = np.concatenate(([0], np.cumsum(lengths))).tolist()
    itemsets = [tuple(sorted(set(items[tok_bounds[j]:tok_bounds[j + 1]])))
                for j in range(n_itemsets)]
    return [tuple(itemsets[set_bounds[i]:set_bounds[i + 1]])
            for i in range(n_sequences)]


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def lognormal_length_pmf(n_sequences: int, mean_itemsets: float,
                         max_itemsets: int) -> np.ndarray:
    """Probabilities of the lengths ``1..max_itemsets``: a lognormal
    rounded to whole itemsets, fitted so that one sequence of
    ``n_sequences`` is expected past ``max_itemsets`` and the mean length,
    cut at ``max_itemsets``, is ``mean_itemsets``."""
    tail = 1.0 / n_sequences
    lo, hi = -10.0, 10.0                     # z with 1 - phi(z) = tail
    for _ in range(100):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if 1.0 - _phi(mid) > tail else (lo, mid)
    z = (lo + hi) / 2
    edges = np.log(np.arange(1, max_itemsets + 1) + 0.5)
    ks = np.arange(1, max_itemsets + 1, dtype=np.float64)

    def pmf(sigma: float) -> np.ndarray:
        mu = edges[-1] - z * sigma
        cdf = np.array([_phi((e - mu) / sigma) for e in edges])
        p = np.diff(np.concatenate(([0.0], cdf)))
        return p / p.sum()

    lo, hi = 1e-3, 10.0                      # the mean falls as sigma grows
    for _ in range(100):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if float(pmf(mid) @ ks) > mean_itemsets \
            else (lo, mid)
    return pmf((lo + hi) / 2)


def clickstream_db(
    seed: int,
    n_sequences: int,
    n_items: int,
    mean_itemsets: float,
    max_itemsets: int,
    mean_itemset_size: float = 1.0,
    zipf_s: float = 1.2,
    correlation: float = 0.35,
    working_set: int = 6,
) -> SequenceDB:
    """``synthetic_db_fast``'s items over heavy-tailed lengths: drawn from
    :func:`lognormal_length_pmf`, a dataset's published mean and longest
    sequence, and the longest drawn sequence set to that longest, so the
    widest row (positions a sequence, words a bitmap row) is the
    dataset's own."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(lognormal_length_pmf(n_sequences, mean_itemsets,
                                         max_itemsets))
    lengths = 1 + np.searchsorted(cdf, rng.random(n_sequences) * cdf[-1],
                                  side="right")
    lengths = np.minimum(lengths, max_itemsets)
    lengths[int(np.argmax(lengths))] = max_itemsets
    return _fill(rng, lengths, n_items, mean_itemset_size, zipf_s,
                 correlation, working_set)


def relabel(db: SequenceDB, n_items: int, seed: int) -> SequenceDB:
    """``db`` with item ``i`` renamed ``names[i - 1]``, ``n_items`` names
    drawn from ``1..2 * n_items`` by ``seed`` and sorted, so that renaming
    keeps the items' order, and its sequences in an order drawn from the
    same seed."""
    rng = np.random.default_rng(seed)
    names = np.sort(rng.choice(2 * n_items, size=n_items, replace=False))
    names = (names + 1).tolist()
    order = rng.permutation(len(db)).tolist()
    return [tuple(tuple(names[i - 1] for i in itemset)
                  for itemset in db[k]) for k in order]


GENERATORS = {"synthetic_db_fast": synthetic_db_fast,
              "clickstream_db": clickstream_db}


def make_db(data: dict, seed: int) -> SequenceDB:
    """The database a configuration's ``data`` block describes, for the
    run's ``seed``: ``data["generator"]`` names the generator and
    ``data["base_seed"]`` its seed; every other key is one of its
    parameters.  The seed relabels the drawn database."""
    params = {k: v for k, v in data.items()
              if k not in ("generator", "base_seed")}
    db = GENERATORS[data["generator"]](int(data["base_seed"]), **params)
    return relabel(db, int(data["n_items"]), int(seed))
