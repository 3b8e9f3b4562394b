"""Sliding-window sequence DB and the re-mine window miner — port of
``spark_fsm_tpu/streaming/window.py`` (``SlidingWindow``, ``WindowMiner``).

- ``SlidingWindow`` holds the live micro-batches (append at the head,
  evict at the tail by batch count and/or total-sequence cap).
- ``WindowMiner`` re-mines the window after each push: the vertical build
  over the window's sequences, then ``mine_spade_torch(...,
  shape_buckets=True)`` on the miner's device (CUDA unless the caller
  passes ``device="cpu"``).  Re-mining is the fallback route; the
  incremental miner (``streaming/incremental.py``) is the default one.

Determinism contract: after every push, the mined pattern set is
byte-identical to a fresh mine of exactly the window's sequences — the
stream never changes WHAT is mined, only WHEN.
"""

from __future__ import annotations

import functools
import itertools
import threading
from collections import Counter, deque
from typing import Callable, Deque, List, Optional

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.device import DeviceLike, resolve_device
from spark_fsm_tpu_torch.utils.canonical import PatternResult


class SlidingWindow:
    """Count-based sliding window of sequence micro-batches.

    Args:
      max_batches: keep at most this many micro-batches (None = unbounded).
      max_sequences: evict oldest batches while the window holds more than
        this many sequences (None = unbounded).  Eviction granularity is a
        whole micro-batch.
    """

    def __init__(self, max_batches: Optional[int] = None,
                 max_sequences: Optional[int] = None) -> None:
        if max_batches is None and max_sequences is None:
            max_batches = 1  # degenerate default: mine each batch alone
        if max_batches is not None and max_batches < 1:
            raise ValueError(f"max_batches must be >= 1 (got {max_batches}); "
                             "use None for an unbounded window")
        if max_sequences is not None and max_sequences < 1:
            raise ValueError(f"max_sequences must be >= 1 (got {max_sequences}); "
                             "use None for an unbounded window")
        self.max_batches = max_batches
        self.max_sequences = max_sequences
        self._batches: Deque[SequenceDB] = deque()
        self._n_sequences = 0
        self.pushed_batches = 0
        self.evicted_batches = 0

    # -- window state -----------------------------------------------------

    @property
    def n_batches(self) -> int:
        return len(self._batches)

    @property
    def n_sequences(self) -> int:
        return self._n_sequences

    def batches(self) -> List[SequenceDB]:
        """The live micro-batches, oldest first (a fresh list)."""
        return list(self._batches)

    def sequences(self) -> SequenceDB:
        """The window's sequence DB, oldest batch first (a fresh list —
        the input of both the engine mine and the parity oracle)."""
        out: List = []
        for b in self._batches:
            out.extend(b)
        return out

    def item_supports(self) -> Counter:
        """Window-wide sequence-support per item (introspection helper;
        the mining path recomputes its own projection)."""
        total: Counter = Counter()
        for batch in self._batches:
            for seq in batch:
                for it in set(itertools.chain.from_iterable(seq)):
                    total[it] += 1
        return total

    # -- mutation ---------------------------------------------------------

    def push(self, batch: SequenceDB) -> int:
        """Append a micro-batch, evict expired ones; returns #evicted."""
        batch = list(batch)
        if not batch:
            raise ValueError("empty micro-batch: a push must carry at least "
                             "one sequence (it would evict real data while "
                             "adding none)")
        self._batches.append(batch)
        self._n_sequences += len(batch)
        self.pushed_batches += 1
        evicted = 0
        while (self.max_batches is not None
               and len(self._batches) > self.max_batches):
            evicted += self._evict_oldest()
        while (self.max_sequences is not None and len(self._batches) > 1
               and self._n_sequences > self.max_sequences):
            evicted += self._evict_oldest()
        self.evicted_batches += evicted
        return evicted

    def _evict_oldest(self) -> int:
        old = self._batches.popleft()
        self._n_sequences -= len(old)
        return 1


MineFn = Callable[[SequenceDB, int], List[PatternResult]]


def _default_mine(db: SequenceDB, minsup: int, *,
                  device) -> List[PatternResult]:
    from spark_fsm_tpu_torch.models.spade import mine_spade_torch

    # the reference buckets the device shapes so consecutive re-mines
    # reuse compiled programs; here it keeps the routes equal to its
    return mine_spade_torch(db, minsup, shape_buckets=True, device=device)


class WindowMiner:
    """Keeps a sliding window's pattern set current across micro-batches.

    ``push(batch)`` updates the window and re-mines it, returning the new
    pattern set (also kept in ``.patterns``).  ``min_support`` < 1 is
    relative to the *current* window size (recomputed per push), >= 1 is
    an absolute sequence count.  ``device`` is resolved once
    (``resolve_device``: CUDA, raising without it, unless ``"cpu"``); the
    default mine runs there.  A custom ``mine(db, minsup)`` replaces it.
    """

    def __init__(self, min_support: float, *,
                 max_batches: Optional[int] = None,
                 max_sequences: Optional[int] = None,
                 mine: Optional[MineFn] = None,
                 device: DeviceLike = None) -> None:
        self.min_support = float(min_support)
        self.device = resolve_device(device)
        self.window = SlidingWindow(max_batches=max_batches,
                                    max_sequences=max_sequences)
        self._mine = (mine if mine is not None
                      else functools.partial(_default_mine,
                                             device=self.device))
        self._lock = threading.Lock()
        self.patterns: List[PatternResult] = []
        # route mirrors IncrementalWindowMiner's stats key
        self.stats = {"pushes": 0, "mines": 0, "evicted_batches": 0,
                      "window_sequences": 0, "patterns": 0,
                      "route": "re-mine"}

    def minsup_abs(self) -> int:
        if self.min_support >= 1.0:
            return int(self.min_support)
        return abs_minsup(self.min_support, max(1, self.window.n_sequences))

    def push(self, batch: SequenceDB) -> List[PatternResult]:
        """Append a micro-batch; evict expired sequences; re-mine."""
        with self._lock:
            self.window.push(batch)
            seqs = self.window.sequences()
            self.patterns = self._mine(seqs, self.minsup_abs()) if seqs else []
            self.stats["pushes"] += 1
            self.stats["mines"] += 1
            self.stats["evicted_batches"] = self.window.evicted_batches
            self.stats["window_sequences"] = self.window.n_sequences
            self.stats["patterns"] = len(self.patterns)
            return self.patterns
