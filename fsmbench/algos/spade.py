"""SPADE (plain frequent sequences) through the port's entries.

Modes (a traffic mix's ``mode``):
- ``repeat``: a repeated ``/train`` of the same data and support through
  the service's engine cache, ``SpadeEngineCache.mine``: fingerprint,
  checkout, then the cached engine's search on its resident store;
- ``cold``: ``mine_spade_torch`` from the sequence database every mine.
  No cell of ``BENCHMARK.json`` uses it yet: it is kept so that the
  ``bms2-spade.cold`` cell that waits in ``PERF.md`` can be added as data
  alone (a mix with ``"mode": "cold"``), without an edit of this file.
"""

from __future__ import annotations

from fsmbench.reference import fast
from fsmbench.reference.vertical import build_vertical


class _Miner:
    def __init__(self, cfg: dict, mode: str, device: str):
        self.minsup = int(cfg["minsup_abs"])
        self.device = device
        if mode == "repeat":
            from spark_fsm_tpu_torch.service.devcache import SpadeEngineCache

            self._cache = SpadeEngineCache()
            self._entry = self._cache.mine
        elif mode == "cold":
            from spark_fsm_tpu_torch.models.spade import mine_spade_torch

            self._cache = None
            self._entry = mine_spade_torch
        else:
            raise ValueError(f"SPADE has no mode {mode!r}")

    def mine(self, db):
        stats = {}
        res = self._entry(db, self.minsup, device=self.device,
                          stats_out=stats)
        return res, stats

    def close(self) -> None:
        if self._cache is not None:
            self._cache.clear()
        self._entry = self._cache = None


def miner(cfg: dict, mix: dict, device: str) -> _Miner:
    return _Miner(cfg, mix["mode"], device)


def reference(cfg: dict, db, count=fast.count_exact):
    minsup = int(cfg["minsup_abs"])
    return fast.mine_spade(build_vertical(db, minsup), minsup, count)
