"""Constrained SPADE (maxgap, maxwindow) through the port's entries.

Mode (a traffic mix's ``mode``): ``cold``, ``mine_cspade_torch`` from the
sequence database every mine: the vertical build, the engine with its
zero-filled state pool, and the max-start DFS.
"""

from __future__ import annotations

from fsmbench.reference import fast
from fsmbench.reference.vertical import build_vertical


class _Miner:
    def __init__(self, cfg: dict, mode: str, device: str):
        self.minsup = int(cfg["minsup_abs"])
        self.kw = dict(maxgap=cfg["maxgap"], maxwindow=cfg["maxwindow"],
                       device=device)
        if mode != "cold":
            raise ValueError(f"cSPADE has no mode {mode!r}")
        from spark_fsm_tpu_torch.models.spade_constrained import \
            mine_cspade_torch

        self._entry = mine_cspade_torch

    def mine(self, db):
        stats = {}
        res = self._entry(db, self.minsup, stats_out=stats, **self.kw)
        return res, stats

    def close(self) -> None:
        self._entry = None


def miner(cfg: dict, mix: dict, device: str) -> _Miner:
    return _Miner(cfg, mix["mode"], device)


def reference(cfg: dict, db, count=fast.count_exact):
    minsup = int(cfg["minsup_abs"])
    return fast.mine_cspade(build_vertical(db, minsup), minsup,
                            cfg["maxgap"], cfg["maxwindow"], count)
