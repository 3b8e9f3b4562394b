"""The rank side of ``tests/test_torch_meshguard.py``'s world drills.

Imports only the port.  Every rank installs its own meshguard
(``dead_after=1``); rank 0 alone arms the injected device-shaped fault on
its row, so its part is orphaned and the other row adopts it through the
round's exchange.  :data:`CASES` are the drills, one database each, made
from a seed.  :data:`FAILURES` are drills that must end the mine with an
error on every rank: rank 1 raises a fault that is not device-shaped in
its own slice, or a cancel while it adopts rank 0's dead part.  After
them every rank mines again, healthy.
"""

from __future__ import annotations

import time

from spark_fsm_tpu_torch.config import MeshguardConfig
from spark_fsm_tpu_torch.data.synth import kosarak_like, synthetic_db
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models import spam_bitmap
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
from spark_fsm_tpu_torch.service import meshguard as MG
from spark_fsm_tpu_torch.utils import faults, jobctl
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text


def spade_db():
    """``tests/_torch_partition_worker._db_slices``."""
    return synthetic_db(seed=21, n_sequences=203, n_items=12,
                        mean_itemsets=5.0, mean_itemset_size=1.4)


def tsr_db():
    """``tests/test_meshguard.py``'s drill database."""
    return kosarak_like(scale=0.002, fast=True)


def spam_db():
    """``tests/test_spam.py``'s partition fixture."""
    return kosarak_like(scale=0.0003, fast=True)


def faulty_mine(mine, fault_site):
    """A SPAM engine's ``mine`` that first passes a ``device.dispatch``
    fault site naming its partition (the SPAM engines of both packages
    have none of their own)."""
    def wrapped(self, **kwargs):
        fault_site("device.dispatch", point="spam",
                   part=f"part{self._partition[1]}")
        return mine(self, **kwargs)
    return wrapped


def mine_case(name: str, mesh, device=None) -> tuple:
    """(text, stats) of drill ``name`` at 2 partitions on ``mesh`` (or in
    one process on ``device``)."""
    stats: dict = {}
    kw = dict(device=device, mesh=mesh, partition_parts=2, stats_out=stats)
    if name == "tsr":
        text = rules_text(mine_tsr_torch(tsr_db(), 100, 0.5, max_side=2,
                                         **kw))
    elif name == "spade":
        db = spade_db()
        text = patterns_text(mine_spade_torch(db, abs_minsup(0.06, len(db)),
                                              **kw))
    else:
        db = spam_db()
        text = patterns_text(spam_bitmap.mine_spam_torch(
            db, abs_minsup(0.03, len(db)), partition_classes=16, **kw))
    return text, stats


CASES = ("tsr", "spade", "spam")
# TSR's and the wrapped SPAM's fault sites name their part; the SPADE
# queue engine's do not, so its drill fails the first dispatch
MATCH = {"tsr": {"match": "part0"}, "spade": {}, "spam": {"match": "part0"}}


class Cancelled(jobctl.JobCancelled):
    """A cancel landing at a fault site (the sites raise ``exc(message)``)."""

    def __init__(self, message: str):
        super().__init__("drill", "cancelled")


# name -> (case, what rank 0 arms, what rank 1 arms): a ValueError in rank
# 1's own slice; rank 0's row killed and a cancel in rank 1's adoption of
# its part
FAILURES = {
    "tsr raise": ("tsr", None, {"match": "part1", "exc": ValueError}),
    "spam raise": ("spam", None, {"match": "part1", "exc": ValueError}),
    "tsr cancel": ("tsr", {"match": "part0"},
                   {"match": "part0", "exc": Cancelled}),
    "spam cancel": ("spam", {"match": "part0"},
                    {"match": "part0", "exc": Cancelled}),
}


def drill(mesh) -> dict:
    """Every drill on this rank: first the :data:`FAILURES` (the
    exception's type and the mine's wall), then the :data:`CASES` on the
    same world (the text, the guard's dead rows and epoch, the exchanges
    and the deepening rounds)."""
    out = {"rank": mesh.rank}
    saved = spam_bitmap.SpamBitmapTorch.mine
    spam_bitmap.SpamBitmapTorch.mine = faulty_mine(saved, faults.fault_site)
    try:
        for name, (case, arm0, arm1) in FAILURES.items():
            MG.install(MeshguardConfig(enabled=True, dead_after=1))
            arm = arm0 if mesh.rank == 0 else arm1
            t0 = time.perf_counter()
            try:
                if arm is not None:
                    faults.arm("device.dispatch", every=1, times=1, **arm)
                mine_case(case, mesh)
                out[name] = ("no error", time.perf_counter() - t0)
            except Exception as exc:
                out[name] = (type(exc).__name__, time.perf_counter() - t0)
            finally:
                faults.disarm()
                MG.reset()
        for name in CASES:
            guard = MG.install(MeshguardConfig(enabled=True, dead_after=1))
            try:
                if mesh.rank == 0:
                    faults.arm("device.dispatch", every=1, times=1,
                               **MATCH[name])
                text, stats = mine_case(name, mesh)
                out[name] = {"text": text,
                             "dead": sorted(guard.dead_rows()),
                             "epoch": guard.current_epoch(),
                             "exchanges": stats["partition_exchanges"],
                             "rounds": stats.get("deepening_rounds", 1)}
            finally:
                faults.disarm()
                MG.reset()
    finally:
        spam_bitmap.SpamBitmapTorch.mine = saved
    return out
