"""The rank side of ``tests/test_torch_partition_world.py``.

Imports only the port, so the ranks that ``parallel.launch.spawn_world``
starts stay light.  Each case makes its database from a seed (the
fixtures of ``tests/test_partition.py`` and ``tests/test_spam.py``) and
mines it through the port's entry points with ``partition_parts``;
:func:`run_cases` runs every case on a rank, counting each collective the
mine calls by the size of its group, and :func:`run_port` runs one case
in one process without a mesh.
"""

from __future__ import annotations

import functools

from spark_fsm_tpu_torch.data.synth import kosarak_like, synthetic_db
from spark_fsm_tpu_torch.data.vertical import abs_minsup
from spark_fsm_tpu_torch.models.spade import mine_spade_torch
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text


def _db(seed=33, n=300, items=40):
    """``tests/test_partition._db``."""
    return synthetic_db(seed=seed, n_sequences=n, n_items=items,
                        mean_itemsets=5.0, mean_itemset_size=1.4)


def _db_slices():
    return _db(seed=21, n=203, items=12)


# name -> (algorithm, database maker, arguments)
CASES = {
    # tests/test_partition.py: the multi-round mine and an unlimited-side
    # mine (several rounds, so several exchanges)
    "tsr_rounds": ("tsr", _db, dict(k=10, minconf=0.4, max_side=2,
                                    item_cap=8)),
    "tsr_side_none": ("tsr", lambda: _db(seed=34),
                      dict(k=12, minconf=0.4, max_side=None)),
    "spade_auto": ("spade", _db_slices, dict(fused="auto")),
    "spade_never": ("spade", _db_slices, dict(fused="never")),
    # tests/test_spam.py's partition fixture
    "spam": ("spam", lambda: kosarak_like(scale=0.0003, fast=True),
             dict(partition_classes=16)),
    "cspade": ("cspade", _db_slices, dict(maxgap=2, maxwindow=5)),
}


def case_input(name: str):
    algo, make_db, kw = CASES[name]
    db = make_db()
    kw = dict(kw)
    if algo == "spam":
        kw["minsup"] = abs_minsup(0.03, len(db))
    elif algo != "tsr":
        kw["minsup"] = abs_minsup(0.06, len(db))
    return algo, db, kw


def run_port(name: str, parts: int, mesh=None) -> dict:
    """Case ``name`` in ``parts`` partitions on ``mesh`` (None: every
    partition in turn on the CPU): ``{"text", "stats"}``."""
    algo, db, kw = case_input(name)
    stats: dict = {}
    common = dict(device=None if mesh is not None else "cpu", mesh=mesh,
                  partition_parts=parts, stats_out=stats)
    if algo == "tsr":
        k, minconf = kw.pop("k"), kw.pop("minconf")
        text = rules_text(mine_tsr_torch(db, k, minconf, **kw, **common))
    else:
        minsup = kw.pop("minsup")
        fn = {"spade": mine_spade_torch, "spam": mine_spam_torch,
              "cspade": mine_cspade_torch}[algo]
        text = patterns_text(fn(db, minsup, **kw, **common))
    return {"text": text, "stats": stats}


_COLLECTIVES = ("all_reduce", "all_gather_object", "all_gather",
                "broadcast", "broadcast_object_list", "reduce", "barrier",
                "all_to_all", "reduce_scatter", "gather_object")


def _logged(log: list, name: str, fn):
    import torch.distributed as dist

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        group = kwargs.get("group")
        log.append((name, dist.get_world_size(group)))
        return fn(*args, **kwargs)
    return wrapper


def run_cases(mesh, parts_list) -> dict:
    """Every case at every ``parts`` on this rank: the text, the stats,
    the collectives called (name and group size), the world collectives
    ``partition.tallies`` counted, and the row meshes' sizes."""
    import torch.distributed as dist

    out = {"rank": mesh.rank, "rows": {}}
    for parts in parts_list:
        rows = PN.submeshes(mesh, parts)
        out["rows"][parts] = [None if r is None else r.size for r in rows]
        for name in CASES:
            log: list = []
            saved = [(n, getattr(dist, n)) for n in _COLLECTIVES]
            for n, fn in saved:
                setattr(dist, n, _logged(log, n, fn))
            before = PN.tallies()["world_collectives"]
            try:
                res = run_port(name, parts, mesh)
            finally:
                for n, fn in saved:
                    setattr(dist, n, fn)
            res["collectives"] = log
            res["world_collectives"] = (PN.tallies()["world_collectives"]
                                        - before)
            out[(name, parts)] = res
    return out


def refuse_parts(mesh, parts: int) -> str:
    """The error a mine at ``parts`` partitions raises on this world."""
    try:
        run_port("spade_never", parts, mesh)
    except ValueError as exc:
        return str(exc)
    return ""
