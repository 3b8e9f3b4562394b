"""The rank side of ``tests/test_torch_mesh_engines.py``.

Imports only the port (no ``jax``, no ``spark_fsm_tpu``), so the ranks
that ``parallel.launch.spawn_world`` starts stay light.  Each case makes
its database from a seed and mines it through the port's public entry
points; :func:`run_port` runs one case on a mesh rank or, with
``mesh=None``, on one CPU device, and returns the canonical text, the
engine's stats and, for the checkpoint cases, the snapshot involved.
The cases follow the reference's own mesh fixtures (named per case).
"""

from __future__ import annotations

import functools

import numpy as np

from spark_fsm_tpu_torch.data.synth import kosarak_like, synthetic_db
from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
from spark_fsm_tpu_torch.models.spade import SpadeTorch, mine_spade_torch
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
from spark_fsm_tpu_torch.models.spade_fused import FusedCaps, FusedSpadeTorch
from spark_fsm_tpu_torch.models.spade_queue import QueueCaps, QueueSpadeTorch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
from spark_fsm_tpu_torch.models.tsr import mine_tsr_torch
from spark_fsm_tpu_torch.ops import extend_prune as EP
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops import rule_support as RS
from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

QUEUE_CAPS = dict(nb=32, ring=512, c_cap=2048, r_cap=16384)
FUSED_CAPS = dict(f_cap=256, c_cap=2048, r_cap=16384)


def random_db(rng, n_seq=12, n_items=5, max_itemsets=4, max_set=3):
    """``tests/test_oracle.random_db``."""
    db = []
    for _ in range(n_seq):
        seq = []
        for _ in range(rng.integers(1, max_itemsets + 1)):
            k = int(rng.integers(1, max_set + 1))
            itemset = tuple(sorted(rng.choice(n_items, size=k, replace=False)
                                   + 1))
            seq.append(tuple(int(x) for x in itemset))
        db.append(tuple(seq))
    return db


def batches(seed, n_batches, per_batch, n_items=12, mean_itemsets=3.0,
            mean_itemset_size=1.5):
    """``tests/test_incremental._batches``."""
    rng = np.random.default_rng(seed)
    return [synthetic_db(seed=int(rng.integers(1 << 30)),
                         n_sequences=per_batch, n_items=n_items,
                         mean_itemsets=mean_itemsets,
                         mean_itemset_size=mean_itemset_size)
            for _ in range(n_batches)]


def _multiword_db():
    # 40 itemsets a sequence: two bitmap words
    return synthetic_db(seed=21, n_sequences=45, n_items=6,
                        mean_itemsets=40.0, mean_itemset_size=1.1)


# name -> (database maker, minimum support maker); the miners are in
# run_port
CASES = {
    # tests/test_spade_tpu.py:81-90 (a 1-byte pool forces recomputes)
    "classic_recompute": (
        lambda: synthetic_db(seed=11, n_sequences=160, n_items=20,
                             mean_itemsets=4.0),
        lambda db: abs_minsup(0.05, len(db))),
    # tests/test_spade_tpu.py:69-78 (330 sequences: padding on any N)
    "router_auto": (
        lambda: synthetic_db(seed=10, n_sequences=330, n_items=30,
                             mean_itemsets=4.0, mean_itemset_size=1.3),
        lambda db: abs_minsup(0.03, len(db))),
    # tests/test_spade_queue.py:184-195
    "queue": (
        lambda: synthetic_db(seed=7, n_sequences=400, n_items=40,
                             mean_itemsets=4.0, mean_itemset_size=1.6),
        lambda db: 8),
    # tests/test_spade_fused.py:170-180
    "dense": (
        lambda: synthetic_db(seed=7, n_sequences=400, n_items=40,
                             mean_itemsets=4.0, mean_itemset_size=1.6),
        lambda db: 8),
    # tests/test_spade_fused.py:139-167 (the mesh's default caps)
    "dense_mesh_caps": (
        lambda: synthetic_db(seed=13, n_sequences=60, n_items=40,
                             mean_itemsets=6.0, mean_itemset_size=2.0,
                             correlation=0.8),
        lambda db: 2),
    # SPADE at two words a sequence, through the router and pinned classic
    "spade_w2_auto": (_multiword_db, lambda db: abs_minsup(0.9, len(db))),
    "spade_w2_classic": (_multiword_db, lambda db: abs_minsup(0.9, len(db))),
    # tests/test_spam.py:110-117
    "spam_bitmap": (
        lambda: kosarak_like(scale=0.0003, fast=True),
        lambda db: abs_minsup(0.03, len(db))),
    # tests/test_spam.py:280-291 (the hybrid store, rep_idlist > 0)
    "spam_hybrid": (
        lambda: synthetic_db(seed=401, n_sequences=90, n_items=24,
                             mean_itemsets=4.0, mean_itemset_size=1.3,
                             zipf_s=2.2),
        lambda db: abs_minsup(0.08, len(db))),
    "spam_w2": (_multiword_db, lambda db: abs_minsup(0.9, len(db))),
    # tests/test_tsr.py:128-133, at max_side 2 and None
    "tsr_side2": (
        lambda: random_db(np.random.default_rng(9), n_seq=27, n_items=6,
                          max_itemsets=5, max_set=2),
        lambda db: None),
    "tsr_side_none": (
        lambda: random_db(np.random.default_rng(9), n_seq=27, n_items=6,
                          max_itemsets=5, max_set=2),
        lambda db: None),
    # tests/test_constrained.py:152-158
    "cspade": (
        lambda: synthetic_db(seed=32, n_sequences=210, n_items=15,
                             mean_itemsets=4.5),
        lambda db: abs_minsup(0.05, len(db))),
    # tests/test_incremental.py:187-195 (pushes with eviction)
    "incremental_evict": (lambda: batches(7, 6, 60), lambda db: None),
    # tests/test_incremental.py:198-212 (two-word batch stores), at a
    # width whose frequent set stays small
    "incremental_multiword": (
        lambda: batches(8, 3, 24, n_items=12, mean_itemsets=24.0,
                        mean_itemset_size=1.0),
        lambda db: None),
    # a classic-engine snapshot taken by the reference's mesh mine,
    # resumed here; and one taken here, for the reference to resume
    "checkpoint_from_reference": (
        lambda: synthetic_db(seed=11, n_sequences=160, n_items=20,
                             mean_itemsets=4.0),
        lambda db: abs_minsup(0.05, len(db))),
    "checkpoint_to_reference": (
        lambda: synthetic_db(seed=11, n_sequences=160, n_items=20,
                             mean_itemsets=4.0),
        lambda db: abs_minsup(0.05, len(db))),
}

TSR_K, TSR_MINCONF = 6, 0.5
CSPADE_GAPS = dict(maxgap=2, maxwindow=4)
INC_ARGS = {"incremental_evict": (0.2, 3), "incremental_multiword": (0.8, 2)}


def case_input(name: str):
    make_db, make_minsup = CASES[name]
    db = make_db()
    return db, make_minsup(db)


class Checkpoint:
    """The engines' checkpoint contract (``load``, ``save``, ``every_s``):
    resumes ``state`` and keeps every snapshot saved."""

    def __init__(self, state=None, every_s: float = 3600.0):
        self.state = state
        self.every_s = every_s
        self.saved = []

    def load(self):
        return self.state

    def save(self, state):
        self.saved.append(state)


def run_port(name: str, mesh=None, n_ranks: int = 1, resume=None) -> dict:
    """Run case ``name`` on ``mesh`` (or on one CPU device with the caps a
    ``n_ranks`` mesh would take): ``{"text", "stats", "snapshot"}``."""
    db, minsup = case_input(name)
    dev = None if mesh is not None else "cpu"
    kw = dict(device=dev, mesh=mesh)
    stats: dict = {}
    snapshot = None
    if name == "classic_recompute":
        vdb = build_vertical(db, min_item_support=minsup)
        eng = SpadeTorch(vdb, minsup, pool_bytes=1, node_batch=16, chunk=64,
                         **kw)
        text = patterns_text(eng.mine())
        stats = dict(eng.stats)
    elif name == "router_auto":
        text = patterns_text(mine_spade_torch(db, minsup, stats_out=stats,
                                              **kw))
    elif name in ("queue", "dense", "dense_mesh_caps"):
        vdb = build_vertical(db, min_item_support=minsup)
        if name == "queue":
            eng = QueueSpadeTorch(vdb, minsup, caps=QueueCaps(**QUEUE_CAPS),
                                  **kw)
        else:
            if name == "dense":
                caps = FusedCaps(**FUSED_CAPS)
            else:  # the mesh's default; one device takes the same width
                caps = None if mesh is not None else FusedCaps(
                    f_cap=min(8192, 1024 * n_ranks))
            eng = FusedSpadeTorch(vdb, minsup, caps=caps, **kw)
        got = eng.mine()
        text = None if got is None else patterns_text(got)
        stats = dict(eng.stats)
    elif name in ("spade_w2_auto", "spade_w2_classic"):
        fused = "auto" if name.endswith("auto") else "never"
        text = patterns_text(mine_spade_torch(db, minsup, fused=fused,
                                              stats_out=stats, **kw))
    elif name.startswith("spam"):
        extra = {"density_crossover": 0.5} if name == "spam_hybrid" else {}
        text = patterns_text(mine_spam_torch(db, minsup, stats_out=stats,
                                             **extra, **kw))
    elif name.startswith("tsr"):
        side = 2 if name == "tsr_side2" else None
        text = rules_text(mine_tsr_torch(db, TSR_K, TSR_MINCONF,
                                         max_side=side, stats_out=stats,
                                         **kw))
    elif name == "cspade":
        text = patterns_text(mine_cspade_torch(db, minsup, stats_out=stats,
                                               **CSPADE_GAPS, **kw))
        stats.pop("geometry")
    elif name.startswith("incremental"):
        min_support, keep = INC_ARGS[name]
        wm = IncrementalWindowMiner(min_support, max_batches=keep, **kw)
        texts, per_push = [], []
        for batch in db:
            texts.append(patterns_text(wm.push(batch)))
            per_push.append(dict(wm.stats))
        text, stats = texts, per_push
    elif name == "checkpoint_from_reference":
        ck = Checkpoint(resume)
        text = patterns_text(mine_spade_torch(
            db, minsup, fused="never", checkpoint=ck, stats_out=stats, **kw))
    elif name == "checkpoint_to_reference":
        ck = Checkpoint(every_s=0.0)
        text = patterns_text(mine_spade_torch(
            db, minsup, fused="never", checkpoint=ck, stats_out=stats, **kw))
        snapshot = ck.saved[0]
    else:
        raise KeyError(name)
    return {"text": text, "stats": stats, "snapshot": snapshot}


# each kernel's wrapper and its plain version: on the CPU the wrappers
# run the plain versions and launch nothing, so the cases count calls
KERNEL_ENTRIES = {
    "b1": ((PS, "pair_supports"),),
    "b2": ((RS, "rule_supports"), (RS, "rule_supports_plain")),
    "b3": ((EP, "extend_count_prune"), (EP, "extend_count_prune_plain")),
}


def _counted(calls: dict, key: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def run_cases(mesh, names, resumes) -> dict:
    """A rank's run of every case: each case's :func:`run_port` result
    plus the calls of each kernel's entry points (B1, B2, B3) and the
    mesh's support reduces, counted from 0 for each case."""
    out = {}
    for name in names:
        calls = {key: 0 for key in KERNEL_ENTRIES}
        saved = []
        for key, entries in KERNEL_ENTRIES.items():
            for mod, attr in entries:
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, _counted(calls, key, fn))
        mesh.reset_counters()
        try:
            res = run_port(name, mesh, mesh.size, resumes.get(name))
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        res["calls"] = calls
        res["all_reduces"] = mesh.reduce_stats()["all_reduces"]
        out[name] = res
    return out


# ------------------------------------------------------------ on the card

CARD_DB = dict(seed=21, n_sequences=300, n_items=60, mean_itemsets=6.0,
               mean_itemset_size=1.3)
CARD_MINES = ("spade_queue", "spade_classic", "spam", "tsr")


def card_mine(name: str, mesh=None, device=None):
    """One of the card tests' mines on ``mesh`` (or one ``device``):
    ``(text, stats)``."""
    db = synthetic_db(**CARD_DB)
    minsup = abs_minsup(0.02, len(db))
    stats: dict = {}
    kw = dict(device=device, mesh=mesh, stats_out=stats)
    if name == "spade_queue":
        text = patterns_text(mine_spade_torch(db, minsup, fused="queue", **kw))
    elif name == "spade_classic":
        text = patterns_text(mine_spade_torch(db, minsup, fused="never",
                                              node_batch=16, **kw))
    elif name == "spam":
        text = patterns_text(mine_spam_torch(db, minsup, **kw))
    else:
        text = rules_text(mine_tsr_torch(db, 20, 0.5, max_side=2, **kw))
    return text, stats


def card_mines(mesh) -> dict:
    """Every card mine on a rank, with its B1/B2/B3 launches."""
    out = {}
    for name in CARD_MINES:
        before = (PS.pair_supports.launches, RS.rule_supports.launches,
                  EP.extend_count_prune.launches)
        text, stats = card_mine(name, mesh)
        after = (PS.pair_supports.launches, RS.rule_supports.launches,
                 EP.extend_count_prune.launches)
        out[name] = (text, stats.get("fused"), stats.get("resident"),
                     tuple(a - b for a, b in zip(after, before)))
    return out


def queue_waves_sync_free(mesh) -> int:
    """Two queue waves, each with its all-reduce, under
    ``torch.cuda.set_sync_debug_mode("error")`` (which raises on any host
    sync); returns the B1 launches they made."""
    import torch

    db = synthetic_db(**CARD_DB)
    vdb = build_vertical(db, min_item_support=6)
    q = QueueSpadeTorch(vdb, 6, mesh=mesh, caps=QueueCaps(**QUEUE_CAPS))
    carry = q.start(q.roots())
    PS._kernel()
    # the first collective sets the communicator up; it may sync
    from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum
    all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=mesh.device),
                   mesh)
    torch.cuda.synchronize()
    before = PS.pair_supports.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        q.wave(carry, q.caps.nb)
        q.wave(carry, q.nb_late)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if carry.ctr.tolist()[3] != 2:
        raise AssertionError(f"counters after two waves: {carry.ctr}")
    return PS.pair_supports.launches - before


def fail_on_rank(mesh, bad_rank: int) -> int:
    """Raises on ``bad_rank``; the other ranks wait in a collective that
    never completes, which the launcher must end."""
    import torch

    from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum

    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} refuses")
    all_reduce_sum(torch.ones(1, dtype=torch.int32), mesh)
    return mesh.rank
