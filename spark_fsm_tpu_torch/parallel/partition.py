"""Equivalence-class candidate partitioning — port of
``spark_fsm_tpu/parallel/partition.py``.

A sequence mesh (``parallel/mesh.py``) shards the data and replicates the
candidates: every rank evaluates the same candidate set and all-reduces
before each prune.  This module partitions the candidates instead:

- the mining frontier splits by EQUIVALENCE CLASS: a TSR rule's class is
  its root item ``min(X)`` (invariant under both expansions), a SPADE,
  SPAM or cSPADE pattern's class is its first item (the DFS root).
  Classes hash from GLOBAL item ids (:func:`class_of`), so ownership is
  identical on every process with no coordination;
- classes balance over the partitions by their summed item supports,
  longest-processing-time first (:func:`plan_partitions`);
- each partition keeps the sequence mesh of its own ROW
  (:func:`submeshes`), so the only traffic between partitions is one
  small exchange per round (:func:`exchange_objects`): TSR's threshold
  floor and result slices once per deepening round, the pattern slices
  once per SPADE/SPAM/cSPADE mine.

The host half (class hash, plans, re-plans, the threshold board, the
composite checkpoint format) is the reference's numpy, copied.  The
device half follows the port's process model: one process per rank.

- ``mesh=None``: every partition is mined in turn in this process on its
  one device (the reference's single controller without a mesh).
- A ``SeqMesh`` of W ranks splits into ``n_parts`` rows of
  ``inner = W / n_parts`` ranks: row p is ranks ``[p*inner, (p+1)*inner)``
  and each rank mines only its row's partition (:func:`owned_parts`).  A
  row of several ranks is a ``SeqMesh`` over its own process group, so
  its engines all-reduce inside the row; a row of one rank is ``None``
  (the bare single-device route on the rank's own device, the
  reference's rule for a one-local-device process).
- The exchange is one ``all_gather_object`` over the mesh's exchange
  group (``SeqMesh.exchange_group``: gloo, so it never stages through a
  card and a rank whose card failed can still join it, with the world's
  timeout), to which each row contributes once (its inner rank 0's
  payload).

Counters: the reference's ``fsm_partition_*`` registry families
(plans, exchange rounds, cross bytes, the latest imbalance, mines by
algorithm); :func:`tallies` is a view of them, plus
``world_collectives``, the exchanges that crossed processes.

Topology survival (``service/meshguard.py``, when installed): a part
whose dispatch fails device-shaped marks its row suspect, then dead; a
dead row's slice is adopted by the :func:`adopters_for` survivor with its
last frontier snapshot (kept host-side even without a checkpoint sink),
the same class restriction and so the same merged answer.  Without a
mesh the adopter mines it here at once, as the reference's single
controller does.  On a world the rank of the dead row stops its device
work; the exchange then carries each row's health (the guard's
heartbeat payload), the orphaned part and its snapshot; every rank merges
the health alike, the adopter row mines the part, and a second exchange
merges its rows (no second exchange when no row failed).  Any other
failure of a row on a world (a fault that is not device-shaped, a job
abort, an adopter that fails too) travels in the exchange the row was
bound for, and every rank raises together (:func:`finish_round`).  A
process that dies cannot be adopted: the world's collectives fail with
it, and the world's timeout ends the mine with an error.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import threading
from typing import List, Optional, Sequence

import numpy as np

from spark_fsm_tpu_torch.service import meshguard as MG
from spark_fsm_tpu_torch.utils import jobctl, obs

# ---------------------------------------------------------------- metrics

_PLANS = obs.REGISTRY.counter(
    "fsm_partition_plans_total",
    "equivalence-class partition plans built (parallel/partition.py)")
_EXCHANGES = obs.REGISTRY.counter(
    "fsm_partition_exchange_rounds_total",
    "cross-partition exchange rounds (threshold floor + result merge)")
_CROSS_BYTES = obs.REGISTRY.counter(
    "fsm_partition_cross_bytes_total",
    "bytes exchanged across partitions (payload size)")
_IMBALANCE = obs.REGISTRY.gauge(
    "fsm_partition_imbalance_ratio",
    "max/mean per-partition cost of the latest plan (1.0 = perfect)")
_MINES = obs.REGISTRY.counter(
    "fsm_partition_mines_total",
    "partitioned mines run, by algorithm")
for _algo in ("tsr", "spade", "cspade"):
    _MINES.seed(algo=_algo)
_IMBALANCE.set(0.0)

_lock = threading.Lock()
_world_collectives = 0


def tallies() -> dict:
    """Partition plans built, exchange rounds, bytes exchanged, exchanges
    that crossed processes, the latest plan's imbalance and the
    partitioned mines by algorithm, over the process's lifetime (a view
    of the ``fsm_partition_*`` registry families)."""
    mines = {"tsr": 0, "spade": 0, "spam": 0, "cspade": 0}
    snap = _MINES.snapshot()
    for key, v in (snap.items() if isinstance(snap, dict) else ()):
        if key:
            mines[key.split("=", 1)[1]] = int(v)
    with _lock:
        world = _world_collectives
    return {"plans": int(_PLANS.total()),
            "exchanges": int(_EXCHANGES.total()),
            "cross_bytes": int(_CROSS_BYTES.total()),
            "world_collectives": world,
            "imbalance": float(_IMBALANCE.snapshot()),
            "mines": mines}


def count_mine(algo: str) -> None:
    _MINES.inc(algo=algo)


# ------------------------------------------------------------ class hash

# splitmix64 finalizer constants: a fixed, seedless avalanche over the
# GLOBAL item id, so every process computes the identical class map
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def class_of(item_ids, n_classes: int) -> np.ndarray:
    """Equivalence-class index of each global item id (vectorized
    splitmix64 finalizer): uncorrelated with id magnitude, identical
    everywhere."""
    x = np.asarray(item_ids, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * _C1
    x = (x ^ (x >> np.uint64(27))) * _C2
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(int(n_classes))).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A committed class -> partition assignment: ``owner[c]`` owns class
    ``c``; ``part_costs`` is each partition's modeled cost, and
    ``class_costs`` each class's (kept for :func:`replan_surviving`).  A
    pure function of (item ids, item supports, n_parts, n_classes), so
    every process builds the same plan from the same vertical DB."""

    n_parts: int
    n_classes: int
    owner: np.ndarray  # [n_classes] int32
    part_costs: np.ndarray  # [n_parts] float64
    class_costs: Optional[np.ndarray] = None

    @property
    def imbalance_ratio(self) -> float:
        mean = float(self.part_costs.mean()) if self.n_parts else 0.0
        if mean <= 0:
            return 1.0
        return float(self.part_costs.max()) / mean

    def owner_of(self, item_ids) -> np.ndarray:
        """Partition owning each item's class (vectorized)."""
        return self.owner[class_of(item_ids, self.n_classes)]

    def owned_slice(self, roots: Sequence[int], item_ids,
                    part: int) -> List[int]:
        """The LOCAL root indices whose class ``part`` owns
        (``item_ids[r]`` maps a local index to its global id): the one
        seed filter every engine's root seeding goes through."""
        roots = list(roots)
        if not roots:
            return roots
        own = self.owner_of(
            np.asarray(item_ids)[np.asarray(roots, np.int64)]
        ) == int(part)
        return [r for r, o in zip(roots, own) if o]

    def fingerprint(self) -> dict:
        """What a partitioned checkpoint binds to: a changed layout
        restarts fresh."""
        return {"parts": int(self.n_parts), "classes": int(self.n_classes),
                "owner_sum": int(self.owner.astype(np.int64).sum())}


def owned_roots(roots: Sequence[int], item_ids, partition) -> List[int]:
    """The roots an engine seeds: all of them, or under a ``(plan,
    part)`` slice the ones whose class the part owns."""
    if partition is None:
        return list(roots)
    plan, part = partition
    return plan.owned_slice(roots, item_ids, part)


def plan_partitions(item_ids, item_supports, n_parts: int,
                    n_classes: int = 64, *,
                    record: bool = True) -> PartitionPlan:
    """Balance equivalence classes over ``n_parts`` partitions: a class
    costs the summed supports of its items (a root's subtree dispatches
    candidate lanes roughly in proportion to its support), assigned
    largest first to the least-loaded partition."""
    n_parts = int(n_parts)
    n_classes = int(n_classes)
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if n_classes < n_parts:
        raise ValueError(
            f"n_classes ({n_classes}) must be >= n_parts ({n_parts})")
    cls = class_of(item_ids, n_classes)
    costs = np.bincount(cls, weights=np.asarray(item_supports,
                                                np.float64),
                        minlength=n_classes)
    owner = np.zeros(n_classes, np.int32)
    load = np.zeros(n_parts, np.float64)
    # a stable sort keeps the plan deterministic across numpy versions
    for c in np.argsort(-costs, kind="stable"):
        p = int(np.argmin(load))
        owner[int(c)] = p
        load[p] += costs[int(c)]
    plan = PartitionPlan(n_parts, n_classes, owner, load, costs)
    if record:
        _PLANS.inc()
        _IMBALANCE.set(plan.imbalance_ratio)
    return plan


def replan_surviving(plan: PartitionPlan,
                     dead_rows: Sequence[int]) -> PartitionPlan:
    """Re-balance dead rows' classes onto the survivors: surviving rows
    keep their classes, the dead rows' classes go largest first to the
    least-loaded survivor.  The owner map changes, so
    :meth:`PartitionPlan.fingerprint` does too."""
    dead = {int(r) for r in dead_rows}
    survivors = [p for p in range(plan.n_parts) if p not in dead]
    if not survivors:
        raise ValueError(
            f"no surviving partitions (dead={sorted(dead)} of "
            f"{plan.n_parts}): the mesh is gone, not degraded")
    if not dead:
        return plan
    costs = (plan.class_costs if plan.class_costs is not None
             else np.ones(plan.n_classes, np.float64))
    owner = plan.owner.copy()
    load = np.zeros(plan.n_parts, np.float64)
    for c in range(plan.n_classes):
        if int(owner[c]) not in dead:
            load[int(owner[c])] += costs[c]
    orphan_classes = [c for c in range(plan.n_classes)
                      if int(owner[c]) in dead]
    orphan_classes.sort(key=lambda c: (-costs[c], c))
    for c in orphan_classes:
        p = survivors[int(np.argmin(load[survivors]))]
        owner[c] = p
        load[p] += costs[c]
    return PartitionPlan(plan.n_parts, plan.n_classes, owner, load,
                         plan.class_costs)


def adopters_for(plan: PartitionPlan, dead_rows: Sequence[int]) -> dict:
    """``dead part -> surviving adopter``: each dead part's whole slice
    goes to the least-loaded survivor, largest dead part first."""
    dead = sorted({int(r) for r in dead_rows},
                  key=lambda r: (-float(plan.part_costs[r]), r))
    survivors = [p for p in range(plan.n_parts) if p not in set(dead)]
    if not survivors:
        raise ValueError(
            f"no surviving partitions (dead={sorted(dead)} of "
            f"{plan.n_parts}): the mesh is gone, not degraded")
    load = plan.part_costs.astype(np.float64).copy()
    out = {}
    for r in dead:
        p = survivors[int(np.argmin(load[survivors]))]
        out[r] = p
        load[p] += float(plan.part_costs[r])
    return out


# ------------------------------------------------------------- row meshes


def _inner(mesh, n_parts: int) -> int:
    if mesh.size % n_parts:
        raise ValueError(
            f"mesh of {mesh.size} devices does not split into "
            f"{n_parts} equal partition rows")
    return mesh.size // n_parts


def submeshes(mesh, n_parts: int) -> list:
    """Each partition's row: ``[mesh]`` for ``n_parts <= 1``, ``[None] *
    n_parts`` for ``mesh=None`` (every partition on the one device).  A
    ``SeqMesh`` of W ranks splits into rows of ``inner = W / n_parts``
    ranks (``ValueError`` unless ``n_parts`` divides W).  This rank's row
    is a ``SeqMesh`` over the row's group when ``inner > 1`` and ``None``
    (the bare route on ``mesh.device``) when ``inner == 1``; the other
    rows, which this rank does not run, are ``None`` too."""
    n_parts = int(n_parts)
    if n_parts <= 1:
        return [mesh]
    if mesh is None:
        return [None] * n_parts
    inner = _inner(mesh, n_parts)
    rows: list = [None] * n_parts
    if inner == 1:
        return rows
    import torch.distributed as dist

    from spark_fsm_tpu_torch.parallel.mesh import make_mesh

    groups = mesh.row_groups.get(n_parts)
    if groups is None:
        # every rank creates every row's group, in the same order (each
        # rank makes the same calls on its mesh, so the cache hits alike)
        ranks = dist.get_process_group_ranks(mesh.group)
        groups = [dist.new_group(ranks[p * inner:(p + 1) * inner])
                  for p in range(n_parts)]
        mesh.row_groups[n_parts] = groups
    own = mesh.rank // inner
    rows[own] = make_mesh(group=groups[own], device=mesh.device)
    return rows


def owned_parts(plan: PartitionPlan, mesh=None) -> List[int]:
    """The partitions this process mines: all of them in turn without a
    mesh, its own row's on a mesh."""
    if mesh is None or plan.n_parts <= 1:
        return list(range(plan.n_parts))
    return [own_row(plan, mesh)]


# --------------------------------------------------------------- exchange


def exchange_objects(payload, *, mesh=None, n_parts: int = 1,
                     stats: Optional[dict] = None,
                     record: bool = True) -> list:
    """One cross-partition exchange round: the list of every row's
    ``payload`` (any JSON-able object), in row order.

    Without a mesh the caller already holds every partition's data: the
    exchange returns ``[payload]`` and counts the round and the payload's
    bytes (what would cross between partitions).  On a mesh it is one
    ``all_gather_object`` over the mesh's exchange group; each row
    contributes its inner rank 0's payload, and the bytes are the sum of
    those payloads'.

    ``stats`` mirrors the round and byte counts into an engine's stats
    (``partition_exchanges``, ``partition_cross_bytes``); ``record=False``
    leaves the registry families as they are."""
    global _world_collectives
    crossed = mesh is not None and n_parts > 1
    if not crossed:
        nbytes = len(json.dumps(payload).encode("utf-8"))
        merged = [payload]
    else:
        import torch.distributed as dist

        inner = _inner(mesh, n_parts)
        gathered: list = [None] * mesh.size
        mine = payload if mesh.rank % inner == 0 else None
        dist.all_gather_object(gathered, mine, group=mesh.exchange_group())
        merged = [g for g in gathered if g is not None]
        nbytes = sum(len(json.dumps(g).encode("utf-8")) for g in merged)
    if record:
        _EXCHANGES.inc()
        _CROSS_BYTES.inc(nbytes)
        with _lock:
            _world_collectives += int(crossed)
    if stats is not None:
        stats["partition_exchanges"] = (
            stats.get("partition_exchanges", 0) + 1)
        stats["partition_cross_bytes"] = (
            stats.get("partition_cross_bytes", 0) + nbytes)
    return merged


# ------------------------------------------------------- topology survival

#: :func:`mine_on_rows`' answer when this rank's row died on a world: the
#: part is orphaned, and the exchange hands it to its adopter
ORPHANED = object()


def mine_on_rows(plan: PartitionPlan, p: int, mine, *, world: bool,
                 row: Optional[int] = None):
    """Mine part ``p`` through ``mine(row, attempt)`` under the process's
    meshguard (the reference's retry loops of ``mine_partitioned_slices``
    and ``TsrPartitioned._mine_round``).  Without a guard a failure
    raises.  With one, a device-shaped failure marks the row: a suspect
    row tries again, a dead row's part moves to its :func:`adopters_for`
    survivor (``attempt`` counts the tries, so the caller rebuilds its
    engine); a ``StaleTopology`` refusal keeps the row's health and tries
    again at the new epoch.  A failure that is not device-shaped, or
    ``max_retries`` tries, raise.  On a ``world`` a dead row cannot hand
    its part to another process here: the answer is :data:`ORPHANED`.
    ``row`` is the row it starts on (default: the part's own)."""
    guard = MG.get()
    row, attempt = int(p if row is None else row), 0
    while True:
        try:
            out = mine(row, attempt)
            if guard is not None:
                guard.note_row_ok(row)
            return out
        except Exception as exc:
            if guard is None:
                raise
            attempt += 1
            if attempt >= guard.max_retries:
                raise
            if isinstance(exc, MG.StaleTopology):
                state = guard.state_of(row)
            else:
                state = guard.note_row_fault(row, exc)
                if state is None:
                    raise
            if state == MG.DEAD:
                if world:
                    return ORPHANED
                adopter = adopters_for(plan, guard.dead_rows()).get(row)
                if adopter is None or adopter == row:
                    raise
                MG.note_replan(guard.dead_rows())
                row = adopter


def part_homes(plan: PartitionPlan) -> dict:
    """``part -> row`` that mines it now: its own row, or for a part of a
    dead row (the process guard's view) its adopter."""
    guard = MG.get()
    dead = guard.dead_rows() if guard is not None else frozenset()
    homes = {p: p for p in range(plan.n_parts)}
    if dead:
        homes.update(adopters_for(plan, dead))
    return homes


class RowFailed(RuntimeError):
    """Another row of the mesh failed in this round (the error it raised
    travels in the exchange), so this rank leaves the mine too."""


def _exchange_or_raise(payload: dict, failure, *, mesh, n_parts: int,
                       stats: Optional[dict], record: bool) -> list:
    """A world's exchange when this row's work may have ended on
    ``failure`` (an exception, raised again after the exchange): every row
    learns of it there and raises too, where it would otherwise wait in
    the exchange until the world's timeout.  Another row's job abort
    raises ``jobctl.RankAborted`` here, any other failure
    :class:`RowFailed`."""
    if failure is not None:
        payload = dict(payload, failed={
            "abort": isinstance(failure, jobctl.JobAborted),
            "error": f"{type(failure).__name__}: {failure}"})
    gathered = exchange_objects(payload, mesh=mesh, n_parts=n_parts,
                                stats=stats, record=record)
    if failure is not None:
        raise failure
    failed = [g["failed"] for g in gathered if g.get("failed")]
    if failed and all(f["abort"] for f in failed):
        raise jobctl.RankAborted("", "aborted by another row of the mesh")
    if failed:
        raise RowFailed("another row of the mesh failed: "
                        + next(f["error"] for f in failed if not f["abort"]))
    return gathered


def finish_round(payload: dict, failure, orphans: list, adopt_part, *,
                 plan: PartitionPlan, mesh, stats: Optional[dict],
                 record: bool = True, before_adopt=None) -> list:
    """The end of a round of partitioned slices: its exchange and, on a
    world where a row died, the adoption of that row's parts.

    ``payload`` is this row's contribution (a dict with ``rows``),
    ``failure`` the exception that ended this rank's slices early (None
    when they ran to the end) and ``orphans`` the parts it left to an
    adopter, each with its last frontier.  Without a world a failure
    raises at once.  On a world every rank joins every exchange whatever
    happened, and a failure travels in it (:func:`_exchange_or_raise`).
    Under a guard each row adds its health (``heartbeat_payload``: epoch
    and dead rows) and its orphans, and every rank merges the health
    alike, so all agree on each orphan's adopter.  When parts were
    orphaned, ``before_adopt(gathered)`` runs on every rank, the adopter
    row mines each of its parts through ``adopt_part(part, frontier)``
    (its rows, or None when it is orphaned again) and a second exchange
    merges them.  Returns every row's payload of both exchanges, in
    order."""
    world = mesh is not None and plan.n_parts > 1
    kw = dict(mesh=mesh, n_parts=plan.n_parts, stats=stats, record=record)
    if not world:
        if failure is not None:
            raise failure
        return exchange_objects(payload, **kw)
    guard = MG.get()
    if guard is not None:
        payload = dict(payload, health=guard.heartbeat_payload(),
                       orphans=orphans)
    gathered = _exchange_or_raise(payload, failure, **kw)
    if guard is None:
        return gathered
    for g in gathered:
        guard.merge_peer(g.get("health"))
    orphaned = sorted((o for g in gathered for o in g.get("orphans", ())),
                      key=lambda o: int(o["part"]))
    if not orphaned:
        return gathered
    homes, me = part_homes(plan), own_row(plan, mesh)
    rows: list = []
    failure = None
    try:
        if before_adopt is not None:
            before_adopt(gathered)
        for o in orphaned:
            if homes[int(o["part"])] == me:
                MG.note_replan(guard.dead_rows())
                got = adopt_part(int(o["part"]), o["fs"])
                if got is None:
                    raise RuntimeError(
                        f"the adopter of part {o['part']} failed too")
                rows.extend(got)
    except Exception as exc:
        failure = exc
    return gathered + _exchange_or_raise({"rows": rows}, failure, **kw)


def own_row(plan: PartitionPlan, mesh) -> int:
    """This rank's row of ``mesh`` split into ``plan.n_parts`` rows."""
    return mesh.rank // _inner(mesh, plan.n_parts)


class ThresholdBoard:
    """Conservative global top-k floor, monotonically tightening: the
    k-th largest support published so far, a LOWER bound on the global
    top-k threshold, so a partition starting at ``minsup = floor`` prunes
    only candidates that can never enter the global top-k."""

    def __init__(self, k: int, floor: int = 1):
        self.k = int(k)
        self._floor = max(1, int(floor))
        self._sups: List[int] = []  # top-k supports seen, ascending

    def floor(self) -> int:
        return self._floor

    def merge(self, supports: Sequence[int]) -> int:
        for s in supports:
            s = int(s)
            if len(self._sups) < self.k:
                bisect.insort(self._sups, s)
            elif s > self._sups[0]:
                self._sups.pop(0)
                bisect.insort(self._sups, s)
        if len(self._sups) >= self.k and self._sups[0] > self._floor:
            self._floor = self._sups[0]
        return self._floor


def fold_numeric_stats(dst: dict, src: dict) -> None:
    """Add one engine's numeric counters into an orchestrator's stats
    (strings, bools and containers skipped)."""
    for key, v in src.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        dst[key] = dst.get(key, 0) + v


def encode_patterns(results) -> list:
    """(pattern, support) results -> JSON rows for the exchange."""
    return [[[list(its) for its in pat], int(sup)]
            for pat, sup in results]


def decode_patterns(rows) -> list:
    return [(tuple(tuple(int(i) for i in its) for its in pat), int(sup))
            for pat, sup in rows]


def composite_state(fingerprint: dict, done: dict, active_part,
                    active_state, **extra) -> dict:
    """The partitioned composite checkpoint: the merged rows at top level
    in rewrite mode (``results_done=0``) plus the active partition's
    frontier in its engine's own ``frontier_state`` format."""
    return {
        "version": 1,
        "fingerprint": fingerprint,
        "stack": [],
        "results": [r for p in sorted(done) for r in done[p]],
        "results_done": 0,
        "partition": {
            "done": {str(p): done[p] for p in sorted(done)},
            "active_part": active_part,
            "active_state": active_state,
        },
        **extra,
    }


def decode_composite(resume: Optional[dict], fingerprint: dict):
    """(done, active_resume) from a composite snapshot; empty when the
    snapshot is missing or bound to another layout."""
    done: dict = {}
    active_resume: dict = {}
    if resume is not None and resume.get("fingerprint") == fingerprint:
        pr = resume.get("partition", {})
        for p_s, rows_p in pr.get("done", {}).items():
            done[int(p_s)] = [list(r) for r in rows_p]
        ap = pr.get("active_part")
        if ap is not None and pr.get("active_state") is not None:
            active_resume[int(ap)] = pr["active_state"]
    return done, active_resume


def _whole_frontier(state: dict, merged: list) -> dict:
    """An engine snapshot with every result of its slice so far: a delta
    snapshot (``results_done > 0``) gets the earlier results ``merged``
    holds prepended, so the nested frontier resumes on its own."""
    if state.get("results_done", 0):
        merged.extend(state["results"])
        return dict(state, results=list(merged), results_done=0)
    merged[:] = list(state["results"])
    return state


def mine_partitioned_slices(*, plan: PartitionPlan, meshes: list,
                            fingerprint: dict, mine_part,
                            resume: Optional[dict] = None,
                            checkpoint_cb=None,
                            stats: Optional[dict] = None,
                            mesh=None) -> list:
    """Mine fully independent class slices (SPADE, SPAM, cSPADE: a fixed
    minsup, nothing shared but the vertical DB) and exchange the result
    slices once at the end.

    ``mine_part(p, row_mesh, resume_state, part_cb)`` mines partition
    ``p``'s slice and returns JSON-able rows; it gets the part's resumed
    frontier (or None) and a callback for its engine's snapshots.  Each
    checkpoint is a :func:`composite_state` bound to ``fingerprint``; its
    nested frontier carries the whole slice's results so far (the port
    merges a delta snapshot's earlier results in).  ``mesh`` is the mesh
    the rows split (None: every part here, in turn).  Returns the union
    of every partition's rows.  Under the meshguard a dead row's slice is
    adopted (:func:`mine_on_rows`; on a world through the exchange), and
    the union stays the healthy run's."""
    done, active_resume = decode_composite(resume, fingerprint)
    guarded = MG.get() is not None
    world = mesh is not None and plan.n_parts > 1
    own = owned_parts(plan, mesh)
    orphans: list = []

    def run(p, resume_state, row_mesh, row=None):
        """Mine part ``p`` on ``row_mesh`` (row ``row``, default its own)
        from ``resume_state``; None when the part is orphaned."""
        last = {"fs": resume_state}
        part_cb = None
        if checkpoint_cb is not None or guarded:
            merged = list(resume_state["results"]) if resume_state else []

            def part_cb(fs, p=p, merged=merged):
                last["fs"] = _whole_frontier(fs, merged)
                if checkpoint_cb is not None:
                    checkpoint_cb(composite_state(fingerprint, done, p,
                                                  last["fs"]))
        rows = mine_on_rows(
            plan, p, lambda row, _attempt: mine_part(
                p, row_mesh if world else meshes[row], last["fs"], part_cb),
            world=world, row=row)
        if rows is ORPHANED:
            orphans.append({"part": p, "fs": last["fs"]})
            return None
        return list(rows)

    failure = None
    try:
        for p in own:
            if p in done:
                continue
            rows = run(p, active_resume.get(p), meshes[p])
            if rows is None:
                continue
            done[p] = rows
            if checkpoint_cb is not None:
                checkpoint_cb(composite_state(fingerprint, done, None, None))
    except Exception as exc:
        if not world:
            raise
        failure = exc   # every rank raises it together, after the exchange
    me = own_row(plan, mesh) if world else None
    # contribute only owned parts: a resumed composite can carry other
    # rows' slices, which their own rows contribute
    gathered = finish_round(
        {"rows": [r for p in sorted(done) if p in own for r in done[p]]},
        failure, orphans, lambda p, fs: run(p, fs, meshes[me], me),
        plan=plan, mesh=mesh, stats=stats)
    return [r for g in gathered for r in g["rows"]]
