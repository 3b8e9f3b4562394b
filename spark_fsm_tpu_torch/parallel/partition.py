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
- The exchange is one ``all_gather_object`` over the whole mesh, to which
  each row contributes once (its inner rank 0's payload).

Counters: the reference's ``fsm_partition_*`` registry families are the
plain integers of :func:`tallies` here (the registry is the service
plane's).  ``world_collectives`` counts the exchanges that crossed
processes, the only collective of the partitioned path that spans rows.

Not ported: the meshguard adoption loop of ``mine_partitioned_slices``
(a slice that fails raises); :func:`replan_surviving` and
:func:`adopters_for` are here for it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import threading
from typing import List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------- tallies

_lock = threading.Lock()
_tallies = {"plans": 0, "exchanges": 0, "cross_bytes": 0,
            "world_collectives": 0, "imbalance": 0.0,
            "mines": {"tsr": 0, "spade": 0, "spam": 0, "cspade": 0}}


def tallies() -> dict:
    """Partition plans built, exchange rounds, bytes exchanged, exchanges
    that crossed processes, the latest plan's imbalance and the
    partitioned mines by algorithm, over the process's lifetime."""
    with _lock:
        out = dict(_tallies)
        out["mines"] = dict(_tallies["mines"])
        return out


def count_mine(algo: str) -> None:
    with _lock:
        _tallies["mines"][algo] = _tallies["mines"].get(algo, 0) + 1


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
        with _lock:
            _tallies["plans"] += 1
            _tallies["imbalance"] = plan.imbalance_ratio
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
    return [mesh.rank // _inner(mesh, plan.n_parts)]


# --------------------------------------------------------------- exchange


def exchange_objects(payload, *, mesh=None, n_parts: int = 1,
                     stats: Optional[dict] = None,
                     record: bool = True) -> list:
    """One cross-partition exchange round: the list of every row's
    ``payload`` (any JSON-able object), in row order.

    Without a mesh the caller already holds every partition's data: the
    exchange returns ``[payload]`` and counts the round and the payload's
    bytes (what would cross between partitions).  On a mesh it is one
    ``all_gather_object`` over the mesh's group; each row contributes its
    inner rank 0's payload, and the bytes are the sum of those payloads'.

    ``stats`` mirrors the round and byte counts into an engine's stats
    (``partition_exchanges``, ``partition_cross_bytes``); ``record=False``
    leaves :func:`tallies` as it is."""
    crossed = mesh is not None and n_parts > 1
    if not crossed:
        nbytes = len(json.dumps(payload).encode("utf-8"))
        merged = [payload]
    else:
        import torch.distributed as dist

        inner = _inner(mesh, n_parts)
        gathered: list = [None] * mesh.size
        mine = payload if mesh.rank % inner == 0 else None
        dist.all_gather_object(gathered, mine, group=mesh.group)
        merged = [g for g in gathered if g is not None]
        nbytes = sum(len(json.dumps(g).encode("utf-8")) for g in merged)
    if record:
        with _lock:
            _tallies["exchanges"] += 1
            _tallies["cross_bytes"] += nbytes
            _tallies["world_collectives"] += int(crossed)
    if stats is not None:
        stats["partition_exchanges"] = (
            stats.get("partition_exchanges", 0) + 1)
        stats["partition_cross_bytes"] = (
            stats.get("partition_cross_bytes", 0) + nbytes)
    return merged


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
    of every partition's rows.  A slice that fails raises."""
    done, active_resume = decode_composite(resume, fingerprint)
    own = owned_parts(plan, mesh)
    for p in own:
        if p in done:
            continue
        part_cb = None
        if checkpoint_cb is not None:
            first = active_resume.get(p)
            merged = list(first["results"]) if first is not None else []

            def part_cb(fs, p=p, merged=merged):
                checkpoint_cb(composite_state(
                    fingerprint, done, p, _whole_frontier(fs, merged)))
        done[p] = list(mine_part(p, meshes[p], active_resume.get(p),
                                 part_cb))
        if checkpoint_cb is not None:
            checkpoint_cb(composite_state(fingerprint, done, None, None))
    # contribute only owned parts: a resumed composite can carry other
    # rows' slices, which their own rows contribute
    gathered = exchange_objects(
        {"rows": [r for p in sorted(done) if p in own for r in done[p]]},
        mesh=mesh, n_parts=plan.n_parts, stats=stats)
    return [r for g in gathered for r in g["rows"]]
