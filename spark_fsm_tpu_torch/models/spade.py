"""SPADE classic engine on a CUDA device, and the SPADE entry point — port
of ``spark_fsm_tpu/models/spade_tpu.py`` (``classic_geometry``,
``SpadeTPU`` as :class:`SpadeTorch`, ``mine_spade_tpu`` as
:func:`mine_spade_torch`, and ``_route_spade``, which routes a mine to
the queue engine ``spade_queue.py``, the dense engine ``spade_fused.py``
or this classic engine as the reference does).

- The vertical DB and all live pattern bitmaps sit in one device-resident
  flat ``store[slot, seq*word]`` int32 tensor (word minor).  Slots
  ``0..n_items-1`` are the item id-lists (never freed); the rest is a pool
  for pattern bitmaps.
- The host DFS pops nodes in batches.  Each batch's parent bitmaps are
  gathered and interleaved with their s-ext transforms once (prep); every
  candidate's support then comes from the pair-support kernel
  (``ops/pair_support.batch_supports``); the host applies the minsup prune
  and materializes only the surviving children into pool slots.
- ``pipeline_depth`` batches are in flight at once.  Each batch's supports
  go to a pinned host tensor with a non-blocking copy and a recorded CUDA
  event; resolving a batch waits on its event only.  Everything runs on
  one stream, so device work stays in order, and every read of a pool slot
  happens in prep (which copies the rows into the batch's own tensor) —
  that is what makes the in-place materialize safe while later batches
  are in flight.
- Memory safety is recompute-on-miss: a child that gets no slot (or whose
  slot was reclaimed) carries its extension path ``steps``, and its bitmap
  is rebuilt by folding the joins from the item id-lists — bit-exact.

Enumeration is identical to the CPU oracle, so the output pattern set is
byte-identical by construction.  ``shape_buckets`` rounds the sequence
axis and the store's rows to powers of two as the reference does (its
streaming windows set it); the port launches at live sizes either way, so
the buckets only keep the geometry, the routes and the counters equal to
the reference's.

With a ``mesh`` (``parallel.mesh.SeqMesh``) every rank runs this host
loop over its block of the sequence axis (the reference's ``shard_map``
over ``SEQ_AXIS``): prep, materialize and recompute are per-sequence and
stay local, and each batch's extracted supports are all-reduced (SUM)
before the prune (the reference's ``psum``), so every rank prunes alike.

``partition_parts > 1`` mines equivalence-class slices
(``parallel/partition.py``): a pattern's class is its first item, so each
partition seeds only its owned roots and the slices union to the whole
set.  Each slice routes queue -> classic (the dense engine has no root
slice); the composite checkpoint nests the active slice's frontier.  Not
ported: shape-key registration (ROADMAP Queue A item 13).

Traced (``utils/obs``), :func:`mine_spade_torch` is a ``mine.spade`` span
(a trace of its own outside a job) and a classic mine a ``spade.mine``
span: ``spade.roots``, then each batch's ``spade.dispatch`` (``slots``,
``prep``, ``candidates``, ``supports``) and ``spade.resolve`` (``wait``,
``prune``, ``materialize``), then ``mine.sort``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import VerticalDB, build_vertical
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    FrontierNode, SlotPool, auto_pool_bytes, bucket_store_rows,
    checkpoint_due, decode_frontier, device_axes, encode_frontier,
    engine_device, ensure_slots, frontier_fingerprint, key_seq,
    launch_width_cap, load_checkpoint, materialize_rows, prep_rows,
    scatter_build_store, shard_width, to_host, to_index)
from spark_fsm_tpu_torch.models.spade_fused import (
    FusedSpadeTorch, fused_eligible)
from spark_fsm_tpu_torch.models.spade_queue import (
    QueueSpadeTorch, queue_eligible)
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum, mesh_size
from spark_fsm_tpu_torch.utils import obs, shapes
from spark_fsm_tpu_torch.utils.canonical import Pattern, PatternResult, sort_patterns

Step = Tuple[int, bool]  # (item index, is_s_extension)

_Node = FrontierNode


def classic_geometry(n_sequences: int, n_items: int, n_words: int, *,
                     device: Optional[torch.device] = None,
                     mesh=None, chunk: int = 2048, node_batch: int = 1024,
                     pipeline_depth: int = 4, recompute_chunk: int = 256,
                     pool_bytes: Optional[int] = None,
                     shape_buckets: bool = False) -> dict:
    """Derived device geometry of a :class:`SpadeTorch`; pure host
    arithmetic.  ``device`` sizes the default pool budget and may be None
    only when ``pool_bytes`` is given.

    The budget covers the slot pool plus the in-flight prep tensors, and
    node_batch is bounded so pipeline_depth in-flight batches can never
    starve a recompute: slots held in flight <= depth*nb, so
    free+stack-reclaimable >= pool - (depth+1)*nb >= nb holds whenever
    nb <= pool // (depth+2).

    ``shape_buckets`` buckets the sequence axis (``_common.bucket_seq``)
    and rounds the store's rows (items, pool and the reference's scratch
    row, which stays unused here) to a power of two as the reference
    does without its Pallas kernel (``_common.bucket_store_rows``), so
    ``node_batch`` and ``pool_slots`` equal its.

    With a ``mesh`` the sequence axis is the reference's for that many
    shards (``_common.device_axes``), and the launch-width cap judges one
    shard's bytes of a row, as the reference's does.

    ``shape_key`` is the reference's ``classic:`` key: its sequence axis
    (``_common.key_seq``) and its store rows, the scratch row counted."""
    n_seq = device_axes(n_sequences, shape_buckets, mesh)
    if pool_bytes is None:
        pool_bytes = auto_pool_bytes(device)
    # the budget judges the reference's sequence axis (no tile pad, at
    # most 31 sequences a row fewer), so the pool equals its
    ks = key_seq(n_sequences, shape_buckets, mesh)
    slot_bytes = ks * n_words * 4
    # memory-safety ceiling on launch widths; overrides an explicit chunk
    max_chunk = launch_width_cap(pool_bytes,
                                 -(-slot_bytes // mesh_size(mesh)), 8)
    chunk = min(int(chunk), max_chunk)
    recompute_chunk = min(int(recompute_chunk), max(4, max_chunk // 2))
    budget_slots = max(64, min(int(pool_bytes) // max(slot_bytes, 1), 32768))
    pipeline_depth = min(max(1, int(pipeline_depth)),
                         max(1, budget_slots // 8))
    d = pipeline_depth
    nb = max(1, min(int(node_batch), budget_slots // (3 * (d + 2))))
    pool_slots = max(8, budget_slots - 2 * d * nb)
    total = n_items + pool_slots
    if shape_buckets:
        total, pool_slots, nb = bucket_store_rows(
            total + 1, n_items, budget_slots, nb, d)
    return {
        "n_seq": n_seq, "chunk": chunk, "recompute_chunk": recompute_chunk,
        "pipeline_depth": pipeline_depth, "node_batch": nb,
        "pool_slots": pool_slots, "total_rows": total,
        "shape_key": shapes.key_classic(ks, n_words,
                                        n_items + pool_slots + 1, nb, chunk),
    }


class SpadeTorch:
    """Single-device or sequence-sharded SPADE miner.

    Args:
      vdb: vertical DB (build with ``min_item_support=minsup_abs``).
      minsup_abs: absolute minimum sequence support.
      device: ``None`` (= CUDA, raising without it) or ``"cpu"``.
      mesh: optional ``parallel.mesh.SeqMesh``; this rank mines its block
        of the sequence axis on the mesh's device.
      chunk: candidates per materialize launch.
      node_batch: DFS nodes popped per host iteration.
      pipeline_depth: node batches in flight at once.
      recompute_chunk: nodes rebuilt per recompute launch.
      pool_bytes: device memory budget for the pattern-bitmap pool.
      max_pattern_itemsets: optional cap on pattern length in itemsets.
      shape_buckets: bucketed geometry (:func:`classic_geometry`).
      partition: optional ``(PartitionPlan, part)``: seed only the roots
        whose class the part owns.
    """

    def __init__(
        self,
        vdb: VerticalDB,
        minsup_abs: int,
        *,
        device: DeviceLike = None,
        mesh=None,
        chunk: int = 2048,
        node_batch: int = 1024,
        pipeline_depth: int = 4,
        recompute_chunk: int = 256,
        pool_bytes: Optional[int] = None,
        max_pattern_itemsets: Optional[int] = None,
        shape_buckets: bool = False,
        partition=None,
    ):
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        self.vdb = vdb
        self.minsup = int(minsup_abs)
        self._partition = partition
        self.max_pattern_itemsets = max_pattern_itemsets
        n_items, n_words = vdb.n_items, vdb.n_words
        g = classic_geometry(
            vdb.n_sequences, n_items, n_words, device=self.device, mesh=mesh,
            chunk=chunk, node_batch=node_batch, pipeline_depth=pipeline_depth,
            recompute_chunk=recompute_chunk, pool_bytes=pool_bytes,
            shape_buckets=shape_buckets)
        self.n_items, self.n_seq, self.n_words = n_items, g["n_seq"], n_words
        # the width of this rank's store rows (n_seq without a mesh)
        self.s_local = shard_width(self.n_seq, mesh)
        self.chunk = g["chunk"]
        self.recompute_chunk = g["recompute_chunk"]
        self.pipeline_depth = g["pipeline_depth"]
        self.pool_slots = g["pool_slots"]
        self.node_batch = g["node_batch"]
        self.store = scatter_build_store(vdb, g["total_rows"], self.n_seq,
                                         n_words, self.device, mesh)
        self._pool = SlotPool(range(n_items, n_items + self.pool_slots))
        self.stats = {
            "candidates": 0, "kernel_launches": 0, "recomputed_nodes": 0,
            "reclaimed_slots": 0, "patterns": 0,
            "shape_key": g["shape_key"],
        }
        shapes.record(g["shape_key"])

    # ------------------------------------------------------------ helpers

    def _alloc(self) -> Optional[int]:
        return self._pool.alloc()

    def _free_slot(self, slot: Optional[int]) -> None:
        if slot is not None and slot >= self.n_items:  # item rows never free
            self._pool.free(slot)

    # ------------------------------------------------------------- kernels

    def _prep(self, batch: List[_Node]) -> torch.Tensor:
        """The batch's interleaved plain/transformed parent rows, sized to
        the live batch (the kernel takes any row count)."""
        with obs.span("spade.prep", launches=1):
            pt = prep_rows(self.store, [n.slot for n in batch], self.s_local,
                           self.n_words)
        self.stats["kernel_launches"] += 1
        return pt

    def _supports_dispatch(self, pt: torch.Tensor, ref: np.ndarray,
                           item: np.ndarray, iss: np.ndarray):
        """Dispatch the batch's supports through the pair-support kernel
        (on a mesh: this shard's, then the all-reduce); on CUDA, start the
        copy into a pinned host tensor and record an event behind it.
        Returns ``(supports, event_or_None)``."""
        self.stats["candidates"] += len(ref)
        with obs.span("spade.supports", candidates=len(ref)):
            sup = PS.batch_supports(pt, self.store, self.n_items,
                                    to_index(2 * ref + iss, self.device),
                                    to_index(item, self.device),
                                    n_words=self.n_words)
            all_reduce_sum(sup, self.mesh)
            self.stats["kernel_launches"] += 1
            (host,), ev = to_host([sup])
        return host, ev

    # ---------------------------------------------------------------- mine

    def _pattern_of(self, steps: Sequence[Step]) -> Pattern:
        ids = self.vdb.item_ids
        pat: List[List[int]] = []
        for it, is_s in steps:
            if is_s:
                pat.append([int(ids[it])])
            else:
                pat[-1].append(int(ids[it]))
        return tuple(tuple(s) for s in pat)

    def _dispatch(self, stack: List[_Node]):
        """Pop a node batch, dispatch its supports, start the host copy.
        Returns everything the resolve step needs."""
        with obs.span("spade.dispatch") as dsp:
            batch = [stack.pop()
                     for _ in range(min(self.node_batch, len(stack)))]
            dsp.set(nodes=len(batch))
            with obs.span("spade.slots") as sp:
                before = self.stats["kernel_launches"]
                ensure_slots(self.store, self._pool, batch, stack,
                             first_pool_slot=self.n_items,
                             group=self.recompute_chunk,
                             n_seq=self.s_local, n_words=self.n_words,
                             stats=self.stats)
                sp.set(launches=self.stats["kernel_launches"] - before)
            pt = self._prep(batch)

            # Flat candidate list for the whole batch (ref = index in batch).
            with obs.span("spade.candidates"):
                cand_item: List[int] = []
                cand_iss: List[bool] = []
                cand_ref: List[int] = []
                spans: List[Tuple[int, int, int]] = []  # (s_lo, s_hi == i_lo, i_hi)
                for b_idx, node in enumerate(batch):
                    n_itemsets = sum(1 for _, s in node.steps if s)
                    allow_s = (self.max_pattern_itemsets is None
                               or n_itemsets < self.max_pattern_itemsets)
                    s_lo = len(cand_ref)
                    if allow_s:
                        for i in node.s_list:
                            cand_ref.append(b_idx); cand_item.append(i); cand_iss.append(True)
                    s_hi = len(cand_ref)
                    for i in node.i_list:
                        cand_ref.append(b_idx); cand_item.append(i); cand_iss.append(False)
                    spans.append((s_lo, s_hi, len(cand_ref)))
                arrays = (np.array(cand_ref, np.int64),
                          np.array(cand_item, np.int64),
                          np.array(cand_iss, np.int64))

            sup, ev = (self._supports_dispatch(pt, *arrays)
                       if cand_ref else (None, None))
        return batch, pt, cand_item, cand_iss, spans, sup, ev

    def _resolve(self, inflight, stack: List[_Node],
                 results: List[PatternResult]) -> None:
        """Wait for a dispatched batch's supports; prune, materialize
        surviving children, push them on the DFS stack."""
        batch, pt, cand_item, cand_iss, spans, sup, ev = inflight
        minsup = self.minsup
        with obs.span("spade.resolve", nodes=len(batch)):
            with obs.span("spade.wait"):
                if sup is None:
                    sups = np.empty(0, np.int32)
                else:
                    if ev is not None:
                        ev.synchronize()
                    sups = sup.numpy()

            with obs.span("spade.prune") as sp:
                children: List[_Node] = []
                mat_ref: List[int] = []; mat_item: List[int] = []
                mat_iss: List[int] = []; mat_child: List[int] = []
                for b_idx, (node, (s_lo, s_hi, i_hi)) in enumerate(zip(batch, spans)):
                    n_itemsets = sum(1 for _, s in node.steps if s)
                    s_items = [cand_item[k] for k in range(s_lo, s_hi) if sups[k] >= minsup]
                    i_items = [cand_item[k] for k in range(s_hi, i_hi) if sups[k] >= minsup]
                    for k in range(s_lo, i_hi):
                        if sups[k] < minsup:
                            continue
                        it, is_s = cand_item[k], cand_iss[k]
                        steps = node.steps + ((it, is_s),)
                        results.append((self._pattern_of(steps), int(sups[k])))
                        src = s_items if is_s else i_items
                        child_i = [j for j in src if j > it]
                        child_itemsets = n_itemsets + (1 if is_s else 0)
                        child_allow_s = (self.max_pattern_itemsets is None
                                         or child_itemsets < self.max_pattern_itemsets)
                        if not ((s_items and child_allow_s) or child_i):
                            continue  # leaf: no possible extensions
                        child = _Node(steps, None, s_items, child_i)
                        slot = self._alloc()
                        if slot is not None:
                            child.slot = slot
                            mat_ref.append(b_idx); mat_item.append(it)
                            mat_iss.append(int(is_s)); mat_child.append(slot)
                        children.append(child)
                sp.set(children=len(children))
            with obs.span("spade.materialize", rows=len(mat_child)) as sp:
                launches = materialize_rows(
                    self.store, pt, np.array(mat_ref, np.int64),
                    np.array(mat_item, np.int64), np.array(mat_iss, np.int64),
                    np.array(mat_child, np.int64), self.chunk) if mat_child else 0
                self.stats["kernel_launches"] += launches
                sp.set(launches=launches)
                stack.extend(reversed(children))
                for node in batch:
                    self._free_slot(node.slot)

    def frontier_fingerprint(self) -> dict:
        """Identity of the (vdb, minsup) a frontier checkpoint binds to —
        the reference engine's exact fields, so snapshots interchange."""
        return frontier_fingerprint(self.vdb, self.minsup,
                                    self.max_pattern_itemsets)

    def frontier_state(self, stack: List[_Node],
                       results: List[PatternResult],
                       results_from: int = 0) -> dict:
        """Snapshot of a paused DFS (see _common.encode_frontier)."""
        return encode_frontier(self.frontier_fingerprint(), stack, results,
                               results_from)

    def mine(self, *, resume: Optional[dict] = None,
             checkpoint_cb=None,
             checkpoint_every_s: float = 30.0) -> List[PatternResult]:
        """Run the DFS; optionally resumable.

        Args:
          resume: a ``frontier_state`` snapshot (from either package) to
            continue from; its fingerprint must match this engine's.
          checkpoint_cb: called with a ``frontier_state`` dict at most
            every ``checkpoint_every_s`` seconds (the in-flight pipeline is
            drained first so the snapshot is consistent).
        """
        with obs.span("spade.mine"):
            return self._mine(resume, checkpoint_cb, checkpoint_every_s)

    def _mine(self, resume, checkpoint_cb, checkpoint_every_s):
        minsup = self.minsup
        # every mine starts from a whole slot pool (a repeat mine on a
        # cached engine must not inherit the last one's free list or its
        # reclaim count): no node of this mine holds a slot yet
        self._pool = SlotPool(range(self.n_items,
                                    self.n_items + self.pool_slots))
        stack: List[_Node] = []
        results: List[PatternResult]
        with obs.span("spade.roots"):
            if resume is not None:
                results, stack = decode_frontier(
                    resume, self.frontier_fingerprint(), _Node)
                self.stats["resumed_nodes"] = len(stack)
            else:
                results = []
                root_items = [i for i in range(self.n_items)
                              if int(self.vdb.item_supports[i]) >= minsup]
                seed = set(PN.owned_roots(root_items, self.vdb.item_ids,
                                          self._partition))
                for i in reversed(root_items):
                    if i not in seed:
                        continue  # another partition's class slice
                    results.append((self._pattern_of(((i, True),)),
                                    int(self.vdb.item_supports[i])))
                    stack.append(_Node(((i, True),), i, root_items,
                                       [j for j in root_items if j > i]))

        # Software-pipelined DFS: up to pipeline_depth batches in flight.
        # Resolving out of strict DFS order only permutes enumeration order;
        # the pattern SET is unchanged (canonicalized in sort_patterns).
        ckpt_done = len(results) if resume is not None else 0
        last_ckpt = time.monotonic()
        inflight: deque = deque()
        while stack or inflight:
            while stack and len(inflight) < self.pipeline_depth:
                inflight.append(self._dispatch(stack))
            self._resolve(inflight.popleft(), stack, results)
            if checkpoint_due(checkpoint_cb, last_ckpt, checkpoint_every_s,
                              self.mesh):
                while inflight:  # drain for a consistent frontier
                    self._resolve(inflight.popleft(), stack, results)
                checkpoint_cb(self.frontier_state(stack, results,
                                                  results_from=ckpt_done))
                ckpt_done = len(results)
                self.stats["checkpoints"] = self.stats.get("checkpoints", 0) + 1
                last_ckpt = time.monotonic()

        self.stats["patterns"] = len(results)
        with obs.span("mine.sort", patterns=len(results)):
            return sort_patterns(results)


_FUSED = ("auto", "always", "never", "queue", "dense")


def mine_spade_torch(
    db: SequenceDB,
    minsup_abs: int,
    *,
    device: DeviceLike = None,
    mesh=None,
    max_pattern_itemsets: Optional[int] = None,
    stats_out: Optional[dict] = None,
    checkpoint=None,
    fused: str = "auto",
    partition_parts: int = 0,
    partition_classes: int = 64,
    shape_buckets: bool = False,
    **kwargs,
) -> List[PatternResult]:
    """DB -> vertical build -> device mine, on ``device`` (default CUDA;
    raises without it).

    ``checkpoint`` (optional): an object with ``load() -> Optional[dict]``,
    ``save(state)`` and ``every_s``; a saved frontier (from either
    package, either engine) is resumed when its fingerprint still matches.

    ``fused`` routes as the reference does: "auto" tries the queue engine
    when ``queue_eligible`` passes, then the dense engine when
    ``fused_eligible`` passes, then the classic engine; a cap overflow
    falls through to the next.  "queue" and "dense" pin one whole-mine
    engine (still falling back on overflow), "always" tries both
    regardless of the size tests, "never" pins the classic engine.  A
    checkpointed mine runs the queue engine (in segments) or the classic
    one, never the dense engine.  ``stats_out`` gets the engine's stats
    and the routing keys (``fused``, ``fused_overflow``, ``fused_waves``,
    ``fused_levels``, ``fused_skipped``).  ``shape_buckets`` reaches
    every engine and the routing tests, as in the reference.  ``mesh``
    (a ``parallel.mesh.SeqMesh``) shards the sequence axis over its ranks:
    every rank calls this with the same arguments and gets the same
    result, and the routing tests judge one shard's bytes as the
    reference's do.  ``partition_parts > 1`` mines ``partition_classes``
    equivalence classes in that many slices (:func:`_mine_spade_partitioned`;
    on a mesh, one row of ranks a slice).  ``kwargs`` go to
    :class:`SpadeTorch`.
    """
    dev = engine_device(device, mesh)
    if fused not in _FUSED:
        raise ValueError(f"fused must be one of {_FUSED}, got {fused!r}")
    with obs.mine_trace("mine.spade", minsup=int(minsup_abs), fused=fused):
        vdb = build_vertical(db, min_item_support=minsup_abs)
        if vdb.n_items == 0:
            return []
        if partition_parts and int(partition_parts) > 1:
            return _mine_spade_partitioned(
                vdb, minsup_abs, device=dev, mesh=mesh,
                parts=int(partition_parts), classes=int(partition_classes),
                max_pattern_itemsets=max_pattern_itemsets,
                stats_out=stats_out, checkpoint=checkpoint, fused=fused,
                shape_buckets=shape_buckets, **kwargs)
        return _route_spade(vdb, minsup_abs, device=dev, mesh=mesh,
                            max_pattern_itemsets=max_pattern_itemsets,
                            stats_out=stats_out, checkpoint=checkpoint,
                            fused=fused, shape_buckets=shape_buckets,
                            **kwargs)


def _route_spade(
    vdb: VerticalDB,
    minsup_abs: int,
    *,
    device: DeviceLike = None,
    mesh=None,
    max_pattern_itemsets: Optional[int] = None,
    stats_out: Optional[dict] = None,
    checkpoint=None,
    fused: str = "auto",
    shape_buckets: bool = False,
    partition=None,
    **kwargs,
) -> List[PatternResult]:
    """The reference's engine ladder (``spade_tpu._route_spade``): queue,
    then dense, then classic, each engine and routing test judging the
    bucketed sequence axis when ``shape_buckets``, and one shard of it
    under a ``mesh``.  A ``partition`` slice reaches the queue and
    classic engines; the dense engine, which has no root slice, is gated
    off under one."""
    ekw = dict(device=device, mesh=mesh,
               max_pattern_itemsets=max_pattern_itemsets,
               shape_buckets=shape_buckets)
    if fused in ("auto", "always", "queue"):
        if fused in ("always", "queue") or queue_eligible(
                vdb, device, shape_buckets=shape_buckets, mesh=mesh):
            qeng = QueueSpadeTorch(vdb, minsup_abs, partition=partition,
                                   **ekw)
            q_resume, q_save, q_every = load_checkpoint(
                checkpoint, qeng.frontier_fingerprint())
            res = qeng.mine(resume=q_resume, checkpoint_cb=q_save,
                            checkpoint_every_s=q_every)
            if res is not None:
                if stats_out is not None:
                    stats_out.update(qeng.stats)
                return res
            # cap overflow: fall through, the marker kept visible; a
            # checkpointed mine's classic fallback resumes the queue
            # engine's last snapshot (shared format and fingerprint)
            if stats_out is not None:
                stats_out["fused_overflow"] = True
                stats_out["fused_waves"] = qeng.stats.get("waves", 0)
            del qeng  # frees the queue store before the next engine's
    if checkpoint is not None and fused in ("always", "dense", "auto"):
        # the dense engine has no resumable frontier: a checkpointed mine
        # that would have used it runs the classic engine, flagged
        if stats_out is not None and (
                fused in ("always", "dense") or fused_eligible(
                    vdb, device, shape_buckets=shape_buckets, mesh=mesh)):
            stats_out["fused_skipped"] = "checkpoint"
    if checkpoint is None and partition is None \
            and fused in ("always", "dense", "auto"):
        if fused in ("always", "dense") or fused_eligible(
                vdb, device, shape_buckets=shape_buckets, mesh=mesh):
            feng = FusedSpadeTorch(vdb, minsup_abs, **ekw)
            res = feng.mine()
            if res is not None:
                if stats_out is not None:
                    stats_out.update(feng.stats)
                return res
            if stats_out is not None:
                stats_out["fused_overflow"] = True
                stats_out["fused_levels"] = feng.stats.get("levels", 0)
    eng = SpadeTorch(vdb, minsup_abs, partition=partition, **ekw, **kwargs)
    resume, save_cb, every_s = load_checkpoint(
        checkpoint, eng.frontier_fingerprint())
    results = eng.mine(resume=resume, checkpoint_cb=save_cb,
                       checkpoint_every_s=every_s)
    if stats_out is not None:
        stats_out.update(eng.stats)
        # the routing decision is always recorded ("routed classic")
        stats_out.setdefault("fused", False)
    return results


class _SliceCheckpoint:
    """The engines' checkpoint contract (``load``, ``save``, ``every_s``)
    over a partition slice's resumed state and snapshot callback."""

    def __init__(self, state, save, every_s: float):
        self._state = state
        self.save = save
        self.every_s = every_s

    def load(self):
        return self._state


def _mine_spade_partitioned(
    vdb: VerticalDB,
    minsup_abs: int,
    *,
    device: DeviceLike,
    mesh,
    parts: int,
    classes: int,
    max_pattern_itemsets: Optional[int],
    stats_out: Optional[dict],
    checkpoint,
    fused: str,
    **kwargs,
) -> List[PatternResult]:
    """Equivalence-class partitioned SPADE (``spade_tpu.
    _mine_spade_partitioned``): each partition mines the patterns rooted
    at its owned classes as an independent slice (a fixed minsup), and
    the union of the slices is the exact pattern set.  Each slice routes
    queue -> classic: ``fused`` "always"/"dense" map to "auto", since the
    dense engine has no root slice.  Checkpoints are composite
    (``partition.mine_partitioned_slices``)."""
    plan = PN.plan_partitions(vdb.item_ids, vdb.item_supports, parts,
                              classes)
    meshes = PN.submeshes(mesh, parts)
    fused_p = fused if fused in ("never", "queue", "auto") else "auto"
    fingerprint = dict(
        frontier_fingerprint(vdb, minsup_abs, max_pattern_itemsets),
        partition=plan.fingerprint())
    resume, save_cb, every_s = load_checkpoint(checkpoint, fingerprint)
    stats: dict = {
        "partition_parts": int(parts),
        "partition_classes": int(classes),
        "partition_imbalance": round(plan.imbalance_ratio, 4),
    }
    PN.count_mine("spade")

    def mine_part(p, row_mesh, resume_state, part_cb):
        part_stats: dict = {}
        ckpt = None
        if resume_state is not None or part_cb is not None:
            ckpt = _SliceCheckpoint(resume_state, part_cb, every_s)
        res = _route_spade(
            vdb, minsup_abs, device=device, mesh=row_mesh,
            max_pattern_itemsets=max_pattern_itemsets,
            stats_out=part_stats, checkpoint=ckpt, fused=fused_p,
            partition=(plan, p), **kwargs)
        PN.fold_numeric_stats(stats, part_stats)
        return PN.encode_patterns(res)

    rows = PN.mine_partitioned_slices(
        plan=plan, meshes=meshes, fingerprint=fingerprint,
        mine_part=mine_part, resume=resume, checkpoint_cb=save_cb,
        stats=stats, mesh=mesh)
    results = sort_patterns(PN.decode_patterns(rows))
    stats["patterns"] = len(results)
    stats["fused"] = "partitioned"
    if stats_out is not None:
        stats_out.update(stats)
    return results
