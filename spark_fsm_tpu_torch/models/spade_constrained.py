"""Constrained SPADE (maxgap / maxwindow) on a CUDA device: the max-start
state engine — port of ``spark_fsm_tpu/models/spade_constrained.py``
(``cspade_geometry``, ``_cspade_fns`` as the engine's device steps,
``ConstrainedSpadeTPU`` as :class:`ConstrainedSpadeTorch`,
``mine_cspade_tpu`` as :func:`mine_cspade_torch`).

The batched DFS of the classic engine (``models/spade.py``: a slot pool
on the device, chunked launches, recompute-on-miss, ``pipeline_depth``
node batches in flight), but the per-pattern device state is the
max-start array of ``ops/maxstart_torch.py`` instead of an end-position
bitmap, because gap and window checks need where occurrences start.  The
state is int8 when positions fit (<= 127), else int16.

Enumeration, as the oracle ``models/oracle.mine_cspade``:
- under maxgap the s-extension candidates are all frequent root items
  (sibling S-list pruning is unsound there); with no gap bound the usual
  sibling prune applies;
- i-extension sibling pruning stays valid (same positions);
- pruning on the windowed support is exact: it is anti-monotone under
  prefix growth.

No Pallas kernel backs the reference engine.  Here the supports run on
hand kernels: a candidate's windowed support is the count of sequences
where its item meets a window mask of its parent node alone, so each
batch launches the mask kernel (``ops/maxstart_masks``,
``csrc/maxstart_masks.cu``) once and kernel B1 (``ops/pair_support``)
once over (mask row, item) pairs, and builds no child state to count
it.  The other device steps (prep, materialise, recompute) are torch ops
(gathers, the position-axis running or shifted max, masks).  The
reference's ``lax.scan`` recompute fold is a loop over the steps.  Every
step counts ``kernel_launches`` as the reference counts its dispatches
(the supports one a ``chunk`` of candidates), so with a pinned geometry
the stats equal the reference's.  The slot reclaim works
on max-start states, not on bitmap joins, so the engine keeps its own
``_ensure_slots`` over ``_common.SlotPool``.

``shape_buckets`` buckets the sequence axis and the item rows as the
reference does (:func:`cspade_geometry`).  With a ``mesh`` every rank
keeps its block of the sequence axis (item bitmaps and state pool), the
device steps are per-sequence and stay local, and each batch's windowed
supports are all-reduced (SUM) before the prune (the reference's
``psum``).  ``partition_parts > 1`` mines equivalence-class slices
(:func:`_mine_cspade_partitioned`): a pattern's class is its first item,
and the constraints change support counting, not the class structure.

Traced (``utils/obs``), :func:`mine_cspade_torch` is a ``mine.cspade``
span, construction a ``cspade.engine`` span (``store.build`` and the
pool's zero-fill ``cspade.pool`` inside it) and a mine the classic
engine's set of spans under ``cspade.*``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import VerticalDB, build_vertical
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    FrontierNode, SlotPool, auto_pool_bytes, bucket_seq, checkpoint_due,
    decode_frontier, encode_frontier, engine_device, launch_width_cap,
    load_checkpoint, scatter_build_store, shard_width, to_host, to_index)
from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
from spark_fsm_tpu_torch.ops import maxstart_masks as MM
from spark_fsm_tpu_torch.ops import maxstart_torch as MS
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import (
    all_reduce_sum, mesh_size, pad_to_multiple)
from spark_fsm_tpu_torch.utils import obs, shapes
from spark_fsm_tpu_torch.utils.canonical import (
    Pattern, PatternResult, sort_patterns)

# the one frontier-node shape every engine snapshots (see _common); here
# s_list holds siblings when maxgap is None, else all roots
_Node = FrontierNode


def cspade_geometry(n_sequences: int, n_items: int, n_words: int, *,
                    maxgap: Optional[int] = None,
                    maxwindow: Optional[int] = None,
                    device: DeviceLike = None, mesh=None, chunk: int = 256,
                    node_batch: int = 32, pipeline_depth: int = 4,
                    recompute_chunk: int = 32,
                    pool_bytes: Optional[int] = None,
                    shape_buckets: bool = False) -> dict:
    """Derived device geometry of a :class:`ConstrainedSpadeTorch`; pure
    host arithmetic, the reference's formulas.  The pool shares the
    budget with ``pipeline_depth`` in-flight (m, pm) preps, and
    ``node_batch`` is bounded so in-flight batches can never starve a
    recompute.  ``device`` sizes the default pool budget and may be None
    only when ``pool_bytes`` is given.  ``shape_buckets`` buckets the
    sequence axis (``_common.bucket_seq``) and rounds the item rows up to
    a power of two of at least 16; the extra rows stay all-zero.  A
    ``mesh`` pads the sequence axis to a multiple of its rank count and
    caps the launch width on one shard's bytes, as the reference does.
    ``shape_key`` is the reference's ``cspade:`` key, which carries the
    constraint pair and the state dtype's bits."""
    n_seq = int(n_sequences)
    item_rows = n_items
    if shape_buckets:
        n_seq = bucket_seq(n_seq)
        item_rows = max(16, next_pow2(n_items))
    if mesh is not None:
        n_seq = pad_to_multiple(n_seq, mesh_size(mesh))
    n_pos = n_words * 32
    dtype = MS.state_dtype(n_pos)
    state_bits = 8 if dtype == torch.int8 else 16
    if pool_bytes is None:
        pool_bytes = auto_pool_bytes(engine_device(device, mesh))
    slot_bytes = n_seq * n_pos * (state_bits // 8)
    # memory-safety ceiling on per-launch [chunk, S, n_pos] temporaries
    max_chunk = launch_width_cap(pool_bytes,
                                 -(-slot_bytes // mesh_size(mesh)), 4)
    chunk = min(int(chunk), max_chunk)
    recompute_chunk = min(int(recompute_chunk), max(2, max_chunk // 2))
    budget_slots = max(32, min(int(pool_bytes) // max(slot_bytes, 1), 8192))
    pipeline_depth = min(max(1, int(pipeline_depth)),
                         max(1, budget_slots // 8))
    d = pipeline_depth
    nb = max(1, min(int(node_batch), budget_slots // (3 * (d + 2))))
    pool_slots = max(8, budget_slots - 2 * d * nb)
    return {
        "n_seq": n_seq, "item_rows": item_rows, "n_pos": n_pos,
        "dtype": dtype, "state_bits": state_bits, "chunk": chunk,
        "recompute_chunk": recompute_chunk,
        "pipeline_depth": pipeline_depth, "node_batch": nb,
        "pool_slots": pool_slots,
        "shape_key": shapes.key_cspade(n_seq, n_words, item_rows,
                                       pool_slots, nb, chunk, maxgap,
                                       maxwindow, state_bits),
    }


class ConstrainedSpadeTorch:
    """Single-device constrained SPADE miner.

    Args:
      vdb: vertical DB (build with ``min_item_support=minsup_abs``).
      minsup_abs: absolute minimum sequence support (of the windowed
        support).
      maxgap / maxwindow: the cSPADE constraints (None = unbounded).
      device: ``None`` (= CUDA, raising without it) or ``"cpu"``.
      chunk, node_batch, pipeline_depth, recompute_chunk, pool_bytes,
        shape_buckets: the geometry (:func:`cspade_geometry`).
      max_pattern_itemsets: optional cap on pattern length in itemsets.
    """

    def __init__(
        self,
        vdb: VerticalDB,
        minsup_abs: int,
        *,
        maxgap: Optional[int] = None,
        maxwindow: Optional[int] = None,
        device: DeviceLike = None,
        mesh=None,
        chunk: int = 256,
        node_batch: int = 32,
        pipeline_depth: int = 4,
        recompute_chunk: int = 32,
        pool_bytes: Optional[int] = None,
        max_pattern_itemsets: Optional[int] = None,
        shape_buckets: bool = False,
        partition=None,
    ):
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        self.vdb = vdb
        self.minsup = int(minsup_abs)
        # a (PartitionPlan, part) slice seeds only the owned classes'
        # roots; the candidate lists stay full-width (under maxgap the
        # s-side is every frequent root)
        self._partition = partition
        self.maxgap = maxgap
        self.maxwindow = maxwindow
        self.max_pattern_itemsets = max_pattern_itemsets
        with obs.span("cspade.engine"):
            n_items, n_words = vdb.n_items, vdb.n_words
            g = cspade_geometry(
                vdb.n_sequences, n_items, n_words, maxgap=maxgap,
                maxwindow=maxwindow, device=self.device, mesh=mesh,
                chunk=chunk, node_batch=node_batch,
                pipeline_depth=pipeline_depth, recompute_chunk=recompute_chunk,
                pool_bytes=pool_bytes, shape_buckets=shape_buckets)
            self.n_items, self.n_seq, self.n_words = n_items, g["n_seq"], n_words
            self.item_rows = g["item_rows"]
            self.n_pos = g["n_pos"]
            self.dtype = g["dtype"]
            self.chunk = g["chunk"]
            self.recompute_chunk = g["recompute_chunk"]
            self.pipeline_depth = g["pipeline_depth"]
            self.node_batch = g["node_batch"]
            self.pool_slots = g["pool_slots"]
            # the item bitmaps scatter-built on the device, viewed as words
            # (rows past n_items, under shape_buckets, stay all-zero and are
            # never indexed), and the state pool
            # this rank's block of the sequence axis (all of it without a mesh)
            self.s_local = shard_width(self.n_seq, mesh)
            self._words = scatter_build_store(
                vdb, self.item_rows, self.n_seq, n_words, self.device,
                mesh).view(self.item_rows, self.s_local, n_words)
            with obs.span("cspade.pool", slots=self.pool_slots):
                self.pool = torch.zeros(
                    (self.pool_slots, self.s_local, self.n_pos),
                    dtype=self.dtype, device=self.device)
            self._pool_alloc = SlotPool(range(self.pool_slots))
            # s_candidates vs i_candidates: under maxgap the s-side is all
            # root items per node, so its share is the cost of that constraint
            self.stats = {"candidates": 0, "s_candidates": 0, "i_candidates": 0,
                          "kernel_launches": 0, "recomputed_nodes": 0,
                          "reclaimed_slots": 0, "patterns": 0,
                          "shape_key": g["shape_key"]}
            shapes.record(g["shape_key"])

    # ------------------------------------------------------- device steps

    def _root_states(self, idx: torch.Tensor) -> torch.Tensor:
        return MS.root_state(self._words.index_select(0, idx), self.dtype)

    def _child(self, m, pm, ref, item_idx, iss) -> torch.Tensor:
        """Children states: s-extension from ``pm[ref]``, i-extension from
        ``m[ref]``, where the item occurs."""
        occ = MS.expand_bits(self._words.index_select(0, item_idx))
        base = torch.where(iss[:, None, None], pm.index_select(0, ref),
                           m.index_select(0, ref))
        return torch.where(occ & (base >= 0), base, MS.NONE)

    def _prep(self, batch: List[_Node]):
        """The batch's states (roots read theirs straight from the item
        bitmaps) and their ``prev_max``."""
        roots = np.zeros(len(batch), np.int64)
        slots = np.zeros(len(batch), np.int64)
        is_root = np.zeros(len(batch), bool)
        for i, n in enumerate(batch):
            if len(n.steps) == 1:
                is_root[i] = True
                roots[i] = n.steps[0][0]
            else:
                slots[i] = n.slot
        dev = self.device
        with obs.span("cspade.prep", launches=1):
            m = torch.where(torch.from_numpy(is_root).to(dev)[:, None, None],
                            self._root_states(to_index(roots, dev)),
                            self.pool.index_select(0, to_index(slots, dev)))
            self.stats["kernel_launches"] += 1
            return m, MS.prev_max(m, self.maxgap)

    def _supports(self, m, pm, ref, item, iss):
        """Windowed supports of the candidates (all-reduced on a mesh) with
        the host copy started; returns ``(supports, event_or_None)``.
        B1 counts each candidate's (window mask row, item) pair: row
        ``2 ref`` for an s-extension, ``2 ref + 1`` for an i-extension.
        ``kernel_launches`` counts the reference's dispatches, one a
        ``chunk`` of candidates; the span's ``masks`` and ``b1`` attrs
        count the kernels' own launches."""
        with obs.span("cspade.supports", candidates=len(ref)) as sp:
            masks0 = MM.window_masks.launches
            b1_0 = PS.pair_supports.launches
            dev = self.device
            masks = MM.window_masks(m, pm, self.maxwindow, self.n_words)
            pref = 2 * ref + np.where(iss, 0, 1)
            sup = PS.batch_supports(
                masks, self._words.view(self.item_rows, -1), self.item_rows,
                to_index(pref, dev), to_index(item, dev), self.n_words,
                n_live=self.n_items)
            launches = -(-len(ref) // self.chunk)
            self.stats["kernel_launches"] += launches
            (host,), ev = to_host([all_reduce_sum(sup, self.mesh)])
            sp.set(launches=launches,
                   masks=MM.window_masks.launches - masks0,
                   b1=PS.pair_supports.launches - b1_0)
        return host, ev

    def _materialize(self, m, pm, ref, item, iss, out_slot) -> None:
        """The children's states into their slots, ``chunk`` a launch."""
        dev = self.device
        for lo in range(0, len(ref), self.chunk):
            hi = lo + self.chunk
            self.stats["kernel_launches"] += 1
            c = self._child(m, pm, to_index(ref[lo:hi], dev),
                            to_index(item[lo:hi], dev),
                            torch.from_numpy(iss[lo:hi]).to(dev))
            self.pool.index_copy_(0, to_index(out_slot[lo:hi], dev), c)

    def _recompute(self, items: np.ndarray, iss: np.ndarray,
                   valid: np.ndarray, slots: List[int]) -> None:
        """Rebuild states by folding the extension steps (``[K, n]``
        arrays, one column per node) from the roots, into ``slots``."""
        dev = self.device
        it = to_index(items, dev)
        ss = torch.from_numpy(iss).to(dev)
        vv = torch.from_numpy(valid).to(dev)
        m = self._root_states(it[0])
        for k in range(1, it.shape[0]):
            pm = MS.prev_max(m, self.maxgap)
            occ = MS.expand_bits(self._words.index_select(0, it[k]))
            base = torch.where(ss[k][:, None, None], pm, m)
            nm = torch.where(occ & (base >= 0), base, MS.NONE)
            m = torch.where(vv[k][:, None, None], nm, m)
        self.pool.index_copy_(0, to_index(slots, dev), m)

    def _ensure_slots(self, batch: List[_Node], stack: List[_Node]) -> None:
        """Recompute the states of popped non-root nodes that lost (or
        never had) a slot, ``recompute_chunk`` nodes a launch, reclaiming
        non-root slots from the bottom of the stack when the pool is
        short."""
        missing = [n for n in batch if n.slot is None and len(n.steps) > 1]
        if not missing:
            return
        self.stats["recomputed_nodes"] += len(missing)
        if len(self._pool_alloc) < len(missing):
            self._pool_alloc.reclaim(stack, len(missing),
                                     lambda n: len(n.steps) > 1)
            self.stats["reclaimed_slots"] = self._pool_alloc.reclaimed
        for lo in range(0, len(missing), self.recompute_chunk):
            group = missing[lo: lo + self.recompute_chunk]
            k = max(len(n.steps) for n in group)
            items = np.zeros((k, len(group)), np.int64)
            iss = np.zeros((k, len(group)), bool)
            valid = np.zeros((k, len(group)), bool)
            slots = []
            for col, node in enumerate(group):
                slot = self._pool_alloc.alloc()
                if slot is None:
                    raise RuntimeError(
                        "constrained pool exhausted beyond reclaim")
                node.slot = slot
                slots.append(slot)
                for row, (it, s) in enumerate(node.steps):
                    items[row, col], iss[row, col], valid[row, col] = it, s, True
            self._recompute(items, iss, valid, slots)
            self.stats["kernel_launches"] += 1

    # ---------------------------------------------------------------- mine

    def _pattern_of(self, steps) -> Pattern:
        ids = self.vdb.item_ids
        pat: List[List[int]] = []
        for it, is_s in steps:
            if is_s:
                pat.append([int(ids[it])])
            else:
                pat[-1].append(int(ids[it]))
        return tuple(tuple(s) for s in pat)

    def frontier_fingerprint(self) -> dict:
        """Identity a frontier checkpoint binds to — the reference
        engine's exact fields: (vdb, minsup) plus the constraint set,
        since maxgap/maxwindow/length change enumeration."""
        ids = self.vdb.item_ids
        return {
            "minsup": self.minsup,
            "maxgap": self.maxgap,
            "maxwindow": self.maxwindow,
            "n_items": self.n_items,
            "n_sequences": self.vdb.n_sequences,
            "max_itemsets": self.max_pattern_itemsets,
            "item_ids_head": [int(i) for i in ids[:8]],
            "item_ids_sum": int(ids.astype(np.int64).sum()),
        }

    def frontier_state(self, stack: List[_Node],
                       results: List[PatternResult],
                       results_from: int = 0) -> dict:
        """Snapshot of a paused DFS (see _common.encode_frontier)."""
        return encode_frontier(self.frontier_fingerprint(), stack, results,
                               results_from)

    def mine(self, *, resume: Optional[dict] = None, checkpoint_cb=None,
             checkpoint_every_s: float = 30.0) -> List[PatternResult]:
        """Run the DFS; optionally resumable from either package's
        snapshot, with a ``frontier_state`` snapshot at most every
        ``checkpoint_every_s`` seconds (the in-flight batches drained
        first)."""
        with obs.span("cspade.mine"):
            return self._mine(resume, checkpoint_cb, checkpoint_every_s)

    def _mine(self, resume, checkpoint_cb, checkpoint_every_s):
        minsup = self.minsup
        # a whole state pool for every mine (see SpadeTorch.mine)
        self._pool_alloc = SlotPool(range(self.pool_slots))
        results: List[PatternResult] = []
        root_items = [i for i in range(self.n_items)
                      if int(self.vdb.item_supports[i]) >= minsup]
        stack: List[_Node] = []
        with obs.span("cspade.roots"):
            if resume is not None:
                results, stack = decode_frontier(
                    resume, self.frontier_fingerprint(), _Node)
                self.stats["resumed_nodes"] = len(stack)
            else:
                seed = set(PN.owned_roots(root_items, self.vdb.item_ids,
                                          self._partition))
                for i in reversed(root_items):
                    if i not in seed:
                        continue  # another partition's class slice
                    results.append((self._pattern_of(((i, True),)),
                                    int(self.vdb.item_supports[i])))
                    stack.append(_Node(((i, True),), None, root_items,
                                       [j for j in root_items if j > i]))

        # software-pipelined dispatch/resolve: one support readback per
        # node batch, pipeline_depth batches in flight
        inflight: deque = deque()

        def dispatch():
            with obs.span("cspade.dispatch") as dsp:
                batch = [stack.pop()
                         for _ in range(min(self.node_batch, len(stack)))]
                dsp.set(nodes=len(batch))
                with obs.span("cspade.slots") as sp:
                    before = self.stats["kernel_launches"]
                    self._ensure_slots(batch, stack)
                    sp.set(launches=self.stats["kernel_launches"] - before)
                m, pm = self._prep(batch)

                with obs.span("cspade.candidates"):
                    cand_ref: List[int] = []
                    cand_item: List[int] = []
                    cand_iss: List[bool] = []
                    spans: List[Tuple[int, int, int]] = []
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

                    self.stats["candidates"] += len(cand_ref)
                    n_s = sum(1 for x in cand_iss if x)
                    self.stats["s_candidates"] += n_s
                    self.stats["i_candidates"] += len(cand_iss) - n_s
                    arrays = (np.array(cand_ref, np.int64),
                              np.array(cand_item, np.int64),
                              np.array(cand_iss, bool))
                sup = self._supports(m, pm, *arrays) if cand_ref else None
            return batch, (m, pm), cand_item, cand_iss, spans, sup

        def resolve(entry):
            batch, (m, pm), cand_item, cand_iss, spans, sup = entry
            with obs.span("cspade.resolve", nodes=len(batch)):
                with obs.span("cspade.wait"):
                    if sup is None:
                        sups = np.empty(0, np.int32)
                    else:
                        host, ev = sup
                        if ev is not None:
                            ev.synchronize()
                        sups = host.numpy()

                with obs.span("cspade.prune") as sp:
                    children: List[_Node] = []
                    mat_ref: List[int] = []; mat_item: List[int] = []
                    mat_iss: List[bool] = []; mat_child: List[int] = []
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
                            child_s = s_items if self.maxgap is None else root_items
                            child_itemsets = n_itemsets + (1 if is_s else 0)
                            child_allow_s = (self.max_pattern_itemsets is None
                                             or child_itemsets < self.max_pattern_itemsets)
                            if not ((child_s and child_allow_s) or child_i):
                                continue
                            child = _Node(steps, None, child_s, child_i)
                            slot = self._pool_alloc.alloc()
                            if slot is not None:
                                child.slot = slot
                                mat_ref.append(b_idx); mat_item.append(it)
                                mat_iss.append(is_s); mat_child.append(slot)
                            children.append(child)
                    sp.set(children=len(children))
                with obs.span("cspade.materialize", rows=len(mat_child)) as sp:
                    before = self.stats["kernel_launches"]
                    if mat_child:
                        self._materialize(m, pm, np.array(mat_ref, np.int64),
                                          np.array(mat_item, np.int64),
                                          np.array(mat_iss, bool),
                                          np.array(mat_child, np.int64))
                    sp.set(launches=self.stats["kernel_launches"] - before)
                    stack.extend(reversed(children))
                    for node in batch:
                        if len(node.steps) > 1 and node.slot is not None:
                            self._pool_alloc.free(node.slot)

        ckpt_done = len(results) if resume is not None else 0
        last_ckpt = time.monotonic()
        while stack or inflight:
            while stack and len(inflight) < self.pipeline_depth:
                inflight.append(dispatch())
            resolve(inflight.popleft())
            if checkpoint_due(checkpoint_cb, last_ckpt, checkpoint_every_s,
                              self.mesh):
                while inflight:  # drain for a consistent frontier
                    resolve(inflight.popleft())
                checkpoint_cb(self.frontier_state(stack, results,
                                                  results_from=ckpt_done))
                ckpt_done = len(results)
                self.stats["checkpoints"] = self.stats.get("checkpoints", 0) + 1
                last_ckpt = time.monotonic()

        self.stats["patterns"] = len(results)
        with obs.span("mine.sort", patterns=len(results)):
            return sort_patterns(results)


def mine_cspade_torch(
    db: SequenceDB,
    minsup_abs: int,
    *,
    maxgap: Optional[int] = None,
    maxwindow: Optional[int] = None,
    device: DeviceLike = None,
    mesh=None,
    max_pattern_itemsets: Optional[int] = None,
    stats_out: Optional[dict] = None,
    checkpoint=None,
    partition_parts: int = 0,
    partition_classes: int = 64,
    **kwargs,
) -> List[PatternResult]:
    """DB -> vertical build -> constrained mine, on ``device`` (default
    CUDA; raises without it).  ``checkpoint`` follows ``mine_spade_torch``'s
    load/save/every_s contract (a stale snapshot is ignored and the mine
    restarts fresh).  A ``mesh`` shards the sequence axis over its ranks
    (every rank calls this alike and gets the same result);
    ``partition_parts > 1`` mines ``partition_classes`` equivalence
    classes in that many slices (:func:`_mine_cspade_partitioned`).
    ``kwargs`` go to :class:`ConstrainedSpadeTorch`.  ``stats_out`` gets
    the engine's stats and, under ``geometry`` (unpartitioned mines), the
    dtype, chunk, node batch, pool slots, recompute chunk and pipeline
    depth the mine ran with."""
    dev = engine_device(device, mesh)
    with obs.mine_trace("mine.cspade", minsup=int(minsup_abs), maxgap=maxgap,
                        maxwindow=maxwindow):
        vdb = build_vertical(db, min_item_support=minsup_abs)
        if vdb.n_items == 0:
            return []
        if partition_parts and int(partition_parts) > 1:
            return _mine_cspade_partitioned(
                vdb, minsup_abs, maxgap=maxgap, maxwindow=maxwindow,
                device=dev, mesh=mesh, parts=int(partition_parts),
                classes=int(partition_classes),
                max_pattern_itemsets=max_pattern_itemsets,
                stats_out=stats_out, checkpoint=checkpoint, **kwargs)
        eng = ConstrainedSpadeTorch(vdb, minsup_abs, maxgap=maxgap,
                                    maxwindow=maxwindow, device=dev,
                                    mesh=mesh,
                                    max_pattern_itemsets=max_pattern_itemsets,
                                    **kwargs)
        resume, save_cb, every_s = load_checkpoint(
            checkpoint, eng.frontier_fingerprint())
        results = eng.mine(resume=resume, checkpoint_cb=save_cb,
                           checkpoint_every_s=every_s)
    if stats_out is not None:
        stats_out.update(eng.stats)
        # the geometry the mine ran with (the port's addition)
        stats_out["geometry"] = {
            "dtype": str(eng.dtype).replace("torch.", ""), "chunk": eng.chunk,
            "node_batch": eng.node_batch, "pool_slots": eng.pool_slots,
            "recompute_chunk": eng.recompute_chunk,
            "pipeline_depth": eng.pipeline_depth}
    return results


def _mine_cspade_partitioned(
    vdb: VerticalDB,
    minsup_abs: int,
    *,
    maxgap: Optional[int],
    maxwindow: Optional[int],
    device: DeviceLike,
    mesh,
    parts: int,
    classes: int,
    max_pattern_itemsets: Optional[int],
    stats_out: Optional[dict],
    checkpoint,
    **kwargs,
) -> List[PatternResult]:
    """Equivalence-class partitioned cSPADE (``spade_constrained.
    _mine_cspade_partitioned``): the partitioned SPADE route's independent
    slices, one :class:`ConstrainedSpadeTorch` a slice.  The composite's
    fingerprint is built without an engine (the constructor builds the
    device stores), field for field the engine's."""
    plan = PN.plan_partitions(vdb.item_ids, vdb.item_supports, parts,
                              classes)
    meshes = PN.submeshes(mesh, parts)
    ids = vdb.item_ids
    fingerprint = {
        "minsup": int(minsup_abs),
        "maxgap": maxgap,
        "maxwindow": maxwindow,
        "n_items": int(vdb.n_items),
        "n_sequences": int(vdb.n_sequences),
        "max_itemsets": max_pattern_itemsets,
        "item_ids_head": [int(i) for i in ids[:8]],
        "item_ids_sum": int(ids.astype(np.int64).sum()),
        "partition": plan.fingerprint(),
    }
    resume, save_cb, every_s = load_checkpoint(checkpoint, fingerprint)
    stats: dict = {
        "partition_parts": int(parts),
        "partition_classes": int(classes),
        "partition_imbalance": round(plan.imbalance_ratio, 4),
    }
    PN.count_mine("cspade")

    def mine_part(p, row_mesh, resume_state, part_cb):
        eng = ConstrainedSpadeTorch(
            vdb, minsup_abs, maxgap=maxgap, maxwindow=maxwindow,
            device=device, mesh=row_mesh,
            max_pattern_itemsets=max_pattern_itemsets,
            partition=(plan, p), **kwargs)
        res = eng.mine(resume=resume_state, checkpoint_cb=part_cb,
                       checkpoint_every_s=every_s)
        PN.fold_numeric_stats(stats, eng.stats)
        return PN.encode_patterns(res)

    rows = PN.mine_partitioned_slices(
        plan=plan, meshes=meshes, fingerprint=fingerprint,
        mine_part=mine_part, resume=resume, checkpoint_cb=save_cb,
        stats=stats, mesh=mesh)
    results = sort_patterns(PN.decode_patterns(rows))
    stats["patterns"] = len(results)
    if stats_out is not None:
        stats_out.update(stats)
    return results
