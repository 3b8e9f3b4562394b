"""Incremental sliding-window SPADE — push cost scales with the BATCH —
port of ``spark_fsm_tpu/streaming/incremental.py`` (``sweep_geometry``,
``_TNode``, ``_fold_supports_fn`` as :func:`fold_supports`,
``_BatchTokens``, ``IncrementalWindowMiner``).

SPADE supports are additive over the sequence axis: the support of a
pattern in the window is the sum of its supports in the live micro-batches
(each sequence lives in one batch).  So the miner keeps, on the host, a
pattern tree T = the frequent set F plus its negative border (every
candidate an exact mine would have evaluated), with per-batch support
counts per node.  A push then costs:

- **count the arriving batch only** (device): one level-order sweep of T
  over the batch's bitmap store — the classic engine's steps
  (``_common.prep_rows``, the supports, ``_common.materialize_rows``),
  driven by T's known structure instead of pruning decisions, so no level
  waits for the one before: every copy back is started as its level is
  dispatched, and the host waits once, at the end of the sweep;
- **evict by subtraction** (host): an expired batch's stored supports
  leave each node's running total;
- **border repair** (device, only when a pattern crosses minsup either
  way): candidate lists are recomputed top-down from the new frequent
  sets, and candidates T has never evaluated are counted on every live
  batch by a join-chain fold over that batch's store.

The supports of a level are B1 (``ops/pair_support.batch_supports``: the
pair matrix and the per-candidate extraction) when ``use_kernel`` (the
default on CUDA), else the reference's gather-join, one launch per
``support_chunk`` candidates.  B1 on a CPU tensor runs its plain version;
on a CUDA tensor it launches the kernel or raises.

Differences from the reference, none of them visible in the patterns or
in ``stats``'s counters:
- the stores are written in place (the reference donates them); each
  level's parent rows are copied by ``prep_rows`` before the level writes,
  and the two work regions alternate by depth as in the reference, so
  ``n_rows`` and ``store_cache_bytes`` equal its;
- launches run at their live sizes: the reference's pow2 padding of
  slots, candidates, tokens and the remap exists for XLA's compile cache;
  ``kernel_launches`` still counts the reference's events;
- ``stats`` omits ``shape_key`` and ``sweep_shape_keys`` (the shape
  registry is not ported);
- a sweep whose widest level needs more work rows than the top of the
  ``SWEEP_ROW_BUCKETS`` pow2 buckets a prewarm enumerates is swept in
  pieces, depth first, so its store keeps an enumerated shape key (the
  reference builds the wider store and records a key its prewarm never
  warmed); a sweep that fits runs level by level, launch for launch as
  the reference's.

With a ``mesh`` (``parallel.mesh.SeqMesh``) every rank keeps its block of
each batch's sequence axis: it uploads only the tokens of that block, and
every support vector (the sweep's and the repair folds') is all-reduced
(SUM) before the host reads it, as the reference ``psum``s.  The census,
the tree and every decision are host data, the same on every rank.  The
reference's ``_block_collectives_on_cpu`` works around two collective
programs in flight deadlocking XLA's CPU backend; torch's collectives run
in program order on each rank, so it has no counterpart here.

After every push the frequent set and its supports are byte-identical to
a fresh mine of the window.  Scope: plain SPADE (no maxgap/maxwindow, no
max_pattern_itemsets).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import abs_minsup, build_vertical
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    I_TILE, bucket_seq, device_hbm_budget, engine_device, fold_rows,
    materialize_rows, pad_to_multiple, prep_rows, scatter_tokens_remap,
    shard_tokens, shard_width, to_device, to_host, to_index)
from spark_fsm_tpu_torch.ops import bitops_torch as B
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum, mesh_size
from spark_fsm_tpu_torch.streaming.window import SlidingWindow
from spark_fsm_tpu_torch.utils import shapes
from spark_fsm_tpu_torch.utils.canonical import PatternResult, sort_patterns

Key = Tuple[int, bool]  # (GLOBAL item id, is_s_extension)

# the pow2 work-row buckets a sweep geometry's prewarm lists
# (``utils/shapes.enumerate_shapes``): a sweep never builds a store past
# the top one, so every store it builds has an enumerated shape key
SWEEP_ROW_BUCKETS = shapes.WorkloadSpec.sweep_row_buckets


def sweep_geometry(batch_sequences: int, n_words_raw: int, *,
                   mesh=None, seq_floor: int = 0) -> dict:
    """Device geometry of a batch store: the word axis rounded up to a
    power of two and the sequence axis bucketed (``_common.bucket_seq``)
    from at least ``seq_floor`` sequences, then padded to a multiple of a
    ``mesh``'s rank count.  The reference's Pallas sequence block leaves
    a pow2 bucket as it is on one device, so these equal its numbers; on
    a mesh they equal its XLA path's (B1 needs no sequence block).
    ``seq_floor`` pins small batches up to a declared steady-state
    bucket, as in the reference."""
    n_words = next_pow2(max(1, n_words_raw))
    n_seq = pad_to_multiple(
        bucket_seq(max(int(batch_sequences), int(seq_floor or 0))),
        mesh_size(mesh))
    return {"n_seq": n_seq, "n_words": n_words}


class _TNode:
    """Tracked pattern: frequent node or border leaf.  ``steps`` holds
    GLOBAL item ids (the projection drifts across pushes, so dense
    indices would go stale); ``sup`` maps live batch id -> exact batch
    support; ``total`` is kept equal to ``sum(sup.values())`` over live
    batches incrementally."""

    __slots__ = ("steps", "children", "sup", "total")

    def __init__(self, steps: Tuple[Key, ...]):
        self.steps = steps
        self.children: Dict[Key, "_TNode"] = {}
        self.sup: Dict[int, int] = {}
        self.total = 0


def fold_supports(store: torch.Tensor, items: np.ndarray, iss: np.ndarray,
                  valid: np.ndarray, n_seq: int,
                  n_words: int) -> torch.Tensor:
    """Border-repair evaluator: fold each candidate's join chain from the
    item rows (``_common.fold_rows``: the recompute without the store
    write — repair needs supports, not bitmaps) and count.  ``items``,
    ``iss`` and ``valid`` are ``[K, M]``: M candidates, K steps; a
    column's invalid steps leave its carry as it is.  Returns ``[M]``
    int32 supports."""
    return B.support(fold_rows(store, items, iss, valid, n_seq, n_words))


class _BatchTokens:
    """Per-live-batch device state: the token table (uploaded once when
    the batch arrives, far smaller than the dense store) plus the batch's
    item census.  Bitmap stores are rebuilt from these tokens on demand
    (one scatter on the device) and dropped under memory pressure.  Under
    a ``mesh`` the tokens and the store are this rank's block of the
    sequence axis (``s_local`` wide); the census is the whole batch's."""

    def __init__(self, bid: int, db: SequenceDB, device: torch.device,
                 mesh=None, seq_floor: int = 0):
        self.bid = bid
        self.db = db
        self.device = device
        vdb = build_vertical(db, min_item_support=1)
        self.item_ids = vdb.item_ids                      # ascending
        self.item_counts: Dict[int, int] = {
            int(i): int(s)
            for i, s in zip(vdb.item_ids, vdb.item_supports)}
        self.n_local = vdb.n_items
        g = sweep_geometry(vdb.n_sequences, vdb.n_words, mesh=mesh,
                           seq_floor=seq_floor)
        self.n_words = g["n_words"]
        self.n_seq = g["n_seq"]
        self.s_local = shard_width(self.n_seq, mesh)
        toks = (vdb.tok_item, vdb.tok_seq, vdb.tok_word, vdb.tok_mask)
        if mesh is not None:
            toks = shard_tokens(*toks, self.n_seq, mesh)
        self.ti = to_device(toks[0].astype(np.int64), device)
        self.ts = to_device(toks[1].astype(np.int64), device)
        self.tw = to_device(toks[2].astype(np.int64), device)
        self.tm = to_device(np.ascontiguousarray(toks[3], np.uint32)
                            .view(np.int32), device)
        # projection-dependent state, set by _project and kept across
        # pushes while the frequent projection holds still (steady-state
        # repair then skips every store rebuild)
        self.row_of: Dict[int, int] = {}
        # item rows: n_present live ones, zero pad rows up to ni_rows
        self.n_present = 0
        self.ni_rows = 0
        self.store: Optional[torch.Tensor] = None
        self._proj_key = None
        self._n_rows = 0
        self.last_shape_key: Optional[str] = None

    def item_rows(self, needed: List[int]) -> int:
        """The item rows a projection on ``needed`` gives this batch's
        store: its present items, padded to ``I_TILE``."""
        n = sum(1 for g in needed if g in self.item_counts)
        return pad_to_multiple(max(n, 1), I_TILE)

    def _project(self, needed: List[int], extra_rows: int) -> int:
        """Build (or reuse) this batch's store for the given GLOBAL item
        set + ``extra_rows`` work rows; items absent from the batch get no
        row (their patterns are zero-support here).  Returns its rows."""
        present = [g for g in needed if g in self.item_counts]
        ni_rows = self.item_rows(needed)
        n_rows = next_pow2(ni_rows + extra_rows + 1)
        key = (tuple(present), ni_rows)
        if (self.store is not None and self._proj_key == key
                and self._n_rows >= n_rows):
            return self._n_rows
        self.row_of = {g: r for r, g in enumerate(present)}
        self.n_present = len(present)
        self.ni_rows = ni_rows
        # unneeded items point past the store; the scatter drops them
        remap = np.full(max(self.n_local, 1), n_rows + 1, np.int64)
        idx = np.searchsorted(self.item_ids, present)
        remap[idx] = np.arange(len(present), dtype=np.int64)
        self.store = None   # free the old store before the new one
        self.store = scatter_tokens_remap(
            self.ti, self.ts, self.tw, self.tm,
            to_device(remap, self.device), n_rows, self.s_local,
            self.n_words)
        self._proj_key = key
        self._n_rows = n_rows
        # a store (re)build fixes the sweep geometry: stamp and record it
        self.last_shape_key = shapes.key_sweep(
            self.n_seq, self.n_words, n_rows, ni_rows)
        shapes.record(self.last_shape_key)
        return n_rows

    def store_bytes(self) -> int:
        return (0 if self.store is None
                else self._n_rows * self.n_seq * self.n_words * 4)

    def drop_store(self) -> None:
        self.store = None
        self._proj_key = None
        self._n_rows = 0


class IncrementalWindowMiner:
    """WindowMiner-compatible incremental miner (same push/stats/window
    surface).

    ``min_support`` < 1 is relative to the current window size, >= 1 an
    absolute count.  ``device`` is resolved once (CUDA unless ``"cpu"``).
    ``use_kernel`` ("auto": B1 on CUDA, the gather-join on the CPU; True:
    B1, whose wrapper runs its plain version on CPU tensors; False: the
    gather-join) picks the sweep's supports.  ``repair_chunk`` candidates
    go to a repair fold launch, ``support_chunk`` to a gather-join or
    materialize launch.  ``mesh`` (a ``parallel.mesh.SeqMesh``) shards
    every batch's sequence axis over its ranks; every rank pushes the
    same batches and holds the same patterns.
    """

    def __init__(self, min_support: float, *,
                 max_batches: Optional[int] = None,
                 max_sequences: Optional[int] = None,
                 device: DeviceLike = None,
                 mesh=None,
                 use_kernel="auto",
                 repair_chunk: int = 256,
                 support_chunk: int = 2048,
                 seq_floor: int = 0) -> None:
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        self.min_support = float(min_support)
        self.window = SlidingWindow(max_batches=max_batches,
                                    max_sequences=max_sequences)
        if use_kernel == "auto":
            self.use_kernel = self.device.type == "cuda"
        else:
            self.use_kernel = bool(use_kernel)
        self.repair_chunk = int(repair_chunk)
        self.support_chunk = int(support_chunk)
        # pins every batch store's sequence bucket to at least this many
        # sequences (the declared steady-state batch size)
        self.seq_floor = int(seq_floor or 0)
        self._lock = threading.Lock()
        self._next_bid = 0
        # keyed by id() of the window's PRIVATE copy of each batch —
        # push() shallow-copies every arriving batch, so each live window
        # entry is a distinct object and the ids cannot collide even when
        # a caller pushes the same list twice
        self._states: Dict[int, _BatchTokens] = {}
        self._item_totals: Dict[int, int] = {}       # window item census
        self._root: Dict[Key, _TNode] = {}           # tracked F1 subtrees
        self.patterns: List[PatternResult] = []
        self.stats = {"pushes": 0, "mines": 0, "evicted_batches": 0,
                      "window_sequences": 0, "patterns": 0,
                      "route": "incremental", "tracked_nodes": 0,
                      "border_nodes": 0, "repaired_nodes": 0,
                      "swept_batches": 0, "sweep_candidates": 0,
                      "repair_rounds": 0, "kernel_launches": 0}

    # ------------------------------------------------------------- util

    def minsup_abs(self) -> int:
        if self.min_support >= 1.0:
            return int(self.min_support)
        return abs_minsup(self.min_support, max(1, self.window.n_sequences))

    def _zero_subtree(self, node: _TNode, bid: int) -> None:
        node.sup[bid] = 0
        for child in node.children.values():
            self._zero_subtree(child, bid)

    # ------------------------------------------------------------- push

    def push(self, batch: SequenceDB) -> List[PatternResult]:
        with self._lock:
            t0 = time.monotonic()
            # a shallow copy makes every window entry a distinct object
            # (identity-keyed state) and freezes the counted content
            batch = list(batch)
            self.window.push(batch)
            live = self.window.batches()
            live_ids = {id(b) for b in live}

            # --- evict by subtraction (host only) ---
            evicted = [st for key, st in self._states.items()
                       if key not in live_ids]
            for key in [k for k in self._states if k not in live_ids]:
                del self._states[key]
            if evicted:
                ev_bids = {st.bid for st in evicted}
                for st in evicted:
                    for g, c in st.item_counts.items():
                        left = self._item_totals.get(g, 0) - c
                        if left:
                            self._item_totals[g] = left
                        else:
                            # a rotating item universe must not grow the
                            # census without bound
                            self._item_totals.pop(g, None)
                self._subtract_evicted(ev_bids)

            # --- register unseen batches (the pushed one; after a
            # restored window, every restored batch) ---
            fresh: List[_BatchTokens] = []
            for b in live:
                if id(b) not in self._states:
                    st = _BatchTokens(self._next_bid, b, self.device,
                                      self.mesh, seq_floor=self.seq_floor)
                    self._next_bid += 1
                    self._states[id(b)] = st
                    fresh.append(st)
                    for g, c in st.item_counts.items():
                        self._item_totals[g] = self._item_totals.get(g, 0) + c
            t_tok = time.monotonic()

            minsup = self.minsup_abs()
            f1 = sorted(g for g, c in self._item_totals.items()
                        if c >= minsup)

            # --- count the arriving batch(es): sweep T (pre-repair
            # structure) over each fresh batch ---
            for st in fresh:
                self._sweep(st, f1)
                self.stats["swept_batches"] += 1
            t_sweep = time.monotonic()

            # --- border repair + result collection ---
            self._repair(minsup, f1)
            t_rep = time.monotonic()
            self.patterns = self._collect_and_prune(minsup, f1)
            self.stats["phase_s"] = {
                "tokens": round(t_tok - t0, 3),
                "sweep": round(t_sweep - t_tok, 3),
                "repair": round(t_rep - t_sweep, 3),
                "prune": round(time.monotonic() - t_rep, 3),
            }
            # the freshest batch's store geometry and every live batch's
            live_keys = sorted({st.last_shape_key
                                for st in self._states.values()
                                if st.last_shape_key})
            if fresh and fresh[-1].last_shape_key:
                self.stats["shape_key"] = fresh[-1].last_shape_key
            if live_keys:
                self.stats["sweep_shape_keys"] = live_keys
            self.stats["pushes"] += 1
            self.stats["mines"] += 1
            self.stats["evicted_batches"] = self.window.evicted_batches
            self.stats["window_sequences"] = self.window.n_sequences
            self.stats["patterns"] = len(self.patterns)
            n_nodes = sum(1 for _ in self._iter_nodes())
            self.stats["tracked_nodes"] = n_nodes
            self.stats["border_nodes"] = n_nodes - len(self.patterns)
            self.stats["push_wall_s"] = round(time.monotonic() - t0, 4)
            # keep projected stores warm across pushes under a fifth of
            # device memory; beyond it, drop oldest-batch stores first.
            # A store shards over the mesh, so a device holds 1/N of it
            budget = 0.2 * device_hbm_budget(self.device)
            n_sh = mesh_size(self.mesh)
            total = sum(st.store_bytes() for st in self._states.values()
                        ) // n_sh
            for b in live:  # oldest first
                if total <= budget:
                    break
                st = self._states[id(b)]
                total -= st.store_bytes() // n_sh
                st.drop_store()
            self.stats["store_cache_bytes"] = int(
                sum(st.store_bytes() for st in self._states.values()))
            return self.patterns

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _subtract_evicted(self, ev_bids) -> None:
        for node in self._iter_nodes():
            for bid in ev_bids:
                node.total -= node.sup.pop(bid, 0)

    # ------------------------------------------------------------ sweep

    def _sweep(self, st: _BatchTokens, f1: List[int]) -> None:
        """Fill ``node.sup[st.bid]`` for every tracked node by walking
        T's levels over the batch store: :meth:`_sweep_dispatch`, then
        one wait and the host's reads (:meth:`_resolve`)."""
        self._resolve(st.bid, *self._sweep_dispatch(st, f1))

    def _sweep_dispatch(self, st: _BatchTokens, f1: List[int]):
        """Dispatch every level of the sweep without a host sync: no
        pruning happens here, so no level needs the previous level's
        supports.  Each level's supports start their copy to pinned host
        memory as they are dispatched.  Returns ``(pending, event)``: the
        ``(host supports, nodes)`` pairs and the last copy's event (None
        on the CPU)."""
        bid = st.bid
        # depth-1 supports come from the batch census (host)
        for (g, _), node in self._root.items():
            c = st.item_counts.get(g, 0)
            node.sup[bid] = c
            node.total += c

        # parents per level = tracked nodes with tracked children
        lcap = 0
        lvl_nodes = [n for n in self._root.values() if n.children]
        probe = lvl_nodes
        while probe:
            lcap = max(lcap, len(probe))
            probe = [c for n in probe for c in n.children.values()
                     if c.children]
        # two work regions of one level's parents each; a level wider than
        # the top prewarmed row bucket allows is swept in pieces
        width = max(lcap, 1)
        ni_rows = st.item_rows(f1)
        top = next_pow2(ni_rows + 1) << (SWEEP_ROW_BUCKETS - 1)
        if ni_rows + 2 * width + 1 > top:
            width = (top - ni_rows - 1) // 2
        st._project(f1, 2 * width)
        region = [st.ni_rows, st.ni_rows + width]

        cur: List[Tuple[_TNode, int]] = []
        for node in lvl_nodes:
            g = node.steps[0][0]
            row = st.row_of.get(g)
            if row is None:  # item absent from this batch: subtree is 0
                for c in node.children.values():
                    self._zero_subtree(c, bid)
            else:
                cur.append((node, row))

        pend: List[Tuple[torch.Tensor, List[_TNode]]] = []
        event = None

        def descend(cur: List[Tuple[_TNode, int]], depth: int) -> None:
            """Count the children of ``cur`` (parents at store rows), then
            materialize the children that are parents themselves into this
            depth's work region, ``width`` at a time, and descend into each
            piece.  ``pt`` holds copies of the parents' rows, so a deeper
            level may reuse their region, and a level that fits one piece
            is swept level by level, as the reference sweeps it."""
            nonlocal event
            pt = prep_rows(st.store, [slot for _, slot in cur], st.s_local,
                           st.n_words)
            self.stats["kernel_launches"] += 1

            refs: List[int] = []
            items: List[int] = []
            iss: List[bool] = []
            meta: List[_TNode] = []
            kids: List[Tuple[int, int, bool, _TNode]] = []
            for b, (node, _) in enumerate(cur):
                for (g, s), child in node.children.items():
                    jrow = st.row_of.get(g)
                    if jrow is None:
                        self._zero_subtree(child, bid)
                        continue
                    refs.append(b)
                    items.append(jrow)
                    iss.append(s)
                    meta.append(child)
                    if child.children:
                        kids.append((b, jrow, s, child))
            if refs:
                for host, ev, sub in self._supports_dispatch(
                        st, pt, np.asarray(refs, np.int64),
                        np.asarray(items, np.int64),
                        np.asarray(iss, np.int64), meta):
                    pend.append((host, sub))
                    event = ev if ev is not None else event
                self.stats["sweep_candidates"] += len(refs)
            out_base = region[depth % 2]
            for lo in range(0, len(kids), width):
                piece = kids[lo:lo + width]
                # writes land in this depth's work region, never in the
                # item rows
                m = np.asarray([(b, j, s, out_base + i)
                                for i, (b, j, s, _) in enumerate(piece)],
                               np.int64)
                self.stats["kernel_launches"] += materialize_rows(
                    st.store, pt, m[:, 0], m[:, 1], m[:, 2], m[:, 3],
                    self.support_chunk)
                descend([(c, out_base + i)
                         for i, (*_, c) in enumerate(piece)], depth + 1)

        if cur:
            descend(cur, 0)
        return pend, event

    @staticmethod
    def _resolve(bid: int, pend, event) -> None:
        """Wait once for the last copy (one stream: every earlier copy
        ran before it), then add each node's batch support."""
        if event is not None:
            event.synchronize()
        for host, meta in pend:
            sups = host.numpy()
            for i, child in enumerate(meta):
                s = int(sups[i])
                child.sup[bid] = s
                child.total += s

    def _supports_dispatch(self, st: _BatchTokens, pt: torch.Tensor,
                           refs: np.ndarray, items: np.ndarray,
                           iss: np.ndarray, meta):
        """Support vectors for a candidate list: B1's pair matrix with the
        per-candidate extraction on the device (one launch), or the
        gather-join, one launch per ``support_chunk`` candidates; on a
        mesh each vector is all-reduced.  Each vector starts its copy to
        the host; yields ``(host tensor, event_or_None, meta slice)``
        triples."""
        dev = self.device
        if self.use_kernel:
            sup = all_reduce_sum(
                PS.batch_supports(pt, st.store, st.ni_rows,
                                  to_index(2 * refs + iss, dev),
                                  to_index(items, dev), n_words=st.n_words,
                                  n_live=st.n_present),
                self.mesh)
            self.stats["kernel_launches"] += 1
            (host,), ev = to_host([sup])
            return [(host, ev, meta)]
        out = []
        c = self.support_chunk
        for lo in range(0, len(refs), c):
            hi = min(lo + c, len(refs))
            rows = (pt.index_select(0, to_index(2 * refs[lo:hi] + iss[lo:hi],
                                                dev))
                    & st.store.index_select(0, to_index(items[lo:hi], dev)))
            sup = all_reduce_sum(
                B.support(rows.view(hi - lo, st.s_local, st.n_words)),
                self.mesh)
            (host,), ev = to_host([sup])
            out.append((host, ev, meta[lo:hi]))
            self.stats["kernel_launches"] += 1
        return out

    # ----------------------------------------------------------- repair

    def _walk_candidates(self, minsup: int, f1: List[int], missing) -> None:
        """Top-down recompute of candidate lists from CURRENT frequent
        sets (the classic engine's resolve rules); collect candidates T
        has never evaluated into ``missing``."""

        def walk(node: _TNode, s_list: List[int], i_list: List[int]):
            for j in s_list:
                if (j, True) not in node.children:
                    missing.append((node, (j, True)))
            for j in i_list:
                if (j, False) not in node.children:
                    missing.append((node, (j, False)))
            s_items = [j for j in s_list
                       if node.children.get((j, True)) is not None
                       and node.children[(j, True)].total >= minsup]
            i_items = [j for j in i_list
                       if node.children.get((j, False)) is not None
                       and node.children[(j, False)].total >= minsup]
            for j in s_items:
                walk(node.children[(j, True)], s_items,
                     [x for x in s_items if x > j])
            for j in i_items:
                walk(node.children[(j, False)], s_items,
                     [x for x in i_items if x > j])

        for i in f1:
            node = self._root.get((i, True))
            if node is None:
                # newly frequent item: its root node from the batch
                # censuses (host data, no device work)
                node = _TNode(((i, True),))
                for st in self._states.values():
                    node.sup[st.bid] = st.item_counts.get(i, 0)
                node.total = self._item_totals.get(i, 0)
                self._root[(i, True)] = node
            walk(node, f1, [x for x in f1 if x > i])

    def _repair(self, minsup: int, f1: List[int]) -> None:
        rounds = 0
        while True:
            missing: List[Tuple[_TNode, Key]] = []
            self._walk_candidates(minsup, f1, missing)
            if not missing:
                break
            rounds += 1
            self._evaluate_missing(missing, f1)
            self.stats["repaired_nodes"] += len(missing)
        self.stats["repair_rounds"] += rounds

    def _evaluate_missing(self, missing, f1: List[int]) -> None:
        """Count never-evaluated candidates on EVERY live batch (the fold
        evaluator); insert them as tracked children.  Every (batch,
        chunk) fold is dispatched first, then the host waits once."""
        children: List[_TNode] = []
        for parent, key in missing:
            child = _TNode(parent.steps + (key,))
            parent.children[key] = child
            children.append(child)

        pend = []
        event = None
        for st in self._states.values():
            # every candidate/step item is window-frequent (downward
            # closure), so the f1 projection serves all repair rounds;
            # a cached store from an older projection is never reused
            st._project(f1, 0)
            todo: List[Tuple[int, List[Tuple[int, bool]]]] = []
            for ci, child in enumerate(children):
                rows = [(st.row_of.get(g), s) for g, s in child.steps]
                if any(r is None for r, _ in rows):
                    child.sup[st.bid] = 0  # an item absent from batch
                    continue
                todo.append((ci, rows))
            m = self.repair_chunk
            for lo in range(0, len(todo), m):
                grp = todo[lo:lo + m]
                k = max(len(r) for _, r in grp)
                it = np.zeros((k, len(grp)), np.int64)
                ss = np.zeros((k, len(grp)), bool)
                va = np.zeros((k, len(grp)), bool)
                for col, (_, rows) in enumerate(grp):
                    for row_i, (r, s) in enumerate(rows):
                        it[row_i, col] = r
                        ss[row_i, col] = s
                        va[row_i, col] = True
                sup = all_reduce_sum(
                    fold_supports(st.store, it, ss, va, st.s_local,
                                  st.n_words), self.mesh)
                self.stats["kernel_launches"] += 1
                (host,), ev = to_host([sup])
                event = ev if ev is not None else event
                pend.append((host, st.bid, grp))
        if event is not None:
            event.synchronize()
        for host, bid, grp in pend:
            sups = host.numpy()
            for col, (ci, _) in enumerate(grp):
                children[ci].sup[bid] = int(sups[col])
        for child in children:
            child.total = sum(child.sup.values())

    # ---------------------------------------------------- prune/collect

    def _collect_and_prune(self, minsup: int,
                           f1: List[int]) -> List[PatternResult]:
        """Final walk: collect the frequent set and prune T down to F plus
        its CURRENT negative border, so tracked state cannot grow
        monotonically."""
        results: List[PatternResult] = []

        def pattern_of(steps: Tuple[Key, ...]):
            pat: List[List[int]] = []
            for g, s in steps:
                if s:
                    pat.append([g])
                else:
                    pat[-1].append(g)
            return tuple(tuple(p) for p in pat)

        def walk(node: _TNode, s_list: List[int], i_list: List[int]):
            keep: Dict[Key, _TNode] = {}
            s_items = [j for j in s_list
                       if (c := node.children.get((j, True))) is not None
                       and c.total >= minsup]
            i_items = [j for j in i_list
                       if (c := node.children.get((j, False))) is not None
                       and c.total >= minsup]
            for j in s_list:
                c = node.children.get((j, True))
                if c is not None:
                    keep[(j, True)] = c
            for j in i_list:
                c = node.children.get((j, False))
                if c is not None:
                    keep[(j, False)] = c
            # drop stale children outside the current candidate lists
            # AND the whole subtree of any non-frequent child (border
            # nodes are leaves)
            node.children = keep
            for c in keep.values():
                if c.total < minsup:
                    c.children = {}
            for j in s_items:
                c = node.children[(j, True)]
                results.append((pattern_of(c.steps), c.total))
                walk(c, s_items, [x for x in s_items if x > j])
            for j in i_items:
                c = node.children[(j, False)]
                results.append((pattern_of(c.steps), c.total))
                walk(c, s_items, [x for x in i_items if x > j])

        f1_set = set(f1)
        for key in list(self._root):
            if key[0] not in f1_set:
                # the item fell below minsup: its whole subtree is
                # infrequent by downward closure
                del self._root[key]
        for i in f1:
            node = self._root[(i, True)]
            results.append((pattern_of(node.steps), node.total))
            walk(node, f1, [x for x in f1 if x > i])
        return sort_patterns(results)
