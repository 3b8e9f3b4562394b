"""SPAM vertical-bitmap miner on a CUDA device — port of
``spark_fsm_tpu/models/spam_bitmap.py`` (``spam_geometry``,
``SpamBitmapTPU`` as :class:`SpamBitmapTorch`, ``mine_spam_cpu``, and
``mine_spam_tpu`` as :func:`mine_spam_torch`).

The second mining engine beside SPADE's classic one: the same pattern
universe, enumeration, frontier node and checkpoint format, another way
to evaluate candidates.  Each popped batch of nodes is evaluated against
the whole (dense) item axis in one fixed-shape wave — kernel B3, which
joins, counts, thresholds and packs a survivor mask in one pass
(``ops/spam_bitops.wave_extend_prune``) — and the host reads only the
lanes its candidate lists name.  The planner (``service/planner.py``)
splits the items by density: dense items are wave lanes, sparse items are
evaluated as explicit (parent row, item row) pairs (the hybrid store), and
from ``diffset_depth`` on, supports take the dEclat diffset spelling (an
exact identity).

- Output is byte-identical to the CPU oracle (``models/oracle``), and
  ``frontier_fingerprint`` equals :class:`~models.spade.SpadeTorch`'s and
  the reference engines', so a checkpoint of any of them resumes in any.
- The batch prep, the materialize of surviving children and the
  recompute of evicted bitmaps are the classic engine's
  (``models/_common``).
- ``pipeline_depth`` waves are in flight; each wave's outputs go to pinned
  host tensors with non-blocking copies behind one recorded CUDA event.

``shape_buckets`` buckets the sequence axis and the store's rows as the
reference does (:func:`spam_geometry`).  With a ``mesh`` every rank runs
the DFS over its block of the sequence axis: the wave is B1 on the shard,
the all-reduce and the threshold and pack as torch ops
(``spam_bitops.wave_prune_sharded``: B3 never runs on a mesh), the
sparse half all-reduces before its threshold, and prep, materialize and
recompute stay local.  ``partition_parts > 1`` mines equivalence-class
slices as the partitioned SPADE route does (:func:`_mine_spam_partitioned`).
Not ported: the service planes the reference's dispatch calls (fusion,
usage, cost-model observation, job control, shape records: ROADMAP Queue A
item 13).
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import (
    VerticalDB, build_vertical, idlist_join_support)
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    FrontierNode, SlotPool, auto_pool_bytes, bucket_store_rows,
    checkpoint_due, decode_frontier, device_axes, encode_frontier,
    engine_device, ensure_slots, frontier_fingerprint, key_seq,
    load_checkpoint, materialize_rows, prep_rows, scatter_build_store,
    shard_width, to_host, to_index)
from spark_fsm_tpu_torch.ops import bitops_np as BN
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.ops import spam_bitops as SB
from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import mesh_size
from spark_fsm_tpu_torch.service import fusion, planner, usage
from spark_fsm_tpu_torch.utils import jobctl, obs, shapes
from spark_fsm_tpu_torch.utils.canonical import Pattern, PatternResult, sort_patterns

Step = Tuple[int, bool]
_Node = FrontierNode


def spam_geometry(n_sequences: int, n_items: int, n_words: int, *,
                  device: Optional[torch.device] = None, mesh=None,
                  node_batch: int = 64,
                  pipeline_depth: int = 2,
                  pool_bytes: Optional[int] = None,
                  shape_buckets: bool = False) -> dict:
    """Derived device geometry of a :class:`SpamBitmapTorch`; pure host
    arithmetic, the reference's formula.  ``device`` sizes the default
    pool budget and may be None only when ``pool_bytes`` is given.

    Beyond the classic engine's slot arithmetic, the node batch is bounded
    so that the in-flight waves' ``[2*nb, ITEM_TILE, S, W]`` temporaries
    (the plain spelling's) fit a quarter of the pool budget.
    ``shape_buckets`` buckets the sequence axis and rounds the store's
    rows (padded items, pool and the reference's unused scratch row) to a
    power of two (``_common.bucket_store_rows``).  With a ``mesh`` the
    sequence axis is the reference's for that many shards and the wave
    temporaries are one shard's.

    ``key_seq``/``key_rows`` are the reference's sequence axis
    (``_common.key_seq``) and store rows (its scratch row counted), which
    its ``spam:`` keys spell; ``shape_key`` is the pure-bitmap plan's."""
    n_seq = device_axes(n_sequences, shape_buckets, mesh)
    if pool_bytes is None:
        pool_bytes = auto_pool_bytes(device)
    ni_pad = SB.pad_items(n_items)
    # the budget judges the reference's sequence axis (no tile pad), so
    # the pool equals its
    ks = key_seq(n_sequences, shape_buckets, mesh)
    slot_bytes = ks * n_words * 4
    spd = -(-slot_bytes // mesh_size(mesh))  # one device's bytes of a row
    budget_slots = max(64, min(int(pool_bytes) // max(slot_bytes, 1), 32768))
    d = max(1, min(int(pipeline_depth), max(1, budget_slots // 8)))
    nb_wave = max(1, (int(pool_bytes) // 4)
                  // max(1, 2 * SB.ITEM_TILE * spd * d))
    nb = max(1, min(int(node_batch), nb_wave, budget_slots // (3 * (d + 2))))
    pool_slots = max(8, budget_slots - 2 * d * nb)
    total = ni_pad + pool_slots
    if shape_buckets:
        total, pool_slots, nb = bucket_store_rows(
            total + 1, ni_pad, budget_slots, nb, d)
    kr = ni_pad + pool_slots + 1
    return {
        "n_seq": n_seq, "ni_pad": ni_pad, "node_batch": nb,
        "pipeline_depth": d, "pool_slots": pool_slots,
        "total_rows": total, "tile": SB.ITEM_TILE,
        # sparse-candidate pair-launch width (hybrid store)
        "chunk": min(2048, max(64, next_pow2(2 * nb))),
        "key_seq": ks, "key_rows": kr,
        "shape_key": shapes.key_spam(ks, n_words, kr, nb, ni_pad),
    }


class SpamBitmapTorch:
    """Single-device or sequence-sharded SPAM miner over the shared
    bitmap store.

    Args:
      vdb: vertical DB (build with ``min_item_support=minsup_abs``).
      minsup_abs: absolute minimum sequence support.
      device: ``None`` (= CUDA, raising without it) or ``"cpu"``.
      mesh: optional ``parallel.mesh.SeqMesh`` (this rank's block of the
        sequence axis, on the mesh's device).
      node_batch: DFS nodes per wave (each pays the whole item axis).
      pipeline_depth: waves in flight at once.
      pool_bytes: device memory budget for the pattern-bitmap pool.
      max_pattern_itemsets: optional cap on pattern length in itemsets.
      representation: ``"auto"`` (density-routed), ``"bitmap"`` or
        ``"idlist"``; None takes the planner's default.
      density_crossover, diffset_depth: the planner's knobs; None takes
        its defaults (0 disables the diffset spelling).
      shape_buckets: bucketed geometry (:func:`spam_geometry`).
    """

    def __init__(
        self,
        vdb: VerticalDB,
        minsup_abs: int,
        *,
        device: DeviceLike = None,
        mesh=None,
        node_batch: int = 64,
        pipeline_depth: int = 2,
        pool_bytes: Optional[int] = None,
        max_pattern_itemsets: Optional[int] = None,
        representation: Optional[str] = None,
        density_crossover: Optional[float] = None,
        diffset_depth: Optional[int] = None,
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
        self.rep_plan, self.diffset_depth = planner.choose_representation(
            vdb.item_supports, vdb.n_sequences, pin=representation,
            crossover=density_crossover, diffset_depth=diffset_depth)
        self._hybrid = self.rep_plan.n_sparse > 0

        g = spam_geometry(
            vdb.n_sequences, n_items, n_words, device=self.device, mesh=mesh,
            node_batch=node_batch, pipeline_depth=pipeline_depth,
            pool_bytes=pool_bytes, shape_buckets=shape_buckets)
        self.n_items, self.n_seq, self.n_words = n_items, g["n_seq"], n_words
        self.s_local = shard_width(self.n_seq, mesh)
        self.ni_pad = g["ni_pad"]
        self.node_batch = g["node_batch"]
        self.pipeline_depth = g["pipeline_depth"]
        self.pool_slots = g["pool_slots"]
        self.chunk = g["chunk"]

        # pool slots start at ni_pad, not n_items: rows n_items..ni_pad-1
        # are the all-zero item pad rows the wave ANDs against
        self.store = scatter_build_store(vdb, g["total_rows"], self.n_seq,
                                         n_words, self.device, mesh)
        self._pool = SlotPool(range(self.ni_pad, self.ni_pad + self.pool_slots))

        # hybrid split: dense items are wave lanes in a compact gathered
        # block (the wave axis shrinks from ni_pad to nd_pad); sparse items
        # ride pair launches.  On the pure-bitmap plan the wave runs over
        # the store's item rows and nd_pad == ni_pad.
        dense_idx = np.flatnonzero(self.rep_plan.rep[:n_items])
        self.n_dense = int(dense_idx.size)
        self._dense_col = np.full(max(n_items, 1), -1, np.int32)
        self._dense_col[dense_idx] = np.arange(self.n_dense, dtype=np.int32)
        if self._hybrid:
            self.nd_pad = SB.pad_items(self.n_dense) if self.n_dense else 0
        else:
            self.nd_pad = self.ni_pad
        self._items = self.store
        if self._hybrid and self.n_dense:
            rows = np.full(self.nd_pad, -1, np.int64)
            rows[: self.n_dense] = dense_idx
            self._items = SB.gather_rows(self.store, to_index(rows, self.device))

        self._key_seq = g["key_seq"]
        if self._hybrid:
            shape_key = shapes.key_spam_hybrid(
                g["key_seq"], n_words, g["key_rows"], self.node_batch,
                self.ni_pad, self.nd_pad)
        else:
            shape_key = g["shape_key"]
        self.stats = {
            "engine": "spam",
            "candidates": 0, "evaluated_lanes": 0, "waves": 0,
            "kernel_launches": 0, "recomputed_nodes": 0,
            "reclaimed_slots": 0, "patterns": 0,
            "shape_key": shape_key,
            "representation": self.rep_plan.pin,
            "rep_dense": self.n_dense,
            "rep_idlist": int(self.rep_plan.n_sparse),
            "diffset_depth": int(self.diffset_depth),
            "diffset_nodes": 0, "pair_launches": 0, "wave_survivors": 0,
        }
        shapes.record(shape_key)

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

    def _allow_s(self, node: _Node) -> bool:
        if self.max_pattern_itemsets is None:
            return True
        return sum(1 for _, s in node.steps if s) < self.max_pattern_itemsets

    def _dispatch(self, stack: List[_Node]):
        """Pop a node batch and launch one fused extension-count-prune wave
        for the whole (nodes x dense items x {s, i}) grid, plus, on a
        hybrid plan, pair launches for the sparse-item candidates; start
        the copies to the host."""
        # launch-boundary safe point (cancel/deadline)
        jobctl.check_shared(self.mesh)
        pairs0 = self.stats["pair_launches"]
        batch = [stack.pop() for _ in range(min(self.node_batch, len(stack)))]
        ensure_slots(self.store, self._pool, batch, stack,
                     first_pool_slot=self.ni_pad,
                     group=max(16, self.node_batch), n_seq=self.s_local,
                     n_words=self.n_words, stats=self.stats)
        pt = prep_rows(self.store, [n.slot for n in batch], self.s_local,
                       self.n_words)
        self.stats["kernel_launches"] += 1
        # per-row dEclat flags: a node at or past the diffset depth counts
        # both its rows (plain 2b, transformed 2b+1) as support(parent row)
        # - |diffset|; an exact identity, read by the plain spelling only
        dd = self.diffset_depth
        ud_rows = np.zeros(2 * len(batch), bool)
        for b, node in enumerate(batch):
            if dd and len(node.steps) >= dd:
                ud_rows[2 * b] = ud_rows[2 * b + 1] = True
                self.stats["diffset_nodes"] += 1
        sup = mask = None
        if self.nd_pad:
            # the wave's item rows past the real items are all zero: the
            # store's pad rows (pure bitmap) or the gather's -1 rows (hybrid)
            n_live = self.n_dense if self._hybrid else self.n_items
            # every device wave routes through the fusion broker's
            # accounting and fault surface (one global read when it is off)
            if self.mesh is None:
                sup, mask = fusion.dispatch_wave(
                    "spam", lambda: SB.wave_extend_prune(
                        pt, self._items, self.minsup,
                        torch.from_numpy(ud_rows), n_words=self.n_words,
                        nd_pad=self.nd_pad, n_live=n_live),
                    nodes=len(batch), items=self.nd_pad)
            else:
                sup, mask = fusion.dispatch_wave(
                    "spam", lambda: SB.wave_prune_sharded(
                        pt, self._items, self.minsup, n_words=self.n_words,
                        nd_pad=self.nd_pad, mesh=self.mesh, n_live=n_live),
                    nodes=len(batch), items=self.nd_pad)
            self.stats["kernel_launches"] += 1
            self.stats["waves"] += 1
            self.stats["evaluated_lanes"] += 2 * self.node_batch * self.nd_pad
        # sparse half of the hybrid store: candidates whose item is an
        # id-list never bought a wave lane; they go in pow2-wide pair
        # launches of at most `chunk` lanes
        pair = None
        pair_pos = {}
        pair_lanes = 0
        if self._hybrid:
            pref_l: List[int] = []
            item_l: List[int] = []
            ud_l: List[bool] = []
            for b, node in enumerate(batch):
                node_ud = bool(dd and len(node.steps) >= dd)
                if self._allow_s(node):
                    for i in node.s_list:
                        if self._dense_col[i] < 0:
                            pair_pos[(2 * b + 1, i)] = len(pref_l)
                            pref_l.append(2 * b + 1)
                            item_l.append(i)
                            ud_l.append(node_ud)
                for i in node.i_list:
                    if self._dense_col[i] < 0:
                        pair_pos[(2 * b, i)] = len(pref_l)
                        pref_l.append(2 * b)
                        item_l.append(i)
                        ud_l.append(node_ud)
            outs = []
            c = self.chunk
            for lo in range(0, len(pref_l), c):
                hi = min(lo + c, len(pref_l))
                w = max(64, next_pow2(hi - lo))
                pref = np.zeros(w, np.int64)
                pref[: hi - lo] = pref_l[lo:hi]
                item = np.full(w, -1, np.int64)
                item[: hi - lo] = item_l[lo:hi]
                ud = np.zeros(w, bool)
                ud[: hi - lo] = ud_l[lo:hi]
                out = fusion.dispatch_wave(
                    "spam",
                    lambda p=pref, it=item, u=ud: SB.pair_prune(
                        pt, self.store, to_index(p, self.device),
                        to_index(it, self.device), self.minsup,
                        torch.from_numpy(u).to(self.device), self.n_words,
                        self.mesh),
                    nodes=len(batch), items=w)
                shapes.record(shapes.key_spam_pair(self._key_seq,
                                                   self.n_words, w))
                outs.append(out[: hi - lo])
                pair_lanes += w
                self.stats["kernel_launches"] += 1
                self.stats["pair_launches"] += 1
                self.stats["evaluated_lanes"] += w
            if outs:
                pair = torch.cat(outs)
        self.stats["candidates"] += sum(
            (len(n.s_list) if self._allow_s(n) else 0) + len(n.i_list)
            for n in batch)
        host, ev = to_host([sup, mask, pair])
        # dispatch-cost stamp for attribution at resolve time: launches
        # and lane traffic this wave bought, the cost model's estimate for
        # them, and the dispatch instant
        launches = ((1 if sup is not None else 0)
                    + self.stats["pair_launches"] - pairs0)
        lanes = (2 * self.node_batch * self.nd_pad if sup is not None
                 else 0) + pair_lanes
        est_s = (RB.estimate_seconds(lanes, max(1, launches), self.n_seq,
                                     self.n_words) if launches else 0.0)
        return (batch, pt, pair_pos, host, ev,
                (launches, lanes, est_s, time.monotonic()))

    def _resolve(self, inflight, stack: List[_Node],
                 results: List[PatternResult]) -> None:
        """Wait for a wave's outputs; read the candidates' lanes, emit the
        survivors, materialize their children and push them."""
        batch, pt, pair_pos, (sup, mask, pair), ev, cost = inflight
        if ev is not None:
            ev.synchronize()
        sups = sup.numpy() if sup is not None else None  # [2*len(batch), nd_pad]
        pair_sups = pair.numpy() if pair is not None else None
        launches, lanes, est_s, t0 = cost
        if launches:
            measured_s = time.monotonic() - t0
            # spam residuals feed the spam family gauge only
            obs.observe_costmodel_family("spam", est_s, measured_s)
            if usage.get() is not None:
                ctl = jobctl.current()
                if ctl is not None:
                    nbytes = ((sups.nbytes if sups is not None else 0)
                              + (pair_sups.nbytes
                                 if pair_sups is not None else 0))
                    usage.deposit(ctl.uid, launches=launches,
                                  traffic_units=lanes, seconds_est=est_s,
                                  seconds_measured=measured_s,
                                  readback_bytes=int(nbytes))
        if mask is not None:
            self.stats["wave_survivors"] += int(
                BN.popcount(mask.numpy().view(np.uint32)).sum())
        col = self._dense_col

        def sup_at(r: int, i: int) -> int:
            # the exact count where >= threshold and exactly 0 otherwise,
            # so the >= thr tests below read as on unpruned counts
            ci = col[i]
            if ci >= 0:
                return int(sups[r, ci])
            return int(pair_sups[pair_pos[(r, i)]])

        thr = self.minsup
        children: List[_Node] = []
        mat_ref: List[int] = []; mat_item: List[int] = []
        mat_iss: List[int] = []; mat_child: List[int] = []
        for b, node in enumerate(batch):
            allow_s = self._allow_s(node)
            n_itemsets = sum(1 for _, s in node.steps if s)
            # only the lanes the candidate lists name are read
            s_items = ([i for i in node.s_list if sup_at(2 * b + 1, i) >= thr]
                       if allow_s else [])
            i_items = [i for i in node.i_list if sup_at(2 * b, i) >= thr]
            for it, is_s in ([(i, True) for i in s_items]
                             + [(i, False) for i in i_items]):
                sup_v = sup_at(2 * b + 1, it) if is_s else sup_at(2 * b, it)
                steps = node.steps + ((it, is_s),)
                results.append((self._pattern_of(steps), sup_v))
                src = s_items if is_s else i_items
                child_i = [j for j in src if j > it]
                child_itemsets = n_itemsets + (1 if is_s else 0)
                child_allow_s = (self.max_pattern_itemsets is None
                                 or child_itemsets < self.max_pattern_itemsets)
                if not ((s_items and child_allow_s) or child_i):
                    continue
                child = _Node(steps, None, s_items, child_i)
                slot = self._pool.alloc()
                if slot is not None:
                    child.slot = slot
                    mat_ref.append(b); mat_item.append(it)
                    mat_iss.append(int(is_s)); mat_child.append(slot)
                children.append(child)
        if mat_child:
            self.stats["kernel_launches"] += materialize_rows(
                self.store, pt, np.array(mat_ref, np.int64),
                np.array(mat_item, np.int64), np.array(mat_iss, np.int64),
                np.array(mat_child, np.int64), self.chunk)
        stack.extend(reversed(children))
        for node in batch:
            if node.slot is not None and node.slot >= self.ni_pad:
                self._pool.free(node.slot)

    def frontier_fingerprint(self) -> dict:
        """Field for field the classic engine's (and the reference
        engines'): the engines' checkpoints resume each other."""
        return frontier_fingerprint(self.vdb, self.minsup,
                                    self.max_pattern_itemsets)

    def frontier_state(self, stack: List[_Node],
                       results: List[PatternResult],
                       results_from: int = 0) -> dict:
        return encode_frontier(self.frontier_fingerprint(), stack, results,
                               results_from)

    def mine(self, *, resume: Optional[dict] = None,
             checkpoint_cb=None,
             checkpoint_every_s: float = 30.0) -> List[PatternResult]:
        """Run the DFS; optionally resumable (see ``SpadeTorch.mine``)."""
        stack: List[_Node] = []
        results: List[PatternResult]
        if resume is not None:
            results, stack = decode_frontier(
                resume, self.frontier_fingerprint(), _Node)
            self.stats["resumed_nodes"] = len(stack)
        else:
            results = []
            root_items = [i for i in range(self.n_items)
                          if int(self.vdb.item_supports[i]) >= self.minsup]
            seed = set(PN.owned_roots(root_items, self.vdb.item_ids,
                                      self._partition))
            for i in reversed(root_items):
                if i not in seed:
                    continue  # another partition's class slice
                results.append((self._pattern_of(((i, True),)),
                                int(self.vdb.item_supports[i])))
                stack.append(_Node(((i, True),), i, root_items,
                                   [j for j in root_items if j > i]))

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
        return sort_patterns(results)


# ---------------------------------------------------------------------------
# CPU reference (the SPAM plugin's engine; numpy popcount formulation)
# ---------------------------------------------------------------------------


def mine_spam_cpu(db: SequenceDB, minsup_abs: int, *,
                  max_pattern_itemsets: Optional[int] = None,
                  stats_out: Optional[dict] = None,
                  representation: Optional[str] = None,
                  density_crossover: Optional[float] = None,
                  diffset_depth: Optional[int] = None) -> List[PatternResult]:
    """Host SPAM miner on the dense numpy bitmaps with the popcount support
    spelling (``bitops_np.support_popcount``), the planner's per-item
    bitmap/id-list split (sparse candidates count through
    ``vertical.idlist_join_support``) and depth-selected diffset supports:
    three exact spellings of one count, so its output is byte-identical to
    the oracle's under any plan.  Independent of torch."""
    vdb = build_vertical(db, min_item_support=minsup_abs)
    if vdb.n_items == 0:
        return []
    plan, dd = planner.choose_representation(
        vdb.item_supports, vdb.n_sequences, pin=representation,
        crossover=density_crossover, diffset_depth=diffset_depth)
    rep = plan.rep
    bm = vdb.bitmaps  # [n_items, S, W]
    n_items = vdb.n_items
    results: List[PatternResult] = []
    ids = vdb.item_ids

    def pattern_of(steps) -> Pattern:
        pat: List[List[int]] = []
        for it, is_s in steps:
            if is_s:
                pat.append([int(ids[it])])
            else:
                pat[-1].append(int(ids[it]))
        return tuple(tuple(s) for s in pat)

    root_items = [i for i in range(n_items)
                  if int(vdb.item_supports[i]) >= minsup_abs]
    stack: List[tuple] = []  # (steps, bitmap, s_list, i_list)
    for i in reversed(root_items):
        results.append((pattern_of(((i, True),)),
                        int(vdb.item_supports[i])))
        stack.append((((i, True),), bm[i], root_items,
                      [j for j in root_items if j > i]))
    waves = candidates = diffset_nodes = 0

    def eval_cands(parent, cand, use_diff):
        """support(parent AND bm[i]) per candidate through the plan's
        per-item path: dense items as one bitmap block (direct popcount or
        the diffset spelling), sparse items through the id-list join."""
        sups = {}
        dense = [i for i in cand if rep[i]]
        if dense:
            joined = parent[None] & bm[dense]           # [n, S, W]
            if use_diff:
                block = BN.support_from_diffset(
                    BN.support_popcount(parent[None]),
                    BN.diffset_count(parent[None], joined))
            else:
                block = BN.support_popcount(joined)
            sups.update((i, int(s)) for i, s in zip(dense, block))
        for i in cand:
            if not rep[i]:
                sups[i] = idlist_join_support(parent, *vdb.idlist(i))
        return sups

    while stack:
        steps, b, s_list, i_list = stack.pop()
        n_itemsets = sum(1 for _, s in steps if s)
        allow_s = (max_pattern_itemsets is None
                   or n_itemsets < max_pattern_itemsets)
        trans = BN.sext_transform(b)
        waves += 1
        use_diff = bool(dd and len(steps) >= dd)
        if use_diff:
            diffset_nodes += 1
        s_items: List[int] = []
        s_sups = {}
        if allow_s and s_list:
            all_s = eval_cands(trans, s_list, use_diff)
            candidates += len(s_list)
            for i in s_list:
                if all_s[i] >= minsup_abs:
                    s_items.append(i)
                    s_sups[i] = all_s[i]
        i_items: List[int] = []
        i_sups = {}
        if i_list:
            all_i = eval_cands(b, i_list, use_diff)
            candidates += len(i_list)
            for i in i_list:
                if all_i[i] >= minsup_abs:
                    i_items.append(i)
                    i_sups[i] = all_i[i]
        children = []
        for it, is_s in ([(i, True) for i in s_items]
                         + [(i, False) for i in i_items]):
            sup = s_sups[it] if is_s else i_sups[it]
            child_steps = steps + ((it, is_s),)
            results.append((pattern_of(child_steps), sup))
            src = s_items if is_s else i_items
            child_i = [j for j in src if j > it]
            child_itemsets = n_itemsets + (1 if is_s else 0)
            child_allow_s = (max_pattern_itemsets is None
                             or child_itemsets < max_pattern_itemsets)
            if not ((s_items and child_allow_s) or child_i):
                continue
            cb = (BN.s_extend(b, bm[it]) if is_s
                  else BN.i_extend(b, bm[it]))
            children.append((child_steps, cb, s_items, child_i))
        stack.extend(reversed(children))
    if stats_out is not None:
        stats_out.update({"engine": "spam-cpu", "waves": waves,
                          "candidates": candidates,
                          "patterns": len(results),
                          "representation": plan.pin,
                          "rep_dense": plan.n_dense,
                          "rep_idlist": plan.n_sparse,
                          "diffset_depth": dd,
                          "diffset_nodes": diffset_nodes})
    return sort_patterns(results)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def mine_spam_torch(
    db: SequenceDB,
    minsup_abs: int,
    *,
    device: DeviceLike = None,
    mesh=None,
    max_pattern_itemsets: Optional[int] = None,
    stats_out: Optional[dict] = None,
    checkpoint=None,
    partition_parts: int = 0,
    partition_classes: int = 64,
    shape_buckets: bool = False,
    **kwargs,
) -> List[PatternResult]:
    """DB -> vertical build -> SPAM wave mine on ``device`` (default CUDA;
    raises without it).

    ``checkpoint`` (optional): an object with ``load() -> Optional[dict]``,
    ``save(state)`` and ``every_s``; a saved frontier (from either package,
    SPAM or SPADE) is resumed when its fingerprint still matches.  A
    ``mesh`` shards the sequence axis over its ranks (every rank calls
    this alike and gets the same result); ``partition_parts > 1`` mines
    ``partition_classes`` equivalence classes in that many slices
    (:func:`_mine_spam_partitioned`).  ``kwargs`` go to
    :class:`SpamBitmapTorch`."""
    dev = engine_device(device, mesh)
    vdb = build_vertical(db, min_item_support=minsup_abs)
    if vdb.n_items == 0:
        return []
    if partition_parts and int(partition_parts) > 1:
        return _mine_spam_partitioned(
            vdb, minsup_abs, device=dev, mesh=mesh,
            parts=int(partition_parts), classes=int(partition_classes),
            max_pattern_itemsets=max_pattern_itemsets, stats_out=stats_out,
            checkpoint=checkpoint, shape_buckets=shape_buckets, **kwargs)
    eng = SpamBitmapTorch(vdb, minsup_abs, device=dev, mesh=mesh,
                          max_pattern_itemsets=max_pattern_itemsets,
                          shape_buckets=shape_buckets, **kwargs)
    resume, save_cb, every_s = load_checkpoint(
        checkpoint, eng.frontier_fingerprint())
    results = eng.mine(resume=resume, checkpoint_cb=save_cb,
                       checkpoint_every_s=every_s)
    if stats_out is not None:
        stats_out.update(eng.stats)
    return results


def _mine_spam_partitioned(
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
    **kwargs,
) -> List[PatternResult]:
    """Equivalence-class partitioned SPAM (``spam_bitmap.
    _mine_spam_partitioned``): the partitioned SPADE route's structure,
    one :class:`SpamBitmapTorch` a slice.  The composite's fingerprint is
    field for field the partitioned SPADE route's, so either route
    resumes the other's checkpoint."""
    from spark_fsm_tpu_torch.models.spade import _SliceCheckpoint

    plan = PN.plan_partitions(vdb.item_ids, vdb.item_supports, parts,
                              classes)
    meshes = PN.submeshes(mesh, parts)
    fingerprint = dict(
        frontier_fingerprint(vdb, minsup_abs, max_pattern_itemsets),
        partition=plan.fingerprint())
    resume, save_cb, every_s = load_checkpoint(checkpoint, fingerprint)
    stats: dict = {
        "engine": "spam",
        "partition_parts": int(parts),
        "partition_classes": int(classes),
        "partition_imbalance": round(plan.imbalance_ratio, 4),
    }
    PN.count_mine("spam")

    def mine_part(p, row_mesh, resume_state, part_cb):
        ckpt = None
        if resume_state is not None or part_cb is not None:
            ckpt = _SliceCheckpoint(resume_state, part_cb, every_s)
        eng = SpamBitmapTorch(vdb, minsup_abs, device=device, mesh=row_mesh,
                              max_pattern_itemsets=max_pattern_itemsets,
                              partition=(plan, p), **kwargs)
        p_resume, p_save, p_every = load_checkpoint(
            ckpt, eng.frontier_fingerprint())
        res = eng.mine(resume=p_resume, checkpoint_cb=p_save,
                       checkpoint_every_s=p_every)
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
