"""Dense whole-mine SPADE — port of ``spark_fsm_tpu/models/spade_fused.py``
(``fused_geometry``, ``FusedCaps``, ``fused_eligible``, the init and level
body of ``_fused_init_fn``/``_fused_mine_fn``, and ``FusedSpadeTPU`` as
:class:`FusedSpadeTorch`).

The level-wise BFS runs on the device:

- the frontier is fixed-capacity tensors: the s/i candidate lists as
  ``[f_cap, ni_pad]`` masks over the item axis (the oracle's S/I lists,
  vectorized), each lane's bitmap slot, itemset count and record index;
- each level computes the dense ``[2*f_cap, ni_pad]`` pair matrix with B1
  (``ops/pair_support.pair_supports``: the kernel on CUDA, its plain
  version on the CPU), prunes by minsup, appends every surviving
  (parent record, item, ext-type, support) to a record buffer, and
  compacts the surviving children into the next frontier;
- child bitmaps go to one of two child regions of the store, which
  alternate by level (parents of level k sit in one, their children go
  to the other), so a child's slot is the region's base plus its rank.

Torch has no device while-loop, so the host runs the levels: after each
it reads a small counter tensor (live nodes, overflow, level), which is
the reference's loop condition.  The level body itself never syncs with
the host: every shape is a cap, ``nonzero`` is
``_common.nonzero_static``, and masked writes land in trash rows
(``_common.copy_rows_drop``), so the scratch row that inactive lanes
read stays all-zero.

With a ``mesh`` each rank runs the levels over its block of the sequence
axis and all-reduces (SUM) the level's pair matrix after B1 (the
reference's ``psum``), so every rank's frontier is the same; the default
frontier cap grows with the mesh (``FusedCaps.for_mesh``).

Any cap overflow makes :meth:`FusedSpadeTorch.mine` return None and the
caller falls back to the classic engine: capacity never costs
correctness.  The masks implement the oracle's candidate-list rules, so
the pattern set is byte-identical to it.  :func:`expand` (prune, records,
child masks) is shared with the queue engine (``spade_queue.py``), whose
body the reference spells out a second time.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from spark_fsm_tpu_torch.data.vertical import VerticalDB
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    I_TILE, P_TILE, CounterReader, bucket_seq, copy_rows_drop, device_axes,
    device_hbm_budget, engine_device, key_seq, nonzero_static,
    pad_to_multiple, prep_rows, scatter_build_store, shard_width)
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum, mesh_size
from spark_fsm_tpu_torch.utils import shapes
from spark_fsm_tpu_torch.utils.canonical import PatternResult, sort_patterns


def fused_geometry(n_sequences: int, n_items: int, n_words: int, *,
                   shape_buckets: bool = False,
                   caps: Optional["FusedCaps"] = None, mesh=None) -> dict:
    """Derived device geometry of a :class:`FusedSpadeTorch`;
    ``shape_buckets`` buckets the sequence axis (``_common.bucket_seq``),
    and a ``mesh`` sizes it and the default caps for its shards.
    ``shape_key`` is the reference's ``fused:`` key."""
    caps = caps or FusedCaps.for_mesh(mesh)
    ni_pad = pad_to_multiple(max(n_items, 1), I_TILE)
    return {"n_seq": device_axes(n_sequences, shape_buckets, mesh),
            "ni_pad": ni_pad, "caps": caps,
            "shape_key": shapes.key_fused(
                key_seq(n_sequences, shape_buckets, mesh), n_words, ni_pad,
                caps.f_cap)}


def fused_eligible(vdb: VerticalDB, device: DeviceLike = None,
                   caps: Optional["FusedCaps"] = None,
                   shape_buckets: bool = False, mesh=None) -> bool:
    """The reference's size heuristic for ``fused="auto"``, two ceilings:

    - traffic: each level computes the dense ``[2*f_cap, ni_pad]`` pair
      matrix, inactive lanes included, about ``row_bytes * 2 * f_cap *
      ni_pad * (1/I_TILE + 1/P_TILE)`` bytes; above 24 GiB the classic
      engine's exact candidate lists win;
    - allocation: the store plus four ``[2*f_cap]``-row prep stacks must
      fit 45 % of the device budget.

    Under ``shape_buckets`` both judge the bucketed sequence axis, under
    a ``mesh`` one device's share of it (``ceil(n_seq / N)``), with the
    mesh's default caps."""
    caps = caps or FusedCaps.for_mesh(mesh)
    ni_pad = pad_to_multiple(max(vdb.n_items, 1), I_TILE)
    if ni_pad > 1024:
        return False
    n_seq = (bucket_seq(vdb.n_sequences) if shape_buckets
             else vdb.n_sequences)
    row_bytes = -(-n_seq // mesh_size(mesh)) * vdb.n_words * 4
    est = (row_bytes * 2 * caps.f_cap * ni_pad
           * (1 / I_TILE + 1 / P_TILE))
    if est > 24 << 30:
        return False
    store_bytes = (ni_pad + 2 * caps.f_cap + 1) * row_bytes
    prep_bytes = 2 * caps.f_cap * row_bytes
    budget = device_hbm_budget(engine_device(device, mesh))
    return store_bytes + 4 * prep_bytes <= 0.45 * budget


class FusedCaps:
    """Static capacities: frontier width ``f_cap`` (rounded so ``2*f_cap``
    is a multiple of P_TILE), emissions per level ``c_cap``, total records
    ``r_cap``, levels ``l_max``."""

    def __init__(self, f_cap: int = 1024, c_cap: Optional[int] = None,
                 r_cap: int = 1 << 17, l_max: int = 128):
        self.f_cap = pad_to_multiple(int(f_cap), P_TILE // 2)
        self.c_cap = 8 * self.f_cap if c_cap is None else int(c_cap)
        self.r_cap = int(r_cap)
        self.l_max = int(l_max)

    @classmethod
    def for_mesh(cls, mesh=None) -> "FusedCaps":
        """The default caps scaled to the mesh: the pair matrix's sequence
        axis shards over the ranks, so the frontier cap grows with the
        rank count at constant per-rank traffic, up to 8192."""
        return cls(f_cap=min(8192, 1024 * mesh_size(mesh)))


def expand(sup_s: torch.Tensor, sup_i: torch.Tensor, cand_s: torch.Tensor,
           cand_i: torch.Tensor, nits: torch.Tensor, lane_rec: torch.Tensor,
           rec_count: torch.Tensor, minsup: int, max_its: Optional[int],
           c_cap: int, records: torch.Tensor, recsup: torch.Tensor):
    """One frontier step after the pair matrix, shared by the dense and
    queue engines: prune the lanes' candidates by ``minsup``, write a
    record (parent record, item, is-s) and support for every survivor
    into ``records``/``recsup`` from row ``rec_count`` on (in place; the
    buffers' last row is the trash row), and build each survivor's child
    candidate masks.  Emissions are in (lane, s then i, item) order; the
    pattern set is canonicalized on the host.

    Returns ``(n_emit, e_f, e_item, e_iss, e_rec, srow, child_i,
    child_nits, is_child)`` over ``c_cap`` emission slots (slots past
    ``n_emit`` read lane 0, item 0 and are not children)."""
    nb, ni = sup_s.shape
    dev = sup_s.device
    surv_s = cand_s & (sup_s >= minsup)
    surv_i = cand_i & (sup_i >= minsup)
    flat = torch.stack([surv_s, surv_i], dim=1).reshape(-1)
    n_emit = flat.sum()
    pos = nonzero_static(flat, c_cap, 2 * nb * ni)
    valid = torch.arange(c_cap, device=dev) < n_emit
    e_f = torch.where(valid, pos // (2 * ni), 0)
    e_iss = 1 - (pos // ni) % 2                        # 1 = s-extension
    e_item = torch.where(valid, pos % ni, 0)
    e_sup = torch.where(e_iss == 1, sup_s[e_f, e_item], sup_i[e_f, e_item])
    e_rec = rec_count + torch.cumsum(valid, 0) - 1
    keep = valid & (e_rec < records.shape[0] - 1)
    copy_rows_drop(records, e_rec, keep,
                   torch.stack([lane_rec[e_f], e_item, e_iss], dim=1)
                   .to(torch.int32))
    copy_rows_drop(recsup, e_rec, keep, e_sup.to(torch.int32))
    # child.s = the parent's surviving s-items; child.i = (s-child ?
    # surviving s-items : surviving i-items) above the extension item
    srow = surv_s[e_f]
    irow = torch.where((e_iss == 1)[:, None], srow, surv_i[e_f])
    child_i = irow & (torch.arange(ni, device=dev)[None, :] > e_item[:, None])
    child_nits = nits[e_f] + e_iss
    has_s = srow.any(dim=1)
    if max_its is not None:
        has_s = has_s & (child_nits < max_its)
    is_child = valid & (has_s | child_i.any(dim=1))
    return (n_emit, e_f, e_item, e_iss, e_rec, srow, child_i, child_nits,
            is_child)


def decode_records(item_ids: np.ndarray, rec: np.ndarray, sup: np.ndarray,
                   want_steps: bool = False):
    """Patterns (global ids) from the parent-linked records (parents
    precede children); with ``want_steps`` also each record's step chain
    in dense item indices.  Returns ``(results, steps_or_None)``."""
    n_rec = len(rec)
    pats: List[Optional[tuple]] = [None] * n_rec
    steps_of: List[Optional[tuple]] = [None] * n_rec
    results: List[PatternResult] = []
    for k in range(n_rec):
        parent, item, iss = int(rec[k, 0]), int(rec[k, 1]), int(rec[k, 2])
        it_id = int(item_ids[item])
        if parent < 0:
            pat = ((it_id,),)
        elif iss:
            pat = pats[parent] + ((it_id,),)
        else:
            pat = pats[parent][:-1] + (pats[parent][-1] + (it_id,),)
        pats[k] = pat
        if want_steps:
            steps_of[k] = (((item, True),) if parent < 0
                           else steps_of[parent] + ((item, bool(iss)),))
        results.append((pat, int(sup[k])))
    return results, (steps_of if want_steps else None)


def root_state(root_ids: List[int], root_sups: List[int], root_mask,
               width: int, ni_pad: int, r_cap: int, device: torch.device):
    """The first frontier on the device, shared with the queue engine:
    lane k < len(root_ids) holds root item ``root_ids[k]`` (its bitmap
    is the item row itself), s-candidates = the frequent items
    (``root_mask``), i-candidates = those above the root; lanes past the
    roots are empty.  Returns ``(slots, s_mask, i_mask, nits, records,
    recsup)``: the root records 0..n-1 are written, with one trash row
    past ``r_cap``."""
    n = len(root_ids)
    slots = torch.zeros(width, dtype=torch.int64, device=device)
    slots[:n] = torch.as_tensor(root_ids, dtype=torch.int64).to(device)
    mask = torch.as_tensor(np.asarray(root_mask, bool)).to(device)
    active = torch.arange(width, device=device) < n
    s_mask = active[:, None] & mask[None, :]
    i_mask = s_mask & (torch.arange(ni_pad, device=device)[None, :]
                       > slots[:, None])
    nits = torch.ones(width, dtype=torch.int64, device=device)
    records = torch.zeros(r_cap + 1, 3, dtype=torch.int32, device=device)
    recsup = torch.zeros(r_cap + 1, dtype=torch.int32, device=device)
    records[:n, 0] = -1
    records[:n, 1] = slots[:n].to(torch.int32)
    records[:n, 2] = 1
    recsup[:n] = torch.as_tensor(root_sups, dtype=torch.int32).to(device)
    return slots, s_mask, i_mask, nits, records, recsup


class FusedSpadeTorch:
    """Whole-mine-on-device SPADE for small and medium databases.

    :meth:`mine` returns None when a static cap overflowed; the caller
    (``mine_spade_torch(fused="auto")``) then falls back to the classic
    engine, which has no capacity limits."""

    def __init__(self, vdb: VerticalDB, minsup_abs: int, *,
                 device: DeviceLike = None, mesh=None,
                 max_pattern_itemsets: Optional[int] = None,
                 caps: Optional[FusedCaps] = None,
                 shape_buckets: bool = False):
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        self.vdb = vdb
        self.minsup = int(minsup_abs)
        self.max_its = max_pattern_itemsets
        g = fused_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                           shape_buckets=shape_buckets, caps=caps, mesh=mesh)
        self.caps = g["caps"]
        self.n_seq, self.n_words = g["n_seq"], vdb.n_words
        self.s_local = shard_width(self.n_seq, mesh)
        self.ni_pad = g["ni_pad"]
        self.n_items = vdb.n_items
        self.stats = {"patterns": 0, "levels": 0, "fused": True,
                      "shape_key": g["shape_key"]}
        shapes.record(g["shape_key"])

    def mine(self) -> Optional[List[PatternResult]]:
        vdb, cap, dev = self.vdb, self.caps, self.device
        roots = [i for i in range(self.n_items)
                 if int(vdb.item_supports[i]) >= self.minsup]
        if not roots:
            return []
        if len(roots) > min(cap.f_cap, cap.r_cap):
            self.stats["fused_overflow"] = True
            return None  # the frontier cannot hold the roots

        self.start(roots)
        reader = CounterReader(5, dev)
        n_nodes, n_rec = len(roots), len(roots)
        oflow = level = n_cand = 0
        while n_nodes > 0 and not oflow and level < cap.l_max:
            self.level()
            n_nodes, oflow, level, n_rec, n_cand = reader.read(self.ctr)
        self.stats["levels"] = level
        self.stats["candidates"] = n_cand
        self.stats["kernel_launches"] = level  # one B1 launch a level
        self.stats["wait_s"] = reader.wait_s
        if oflow or n_nodes > 0:
            self.stats["fused_overflow"] = True
            self.store = None
            return None  # the record buffer is garbage
        rec = self.records[:n_rec].cpu().numpy()
        sup = self.recsup[:n_rec].cpu().numpy()
        self.store = None
        results, _ = decode_records(vdb.item_ids, rec, sup)
        self.stats["patterns"] = len(results)
        return sort_patterns(results)

    def start(self, roots: List[int]) -> None:
        """Build the store and the root frontier on the device."""
        cap, dev = self.caps, self.device
        # store rows: [0, ni_pad) item rows; two child regions of f_cap
        # rows; the all-zero scratch row inactive lanes read; the trash row
        ni, f = self.ni_pad, cap.f_cap
        self._scratch = ni + 2 * f
        self.store = scatter_build_store(self.vdb, ni + 2 * f + 2, self.n_seq,
                                         self.n_words, dev, self.mesh)
        root_mask = np.zeros(ni, bool)
        root_mask[roots] = True
        (self.slots, self.s_mask, self.i_mask, self.nits, self.records,
         self.recsup) = root_state(
            roots, [int(self.vdb.item_supports[i]) for i in roots],
            root_mask, f, ni, cap.r_cap, dev)
        self.rec_idx = torch.arange(f, dtype=torch.int64, device=dev)
        # [n_nodes, overflow, level, rec_count, candidates]
        self.ctr = torch.tensor([len(roots), 0, 0, len(roots), 0],
                                dtype=torch.int64, device=dev)

    def level(self) -> None:
        """One BFS level on the device, with no host sync: the frontier
        tensors, the record buffers and the counters advance in place."""
        cap, dev, ni, f = self.caps, self.device, self.ni_pad, self.caps.f_cap
        n_nodes, oflow, level, rec_count, n_cand = self.ctr.unbind(0)
        lane = torch.arange(f, device=dev)
        active = lane < n_nodes
        pt = prep_rows(self.store, torch.where(active, self.slots,
                                               self._scratch),
                       self.s_local, self.n_words)
        # item rows past the real items are the store's zero pad rows
        pair = all_reduce_sum(PS.pair_supports(pt, self.store, ni,
                                               n_words=self.n_words,
                                               n_live=self.n_items),
                              self.mesh).view(f, 2, ni)
        # row 2f: plain & item = i-ext; row 2f+1: transform & item = s-ext
        sup_i, sup_s = pair[:, 0], pair[:, 1]
        allow_s = active
        if self.max_its is not None:
            allow_s = active & (self.nits < self.max_its)
        cand_s = self.s_mask & allow_s[:, None]
        cand_i = self.i_mask & active[:, None]
        n_cand = n_cand + cand_s.sum() + cand_i.sum()
        (n_emit, e_f, e_item, e_iss, e_rec, srow, child_i, child_nits,
         is_child) = expand(sup_s, sup_i, cand_s, cand_i, self.nits,
                            self.rec_idx, rec_count, self.minsup,
                            self.max_its, cap.c_cap, self.records,
                            self.recsup)
        n_children = is_child.sum()
        cpos = nonzero_static(is_child, f, cap.c_cap - 1)
        cvalid = lane < n_children
        # children's bitmaps into the region the parents are not in; pt's
        # row 2f is parent f's bitmap, row 2f+1 its s-ext transform
        base = torch.where(level % 2 == 0, ni, ni + f)
        new_slots = base + lane
        joins = (pt.index_select(0, 2 * e_f[cpos] + e_iss[cpos])
                 & self.store.index_select(0, e_item[cpos]))
        copy_rows_drop(self.store, new_slots, cvalid, joins)
        self.slots = new_slots
        self.s_mask = srow[cpos] & cvalid[:, None]
        self.i_mask = child_i[cpos] & cvalid[:, None]
        self.nits = torch.where(cvalid, child_nits[cpos], 0)
        self.rec_idx = torch.where(cvalid, e_rec[cpos], 0)
        oflow = ((oflow != 0) | (n_emit > cap.c_cap)
                 | (rec_count + n_emit > cap.r_cap) | (n_children > f))
        self.ctr = torch.stack([n_children, oflow.long(), level + 1,
                                rec_count + n_emit, n_cand])
