"""Queue SPADE: the sparse-frontier whole-mine engine — port of
``spark_fsm_tpu/models/spade_queue.py`` (``queue_geometry``,
``QueueCaps``, ``working_set_bytes``, ``queue_eligible``, the root init,
the wave body, the one-shot mine with its late-wave ladder, the
segmented checkpointed mine, the snapshot and the resume with its
join-chain refill; ``QueueSpadeTPU`` as :class:`QueueSpadeTorch`).

The classic engine's cost model (each wave evaluates about ``nb`` real
nodes against the item rows) with the frontier kept on the device:

- the frontier is a FIFO queue over a ring of bitmap slots in the store.
  FIFO order makes a slot's lifetime its time in the queue, so the ring
  holds only the live frontier (about two BFS levels), not the mine;
- each wave pops ``nb`` nodes (inactive lanes read the all-zero scratch
  row), computes the ``[2*nb, ni_pad]`` pair matrix with B1
  (``ops/pair_support.pair_supports``), prunes by minsup, appends the
  survivors' records and enqueues the children (bitmap and candidate
  masks) at the ring's tail;
- root nodes alias the item rows through ``q_slot``, so the root level
  copies nothing.

Torch has no device while-loop, so the host runs the waves.  After each
wave it reads a 6-int counter tensor (head, tail, overflow, wave,
records, candidates) and applies the reference's loop conditions: the
same wide/narrow switch as its one-shot ``cond_wide``/``cond_late``, and
the same segment budgets (1, then x4 up to ``seg_waves``) when a
checkpoint is taken.  With pinned caps the counters ``waves``,
``late_waves``, ``candidates`` and ``patterns`` therefore equal the
reference's.  The wave body makes no host sync: every shape is static,
``nonzero`` is ``_common.nonzero_static``, and masked writes land in each
buffer's trash row (``_common.copy_rows_drop``) — the store's is one row
past the scratch row, so scratch stays all-zero.  The host's waits on
the counters are summed in ``stats["wait_s"]``.

With a ``mesh`` every rank runs the waves over its block of the sequence
axis: B1 gives the shard's partial pair matrix, which is all-reduced
(SUM) before ``expand`` (the reference's ``psum`` at its wave), so the
frontier, records and counters agree on every rank.  Under NCCL the
reduce stays on the stream and the wave body stays free of host syncs.

Static caps (wave width, ring, emissions and children per wave, total
records, waves) bound every shape; any overflow makes :meth:`mine`
return None and the caller falls back (capacity is a routing concern,
never a correctness one).  A snapshot is the classic engine's frontier
format, so either package's classic or queue engine resumes it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from spark_fsm_tpu_torch.data.vertical import VerticalDB
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    I_TILE, P_TILE, CounterReader, FrontierNode, bucket_seq, checkpoint_due,
    copy_rows_drop, decode_frontier, device_axes, device_hbm_budget,
    encode_frontier, engine_device, frontier_fingerprint, key_seq,
    nonzero_static, pad_to_multiple, prep_rows, recompute_rows,
    scatter_build_store, shard_width)
from spark_fsm_tpu_torch.models.spade_fused import (
    decode_records, expand, root_state)
from spark_fsm_tpu_torch.ops import pair_support as PS
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import all_reduce_sum, mesh_size
from spark_fsm_tpu_torch.service import fusion as FZ
from spark_fsm_tpu_torch.utils import faults, jobctl, obs, shapes, watchdog
from spark_fsm_tpu_torch.utils.canonical import PatternResult, sort_patterns

# ring slots a resume refills per join-chain fold launch
_REFILL_GROUP = 256


def queue_geometry(n_sequences: int, n_items: int, n_words: int, *,
                   device: DeviceLike = None, shape_buckets: bool = False,
                   caps: Optional["QueueCaps"] = None, mesh=None) -> dict:
    """Derived device geometry of a :class:`QueueSpadeTorch`; pure host
    arithmetic (the budget probe reads device metadata only).
    ``shape_buckets`` buckets the sequence axis (``_common.bucket_seq``),
    which the caps are sized on; under a ``mesh`` the axis is the
    reference's for that many shards and the caps judge one shard.
    ``shape_key`` is the reference's ``queue:`` key
    (``_common.key_seq``)."""
    n_seq = device_axes(n_sequences, shape_buckets, mesh)
    ks = key_seq(n_sequences, shape_buckets, mesh)
    ni_pad = pad_to_multiple(max(n_items, 1), I_TILE)
    if caps is None:
        # sized on the reference's sequence axis, as queue_eligible judges
        caps = QueueCaps.for_budget(
            ks * n_words * 4, ni_pad,
            int(0.45 * device_hbm_budget(engine_device(device, mesh))),
            mesh_size(mesh))
    return {"n_seq": n_seq, "ni_pad": ni_pad, "caps": caps,
            # the narrow wave width the mine switches to once the live
            # frontier drops below it
            "nb_late": RB.late_wave_nb(caps.nb, P_TILE),
            "shape_key": shapes.key_queue(ks, n_words, ni_pad, caps.nb,
                                          caps.ring)}


class QueueCaps:
    """Static capacities of the queue engine.

    ``nb``: nodes popped per wave.  ``ring``: live-frontier capacity
    (bitmap slots and candidate masks); it bounds ``tail - head``, not
    the mine.  ``c_cap``: records emitted per wave.  ``m_cap``: children
    materialized per wave.  ``r_cap``: records (= patterns) in all.
    ``i_max``: wave-count ceiling (an overflow guard)."""

    def __init__(self, nb: int = 512, ring: int = 8192,
                 c_cap: Optional[int] = None, m_cap: Optional[int] = None,
                 r_cap: int = 1 << 17, i_max: int = 8192):
        self.nb = pad_to_multiple(int(nb), P_TILE)
        self.ring = int(ring)
        self.c_cap = 4 * self.nb if c_cap is None else int(c_cap)
        self.m_cap = min(self.c_cap,
                         max(2 * self.nb, self.c_cap // 2)
                         if m_cap is None else int(m_cap))
        self.r_cap = int(r_cap)
        self.i_max = int(i_max)

    @classmethod
    def for_budget(cls, row_bytes: int, ni_pad: int,
                   budget: int, n_dev: int = 1) -> "QueueCaps":
        """The largest pow2 ring in [256, 65536] whose working set
        (:func:`working_set_bytes`, which ``queue_eligible`` judges too)
        fits ``budget`` per device, on ``n_dev`` devices' shares of a
        ``row_bytes`` row; the smallest ring when none does."""
        per_dev_row = max(1, -(-row_bytes // n_dev))
        best = None
        ring = 256
        while ring <= 65536:
            caps = cls(ring=ring)
            if working_set_bytes(caps, per_dev_row, ni_pad) > budget:
                break
            best = caps
            ring *= 2
        return best if best is not None else cls(ring=256)


def working_set_bytes(caps: QueueCaps, per_dev_row: int,
                      ni_pad: int) -> int:
    """The reference's one working-set estimator, shared by sizing and
    routing so the two never disagree.  It counts the store twice (the
    reference's ``while_loop`` carry cannot alias its input store); this
    port updates the store in place and needs it once, but the estimator
    is kept as it is so equal budgets give equal caps and routes."""
    store_rows = ni_pad + caps.ring + 1
    return (2 * store_rows * per_dev_row                 # store (x2 carry)
            + (2 * caps.nb + caps.m_cap) * per_dev_row   # wave temps
            + 2 * (2 * caps.ring * ni_pad)               # bool masks (x2)
            + 2 * (3 * caps.ring * 4)                    # int32 queue state
            + 2 * (4 * caps.r_cap * 4))                  # records + recsup


def queue_eligible(vdb: VerticalDB, device: DeviceLike = None,
                   caps: Optional[QueueCaps] = None,
                   shape_buckets: bool = False, mesh=None) -> bool:
    """The reference's routing test for ``fused="auto"``: the padded
    alphabet is at most 1024 items (the pair matrix spans every item
    row), the ring holds the whole root level, and the working set fits
    45 % of the device budget.  It judges the unpadded sequence count, or
    its bucket under ``shape_buckets``, as the reference does, and under
    a ``mesh`` one device's share of a row (``ceil(n_seq / N)``)."""
    ni_pad = pad_to_multiple(max(vdb.n_items, 1), I_TILE)
    if ni_pad > 1024:
        return False
    n_dev = mesh_size(mesh)
    n_seq = (bucket_seq(vdb.n_sequences) if shape_buckets
             else vdb.n_sequences)
    row_bytes = -(-n_seq // n_dev) * vdb.n_words * 4
    budget = 0.45 * device_hbm_budget(engine_device(device, mesh))
    if caps is None:
        caps = QueueCaps.for_budget(row_bytes * n_dev, ni_pad, int(budget),
                                    n_dev)
    if caps.ring < vdb.n_items:
        return False
    return working_set_bytes(caps, row_bytes, ni_pad) <= budget


@dataclasses.dataclass
class _Carry:
    """The device state of a mine.  Ring buffers have ``ring + 1`` rows
    and record buffers ``r_cap + 1``: the last is the trash row.
    ``ctr`` = [head, tail, overflow, wave, records, candidates]."""

    q_slot: torch.Tensor    # store row of each ring entry's bitmap
    q_smask: torch.Tensor   # [ring + 1, ni_pad] s-extension candidates
    q_imask: torch.Tensor   # [ring + 1, ni_pad] i-extension candidates
    q_nits: torch.Tensor    # itemsets in each entry's pattern
    q_rec: torch.Tensor     # each entry's own record
    records: torch.Tensor   # [r_cap + 1, 3] (parent record, item, is-s)
    recsup: torch.Tensor    # [r_cap + 1] supports
    ctr: torch.Tensor


class QueueSpadeTorch:
    """Sparse-frontier whole-mine-on-device SPADE.

    :meth:`mine` returns None when a static cap overflowed; the caller
    (``mine_spade_torch``) then falls back.  The store is built once here
    and reused by every :meth:`mine` (waves never write the item rows).
    """

    def __init__(self, vdb: VerticalDB, minsup_abs: int, *,
                 device: DeviceLike = None, mesh=None,
                 max_pattern_itemsets: Optional[int] = None,
                 caps: Optional[QueueCaps] = None,
                 shape_buckets: bool = False, partition=None):
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        self.vdb = vdb
        self.minsup = int(minsup_abs)
        self.max_its = max_pattern_itemsets
        # a (PartitionPlan, part) slice seeds only the owned classes'
        # roots; the candidate masks stay the whole extension universe
        self._partition = partition
        g = queue_geometry(vdb.n_sequences, vdb.n_items, vdb.n_words,
                           device=self.device, shape_buckets=shape_buckets,
                           caps=caps, mesh=mesh)
        self.n_seq, self.n_words = g["n_seq"], vdb.n_words
        self.s_local = shard_width(self.n_seq, mesh)
        self.ni_pad = g["ni_pad"]
        self.n_items = vdb.n_items
        self.caps = g["caps"]
        self.nb_late = g["nb_late"]
        self.stats = {"patterns": 0, "waves": 0, "fused": "queue",
                      "shape_key": g["shape_key"]}
        shapes.record(g["shape_key"])
        # store rows: [0, ni_pad) the item rows (children go to rows >=
        # ni_pad); [ni_pad, ni_pad + ring) the slot ring; the all-zero
        # scratch row inactive lanes read; the trash row
        self._scratch = self.ni_pad + self.caps.ring
        self.store = scatter_build_store(vdb, self._scratch + 2, self.n_seq,
                                         self.n_words, self.device, mesh)

    def mine(self, *, resume: Optional[dict] = None, checkpoint_cb=None,
             checkpoint_every_s: float = 30.0,
             seg_waves: int = 256) -> Optional[List[PatternResult]]:
        """Run the mine.  Without ``resume``/``checkpoint_cb`` it is the
        one-shot mine with the late-wave ladder; with them it runs in
        segments of at most ``seg_waves`` waves and, at most every
        ``checkpoint_every_s`` seconds, snapshots the live frontier in the
        classic engine's ``encode_frontier`` format."""
        if resume is None and checkpoint_cb is None:
            return self._mine_oneshot()
        return self._mine_segmented(resume, checkpoint_cb,
                                    checkpoint_every_s, seg_waves)

    def frontier_fingerprint(self) -> dict:
        """The classic engine's fingerprint: the engines enumerate alike,
        so their snapshots interchange."""
        return frontier_fingerprint(self.vdb, self.minsup, self.max_its)

    def roots(self) -> List[int]:
        return [i for i in range(self.n_items)
                if int(self.vdb.item_supports[i]) >= self.minsup]

    def _seed_roots(self) -> List[int]:
        """The roots this engine seeds: every frequent item, or only the
        owned classes' items under a partition slice."""
        return PN.owned_roots(self.roots(), self.vdb.item_ids,
                              self._partition)

    def start(self, roots: List[int]) -> _Carry:
        """The device state of a fresh mine seeded with ``roots``; the
        candidate masks are every frequent item, whichever roots seed."""
        cap, ni, dev = self.caps, self.ni_pad, self.device
        root_mask = np.zeros(ni, bool)
        root_mask[self.roots()] = True
        slots, s_mask, i_mask, nits, records, recsup = root_state(
            roots, [int(self.vdb.item_supports[i]) for i in roots],
            root_mask, cap.ring + 1, ni, cap.r_cap, dev)
        lane = torch.arange(cap.ring + 1, device=dev)
        n = len(roots)
        return _Carry(torch.where(lane < n, slots, self._scratch), s_mask,
                      i_mask, nits, lane, records, recsup,
                      torch.tensor([0, n, 0, 0, n, 0], dtype=torch.int64,
                                   device=dev))

    def wave(self, c: _Carry, nb: int) -> None:
        """One wave of width ``nb`` on the device, with no host sync:
        ``c``'s buffers, the store's ring rows and the counters advance in
        place."""
        cap, dev, ni = self.caps, self.device, self.ni_pad
        ring = cap.ring
        head, tail, oflow, wave, rec_count, n_cand = c.ctr.unbind(0)
        qid = head + torch.arange(nb, device=dev)
        active = qid < tail
        ridx = torch.where(active, qid % ring, ring - 1)
        pt = prep_rows(self.store,
                       torch.where(active, c.q_slot[ridx], self._scratch),
                       self.s_local, self.n_words)
        pair = all_reduce_sum(PS.pair_supports(pt, self.store, ni,
                                               n_words=self.n_words),
                              self.mesh).view(nb, 2, ni)
        # row 2f: plain & item = i-ext; row 2f+1: transform & item = s-ext
        sup_i, sup_s = pair[:, 0], pair[:, 1]
        nits = c.q_nits[ridx]
        allow_s = active
        if self.max_its is not None:
            allow_s = active & (nits < self.max_its)
        cand_s = c.q_smask[ridx] & allow_s[:, None]
        cand_i = c.q_imask[ridx] & active[:, None]
        n_cand = n_cand + cand_s.sum() + cand_i.sum()
        (n_emit, e_f, e_item, e_iss, e_rec, srow, child_i, child_nits,
         is_child) = expand(sup_s, sup_i, cand_s, cand_i, nits,
                            c.q_rec[ridx], rec_count, self.minsup,
                            self.max_its, cap.c_cap, c.records, c.recsup)
        n_children = is_child.sum()
        cpos = nonzero_static(is_child, cap.m_cap, cap.c_cap - 1)
        cvalid = torch.arange(cap.m_cap, device=dev) < n_children
        # enqueue at the tail.  Children may reuse the slots of nodes
        # popped this wave (pt copied those rows first); overwriting a
        # still-live slot means new_tail - new_head > ring, an overflow
        # that discards the mine
        cridx = (tail + torch.cumsum(cvalid, 0) - 1) % ring
        joins = (pt.index_select(0, 2 * e_f[cpos] + e_iss[cpos])
                 & self.store.index_select(0, e_item[cpos]))
        copy_rows_drop(self.store, ni + cridx, cvalid, joins)
        copy_rows_drop(c.q_slot, cridx, cvalid, ni + cridx)
        copy_rows_drop(c.q_smask, cridx, cvalid, srow[cpos])
        copy_rows_drop(c.q_imask, cridx, cvalid, child_i[cpos])
        copy_rows_drop(c.q_nits, cridx, cvalid, child_nits[cpos])
        copy_rows_drop(c.q_rec, cridx, cvalid, e_rec[cpos])
        new_head = torch.minimum(head + nb, tail)
        new_tail = tail + n_children
        oflow = ((oflow != 0) | (n_emit > cap.c_cap)
                 | (n_children > cap.m_cap) | (rec_count + n_emit > cap.r_cap)
                 | (new_tail - new_head > ring))
        c.ctr = torch.stack([new_head, new_tail, oflow.long(), wave + 1,
                             rec_count + n_emit, n_cand])

    def _finish(self, c: _Carry, n_rec: int, waves: int,
                n_cand: int) -> List[PatternResult]:
        self.stats["waves"] = waves
        self.stats["candidates"] = n_cand
        self.stats["kernel_launches"] = waves  # one B1 launch a wave
        rec = c.records[:n_rec].cpu().numpy()
        sup = c.recsup[:n_rec].cpu().numpy()
        results, _ = decode_records(self.vdb.item_ids, rec, sup)
        self.stats["patterns"] = len(results)
        return sort_patterns(results)

    def _overflow(self, waves: int) -> None:
        self.stats["fused_overflow"] = True
        self.stats["waves"] = waves

    def _mine_oneshot(self) -> Optional[List[PatternResult]]:
        cap = self.caps
        roots = self._seed_roots()
        if not roots:
            return []
        if len(roots) > min(cap.ring, cap.r_cap):
            self.stats["fused_overflow"] = True
            return None  # the ring cannot hold the root level
        # deadline/cancel safe point before the whole mine's waves, where
        # the reference commits its one whole-mine dispatch
        jobctl.check_shared(self.mesh)
        c = self.start(roots)
        reader = CounterReader(6, self.device)
        nb, nbl = cap.nb, self.nb_late
        # watchdog deadline for every counter read of the mine: the wave
        # ceiling times the wave width bounds the lanes the mine streams
        # (a ceiling, not a prediction: it feeds no cost-model gauge)
        bound_s = RB.estimate_seconds(cap.nb * cap.i_max, 1, self.n_seq,
                                      self.n_words)
        deadline = watchdog.deadline_s(bound_s)

        def read():
            faults.fault_site("device.dispatch", point="queue_readback")
            return reader.read(c.ctr)

        def run():
            """The whole mine's waves: wide while the live frontier
            exceeds nb_late, then narrow waves drain it (their ceiling is
            nb/nb_late times higher).  Returns the last counters and the
            narrow waves."""
            ctr = (0, len(roots), 0, 0, len(roots), 0)  # as start() sets them
            rd = lambda: watchdog.run_with_deadline(  # noqa: E731
                read, deadline, site="queue.readback")
            wide = None
            if nbl < nb:
                while (ctr[1] - ctr[0] > nbl and not ctr[2]
                       and ctr[3] < cap.i_max):
                    self.wave(c, nb)
                    ctr = rd()
                wide = ctr[3]
                i_max_late = cap.i_max * max(1, nb // nbl)
                while ctr[1] > ctr[0] and not ctr[2] and ctr[3] < i_max_late:
                    self.wave(c, nbl)
                    ctr = rd()
            else:
                while ctr[1] > ctr[0] and not ctr[2] and ctr[3] < cap.i_max:
                    self.wave(c, nb)
                    ctr = rd()
            return ctr, (0 if wide is None else ctr[3] - wide)

        with obs.span("queue.dispatch", point="oneshot", nb=cap.nb,
                      bound_s=round(bound_s, 6)):
            faults.fault_site("device.dispatch", point="queue_launch")
            # the mine carries this job's device state, so it never
            # fuses; it routes through the broker's accounting and fault
            # surface (one global read when the broker is off)
            ctr, late = FZ.dispatch_wave("queue", run, point="oneshot")
        head, tail, oflow, wave, n_rec, n_cand = ctr
        self.stats["late_waves"] = late
        self.stats["wait_s"] = reader.wait_s
        self.stats["candidates"] = n_cand
        if oflow or tail > head:
            self._overflow(wave)
            return None  # the record buffer is garbage
        return self._finish(c, n_rec, wave, n_cand)

    # ------------------------------------------------ checkpointed path

    def _mine_segmented(self, resume, checkpoint_cb, every_s: float,
                        seg_waves: int) -> Optional[List[PatternResult]]:
        cap = self.caps
        if resume is not None:
            results, nodes = decode_frontier(
                resume, self.frontier_fingerprint(), FrontierNode)
            self.stats["resumed_nodes"] = len(nodes)
            if not nodes:
                self.stats["patterns"] = len(results)
                return sort_patterns(results)
            c = self._resume_carry(results, nodes)
            if c is None:
                self.stats["fused_overflow"] = True
                return None  # the snapshot does not fit these caps
            ckpt_done = len(results)
            head, tail, n_rec = 0, len(nodes), len(results)
        else:
            roots = self._seed_roots()
            if not roots:
                return []
            if len(roots) > min(cap.ring, cap.r_cap):
                self.stats["fused_overflow"] = True
                return None
            c = self.start(roots)
            ckpt_done = 0
            head, tail, n_rec = 0, len(roots), len(roots)
        oflow = wave = n_cand = 0
        reader = CounterReader(6, self.device)
        nbl = self.nb_late
        ratio = max(1, cap.nb // max(1, nbl))
        # the late-wave ladder, host-driven: narrow segments run at
        # nb_late with a ceiling scaled by the width ratio
        narrow = nbl < cap.nb and tail - head <= nbl
        last_ckpt = time.monotonic()
        last_waves = 0
        self.stats["late_waves"] = 0
        # fine segment boundaries early (a checkpointed mine snapshots
        # after wave 1), coarse later
        budget = 1 if checkpoint_cb is not None else seg_waves
        ctr = (head, tail, oflow, wave, n_rec, n_cand)

        def segment(nbw: int, ceil: int, wave_end: int, deadline):
            """One segment's waves; each counter read runs under the
            watchdog.  Returns the last counters."""
            k = ctr
            while k[1] > k[0] and not k[2] and k[3] < ceil and k[3] < wave_end:
                self.wave(c, nbw)
                k = watchdog.run_with_deadline(
                    lambda: reader.read(c.ctr), deadline,
                    site="queue.segment_readback")
            return k

        while True:
            # deadline/cancel safe point between segments
            jobctl.check_shared(self.mesh)
            nbw = nbl if narrow else cap.nb
            ceil = cap.i_max * (ratio if narrow else 1)
            seg_bound_s = RB.estimate_seconds(nbw * budget, 1, self.n_seq,
                                              self.n_words)
            with obs.span("queue.segment", nb=nbw, budget=budget,
                          narrow=narrow, bound_s=round(seg_bound_s, 6)):
                faults.fault_site("device.dispatch", point="queue_segment")
                # unfusable (per-job device state), broker-accounted
                ctr = FZ.dispatch_wave(
                    "queue", lambda: segment(
                        nbw, ceil, wave + budget,
                        watchdog.deadline_s(seg_bound_s)),
                    point="segment")
            head, tail, oflow, wave, n_rec, n_cand = ctr
            budget = min(seg_waves, budget * 4)
            pending = tail > head
            if narrow:
                self.stats["late_waves"] += wave - last_waves
            last_waves = wave
            if oflow or (pending and wave >= ceil):
                self.stats["wait_s"] = reader.wait_s
                self._overflow(wave)
                return None  # a classic fallback resumes the last save
            if not pending:
                break
            if not narrow and nbl < cap.nb and tail - head <= nbl:
                narrow = True  # never switched back
            if checkpoint_due(checkpoint_cb, last_ckpt, every_s, self.mesh):
                checkpoint_cb(self._snapshot(c, head, tail, n_rec, ckpt_done))
                ckpt_done = n_rec
                self.stats["checkpoints"] = (
                    self.stats.get("checkpoints", 0) + 1)
                last_ckpt = time.monotonic()
        self.stats["wait_s"] = reader.wait_s
        return self._finish(c, n_rec, wave, n_cand)

    def _snapshot(self, c: _Carry, head: int, tail: int, n_rec: int,
                  ckpt_done: int) -> dict:
        """Wave-boundary snapshot in the classic engine's format: live
        ring entries become stack nodes (their masks are the s/i lists),
        records become results.  The ring bitmaps are not read: a resume
        rebuilds them."""
        ring = self.caps.ring
        q_smask = c.q_smask.cpu().numpy()
        q_imask = c.q_imask.cpu().numpy()
        q_rec = c.q_rec.cpu().numpy()
        results, steps_of = decode_records(
            self.vdb.item_ids, c.records[:n_rec].cpu().numpy(),
            c.recsup[:n_rec].cpu().numpy(), want_steps=True)
        nim = self.n_items
        nodes = []
        for qid in range(head, tail):
            r = qid % ring
            nodes.append(FrontierNode(
                steps_of[int(q_rec[r])], None,
                [int(x) for x in np.nonzero(q_smask[r][:nim])[0]],
                [int(x) for x in np.nonzero(q_imask[r][:nim])[0]]))
        return encode_frontier(self.frontier_fingerprint(), nodes, results,
                               ckpt_done)

    def _resume_carry(self, results, nodes) -> Optional[_Carry]:
        """The device state a snapshot describes: the parent-linked
        records rebuilt from the result patterns, the candidate masks and
        queue bookkeeping uploaded, and each live entry's ring bitmap
        recomputed by folding its join chain from the item rows.  None
        when the snapshot does not fit these caps (the classic engine
        resumes it instead)."""
        cap, ni, dev = self.caps, self.ni_pad, self.device
        ring = cap.ring
        n_live = len(nodes)
        if n_live > min(ring, cap.r_cap) or len(results) > cap.r_cap:
            return None
        ids = self.vdb.item_ids
        g2l = {int(g): l for l, g in enumerate(ids)}
        rec_np = np.zeros((cap.r_cap + 1, 3), np.int32)
        sup_np = np.zeros(cap.r_cap + 1, np.int32)
        idx_of: dict = {}
        for k, (pat, s) in enumerate(results):
            # the last step comes off the canonical pattern: i-extensions
            # only add items above the itemset's current largest
            last = pat[-1]
            if len(last) == 1:
                ppat, g, iss = pat[:-1], last[0], 1
            else:
                ppat, g, iss = pat[:-1] + (last[:-1],), last[-1], 0
            loc = g2l.get(int(g))
            if loc is None:
                return None  # projection drift the fingerprint missed
            if ppat:
                parent = idx_of.get(ppat)
                if parent is None:
                    return None  # malformed snapshot: orphan pattern
            else:
                parent = -1
            rec_np[k] = (parent, loc, iss)
            sup_np[k] = int(s)
            idx_of[pat] = k

        def pattern_of_steps(steps):
            pat: List[List[int]] = []
            for it, s in steps:
                if s:
                    pat.append([int(ids[it])])
                else:
                    pat[-1].append(int(ids[it]))
            return tuple(tuple(p) for p in pat)

        q_slot = np.full(ring + 1, self._scratch, np.int64)
        q_smask = np.zeros((ring + 1, ni), bool)
        q_imask = np.zeros((ring + 1, ni), bool)
        q_nits = np.ones(ring + 1, np.int64)
        q_rec = np.zeros(ring + 1, np.int64)
        K = max(2, max(len(n.steps) for n in nodes))
        items = np.zeros((K, n_live), np.int64)
        iss_a = np.zeros((K, n_live), bool)
        valid = np.zeros((K, n_live), bool)
        for k, node in enumerate(nodes):
            r = idx_of.get(pattern_of_steps(node.steps))
            if r is None:
                return None  # a node without its own record: malformed
            q_rec[k] = r
            q_slot[k] = ni + k
            for j in node.s_list:
                if 0 <= j < ni:
                    q_smask[k, j] = True
            for j in node.i_list:
                if 0 <= j < ni:
                    q_imask[k, j] = True
            q_nits[k] = sum(1 for _, s in node.steps if s)
            for d, (it, s) in enumerate(node.steps):
                if not 0 <= it < self.n_items:
                    return None
                items[d, k] = it
                iss_a[d, k] = s
                valid[d, k] = True
        for lo in range(0, n_live, _REFILL_GROUP):
            hi = min(n_live, lo + _REFILL_GROUP)
            recompute_rows(self.store, items[:, lo:hi], iss_a[:, lo:hi],
                           valid[:, lo:hi], list(range(ni + lo, ni + hi)),
                           self.s_local, self.n_words)

        def put(a):
            return torch.from_numpy(a).to(dev)

        return _Carry(put(q_slot), put(q_smask), put(q_imask), put(q_nits),
                      put(q_rec), put(rec_np), put(sup_np),
                      torch.tensor([0, n_live, 0, 0, len(results), 0],
                                   dtype=torch.int64, device=dev))
