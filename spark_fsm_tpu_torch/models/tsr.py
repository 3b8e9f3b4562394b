"""TSR — top-k sequential rules (TopSeqRules) on a CUDA device — port of
``spark_fsm_tpu/models/tsr.py`` (``conf_ok``, ``rule_counts_direct``,
``brute_force_rules``, ``TsrTPU`` with its host-loop and resident-frontier
routes as :class:`TsrTorch`, ``TsrCPU``, ``TsrPartitioned``,
``mine_tsr_tpu`` as :func:`mine_tsr_torch`, ``mine_tsr_cpu``,
``resident_counters``).

Semantics: a rule X ==> Y (X, Y disjoint itemsets) occurs in a sequence iff
every item of X occurs strictly before every item of Y, i.e.
max_x first(x) < min_y last(y).  sup(X=>Y) counts such sequences and
conf = sup(X=>Y) / sup(X).  The miner returns the top-k rules by support
among those with conf >= minconf, tie-inclusive, with an internal minsup
that rises as the top-k fills.

Bitmap form: with A = AND over x in X of prefix_or_incl(id-list(x)) and
C = AND over y in Y of suffix_or_incl(id-list(y)), the rule holds in a
sequence iff (shift_up_one(A) & C) != 0, and sup(X) = #sequences with
A != 0.  Each deepening round scatter-builds the top-m item rows on the
device, takes their prefix/suffix ORs once, appends the all-ones pad row,
and evaluates candidate batches with the rule-support kernel
(``ops/rule_support.py``) in launches planned by ``ops/ragged_batch.py``.

Search (host Python, copied from the reference): best-first
branch-and-bound over expansions with lazy sibling chains, dynamic-
threshold (confidence-bound) pruning, up to ``PIPELINE_DEPTH`` dispatches
in flight, and iterative deepening over the top-m items by support.  A
round routes as the reference routes it (``_resident_route``): deep mines
whose launches cost more than a wave's padding run the resident-frontier
route, where the frontier and the top-k threshold stay on the device and
the host runs waves of ``nb`` popped entries (B2 evaluates each wave); a
capacity overflow spills the intact frontier back to the host loop.

``shape_buckets`` buckets the sequence axis (:func:`tsr_geometry`) and
pads each round's token slice to a power of two, as the reference does.

With a ``mesh`` (``parallel.mesh.SeqMesh``) every rank runs the host loop
over its block of the sequence axis: a round scatter-builds only that
block of the m selected rows (the reference's ``_sharded_bitmaps``), the
prefix/suffix ORs are per-sequence, and each dispatch's ``[2, C]``
(sup, supx) counts are all-reduced (SUM) after B2 (the reference's two
``psum``s), so every rank's heap and threshold agree.  The resident route
refuses a mesh, as the reference's does, so ``resident="auto"`` and
``"always"`` both take the host loop there.

:class:`TsrPartitioned` (``partition_parts > 1``) splits the candidates
by equivalence class, ``min(X)`` (``parallel/partition.py``): each
partition seeds only its owned roots and starts its threshold at a
conservative global floor, one exchange a deepening round merges the
slices, and the exact global s_k filters the union.  Under the meshguard
(``service/meshguard.py``) every engine stamps the topology epoch at
construction and refuses a dispatch planned against an older one, and a
partition whose row dies is adopted by a survivor
(``partition.mine_on_rows``; on a world through the round's exchange).
A launch that fails otherwise raises: the reference's kernel-to-jnp
downgrades and its resident-round fallback (``_resident_abandon``) have
no counterpart, so a ``device.resident`` fault (at a segment's dispatch,
its counter readback or the round's records readback, the reference's
three points) raises out of the mine.  A device OOM on a kernel launch
is the one fault the engine absorbs, as the reference's does: the
launch re-plans at half width, down to ``RB.OOM_FLOOR_LANES``
(``RB.is_oom`` knows ``torch.cuda.OutOfMemoryError``), on the direct
path and in the fusion broker alike (``RB.launch_halving``).

The service's planes sit at the reference's sites: every engine stamps
and records its shape key (``utils/shapes.py``); with ``[fusion]`` on,
an eval wave off a mesh goes to the cross-job broker
(``service/fusion.py``) with this engine's own evaluator, B2 on the card;
host readbacks run under the dispatch watchdog, feed the cost model
(``measured_s`` is the host's wall from dispatch to readback) and
deposit usage; resident segments route through ``fusion.dispatch_wave``.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import itertools
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.data.spmf import SequenceDB
from spark_fsm_tpu_torch.data.vertical import VerticalDB, build_vertical
from spark_fsm_tpu_torch.device import DeviceLike
from spark_fsm_tpu_torch.models._common import (
    CounterReader, bucket_seq, checkpoint_due, device_hbm_budget,
    engine_device, load_checkpoint, pad_tokens_pow2, scatter_tokens,
    shard_tokens, shard_width, to_host)
from spark_fsm_tpu_torch.ops import bitops_np as Bnp
from spark_fsm_tpu_torch.ops import bitops_torch as B
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.ops import resident_frontier as RF
from spark_fsm_tpu_torch.ops import rule_support as RS
from spark_fsm_tpu_torch.parallel import partition as PN
from spark_fsm_tpu_torch.parallel.mesh import (
    all_reduce_sum, mesh_size, pad_to_multiple)
from spark_fsm_tpu_torch.service import fusion as FZ
from spark_fsm_tpu_torch.service import meshguard as MGD
from spark_fsm_tpu_torch.service import usage
from spark_fsm_tpu_torch.utils import faults, jobctl, obs, shapes, watchdog
from spark_fsm_tpu_torch.utils.canonical import RuleResult, sort_rules

# initial top-m item restriction for the iterative-deepening outer loop
ITEM_CAP_DEFAULT = 256

# transfer-pricing floor (bytes/s) for the resident round's final
# readback deadline (the reference's figure)
_RESIDENT_READBACK_FLOOR_BPS = 8e6


# Lane floor of the kernel path's launch plans: the reference kernel's
# 128-candidate output tile.  This kernel takes any candidate count and
# launches only a plan's real lanes; the floor keeps the plans equal to
# the reference's kernel path.
KERNEL_LANE = 128

# the resident-frontier counters the bench harnesses export (the
# reference's one spelling)
RESIDENT_EXPORT_KEYS = (
    "resident_rounds", "resident_segments", "resident_waves",
    "resident_deferred", "resident_spills", "resident_handoffs",
    "resident_fallbacks", "resident_readback_bytes")


def resident_counters(stats: dict) -> dict:
    """Export of the resident-frontier counters: empty unless (part of)
    the mine ran on the resident route, zero-filled otherwise."""
    if not stats.get("resident"):
        return {}
    return {k: stats.get(k, 0) for k in RESIDENT_EXPORT_KEYS}


def tsr_geometry(n_sequences: int, *, shape_buckets: bool = False,
                 mesh=None, n_words: int = 1) -> dict:
    """Static device geometry of a :class:`TsrTorch`: the sequence axis,
    bucketed by ``_common.bucket_seq`` under ``shape_buckets`` and padded
    to a multiple of a ``mesh``'s rank count; padded sequences hold
    all-zero item bitmaps and support nothing.  The reference's Pallas
    sequence block (``sb``, and ``_bucket_seq_block``, which halves it
    per km so the rows fit TPU VMEM) has no counterpart: B2 takes any
    sequence count.  ``shape_key`` is the reference's ``tsr:`` key."""
    n_seq = int(n_sequences)
    if shape_buckets:
        n_seq = bucket_seq(n_seq)
    if mesh is not None:
        n_seq = pad_to_multiple(n_seq, mesh_size(mesh))
    return {"n_seq": n_seq, "shape_key": shapes.key_tsr(n_seq, n_words)}


def conf_ok(sup: int, supx: int, minconf: float) -> bool:
    """Exact confidence test: sup/supx >= minconf (no float division)."""
    num, den = _conf_frac(minconf)
    return supx > 0 and sup * den >= supx * num


@functools.lru_cache(maxsize=64)
def _conf_frac(minconf: float) -> Tuple[int, int]:
    """minconf as an exact (numerator, denominator) for the hot-loop
    integer cross-multiply form of ``conf_ok``."""
    f = Fraction(str(minconf))
    return f.numerator, f.denominator


# ---------------------------------------------------------------------------
# Brute-force oracle (independent ground truth for tiny DBs)
# ---------------------------------------------------------------------------

def rule_counts_direct(db: SequenceDB, x_items: Tuple[int, ...],
                       y_items: Tuple[int, ...]) -> Tuple[int, int]:
    """(sup(X=>Y), sup(X)) by direct first/last-occurrence scanning."""
    sup = supx = 0
    for seq in db:
        first: dict[int, int] = {}
        last: dict[int, int] = {}
        for p, itemset in enumerate(seq):
            for it in itemset:
                first.setdefault(it, p)
                last[it] = p
        if all(x in first for x in x_items):
            supx += 1
            if all(y in last for y in y_items):
                if max(first[x] for x in x_items) < min(last[y] for y in y_items):
                    sup += 1
    return sup, supx


def brute_force_rules(db: SequenceDB, k: int, minconf: float,
                      max_side: int = 2) -> List[RuleResult]:
    """Enumerate every X, Y (sizes <= max_side, disjoint) directly."""
    items = sorted({i for seq in db for itemset in seq for i in itemset})
    qualifying: List[RuleResult] = []
    for nx in range(1, max_side + 1):
        for x in itertools.combinations(items, nx):
            rest = [i for i in items if i not in x]
            for ny in range(1, max_side + 1):
                for y in itertools.combinations(rest, ny):
                    sup, supx = rule_counts_direct(db, x, y)
                    if sup >= 1 and conf_ok(sup, supx, minconf):
                        qualifying.append((x, y, sup, supx))
    if not qualifying:
        return []
    sups = sorted((r[2] for r in qualifying), reverse=True)
    s_k = sups[k - 1] if len(sups) >= k else sups[-1]
    return sort_rules([r for r in qualifying if r[2] >= s_k])


# ---------------------------------------------------------------------------
# Device engine
# ---------------------------------------------------------------------------

class TsrTorch:
    """Batched best-first TopSeqRules over the vertical bitmap DB.

    Args:
      vdb: vertical DB (min_item_support=1 — TSR's internal minsup starts
        at 1 and rises as the top-k heap fills).
      k / minconf: the top-k size and the confidence floor.
      device: ``None`` (= CUDA, raising without it) or ``"cpu"``.
      chunk: candidates per dispatch (None = sized per deepening round).
      item_cap: initial restriction to the top-m items by support for the
        iterative-deepening outer loop.
      max_side: optional cap on |X| and |Y|.
      use_kernel: "auto" = the rule-support kernel on CUDA and the plain
        evaluator on the CPU; False = the plain evaluator on either; True
        = the kernel (raises on the CPU: the kernel has no CPU mode).
      resident: "auto" lets each round's ``_resident_route`` pick the
        resident-frontier route or the host loop as the reference's
        heuristic does; "always"/"never" (or True/False) pin it (the
        structural tests still apply to "always").
      partition: optional ``(PartitionPlan, part)``: seed only the roots
        whose class (``min(X)``) the part owns.
    """

    # dispatches kept in flight by the mine loop: each one's readback
    # overlaps the later dispatches' device work and the host heap work
    PIPELINE_DEPTH = 3

    # resident-frontier route capability; the NumPy TsrCPU opts out
    _RESIDENT_CAPABLE = True

    # shape-registry participation; the NumPy TsrCPU launches nothing
    _RECORD_SHAPES = True

    def __init__(
        self,
        vdb: VerticalDB,
        k: int,
        minconf: float,
        *,
        device: DeviceLike = None,
        mesh=None,
        chunk: Optional[int] = None,
        item_cap: int = ITEM_CAP_DEFAULT,
        max_side: Optional[int] = None,
        use_kernel="auto",
        shape_buckets: bool = False,
        resident="auto",
        partition=None,
    ):
        if partition is not None:
            plan, part = partition
            if not (0 <= int(part) < plan.n_parts):
                raise ValueError(f"partition index {part} out of range "
                                 f"for {plan.n_parts} partitions")
            partition = (plan, int(part))
        self._partition = partition
        if isinstance(resident, bool):
            resident = "always" if resident else "never"
        if resident not in ("auto", "always", "never"):
            raise ValueError(f"resident must be auto/always/never, "
                             f"got {resident!r}")
        self.resident = resident
        self._resident_caps: Optional[RF.ResidentCaps] = None
        self.device = engine_device(device, mesh)
        self.mesh = mesh
        if use_kernel == "auto":
            self.use_kernel = self.device.type == "cuda"
        elif use_kernel:
            if self.device.type != "cuda":
                raise ValueError(
                    "use_kernel=True needs a CUDA device: the rule-support "
                    "kernel has no CPU mode (use_kernel='auto' or False "
                    "runs the plain evaluator)")
            self.use_kernel = True
        else:
            self.use_kernel = False
        self.vdb = vdb
        self.k = int(k)
        self.minconf = float(minconf)
        self.item_cap = int(item_cap)
        self.max_side = max_side
        self.stats = {"evaluated": 0, "kernel_launches": 0,
                      "deepening_rounds": 0, "pruned_conf": 0,
                      "traffic_units": 0}
        self._stager = RB.XYStager()
        # budget-derived plain-evaluator width before the dispatch-
        # efficiency clamp (set by _round_chunk_plain; the per-km memory
        # caps divide this)
        self._plain_raw = 8192
        # the dense store of all items is never built: each deepening
        # round builds only the top-m item rows from the token table
        self.n_words = vdb.n_words
        self._shape_buckets = bool(shape_buckets)
        g = tsr_geometry(vdb.n_sequences, shape_buckets=self._shape_buckets,
                         mesh=mesh, n_words=self.n_words)
        self.n_seq = g["n_seq"]
        self.stats["shape_key"] = g["shape_key"]
        if self._RECORD_SHAPES:
            shapes.record(g["shape_key"])
        # this rank's block of the sequence axis (all of it without a mesh)
        self.s_local = shard_width(self.n_seq, mesh, tile=1)
        # chunk <= 0 = adaptive sizing, like None
        self._chunk_user = None if not chunk or chunk <= 0 else int(chunk)
        # the plain evaluator's device memory budget, read at first use
        self._eval_budget = None
        self.chunk = self._chunk_user or 8192
        # tok_item is nondecreasing (build_vertical emits tokens sorted by
        # item), so per-item token ranges are a searchsorted away
        self._tok_starts = np.searchsorted(
            vdb.tok_item, np.arange(vdb.n_items + 1))
        # items sorted by support desc, stable by item id
        order = np.lexsort((vdb.item_ids, -vdb.item_supports))
        self._order = order
        self._sup_sorted = vdb.item_supports[order]
        if partition is not None:
            self.stats["partition"] = partition[1]
        # the topology epoch at construction (None with the meshguard
        # off): every dispatch checks it, so a dispatch planned before a
        # row died is refused and the partitioned route rebuilds this
        # engine against the surviving rows
        self._topo_epoch = MGD.current_epoch()

    def _part_idx(self) -> Optional[int]:
        return None if self._partition is None else self._partition[1]

    def _fault_ctx(self) -> dict:
        """Chaos-site context naming this engine's partition (``part{p}``);
        empty when unpartitioned."""
        p = self._part_idx()
        return {} if p is None else {"part": f"part{p}"}

    def _owned_mask(self, m: int) -> Optional[np.ndarray]:
        """Over the round's local roots 0..m-1: True where this partition
        owns the root's class (a hash of the global item id, the same in
        every round and on every process); None when unpartitioned."""
        if self._partition is None:
            return None
        plan, part = self._partition
        return plan.owner_of(self.vdb.item_ids[self._order[:m]]) == part

    # ------------------------------------------------------------- kernels

    def _sel_tokens(self, sel: np.ndarray):
        """Token table restricted to the selected items, rows renumbered to
        0..len(sel)-1 (selection order)."""
        starts, vdb = self._tok_starts, self.vdb
        lens = starts[sel + 1] - starts[sel]
        if len(sel):
            # vectorized ragged arange: each selected item's token range
            ends = np.cumsum(lens)
            idx = (np.repeat(starts[sel], lens)
                   + np.arange(int(ends[-1])) - np.repeat(ends - lens, lens))
        else:
            idx = np.zeros(0, np.int64)
        ti = np.repeat(np.arange(len(sel), dtype=np.int32), lens)
        return ti, vdb.tok_seq[idx], vdb.tok_word[idx], vdb.tok_mask[idx]

    def _round_tokens(self, m: int):
        """The token slice of a round's top-m items, pow2-padded with
        mask-0 tokens under ``shape_buckets`` as the reference pads it;
        under a mesh only the tokens of this rank's block, with local
        sequence ids."""
        toks = self._sel_tokens(self._order[:m])
        if self.mesh is not None:
            toks = shard_tokens(*toks, self.n_seq, self.mesh)
        return pad_tokens_pow2(*toks) if self._shape_buckets else toks

    def _prep(self, m: int):
        """Prefix/suffix-OR rows of the top-m items as flat ``[m+1, S*W]``
        int32 stores with the all-ones pad row last.  The ``[m, S, W]``
        rows are scatter-built on the device from the token slice; the
        dense rows never exist on the host.  Under a mesh the rows are
        this rank's block of the sequence axis.  One ``tsr.prep`` span a
        prep, so every ``kernel_launches`` increment has its span."""
        with obs.span("tsr.prep", m=m):
            ti, ts, tw, tm = self._round_tokens(m)
            b = scatter_tokens(ti, ts, tw, tm, m, self.s_local,
                               self.n_words, self.device).view(
                                   m, self.s_local, self.n_words)
            p1 = self._with_pad(B.prefix_or_incl(b))
            s1 = self._with_pad(B.suffix_or_incl(b))
            self.stats["kernel_launches"] += 1
        return p1, s1

    def _with_pad(self, rows: torch.Tensor) -> torch.Tensor:
        m = rows.shape[0]
        out = torch.empty(m + 1, self.s_local * self.n_words,
                          dtype=torch.int32, device=self.device)
        out[:m] = rows.reshape(m, -1)
        out[m] = -1
        return out

    def _round_chunk(self, m: int) -> int:
        """Launch width for a deepening round over m items.  The kernel
        holds no ``[chunk, S, W]`` temporaries, so its width is the
        dispatch-efficiency quantum alone; the plain evaluator's is
        bounded by the memory budget too."""
        if self._chunk_user is not None:
            return self._chunk_user
        if self.use_kernel:
            return RB.dispatch_quantum_lanes(self.n_seq, self.n_words)
        return self._round_chunk_plain(m)

    def _round_chunk_plain(self, m: int) -> int:
        """Budget-derived width for the plain evaluator (the reference's
        ``_round_chunk_jnp``): what the budget allows after the round's two
        ``[m, S, W]`` stores, at four live ``[chunk, S, W]`` temporaries a
        candidate, floored to a power of two; ``S`` is one shard's under a
        mesh."""
        if self._chunk_user is not None:
            return self._chunk_user
        self._ensure_budget()
        s_local = max(1, self.n_seq // mesh_size(self.mesh))
        per_cand = max(1, s_local * self.n_words * 4 * 4)
        prep = 2 * m * s_local * self.n_words * 4
        budget = max(per_cand, self._eval_budget - prep)
        # the raw budget width is what the per-km memory caps divide; the
        # clamp below is dispatch efficiency, not memory
        self._plain_raw = max(128, RB.next_pow2(budget // per_cand + 1) // 2)
        return min(RB.dispatch_quantum_lanes(self.n_seq, self.n_words),
                   self._plain_raw)

    def _ensure_budget(self) -> int:
        """The device memory budget, read at first use."""
        if self._eval_budget is None:
            self._eval_budget = device_hbm_budget(self.device)
        return self._eval_budget

    def _plain_cap(self):
        """The plain evaluator's per-km width cap: its temporaries grow
        with km, so the budget-derived width narrows 1/km; a pinned chunk
        is honored as it is."""
        cw = self.chunk
        if self._chunk_user:
            return lambda km: cw
        return lambda km: max(32, min(cw, self._plain_raw // km))

    def _eval_fn(self, km: int):
        """The evaluator a launch at geometry ``km`` runs: B2 on the kernel
        path, the plain version otherwise (the fusion broker calls this
        too)."""
        evaluate = RS.rule_supports if self.use_kernel else RS.rule_supports_plain
        return functools.partial(evaluate, n_words=self.n_words)

    def _put(self, xy: np.ndarray) -> torch.Tensor:
        """A launch's staged ``[C, 2, km]`` candidates on the device (on
        CUDA through pinned memory, without blocking the host)."""
        t = torch.from_numpy(xy)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _dispatch_eval(self, p1, s1,
                       cands: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]):
        """Launch (sup, supx) evaluation for candidate rules (local item
        indices) and start the readback; returns the handle
        :meth:`_resolve_eval` waits on.

        Per-km pools go through the ragged planner: the kernel path's
        width cap is flat at the engine chunk; the plain evaluator's
        budget-derived cap narrows 1/km (its temporaries grow with km),
        and a pinned chunk is honored as the cap.  Each launch carries
        only its plan's real lanes.  With ``[fusion]`` on and no mesh the
        whole wave goes to the cross-job broker instead, which plans it
        with the same inputs; the ticket is the handle.  A dispatch planned
        at an older topology epoch raises ``StaleTopology`` first.

        The dispatch runs under one ``tsr.dispatch`` span; the launch
        spans nest under it, and a wave handed to the broker continues
        under ``fusion.launch``/``fusion.readback``."""
        MGD.check_epoch(self._topo_epoch)
        with obs.span("tsr.dispatch", candidates=len(cands)) as sp:
            handle = self._dispatch_eval_inner(p1, s1, cands)
            if isinstance(handle, FZ.EvalWave):
                sp.set(fusion=True)
            else:
                est_s, n_launch = handle[4], handle[6]
                sp.set(launches=n_launch, predicted_s=round(est_s, 6))
        return handle

    def _dispatch_eval_inner(self, p1, s1, cands):
        n = len(cands)
        kms = np.empty(n, np.int32)
        for r, (x, y) in enumerate(cands):
            side = max(len(x), len(y))
            km = 1
            while km < side:
                km *= 2
            kms[r] = km
        for km_v, cnt in zip(*np.unique(kms, return_counts=True)):
            key = f"evaluated_km{int(km_v)}"
            self.stats[key] = self.stats.get(key, 0) + int(cnt)
        pools: Dict[int, List[int]] = {}
        for r in range(n):
            pools.setdefault(int(kms[r]), []).append(r)
        if FZ.eval_enabled() and self.mesh is None:
            ticket = self._submit_fusion_wave(p1, s1, cands, pools)
            if ticket is not None:
                self.stats["evaluated"] += n
                return ticket
        t0 = time.monotonic()
        launches0 = self.stats["kernel_launches"]
        traffic0 = self.stats.get("traffic_units", 0)
        overhead = RB.overhead_units(self.n_seq, self.n_words)
        parts: List[torch.Tensor] = []
        cols = np.empty(n, np.int64)  # candidate r -> column of `out`
        base = 0
        xy_bufs: List[np.ndarray] = []  # recycled at readback
        if self.use_kernel:
            plan = RB.plan_launches(pools, cap=lambda km: self.chunk,
                                    lane=KERNEL_LANE, overhead=overhead,
                                    part=self._part_idx())
            for L in plan:
                base = self._dispatch_kernel_launch(p1, s1, cands, L, parts,
                                                    cols, base, xy_bufs)
        else:
            plan = RB.plan_launches(pools, cap=self._plain_cap(), lane=32,
                                    overhead=overhead, part=self._part_idx())
            fn = self._eval_fn(0)
            for L in plan:
                with obs.span("tsr.launch", point="jnp", km=L.km,
                              width=L.width,
                              predicted_s=self._launch_estimate(L)):
                    faults.fault_site("device.dispatch", point="jnp",
                                      km=str(L.km), width=str(L.width),
                                      **self._fault_ctx())
                    xy = self._stager.take(L, cands)
                    xy_bufs.append(xy)
                    parts.append(fn(p1, s1, self._put(xy[:len(L.rows)])))
                    cols[L.rows] = base + np.arange(len(L.rows))
                    base += len(L.rows)
                    self._count_launch(L)
        self.stats["evaluated"] += n
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if self.mesh is not None:
            # one reduce for the dispatch's sup and supx rows (the
            # reference psums each launch's two rows)
            out = all_reduce_sum(out.contiguous(), self.mesh)
        (host,), ev = to_host([out])
        n_launch = self.stats["kernel_launches"] - launches0
        traffic = self.stats.get("traffic_units", 0) - traffic0
        # the planner's own wall estimate: the readback's watchdog
        # deadline and the cost model's prediction
        est_s = RB.estimate_seconds(traffic, n_launch, self.n_seq,
                                    self.n_words)
        return host, cols, ev, xy_bufs, est_s, t0, n_launch, traffic

    def _dispatch_kernel_launch(self, p1, s1, cands, L, parts, cols,
                                base: int, xy_bufs) -> int:
        """Launch B2 for one planned launch; appends to ``parts``/``cols``
        and returns the advanced base.  A device OOM re-plans the launch
        at half width (``RB.launch_halving``), each halving counted in
        ``degraded_launches``; any other failure raises."""
        def launch(leaf):
            faults.fault_site("device.dispatch", point="kernel",
                              km=str(leaf.km), width=str(leaf.width),
                              **self._fault_ctx())
            faults.fault_site("device.oom", point="kernel",
                              km=str(leaf.km), width=str(leaf.width))
            xy = self._stager.take(leaf, cands)
            return xy, RS.rule_supports(p1, s1,
                                        self._put(xy[:len(leaf.rows)]),
                                        self.n_words)

        for leaf, (xy, part) in RB.launch_halving(
                L, launch,
                span=lambda leaf: obs.span(
                    "tsr.launch", point="kernel", km=leaf.km,
                    width=leaf.width,
                    predicted_s=self._launch_estimate(leaf)),
                on_halve=self._count_halving):
            xy_bufs.append(xy)
            self._count_launch(leaf)
            cols[leaf.rows] = base + np.arange(len(leaf.rows))
            parts.append(part)
            base += len(leaf.rows)
        return base

    def _launch_estimate(self, L) -> float:
        """The planner's wall estimate of one launch, rounded for its
        span."""
        return round(RB.estimate_seconds(L.traffic_units, 1, self.n_seq,
                                         self.n_words), 6)

    def _count_halving(self, L) -> None:
        self.stats["degraded_launches"] = (
            self.stats.get("degraded_launches", 0) + 1)

    def _submit_fusion_wave(self, p1, s1, cands, pools):
        """Hand one dispatch's candidate wave to the cross-job broker with
        this engine's own planner inputs (kernel path: flat cap at the
        chunk, the kernel lane, B2; plain path: the budget cap, lane 32,
        the plain version), so a wave that finds no peer launches what
        the direct path would have.  None when the broker declined."""
        if self.use_kernel:
            cw = self.chunk
            cap, lane = (lambda km: cw), KERNEL_LANE
        else:
            cap, lane = self._plain_cap(), 32
        return FZ.submit_eval(
            cands=cands, pools=pools, p1=p1, s1=s1, eval_fn=self._eval_fn,
            put=self._put, cap=cap, lane=lane, n_seq=self.n_seq,
            n_words=self.n_words,
            point="kernel" if self.use_kernel else "jnp")

    def _count_launch(self, L) -> None:
        """Per-launch accounting: geometry-keyed fill counters, the
        planner's traffic units, super-batch and borrow counts, the
        launches of each partition and the launch's shape key."""
        self.stats["kernel_launches"] += 1
        lk, wk = f"launches_km{L.km}", f"width_km{L.km}"
        self.stats[lk] = self.stats.get(lk, 0) + 1
        self.stats[wk] = self.stats.get(wk, 0) + L.width
        self.stats["traffic_units"] = (
            self.stats.get("traffic_units", 0) + L.traffic_units)
        borrowed = L.borrowed
        if borrowed:
            bk = f"borrowed_km{L.km}"
            self.stats[bk] = self.stats.get(bk, 0) + borrowed
        if L.mixed:
            self.stats["superbatches"] = (
                self.stats.get("superbatches", 0) + 1)
        if L.part is not None:
            # per-partition dispatch accounting (the scaling split)
            pk = f"launches_part{L.part}"
            self.stats[pk] = self.stats.get(pk, 0) + 1
        if self._RECORD_SHAPES:
            shapes.record(shapes.key_tsr_eval(
                self.n_seq, self.n_words, L.km, L.width))

    @staticmethod
    def _bill_readback(nbytes: int) -> None:
        """Attribute a readback's bytes to the current job (no-op when
        the usage plane is off)."""
        if usage.get() is not None:
            ctl = jobctl.current()
            if ctl is not None:
                usage.deposit(ctl.uid, readback_bytes=int(nbytes))

    def _resolve_eval(self, handle):
        """Wait for one dispatch's readback and return (sups, supxs) in
        candidate order.  A broker ticket blocks on the broker's result
        (its launches land in ``fusion_*`` stats, not in this engine's
        ``kernel_launches``: a fused launch is shared work).  A direct
        handle waits on its CUDA event under the dispatch watchdog, feeds
        the cost model, deposits usage and recycles its staging
        buffers."""
        if isinstance(handle, FZ.EvalWave):
            sups, supxs, report = handle.result()
            self.stats["fusion_waves"] = self.stats.get("fusion_waves", 0) + 1
            if report.get("fused_jobs", 1) > 1:
                self.stats["fusion_fused_waves"] = (
                    self.stats.get("fusion_fused_waves", 0) + 1)
            self.stats["fusion_launches"] = (
                self.stats.get("fusion_launches", 0)
                + report.get("launches", 0))
            if report.get("degraded_launches"):
                self.stats["degraded_launches"] = (
                    self.stats.get("degraded_launches", 0)
                    + report["degraded_launches"])
            return sups, supxs
        out, cols, ev, xy_bufs, est_s, t0, n_launch, traffic = handle

        def read():
            faults.fault_site("device.dispatch", point="readback",
                              **self._fault_ctx())
            if ev is not None:
                ev.synchronize()
            return out.numpy()

        with obs.span("tsr.readback", predicted_s=round(est_s, 6)) as sp:
            arr = watchdog.run_with_deadline(
                read, watchdog.deadline_s(est_s), site="tsr.readback")
            measured_s = time.monotonic() - t0
            sp.set(measured_s=round(measured_s, 6))
            obs.observe_costmodel(est_s, measured_s, family="tsr-eval")
        if usage.get() is not None:
            ctl = jobctl.current()
            if ctl is not None:
                usage.deposit(ctl.uid, launches=int(n_launch),
                              traffic_units=int(traffic), seconds_est=est_s,
                              seconds_measured=measured_s,
                              readback_bytes=int(arr.nbytes))
        self._stager.release(xy_bufs)
        return arr[0, cols].astype(np.int64), arr[1, cols].astype(np.int64)

    # --------------------------------------------------------- checkpoints

    def frontier_fingerprint(self) -> dict:
        """Identity a frontier checkpoint binds to — the reference engine's
        exact fields, so snapshots interchange: queue entries hold
        support-order local item indices, which are only meaningful for the
        exact same (vdb, k, minconf, max_side)."""
        ids = self.vdb.item_ids
        return {
            "algo": "tsr",
            "stack_format": 3,  # 3 = sibling-chain entries + psupx
            "k": self.k,
            "minconf": float(self.minconf),
            "max_side": self.max_side,
            "n_items": int(self.vdb.n_items),
            "n_sequences": int(self.vdb.n_sequences),
            "item_ids_head": [int(i) for i in ids[:8]],
            "item_ids_sum": int(ids.astype(np.int64).sum()),
        }

    def frontier_state(self, queue, results, m: int, minsup: int) -> dict:
        """JSON-able snapshot of a paused best-first round, field for field
        the reference's.  A round's accepted-rule set shrinks when the
        internal minsup rises, so every snapshot carries the full current
        set (``results_done=0``); bound-pruned queue entries are dropped."""
        return {
            "version": 1,
            "fingerprint": self.frontier_fingerprint(),
            "m": int(m),
            "minsup": int(minsup),
            "stack": [[int(-nb), [int(i) for i in x], [int(j) for j in y],
                       bool(cr), int(side), int(psup), int(psupx)]
                      for nb, x, y, cr, side, psup, psupx in queue
                      if -nb >= minsup],
            "results_done": 0,
            "results": [[[int(i) for i in x], [int(j) for j in y],
                         int(sup), int(supx)]
                        for sup, supx, x, y in results],
        }

    # ---------------------------------------------------------------- mine

    def _mine_restricted(self, m: int, resume: Optional[dict] = None,
                         checkpoint_cb=None, every_s: float = 30.0,
                         floor: int = 1) -> Tuple[List[RuleResult], int]:
        """One deepening round over the top-m items; returns (results,
        s_k).  Routes the round as the reference does: the resident-
        frontier route when :meth:`_resident_route` picks it, else the
        host loop.  The resident route spills back to the host loop on a
        capacity overflow, so the choice never changes the answer.

        ``floor``: the initial minsup, the partitioned route's
        conservative global top-k floor (``partition.ThresholdBoard``), a
        lower bound on the global s_k; 1 is the whole-frontier search."""
        self.chunk = self._round_chunk(m)
        if self._resident_route(m):
            return self._mine_resident(m, resume=resume,
                                       checkpoint_cb=checkpoint_cb,
                                       every_s=every_s, floor=floor)
        return self._mine_host_restricted(m, resume=resume,
                                          checkpoint_cb=checkpoint_cb,
                                          every_s=every_s, floor=floor)

    def _resident_route(self, m: int) -> bool:
        """Should this round run on the resident-frontier route?  The
        reference's test as written: never on a mesh (the resident waves
        have no collective).  Structural eligibility, which
        applies to ``resident="always"`` too: k within the on-device top-k
        buffer, exact-conf products within int32, and caps that fit the
        budget.  The ``auto`` heuristic on top: only deep mines (sides
        unlimited or above 2), and only when one saved dispatch is worth at
        least a wave of km-ladder padding (``overhead_units >= nb``)."""
        if not self._RESIDENT_CAPABLE or self.resident == "never":
            return False
        if self.mesh is not None:
            return False
        if self.k > RF.K_PAD:
            return False
        num, den = _conf_frac(self.minconf)
        if max(num, den) * (self.n_seq + 1) >= 2 ** 31:
            return False  # the device conf test multiplies in int32
        if self.resident != "always" and not (
                self.max_side is None or self.max_side > 2):
            return False
        caps = RF.caps_for(self.n_seq, self.n_words, m,
                           self._ensure_budget())
        if caps is None or m > caps.ring:
            return False
        if (self.resident != "always"
                and RB.overhead_units(self.n_seq, self.n_words) < caps.nb):
            return False
        self._resident_caps = caps
        return True

    # ------------------------------------------------- resident route

    def _mine_resident(self, m: int, resume: Optional[dict],
                       checkpoint_cb, every_s: float, floor: int = 1,
                       ) -> Tuple[List[RuleResult], int]:
        """One deepening round on the resident-frontier route: the
        frontier, the antecedent supports and the top-k threshold stay on
        the device, and the host runs waves (``RF.wave``) in segments,
        reading the 10 counters after each wave.  A segment is the
        reference's one ``while_loop`` dispatch: waves while the frontier
        is non-empty, nothing overflowed and the segment's wave budget
        lasts (256, growing x4 to 4,096; 1 when checkpointing).  The
        wide-to-narrow switch and the checkpoints happen only at segment
        boundaries, as in the reference, so every counter equals its.

        A capacity overflow commits nothing on the device: the intact
        frontier spills into the host loop's own resume format.  Deferred
        over-ladder children that survive the round's final threshold
        hand off to the host loop the same way."""
        caps = self._resident_caps
        num, den = _conf_frac(self.minconf)
        max_side_t = self.max_side if self.max_side is not None else 1 << 30
        sup_l = self._sup_sorted[:m].astype(np.int64).tolist()
        if resume is not None:
            minsup = max(int(resume["minsup"]), int(floor))
            results0 = [(int(sup), int(supx), tuple(x), tuple(y))
                        for x, y, sup, supx in resume["results"]
                        if int(sup) >= minsup]
            entries = [(int(b), tuple(x), tuple(y), bool(cr), int(side),
                        int(psup), int(psupx))
                       for b, x, y, cr, side, psup, psupx in resume["stack"]]
            self.stats["resumed_nodes"] = len(entries)
        else:
            minsup = max(1, int(floor))
            results0 = []
            entries = RF.root_entries(sup_l, minsup, num, den, self.max_side)
            own = self._owned_mask(m)
            if own is not None:
                # only the owned classes' root chains: every descendant
                # keeps min(X) = its root, so the slice stays owned
                entries = [e for e in entries if own[e[1][0]]]
        state = RF.pack_state(entries, results0, caps)
        if state is None:
            # the resumed frontier outgrows the caps: the host loop
            return self._mine_host_restricted(
                m, resume=resume, checkpoint_cb=checkpoint_cb,
                every_s=every_s, floor=floor)
        self.stats["resident"] = True
        self.stats["resident_rounds"] = (
            self.stats.get("resident_rounds", 0) + 1)
        keys = RF.resident_keys(self.n_seq, self.n_words, m, caps)
        if self._RECORD_SHAPES:
            shapes.record(keys[0])
        p1, s1 = self._prep(m)
        sup_items = torch.from_numpy(
            np.asarray(sup_l, np.int32)).to(self.device)
        carry = RF.carry_from_state(state, minsup, self.device)
        evaluate = RS.rule_supports if self.use_kernel else RS.rule_supports_plain
        reader = CounterReader(len(RF.COUNTERS), self.device)
        # the counters as the carry starts them (RF.COUNTERS)
        n_rec, n_def = state["n_results"], state["n_defer"]
        head, tail, oflow, waves = 0, state["n_entries"], 0, 0
        evaluated = pruned = 0
        narrow = caps.nb_late < caps.nb and tail <= caps.nb_late
        if narrow and self._RECORD_SHAPES:
            shapes.record(keys[-1])
        narrow_recorded = narrow
        # segment budget: fine-grained when checkpointing (the first
        # snapshot lands after wave 1), coarse otherwise
        budget = 1 if checkpoint_cb is not None else 256
        last_ckpt = time.monotonic()
        waves_done = ev_done = pr_done = 0
        ctr = (n_rec, oflow, waves, head, tail, minsup, evaluated, pruned,
               0, n_def)

        def segment(nbw: int, wave_end: int, deadline):
            """Waves until the frontier empties, a cap overflows or the
            segment's wave budget is spent; each counter read runs under
            the watchdog.  Returns the last counters."""
            def read():
                faults.fault_site("device.resident", point="readback")
                return reader.read(carry.ctr)

            c = ctr
            while c[4] > c[3] and not c[1] and c[2] < wave_end:
                RF.wave(carry, p1, s1, sup_items, num, den, self.k,
                        max_side_t, nbw, self.n_words, evaluate)
                c = watchdog.run_with_deadline(read, deadline,
                                               site="tsr.resident")
            return c

        while True:
            # deadline/cancel safe point between segments (a host-side
            # check, no device sync)
            jobctl.check_shared(self.mesh)
            nbw = caps.nb_late if narrow else caps.nb
            # watchdog ceiling from the cost model: the segment streams
            # at most budget x nbw x km lane-units
            bound_s = RB.estimate_seconds(budget * nbw * caps.km, 1,
                                          self.n_seq, self.n_words)
            deadline = watchdog.deadline_s(bound_s)
            t_seg = time.monotonic()
            with obs.span("tsr.resident", point="segment", nb=nbw,
                          budget=budget, narrow=narrow,
                          bound_s=round(bound_s, 6)):
                faults.fault_site("device.resident", point="segment",
                                  nb=str(nbw))
                # a segment carries this round's device state: it never
                # waits in a fusion window (dispatch_wave is the broker's
                # accounting and fault surface only)
                ctr = FZ.dispatch_wave(
                    "tsr_resident",
                    functools.partial(segment, nbw, waves_done + budget,
                                      deadline),
                    point="resident_segment")
            (n_rec, oflow, waves, head, tail, minsup, evaluated,
             pruned, _n_acc, n_def) = ctr
            self.stats["kernel_launches"] += 1  # one segment
            RF.count_segment(waves - waves_done)
            self.stats["resident_segments"] = (
                self.stats.get("resident_segments", 0) + 1)
            self.stats["resident_waves"] = (
                self.stats.get("resident_waves", 0) + waves - waves_done)
            seg_traffic = (waves - waves_done) * nbw * caps.km
            self.stats["traffic_units"] = (
                self.stats.get("traffic_units", 0) + seg_traffic)
            # one owning job per segment; its residual feeds the
            # tsr-resident family gauge only
            seg_wall = time.monotonic() - t_seg
            seg_est = RB.estimate_seconds(seg_traffic, 1, self.n_seq,
                                          self.n_words)
            obs.observe_costmodel_family("tsr-resident", seg_est, seg_wall)
            if usage.get() is not None:
                ctl = jobctl.current()
                if ctl is not None:
                    usage.deposit(ctl.uid, launches=1,
                                  traffic_units=seg_traffic,
                                  seconds_est=seg_est,
                                  seconds_measured=seg_wall,
                                  readback_bytes=8 * len(RF.COUNTERS)
                                  * (waves - waves_done))
            self.stats["evaluated"] += evaluated - ev_done
            self.stats["pruned_conf"] += pruned - pr_done
            waves_done, ev_done, pr_done = waves, evaluated, pruned
            budget = min(4096, budget * 4)
            pending = tail > head
            if oflow or (pending and waves >= caps.i_max):
                self._resident_wait(reader)
                return self._resident_spill(
                    m, carry, head, tail, n_rec, n_def, minsup,
                    checkpoint_cb=checkpoint_cb, every_s=every_s,
                    prep=(p1, s1))
            if not pending:
                break
            if not narrow and caps.nb_late < caps.nb and (
                    tail - head) <= caps.nb_late:
                narrow = True  # the late-wave switch, never switched back
                if not narrow_recorded and self._RECORD_SHAPES:
                    shapes.record(keys[-1])
                    narrow_recorded = True
            if checkpoint_due(checkpoint_cb, last_ckpt, every_s, self.mesh):
                checkpoint_cb(self._resident_snapshot(
                    m, carry, head, tail, n_rec, n_def, minsup))
                self.stats["checkpoints"] = (
                    self.stats.get("checkpoints", 0) + 1)
                last_ckpt = time.monotonic()
        self._resident_wait(reader)
        # the final readback: the records, and the deferred children when
        # there are any; its deadline prices the buffers' bytes at a
        # conservative transfer floor plus a second of latency
        names = RF.RECORD_FIELDS + (RF.DEFER_FIELDS if n_def else ())
        rb_est_s = 1.0 + (carry.nbytes(names)
                          / _RESIDENT_READBACK_FLOOR_BPS)
        with obs.span("tsr.resident", point="readback", records=n_rec,
                      deferred=n_def, bound_s=round(rb_est_s, 6)):
            def read_records():
                faults.fault_site("device.resident", point="records")
                return carry.arrays(names)

            arrs = watchdog.run_with_deadline(
                read_records, watchdog.deadline_s(rb_est_s),
                site="tsr.resident")
        self._count_readback(arrs)
        results = RF.unpack_results(*arrs[:3], n_rec, minsup)
        if n_def:
            # over-ladder children filtered against the final exact top-k
            # threshold; survivors are deep-side work the host loop
            # finishes (a handoff: the in-ladder search completed)
            RF.count_deferred(n_def)
            self.stats["resident_deferred"] = (
                self.stats.get("resident_deferred", 0) + n_def)
            deep = RF.unpack_entries(*arrs[3:], 0, n_def, minsup)
            if deep:
                RF.count_handoff()
                self.stats["resident_handoffs"] = (
                    self.stats.get("resident_handoffs", 0) + 1)
                return self._mine_host_restricted(
                    m, resume=_resume_dict(minsup, deep, results),
                    checkpoint_cb=checkpoint_cb, every_s=every_s,
                    count_resume=False, prep=(p1, s1))
        return self._finish_round(m, results)

    def _resident_wait(self, reader: CounterReader) -> None:
        self.stats["wait_s"] = self.stats.get("wait_s", 0.0) + reader.wait_s

    def _count_readback(self, arrs: List[np.ndarray]) -> None:
        nbytes = sum(a.nbytes for a in arrs)
        RF.count_readback(nbytes)
        self.stats["resident_readback_bytes"] = (
            self.stats.get("resident_readback_bytes", 0) + nbytes)
        self._bill_readback(nbytes)

    def _resident_entries(self, carry: RF.Carry, head: int, tail: int,
                          n_rec: int, n_def: int, minsup: int):
        """Read the device frontier, records and deferred children back
        into host tuples (the spill and the snapshot share this path)."""
        arrs = carry.arrays(RF.RING_FIELDS + RF.RECORD_FIELDS)
        darrs = carry.arrays(RF.DEFER_FIELDS) if n_def else []
        self._count_readback(arrs + darrs)
        entries = RF.unpack_entries(*arrs[:6], head, tail, minsup)
        if n_def:
            entries += RF.unpack_entries(*darrs, 0, n_def, minsup)
        results = RF.unpack_results(*arrs[6:], n_rec, minsup)
        return entries, results

    def _resident_spill(self, m: int, carry: RF.Carry, head: int, tail: int,
                        n_rec: int, n_def: int, minsup: int, *,
                        checkpoint_cb, every_s: float,
                        prep=None) -> Tuple[List[RuleResult], int]:
        """Overflow-to-host spill: the intact device frontier becomes the
        host loop's own resume state, so no candidate is lost or
        duplicated."""
        entries, results = self._resident_entries(carry, head, tail,
                                                  n_rec, n_def, minsup)
        RF.count_spill("capacity")
        self.stats["resident_spills"] = (
            self.stats.get("resident_spills", 0) + 1)
        return self._mine_host_restricted(
            m, resume=_resume_dict(minsup, entries, results),
            checkpoint_cb=checkpoint_cb, every_s=every_s,
            count_resume=False, prep=prep)

    def _resident_snapshot(self, m: int, carry: RF.Carry, head: int,
                           tail: int, n_rec: int, n_def: int,
                           minsup: int) -> dict:
        """Segment-boundary snapshot in the one checkpoint format
        (``frontier_state``): it resumes on either route of either
        package."""
        entries, results = self._resident_entries(carry, head, tail,
                                                  n_rec, n_def, minsup)
        queue = [(-b, x, y, cr, side, psup, psupx)
                 for b, x, y, cr, side, psup, psupx in entries]
        return self.frontier_state(queue, results, m, minsup)

    def _finish_round(self, m: int, results: List[tuple],
                      ) -> Tuple[List[RuleResult], int]:
        """The exact end-of-round filter: s_k = k-th largest accepted
        support, results filtered to >= s_k, local indices mapped to
        canonical item ids."""
        sups = sorted((r[0] for r in results), reverse=True)
        s_k = sups[self.k - 1] if len(sups) >= self.k else 1
        ids = self.vdb.item_ids[self._order[:m]]
        out = [
            (tuple(sorted(int(ids[i]) for i in x)),
             tuple(sorted(int(ids[i]) for i in y)), sup, supx)
            for sup, supx, x, y in results if sup >= s_k
        ]
        return sort_rules(out), s_k

    # ----------------------------------------------------- host route

    def _mine_host_restricted(self, m: int, resume: Optional[dict] = None,
                              checkpoint_cb=None, every_s: float = 30.0,
                              count_resume: bool = True, prep=None,
                              floor: int = 1,
                              ) -> Tuple[List[RuleResult], int]:
        """One deepening round on the host loop: best-first heap on the
        host, ragged super-batched eval dispatches on the device.  Returns
        (results, s_k).

        ``count_resume=False``: ``resume`` is an internal continuation (a
        resident spill or handoff), not a persisted checkpoint, so
        ``resumed_nodes`` is left as it is.  ``prep``: the resident
        round's live ``(p1, s1)``, reused instead of built again.
        ``floor``: the initial minsup (see :meth:`_mine_restricted`)."""
        sup_it = self._sup_sorted[:m].astype(np.int64)
        p1, s1 = prep if prep is not None else self._prep(m)
        ids = self.vdb.item_ids[self._order[:m]]

        results: List[Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]] = []
        # the partitioned route's conservative global floor is a sound
        # initial threshold (it never exceeds the global s_k)
        floor = max(1, int(floor))
        minsup = floor
        sup_sorted: List[int] = []  # ascending supports of accepted rules
        # conf test as exact integer cross-multiply: sup/supx >= num/den —
        # shared by acceptance AND the conf-bound pruning below
        num, den = _conf_frac(self.minconf)

        def s_k_threshold() -> int:
            if len(sup_sorted) < self.k:
                return floor
            return sup_sorted[-self.k]

        # queue: (-bound, X, Y, can_right, side, psup, psupx); X/Y are
        # local index tuples.  Entries are totally ordered by the tuples
        # themselves, and the final rule set is pop-order independent (the
        # end-of-round s_k filter is exact), so tie order is free to vary.
        #
        # Expansion is lazy ("sibling chains"): a popped entry re-pushes
        # only its next sibling — the same-parent candidate whose variable
        # item (the last of the `side` tuple, 0 = X, 1 = Y) is the next
        # admissible index.  Items are support-sorted, so sibling bounds
        # min(psup, sup[c]) are nonincreasing in c: best-first order is
        # preserved exactly, and a sibling whose bound drops below minsup
        # kills the whole remaining chain.
        #
        # ``psupx`` is the exact antecedent support sup(X) for side-1
        # (grow-Y) entries — X is fixed along a right chain — and 0 for
        # side-0 entries.  It feeds the dynamic-threshold pruning: a
        # right-expansion candidate with bound*den < supx*num can never
        # pass the confidence floor, and when its X can never grow again
        # the whole right-growing subtree is dead and never evaluated.
        sup_l = sup_it.tolist()

        # sup_it is sorted descending, so "items with sup >= minsup" is the
        # prefix [0, jcut)
        def item_cut() -> int:
            return int(np.searchsorted(-sup_it, -minsup, side="right"))

        jcut = item_cut()
        queue: list = []
        push = heapq.heappush

        def chain_push(xf, yf, cr, side, psup, psupx, start):
            """Push the chain entry whose variable item is the first
            admissible index >= start (xf/yf are the fixed side contents).
            Admissible = not already used in the rule and bound >= minsup;
            bounds are nonincreasing along the chain, so a failing bound
            ends it for good.  When the antecedent can never grow again, a
            side-1 chain whose bound drops below the confidence floor is
            dead in full, so it ends here too."""
            fixed = set(xf) | set(yf)
            c = start
            while True:
                if c >= jcut:
                    return
                if c not in fixed:
                    s_c = sup_l[c]
                    b = s_c if s_c < psup else psup
                    if b < minsup:
                        return
                    if (side == 1 and psupx > 0 and b * den < psupx * num
                            and self.max_side is not None
                            and len(xf) >= self.max_side):
                        self.stats["pruned_conf_chains"] = (
                            self.stats.get("pruned_conf_chains", 0) + 1)
                        return
                    break
                c += 1
            if side == 0:
                push(queue, (-b, xf + (c,), yf, cr, 0, psup, 0))
            else:
                push(queue, (-b, xf, yf + (c,), cr, 1, psup, psupx))

        if resume is not None:
            minsup = max(int(resume["minsup"]), floor)
            results = [(int(sup), int(supx), tuple(x), tuple(y))
                       for x, y, sup, supx in resume["results"]
                       if int(sup) >= minsup]
            sup_sorted = sorted(r[0] for r in results)
            jcut = item_cut()
            queue = [(-int(b), tuple(x), tuple(y), bool(cr), int(side),
                      int(psup), int(psupx))
                     for b, x, y, cr, side, psup, psupx in resume["stack"]]
            heapq.heapify(queue)
            if count_resume:
                self.stats["resumed_nodes"] = len(queue)
        else:
            # roots: one right-side chain per item i over partners j != i;
            # X = {i} is fixed, so psupx = sup(i) exactly.  A partition
            # seeds only its owned classes' roots
            own = self._owned_mask(m)
            for i in range(m):
                if own is not None and not own[i]:
                    continue
                chain_push((i,), (), True, 1, sup_l[i], sup_l[i], 0)

        def left_viable(x, y):
            """Can the antecedent still grow into an above-threshold
            candidate?  Left expansion adds an admissible index > max(X);
            below jcut every item clears minsup, so viability is just 'an
            unused index remains'.  When this is False it is False for
            every right descendant as well, which makes whole-subtree conf
            pruning sound."""
            if self.max_side is not None and len(x) >= self.max_side:
                return False
            fixed = set(x) | set(y)
            c = max(x) + 1
            while c < jcut:
                if c not in fixed:
                    return True
                c += 1
            return False

        def pop_batch():
            batch = []
            while queue and len(batch) < self.chunk:
                nb, x, y, cr, side, psup, psupx = queue[0]
                if -nb < minsup:
                    # every remaining entry is bound-pruned, and chain
                    # siblings bound even lower (minsup only rises)
                    queue.clear()
                    break
                heapq.heappop(queue)
                # advance this entry's sibling chain before evaluating it
                if side == 0:
                    chain_push(x[:-1], y, cr, 0, psup, 0, x[-1] + 1)
                else:
                    chain_push(x, y[:-1], cr, 1, psup, psupx, y[-1] + 1)
                # dynamic-threshold pruning: side-1 entries carry the exact
                # antecedent support, so sup <= bound < minconf * supx
                # proves this rule can never be accepted; if the antecedent
                # can also never grow again, the whole subtree is dead.  A
                # conf-dead candidate whose X can still grow is evaluated
                # normally: its exact sup keeps child bounds tight.
                if (side == 1 and psupx > 0
                        and (-nb) * den < psupx * num
                        and not left_viable(x, y)):
                    self.stats["pruned_conf"] += 1
                    continue
                batch.append((x, y, cr))
            return batch

        def consume(batch, handle):
            nonlocal minsup, results, jcut
            sups, supxs = self._resolve_eval(handle)
            for (x, y, can_right), sup, supx in zip(
                    batch, sups.tolist(), supxs.tolist()):
                if sup < minsup:
                    continue
                if supx > 0 and sup * den >= supx * num:
                    results.append((sup, supx, x, y))
                    bisect.insort(sup_sorted, sup)
                    new_t = s_k_threshold()
                    if new_t > minsup:
                        minsup = new_t
                        results = [r for r in results if r[0] >= minsup]
                        del sup_sorted[: bisect.bisect_left(sup_sorted, minsup)]
                        jcut = item_cut()
                # expansions: one left chain (grow X; kills further right
                # expansion) and one right chain (grow Y), which inherits
                # this rule's exact supx
                if self.max_side is None or len(x) < self.max_side:
                    chain_push(x, y, False, 0, sup, 0, max(x) + 1)
                if can_right and (self.max_side is None or len(y) < self.max_side):
                    chain_push(x, y, True, 1, sup, supx, max(y) + 1)

        # Pipeline: keep PIPELINE_DEPTH batches in flight.  Candidates
        # dispatched with a stale (lower) minsup are wasted work at worst,
        # never wrong — acceptance and the final s_k filter are exact.
        inflight: List[Tuple[list, object]] = []
        last_ckpt = time.monotonic()
        while True:
            # deadline/cancel safe point between launches
            jobctl.check_shared(self.mesh)
            while queue and len(inflight) < self.PIPELINE_DEPTH:
                batch = pop_batch()
                if not batch:
                    break
                handle = self._dispatch_eval(
                    p1, s1, [(x, y) for x, y, _ in batch])
                inflight.append((batch, handle))
            if not inflight:
                break
            consume(*inflight.pop(0))
            if checkpoint_due(checkpoint_cb, last_ckpt, every_s, self.mesh):
                while inflight:  # drain for a consistent frontier
                    consume(*inflight.pop(0))
                checkpoint_cb(self.frontier_state(queue, results, m, minsup))
                self.stats["checkpoints"] = self.stats.get("checkpoints", 0) + 1
                last_ckpt = time.monotonic()

        s_k = s_k_threshold()
        # local indices are support-ordered; canonical form sorts by item id
        out = [
            (tuple(sorted(int(ids[i]) for i in x)),
             tuple(sorted(int(ids[i]) for i in y)), sup, supx)
            for sup, supx, x, y in results
        ]
        return sort_rules(out), s_k

    def mine(self, *, resume: Optional[dict] = None, checkpoint_cb=None,
             checkpoint_every_s: float = 30.0) -> List[RuleResult]:
        """Run the top-k search; optionally resumable.

        ``resume`` is a ``frontier_state`` snapshot from either package
        (its fingerprint must match, ValueError otherwise);
        ``checkpoint_cb`` is called with a snapshot at most every
        ``checkpoint_every_s`` seconds, after draining the in-flight
        pipeline.  A resumed mine restarts at the snapshot's deepening
        round m — earlier (completed) rounds are never replayed.
        """
        if resume is not None:
            fp = resume.get("fingerprint")
            if fp != self.frontier_fingerprint():
                raise ValueError(
                    "frontier checkpoint does not match this engine's "
                    f"(vdb, k, minconf, max_side); checkpointed {fp}, "
                    f"engine {self.frontier_fingerprint()}")
        n_total = self.vdb.n_items
        if resume is not None:
            m = max(1, min(int(resume["m"]), n_total))
        else:
            m = max(1, min(self.item_cap, n_total))
        while True:
            self.stats["deepening_rounds"] += 1
            results, s_k = self._mine_restricted(
                m, resume=resume, checkpoint_cb=checkpoint_cb,
                every_s=checkpoint_every_s)
            resume = None  # only the first (snapshot's) round resumes
            if m >= n_total:
                return results
            next_item_sup = int(self._sup_sorted[m])
            if len(results) >= self.k and next_item_sup < s_k:
                return results
            m = min(m * 2, n_total)


class TsrCPU(TsrTorch):
    """CPU TopSeqRules: the same best-first search and iterative deepening,
    with the bitmap evaluation in NumPy (``ops/bitops_np``), one candidate
    at a time.  An oracle independent of torch and of the kernel."""

    PIPELINE_DEPTH = 1  # dispatch is synchronous — nothing to overlap
    _RESIDENT_CAPABLE = False  # numpy evaluation: no device frontier
    _RECORD_SHAPES = False  # launches nothing on a device

    def __init__(self, *args, **kwargs):
        kwargs["device"] = "cpu"
        kwargs["use_kernel"] = False
        super().__init__(*args, **kwargs)

    def _round_chunk(self, m: int) -> int:
        # the batch granularity of the host loop only
        return self._chunk_user or 8192

    def _prep(self, m: int):
        ti, ts, tw, tm = self._round_tokens(m)
        bm = np.zeros((m, self.n_seq, self.n_words), np.uint32)
        np.add.at(bm, (ti, ts, tw), tm)  # distinct bits: add == OR
        return Bnp.prefix_or_incl(bm), Bnp.suffix_or_incl(bm)

    def _dispatch_eval(self, p1, s1, cands):
        n = len(cands)
        sup = np.empty(n, np.int64)
        supx = np.empty(n, np.int64)
        for r, (x, y) in enumerate(cands):
            a = p1[x[0]]
            for i in x[1:]:
                a = a & p1[i]
            c = s1[y[0]]
            for j in y[1:]:
                c = c & s1[j]
            sup[r] = int(Bnp.support(Bnp.shift_up_one(a) & c))
            supx[r] = int(Bnp.support(a))
        self.stats["evaluated"] += n
        return sup, supx

    def _resolve_eval(self, handle):
        return handle


class TsrPartitioned:
    """Equivalence-class partitioned TSR (the reference's
    ``TsrPartitioned``).

    The candidates split by class, ``min(X)`` (invariant under both
    expansions): each partition's engine seeds only its owned roots, on
    its own row of a mesh (``partition.submeshes``) or, without a mesh,
    in turn on the one device.  Each deepening round every owned
    partition mines its slice from the board's conservative global floor
    (a lower bound on the global s_k, so nothing it prunes could enter
    the global top-k), then ONE exchange merges the slices and the
    floors; the exact global s_k over the union restores the unpartitioned
    mine's output byte for byte.  Partition-local thresholds rise more
    slowly than the global one, so this evaluates more candidates than
    the whole-frontier search for the same output.

    Checkpoints are composite (``partition.composite_state``): the merged
    rows plus the active partition's frontier in the engine's own
    ``frontier_state`` format, with the round's ``m`` and floor, bound to
    the plan's fingerprint.  Under the meshguard each owned row registers
    its device for the guard's probe, and a partition whose row dies
    resumes on its adopter from its last frontier snapshot with the
    floor carried over (``partition.mine_on_rows``): without a mesh at
    once, on a world after the round's exchange, with a second exchange
    for the adopted rows (``partition.finish_round``, which also makes
    every rank raise together when a row fails otherwise); a dead row's
    parts stay on their adopter for the later rounds.
    ``record_metrics=False`` keeps a warm-up mine out of the
    ``fsm_partition_*`` families (prewarm's)."""

    def __init__(self, vdb: VerticalDB, k: int, minconf: float, *,
                 device: DeviceLike = None, mesh=None, parts: int,
                 classes: int = 64, record_metrics: bool = True,
                 **engine_kwargs):
        self.vdb = vdb
        self.k = int(k)
        self.minconf = float(minconf)
        self._record = bool(record_metrics)
        self.plan = PN.plan_partitions(vdb.item_ids, vdb.item_supports,
                                       parts, classes, record=self._record)
        self.mesh = mesh
        self.meshes = PN.submeshes(mesh, parts)
        self.owned = PN.owned_parts(self.plan, mesh)
        self._world = mesh is not None and self.plan.n_parts > 1
        self.item_cap = int(engine_kwargs.get("item_cap",
                                              ITEM_CAP_DEFAULT))
        self._device = engine_device(device, mesh)
        # kept for the meshguard's rebuilds: an adopted part's engine is
        # built again on its adopter's row with these
        self._engine_kwargs = dict(engine_kwargs)
        self.engines: Dict[int, TsrTorch] = {
            p: self._engine(p, p) for p in self.owned}
        g = MGD.get()
        if g is not None:
            # the rows' devices for the guard's probe: this rank's own
            # device on a mesh, none without one (the reference's rows
            # that have no mesh of their own)
            g.register_rows({p: (self._device,) if mesh is not None else ()
                             for p in self.owned})
        self.stats: dict = {
            "partition_parts": int(parts),
            "partition_classes": int(classes),
            "partition_owned": list(self.owned),
            "partition_imbalance": round(self.plan.imbalance_ratio, 4),
            "partition_exchanges": 0,
            "partition_cross_bytes": 0,
            "deepening_rounds": 0,
        }
        first = self.engines[self.owned[0]]
        self.stats["shape_key"] = shapes.key_tsr_part(
            int(parts), first.n_seq, vdb.n_words)
        if first._RECORD_SHAPES:
            shapes.record(self.stats["shape_key"])
        if self._record:
            PN.count_mine("tsr")

    def _engine(self, p: int, row: int) -> TsrTorch:
        """Partition ``p``'s engine on ``row``'s mesh (on a world, this
        rank's own row: the only one it runs)."""
        if self._world:
            row = PN.own_row(self.plan, self.mesh)
        return TsrTorch(self.vdb, self.k, self.minconf, device=self._device,
                        mesh=self.meshes[row], partition=(self.plan, p),
                        **self._engine_kwargs)

    def frontier_fingerprint(self) -> dict:
        fp = self.engines[self.owned[0]].frontier_fingerprint()
        fp["partition"] = self.plan.fingerprint()
        return fp

    def _composite(self, m: int, floor: int, done: dict,
                   active_part, active_state) -> dict:
        """The composite checkpoint with the round's (m, floor), so a
        resume re-enters the right round at the right threshold."""
        return PN.composite_state(
            self.frontier_fingerprint(), done, active_part,
            active_state, m=int(m), minsup=int(floor))

    def _round_parts(self) -> List[int]:
        """The parts this process mines this round: every part without a
        mesh; on a world the parts homed on this rank's row (its own, and
        after a row death the parts it adopted)."""
        if not self._world:
            return list(self.owned)
        me = PN.own_row(self.plan, self.mesh)
        return [p for p, row in sorted(PN.part_homes(self.plan).items())
                if row == me]

    def _mine_round(self, m: int, floor: int, resume: Optional[dict],
                    checkpoint_cb, every_s: float):
        """One deepening round: every part of this process mines its
        slice in turn (each starting from the board's floor, which the
        slices before it tightened), then ONE exchange merges the slices
        and floors (two on a world where a row died this round: the
        adopted slices have their own).  Returns (merged rows, the next
        floor)."""
        board = PN.ThresholdBoard(self.k, floor)
        done, active_resume = PN.decode_composite(
            resume, self.frontier_fingerprint())
        for rows_p in done.values():
            board.merge(int(r[2]) for r in rows_p)
        guarded = MGD.get() is not None
        orphans: list = []

        def run(p, resume_state, row):
            """Part ``p``'s rows mined from ``resume_state`` at the
            board's floor, or None when it is orphaned on a world."""
            # the part's latest snapshot, kept host-side even without a
            # checkpoint sink: an adopter resumes mid-slice from it
            last = {"fs": resume_state}
            cb = None
            if checkpoint_cb is not None or guarded:
                def cb(fs, p=p, last=last):
                    last["fs"] = fs
                    if checkpoint_cb is not None:
                        checkpoint_cb(self._composite(
                            m, board.floor(), done, p, fs))

            def mine(row, attempt):
                if attempt or p not in self.engines:
                    # a fresh topology epoch and, after an adoption, the
                    # adopter's row; the class restriction (plan, p), so
                    # the resumed frontier and the merge, are unchanged
                    self.engines[p] = self._engine(p, row)
                return self.engines[p]._mine_restricted(
                    m, resume=last["fs"], checkpoint_cb=cb,
                    every_s=every_s, floor=board.floor())[0]

            res_p = PN.mine_on_rows(self.plan, p, mine, world=self._world,
                                    row=row)
            if res_p is PN.ORPHANED:
                orphans.append({"part": p, "fs": last["fs"]})
                return None
            rows = [[list(x), list(y), int(sup), int(supx)]
                    for x, y, sup, supx in res_p]
            board.merge(r[2] for r in rows)
            return rows

        parts = self._round_parts()
        me = PN.own_row(self.plan, self.mesh) if self._world else None
        failure = None
        try:
            for p in parts:
                if p in done:
                    continue  # completed before the resumed snapshot
                rows = run(p, active_resume.get(p), p if me is None else me)
                if rows is None:
                    continue
                done[p] = rows
                if checkpoint_cb is not None:
                    # part boundary: a resume starts past this slice
                    checkpoint_cb(self._composite(m, board.floor(), done,
                                                  None, None))
        except Exception as exc:
            if not self._world:
                raise
            # every rank raises it together, after the exchange
            failure = exc

        def before_adopt(gathered):
            # the adopter resumes each orphan at the floor of the rows
            # merged so far
            nonlocal board
            board = self._next_board(board, gathered)

        # contribute only this round's parts: a resumed composite can
        # carry other rows' slices, which their own rows contribute
        gathered = PN.finish_round(
            {"floor": board.floor(),
             "rows": [r for p in sorted(done) if p in parts
                      for r in done[p]]},
            failure, orphans, lambda p, fs: run(p, fs, me), plan=self.plan,
            mesh=self.mesh, stats=self.stats, record=self._record,
            before_adopt=before_adopt)
        out = self._next_board(board, gathered)
        return [r for g in gathered for r in g["rows"]], out.floor()

    def _next_board(self, board, gathered: list):
        """The floor after an exchange, from a FRESH board over the merged
        rows (merging this board's own slice again would count its
        supports twice); the peers' floors are lower bounds too."""
        out = PN.ThresholdBoard(
            self.k, max([board.floor()]
                        + [int(g.get("floor", 1)) for g in gathered]))
        out.merge(int(r[2]) for g in gathered for r in g["rows"])
        return out

    def _merge(self, rows: list) -> Tuple[List[RuleResult], int]:
        """The exact global top-k filter over the union of the slices."""
        qual = [(tuple(int(i) for i in x), tuple(int(j) for j in y),
                 int(sup), int(supx)) for x, y, sup, supx in rows]
        sups = sorted((r[2] for r in qual), reverse=True)
        s_k = sups[self.k - 1] if len(sups) >= self.k else 1
        return sort_rules([r for r in qual if r[2] >= s_k]), s_k

    def mine(self, *, resume: Optional[dict] = None, checkpoint_cb=None,
             checkpoint_every_s: float = 30.0) -> List[RuleResult]:
        if resume is not None:
            fp = resume.get("fingerprint")
            if fp != self.frontier_fingerprint():
                raise ValueError(
                    "partitioned frontier checkpoint does not match this "
                    f"layout; checkpointed {fp}, engine "
                    f"{self.frontier_fingerprint()}")
        n_total = self.vdb.n_items
        if resume is not None:
            m = max(1, min(int(resume["m"]), n_total))
            floor = max(1, int(resume.get("minsup", 1)))
        else:
            m = max(1, min(self.item_cap, n_total))
            floor = 1
        first = self.engines[self.owned[0]]
        while True:
            self.stats["deepening_rounds"] += 1
            rows, floor = self._mine_round(m, floor, resume, checkpoint_cb,
                                           checkpoint_every_s)
            resume = None  # only the first (snapshot's) round resumes
            results, s_k = self._merge(rows)
            if m >= n_total:
                break
            # the deepening decision runs on the merged global state, so
            # every process walks the same m ladder
            next_item_sup = int(first._sup_sorted[m])
            if len(results) >= self.k and next_item_sup < s_k:
                break
            if len(results) >= self.k:
                # round m's exact global s_k lower-bounds round 2m's
                floor = max(floor, s_k)
            m = min(m * 2, n_total)
        self._fold_stats()
        return results

    def _fold_stats(self) -> None:
        """Add the partition engines' numeric counters into the stats."""
        for eng in self.engines.values():
            PN.fold_numeric_stats(
                self.stats, {k: v for k, v in eng.stats.items()
                             if k not in ("shape_key", "partition")})


def _resume_dict(minsup: int, entries: List[tuple],
                 results: List[tuple]) -> dict:
    """A resident round's frontier and records as the host loop's resume
    state (the checkpoint's ``minsup``/``stack``/``results`` fields)."""
    return {
        "minsup": int(minsup),
        "stack": [[b, list(x), list(y), cr, side, psup, psupx]
                  for b, x, y, cr, side, psup, psupx in entries],
        "results": [[list(x), list(y), sup, supx]
                    for sup, supx, x, y in results],
    }


def mine_tsr_torch(db: SequenceDB, k: int, minconf: float, *,
                   device: DeviceLike = None, mesh=None,
                   stats_out: Optional[dict] = None, checkpoint=None,
                   partition_parts: int = 0, partition_classes: int = 64,
                   **kwargs) -> List[RuleResult]:
    """DB -> vertical build -> device mine, on ``device`` (default CUDA;
    raises without it).

    ``checkpoint`` (optional): an object with ``load() -> Optional[dict]``,
    ``save(state)`` and ``every_s``; a saved frontier (from either
    package) is resumed when its fingerprint still matches.  A ``mesh``
    shards the sequence axis over its ranks (every rank calls this alike
    and gets the same rules); ``partition_parts > 1`` mines through
    :class:`TsrPartitioned` with ``partition_classes`` classes (on a
    mesh, one row of ranks a partition).  ``kwargs`` go to
    :class:`TsrTorch`."""
    dev = engine_device(device, mesh)
    vdb = build_vertical(db, min_item_support=1)
    if vdb.n_items == 0:
        return []
    if partition_parts and int(partition_parts) > 1:
        eng = TsrPartitioned(vdb, k, minconf, device=dev, mesh=mesh,
                             parts=int(partition_parts),
                             classes=int(partition_classes), **kwargs)
    else:
        eng = TsrTorch(vdb, k, minconf, device=dev, mesh=mesh, **kwargs)
    return _run(eng, stats_out, checkpoint)


def mine_tsr_cpu(db: SequenceDB, k: int, minconf: float, *,
                 stats_out: Optional[dict] = None,
                 checkpoint=None, **kwargs) -> List[RuleResult]:
    """The NumPy oracle engine (:class:`TsrCPU`) end to end."""
    vdb = build_vertical(db, min_item_support=1)
    if vdb.n_items == 0:
        return []
    return _run(TsrCPU(vdb, k, minconf, **kwargs), stats_out, checkpoint)


def _run(eng: TsrTorch, stats_out: Optional[dict], checkpoint):
    resume, save_cb, every_s = load_checkpoint(
        checkpoint, eng.frontier_fingerprint())
    results = eng.mine(resume=resume, checkpoint_cb=save_cb,
                       checkpoint_every_s=every_s)
    if stats_out is not None:
        stats_out.update(eng.stats)
    return results
