"""Resident-frontier TSR: whole km-ladders of a deepening round expanded
on the device — port of ``spark_fsm_tpu/ops/resident_frontier.py``
(``K_PAD``, ``ResidentCaps``, ``working_set_bytes``, ``caps_for``,
``root_entries``, ``pack_state``, ``unpack_entries``, ``unpack_results``
copied as host code with the same formulas; the ``while_loop`` body of
``_resident_fn`` as :func:`wave`).

The frontier of the host loop's best-first search (models/tsr.py) lives
on the device as a FIFO ring of sibling-chain entries: packed (X, Y) item
slots (``exy``, ``caps.km`` per side), the admission bound, the parent
support, the exact antecedent support ``psupx`` and the chain flags.
Each wave pops ``nb`` entries and, as the host loop does for a popped
entry: advances its sibling chain, applies the pop-time confidence-bound
subtree prune, evaluates (sup, supx), accepts rules into a record buffer,
keeps the exact top-k support threshold on the device (a sorted
``K_PAD`` buffer) and enqueues the left and right child chain heads.  A
child that needs a slot past the km ladder goes to a defer buffer, which
the host filters against the round's final threshold.  Every wave
pre-checks the ring, record and defer capacities and commits nothing on
overflow: the host reads the intact frontier back and finishes the round
on the host loop.  The parity argument is the reference's: the final
rule set is pop-order independent, and the device only prunes against a
threshold no higher than the exact current k-th accepted support.

Torch has no device while-loop, so the host runs the waves
(``models/tsr.TsrTorch._mine_resident``) and reads the 10 counters after
each.  :func:`wave` makes no host sync: every shape is static, ``argmax``
over a bool mask goes through an int cast, and the reference's
``mode="drop"`` writes land in one trash row past each buffer
(``_common.copy_rows_drop``).  The evaluation is B2
(``ops/rule_support.rule_supports``) on the gathered ``exy`` rows: its
``[C, 2, km]`` candidates with -1 reading the all-ones pad row are the
ring's own layout, and it computes the reference's masked AND-fold.

The ``fsm_tsr_resident_*`` registry families and :func:`resident_keys`
are the reference's, counted where its engine counts them, but for
``fsm_tsr_resident_fallbacks_total``: a resident round here never falls
back to the host path (a dispatch fault raises), so it has no family.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from spark_fsm_tpu_torch.models._common import copy_rows_drop
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.utils import obs, shapes

# Exact on-device top-k capacity: the ``topk`` buffer's static length (a
# larger k routes to the host loop)
K_PAD = 1024

_SEGMENTS = obs.REGISTRY.counter(
    "fsm_tsr_resident_segments_total",
    "resident-frontier segments (runs of waves between counter checks)")
_WAVES = obs.REGISTRY.counter(
    "fsm_tsr_resident_waves_total",
    "frontier waves executed on device inside resident segments")
_SPILLS = obs.REGISTRY.counter(
    "fsm_tsr_resident_spills_total",
    "resident frontiers spilled back to the host path (capacity overflow)")
_DEFERRED = obs.REGISTRY.counter(
    "fsm_tsr_resident_deferred_total",
    "over-km-ladder children deferred to the host's end-of-round filter")
_HANDOFFS = obs.REGISTRY.counter(
    "fsm_tsr_resident_handoffs_total",
    "rounds whose surviving deferred entries resumed the host path")
_READBACK = obs.REGISTRY.counter(
    "fsm_tsr_resident_readback_bytes_total",
    "bytes read back from resident device state (records + spills)")


def count_segment(waves: int) -> None:
    _SEGMENTS.inc()
    if waves:
        _WAVES.inc(waves)


def count_spill(reason: str) -> None:
    _SPILLS.inc(reason=reason)


def count_deferred(n: int) -> None:
    if n > 0:
        _DEFERRED.inc(n)


def count_handoff() -> None:
    _HANDOFFS.inc()


def count_readback(nbytes: int) -> None:
    if nbytes > 0:
        _READBACK.inc(nbytes)


@dataclasses.dataclass(frozen=True)
class ResidentCaps:
    """Static capacities of the resident round.

    ``nb``: frontier entries popped per wave; ``nb_late`` the narrow
    late-wave width.  ``ring``: live-frontier capacity (FIFO slot reuse,
    so it bounds ``tail - head``, not the mine's node count).  ``r_cap``:
    accepted-rule records for the whole round (append-only; the host
    filters to the final s_k).  ``km``: per-side item-slot capacity — the
    km-ladder depth expanded on the device; children past it land in the
    defer buffer (``d_cap`` entries of ``km + 1`` slots).  ``i_max``:
    host-side total-wave runaway guard."""

    nb: int = 512
    ring: int = 16384
    r_cap: int = 32768
    km: int = 4
    d_cap: int = 4096
    i_max: int = 1 << 20

    @property
    def nb_late(self) -> int:
        return RB.late_wave_nb(self.nb, 32)


def working_set_bytes(caps: ResidentCaps, row_bytes: int, m: int) -> int:
    """The reference's working-set estimate of a resident round, shared by
    :func:`caps_for` and the engine's routing so the two cannot disagree:
    the prep pair, the carry-doubled ring and record state (a
    ``while_loop`` carry cannot alias its input) and six live
    ``[nb, S, W]`` fold temporaries.  The port updates its carry in place
    and B2 builds no fold temporaries, but the estimate is kept as it is,
    so equal budgets give equal caps and routes."""
    entry = 2 * caps.km * 4 + 3 * 4 + 2 + 4     # exy + int32x3 + flags
    rec = 2 * caps.km * 4 + 2 * 4               # rec_xy + sup/supx
    defer = 2 * (caps.km + 1) * 4 + 3 * 4 + 2 + 4
    return (2 * m * row_bytes                   # p1/s1 preps
            + 2 * (caps.ring * entry + caps.r_cap * rec
                   + caps.d_cap * defer + K_PAD * 4)
            + 6 * caps.nb * row_bytes)          # wave eval temps


def caps_for(n_seq: int, n_words: int, m: int,
             budget: int) -> Optional[ResidentCaps]:
    """Capacity model: the largest pow2 ring (and a budget-clamped wave
    width) whose working set fits ``budget``; None when even the smallest
    geometry does not fit (the round routes to the host loop)."""
    row = max(1, n_seq * max(1, n_words) * 4)
    nb = min(512, max(64, RB.floor_pow2(max(1, budget // (8 * row)))))
    # FIFO breadth-first residency peaks at about a BFS level width, so
    # the search starts at 64k entries and shrinks to fit the budget
    ring = 65536
    while ring >= 2048:
        caps = ResidentCaps(nb=nb, ring=ring, r_cap=2 * ring,
                            d_cap=max(1024, ring // 8))
        if working_set_bytes(caps, row, m) <= budget:
            return caps
        ring //= 2
    return None


# ---------------------------------------------------------------------------
# Host-side frontier packing (entries <-> device carry)
# ---------------------------------------------------------------------------
# Entry tuples use the host engine's queue spelling with the bound kept
# positive: (bound, x, y, can_right, side, psup, psupx) — the checkpoint
# "stack" rows of models/tsr.frontier_state.


def resident_keys(n_seq: int, n_words: int, m: int,
                  caps: ResidentCaps) -> List[str]:
    """The shape keys a resident round records: the wide wave width and
    (when distinct) the narrow late-wave width."""
    out = [shapes.key_tsr_resident(n_seq, n_words, m, caps.km, caps.nb,
                                   caps.ring)]
    if caps.nb_late < caps.nb:
        out.append(shapes.key_tsr_resident(n_seq, n_words, m, caps.km,
                                           caps.nb_late, caps.ring))
    return out


def root_entries(sup_l: Sequence[int], minsup: int, num: int, den: int,
                 max_side: Optional[int]) -> List[tuple]:
    """The round's root chain heads — the device twin of the host loop's
    root ``chain_push`` calls (one side-1 chain per item i over partners
    j != i; items are support-sorted, so the first admissible partner is
    index 0, or 1 for item 0)."""
    m = len(sup_l)
    out = []
    for i in range(m):
        c = 1 if i == 0 else 0
        if c >= m:
            continue
        b = min(sup_l[i], sup_l[c])
        if b < minsup:
            continue
        if (max_side is not None and 1 >= max_side and sup_l[i] > 0
                and b * den < sup_l[i] * num):
            continue  # chain_push's side-1 conf kill at max_side=1
        out.append((b, (i,), (c,), True, 1, sup_l[i], sup_l[i]))
    return out


def pack_state(entries: Sequence[tuple],
               results: Sequence[tuple],
               caps: ResidentCaps) -> Optional[dict]:
    """Numpy arrays for a fresh device carry, or None when the frontier
    does not fit the caps (the round then routes host: entry count past
    the ring or defer buffer, a side past the defer width, or too many
    kept results).  Entries whose sides fit the km ladder land in the
    ring; one-past-the-ladder entries (a resumed snapshot that already
    deferred them) land straight in the defer buffer."""
    ring, km, r_cap = caps.ring, caps.km, caps.r_cap
    if len(results) > r_cap:
        return None
    fit = [e for e in entries if len(e[1]) <= km and len(e[2]) <= km]
    over = [e for e in entries if len(e[1]) > km or len(e[2]) > km]
    if len(fit) > ring or len(over) > caps.d_cap:
        return None
    exy = np.full((ring, 2, km), -1, np.int32)
    bound = np.zeros(ring, np.int32)
    psup = np.zeros(ring, np.int32)
    psupx = np.zeros(ring, np.int32)
    cr = np.zeros(ring, bool)
    side = np.zeros(ring, np.int32)
    for q, (b, x, y, crq, sd, ps, px) in enumerate(fit):
        exy[q, 0, :len(x)] = x
        exy[q, 1, :len(y)] = y
        bound[q] = b
        psup[q] = ps
        psupx[q] = px
        cr[q] = bool(crq)
        side[q] = sd
    dxy = np.full((caps.d_cap, 2, km + 1), -1, np.int32)
    dbound = np.zeros(caps.d_cap, np.int32)
    dpsup = np.zeros(caps.d_cap, np.int32)
    dpsupx = np.zeros(caps.d_cap, np.int32)
    dcr = np.zeros(caps.d_cap, bool)
    dside = np.zeros(caps.d_cap, np.int32)
    for q, (b, x, y, crq, sd, ps, px) in enumerate(over):
        if len(x) > km + 1 or len(y) > km + 1:
            return None
        dxy[q, 0, :len(x)] = x
        dxy[q, 1, :len(y)] = y
        dbound[q] = b
        dpsup[q] = ps
        dpsupx[q] = px
        dcr[q] = bool(crq)
        dside[q] = sd
    rec_xy = np.full((r_cap, 2, km), -1, np.int32)
    rec_sup = np.zeros(r_cap, np.int32)
    rec_supx = np.zeros(r_cap, np.int32)
    for r, (sup, supx, x, y) in enumerate(results):
        if len(x) > km or len(y) > km:
            return None
        rec_xy[r, 0, :len(x)] = x
        rec_xy[r, 1, :len(y)] = y
        rec_sup[r] = sup
        rec_supx[r] = supx
    topk = np.zeros(K_PAD, np.int32)
    sups = sorted((int(r[0]) for r in results), reverse=True)[:K_PAD]
    topk[:len(sups)] = sups
    return {"exy": exy, "bound": bound, "psup": psup, "psupx": psupx,
            "cr": cr, "side": side, "rec_xy": rec_xy, "rec_sup": rec_sup,
            "rec_supx": rec_supx, "n_entries": len(fit),
            "n_results": len(results), "topk": topk,
            "dxy": dxy, "dbound": dbound, "dpsup": dpsup,
            "dpsupx": dpsupx, "dcr": dcr, "dside": dside,
            "n_defer": len(over)}


def unpack_entries(exy: np.ndarray, bound: np.ndarray, psup: np.ndarray,
                   psupx: np.ndarray, cr: np.ndarray, side: np.ndarray,
                   head: int, tail: int, minsup: int) -> List[tuple]:
    """Live ring entries back into host queue tuples (the spill path and
    the checkpoint snapshot).  Bound-dead entries (< minsup) are dropped
    exactly like ``frontier_state`` drops them."""
    ring = exy.shape[0]
    out = []
    for qid in range(int(head), int(tail)):
        r = qid % ring
        b = int(bound[r])
        if b < minsup:
            continue
        x = tuple(int(v) for v in exy[r, 0] if v >= 0)
        y = tuple(int(v) for v in exy[r, 1] if v >= 0)
        out.append((b, x, y, bool(cr[r]), int(side[r]), int(psup[r]),
                    int(psupx[r])))
    return out


def unpack_results(rec_xy: np.ndarray, rec_sup: np.ndarray,
                   rec_supx: np.ndarray, n_rec: int,
                   minsup: int) -> List[tuple]:
    """Accepted records back into (sup, supx, x, y) tuples, filtered to
    the current minsup — the host engine's progressive results filter,
    applied once at readback."""
    out = []
    for r in range(int(n_rec)):
        sup = int(rec_sup[r])
        if sup < minsup:
            continue
        x = tuple(int(v) for v in rec_xy[r, 0] if v >= 0)
        y = tuple(int(v) for v in rec_xy[r, 1] if v >= 0)
        out.append((sup, int(rec_supx[r]), x, y))
    return out


# ---------------------------------------------------------------------------
# The device carry and one wave
# ---------------------------------------------------------------------------

# the reference's 26 carry fields, in its order; the 10 scalars among them
# live in ``Carry.ctr`` (in the order of the reference's counter vector)
CARRY_FIELDS = (
    "exy", "bound", "psup", "psupx", "cr", "side", "head", "tail",
    "rec_xy", "rec_sup", "rec_supx", "rec_count", "topk", "n_acc",
    "minsup", "overflow", "waves", "evaluated", "pruned",
    "dxy", "dbound", "dpsup", "dpsupx", "dcr", "dside", "d_count")
COUNTERS = ("rec_count", "overflow", "waves", "head", "tail", "minsup",
            "evaluated", "pruned", "n_acc", "d_count")
RING_FIELDS = ("exy", "bound", "psup", "psupx", "cr", "side")
RECORD_FIELDS = ("rec_xy", "rec_sup", "rec_supx")
DEFER_FIELDS = ("dxy", "dbound", "dpsup", "dpsupx", "dcr", "dside")


@dataclasses.dataclass
class Carry:
    """The device state of a resident round.  Ring buffers have
    ``ring + 1`` rows, record buffers ``r_cap + 1`` and defer buffers
    ``d_cap + 1``: the last row of each is the trash row that masked
    writes land in, never read.  ``ctr`` is int64 ``[10]`` in the order
    of :data:`COUNTERS`."""

    exy: torch.Tensor
    bound: torch.Tensor
    psup: torch.Tensor
    psupx: torch.Tensor
    cr: torch.Tensor
    side: torch.Tensor
    rec_xy: torch.Tensor
    rec_sup: torch.Tensor
    rec_supx: torch.Tensor
    topk: torch.Tensor
    dxy: torch.Tensor
    dbound: torch.Tensor
    dpsup: torch.Tensor
    dpsupx: torch.Tensor
    dcr: torch.Tensor
    dside: torch.Tensor
    ctr: torch.Tensor

    def arrays(self, names: Sequence[str]) -> List[np.ndarray]:
        """Host copies of the named buffers without their trash rows —
        the reference carry's arrays, dtypes and byte sizes."""
        return [getattr(self, n)[:-1].cpu().numpy() for n in names]

    def nbytes(self, names: Sequence[str]) -> int:
        """Bytes :meth:`arrays` would read back for these buffers."""
        return sum(t[:-1].numel() * t.element_size()
                   for t in (getattr(self, n) for n in names))


def carry_from_state(state: dict, minsup: int,
                     device: torch.device) -> Carry:
    """A fresh device carry from :func:`pack_state`'s arrays, with
    ``head`` 0, ``tail`` at the packed entries and the record and
    accepted counts at the kept results."""

    def put(name):
        a = state[name]
        return torch.from_numpy(np.concatenate([a, a[:1]])).to(device)

    ctr = torch.tensor([state["n_results"], 0, 0, 0, state["n_entries"],
                        int(minsup), 0, 0, state["n_results"],
                        state["n_defer"]], dtype=torch.int64)
    return Carry(*(put(n) for n in RING_FIELDS + RECORD_FIELDS),
                 torch.from_numpy(state["topk"]).to(device),
                 *(put(n) for n in DEFER_FIELDS), ctr.to(device))


def wave(c: Carry, p1: torch.Tensor, s1: torch.Tensor,
         sup_items: torch.Tensor, num: int, den: int, k: int,
         max_side_t: int, nb: int, n_words: int,
         evaluate: Callable) -> None:
    """One wave of width ``nb`` — the reference's ``while_loop`` body —
    on the device with no host sync; ``c``'s buffers and counters
    advance in place.

    ``p1``/``s1``: the round's flat ``[m + 1, S*W]`` prefix/suffix-OR
    stores with the all-ones pad row m; ``sup_items``: the m item
    supports (int32); ``max_side_t``: the side cap (``1 << 30`` for
    none); ``evaluate``: ``rule_support.rule_supports`` (B2 on CUDA) or
    its plain version, called on the popped entries' ``exy`` rows.  The
    int32 confidence products cannot wrap: the engine routes here only
    when ``max(num, den) * (n_seq + 1) < 2**31``."""
    dev = c.exy.device
    i32 = torch.int32
    ring = c.bound.shape[0] - 1
    r_cap = c.rec_sup.shape[0] - 1
    d_cap = c.dbound.shape[0] - 1
    km = c.exy.shape[2]
    m = sup_items.shape[0]
    (rec_count, overflow, waves, head, tail, minsup, evaluated, pruned,
     n_acc, d_count) = c.ctr.unbind(0)
    lane = torch.arange(nb, device=dev)
    item = torch.arange(m, device=dev, dtype=i32)
    pos = torch.arange(km, device=dev, dtype=i32)
    minsup32 = minsup.to(i32)

    qid = head + lane
    active = qid < tail
    ridx = torch.where(active, qid % ring, 0)
    ex = c.exy[ridx]                              # [nb, 2, km]
    b = torch.where(active, c.bound[ridx], -1)
    ps = c.psup[ridx]
    px = c.psupx[ridx]
    crl = c.cr[ridx]
    sd = c.side[ridx]
    # bound-dead lanes drop whole, like the host's queue.clear() at a
    # risen minsup
    live = active & (b >= minsup32)

    xs, ys = ex[:, 0, :], ex[:, 1, :]
    nx = (xs >= 0).sum(1, dtype=i32)
    ny = (ys >= 0).sum(1, dtype=i32)
    # chain items are appended in ascending order, so the last valid slot
    # is the side's largest item
    maxx = xs.gather(1, (nx - 1).clamp(min=0).long()[:, None])[:, 0]
    maxy = torch.where(ny > 0, ys.gather(
        1, (ny - 1).clamp(min=0).long()[:, None])[:, 0], -1)
    free = ~(ex.view(nb, 2 * km, 1) == item).any(1)     # [nb, m] not in rule

    def first(adm):
        # index of the first admissible item (0 when none), as jnp.argmax
        return adm.to(i32).argmax(1).to(i32)

    # ---- sibling advance (before the evaluation: the host's pop order)
    lastv = torch.where(sd == 0, maxx, maxy)
    sib_adm = free & (item > lastv[:, None])
    has_sib = sib_adm.any(1)
    sib_c = first(sib_adm)
    sib_b = torch.minimum(ps, sup_items[sib_c.long()])
    sib_kill = ((sd == 1) & (px > 0) & (sib_b * den < px * num)
                & (nx >= max_side_t))
    push_sib = live & has_sib & (sib_b >= minsup32) & ~sib_kill
    slot_j = (torch.where(sd == 0, nx, ny) - 1).clamp(min=0)
    repl = pos == slot_j[:, None]
    sib_x = torch.where((sd == 0)[:, None] & repl, sib_c[:, None], xs)
    sib_y = torch.where((sd == 1)[:, None] & repl, sib_c[:, None], ys)
    sib_ex = torch.stack([sib_x, sib_y], 1)

    # ---- pop-time conf-bound subtree prune (the host's exact test:
    # side-1, psupx known, bound below the conf floor, and the antecedent
    # can never grow again)
    lv_adm = free & (item > maxx[:, None]) & (sup_items >= minsup32)
    left_viable = (nx < max_side_t) & lv_adm.any(1)
    confdead = (live & (sd == 1) & (px > 0) & (b * den < px * num)
                & ~left_viable)
    ev = live & ~confdead

    # ---- evaluate: B2 on the popped rows (-1 slots read the pad row)
    out = evaluate(p1, s1, ex, n_words)
    sup = torch.where(ev, out[0], 0)
    supx = torch.where(ev, out[1], 0)

    acc_ok = (ev & (sup >= minsup32) & (supx > 0)
              & (sup * den >= supx * num))
    n_new = acc_ok.sum()

    # ---- exact on-device top-k threshold
    merged = torch.sort(torch.cat([c.topk, torch.where(acc_ok, sup, 0)]),
                        descending=True).values[:K_PAD]
    n_acc2 = n_acc + n_new
    thresh = merged[max(k - 1, 0)]
    minsup2 = torch.maximum(minsup32, torch.where(n_acc2 >= k, thresh, 1))

    # ---- children: left/right chain heads (the host's consume())
    expand = ev & (sup >= minsup32)
    l_adm = free & (item > maxx[:, None])
    l_has = l_adm.any(1)
    l_c = first(l_adm)
    l_b = torch.minimum(sup, sup_items[l_c.long()])
    push_l = expand & (nx < max_side_t) & l_has & (l_b >= minsup2)
    r_adm = free & (item > maxy[:, None])
    r_has = r_adm.any(1)
    r_c = first(r_adm)
    r_b = torch.minimum(sup, sup_items[r_c.long()])
    r_kill = (supx > 0) & (r_b * den < supx * num) & (nx >= max_side_t)
    push_r = (expand & crl & (ny < max_side_t) & r_has & (r_b >= minsup2)
              & ~r_kill)
    # km-ladder end: a child that needs a slot past km lands in the defer
    # buffer for the host's end-of-round filter; a deferring side is
    # exactly full (n == km)
    defer_l = push_l & (nx >= km)
    defer_r = push_r & (ny >= km)
    push_l = push_l & (nx < km)
    push_r = push_r & (ny < km)
    l_ex = torch.stack([torch.where(
        pos == nx.clamp(max=km - 1)[:, None], l_c[:, None], xs), ys], 1)
    r_ex = torch.stack([xs, torch.where(
        pos == ny.clamp(max=km - 1)[:, None], r_c[:, None], ys)], 1)

    # ---- capacity pre-check: commit nothing on overflow
    pushes = torch.cat([push_sib, push_l, push_r])
    n_push = pushes.sum()
    defers = torch.cat([defer_l, defer_r])
    n_defer = defers.sum()
    new_head = torch.minimum(head + nb, tail)
    new_tail = tail + n_push
    ovf = ((new_tail - new_head > ring) | (rec_count + n_new > r_cap)
           | (d_count + n_defer > d_cap))
    ok = ~ovf

    # ---- records
    rpos = rec_count + torch.cumsum(acc_ok, 0) - 1
    rkeep = acc_ok & ok
    copy_rows_drop(c.rec_xy, rpos, rkeep, ex)
    copy_rows_drop(c.rec_sup, rpos, rkeep, sup)
    copy_rows_drop(c.rec_supx, rpos, rkeep, supx)

    # ---- defer over-ladder children (km + 1 item slots: the new item
    # lands in the one extra slot)
    zero = torch.zeros(nb, dtype=i32, device=dev)
    one = torch.ones(nb, dtype=i32, device=dev)
    ncol = torch.full((nb, 1), -1, dtype=i32, device=dev)
    dl_ex = torch.stack([torch.cat([xs, l_c[:, None]], 1),
                         torch.cat([ys, ncol], 1)], 1)
    dr_ex = torch.stack([torch.cat([xs, ncol], 1),
                         torch.cat([ys, r_c[:, None]], 1)], 1)
    dpos = d_count + torch.cumsum(defers, 0) - 1
    dkeep = defers & ok
    copy_rows_drop(c.dxy, dpos, dkeep, torch.cat([dl_ex, dr_ex]))
    copy_rows_drop(c.dbound, dpos, dkeep, torch.cat([l_b, r_b]))
    copy_rows_drop(c.dpsup, dpos, dkeep, torch.cat([sup, sup]))
    copy_rows_drop(c.dpsupx, dpos, dkeep, torch.cat([zero, supx]))
    copy_rows_drop(c.dcr, dpos, dkeep, torch.cat([zero, one]).bool())
    copy_rows_drop(c.dside, dpos, dkeep, torch.cat([zero, one]))

    # ---- enqueue at the ring tail.  Slots of entries popped this wave
    # may be reused (their rows were gathered above); new_tail - new_head
    # <= ring guarantees no live slot is overwritten
    qr = (tail + torch.cumsum(pushes, 0) - 1) % ring
    qkeep = pushes & ok
    copy_rows_drop(c.exy, qr, qkeep, torch.cat([sib_ex, l_ex, r_ex]))
    copy_rows_drop(c.bound, qr, qkeep, torch.cat([sib_b, l_b, r_b]))
    copy_rows_drop(c.psup, qr, qkeep, torch.cat([ps, sup, sup]))
    copy_rows_drop(c.psupx, qr, qkeep,
                   torch.cat([torch.where(sd == 1, px, 0), zero, supx]))
    copy_rows_drop(c.cr, qr, qkeep,
                   torch.cat([crl, zero.bool(), one.bool()]))
    copy_rows_drop(c.side, qr, qkeep, torch.cat([sd, zero, one]))

    def keep(old, new):
        return torch.where(ovf, old, new)

    c.topk.copy_(keep(c.topk, merged))
    c.ctr = torch.stack([
        keep(rec_count, rec_count + n_new), overflow | ovf.long(),
        waves + ok.long(), keep(head, new_head), keep(tail, new_tail),
        keep(minsup, minsup2.long()),
        evaluated + torch.where(ok, ev.sum(), 0),
        pruned + torch.where(ok, confdead.sum(), 0),
        keep(n_acc, n_acc2), keep(d_count, d_count + n_defer)])
