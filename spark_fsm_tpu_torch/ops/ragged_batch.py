"""Ragged candidate super-batching for TSR's evaluation launches — copy of
the launch planner in ``spark_fsm_tpu/ops/ragged_batch.py`` (``Launch``,
``plan_launches``, ``XYStager``, ``overhead_units``,
``dispatch_quantum_lanes``, ``KM_LADDER`` and the pow2 helpers), the
queue engine's late-wave geometry ``late_wave_nb``, and the service's
cost estimate ``estimate_seconds``.

Candidates arrive in per-km pools (km = the pow2 bucket of a rule's
larger side).  :func:`plan_launches` splits each pool greedily into full
pow2 launches at its own km, then merges the per-km tails into shared
launches at the largest participating km when the cost model says the
padded lanes cost less than the saved dispatch.  A lane of side <= km
fits any wider geometry: its unused slots are -1, the all-ones pad row.

The cost model counts work in lane x sequence-word units.  The reference
states its constants as measured times; the planner only ever uses their
ratios, so they are kept here as those ratios: a launch that is worth one
dispatch streams :data:`QUANTUM_LANE_SEQWORDS`, and one dispatch's fixed
cost is worth :data:`DISPATCH_LANE_SEQWORDS` of padded lanes.  Held as
exact integers and fractions, they give the same plans as the reference's
floating-point arithmetic (``tests/test_torch_ragged_batch.py``).  They
shape launches, never results.  Left out of the copy: the live drift
recalibration (the factor is 1, as with ``set_overhead_calibration(False)``
in the reference).

The cross-job fusion broker (``service/fusion.py``) plans over candidates
pooled from several jobs: ``plan_launches(job_of=...)`` tags each lane
with its job (``Launch.jobs``, ``cross_job``), ``record=False`` plans
without counting, and :func:`record_plan` counts a plan that dispatches
(the reference's ``fsm_planner_*`` families).  :func:`superbatch_geometries`
lists the (km, width) set a plan can emit, for the shape-key enumerator.

:func:`launch_halving` is the OOM half-width ladder (the reference's
``TsrTPU._dispatch_kernel_launch``), shared by TSR's direct launches and
the broker's fused and solo ones.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_fsm_tpu_torch.utils import faults, obs

_PLAN_LAUNCHES = obs.REGISTRY.counter(
    "fsm_planner_launches_total", "launches emitted by the ragged packer")
_PLAN_SUPERBATCHES = obs.REGISTRY.counter(
    "fsm_planner_superbatches_total",
    "mixed-km launches emitted by the ragged packer")

# lane x sequence-words of one launch at the dispatch-efficiency quantum:
# 8192 lanes over a 990,000-sequence single-word axis
QUANTUM_LANE_SEQWORDS = 8192 * 990_000
# one dispatch's fixed cost in the same units: 25/429 of the quantum, the
# ratio of the reference's dispatch cost to its quantum launch
DISPATCH_LANE_SEQWORDS = Fraction(25, 429) * QUANTUM_LANE_SEQWORDS

# The km side-size ladder (pow2 buckets of a rule's larger side).
KM_LADDER = (1, 2, 4, 8)


# The reference's committed cost-model anchors, in seconds: one km1 lane
# over one sequence word, and one dispatch.  They are the reference
# device's figures, not measurements of the port; the port reads them
# only through :func:`estimate_seconds`, to size the service's admission
# hints (``Retry-After``) and the dispatch watchdog's deadlines, never a
# launch plan.
LANE_SEC_PER_SEQWORD = 85.8e-3 / 8192 / 990_000
DISPATCH_SEC = 0.005


def estimate_seconds(traffic_units: int, n_launches: int, n_seq: int,
                     n_words: int, dispatch_s: float = DISPATCH_SEC) -> float:
    """Predicted wall of ``n_launches`` launches streaming
    ``traffic_units`` lane-km units (the reference's
    ``ragged_batch.estimate_seconds``, same anchors)."""
    lane_s = n_seq * max(1, n_words) * LANE_SEC_PER_SEQWORD
    return max(0, traffic_units) * lane_s + max(1, n_launches) * dispatch_s


def next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def floor_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1) if n >= 1 else 1


def overhead_units(n_seq: int, n_words: int) -> int:
    """Per-launch overhead in traffic units for a sequence axis: how many
    padded lanes one saved dispatch is worth, clamped to [64, 2**20]."""
    seqwords = int(n_seq) * max(1, int(n_words))
    if seqwords <= 0:
        return 1 << 20
    return max(64, min(1 << 20, int(DISPATCH_LANE_SEQWORDS / seqwords)))


def dispatch_quantum_lanes(n_seq: int, n_words: int, lo: int = 8192,
                           hi: int = 16384) -> int:
    """Dispatch-efficiency width ceiling in lanes: the pow2 lane count
    whose launch streams about one quantum of work.  8192 at the full
    990,000-sequence axis, growing as the axis shrinks, up to ``hi`` (the
    bound on best-first staleness: candidates pop with the minsup of
    dispatch time)."""
    seqwords = int(n_seq) * max(1, int(n_words))
    if seqwords <= 0:
        return hi
    return max(lo, min(hi, floor_pow2(QUANTUM_LANE_SEQWORDS // seqwords + 1)))


@dataclasses.dataclass
class Launch:
    """One planned launch.

    ``km``: the launch geometry (xy minor width), the max of its lanes' own
    km buckets.  ``width``: padded pow2 lane count.  ``rows``: candidate
    indices in lane order.  ``kms``: each lane's own km bucket (lanes with
    ``kms[j] < km`` ride a wider geometry).  ``jobs``: each lane's job tag
    (None for single-job plans); the fusion broker demuxes a fused
    readback by it.  ``part``: the equivalence-class partition the launch
    belongs to (None outside partitioned mines)."""

    km: int
    width: int
    rows: List[int]
    kms: List[int]
    jobs: Optional[List[int]] = None
    part: Optional[int] = None

    @property
    def traffic_units(self) -> int:
        """What a launch of the full padded width streams: width x km."""
        return self.width * self.km

    @property
    def mixed(self) -> bool:
        """True when lanes from more than one km bucket share the launch."""
        return len(set(self.kms)) > 1

    @property
    def borrowed(self) -> int:
        """Lanes whose own km is below the launch geometry."""
        return sum(1 for k in self.kms if k < self.km)

    @property
    def n_jobs(self) -> int:
        """Distinct jobs sharing the launch (1 for untagged plans)."""
        return len(set(self.jobs)) if self.jobs else 1

    @property
    def cross_job(self) -> bool:
        """True when lanes from more than one job share the launch."""
        return self.n_jobs > 1


def plan_launches(pools: Dict[int, Sequence[int]], cap: Callable[[int], int],
                  lane: int, overhead: int,
                  job_of: Optional[Callable[[int], int]] = None,
                  record: bool = True,
                  part: Optional[int] = None) -> List[Launch]:
    """Pack per-km candidate pools into pow2 super-batch launches.

    Args:
      pools: ``{km: [candidate indices]}``; km keys are pow2.
      cap: per-geometry width ceiling, floored to ``lane`` and rounded down
        to pow2.
      lane: minimum launch width.
      overhead: per-launch fixed cost in traffic units (lanes x km), as
        :func:`overhead_units` gives it.
      job_of: optional candidate index -> job tag; every launch then
        carries per-lane ``jobs``.
      record: False for exploratory plans (the caller counts the chosen
        one with :func:`record_plan`).
      part: partition tag stamped on every launch.

    Returns launches in dispatch order: full same-km launches largest km
    first, then the merged tails.  Every candidate appears in exactly one
    launch, once.

    Split rule, per pool: while the remainder exceeds the geometry cap,
    emit cap-width full launches; once it fits, emit one padded launch if
    the pad is cheaper than another dispatch (``(width - n) * km <=
    overhead``), else peel the largest pow2 as a full launch and re-test.
    At most one non-full piece (the tail) survives per pool; tails then
    merge across km pools.
    """
    launches: List[Launch] = []
    tails: List[Tuple[int, List[int]]] = []
    for km in sorted(pools, reverse=True):
        rows = list(pools[km])
        if not rows:
            continue
        cap_km = max(lane, floor_pow2(max(1, int(cap(km)))))
        i = 0
        while True:
            n = len(rows) - i
            if n == 0:
                break
            width = max(lane, next_pow2(n))
            if n <= cap_km and (width - n) * km <= overhead:
                tails.append((km, rows[i:]))
                break
            take = min(cap_km, floor_pow2(n))
            if take < lane:
                # sub-lane remainder with a tiny overhead budget: a padded
                # lane-width tail is the only legal shape
                tails.append((km, rows[i:]))
                break
            piece = rows[i:i + take]
            launches.append(Launch(
                km, take, piece, [km] * take,
                [job_of(r) for r in piece] if job_of else None, part))
            i += take

    # cross-km tail merge, largest geometry first: every lane's own km is
    # bounded by the geometry, so -1 slots (the pad row) absorb the rest
    cur: Optional[Tuple[int, List[int], List[int]]] = None
    for km, rows in tails:
        if cur is not None:
            km_g, crows, ckms = cur
            cap_g = max(lane, floor_pow2(max(1, int(cap(km_g)))))
            merged_n = len(crows) + len(rows)
            if merged_n <= cap_g:
                w_cur = max(lane, next_pow2(len(crows)))
                w_merged = max(lane, next_pow2(merged_n))
                w_sep = max(lane, next_pow2(len(rows)))
                if w_merged * km_g <= w_cur * km_g + w_sep * km + overhead:
                    crows.extend(rows)
                    ckms.extend([km] * len(rows))
                    continue
            launches.append(_emit(cur, lane, job_of, part))
        cur = (km, list(rows), [km] * len(rows))
    if cur is not None:
        launches.append(_emit(cur, lane, job_of, part))
    if record:
        record_plan(launches)
    return launches


def record_plan(launches: List[Launch]) -> None:
    """Planner counters and the per-dispatch trace event for a plan that
    dispatches."""
    if not launches:
        return
    mixed = sum(1 for L in launches if L.mixed)
    _PLAN_LAUNCHES.inc(len(launches))
    if mixed:
        _PLAN_SUPERBATCHES.inc(mixed)
    obs.trace_event(
        "plan_launches",
        candidates=sum(len(L.rows) for L in launches),
        launches=len(launches), superbatches=mixed,
        traffic_units=sum(L.traffic_units for L in launches))


# OOM ladder floor (lanes): a launch that runs out of device memory
# re-plans at half width recursively down to here, the kernel path's
# lane floor
OOM_FLOOR_LANES = 128


def is_oom(exc: BaseException) -> bool:
    """Device allocation failure: the card's own
    ``torch.cuda.OutOfMemoryError``, an injected one
    (``faults.InjectedOom``), or the reference's RESOURCE_EXHAUSTED
    spelling."""
    if isinstance(exc, (torch.cuda.OutOfMemoryError, faults.InjectedOom)):
        return True
    s = repr(exc)
    return "RESOURCE_EXHAUSTED" in s or "Resource exhausted" in s


def launch_halving(L: Launch, launch: Callable[[Launch], object],
                   span: Callable[[Launch], object],
                   on_halve: Callable[[Launch], None]
                   ) -> List[Tuple[Launch, object]]:
    """Run ``launch(L)`` inside ``span(L)`` and return ``[(L, result)]``.

    A device OOM (:func:`is_oom`) re-plans the launch at half width,
    recursively down to :data:`OOM_FLOOR_LANES`, and returns the leaves
    in lane order.  Each halving calls ``on_halve(L)``, logs
    ``oom_degraded_launch`` and puts a ``resource_exhausted`` event on
    the failed launch's span, under which the halves nest.  The halves
    keep the parent's partition tag and their lanes' job tags.  Any
    other failure, and an OOM at the floor, raises."""
    with span(L) as sp:
        try:
            return [(L, launch(L))]
        except Exception as exc:
            if not is_oom(exc) or L.width <= OOM_FLOOR_LANES:
                raise
            half = L.width // 2
            on_halve(L)
            obs.log_event("oom_degraded_launch", km=L.km, width=L.width,
                          half=half)
            sp.event("resource_exhausted", km=L.km, width=L.width,
                     half=half, error=f"{type(exc).__name__}: {exc}")
            leaves: List[Tuple[Launch, object]] = []
            for lo, hi in ((0, half), (half, len(L.rows))):
                if L.rows[lo:hi]:
                    leaves += launch_halving(
                        Launch(L.km, half, L.rows[lo:hi], L.kms[lo:hi],
                               L.jobs[lo:hi] if L.jobs else None, L.part),
                        launch, span, on_halve)
            return leaves


def _emit(cur: Tuple[int, List[int], List[int]], lane: int,
          job_of: Optional[Callable[[int], int]] = None,
          part: Optional[int] = None) -> Launch:
    km_g, rows, kms = cur
    return Launch(km_g, max(lane, next_pow2(len(rows))), rows, kms,
                  [job_of(r) for r in rows] if job_of else None, part)


def superbatch_geometries(lane: int, hi_width: int,
                          kms: Sequence[int] = KM_LADDER
                          ) -> List[Tuple[int, int]]:
    """The finite (km, width) set :func:`plan_launches` can emit for a
    lane floor and a width ceiling: the ladder the shape-key enumerator
    lists and prewarm walks."""
    out = []
    for km in kms:
        w = max(1, int(lane))
        hi = max(w, next_pow2(max(1, int(hi_width))))
        while w <= hi:
            out.append((int(km), w))
            w *= 2
    return out


def late_wave_nb(nb: int, tile: int, ratio: int = 8) -> int:
    """Late-wave geometry for the queue engine: the narrow wave width the
    mine switches to once the live frontier drops below it, so many
    underfilled ``nb``-wide waves merge into well-filled narrow ones.
    ``tile``-aligned; returns ``nb`` unchanged (ladder off) when the ratio
    floor reaches it."""
    nb = int(nb)
    cand = max(32, nb // int(ratio))
    cand = -(-cand // int(tile)) * int(tile)
    return min(nb, cand)


class XYStager:
    """Per-geometry xy staging with explicit buffer lifetime.

    The dispatch loop packs the next launch's ``[width, 2, km]`` int32
    candidate array while earlier launches are in flight, so each buffer
    belongs to its dispatch until the dispatch's readback has resolved:
    :meth:`take` hands out a free-listed (or fresh) buffer and
    :meth:`release` returns the dispatch's buffers after the readback.
    """

    _POOL_CAP = 8  # free buffers kept per geometry

    def __init__(self):
        self._free: Dict[Tuple[int, int], List[np.ndarray]] = {}

    def take(self, launch: Launch, cands) -> np.ndarray:
        key = (launch.km, launch.width)
        pool = self._free.get(key)
        buf = (pool.pop() if pool
               else np.empty((launch.width, 2, launch.km), np.int32))
        buf.fill(-1)
        for j, r in enumerate(launch.rows):
            x, y = cands[r]
            buf[j, 0, :len(x)] = x
            buf[j, 1, :len(y)] = y
        return buf

    def release(self, bufs) -> None:
        for buf in bufs:
            key = (int(buf.shape[2]), int(buf.shape[0]))
            pool = self._free.setdefault(key, [])
            if len(pool) < self._POOL_CAP:
                pool.append(buf)
