"""Cross-job launch fusion: co-schedule candidate waves from CONCURRENT
mines into shared super-batched device launches.

The north star is heavy traffic — thousands of small concurrent mines,
not one big one — yet before this layer each job serially owned the
device: the Miner could run several jobs at once, but every engine
dispatched its own launches, so a small mine's candidate wave paid a
full per-launch dispatch cost while leaving the device mostly idle.
The ragged packer (ops/ragged_batch.py) already solved this problem one
level down (candidate pools *within* a job merge into shared launches
under a cost model); this module lifts the same policy one level up, to
candidate waves *across* jobs — ROADMAP open item 3.

Architecture — the unit of device work becomes the WAVE, not the job:

- **eval waves** (models/tsr.py): an engine on the single-device jnp
  path hands its whole per-dispatch candidate set to the broker instead
  of planning and launching itself.  The broker holds it in a **bounded
  fusion window** (``[fusion] window_ms``, width- and job-capped) keyed
  by device geometry ``(n_seq, n_words)``; waves from different jobs
  that share the key are FUSED: their prep stores concatenate along the
  item axis (padded to a pow2 bucket, so the compiled-program set stays
  enumerable — ``tsr-fused`` keys in utils/shapes.py, walked by
  prewarm), their candidates' item indices shift by each job's offset,
  and one ragged super-batch plan covers all of them with per-lane JOB
  tags (``Launch.jobs``) so the single readback demuxes each lane's
  (sup, supx) back to the job that owns it.  Correctness is positional:
  a candidate's gather touches only its own job's rows, so fused counts
  are bit-identical to solo counts (docs/DESIGN.md).
- **a cost model, not a flag**: fusion is taken iff the packer's own
  arithmetic — with the per-launch overhead recalibrated from the live
  ``fsm_costmodel_drift_ratio`` EWMA — predicts the fused plan beats
  the per-job plans by more than the prep-concat cost (priced in the
  same lane-traffic units).  Groups the model declines dispatch per-job
  (still inside the broker, counted ``rejected``).
- **priority-aware window**: a ``high``-priority job's wave NEVER waits
  out the window behind low fill — it launches immediately, fused with
  whatever is already pending.  Normal/low waves wait at most
  ``window_ms``; the window also closes when pending lanes reach
  ``max_width`` or pending waves reach ``max_jobs``.
- **queue waves** (models/spade_queue.py): the queue engine's unit of
  device work is a whole-mine (or segment) program with per-job carry
  state — unfusable by construction — but it routes through the broker
  too (:func:`dispatch_wave`), so every device wave shares one
  accounting/fault surface and the ``fusion.dispatch`` chaos site
  covers both engines.
- **failure posture**: ANY broker failure — the ``fusion.dispatch``
  fault site, a fused-launch error, a cost-model bug — degrades to
  unfused per-job dispatch; a wave is never lost (counted
  ``fsm_fusion_degraded_total``, swept by tests/test_chaos.py).

Disabled (`[fusion] enabled = false`, the default) every probe is one
module-global read — the same pin as the fault registry and the flight
recorder (scripts/bench_smoke.sh's byte-identical counters hold).

Port of ``spark_fsm_tpu/service/fusion.py``.  What differs:

- the engine hands the broker its own evaluator: on CUDA the kernel
  path's cap and lane with B2 (``ops/rule_support.rule_supports``), on
  the CPU the plain path's cap, lane 32 and ``rule_supports_plain``.
  The reference admits only its jnp path, because its folded Pallas
  layout cannot be concatenated; B2 reads the engine layout, so a fused
  wave on the card launches B2.  Each launch evaluates only its plan's
  real lanes (``xy[:len(L.rows)]``), as the engine's own dispatch does;
- the engine's prep stores are ``[M+1, S*W]`` with an all-ones last row,
  the AND identity every -1 slot of ``xy`` stands for.  The fused store
  (:func:`_fuse_preps`) is each distinct job's M real rows, zero rows up
  to the pow2 bucket ``m_pad`` of the real rows' sum, then one all-ones
  row; offsets count real rows only, so the shifted candidates, ``m_pad``
  and the ``tsr-fused`` keys equal the reference's;
- the plan's overhead is not recalibrated from the live drift gauge
  (``ops/ragged_batch.py``: the factor is 1).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.service import meshguard, usage
from spark_fsm_tpu_torch.utils import faults, jobctl, obs, shapes, watchdog
from spark_fsm_tpu_torch.utils.obs import log_event

_WAVES_TOTAL = obs.REGISTRY.counter(
    "fsm_fusion_waves_total",
    "device waves entering the fusion broker, by engine and outcome")
_LAUNCHES_TOTAL = obs.REGISTRY.counter(
    "fsm_fusion_launches_total",
    "device launches the broker dispatched (cross_job=true when lanes "
    "from more than one job shared the launch)")
_JOBS_PER_LAUNCH = obs.REGISTRY.histogram(
    "fsm_fusion_jobs_per_launch",
    "distinct jobs sharing one broker-dispatched launch",
    buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0))
_WINDOW_WAIT = obs.REGISTRY.histogram(
    "fsm_fusion_window_wait_seconds",
    "how long a wave group sat in the fusion window before launching",
    buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))
_DEGRADED_TOTAL = obs.REGISTRY.counter(
    "fsm_fusion_degraded_total",
    "broker failures degraded to unfused per-job dispatch (no wave lost)")
_REJECTED_TOTAL = obs.REGISTRY.counter(
    "fsm_fusion_rejected_total",
    "window groups the cost model declined to fuse (dispatched per-job)")
_PENDING = obs.REGISTRY.gauge(
    "fsm_fusion_pending_waves", "waves currently held in fusion windows")

# Fast-path flag: every engine probe (eval_enabled / dispatch_wave)
# returns after ONE module-global read when the broker is off — the
# contract utils/faults._active and obs._trace_on pin.
_on = False

_lock = threading.Lock()
_broker: Optional["FusionBroker"] = None


def configure(cfg) -> None:
    """Set the process-wide fusion policy (config.set_config owns it,
    like the watchdog and the flight recorder; tests may call directly
    with a config.FusionConfig)."""
    global _on, _broker
    with _lock:
        if cfg is not None and cfg.enabled:
            if _broker is None:
                _broker = FusionBroker()
            _broker.reconfigure(
                window_s=float(cfg.window_ms) / 1000.0,
                max_jobs=int(cfg.max_jobs),
                max_width=int(cfg.max_width),
                dispatch_workers=int(getattr(cfg, "dispatch_workers", 2)))
            _on = True
        else:
            _on = False
            # pending waves drain on the broker thread regardless — a
            # disable can never strand a ticket an engine is waiting on


def eval_enabled() -> bool:
    return _on


def broker() -> Optional["FusionBroker"]:
    return _broker


class EvalWave:
    """One engine dispatch's whole candidate set, handed to the broker.

    Also the engine-side ticket: :meth:`result` blocks until the broker
    resolved it (fused or solo) and returns ``(sups, supxs, report)``
    in the wave's own candidate order, or raises the launch failure.
    """

    __slots__ = ("uid", "priority", "cands", "pools", "p1", "s1",
                 "eval_fn", "put", "cap", "lane", "n_seq", "n_words",
                 "point", "t_submit", "topology_epoch", "_event", "_sups",
                 "_supxs", "_report", "_error")

    def __init__(self, *, uid: str, priority: str, cands, pools,
                 p1, s1, eval_fn, put, cap, lane: int, n_seq: int,
                 n_words: int, point: str = "jnp"):
        self.uid = uid
        self.priority = priority
        self.cands = cands
        self.pools = pools
        self.p1 = p1
        self.s1 = s1
        self.eval_fn = eval_fn
        self.put = put
        self.cap = cap
        self.lane = int(lane)
        self.n_seq = int(n_seq)
        self.n_words = int(n_words)
        # the evaluator's fault-site label: "kernel" (B2, with the
        # device.oom site) or "jnp" (the plain version)
        self.point = point
        self.t_submit = time.monotonic()
        # topology epoch at submit (service/meshguard.py, None when the
        # plane is off): the broker re-checks at launch time — a row
        # death between submit and dispatch refuses the wave instead of
        # executing it on dead silicon
        self.topology_epoch = meshguard.current_epoch()
        self._event = threading.Event()
        self._sups = self._supxs = None
        self._report: dict = {}
        self._error: Optional[BaseException] = None

    @property
    def key(self) -> Tuple[int, int]:
        """Fusion key: waves fuse only when the compiled sequence-axis
        geometry matches (the item axis concatenates freely)."""
        return (self.n_seq, self.n_words)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, sups, supxs, report: dict) -> None:
        self._sups, self._supxs, self._report = sups, supxs, report
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def result(self):
        """Block until resolved.  Polls the job-control safe point while
        waiting, so a cancel/deadline that lands mid-window aborts the
        job exactly like the engines' own launch-boundary checks."""
        while not self._event.wait(0.05):
            jobctl.check()
        if self._error is not None:
            raise self._error
        return self._sups, self._supxs, self._report


def _mark(uid: str, event: str, **attrs) -> None:
    """Land a point event in a job's trace from a dispatcher thread.
    ``obs.trace_event`` binds to the calling thread's CURRENT span —
    which the fsm-fusion-* threads don't carry outside explicit span
    blocks — so the marker opens a zero-length span on the wave's own
    trace to host it (the ``fusion.joined`` idiom)."""
    with obs.span("fusion.mark", trace_id=uid):
        obs.trace_event(event, **attrs)


class _Group:
    __slots__ = ("waves", "t0")

    def __init__(self):
        self.waves: List[EvalWave] = []
        self.t0 = time.monotonic()


class FusionBroker:
    """The dispatcher: one daemon thread owning the fusion windows.

    Engine threads :meth:`submit` waves and block in
    ``EvalWave.result``; the dispatcher groups same-key waves inside
    the bounded window, decides fuse-vs-separate with the calibrated
    cost model, executes the launches, and demuxes the readback per
    job.  Test hooks: :meth:`hold` / :meth:`release` freeze the window
    so a test can line up a deterministic group; :meth:`drain` blocks
    until nothing is pending or in flight.
    """

    _PREP_CACHE_CAP = 32  # fused-prep LRU entries (device arrays)
    # hard byte budget for the same LRU: entries strong-ref device
    # arrays the engines' eval-width budgets know nothing about, so an
    # entry bound alone could pin many GB of HBM at production prep
    # scale (one 8-job fused pair at the default prewarm envelope is
    # ~1.3 GB); evictions trip on whichever bound is hit first
    _PREP_CACHE_BYTES = 2 << 30

    def __init__(self, window_s: float = 0.004, max_jobs: int = 8,
                 max_width: int = 16384, dispatch_workers: int = 2):
        self.window_s = float(window_s)
        self.max_jobs = int(max_jobs)
        self.max_width = int(max_width)
        self.dispatch_workers = max(1, int(dispatch_workers))
        self._cond = threading.Condition()
        self._groups: Dict[Tuple[int, int], _Group] = {}
        self._busy = 0
        self._held = False
        self._threads: List[threading.Thread] = []
        # one stager per dispatcher thread: XYStager's free lists are
        # not safe under concurrent take(), and per-thread pools cost
        # only a few staging buffers each
        self._tls = threading.local()
        # fused-prep LRU: recurring job groups re-fuse every round, and
        # re-concatenating the same prep stores per round was measured
        # as the broker's dominant overhead.  Entries hold STRONG refs
        # to the source arrays, so an id() key can never be recycled
        # while its entry lives; the LRU bound caps the device memory
        # the cache pins.
        self._prep_cache: "Dict[tuple, tuple]" = {}
        self._prep_order: List[tuple] = []
        self._prep_sizes: Dict[tuple, int] = {}
        self._prep_bytes = 0
        self._prep_lock = threading.Lock()
        self._slock = threading.Lock()  # stats: bumped from dispatcher
        # AND engine threads concurrently; bare dict += would lose counts
        # alongside the actual launch/traffic tally, the broker keeps
        # the SOLO-ALTERNATIVE tally: what the same waves would have
        # dispatched unfused (for fused groups, the per-job plans the
        # cost model compared; for solo waves, identical to the actual).
        # actual vs alternative × the committed cost model is the
        # device-dispatch saving the bench reports — a modeled number
        # on CPU, the real bill on hardware where the device serializes
        # launches.
        self.stats = {"waves": 0, "fused_waves": 0, "solo_waves": 0,
                      "launches": 0, "cross_job_launches": 0,
                      "fused_groups": 0, "rejected_groups": 0,
                      "degraded": 0, "traffic_units": 0,
                      "alt_solo_launches": 0, "alt_solo_units": 0}

    # ------------------------------------------------------------- control

    def reconfigure(self, *, window_s: float, max_jobs: int,
                    max_width: int, dispatch_workers: int = 2) -> None:
        with self._cond:
            self.window_s = window_s
            self.max_jobs = max(1, max_jobs)
            self.max_width = max(32, max_width)
            self.dispatch_workers = max(1, dispatch_workers)
            self._cond.notify_all()

    def _bump(self, **adds) -> None:
        with self._slock:
            for k, v in adds.items():
                self.stats[k] += v

    def hold(self) -> None:
        """Freeze the window (tests): waves accumulate, nothing launches
        until :meth:`release`."""
        with self._cond:
            self._held = True

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()

    def _stager(self) -> RB.XYStager:
        st = getattr(self._tls, "stager", None)
        if st is None:
            st = self._tls.stager = RB.XYStager()
        return st

    def pending(self) -> int:
        with self._cond:
            return sum(len(g.waves) for g in self._groups.values())

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until no wave is pending or in flight (tests)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._cond:
                if not self._held and self._busy == 0 and not any(
                        g.waves for g in self._groups.values()):
                    return True
            time.sleep(0.005)
        return False

    # -------------------------------------------------------------- submit

    def submit(self, wave: EvalWave) -> None:
        with self._cond:
            # dispatcher POOL, not a single thread: groups with
            # different membership are independent device work, and one
            # serialized dispatcher was measured to forfeit exactly the
            # concurrency the Miner's worker pool feeds it (a group
            # blocked in readback must not stall the next matured
            # window).  Threads are spawned lazily up to the configured
            # count; the shared pick loop hands each matured group to
            # exactly one of them.
            while len(self._threads) < self.dispatch_workers:
                t = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"fsm-fusion-{len(self._threads)}")
                self._threads.append(t)
                t.start()
            g = self._groups.get(wave.key)
            if g is None or not g.waves:
                g = self._groups[wave.key] = _Group()
            g.waves.append(wave)
            self._bump(waves=1)
            _PENDING.set(sum(len(x.waves) for x in self._groups.values()))
            self._cond.notify_all()

    # ---------------------------------------------------------- dispatcher

    def _ready_key(self, now: float):
        """(key, deadline_hint): the first window due to launch, else
        (None, soonest expiry).  A high-priority wave makes its group
        due IMMEDIATELY — it fuses with whatever is already pending but
        never waits for more fill."""
        soonest: Optional[float] = None
        for key, g in self._groups.items():
            if not g.waves:
                continue
            if any(w.priority == "high" for w in g.waves):
                return key, None
            if len(g.waves) >= self.max_jobs:
                return key, None
            if sum(len(w.cands) for w in g.waves) >= self.max_width:
                return key, None
            expiry = g.t0 + self.window_s
            if now >= expiry:
                return key, None
            soonest = expiry if soonest is None else min(soonest, expiry)
        return None, soonest

    def _loop(self) -> None:
        while True:
            with self._cond:
                group = None
                while group is None:
                    if self._held:
                        self._cond.wait()
                        continue
                    now = time.monotonic()
                    key, soonest = self._ready_key(now)
                    if key is not None:
                        group = self._groups.pop(key)
                        self._busy += 1
                        _PENDING.set(sum(len(x.waves)
                                         for x in self._groups.values()))
                        break
                    self._cond.wait(None if soonest is None
                                    else max(0.0, soonest - now))
            try:
                self._run_group(group)
            finally:
                with self._cond:
                    self._busy -= 1
                    self._cond.notify_all()

    # ------------------------------------------------------------ execution

    def _run_group(self, group: _Group) -> None:
        waves = group.waves
        wait_s = time.monotonic() - group.t0
        _WINDOW_WAIT.observe(wait_s)
        # topology-epoch fence (service/meshguard.py): a wave planned
        # against a mesh a row death has since invalidated is REFUSED
        # here — failed upward so the orchestrator re-plans onto the
        # survivors, never degraded to a solo launch on dead silicon
        live = []
        for w in waves:
            try:
                meshguard.check_epoch(w.topology_epoch)
            except meshguard.StaleTopology as exc:
                _mark(w.uid, "fusion_stale_epoch", error=str(exc))
                w.fail(exc)
                continue
            live.append(w)
        waves = live
        if not waves:
            return
        try:
            faults.fault_site("fusion.dispatch", point="window",
                              jobs=str(len(waves)))
            if len(waves) >= 2:
                fused_plan, fpools, job_of, slices, offsets = \
                    self._fused_plan(waves)
                alt = self._solo_alternative(waves)
                if self._fusion_wins(waves, fused_plan, offsets, alt):
                    fcands = self._fused_cands(waves, offsets[0])
                    self._launch_fused(waves, fused_plan, fcands,
                                       slices, offsets, wait_s)
                    # alt tally lands only once the fused launch did:
                    # a degraded group re-dispatches through
                    # _launch_solo, which tallies its own alternative —
                    # pre-bumping here would double it and overstate
                    # the modeled saving
                    self._bump(alt_solo_launches=alt[0],
                               alt_solo_units=alt[1])
                    return
                self._bump(rejected_groups=1)
                _REJECTED_TOTAL.inc()
            for w in waves:
                self._launch_solo(w, wait_s)
        except BaseException as exc:
            if isinstance(exc, watchdog.WatchdogTimeout):
                # a watchdog timeout is not a broker fault: the DEVICE
                # is suspect, and re-dispatching every wave solo would
                # run N more unguarded-dispatch launches on a possibly
                # wedged backend, each blocking a dispatcher for its
                # own full deadline.  Fail every unresolved wave upward
                # instead — job supervision owns the re-run (same
                # invariant as TsrTPU._resolve_eval's direct path).
                log_event("fusion_watchdog_timeout", jobs=len(waves),
                          error=str(exc))
                for w in waves:
                    if not w.done:
                        _mark(w.uid, "fusion_watchdog_timeout",
                              jobs=len(waves), error=str(exc))
                        w.fail(exc)
                return
            # DEGRADE, never lose a wave: whatever failed — the chaos
            # site, a fused concat, a launch — every unresolved wave is
            # re-dispatched per-job; a wave whose own solo dispatch
            # also fails gets the failure on its ticket (job
            # supervision owns the retry from there).
            self._bump(degraded=1)
            _DEGRADED_TOTAL.inc()
            log_event("fusion_degraded", jobs=len(waves),
                      error=f"{type(exc).__name__}: {exc}")
            for wi, w in enumerate(waves):
                if w.done:
                    continue
                _mark(w.uid, "fusion_degraded", jobs=len(waves),
                      error=f"{type(exc).__name__}: {exc}")
                try:
                    self._launch_solo(w, wait_s)
                except watchdog.WatchdogTimeout as solo_exc:
                    # same posture as the pre-degrade handler above: a
                    # timeout mid-degrade means the device is suspect,
                    # so the REMAINING waves fail upward too instead of
                    # each blocking a dispatcher for its own deadline
                    log_event("fusion_watchdog_timeout",
                              jobs=len(waves) - wi, error=str(solo_exc))
                    for rest in waves[wi:]:
                        if not rest.done:
                            _mark(rest.uid, "fusion_watchdog_timeout",
                                  jobs=len(waves) - wi,
                                  error=str(solo_exc))
                            rest.fail(solo_exc)
                    return
                except BaseException as solo_exc:
                    w.fail(solo_exc)

    def _fused_plan(self, waves: List[EvalWave]):
        """Merge the group's pools into one fused candidate space.

        Returns (plan, fused pools, job_of, per-wave row slices, prep
        offsets).  Prep stores dedup by identity — a job's pipelined
        waves share one prep, so fusing them costs no extra item rows.
        The shifted candidate tuples are NOT built here — see
        :meth:`_fused_cands`."""
        offsets: Dict[int, int] = {}
        uniq: List[Tuple[object, object]] = []
        off = 0
        for w in waves:
            k = id(w.p1)
            if k not in offsets:
                offsets[k] = off
                uniq.append((w.p1, w.s1))
                # real rows only: each store's all-ones last row is
                # dropped and the fused store gets one of its own
                off += int(w.p1.shape[0]) - 1
        fpools: Dict[int, List[int]] = {}
        jobs: List[int] = []
        uid_ix: Dict[str, int] = {}  # lane tags carry JOB identity, not
        # wave identity: one job's pipelined waves fusing together is
        # intra-job batching, and must not read as a cross-job launch
        slices: List[Tuple[int, int]] = []
        base = 0
        for w in waves:
            for km, rows in w.pools.items():
                fpools.setdefault(int(km), []).extend(
                    r + base for r in rows)
            jid = uid_ix.setdefault(w.uid, len(uid_ix))
            jobs.extend([jid] * len(w.cands))
            slices.append((base, base + len(w.cands)))
            base += len(w.cands)
        lane = max(w.lane for w in waves)
        cap = lambda km: min(self.max_width,
                             min(int(w.cap(km)) for w in waves))
        w0 = waves[0]
        overhead = RB.overhead_units(w0.n_seq, w0.n_words)
        plan = RB.plan_launches(fpools, cap=cap, lane=lane,
                                overhead=overhead,
                                job_of=jobs.__getitem__, record=False)
        return plan, fpools, jobs.__getitem__, slices, \
            (offsets, uniq, off)

    @staticmethod
    def _fused_cands(waves, prep_offsets):
        """Index-shift every wave's candidate tuples into the fused
        prep's row space.  Deferred until the cost model has chosen
        fusion: this is the only per-candidate Python work in the
        group path, and a rejected group must not pay it."""
        fcands: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        for w in waves:
            o = prep_offsets[id(w.p1)]
            for x, y in w.cands:
                fcands.append((tuple(i + o for i in x),
                               tuple(j + o for j in y)))
        return fcands

    def _solo_alternative(self, waves) -> Tuple[int, int]:
        """(launches, traffic units) the group's waves would dispatch
        UNFUSED — the cost model's comparison branch, also tallied in
        ``alt_solo_*`` so actual-vs-alternative × the committed cost
        model gives the broker's device-dispatch saving."""
        w0 = waves[0]
        overhead = RB.overhead_units(w0.n_seq, w0.n_words)
        solo_units = solo_launches = 0
        for w in waves:
            plan = RB.plan_launches(w.pools, cap=w.cap, lane=w.lane,
                                    overhead=overhead, record=False)
            solo_launches += len(plan)
            solo_units += sum(L.traffic_units for L in plan)
        return solo_launches, solo_units

    def _fusion_wins(self, waves, fused_plan, offsets, alt) -> bool:
        """The fusion decision: fused plan + prep-concat cost vs the
        per-job plans (``alt``, computed once by the caller), all in
        the packer's own calibrated units."""
        w0 = waves[0]
        overhead = RB.overhead_units(w0.n_seq, w0.n_words)
        solo_launches, solo_units = alt
        fused_units = sum(L.traffic_units for L in fused_plan)
        # the prep concat streams total_m item rows once — priced as
        # total_m lane-units, the same currency as pad and dispatch
        _, uniq, total_m = offsets
        concat_units = total_m if len(uniq) > 1 else 0
        return (fused_units + len(fused_plan) * overhead + concat_units
                <= solo_units + solo_launches * overhead)

    def _launch_fused(self, waves, plan, fcands, slices, offsets,
                      wait_s: float) -> None:
        prep_offsets, uniq, total_m = offsets
        w0 = waves[0]
        m_pad = RB.next_pow2(max(1, total_m))
        p1f, s1f = self._fused_preps(uniq, m_pad, total_m)
        # span host for record_plan's plan_launches trace event — a
        # dispatcher thread has no current span for it to bind to
        with obs.span("fusion.plan", trace_id=w0.uid, jobs=len(waves)):
            RB.record_plan(plan)
        arr, cols, est_s, measured_s, leaves, halved = self._execute(
            plan, fcands, p1f, s1f, w0, trace_uid=w0.uid,
            fused=True, m_pad=m_pad)
        self._bump(fused_groups=1,
                   traffic_units=sum(L.traffic_units for L in plan))
        self._attribute_fused(waves, leaves, est_s, measured_s)
        cross = sum(1 for L in leaves if L.cross_job)
        report_base = {
            "fused_jobs": len(waves), "launches": len(leaves),
            "cross_job_launches": cross,
            "traffic_units": sum(L.traffic_units for L in plan),
            "window_wait_s": round(wait_s, 6), "m_pad": m_pad,
        }
        if halved:
            report_base["degraded_launches"] = halved
        for wi, w in enumerate(waves):
            lo, hi = slices[wi]
            idx = cols[lo:hi]
            w.resolve(arr[0, idx].astype(np.int64),
                      arr[1, idx].astype(np.int64), dict(report_base))
            self._bump(fused_waves=1)
            _WAVES_TOTAL.inc(engine="tsr", fused="true")
            if wi > 0:
                # a zero-length marker span in every rider's own trace:
                # the fused launch spans live on the leader's
                with obs.span("fusion.joined", trace_id=w.uid,
                              leader=w0.uid, jobs=len(waves),
                              launches=len(leaves)):
                    pass

    @staticmethod
    def _attribute_fused(waves, plan, est_s: float,
                         measured_s: float) -> None:
        """Demux a fused plan's device cost back to the jobs that
        occupied it, by LANE SHARE (the per-lane ``Launch.jobs`` tags
        the planner packed with), under the conservation invariant:
        per-job launches sum to ``len(plan)`` and per-job traffic units
        sum to the plan's total, EXACTLY (largest-remainder integer
        apportionment; pad lanes are charged proportionally).  Seconds
        split proportional to each job's traffic share — floats carry
        no exactness guarantee and none is claimed."""
        if usage.get() is None:
            return
        # rebuild the jid -> uid map: _fused_plan assigns jids by FIRST
        # APPEARANCE of each uid in wave order (uid_ix.setdefault)
        uid_of: Dict[int, str] = {}
        order: Dict[str, int] = {}
        for w in waves:
            jid = order.setdefault(w.uid, len(order))
            uid_of.setdefault(jid, w.uid)
        per: Dict[str, List[int]] = {}  # uid -> [launches, traffic]
        total_traffic = 0
        for L in plan:
            total_traffic += L.traffic_units
            if not L.jobs:
                tally = per.setdefault(waves[0].uid, [0, 0])
                tally[0] += 1
                tally[1] += L.traffic_units
                continue
            counts: Dict[int, int] = {}
            for j in L.jobs:
                counts[j] = counts.get(j, 0) + 1
            jids = sorted(counts)
            weights = [counts[j] for j in jids]
            one = usage.split_integral(1, weights)
            traffic = usage.split_integral(L.traffic_units, weights)
            for i, jid in enumerate(jids):
                tally = per.setdefault(uid_of.get(jid, waves[0].uid),
                                       [0, 0])
                tally[0] += one[i]
                tally[1] += traffic[i]
        for uid, (n_launch, n_traffic) in per.items():
            share = (n_traffic / total_traffic if total_traffic > 0
                     else 1.0 / max(1, len(per)))
            usage.deposit(uid, launches=n_launch,
                          traffic_units=n_traffic,
                          seconds_est=est_s * share,
                          seconds_measured=measured_s * share)

    def _fused_preps(self, uniq, m_pad: int, total_m: int):
        """LRU-cached :func:`_fuse_preps`: a group of pipelining jobs
        re-forms every candidate round, and re-concatenating the same
        prep stores per round was the broker's single largest measured
        overhead.  The key is the (ordered) source identities + the pad
        bucket; each entry strong-refs its sources so a cached id can
        never be a recycled pointer."""
        key = (m_pad,) + tuple(id(p) for p, _ in uniq)
        with self._prep_lock:
            hit = self._prep_cache.get(key)
            if hit is not None:
                self._prep_order.remove(key)
                self._prep_order.append(key)
                return hit[1], hit[2]
        fused = _fuse_preps(uniq, m_pad, total_m)
        # BYTE-bounded, not just entry-bounded: at production prep
        # scale one fused pair is hundreds of MB of HBM the engines'
        # eval budgets know nothing about, so the cache must never pin
        # more than its budget (an entry bigger than half of it is not
        # cached at all — recurring giants would just thrash the rest).
        # An entry's pin is the fused pair PLUS the source preps it
        # strong-refs for key safety — once the owning jobs finish, the
        # cache is what keeps those alive, so they bill against the
        # budget too.
        nbytes = (_nbytes(fused[0]) + _nbytes(fused[1])
                  + sum(_nbytes(a) for pair in uniq for a in pair))
        with self._prep_lock:
            if (key not in self._prep_cache
                    and nbytes <= self._PREP_CACHE_BYTES // 2):
                self._prep_cache[key] = (list(uniq),) + fused
                self._prep_order.append(key)
                self._prep_sizes[key] = nbytes
                self._prep_bytes += nbytes
                while (self._prep_order
                       and (len(self._prep_order) > self._PREP_CACHE_CAP
                            or self._prep_bytes > self._PREP_CACHE_BYTES)):
                    old = self._prep_order.pop(0)
                    del self._prep_cache[old]
                    self._prep_bytes -= self._prep_sizes.pop(old)
        return fused

    def _launch_solo(self, w: EvalWave, wait_s: float) -> None:
        overhead = RB.overhead_units(w.n_seq, w.n_words)
        # span host for the plan's plan_launches trace event (see
        # _launch_fused) — solo planning records itself
        with obs.span("fusion.plan", trace_id=w.uid, jobs=1):
            plan = RB.plan_launches(w.pools, cap=w.cap, lane=w.lane,
                                    overhead=overhead)
        units = sum(L.traffic_units for L in plan)
        self._bump(traffic_units=units, alt_solo_launches=len(plan),
                   alt_solo_units=units)
        arr, cols, est_s, measured_s, leaves, halved = self._execute(
            plan, w.cands, w.p1, w.s1, w, trace_uid=w.uid, fused=False)
        # whole-plan attribution: a solo dispatch (window of one, or a
        # degraded re-dispatch) has exactly one owning job
        usage.deposit(w.uid, launches=len(leaves), traffic_units=units,
                      seconds_est=est_s, seconds_measured=measured_s)
        report = {"fused_jobs": 1, "launches": len(leaves),
                  "cross_job_launches": 0, "traffic_units": units,
                  "window_wait_s": round(wait_s, 6)}
        if halved:
            report["degraded_launches"] = halved
        w.resolve(arr[0, cols].astype(np.int64),
                  arr[1, cols].astype(np.int64), report)
        self._bump(solo_waves=1)
        _WAVES_TOTAL.inc(engine="tsr", fused="false")

    def _execute(self, plan, cands, p1, s1, w0: EvalWave, *,
                 trace_uid: str, fused: bool,
                 m_pad: Optional[int] = None):
        """Dispatch a plan against one prep pair and read it back —
        the broker-side twin of TsrTorch._dispatch_eval, shared by the
        fused and solo paths so they cannot drift.  Each launch takes
        its plan's real lanes only.  A device OOM halves the launch
        (``RB.launch_halving``, the engine's own ladder); returns the
        readback, the column map, the estimate and the wall, the leaf
        launches that ran and the number of halvings."""
        parts: List[object] = []
        cols = np.empty(len(cands), np.int64)
        bufs: List[np.ndarray] = []
        leaves: List[RB.Launch] = []
        halved = 0
        base = 0

        def launch(leaf):
            # the engine's own fault sites: with fusion on this IS the
            # real dispatch call site, and a device.dispatch or
            # device.oom drill must fire here, not vacuously
            faults.fault_site("device.dispatch", point=w0.point,
                              km=str(leaf.km), width=str(leaf.width))
            if w0.point == "kernel":
                faults.fault_site("device.oom", point="kernel",
                                  km=str(leaf.km), width=str(leaf.width))
            xy = self._stager().take(leaf, cands)
            return xy, w0.eval_fn(leaf.km)(p1, s1,
                                           w0.put(xy[:len(leaf.rows)]))

        def span(leaf):
            return obs.span("fusion.launch", trace_id=trace_uid,
                            km=leaf.km, width=leaf.width, jobs=leaf.n_jobs,
                            fused=fused,
                            predicted_s=round(RB.estimate_seconds(
                                leaf.traffic_units, 1, w0.n_seq,
                                w0.n_words), 6))

        def on_halve(leaf):
            nonlocal halved
            halved += 1

        for L in plan:
            for leaf, (xy, part) in RB.launch_halving(L, launch, span,
                                                      on_halve):
                bufs.append(xy)
                cols[leaf.rows] = base + np.arange(len(leaf.rows))
                base += len(leaf.rows)
                parts.append(part)
                leaves.append(leaf)
                self._bump(launches=1,
                           cross_job_launches=1 if leaf.cross_job else 0)
                _LAUNCHES_TOTAL.inc(cross_job=str(leaf.cross_job).lower())
                _JOBS_PER_LAUNCH.observe(leaf.n_jobs)
                if fused and m_pad is not None:
                    shapes.record(shapes.key_tsr_fused(
                        w0.n_seq, w0.n_words, m_pad, leaf.km, leaf.width))
                else:
                    shapes.record(shapes.key_tsr_eval(
                        w0.n_seq, w0.n_words, leaf.km, leaf.width))
        if len(parts) == 1:
            out = parts[0]
        else:
            import torch

            out = torch.cat(parts, dim=1)
        est_s = RB.estimate_seconds(
            sum(L.traffic_units for L in plan), len(plan), w0.n_seq,
            w0.n_words)
        t0 = time.monotonic()
        def read():
            faults.fault_site("device.dispatch", point="readback")
            return out.cpu().numpy()

        with obs.span("fusion.readback", trace_id=trace_uid,
                      predicted_s=round(est_s, 6)) as sp:
            arr = watchdog.run_with_deadline(
                read, watchdog.deadline_s(est_s),
                site="fusion.readback")
            measured_s = time.monotonic() - t0
            sp.set(measured_s=round(measured_s, 6))
            obs.observe_costmodel(
                est_s, measured_s,
                family=("tsr-fused" if fused and m_pad is not None
                        else "tsr-eval"))
        self._stager().release(bufs)
        return arr, cols, est_s, measured_s, leaves, halved


def _nbytes(a) -> int:
    """Bytes of a tensor or an array (0 for anything else)."""
    if hasattr(a, "element_size"):
        return int(a.element_size() * a.numel())
    return int(getattr(a, "nbytes", 0))


def _fuse_preps(uniq, m_pad: int, total_m: int):
    """The fused ``[m_pad+1, S*W]`` prep pair: each distinct store's real
    rows (its all-ones last row dropped) in group order, zero rows up to
    the pow2 bucket ``m_pad`` of their sum ``total_m``, then one all-ones
    row, the AND identity every -1 slot of a fused ``xy`` reads.  Zero
    rows support nothing and no shifted candidate indexes them; the pow2
    bucket keeps the fused geometries a finite, enumerable ladder
    (``tsr-fused`` keys)."""
    import torch

    ref = uniq[0][0]
    tail = tuple(ref.shape[1:])
    # bitmaps are int32 tensors holding the reference's uint32 bits
    pad = torch.zeros((m_pad - total_m,) + tail, dtype=ref.dtype,
                      device=ref.device)
    ones = torch.full((1,) + tail, -1, dtype=ref.dtype, device=ref.device)
    p_parts = [p[:-1] for p, _ in uniq] + [pad, ones]
    s_parts = [s[:-1] for _, s in uniq] + [pad, ones]
    return torch.cat(p_parts, dim=0), torch.cat(s_parts, dim=0)


# ---------------------------------------------------------------------------
# Engine entry points
# ---------------------------------------------------------------------------


def submit_eval(*, cands, pools, p1, s1, eval_fn, put, cap, lane: int,
                n_seq: int, n_words: int, point: str = "jnp",
                priority: Optional[str] = None,
                uid: Optional[str] = None) -> Optional[EvalWave]:
    """Hand one dispatch's candidate set to the fusion broker.  Returns
    the wave ticket, or None when the broker is off (the engine then
    dispatches directly — one global read on that path).  Job identity
    and admission class default to the job-control context the Miner
    binds around each run."""
    if not _on:
        return None
    b = _broker
    if b is None:  # configure race: treat as off
        return None
    if priority is None or uid is None:
        ctl = jobctl.current()
        if priority is None:
            priority = ctl.priority if ctl is not None else "normal"
        if uid is None:
            if ctl is not None:
                uid = ctl.uid
            else:
                # ENGINE identity, not wave identity: outside a jobctl
                # context (library use) one mine's pipelined waves must
                # still share a job tag, or their fusion would read as
                # cross-job in every stat and lane label
                anchor = getattr(eval_fn, "__self__", None)
                uid = f"eng-{id(anchor if anchor is not None else p1):x}"
    wave = EvalWave(uid=uid, priority=priority, cands=cands, pools=pools,
                    p1=p1, s1=s1, eval_fn=eval_fn, put=put, cap=cap,
                    lane=lane, n_seq=n_seq, n_words=n_words, point=point)
    b.submit(wave)
    return wave


def dispatch_wave(engine: str, fn: Callable, **ctx):
    """Route an unfusable device wave (the queue engine's whole-mine or
    segment dispatch) through the broker's accounting/fault surface.
    One global read when the broker is off.  An armed
    ``fusion.dispatch`` fault DEGRADES to a direct dispatch — broker
    failure must never lose a wave.  A ``topology_epoch`` in ``ctx``
    is the meshguard fence: a wave planned against a stale mesh is
    REFUSED (StaleTopology) — that one failure mode must never degrade
    to a direct dispatch on dead silicon."""
    meshguard.check_epoch(ctx.pop("topology_epoch", None))
    if not _on:
        return fn()
    _WAVES_TOTAL.inc(engine=engine, fused="false")
    if _broker is not None:
        _broker._bump(waves=1, solo_waves=1)
    try:
        faults.fault_site("fusion.dispatch", engine=engine, **ctx)
    except faults.FaultInjected as exc:
        _DEGRADED_TOTAL.inc()
        if _broker is not None:
            _broker._bump(degraded=1)
        log_event("fusion_degraded", engine=engine, error=str(exc))
        obs.trace_event("fusion_degraded", engine=engine, error=str(exc))
        return fn()
    with obs.span("fusion.wave", engine=engine, **ctx):
        return fn()
