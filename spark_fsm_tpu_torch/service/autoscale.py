"""Elastic control plane — queue/SLO-driven autoscaling on
the lease substrate.

earlier work built a static-N fleet: leases, stealing, a cluster metrics
plane, per-priority SLO quantiles.  This module closes the loop the
north star ("heavy traffic from millions of users") demands — capacity
follows demand:

- **Leader election**: every replica runs a controller; exactly one
  acts, elected through a short-TTL ``fsm:autoscale:leader`` lease on
  the shared store whose value carries a fencing token from the SAME
  ``fsm:lease:token`` sequence the job leases use — a stale leader's
  decision records are ordered (and ignorable) by token, and a dead
  leader stalls the loop for at most ``leader_ttl_s``.

- **Signals** (read from the heartbeat-cadence peer cache — the
  controller never scans the store): cluster queue depth and free
  capacity from :meth:`LeaseManager.cluster_view`, and the local
  ``/admin/slo`` e2e p99 (the leader's own window; every replica
  observes its own finishes, and under load every replica finishes
  jobs — documented approximation, not a fleet-wide quantile merge).

- **Hysteresis**: a signal becomes a decision only after holding
  continuously for ``hold_s``, and decisions are at least
  ``cooldown_s`` apart — load oscillating inside the band produces
  ZERO decisions (the flap test pins it).

- **Scale-up** publishes a desired-replica-count record
  (``fsm:autoscale:desired``: desired/current/reason/ts/seq/leader) and
  appends it to the ``fsm:autoscale:log`` ring.  The record is a
  REQUEST to the environment: an operator hook, scripts/fleet.py, or a
  k8s controller watches it and boots replicas — the control plane
  decides, the environment supplies (docs/OPERATIONS.md runbook).

- **Scale-down** picks the least-loaded replica (min running+queued,
  draining replicas excluded) and writes a drain DIRECTIVE
  (``fsm:autoscale:drain:{replica}``, short PX so a stale directive
  dies on its own).  The victim's own controller claims the directive
  on its next tick (atomic DEL — exactly one drain per directive) and
  drives :meth:`Miner.drain`: stop admitting → peers steal the queue →
  release leases → exit, the protocol earlier work already supports.  A
  ``fsm:autoscale:drained:{replica}`` record publishes the drain
  report for the supervisor to reap the process.

Disabled (``[autoscale] enabled = false``, the default) nothing is
built and nothing ticks; the config layer refuses ``autoscale`` without
``[cluster]`` (the lease substrate IS the transport).

Port: a copy of ``spark_fsm_tpu/service/autoscale.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional

from spark_fsm_tpu_torch import config
from spark_fsm_tpu_torch.service import obsplane
from spark_fsm_tpu_torch.utils import envelope, obs
from spark_fsm_tpu_torch.utils.obs import log_event


def _open(raw) -> dict:
    """Tolerant verified decode of one autoscale control record:
    envelope unwrap (legacy bare JSON accepted) + json.loads, ``{}``
    for anything rotten.  Control records are re-derived every decide
    cadence, so the degradation posture for corruption is simply a
    skipped epoch — never a crashed control loop."""
    payload, _verdict = envelope.unwrap(raw)
    if payload is None:
        return {}
    try:
        rec = json.loads(payload)
    except ValueError:
        return {}
    return rec if isinstance(rec, dict) else {}

LEADER_KEY = "fsm:autoscale:leader"
DESIRED_KEY = "fsm:autoscale:desired"
LOG_KEY = "fsm:autoscale:log"
LOG_KEEP = 64
_TOKEN_KEY = "fsm:lease:token"  # the lease layer's fencing sequence


def drain_key(replica_id: str) -> str:
    return f"fsm:autoscale:drain:{replica_id}"


def drained_key(replica_id: str) -> str:
    return f"fsm:autoscale:drained:{replica_id}"


_LEADER = obs.REGISTRY.gauge(
    "fsm_autoscale_leader",
    "1 while this replica holds the autoscale leader lease")
_LEADER.set(0)
_DESIRED = obs.REGISTRY.gauge(
    "fsm_autoscale_desired_replicas",
    "the published desired replica count (last decision record; 0 "
    "until a first decision exists)")
_DESIRED.set(0)
_EVALS = obs.REGISTRY.counter(
    "fsm_autoscale_evals_total",
    "controller evaluations while holding the leader lease")
_DECISIONS = (obs.REGISTRY.counter(
    "fsm_autoscale_decisions_total",
    "published scale decisions, by direction")
    .seed(dir="up").seed(dir="down"))
_DIRECTIVES = obs.REGISTRY.counter(
    "fsm_autoscale_drain_directives_total",
    "drain directives claimed and acted on by THIS replica (the "
    "scale-down victim side)")


class Autoscaler:
    """One per replica.  ``decide_every_s=None`` resolves to
    ``leader_ttl_s / 3`` (the lease must be renewed faster than it
    expires); ``0`` means MANUAL ticks (tests).  ``clock`` is the same
    injectable monotonic source the lease layer uses, so the hermetic
    suite drives election, hysteresis and cooldown on a virtual
    clock."""

    def __init__(self, miner, mgr, acfg=None,
                 decide_every_s: Optional[float] = None,
                 clock=time.monotonic,
                 on_drained: Optional[Callable[[dict], None]] = None):
        acfg = acfg if acfg is not None else config.get_config().autoscale
        self.miner = miner
        self.mgr = mgr
        self._store = mgr._store
        self.min_replicas = int(acfg.min_replicas)
        self.max_replicas = int(acfg.max_replicas)
        self.up_queue_per_worker = float(acfg.up_queue_per_worker)
        self.up_p99_s = float(acfg.up_p99_s)
        # predictive scale-up (ROADMAP item 4
        # remainder): EWMA-smoothed fleet admission rate + its
        # derivative, from the heartbeat-piggybacked lifetime "adm"
        # counters; 0 disables the signal entirely
        self.up_rate_derivative = float(acfg.up_rate_derivative)
        self.rate_alpha = float(acfg.rate_alpha)
        self._adm_last: Optional[tuple] = None  # (t, fleet admitted)
        self._rate_ewma: Optional[float] = None
        self._deriv_ewma: Optional[float] = None
        self.down_free_frac = float(acfg.down_free_frac)
        self.hold_s = float(acfg.hold_s)
        self.cooldown_s = float(acfg.cooldown_s)
        self.leader_ttl_s = float(acfg.leader_ttl_s)
        self.drain_timeout_s = float(acfg.drain_timeout_s)
        if decide_every_s is None:
            decide_every_s = (acfg.decide_every_s
                              or self.leader_ttl_s / 3.0)
        self.decide_every_s = float(decide_every_s)
        self._clock = clock
        self.on_drained = on_drained
        self._ttl_ms = max(1, int(self.leader_ttl_s * 1000))
        self._lock = threading.Lock()
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._last_decision_t: Optional[float] = None
        self._last: dict = {}  # last evaluation snapshot (stats())
        self._drain_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def build_for(cls, miner, **kw) -> Optional["Autoscaler"]:
        """The Master's constructor hook: an autoscaler when the boot
        config enables the control plane (requires the miner's lease
        manager — config validation enforces [cluster]), else None."""
        if not config.get_config().autoscale.enabled:
            return None
        if miner._lease is None:
            return None
        return cls(miner, miner._lease, **kw)

    # ----------------------------------------------------------- election

    def _lead(self) -> bool:
        """One election round-trip: NX-acquire the leader lease or
        re-arm it when already ours.  The value carries a token from
        the lease layer's fencing sequence, so any two leader epochs
        are strictly ordered."""
        raw = self._store.peek(LEADER_KEY)
        if raw is not None:
            if _open(raw).get("replica") == self.mgr.replica_id:
                return bool(self._store.pexpire(LEADER_KEY, self._ttl_ms))
            return False
        token = int(self._store.incr(_TOKEN_KEY))
        ok = self._store.set_px(
            LEADER_KEY,
            envelope.wrap(json.dumps(
                {"replica": self.mgr.replica_id, "token": token})),
            self._ttl_ms, nx=True)
        if ok:
            log_event("autoscale_leader_acquired",
                      replica=self.mgr.replica_id, token=token)
        return bool(ok)

    # ------------------------------------------------------------ signals

    def _slo_p99(self) -> Optional[float]:
        """Worst per-priority e2e p99 over the local sliding window
        (None before any job finished here)."""
        try:
            snap = obsplane.slo_snapshot()
        except Exception:
            return None
        worst = None
        for row in snap.get("priorities", {}).values():
            e2e = row.get("e2e") or {}
            if (e2e.get("count") or 0) > 0 and e2e.get("p99") is not None:
                worst = e2e["p99"] if worst is None \
                    else max(worst, e2e["p99"])
        return worst

    @staticmethod
    def _fleet_p99(rows, local: Optional[float]) -> Optional[float]:
        """FLEET-WIDE up_p99 signal: the max over
        the local window and every live replica's heartbeat-piggybacked
        SLO digest — an idle leader is no longer blind while a peer
        saturates.  Digest-less rows (old replicas, empty windows)
        contribute nothing; the merge can only RAISE the signal, never
        mask a hot local window."""
        worst = local
        for r in rows:
            digest = r.get("slo") or {}
            p99 = digest.get("p99")
            if p99 is None or not (digest.get("n") or 0):
                continue
            try:
                p99 = float(p99)
            except (TypeError, ValueError):
                continue
            worst = p99 if worst is None else max(worst, p99)
        return worst

    def _admission_derivative(self, rows, now: float) -> Optional[float]:
        """EWMA of the fleet admission-rate DERIVATIVE (jobs/s per
        second).  Each tick differentiates the fleet's lifetime
        admitted sum against the previous tick, EWMA-smooths the rate,
        then EWMA-smooths the rate's slope — two stages of smoothing
        plus the caller's hold_s window are the hysteresis guard: a
        single bursty tick cannot fake sustained acceleration.  The
        fleet sum steps DOWN when a replica leaves (its lifetime
        counter vanishes with its heartbeat) — a counting artifact,
        not a demand signal, so a negative raw delta RE-BASELINES the
        estimator (fresh warm-up from the new fleet sum) instead of
        feeding a phantom deceleration into the slope, which would
        cancel a pending scale-up exactly when capacity was lost."""
        if self.up_rate_derivative <= 0:
            return None
        adm = sum(int(r.get("adm") or 0) for r in rows)
        last = self._adm_last
        self._adm_last = (now, adm)
        if last is None:
            return None
        dt = now - last[0]
        if dt <= 0:
            return self._deriv_ewma
        if adm < last[1]:
            self._rate_ewma = None
            self._deriv_ewma = None
            return None
        rate = (adm - last[1]) / dt
        a = self.rate_alpha
        prev_rate = self._rate_ewma
        self._rate_ewma = (rate if prev_rate is None
                           else a * rate + (1 - a) * prev_rate)
        if prev_rate is None:
            return None
        deriv = (self._rate_ewma - prev_rate) / dt
        self._deriv_ewma = (deriv if self._deriv_ewma is None
                            else a * deriv + (1 - a) * self._deriv_ewma)
        return self._deriv_ewma

    # ----------------------------------------------------------- decisions

    def _publish(self, direction: str, desired: int, replicas: int,
                 reason: str, victim: Optional[str] = None) -> None:
        token = int(self._store.incr(_TOKEN_KEY))
        rec = {"desired": desired, "replicas": replicas,
               "dir": direction, "reason": reason,
               "victim": victim,
               "leader": self.mgr.replica_id, "seq": token,
               "ts": round(time.time(), 3)}
        payload = envelope.wrap(json.dumps(rec))
        self._store.set(DESIRED_KEY, payload)
        try:
            self._store.rpush(LOG_KEY, payload)
            n = self._store.llen(LOG_KEY)
            while n > LOG_KEEP:
                self._store.lpop(LOG_KEY)
                n -= 1
        except Exception:
            pass  # the log ring is evidence, not control flow
        if victim is not None:
            # short-PX directive: a victim that never claims it (crashed
            # between decision and tick) lets it expire instead of
            # draining a future incarnation out of the blue
            self._store.set_px(
                drain_key(victim), payload,
                max(self._ttl_ms * 4, int(self.drain_timeout_s * 1000)))
        _DESIRED.set(desired)
        _DECISIONS.inc(dir=direction)
        self._last_decision_t = self._clock()
        self._up_since = self._down_since = None
        log_event("autoscale_decision", **rec)

    def _decide(self) -> None:
        view = self.mgr.cluster_view(
            max_age_s=max(self.mgr.heartbeat_s, 0.5))
        rows = view["replicas"]
        live = [r for r in rows if not r.get("draining")]
        replicas = len(live)
        workers = sum(int(r.get("workers") or 0) for r in live)
        queued = sum(int(r.get("queued") or 0) for r in live)
        free = sum(int(r.get("free") or 0) for r in live)
        p99 = self._fleet_p99(live, self._slo_p99())
        load = queued / max(1, workers)
        free_frac = free / max(1, workers)
        deriv = self._admission_derivative(live, self._clock())
        deriv_up = (self.up_rate_derivative > 0 and deriv is not None
                    and deriv >= self.up_rate_derivative)
        up = (load > self.up_queue_per_worker
              or (self.up_p99_s > 0 and p99 is not None
                  and p99 > self.up_p99_s)
              or deriv_up)
        down = (not up and queued == 0
                and free_frac >= self.down_free_frac
                and replicas > self.min_replicas)
        now = self._clock()
        # hysteresis: a signal's clock starts when it first holds and
        # resets the moment it breaks — oscillation inside the band
        # never accumulates hold time, so it never becomes a decision
        # (`is None`, not truthiness: a virtual clock starts at 0.0)
        self._up_since = (now if self._up_since is None
                          else self._up_since) if up else None
        self._down_since = (now if self._down_since is None
                            else self._down_since) if down else None
        in_cooldown = (self._last_decision_t is not None
                       and now - self._last_decision_t < self.cooldown_s)
        with self._lock:
            self._last = {
                "replicas": replicas, "workers": workers,
                "queued": queued, "free": free,
                "load_per_worker": round(load, 3),
                "free_frac": round(free_frac, 3),
                "p99_s": p99, "up": up, "down": down,
                "adm_rate_ewma": (round(self._rate_ewma, 4)
                                  if self._rate_ewma is not None
                                  else None),
                "adm_deriv_ewma": (round(deriv, 5)
                                   if deriv is not None else None),
                # `is not None`: a virtual clock's since-stamp can be
                # 0.0 (same guard as the decision path above)
                "held_up_s": (round(now - self._up_since, 3)
                              if self._up_since is not None else 0.0),
                "held_down_s": (round(now - self._down_since, 3)
                                if self._down_since is not None
                                else 0.0),
                "in_cooldown": in_cooldown}
        if in_cooldown:
            return
        if up and now - self._up_since >= self.hold_s:
            if replicas >= self.max_replicas:
                return
            if load > self.up_queue_per_worker:
                reason = (f"queued/worker {load:.2f} > "
                          f"{self.up_queue_per_worker}")
            elif (self.up_p99_s > 0 and p99 is not None
                  and p99 > self.up_p99_s):
                reason = f"e2e p99 {p99:.2f}s > {self.up_p99_s}s"
            else:
                reason = (f"admission rate accelerating: d(rate)/dt "
                          f"EWMA {deriv:.4f} >= "
                          f"{self.up_rate_derivative} jobs/s^2")
            self._publish("up", replicas + 1, replicas, reason)
            return
        if down and now - self._down_since >= self.hold_s:
            victim = min(
                live,
                key=lambda r: (int(r.get("running") or 0)
                               + int(r.get("queued") or 0),
                               str(r.get("replica") or "")))
            self._publish(
                "down", replicas - 1, replicas,
                f"free capacity {free_frac:.2f} >= "
                f"{self.down_free_frac} with an empty queue",
                victim=str(victim.get("replica") or ""))

    # ----------------------------------------------------- victim (drain)

    def _check_drain_directive(self) -> bool:
        """Claim a drain directive addressed to THIS replica (atomic
        DEL — exactly one drain per directive) and drive the drain on
        its own thread; the controller keeps ticking so the heartbeat/
        lease machinery stays alive through the drain."""
        key = drain_key(self.mgr.replica_id)
        try:
            raw = self._store.peek(key)
            if raw is None:
                return False
            if self._store.delete(key) < 1:
                return False  # raced another claimant (shouldn't exist)
        except Exception as exc:
            log_event("autoscale_directive_check_failed", error=str(exc))
            return False
        rec = _open(raw)
        _DIRECTIVES.inc()
        log_event("autoscale_drain_claimed", replica=self.mgr.replica_id,
                  directive=rec)
        if self._drain_thread is not None and self._drain_thread.is_alive():
            return True

        def _run():
            report = self.miner.drain(
                timeout_s=self.drain_timeout_s,
                reason=rec.get("reason") or "autoscale directive")
            try:
                self._store.set_px(
                    drained_key(self.mgr.replica_id),
                    envelope.wrap(json.dumps(
                        {"report": report,
                         "ts": round(time.time(), 3)})),
                    10 * 60 * 1000)
            except Exception:
                pass
            cb = self.on_drained
            if cb is not None:
                try:
                    cb(report)
                except Exception as exc:
                    log_event("autoscale_on_drained_failed",
                              error=str(exc))

        self._drain_thread = threading.Thread(
            target=_run, daemon=True,
            name=f"fsm-drain-{self.mgr.replica_id[:8]}")
        self._drain_thread.start()
        return True

    # ------------------------------------------------------- control loop

    def tick(self) -> None:
        """One controller step: act on a drain directive addressed to
        us, else run the (leader-gated) evaluation.  Every phase is
        isolated: a store hiccup logs and the thread lives on."""
        try:
            if self._check_drain_directive():
                # a drain victim is no leader: clear the gauge NOW — a
                # drained ex-leader must not export leader=1 next to
                # its successor's 1 for the whole drain window
                _LEADER.set(0)
                return
        except Exception as exc:
            log_event("autoscale_directive_failed", error=str(exc))
        if getattr(self.miner, "draining", False):
            _LEADER.set(0)
            return  # a draining replica evaluates nothing
        try:
            if not self._lead():
                _LEADER.set(0)
                return
            _LEADER.set(1)
            _EVALS.inc()
            self._decide()
        except Exception as exc:
            log_event("autoscale_tick_failed", error=str(exc))

    def _loop(self) -> None:
        while not self._stop.wait(self.decide_every_s):
            self.tick()

    def start(self) -> None:
        if self.decide_every_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fsm-autoscale-{self.mgr.replica_id[:8]}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(max(2.0, 2 * self.decide_every_s))
            self._thread = None
        # drop the leader lease so a successor takes over immediately
        try:
            raw = self._store.peek(LEADER_KEY)
            if raw is not None and _open(raw).get(
                    "replica") == self.mgr.replica_id:
                self._store.delete(LEADER_KEY)
        except Exception:
            pass
        _LEADER.set(0)

    # -------------------------------------------------------------- admin

    def desired(self) -> Optional[dict]:
        try:
            raw = self._store.peek(DESIRED_KEY)
            return (_open(raw) or None) if raw else None
        except Exception:
            return None

    def decision_log(self, n: int = 16) -> List[dict]:
        try:
            rows = self._store.lrange(LOG_KEY)
        except Exception:
            return []
        out = []
        for raw in rows[-n:]:
            rec = _open(raw)
            if rec:
                out.append(rec)
        return out

    def stats(self) -> dict:
        with self._lock:
            last = dict(self._last)
        leader = None
        try:
            raw = self._store.peek(LEADER_KEY)
            leader = _open(raw).get("replica") if raw else None
        except Exception:
            pass
        return {"enabled": True,
                "replica": self.mgr.replica_id,
                "leader": leader,
                "is_leader": leader == self.mgr.replica_id,
                "draining": bool(getattr(self.miner, "draining", False)),
                "bounds": [self.min_replicas, self.max_replicas],
                "up_queue_per_worker": self.up_queue_per_worker,
                "up_p99_s": self.up_p99_s,
                "down_free_frac": self.down_free_frac,
                "hold_s": self.hold_s, "cooldown_s": self.cooldown_s,
                "decide_every_s": self.decide_every_s,
                "last_eval": last,
                "desired": self.desired(),
                "decisions": self.decision_log()}


def build_for(miner, **kw) -> Optional[Autoscaler]:
    return Autoscaler.build_for(miner, **kw)
