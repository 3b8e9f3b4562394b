"""The elastic control plane on the port (``spark_fsm_tpu_torch/service/
autoscale.py`` and ``Miner.drain``), against the reference's
``tests/test_autoscale.py``.

Each test of the reference is one test here, parametrised over the two
packages (``_torch_cluster_rig.PKGS``).  The hermetic controller tests
run autoscalers, lease managers and an in-process store on one virtual
clock and record the decisions (the desired-count record without its
wall-clock stamp, the decision log's sequence, the leader records, the
``fsm_autoscale_decisions_total`` deltas).  The drain drills run real
Miners, the port's on its engines on the CPU, on the same seeded input and
record each job's status, the drain report, the oracle parity of the
stolen jobs, the settled bookkeeping and the ``fsm_replica_drains_*``,
``fsm_steal_*`` and ``fsm_recovery_*`` families they moved.  The port's
record must equal the reference's.
"""

import json
import threading
import time

import pytest

from _torch_cluster_rig import (DRILL_TIMEOUT_S, NAMES, PKGS, PortOnCpu,
                                Twins, assert_covers, await_terminal,
                                restored, text_of)

T = Twins(PKGS, families=("fsm_autoscale_decisions", "fsm_replica_drains",
                          "fsm_steal_", "fsm_recovery_jobs"))


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


def test_covers_the_reference():
    assert_covers(globals(), "test_autoscale.py")


def _acfg(P, **kw):
    base = {"min_replicas": 1, "max_replicas": 8,
            "up_queue_per_worker": 2.0, "down_free_frac": 0.5,
            "hold_s": 10.0, "cooldown_s": 30.0, "leader_ttl_s": 3.0,
            "drain_timeout_s": 60.0}
    base.update(kw)
    return P.config.parse_config(
        {"autoscale": {"enabled": True, **base},
         "cluster": {"enabled": True}}).autoscale


class FakeMiner:
    """Duck-typed load source for controller-only tests (the reference
    test's)."""

    def __init__(self, workers=2):
        self.q = 0
        self.r = 0
        self.w = workers
        self.adm = 0
        self.draining = False
        self.drained_with = None

    def admitted_total(self):
        return self.adm

    def queue_size(self):
        return self.q

    def running_count(self):
        return self.r

    def worker_count(self):
        return self.w

    def idle_capacity(self):
        return max(0, self.w - self.r - self.q)

    def sheds_total(self):
        return 0

    def wall_ewma(self):
        return None

    def tenant_depths(self):
        return {}

    def inflight_fps(self):
        return []

    def drain(self, timeout_s=None, reason=""):
        self.draining = True
        self.drained_with = {"timeout_s": timeout_s, "reason": reason}
        return {"outcome": "clean", "reason": reason,
                "left_for_recovery": 0}


def _rig(P, n=2, **acfg_kw):
    t = [0.0]
    store = P.store.ResultStore(clock=lambda: t[0])
    out = []
    cfg = _acfg(P, **acfg_kw)
    for i in range(n):
        mgr = P.lease.LeaseManager(store, replica_id=f"as-{i}",
                                   lease_ttl_s=30.0, heartbeat_s=0,
                                   clock=lambda: t[0])
        m = FakeMiner()
        mgr.start(m)
        sc = P.autoscale.Autoscaler(m, mgr, acfg=cfg, decide_every_s=0,
                                    clock=lambda: t[0])
        out.append((sc, m, mgr))
    return t, store, out


def _decisions(P):
    fam = P.obs.REGISTRY.snapshot().get("fsm_autoscale_decisions_total", {})
    fam = fam if isinstance(fam, dict) else {}
    return {"up": fam.get("dir=up", 0), "down": fam.get("dir=down", 0)}


def _desired(P, store):
    """The desired-count record without its wall-clock stamp."""
    raw = store.peek(P.autoscale.DESIRED_KEY)
    if raw is None:
        return None
    rec = P.autoscale._open(raw)
    rec.pop("ts")
    return rec


# ---------------------------------------------------------------- election


def _election(P):
    AS = P.autoscale
    t, store, rigs = _rig(P, 2)
    (sc_a, _, _), (sc_b, _, _) = rigs
    sc_a.tick()
    sc_b.tick()
    first = AS._open(store.peek(AS.LEADER_KEY))
    leaders = [sc_a.stats()["is_leader"], sc_b.stats()["is_leader"]]
    t[0] = 10.0
    sc_b.tick()
    second = AS._open(store.peek(AS.LEADER_KEY))
    rec = {"first": [first["replica"], first["token"]], "leaders": leaders,
           "second": [second["replica"], second["token"]]}
    assert rec["first"][0] == "as-0" and leaders == [True, False]
    assert rec["second"][0] == "as-1" and second["token"] > first["token"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_exactly_one_leader_and_failover_after_ttl(pkg):
    T.held(pkg, _election)


# --------------------------------------------------------------- decisions


def _sustained(P):
    t, store, rigs = _rig(P, 1, hold_s=10.0, cooldown_s=100.0)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    m.q = 10
    sc.tick()
    held = [_desired(P, store)]
    t[0] = 5.0
    sc.tick()
    held.append(_desired(P, store))
    t[0] = 10.0
    sc.tick()
    rec = {"held": held, "desired": _desired(P, store),
           "log_seq": sc.decision_log()[-1]["seq"]}
    d1 = _decisions(P)
    t[0] = 25.0
    sc.tick()
    rec["ups"] = [d1["up"] - d0["up"], _decisions(P)["up"] - d0["up"]]
    want = rec["desired"]
    assert held == [None, None]
    assert want["dir"] == "up" and want["desired"] == 2 \
        and want["replicas"] == 1 and want["leader"] == "as-0"
    assert "queued/worker" in want["reason"] and want["seq"] > 0
    assert rec["log_seq"] == want["seq"] and rec["ups"] == [1, 1]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_sustained_load_scales_up_once_after_hold(pkg):
    T.held(pkg, _sustained)


def _oscillating(P):
    t, store, rigs = _rig(P, 1, hold_s=10.0)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    for i in range(40):
        m.q = 10 if i % 2 == 0 else 1
        t[0] += 4.0
        sc.tick()
    rec = {"decided": _decisions(P) != d0, "desired": _desired(P, store)}
    assert rec == {"decided": False, "desired": None}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_oscillating_load_inside_the_band_never_decides(pkg):
    T.held(pkg, _oscillating)


def _p99(P):
    t, store, rigs = _rig(P, 1, up_p99_s=1.0, hold_s=0.0)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    P.obsplane.clear_slo()
    try:
        for _ in range(20):
            P.obsplane.observe_job("normal", 5.0, 1.0, 4.0)
        t[0] = 1.0
        sc.tick()
        rec = {"desired": _desired(P, store),
               "ups": _decisions(P)["up"] - d0["up"]}
    finally:
        P.obsplane.clear_slo()
    assert rec["desired"]["dir"] == "up" and "p99" in rec["desired"]["reason"]
    assert rec["ups"] == 1
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_p99_signal_scales_up(pkg):
    T.held(pkg, _p99)


def _derivative(P):
    t, store, rigs = _rig(P, 1, up_rate_derivative=0.5, hold_s=3.0,
                          cooldown_s=100.0)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    for i in range(8):
        t[0] = float(i)
        m.adm += 5
        sc.tick()
    steady = {"desired": _desired(P, store),
              "decided": _decisions(P) != d0,
              "last": sc.stats()["last_eval"]}
    rate, fired_at = 5, None
    for i in range(8, 20):
        t[0] = float(i)
        rate += 4
        m.adm += rate
        sc.tick()
        if store.peek(P.autoscale.DESIRED_KEY) is not None:
            fired_at = i
            break
    rec = {"steady_desired": steady["desired"],
           "steady_decided": steady["decided"],
           "steady_rate": steady["last"]["adm_rate_ewma"],
           "steady_deriv": steady["last"]["adm_deriv_ewma"],
           "fired_at": fired_at, "desired": _desired(P, store),
           "ups": _decisions(P)["up"] - d0["up"],
           "queued": sc.stats()["last_eval"]["queued"]}
    assert rec["steady_desired"] is None and not rec["steady_decided"]
    assert rec["steady_rate"] is not None
    assert abs(rec["steady_deriv"] or 0.0) < 0.5
    assert fired_at is not None and rec["desired"]["dir"] == "up"
    assert "rate" in rec["desired"]["reason"] \
        and "d(rate)/dt" in rec["desired"]["reason"]
    assert rec["ups"] == 1 and rec["queued"] == 0
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_admission_rate_derivative_scales_up_predictively(pkg):
    T.held(pkg, _derivative)


def _derivative_off(P):
    t, store, rigs = _rig(P, 1, hold_s=0.0, cooldown_s=0.0)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    rate = 1
    for i in range(10):
        t[0] = float(i)
        rate *= 2
        m.adm += rate
        sc.tick()
    rec = {"desired": _desired(P, store), "decided": _decisions(P) != d0}
    assert rec == {"desired": None, "decided": False}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_admission_rate_derivative_off_by_default(pkg):
    T.held(pkg, _derivative_off)


def _fleet_p99(P):
    AS = P.autoscale
    t, store, rigs = _rig(P, 2, up_p99_s=1.0, hold_s=0.0)
    (sc_a, m_a, mgr_a), (sc_b, m_b, mgr_b) = rigs
    d0 = _decisions(P)
    P.obsplane.clear_slo()
    try:
        mgr_b.publish_heartbeat()
        hb = AS._open(store.peek("fsm:replica:as-1"))
        has_slo = "slo" in hb
        hb["slo"] = {"p99": 6.5, "n": 40}
        store.set_px("fsm:replica:as-1", json.dumps(hb), 30000)
        t[0] = 1.0
        sc_a.tick()
        rec = {"has_slo": has_slo, "desired": _desired(P, store),
               "p99_s": sc_a.stats()["last_eval"]["p99_s"],
               "ups": _decisions(P)["up"] - d0["up"]}
    finally:
        P.obsplane.clear_slo()
    assert rec["has_slo"] and rec["desired"]["dir"] == "up"
    assert "p99" in rec["desired"]["reason"] and rec["p99_s"] == 6.5
    assert rec["ups"] == 1
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_fleet_p99_merge_scales_up_from_a_peer_digest(pkg):
    T.held(pkg, _fleet_p99)


def _wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def _scale_down(P):
    AS = P.autoscale
    t, store, rigs = _rig(P, 2, hold_s=5.0, min_replicas=1,
                          down_free_frac=0.5)
    (sc_a, m_a, mgr_a), (sc_b, m_b, mgr_b) = rigs
    m_a.r, m_b.r = 1, 0
    mgr_b.publish_heartbeat()
    d0 = _decisions(P)
    sc_a.tick()
    t[0] = 5.0
    mgr_b.publish_heartbeat()
    sc_a.tick()
    rec = {"desired": _desired(P, store),
           "downs": _decisions(P)["down"] - d0["down"],
           "directive": store.peek(AS.drain_key("as-1")) is not None}
    sc_b.tick()
    rec["draining"] = _wait_for(lambda: m_b.draining)
    rec["reason"] = bool((m_b.drained_with or {}).get("reason"))
    rec["drained"] = _wait_for(
        lambda: store.peek(AS.drained_key("as-1")) is not None)
    rec["claimed"] = store.peek(AS.drain_key("as-1")) is None
    want = rec["desired"]
    assert want["dir"] == "down" and want["desired"] == 1 \
        and want["victim"] == "as-1"
    assert rec["downs"] == 1 and rec["directive"]
    assert rec["draining"] and rec["reason"] and rec["drained"] \
        and rec["claimed"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_scale_down_targets_least_loaded_and_respects_min(pkg):
    T.held(pkg, _scale_down)


def _at_min(P):
    t, store, rigs = _rig(P, 1, hold_s=0.0, min_replicas=1)
    sc, m, mgr = rigs[0]
    d0 = _decisions(P)
    t[0] = 100.0
    sc.tick()
    rec = {"decided": _decisions(P) != d0}
    assert rec == {"decided": False}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_no_scale_down_at_min_replicas(pkg):
    T.held(pkg, _at_min)


def _draining_stops(P):
    t, store, rigs = _rig(P, 1)
    sc, m, mgr = rigs[0]
    m.draining = True
    m.q = 100
    t[0] = 100.0
    sc.tick()
    sc.tick()
    rec = {"leader": store.peek(P.autoscale.LEADER_KEY)}
    assert rec == {"leader": None}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_draining_replica_stops_evaluating(pkg):
    T.held(pkg, _draining_stops)


def _config_validation(P):
    cases = [({"autoscale": {"enabled": True}}, "cluster"),
             ({"autoscale": {"min_replicas": 4, "max_replicas": 2}},
              "max_replicas"),
             ({"autoscale": {"down_free_frac": 1.5}}, "down_free_frac"),
             ({"autoscale": {"leader_ttl_s": 0}}, "leader_ttl_s"),
             ({"autoscale": {"up_queue_per_worker": 0}},
              "up_queue_per_worker")]
    errors = []
    for cfg, match in cases:
        with pytest.raises(P.config.ConfigError, match=match) as exc:
            P.config.parse_config(cfg)
        errors.append(str(exc.value))
    return {"errors": errors}


@pytest.mark.parametrize("pkg", NAMES)
def test_autoscale_config_validation(pkg):
    T.held(pkg, _config_validation)


# ------------------------------------------------------------ drain drills


def _req(P, uid, **extra):
    data = {"algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
            "uid": uid}
    data.update({k: str(v) for k, v in extra.items()})
    return P.model.ServiceRequest("fsm", "train", data)


def _db(P, seed):
    db = P.synth.synthetic_db(seed=seed, n_sequences=80, n_items=10,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    return db, P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(0.1, len(db))))


def _full_queue_drain(P):
    store = P.store.ResultStore()
    mk = lambda rid: P.lease.LeaseManager(  # noqa: E731
        store, replica_id=rid, lease_ttl_s=30.0, heartbeat_s=0)
    mgr_a, mgr_b = mk("rep-a"), mk("rep-b")
    master_a = P.actors.Master(store=store, miner_workers=1, lease_mgr=mgr_a)
    master_b = P.actors.Master(store=store, miner_workers=1, lease_mgr=mgr_b)
    gate, entered = threading.Event(), threading.Event()
    real = P.sources.get_db

    def gated(req, store_):
        if req.uid == "hold" and not entered.is_set():
            entered.set()
            assert gate.wait(DRILL_TIMEOUT_S)
        return real(req, store_)

    P.sources.get_db = gated
    db, want = _db(P, 61)
    uids = [f"steal-me-{i}" for i in range(4)]
    rec = {}
    try:
        master_a.miner.submit(_req(P, "hold"))
        assert entered.wait(DRILL_TIMEOUT_S)
        for uid in uids:
            master_a.miner.submit(_req(
                P, uid, algorithm="SPADE_TPU",
                sequences=P.spmf.format_spmf(db), support="0.1"))
        rec["queued"] = master_a.miner.queue_size()
        report = {}
        th = threading.Thread(target=lambda: report.update(
            master_a.miner.drain(timeout_s=DRILL_TIMEOUT_S, reason="drill")))
        th.start()
        deadline = time.time() + DRILL_TIMEOUT_S
        while time.time() < deadline and master_a.miner.queue_size():
            mgr_b.tick()
            time.sleep(0.05)
        rec["emptied"] = master_a.miner.queue_size() == 0
        gate.set()
        th.join(DRILL_TIMEOUT_S)
        rec["returned"] = not th.is_alive()
        rec["report"] = {k: report.get(k) for k in
                         ("outcome", "stolen_by_peers", "left_for_recovery")}
        rec["status"] = {u: await_terminal(store, u) for u in uids + ["hold"]}
        rec["parity"] = [text_of(P, store.patterns(u)) == want for u in uids]
        with pytest.raises(P.actors.AdmissionShed, match="draining"):
            master_a.miner.submit(_req(P, "late"))
        rec["late"] = store.status("late")
        rec["journals"] = store.journal_uids()
        rec["markers"] = store.keys("fsm:admission:")
    finally:
        gate.set()
        master_b.shutdown()
        master_a.shutdown()
    assert rec["queued"] == 4 and rec["emptied"] and rec["returned"]
    assert rec["report"] == {"outcome": "clean", "stolen_by_peers": 4,
                             "left_for_recovery": 0}
    assert set(rec["status"].values()) == {"finished"}
    assert all(rec["parity"]) and rec["late"] is None
    assert rec["journals"] == [] and rec["markers"] == []
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_drain_under_full_queue_peers_steal_everything(pkg):
    with restored(PKGS[pkg].sources, "get_db"):
        rec = T.held(pkg, _full_queue_drain)
    assert rec["moved"]["fsm_steal_victim_drops_total"] >= 4


def _thief_death(P):
    t = [0.0]
    store = P.store.ResultStore(clock=lambda: t[0])
    mk = lambda rid: P.lease.LeaseManager(  # noqa: E731
        store, replica_id=rid, lease_ttl_s=30.0, heartbeat_s=0,
        clock=lambda: t[0])
    mgr_a, mgr_b = mk("rep-a"), mk("rep-b")
    master_a = P.actors.Master(store=store, miner_workers=0, lease_mgr=mgr_a)
    master_b = P.actors.Master(store=store, miner_workers=1, lease_mgr=mgr_b)
    db, want = _db(P, 62)
    rec = {}
    try:
        master_a.miner.submit(_req(
            P, "orphan", algorithm="SPADE_TPU",
            sequences=P.spmf.format_spmf(db), support="0.1",
            checkpoint="1", checkpoint_every_s="0"))
        mgr_b.tick()
        rec["claimed"] = store.delete("fsm:admission:rep-a:orphan")
        tok = int(store.incr("fsm:lease:token"))
        store.set_px("fsm:lease:orphan",
                     json.dumps({"replica": "rep-c", "token": tok}), 30_000)
        report = master_a.miner.drain(timeout_s=0.5, reason="drill")
        rec["report"] = {k: report.get(k) for k in
                         ("outcome", "stolen_by_peers", "left_for_recovery")}
        rec["journal_kept"] = store.journal_get("orphan") is not None
        rec["status_before"] = store.status("orphan")
        t[0] = 40.0
        mgr_b.tick()
        rec["status"] = await_terminal(store, "orphan")
        rec["parity"] = text_of(P, store.patterns("orphan")) == want
        rec["journals"] = store.journal_uids()
    finally:
        master_b.shutdown()
        master_a.shutdown()
    assert rec["claimed"] == 1
    assert rec["report"] == {"outcome": "clean", "stolen_by_peers": 1,
                             "left_for_recovery": 0}
    assert rec["journal_kept"] and rec["status_before"] == "started"
    assert rec["status"] == "finished" and rec["parity"]
    assert rec["journals"] == []
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_thief_death_mid_drain_heals_via_periodic_recovery(pkg):
    rec = T.held(pkg, _thief_death)
    assert rec["moved"]["fsm_recovery_jobs_total"].get(
        "outcome=resumed", 0) >= 1


def _solo_drain(P):
    store = P.store.ResultStore()
    master = P.actors.Master(store=store, miner_workers=0)
    try:
        master.miner.submit(_req(P, "left0"))
        report = master.miner.drain(timeout_s=0.3, reason="drill")
        rec = {"outcome": report["outcome"], "status": store.status("left0"),
               "error": "draining" in store.get("fsm:error:left0"),
               "journal": store.journal_get("left0")}
    finally:
        master.shutdown()
    assert rec == {"outcome": "timeout", "status": "failure", "error": True,
                   "journal": None}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_drain_solo_settles_leftovers_durably(pkg):
    T.held(pkg, _solo_drain)
