"""The port's lease layer (``spark_fsm_tpu_torch/service/lease.py``) and
the cluster half of its actors, against the reference's.

Mirrors ``tests/test_lease.py``.  The hermetic protocol tests (managers
and an in-process store on one virtual clock) run on each package with
the same assertions.  Each end-to-end drill (two ``Miner`` replicas on one
store, heartbeats ticked by hand) runs once with the reference's modules
and once with the port's, engines on the CPU, on the same seeded input;
the two runs must agree on terminal statuses, on the ``fsm_lease_*`` /
``fsm_steal_*`` counters the reference test asserts, and byte for byte on
the result text."""

import json
import math
import time

import pytest

from _torch_cluster_rig import (DRILL_TIMEOUT_S, NAMES, PKGS, Gate,
                                PortOnCpu, await_terminal, counter, req,
                                text_of)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with PortOnCpu():
        yield


# ------------------------------------------------- hermetic protocol tests


def _rig(P, ttl=10.0):
    t = [0.0]
    store = P.store.ResultStore(clock=lambda: t[0])

    def mk(rid):
        return P.lease.LeaseManager(store, replica_id=rid, lease_ttl_s=ttl,
                                    heartbeat_s=0, clock=lambda: t[0])
    return t, store, mk


@pytest.mark.parametrize("pkg", NAMES)
def test_acquire_is_exclusive_and_tokens_are_monotonic(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P)
    a, b = mk("rep-a"), mk("rep-b")
    tok_a = a.acquire("u1")
    with pytest.raises(P.lease.LeaseHeld, match="rep-a"):
        b.acquire("u1")
    assert a.acquire("u1") == tok_a  # re-entrant for the holder
    a.release("u1")
    assert store.peek("fsm:lease:u1") is None
    tok_b = b.acquire("u1")
    assert tok_b > tok_a
    t[0] = 20.0  # expiry frees the uid without a release
    assert a.acquire("u1") > tok_b


@pytest.mark.parametrize("pkg", NAMES)
def test_renewal_extends_and_expiry_allows_seamless_reacquire(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P, ttl=10.0)
    a = mk("rep-a")
    a.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "rep-a"}))
    t[0] = 8.0
    a.renew_all()
    t[0] = 15.0
    a.fence("u1")
    t[0] = 30.0  # expired unclaimed, the intent still ours: NX re-take
    a.fence("u1")
    assert json.loads(store.peek("fsm:lease:u1"))["replica"] == "rep-a"
    t[0] = 50.0
    store.journal_clear("u1")  # disowned: a free key proves nothing
    with pytest.raises(P.jobctl.JobLeaseLost):
        a.fence("u1")
    assert a.settle_for_failure("u1") is False


@pytest.mark.parametrize("pkg", NAMES)
def test_fence_rejects_superseded_holder_and_settle_refuses_writes(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P, ttl=10.0)
    a, b = mk("rep-a"), mk("rep-b")
    a.acquire("u1")
    t[0] = 11.0
    assert b.adopt_expired("u1") is True
    with pytest.raises(P.jobctl.JobLeaseLost):
        a.fence("u1")
    assert a.settle_for_failure("u1") is False
    b.fence("u1")
    assert b.settle_for_failure("u1") is True


@pytest.mark.parametrize("pkg", NAMES)
def test_adopt_requires_expired_lease_and_is_exclusive(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P, ttl=10.0)
    a, b, c = mk("rep-a"), mk("rep-b"), mk("rep-c")
    a.acquire("u1")
    assert b.adopt_expired("u1") is False  # live: never resurrected
    t[0] = 11.0
    assert b.adopt_expired("u1") is True
    assert c.adopt_expired("u1") is False


@pytest.mark.parametrize("pkg", NAMES)
def test_steal_claim_is_exclusive_against_victim_dequeue(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P)
    a = mk("rep-a")
    a.acquire("q1")
    a.publish_admission("q1")
    assert store.delete("fsm:admission:rep-a:q1") == 1  # the thief wins
    assert a.retract_admission("q1") is False            # the victim drops


@pytest.mark.parametrize("pkg", NAMES)
def test_heartbeat_records_expire_with_their_replica(pkg):
    P = PKGS[pkg]
    t, store, mk = _rig(P, ttl=10.0)
    a, b = mk("rep-a"), mk("rep-b")
    a.publish_heartbeat()
    b.publish_heartbeat()
    assert [p["replica"] for p in a.peers()] == ["rep-b"]
    t[0] = 11.0
    assert a.peers() == []


@pytest.mark.parametrize("pkg", NAMES)
def test_cluster_config_parse_and_validation(pkg):
    P = PKGS[pkg]
    cfg = P.config.parse_config({"cluster": {
        "enabled": True, "lease_ttl_s": 5, "heartbeat_s": 1,
        "steal": False, "replica_id": "r1"}})
    mgr = P.lease.LeaseManager.from_config(P.store.ResultStore(),
                                           cfg.cluster)
    assert (mgr.replica_id, mgr.lease_ttl_s, mgr.heartbeat_s,
            mgr.steal_enabled) == ("r1", 5.0, 1.0, False)
    mgr2 = P.lease.LeaseManager.from_config(
        P.store.ResultStore(), P.config.parse_config(
            {"cluster": {"lease_ttl_s": 9}}).cluster)
    assert (mgr2.heartbeat_s, mgr2.recover_every_s) == (3.0, 9.0)
    for bad, match in (({"lease_ttl_s": 0}, "lease_ttl_s"),
                       ({"lease_ttl_s": 2, "heartbeat_s": 3}, "heartbeat_s"),
                       ({"ttl": 1}, "unknown key")):
        with pytest.raises(P.config.ConfigError, match=match):
            P.config.parse_config({"cluster": bad})


# --------------------------------------------------- end-to-end drills


def _miner(P, store, rid, ttl=1.0, workers=1, depth=8):
    mgr = P.lease.LeaseManager(store, replica_id=rid, lease_ttl_s=ttl,
                               heartbeat_s=0)
    return P.actors.Miner(store, workers=workers, queue_depth=depth,
                          lease_mgr=mgr), mgr


class _MasterLike:
    """What ``recover_orphans`` reads of a Master."""

    def __init__(self, store, miner):
        self.store, self.miner = store, miner


def _both(drill, monkeypatch):
    """Run ``drill(P, monkeypatch)`` on each package; their records must
    be equal.  Returns the reference's."""
    records = {name: drill(PKGS[name], monkeypatch) for name in NAMES}
    assert records["port"] == records["reference"]
    return records["reference"]


def _split_brain(P, monkeypatch):
    db = P.synth.synthetic_db(seed=47, n_sequences=120, n_items=10,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    data = {"algorithm": "SPADE_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "support": "0.1",
            "checkpoint": "1", "checkpoint_every_s": "0", "uid": "drill"}
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"drill"}, once=True)
    miner_a, _ = _miner(P, store, "rep-a", ttl=0.5)
    miner_b, _ = _miner(P, store, "rep-b", ttl=0.5)
    rejected0 = counter(P, "fsm_lease_fence_rejections_total")
    try:
        miner_a.submit(P.model.ServiceRequest("fsm", "train", dict(data)))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        assert store.peek("fsm:lease:drill") is not None
        time.sleep(0.7)  # A's lease lapses unrenewed
        report = P.actors.recover_orphans(_MasterLike(store, miner_b))
        status = await_terminal(store, "drill")
        b_payload = store.patterns("drill")
        settled_by_b = (store.journal_uids(), store.peek("fsm:lease:drill"))
        lost0 = counter(P, "fsm_lease_lost_total")
        gate.release.set()  # the stale incarnation wakes
        deadline = time.time() + DRILL_TIMEOUT_S
        while (counter(P, "fsm_lease_fence_rejections_total") <= rejected0
               and time.time() < deadline):
            time.sleep(0.02)
        rejected = counter(P, "fsm_lease_fence_rejections_total") > rejected0
        lost = counter(P, "fsm_lease_lost_total") >= lost0 + 1
        time.sleep(0.3)  # A's settle path: it must write nothing
        want = P.canonical.patterns_text(P.oracle.mine_spade(
            db, P.vertical.abs_minsup(0.1, len(db))))
        record = {
            "report": report, "status_after_b": status,
            "text": text_of(P, b_payload),
            "settled_by_b": settled_by_b,
            "fence_rejected": rejected, "marked_lost": lost,
            "status_after_a": store.status("drill"),
            "payload_is_b_run": store.patterns("drill") == b_payload,
            "journal_after_a": store.journal_uids()}
        assert record["text"] == want
        return record
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_fencing_token_split_brain_zero_duplicated_results(monkeypatch):
    rec = _both(_split_brain, monkeypatch)
    assert rec["report"]["resumed"] == ["drill"]
    assert rec["status_after_b"] == rec["status_after_a"] == "finished"
    assert rec["settled_by_b"] == ([], None)
    assert rec["fence_rejected"] and rec["marked_lost"]
    assert rec["payload_is_b_run"] and rec["journal_after_a"] == []


def _work_stealing(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"}, once=True)
    miner_a, mgr_a = _miner(P, store, "rep-a", ttl=5.0)
    miner_b, mgr_b = _miner(P, store, "rep-b", ttl=5.0)
    try:
        miner_a.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner_a.submit(req(P, "q1"))
        miner_a.submit(req(P, "q2"))
        queued = miner_a.queue_size()
        mgr_a.publish_heartbeat()
        mgr_b.publish_heartbeat()
        advertised = mgr_b.peers()[0]["queued"]
        stolen0 = counter(P, "fsm_steal_attempts_total", "outcome=stolen")
        stole = mgr_b.steal_once()
        q1 = await_terminal(store, "q1")
        stolen = counter(P, "fsm_steal_attempts_total",
                         "outcome=stolen") - stolen0
        gate.release.set()
        statuses = {u: await_terminal(store, u) for u in ("blocker", "q2")}
        deadline = time.time() + DRILL_TIMEOUT_S
        while store.keys("fsm:admission:") and time.time() < deadline:
            time.sleep(0.01)
        return {"queued": queued, "advertised": advertised, "stole": stole,
                "q1": q1, "stolen": stolen, "statuses": statuses,
                "q1_runs": gate.run_order.count("q1"),
                "journal": store.journal_uids(),
                "markers": store.keys("fsm:admission:"),
                "text": text_of(P, store.patterns("q1"))}
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_work_stealing_idle_replica_drains_loaded_peer(monkeypatch):
    rec = _both(_work_stealing, monkeypatch)
    assert rec["queued"] == rec["advertised"] == 2
    assert rec["stole"] == 1 and rec["stolen"] == 1  # one worker: budget 1
    assert rec["q1"] == "finished"
    assert set(rec["statuses"].values()) == {"finished"}
    assert rec["q1_runs"] == 1  # exactly once
    assert rec["journal"] == [] and rec["markers"] == []


def _victim_drop(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"}, once=True)
    miner_a, mgr_a = _miner(P, store, "rep-a", ttl=5.0)
    miner_b, mgr_b = _miner(P, store, "rep-b", ttl=5.0)
    try:
        miner_a.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner_a.submit(req(P, "steal-me"))
        mgr_a.publish_heartbeat()
        stole = mgr_b.steal_once()
        stolen_status = await_terminal(store, "steal-me")
        drops0 = counter(P, "fsm_steal_victim_drops_total")
        gate.release.set()
        blocker = await_terminal(store, "blocker")
        deadline = time.time() + DRILL_TIMEOUT_S
        while (counter(P, "fsm_steal_victim_drops_total") <= drops0
               and time.time() < deadline):
            time.sleep(0.01)
        return {"stole": stole, "stolen_status": stolen_status,
                "blocker": blocker,
                "drops": counter(P, "fsm_steal_victim_drops_total") - drops0,
                "runs": gate.run_order.count("steal-me"),
                "status": store.status("steal-me"),
                "text": text_of(P, store.patterns("steal-me"))}
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_victim_dequeue_drops_stolen_job_exactly_once(monkeypatch):
    rec = _both(_victim_drop, monkeypatch)
    assert rec["stole"] == 1 and rec["drops"] == 1 and rec["runs"] == 1
    assert rec["stolen_status"] == rec["blocker"] == rec["status"] \
        == "finished"


def _conflict(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"dup"}, once=True)
    miner_a, _ = _miner(P, store, "rep-a", ttl=5.0)
    miner_b, _ = _miner(P, store, "rep-b", ttl=5.0)
    try:
        miner_a.submit(req(P, "dup"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        try:
            miner_b.submit(req(P, "dup"))
            refused = None
        except P.actors.UidConflict as exc:
            refused = type(exc).__name__
        gate.release.set()
        first = await_terminal(store, "dup")
        miner_b.submit(req(P, "dup"))  # terminal: the uid is free again
        second = await_terminal(store, "dup")
        return {"refused": refused, "first": first, "second": second,
                "text": text_of(P, store.patterns("dup"))}
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_submit_conflicts_409_when_uid_leased_by_peer(monkeypatch):
    rec = _both(_conflict, monkeypatch)
    assert rec["refused"] == "UidConflict"
    assert rec["first"] == rec["second"] == "finished"


def _retry_after(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"}, once=True)
    mgr_a = P.lease.LeaseManager(store, replica_id="rep-a", lease_ttl_s=6.0,
                                 heartbeat_s=0)
    miner_a = P.actors.Miner(store, workers=1, queue_depth=1,
                             lease_mgr=mgr_a)
    mgr_a.heartbeat_s = 2.0  # the cadence the estimator prices
    mgr_b = P.lease.LeaseManager(store, replica_id="rep-b", lease_ttl_s=6.0,
                                 heartbeat_s=0)
    miner_b = P.actors.Miner(store, workers=2, queue_depth=8,
                             lease_mgr=mgr_b)
    try:
        miner_a.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner_a.submit(req(P, "q1"))
        with pytest.raises(P.actors.AdmissionShed) as err:
            miner_a.submit(req(P, "shed-local"))
        local_hint = err.value.retry_after_s
        mgr_b.publish_heartbeat()
        mgr_a.peers()  # refresh the peer cache as a heartbeat tick would
        with pytest.raises(P.actors.AdmissionShed) as err:
            miner_a.submit(req(P, "shed-cluster"))
        return {"local_hint_ok": local_hint >= 1,
                "cluster_hint": err.value.retry_after_s,
                "steal_path": max(1, math.ceil(2 * mgr_a.heartbeat_s))}
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_retry_after_points_at_steal_path_when_peers_are_free(monkeypatch):
    rec = _both(_retry_after, monkeypatch)
    assert rec == {"local_hint_ok": True, "cluster_hint": 4,
                   "steal_path": 4}


def _skips_live(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"held"}, once=True)
    miner_a, _ = _miner(P, store, "rep-a", ttl=5.0)
    miner_b, _ = _miner(P, store, "rep-b", ttl=5.0)
    try:
        miner_a.submit(req(P, "held"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        report = P.actors.recover_orphans(_MasterLike(store, miner_b))
        during = store.status("held")
        gate.release.set()
        return {"report": report, "during": during,
                "end": await_terminal(store, "held")}
    finally:
        gate.release.set()
        miner_a.shutdown()
        miner_b.shutdown()


def test_recovery_skips_live_sibling_jobs(monkeypatch):
    rec = _both(_skips_live, monkeypatch)
    assert rec == {"report": {"resumed": [], "failed": [], "cleared": [],
                              "quarantined": []},
                   "during": "started", "end": "finished"}
