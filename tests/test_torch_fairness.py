"""Weighted-fair multi-tenant admission on the port (``spark_fsm_tpu_torch/
service/fairness.py`` under the Miner's ``AdmissionQueue``), against the
reference's ``tests/test_fairness.py``.

Each test of the reference is one test here, parametrised over the two
packages (``_torch_cluster_rig.PKGS``), and returns a record: the DRR
service orders, the reservation tuples and scopes, the Retry-After
values, the shed and refusal texts, the flood drill's start order with
the ``fsm_tenant_*`` families it moved, the heartbeat's tenant fields.
The drills run each package's Miner, the port's on its engines on the
CPU.  The port's record must equal the reference's.
"""

import json
import threading
import time

import pytest

from _torch_cluster_rig import (DRILL_TIMEOUT_S, NAMES, PKGS, PortOnCpu,
                                Twins, assert_covers, restored)


# the per-tenant counters; the depth gauge is left out (its delta depends
# on what earlier tests left queued)
T = Twins(PKGS, families=("fsm_tenant_admitted", "fsm_tenant_sheds",
                          "fsm_tenant_dequeued"))


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        saved = {name: P.config.get_config() for name, P in PKGS.items()}
        yield
        for name, P in PKGS.items():
            P.config.set_config(saved[name])


def test_covers_the_reference():
    assert_covers(globals(), "test_fairness.py")


def _cfg(P, **fair):
    fair.setdefault("enabled", True)
    return P.config.parse_config({"fairness": fair})


def _req(P, uid, **extra):
    data = {"algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
            "uid": uid}
    data.update({k: str(v) for k, v in extra.items()})
    return P.model.ServiceRequest("fsm", "train", data)


def _wait(store, uid, timeout=DRILL_TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = store.status(uid)
        if st in ("finished", "failure"):
            return st
        time.sleep(0.01)
    raise TimeoutError(f"job {uid} reached no terminal status")


def _queue(P, weights=None, depth=0, **fair):
    cfg = _cfg(P, weights=weights or {}, **fair)
    return P.actors.AdmissionQueue(
        depth, fair=P.fairness.TenantScheduler(cfg.fairness))


def _fill(P, q, tenant, n, priority="normal", prefix=None):
    for i in range(n):
        ok, *_ = q.try_reserve(priority, tenant)
        assert ok
        q.put(_req(P, f"{prefix or tenant}{i}"), priority, tenant)


# ----------------------------------------------------------- DRR mechanics


def _equal_weights(P):
    q = _queue(P)
    _fill(P, q, "a", 4)
    _fill(P, q, "b", 4)
    rec = {"order": [q.get().uid[0] for _ in range(8)]}
    assert rec["order"] == list("abababab")
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_drr_interleaves_equal_weights_round_robin(pkg):
    T.held(pkg, _equal_weights)


def _weights(P):
    q = _queue(P, weights={"gold": 2.0, "free": 1.0})
    _fill(P, q, "gold", 8)
    _fill(P, q, "free", 8)
    rec = {"first9": [q.get().uid for _ in range(9)]}
    assert sum(1 for u in rec["first9"] if u.startswith("gold")) == 6
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_drr_serves_proportionally_to_weights(pkg):
    T.held(pkg, _weights)


def _idle_credit(P):
    q = _queue(P)
    _fill(P, q, "a", 6)
    first = [q.get().uid for _ in range(3)]
    _fill(P, q, "b", 3)
    rec = {"first": first, "order": [q.get().uid[0] for _ in range(6)]}
    assert all(u.startswith("a") for u in first)
    assert rec["order"].count("b") == 3 and rec["order"][:2] != ["b", "b"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_drr_idle_tenant_banked_credit_does_not_starve(pkg):
    T.held(pkg, _idle_credit)


def _strict_priority(P):
    q = _queue(P)
    _fill(P, q, "a", 3, priority="normal")
    _fill(P, q, "b", 1, priority="high", prefix="hi-b")
    rec = {"first": q.get().uid}
    assert rec == {"first": "hi-b0"}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_priority_classes_stay_strict_above_fairness(pkg):
    T.held(pkg, _strict_priority)


def _remove_pop(P):
    q = _queue(P)
    _fill(P, q, "a", 3)
    _fill(P, q, "b", 2)
    rec = {"removed": q.remove("a1") is not None,
           "depths": q.tenant_depths()}
    rest = q.pop_all()
    rec.update(rest=len(rest), after=q.tenant_depths(), size=q.size())
    assert rec == {"removed": True, "depths": {"a": 2, "b": 2}, "rest": 4,
                   "after": {}, "size": 0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_remove_uid_and_pop_all_keep_tenant_accounting(pkg):
    T.held(pkg, _remove_pop)


# ------------------------------------------------- caps, sheds, Retry-After


def _tenant_cap(P):
    q = _queue(P, tenant_depth=2, depth=100)
    _fill(P, q, "flood", 2)
    flood = list(q.try_reserve("normal", "flood"))
    quiet = list(q.try_reserve("normal", "quiet"))
    rec = {"flood": flood, "quiet": [quiet[0], quiet[-1]]}
    assert (flood[0], flood[3]) == (False, "tenant") and flood[1] == 2
    assert rec["quiet"] == [True, ""]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_tenant_cap_sheds_with_tenant_counts(pkg):
    T.held(pkg, _tenant_cap)


def _global_bound(P):
    q = _queue(P, tenant_depth=0, depth=2)
    _fill(P, q, "a", 2)
    rec = {"b": list(q.try_reserve("normal", "b"))}
    assert (rec["b"][0], rec["b"][3]) == (False, "queue") \
        and rec["b"][1] == 2
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_global_bound_still_binds_under_fairness(pkg):
    T.held(pkg, _global_bound)


def _abort(P):
    q = _queue(P, tenant_depth=1)
    steps = [list(q.try_reserve("normal", "a")),
             list(q.try_reserve("normal", "a"))]
    q.abort("a")
    steps.append(list(q.try_reserve("normal", "a")))
    q.abort("a")
    rec = {"steps": [[s[0], s[-1]] for s in steps]}
    assert rec["steps"] == [[True, ""], [False, "tenant"], [True, ""]]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_reserve_abort_returns_tenant_token(pkg):
    T.held(pkg, _abort)


def _retry_share(P):
    sched = P.fairness.TenantScheduler(
        _cfg(P, weights={"gold": 4.0, "free": 1.0}).fairness)
    rec = {t: sched.retry_after_s(t, 10, per_job_s=2.0, workers=2,
                                  active=["gold", "free"])
           for t in ("free", "gold")}
    assert rec["free"] > rec["gold"] >= 1
    assert rec["free"] >= 4 * rec["gold"] / 2
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_retry_after_tracks_tenant_share(pkg):
    T.held(pkg, _retry_share)


def _tenant_shed(P):
    P.config.set_config(_cfg(P, tenant_depth=1))
    gate, entered = threading.Event(), threading.Event()
    real = P.sources.get_db

    def gated(req, store):
        entered.set()
        assert gate.wait(DRILL_TIMEOUT_S)
        return real(req, store)

    P.sources.get_db = gated
    store = P.store.ResultStore()
    miner = P.actors.Miner(store, workers=1)
    rec = {}
    try:
        miner.submit(_req(P, "f0", tenant="flood"))
        assert entered.wait(DRILL_TIMEOUT_S)
        miner.submit(_req(P, "f1", tenant="flood"))
        with pytest.raises(P.actors.AdmissionShed) as exc:
            miner.submit(_req(P, "f2", tenant="flood"))
        rec["shed"] = str(exc.value)
        rec["retry_after_s"] = exc.value.retry_after_s
        rec["f2"] = [store.status("f2"), store.journal_get("f2")]
        miner.submit(_req(P, "q0", tenant="quiet"))
    finally:
        gate.set()
        rec["status"] = {u: _wait(store, u) for u in ("f0", "f1", "q0")}
        miner.shutdown()
    assert "tenant 'flood'" in rec["shed"] and rec["retry_after_s"] >= 1
    assert rec["f2"] == [None, None]
    assert set(rec["status"].values()) == {"finished"}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_miner_tenant_shed_is_429_with_own_retry(pkg):
    with restored(PKGS[pkg].sources, "get_db"):
        T.held(pkg, _tenant_shed)


def _vocabulary(P):
    P.config.set_config(_cfg(P, max_tenants=2))
    store = P.store.ResultStore()
    miner = P.actors.Miner(store, workers=1)
    rec = {}
    try:
        miner.submit(_req(P, "a0", tenant="alpha"))
        with pytest.raises(ValueError) as exc:
            miner.submit(_req(P, "b0", tenant="beta"))
        rec["full"] = str(exc.value)
        rec["b0"] = store.status("b0")
        with pytest.raises(ValueError) as exc:
            miner.submit(_req(P, "c0", tenant="bad tenant!"))
        rec["invalid"] = str(exc.value)
        miner.submit(_req(P, "a1", tenant="alpha"))
        miner.submit(_req(P, "d0"))
    finally:
        rec["status"] = {u: _wait(store, u) for u in ("a0", "a1", "d0")}
        miner.shutdown()
    assert "vocabulary full" in rec["full"] and rec["b0"] is None
    assert "invalid tenant" in rec["invalid"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_bounded_tenant_vocabulary(pkg):
    T.held(pkg, _vocabulary)


# ------------------------------------------------------- starvation drill


def _flood(P):
    P.config.set_config(_cfg(P))
    gate = threading.Event()
    order = []
    real = P.sources.get_db

    def tracking(req, store):
        if req.uid == "hold":
            assert gate.wait(DRILL_TIMEOUT_S)
        else:
            order.append(req.uid)
        return real(req, store)

    P.sources.get_db = tracking
    store = P.store.ResultStore()
    miner = P.actors.Miner(store, workers=1)
    try:
        miner.submit(_req(P, "hold", tenant="flood"))
        for i in range(12):
            miner.submit(_req(P, f"fl{i}", tenant="flood"))
        for i in range(4):
            miner.submit(_req(P, f"bg{i}", tenant="bg"))
        gate.set()
        for i in range(4):
            _wait(store, f"bg{i}")
    finally:
        gate.set()
        status = {u: _wait(store, u) for u in
                  [f"fl{i}" for i in range(12)] + ["hold"]}
        miner.shutdown()
    rec = {"order": order, "status": status}
    assert order.index("bg3") + 1 <= 9, order
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_flood_tenant_cannot_starve_background_tenant(pkg):
    with restored(PKGS[pkg].sources, "get_db"):
        rec = T.held(pkg, _flood)
    assert rec["moved"], "no fsm_tenant_* family moved"


def _fifo(P):
    q = P.actors.AdmissionQueue(0)
    scopes = []
    for i in range(4):
        ok, _, _, scope = q.try_reserve("normal", "t%d" % (i % 2))
        scopes.append([ok, scope])
        q.put(_req(P, f"j{i}"), "normal")
    rec = {"scopes": scopes, "order": [q.get().uid for _ in range(4)],
           "depths": q.tenant_depths()}
    assert rec["order"] == ["j0", "j1", "j2", "j3"] and rec["depths"] == {}
    assert rec["scopes"] == [[True, ""]] * 4
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_path_is_fifo_and_ignores_tenant(pkg):
    T.held(pkg, _fifo)


def _heartbeat(P):
    P.config.set_config(_cfg(P))
    store = P.store.ResultStore()
    mgr = P.lease.LeaseManager(store, replica_id="rep-t", heartbeat_s=0)
    miner = P.actors.Miner(store, workers=1, lease_mgr=mgr)
    try:
        mgr.publish_heartbeat()
        hb = json.loads(P.envelope.unwrap(store.peek("fsm:replica:rep-t"))[0])
        idle = {k: hb[k] for k in ("draining", "tenants", "fps")}
        mgr.set_draining(True)
        hb = json.loads(P.envelope.unwrap(store.peek("fsm:replica:rep-t"))[0])
        rec = {"idle": idle, "draining": hb["draining"], "free": hb["free"]}
    finally:
        miner.shutdown()
    assert rec == {"idle": {"draining": False, "tenants": {}, "fps": []},
                   "draining": True, "free": 0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_heartbeat_piggybacks_tenant_depths_and_drain_state(pkg):
    T.held(pkg, _heartbeat)


def _config_validation(P):
    cases = [({"tenant_depth": -1}, "tenant_depth"),
             ({"max_tenants": 0}, "max_tenants"),
             ({"default_weight": 0}, "default_weight"),
             ({"weights": {"t": -2.0}}, "weight"),
             ({"weights": {"t": "not-a-number"}}, "weight")]
    errors = []
    for fair, match in cases:
        with pytest.raises(P.config.ConfigError, match=match) as exc:
            P.config.parse_config({"fairness": fair})
        errors.append(str(exc.value))
    return {"errors": errors}


@pytest.mark.parametrize("pkg", NAMES)
def test_fairness_config_validation(pkg):
    T.held(pkg, _config_validation)
