"""Store-outage survival of the port's service
(``spark_fsm_tpu_torch/service/storeguard.py``), against the reference's.

Mirrors ``tests/test_storeguard.py``.  The state-machine tests (a guard
over a cuttable in-process store: DOWN only after a probe confirms it,
the spool bound, the replay gate) run on each package with the same
assertions.  The outage drill (cut the store right after a checkpointed
mine's first frontier save: the job stalls, never fails; heal: the same
replica reacquires through the journal-gated NX path, replays its spool
and finishes) runs once with the reference's Miner and once with the
port's, engines on the CPU, on the same seeded input; the two runs must
agree on the stall, the guard's state, the settled bookkeeping and byte
for byte on the patterns."""

import json
import threading
import time

import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, text_of

DRILL_TIMEOUT_S = 180.0


def cuttable_store(P):
    """An in-process store of package ``P`` whose service-facing verbs
    raise ConnectionError while ``cut`` (what a black-holed Redis
    surfaces); ``cut_on_set_prefix`` cuts right AFTER a key with that
    prefix lands, and then, when ``hold`` is an event, holds the writing
    thread until it is set.  A class per call, so a test may patch its
    methods."""

    class CuttableStore(P.store.ResultStore):
        def __init__(self, clock=None):
            super().__init__(clock=clock)
            self.cut = False
            self.cut_on_set_prefix = None
            self.hold = None

        def _gate(self):
            if self.cut:
                raise ConnectionError("injected store outage (cut)")

        def set(self, key, value):
            self._gate()
            super().set(key, value)
            pfx = self.cut_on_set_prefix
            if pfx and key.startswith(pfx):
                self.cut = True
                self.cut_on_set_prefix = None
                if self.hold is not None:
                    assert self.hold.wait(DRILL_TIMEOUT_S), "hold never freed"

        def probe(self):
            self._gate()
            return True

        def raw(self, key):
            return self._kv.get(key)

    def gated(name):
        real = getattr(P.store.ResultStore, name)

        def verb(self, *args, **kwargs):
            self._gate()
            return real(self, *args, **kwargs)
        return verb

    for name in ("get", "peek", "rpush", "delete", "incr", "set_px",
                 "pexpire", "pttl", "llen", "lrange", "scan_keys",
                 "spine_append"):
        setattr(CuttableStore, name, gated(name))
    return CuttableStore


def _scfg(P, **kw):
    base = {"enabled": True, "probe_every_s": 0, "down_after": 2,
            "spool_max_entries": 512, "stall_max_s": 120.0}
    base.update(kw)
    return P.config.parse_config({"storeguard": base}).storeguard


@pytest.fixture(autouse=True)
def _hygiene():
    with PortOnCpu():
        for P in PKGS.values():
            P.storeguard.uninstall()
        yield
        for P in PKGS.values():
            P.storeguard.uninstall()


class _GuardConfig:
    """Swap ``P``'s active config to a [storeguard]-enabled one (manual
    probe ticks) and restore it after."""

    def __init__(self, P, **kw):
        self.P, self.kw = P, dict({"enabled": True, "probe_every_s": 0,
                                   "down_after": 1, "stall_max_s": 120.0},
                                  **kw)

    def __enter__(self):
        self.old = self.P.config.get_config()
        self.P.config.set_config(self.P.config.parse_config(
            {"storeguard": self.kw}))

    def __exit__(self, *exc):
        self.P.config.set_config(self.old)


def _lease(P, store, rid, ttl, clock=None):
    kw = {} if clock is None else {"clock": clock}
    return P.lease.LeaseManager(store, replica_id=rid, lease_ttl_s=ttl,
                                heartbeat_s=0, **kw)


# ------------------------------------------------------------ state machine


@pytest.mark.parametrize("pkg", NAMES)
def test_down_requires_probe_confirmation_then_replays_in_order(pkg):
    P = PKGS[pkg]
    SG = P.storeguard
    store = cuttable_store(P)()
    g = SG.StoreGuard(store, scfg=_scfg(P, down_after=2))
    g.set("u1", "k0", "v0")
    assert store.raw("k0") == "v0" and g.state == SG.HEALTHY
    store.cut = True
    with pytest.raises(ConnectionError):
        g.set("u1", "k1", "v1")
    assert g.state == SG.FLAKY
    g.set("u1", "k1", "v1")  # past down_after, the probe confirms: spooled
    g.rpush("u1", "l1", "a")
    g.rpush("u1", "l1", "b")
    g.set("u2", "k2", "v2")
    assert g.state == SG.DOWN and store.raw("k1") is None
    assert g.spool_entries() == 4
    store.cut = False
    g.tick()
    assert g.state == SG.HEALTHY and g.drained()
    assert (store.raw("k1"), store.raw("k2")) == ("v1", "v2")
    assert store.lrange("l1") == ["a", "b"]


@pytest.mark.parametrize("pkg", NAMES)
def test_store_that_answers_probe_is_sick_not_down(pkg, monkeypatch):
    P = PKGS[pkg]
    cls = cuttable_store(P)
    store = cls()
    g = P.storeguard.StoreGuard(store, scfg=_scfg(P, down_after=1))

    def set_fails(self, key, value):
        raise ConnectionError("write path broken")

    with monkeypatch.context() as m:
        m.setattr(cls, "set", set_fails)
        with pytest.raises(ConnectionError):
            g.set("u1", "k1", "v1")  # the probe passes: not down
    assert g.state == P.storeguard.FLAKY and g.drained()
    g.set("u1", "k1", "v1")
    assert g.state == P.storeguard.HEALTHY


@pytest.mark.parametrize("pkg", NAMES)
def test_non_transport_errors_never_enter_the_state_machine(pkg,
                                                            monkeypatch):
    P = PKGS[pkg]
    cls = cuttable_store(P)
    store = cls()
    g = P.storeguard.StoreGuard(store, scfg=_scfg(P, down_after=1))

    def set_value_error(self, key, value):
        raise ValueError("bad payload")

    with monkeypatch.context() as m:
        m.setattr(cls, "set", set_value_error)
        with pytest.raises(ValueError):
            g.set("u1", "k1", "v1")
    assert g.state == P.storeguard.HEALTHY and g.drained()


@pytest.mark.parametrize("pkg", NAMES)
def test_spool_bound_overflow_fences_the_job(pkg):
    P = PKGS[pkg]
    store = cuttable_store(P)()
    g = P.storeguard.StoreGuard(store, scfg=_scfg(P, down_after=1,
                                                  spool_max_entries=3))
    ctl = P.jobctl.register("u-big")
    try:
        store.cut = True
        g.set("u-big", "k", "v")  # the probe confirms DOWN
        for i in range(3):
            g.set("u-big", f"k{i}", "v")
        assert ctl.lease_lost is True and g.spool_entries() == 0
        g.set("u-big", "k9", "v")  # dropped, not spooled
        assert g.spool_entries() == 0
        store.cut = False
        g.tick()
        assert g.state == P.storeguard.HEALTHY
        assert store.raw("k0") is None and store.raw("k9") is None
    finally:
        P.jobctl.release("u-big")


@pytest.mark.parametrize("pkg", NAMES)
def test_replay_gate_same_token_reacquire_and_adopted_refusal(pkg):
    P = PKGS[pkg]
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "sg-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    tok = mgr.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "sg-a",
                                        "request": {"x": "1"}}))
    store.cut = True
    g.set("u1", "fsm:pattern:u1", "[1]")
    assert g.state == P.storeguard.DOWN
    t[0] = 10.0  # the outage outlives the TTL
    store.cut = False
    g.tick()
    assert g.drained() and store.raw("fsm:pattern:u1") == "[1]"
    retaken = json.loads(store.peek("fsm:lease:u1"))["token"]
    if pkg == "port":
        # the port re-takes an expired lease under a fresh token, so the
        # uid's tokens never fall (ROADMAP Queue C 11)
        assert retaken > tok and mgr.token_of("u1") == retaken
    else:
        assert retaken == tok
    mgr.release("u1")
    store.journal_clear("u1")

    tok2 = mgr.acquire("u2")
    store.journal_set("u2", json.dumps({"replica": "sg-a",
                                        "request": {"x": "1"}}))
    ctl = P.jobctl.register("u2")
    mgr.attach("u2", ctl)
    store.cut = True
    g.set("u2", "fsm:pattern:u2", "[stale]")
    t[0] = 20.0
    store.cut = False
    adopter = _lease(P, store, "sg-b", 5.0, clock)
    assert adopter.adopt_expired("u2") is True
    store.journal_set("u2", json.dumps({"replica": "sg-b",
                                        "request": {"x": "1"}}))
    store.set("fsm:pattern:u2", "[adopter]")
    g.tick()
    assert g.drained() and store.peek("fsm:pattern:u2") == "[adopter]"
    assert ctl.lease_lost is True
    assert json.loads(store.peek("fsm:lease:u2"))["token"] > tok2
    P.jobctl.release("u2")


@pytest.mark.parametrize("pkg", NAMES)
def test_replay_released_job_cleans_its_reacquired_lease(pkg):
    P = PKGS[pkg]
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "sg-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    mgr.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "sg-a"}))
    store.cut = True
    g.set("u1", "fsm:pattern:u1", "[1]")
    g.delete("u1", "fsm:journal:u1")
    mgr.release("u1")  # a store-side no-op while cut
    t[0] = 10.0
    store.cut = False
    g.tick()
    assert g.drained()
    assert store.peek("fsm:pattern:u1") == "[1]"
    assert store.peek("fsm:journal:u1") is None
    assert store.peek("fsm:lease:u1") is None


@pytest.mark.parametrize("pkg", NAMES)
def test_ephemeral_replay_refused_when_uid_has_foreign_trace(pkg):
    P = PKGS[pkg]
    store = cuttable_store(P)()
    mgr = _lease(P, store, "eph-a", 30.0)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1))
    store.cut = True
    g.set("eph-x", "fsm:pattern:eph-x", "[ephemeral]", gate="none")
    assert g.state == P.storeguard.DOWN
    store.cut = False
    store.add_status("eph-x", "finished")  # a durable run of the uid
    store.set("fsm:pattern:eph-x", "[durable]")
    g.tick()
    assert g.drained() and store.peek("fsm:pattern:eph-x") == "[durable]"
    store.cut = True
    g.set("eph-y", "fsm:pattern:eph-y", "[ephemeral]", gate="none")
    store.cut = False
    g.tick()
    assert store.peek("fsm:pattern:eph-y") == "[ephemeral]"


@pytest.mark.parametrize("pkg", NAMES)
def test_refused_replay_still_sweeps_own_admission_marker(pkg):
    P = PKGS[pkg]
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "mk-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    mgr.acquire("mk-1")
    store.journal_set("mk-1", json.dumps({"replica": "mk-a",
                                          "request": {"x": "1"}}))
    mgr.publish_admission("mk-1")
    marker = "fsm:admission:mk-a:mk-1"
    store.cut = True
    g.delete("mk-1", marker)
    g.set("mk-1", "fsm:pattern:mk-1", "[stale]")
    t[0] = 10.0
    store.cut = False
    adopter = _lease(P, store, "mk-b", 5.0, clock)
    assert adopter.adopt_expired("mk-1") is True
    store.journal_set("mk-1", json.dumps({"replica": "mk-b",
                                          "request": {"x": "1"}}))
    g.tick()
    assert g.drained()
    assert store.peek("fsm:pattern:mk-1") is None  # refused
    assert store.peek(marker) is None              # but swept


# -------------------------------------------------------------- admission


@pytest.mark.parametrize("pkg", NAMES)
def test_outage_sheds_admission_by_default(pkg):
    P = PKGS[pkg]
    store = cuttable_store(P)()
    with _GuardConfig(P):
        miner = P.actors.Miner(store, workers=1)
    try:
        g = miner._guard
        store.cut = True
        assert g.probe_once() == "unreachable" and g.is_down()
        with pytest.raises(P.actors.AdmissionShed, match="store outage"):
            miner.submit(P.model.ServiceRequest("fsm", "train", {
                "algorithm": "SPADE", "source": "INLINE",
                "sequences": "1 -1 2 -2\n", "support": "1.0",
                "uid": "shed-me"}))
        assert g.drained()
    finally:
        store.cut = False
        miner.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_ephemeral_admission_runs_no_journal_job_through_the_spool(pkg):
    P = PKGS[pkg]
    store = cuttable_store(P)()
    with _GuardConfig(P, ephemeral_admission=True):
        miner = P.actors.Miner(store, workers=1)
        try:
            g = miner._guard
            store.cut = True
            assert g.probe_once() == "unreachable"
            extras = miner.submit(P.model.ServiceRequest("fsm", "train", {
                "algorithm": "SPADE", "source": "INLINE",
                "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
                "uid": "eph-1"}))
            assert extras == {"ephemeral": "1"}
            deadline = time.time() + DRILL_TIMEOUT_S
            while (time.time() < deadline
                   and P.jobctl.get("eph-1") is not None):
                time.sleep(0.02)
            assert P.jobctl.get("eph-1") is None
            assert store.raw("fsm:pattern:eph-1") is None
            store.cut = False
            g.tick()
            assert g.drained() and store.status("eph-1") == "finished"
            assert store.patterns("eph-1") is not None
            assert store.journal_get("eph-1") is None
        finally:
            store.cut = False
            miner.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_path_builds_no_guard_objects(pkg):
    P = PKGS[pkg]
    miner = P.actors.Miner(P.store.ResultStore(), workers=1)
    try:
        assert miner._guard is None and P.storeguard.get() is None
    finally:
        miner.shutdown()


# ------------------------------------------------------- the outage drill


def _outage_drill(P):
    """``tests/test_storeguard.py``'s drill, with the mine held at the cut
    until its stall is registered: on the CPU both packages' mines end
    within the lease TTL after their only frontier save, and whether the
    job then passes a safe point stalled is a race the hold removes."""
    store = cuttable_store(P)()
    store.hold = threading.Event()
    mgr = _lease(P, store, "drill-a", 0.5)
    with _GuardConfig(P):
        miner = P.actors.Miner(store, workers=1, lease_mgr=mgr)
    g = miner._guard
    db = P.synth.synthetic_db(seed=41, n_sequences=160, n_items=12,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    want = P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(0.05, len(db))))
    try:
        with P.faults.injected("checkpoint.save", every=1, delay_s=0.3,
                               exc="none"):
            store.cut_on_set_prefix = "fsm:frontier:drill"
            miner.submit(P.model.ServiceRequest("fsm", "train", {
                "algorithm": "SPADE_TPU", "source": "INLINE",
                "sequences": P.spmf.format_spmf(db), "support": "0.05",
                "checkpoint": "1", "checkpoint_every_s": "0",
                "uid": "drill"}))
            ctl = P.jobctl.get("drill")
            deadline = time.time() + DRILL_TIMEOUT_S
            while time.time() < deadline and not store.cut:
                assert P.jobctl.get("drill") is not None, \
                    "the job settled before the cut"
                time.sleep(0.02)
            cut = store.cut
            fenced = False
            deadline = time.time() + DRILL_TIMEOUT_S
            while time.time() < deadline and not ctl.stalled:
                mgr.tick()
                g.tick()
                fenced = fenced or ctl.lease_lost
                time.sleep(0.05)
            store.hold.set()  # the mine goes on to its next safe point
            stalled = ctl.stalled
            time.sleep(0.3)
            parked = P.jobctl.get("drill") is ctl and ctl.stalled
            status_in_outage = store.raw("fsm:status:drill")
            down = g.state == P.storeguard.DOWN
            store.cut = False
            g.tick()
            mgr.tick()
        deadline = time.time() + DRILL_TIMEOUT_S
        status = None
        while time.time() < deadline:
            mgr.tick()
            try:
                status = store.status("drill")
            except ConnectionError:
                status = None
            if status in ("finished", "failure"):
                break
            time.sleep(0.05)
        text = text_of(P, store.patterns("drill"))
        assert text == want
        deadline = time.time() + 10.0
        while (time.time() < deadline
               and store.peek("fsm:lease:drill") is not None):
            time.sleep(0.05)
        return {"cut": cut, "fenced": fenced, "stalled": stalled,
                "parked": parked,
                "status_in_outage": status_in_outage, "down": down,
                "status": status, "text": text,
                "healthy": g.drained() and g.state == P.storeguard.HEALTHY,
                "journal": store.journal_get("drill"),
                "lease": store.peek("fsm:lease:drill")}
    finally:
        store.cut = False
        miner.shutdown()


def test_outage_drill_stall_resume_parity_spool_drained():
    records = {name: _outage_drill(PKGS[name]) for name in NAMES}
    assert records["port"] == records["reference"]
    rec = records["reference"]
    assert rec["cut"] and rec["stalled"] and rec["parked"]
    assert not rec["fenced"]
    assert rec["status_in_outage"] not in ("finished", "failure")
    assert rec["down"] and rec["status"] == "finished" and rec["healthy"]
    assert rec["journal"] is None and rec["lease"] is None


@pytest.mark.parametrize("pkg", NAMES)
def test_stall_honors_cancel_and_deadline(pkg):
    P = PKGS[pkg]
    ctl = P.jobctl.register("stall-1")
    try:
        P.jobctl.stall_entry(ctl)
        woke = []

        def runner():
            try:
                P.jobctl.check_entry(ctl)
                woke.append("clean")
            except P.jobctl.JobCancelled:
                woke.append("cancelled")

        th = threading.Thread(target=runner, daemon=True)
        th.start()
        time.sleep(0.15)
        assert not woke, "check_entry returned while stalled"
        assert P.jobctl.cancel("stall-1") == "queued"
        th.join(5.0)
        assert not th.is_alive() and woke == ["cancelled"]
    finally:
        P.jobctl.unstall_entry(ctl)
        P.jobctl.release("stall-1")


@pytest.mark.parametrize("pkg", NAMES)
def test_stall_max_fences_conservatively(pkg):
    P = PKGS[pkg]
    t = [0.0]
    store = cuttable_store(P)(clock=lambda: t[0])
    g = P.storeguard.StoreGuard(store, scfg=_scfg(P, down_after=1,
                                                  stall_max_s=30.0),
                                clock=lambda: t[0])
    ctl = P.jobctl.register("stall-2")
    try:
        store.cut = True
        assert g.probe_once() == "unreachable"
        assert g.stall_job(ctl, "stall-2") is True
        assert ctl.stalled and not ctl.lease_lost
        t[0] = 31.0
        g.tick()
        assert ctl.lease_lost and not ctl.stalled
    finally:
        store.cut = False
        P.jobctl.release("stall-2")


@pytest.mark.parametrize("pkg", NAMES)
def test_storeguard_config_validation(pkg):
    P = PKGS[pkg]
    for section, bad, match in (
            ("storeguard", {"down_after": 0}, "down_after"),
            ("storeguard", {"spool_max_entries": 0}, "spool_max_entries"),
            ("storeguard", {"stall_max_s": -1}, "stall_max_s"),
            ("storeguard", {"probe_every_s": -1}, "probe_every_s"),
            ("store", {"timeout_s": 0}, "timeout_s")):
        with pytest.raises(P.config.ConfigError, match=match):
            P.config.parse_config({section: bad})
    cfg = P.config.parse_config({"storeguard": {
        "enabled": True, "ephemeral_admission": True}})
    assert cfg.storeguard.enabled and cfg.storeguard.ephemeral_admission


@pytest.mark.parametrize("pkg", NAMES)
def test_down_flaky_drift_still_replays_and_bounds_stalls(pkg, monkeypatch):
    P = PKGS[pkg]
    t = [0.0]
    cls = cuttable_store(P)
    store = cls(clock=lambda: t[0])
    g = P.storeguard.StoreGuard(store, scfg=_scfg(P, down_after=1,
                                                  stall_max_s=30.0),
                                clock=lambda: t[0])
    ctl = P.jobctl.register("drift-1")
    try:
        store.cut = True
        g.set("drift-1", "k1", "v1")
        assert g.state == P.storeguard.DOWN and g.spool_entries() == 1
        assert g.stall_job(ctl, "drift-1") is True
        store.cut = False

        def sick_probe(self):
            raise RuntimeError("LOADING")

        with monkeypatch.context() as m:
            m.setattr(cls, "probe", sick_probe)
            assert g.probe_once() == "error"
            assert g.state == P.storeguard.FLAKY
            t[0] = 31.0
            g.tick()
            assert ctl.lease_lost and not ctl.stalled
        g.tick()
        assert g.state == P.storeguard.HEALTHY and g.drained()
        assert store.raw("k1") == "v1"
    finally:
        P.jobctl.release("drift-1")


def _renewal_before_replay(P):
    """A stalled job with a spooled write; the store returns between the
    guard's probe and the lease renewals of one heartbeat tick (the
    renewals run first), then the guard replays."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "rb-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    tok = mgr.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "rb-a",
                                        "request": {"x": "1"}}))
    ctl = P.jobctl.register("u1")
    try:
        mgr.attach("u1", ctl)
        store.cut = True
        g.set("u1", "fsm:pattern:u1", "[1]")  # DOWN: spooled
        t[0] = 10.0  # past the TTL: the renewal stalls the job
        mgr.renew_all()
        stalled = ctl.stalled
        store.cut = False
        mgr.renew_all()
        g.tick()
        lease = json.loads(store.peek("fsm:lease:u1") or "{}")
        return {"stalled": stalled, "pattern": store.raw("fsm:pattern:u1"),
                "lost": ctl.lease_lost, "still_stalled": ctl.stalled,
                "same_token": lease.get("token") == tok,
                "held": lease.get("token") == mgr.token_of("u1")}
    finally:
        P.jobctl.release("u1")


def test_renewal_before_the_replay_keeps_the_spools_token():
    """ROADMAP Queue C 7: the reference's renewal re-takes the expired
    lease under a fresh token, so its replay, gated on the spool's token,
    is refused and the job fenced; the port's renewal leaves a stalled
    job's lease to the replay, which proves the spool's token is the
    job's last and re-takes the lease for the job under a fresh token
    (Queue C 11: a re-take never lowers the uid's token)."""
    assert _renewal_before_replay(PKGS["reference"]) == {
        "stalled": True, "pattern": None, "lost": True,
        "still_stalled": False, "same_token": False, "held": True}
    assert _renewal_before_replay(PKGS["port"]) == {
        "stalled": True, "pattern": "[1]", "lost": False,
        "still_stalled": False, "same_token": False, "held": True}
