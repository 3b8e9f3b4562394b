"""Admission markers under store blips, and the seeded storm of
``scripts/storm_smoke.py``, on the port and on the reference.

- **A marker the dequeue could not retract (ROADMAP Queue C 10).** A
  worker dequeues a job and its marker ``DEL`` fails with the store's
  connection error while the store guard has not proven an outage (the
  probe answers).  Both packages run the job anyway (a thief that won the
  ``DEL`` would fence the run).  The reference never retries the
  ``DEL``: its marker stays in the store after the job settles, a phantom
  a later steal scan may claim for a settled uid.  The port retries it at
  the job's release and on every heartbeat
  (``LeaseManager.note_unretracted`` / ``sweep_unretracted``).  This is
  a repair in the port only (ROADMAP "Known differences"): the test
  holds the reference's leak and the port's clean store.
- **A stolen job settled by its victim (ROADMAP Queue C 12).** A thief
  claims a queued job; the victim's worker then fails its own marker
  DEL on a blip, runs the job anyway and, trusting its local lease,
  settles it too.  The port's victim finds the thief's token on the
  lease and drops the job, and proves the lease on the store at every
  fence while the DEL stays unproven (port only).
- **A token that fell (ROADMAP Queue C 11).** A renewal's re-take of an
  expired lease lands in the store, but its reply is lost as the store
  goes away; the phantom lease expires before the store returns.  The
  reference's spool replay then re-takes the lease under the spool's
  older token, so the uid's tokens fall; the port re-takes it under a
  fresh one (port only, ROADMAP "Known differences").  The replay keeps
  the token it took, so one that resumes after a flap drains on both
  packages.
- **A status after an adopter's failure (ROADMAP Queue C 13).** A job
  skips its lease fence while its guard proves an outage, and the store
  returns before its next write; meanwhile an adopter has failed the
  job.  The reference writes the status over the settled failure; the
  port fences the job at that first direct write (port only).
- **A heartbeat behind busy workers (ROADMAP Queue C 14).** Each store
  reply of a heartbeat tick waits for the GIL, which a CPU-bound worker
  hands over once a switch interval; the port's lease manager shortens
  the interval when its heartbeat thread starts (port only).
- **The checker** (``tests/_torch_storm.py``, a copy of the script's)
  catches each violation on crafted store contents.
- **One seeded storm** (seed 7001, eight steps) over two replicas, each a
  ``--device cpu`` process of the package's ``service.app`` behind its
  own ``NetProxy`` on one ``SnoopingMiniRedis``: the store guard is
  installed once a process (``service/storeguard.install``), so two
  replicas need two processes.  Every invariant holds on the port.  The
  reference's round is held to quiescence (journal intents, leases and
  spool entries) and parity only: it keeps Queue C 10 (a leaked marker),
  Queue C 11 (a token that falls), Queue C 12 and Queue C 13 (under
  load its round settled a job twice or not at all in 2 of 30 runs), so
  ``REFERENCE_WAIVED`` names those checks.  Which jobs are shed depends on timing, so the two
  packages' records are not compared.
"""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

import _torch_storm as S
from _torch_cluster_rig import (NAMES, PKGS, Gate, PortOnCpu, await_terminal,
                                req, text_of)
from _torch_miniredis import MiniRedis, SnoopingMiniRedis

ROOT = Path(__file__).resolve().parent.parent
BOOT_TIMEOUT_S = 120.0
STORM_SEED = 7001
LEASE_TTL_S = 2.0
# the invariants the reference's round is not held to: it keeps Queue C
# 10 (markers), 11 (tokens), 12 (a stolen job settled by its victim
# too) and 13 (a status after an adopter's failure) (ROADMAP "Known
# differences")
REFERENCE_WAIVED = ("markers", "tokens", "settlement")


@pytest.fixture(autouse=True)
def _hygiene():
    with PortOnCpu():
        for P in PKGS.values():
            P.storeguard.uninstall()
        yield
        for P in PKGS.values():
            P.storeguard.uninstall()


# ------------------------------------------------- Queue C 10: the marker


def _wait_for(cond, what, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise TimeoutError(what)


def _marker_drill(P, point, monkeypatch):
    """One replica (a Miner with a lease manager and the store guard on a
    MiniRedis) whose first admission-marker DEL fails with a connection
    error the guard's probe does not confirm.  ``point`` is where the
    marker is looked for: ``"settle"`` once the job has settled,
    ``"heartbeat"`` after one heartbeat while the job still runs (and
    again once it has settled)."""
    mini = MiniRedis()
    client = PKGS["port"].resp.RespClient(port=mini.port)
    store = P.store.RedisResultStore(port=mini.port)
    old = P.config.get_config()
    P.config.set_config(P.config.parse_config({"storeguard": {
        "enabled": True, "probe_every_s": 0, "down_after": 1}}))
    failed = []
    real_delete = store.delete

    def flaky_delete(key):
        if key.startswith("fsm:admission:") and not failed:
            failed.append(key)
            raise ConnectionError("injected: the marker DEL was dropped")
        return real_delete(key)

    monkeypatch.setattr(store, "delete", flaky_delete)
    db = P.synth.synthetic_db(seed=67, n_sequences=60, n_items=9,
                              mean_itemsets=3.0, mean_itemset_size=1.2)
    want = P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(0.1, len(db))))
    mgr = P.lease.LeaseManager(store, replica_id="rep-a", lease_ttl_s=30.0,
                               heartbeat_s=0)
    gate = Gate(P, monkeypatch, block_uids=["c10"]) \
        if point == "heartbeat" else None
    master = P.actors.Master(store=store, miner_workers=1, lease_mgr=mgr)
    rec = {}
    try:
        master.miner.submit(req(P, "c10", algorithm="SPADE_TPU",
                                sequences=P.spmf.format_spmf(db),
                                support="0.1"))
        if gate is not None:
            assert gate.entered.wait(60), "the job never started"
            mgr.tick()
            rec["running"] = client.keys("fsm:admission:*")
            gate.release.set()
        rec["status"] = await_terminal(store, "c10")
        _wait_for(lambda: mgr.held_uids() == [], "the lease's release")
        rec["failed_del"] = failed
        rec["guard"] = P.storeguard.get().state
        rec["parity"] = text_of(P, store.patterns("c10")) == want
        rec["settled"] = client.keys("fsm:admission:*")
        rec["journal"] = client.keys("fsm:journal:*")
    finally:
        if gate is not None:
            gate.release.set()
        master.shutdown()
        P.config.set_config(old)
        client.close()
        mini.close()
    return rec


@pytest.mark.parametrize("point", ["settle", "heartbeat"])
@pytest.mark.parametrize("pkg", NAMES)
def test_unretracted_admission_marker_is_swept(pkg, point, monkeypatch):
    P = PKGS[pkg]
    rec = _marker_drill(P, point, monkeypatch)
    marker = ["fsm:admission:rep-a:c10"]
    # the same fault on both packages: one dropped DEL, an unproven blip
    # (the probe answered, so the guard never went down), the job ran
    # anyway and settled once with the oracle's text
    assert rec["failed_del"] == marker
    assert rec["guard"] != P.storeguard.DOWN
    assert rec["status"] == "finished" and rec["parity"]
    assert rec["journal"] == []
    if pkg == "port":
        # retried at the release, or at the first heartbeat while the
        # job still runs
        assert rec["settled"] == []
        if point == "heartbeat":
            assert rec["running"] == []
    else:
        # the reference keeps the phantom marker (ROADMAP Queue C 10)
        assert rec["settled"] == marker
        if point == "heartbeat":
            assert rec["running"] == marker


def test_republished_marker_is_not_swept():
    """A retry kept for an earlier incarnation of a uid is dropped when
    the uid is admitted again, so the sweep never deletes the marker of
    a job that is queued now."""
    P = PKGS["port"]
    mini = MiniRedis()
    store = P.store.RedisResultStore(port=mini.port)
    mgr = P.lease.LeaseManager(store, replica_id="rep-a", heartbeat_s=0)
    try:
        mgr.note_unretracted("u1")
        mgr.note_unretracted("u2")
        mgr.publish_admission("u1")
        store.set("fsm:admission:rep-a:u2", "1")
        assert mgr.sweep_unretracted() == 1
        assert store.keys("fsm:admission:") == ["fsm:admission:rep-a:u1"]
        assert mgr.sweep_unretracted() == 0
    finally:
        mini.close()


# ------------------------- Queue C 12: a stolen job run on a blip


def _stolen_blip_drill(P, monkeypatch):
    """Replica B steals job ``u`` from A's queue while A's worker is busy;
    when A's worker reaches ``u`` its marker DEL fails with a connection
    error (an unproven blip), so A cannot tell the steal from a lost
    reply.  Returns the terminal entries of ``u``'s status log once both
    replicas are idle, and ``u``'s text."""
    mini = MiniRedis()
    client = PKGS["port"].resp.RespClient(port=mini.port)
    store_a = P.store.RedisResultStore(port=mini.port)
    store_b = P.store.RedisResultStore(port=mini.port)
    failed = []
    real_delete = store_a.delete

    def flaky_delete(key):
        if key == "fsm:admission:rep-a:u" and not failed:
            failed.append(key)
            raise ConnectionError("injected: the marker DEL was dropped")
        return real_delete(key)

    db = P.synth.synthetic_db(seed=68, n_sequences=60, n_items=9,
                              mean_itemsets=3.0, mean_itemset_size=1.2)
    want = P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(0.1, len(db))))
    mk = lambda store, rid: P.lease.LeaseManager(  # noqa: E731
        store, replica_id=rid, lease_ttl_s=30.0, heartbeat_s=0)
    mgr_a, mgr_b = mk(store_a, "rep-a"), mk(store_b, "rep-b")
    gate = Gate(P, monkeypatch, block_uids=["hold", "u"], once=True)
    master_a = P.actors.Master(store=store_a, miner_workers=1,
                               lease_mgr=mgr_a)
    master_b = P.actors.Master(store=store_b, miner_workers=1,
                               lease_mgr=mgr_b)
    try:
        master_a.miner.submit(req(P, "hold"))
        assert gate.entered.wait(60), "A never took the hold job"
        master_a.miner.submit(req(P, "u", algorithm="SPADE_TPU",
                                  sequences=P.spmf.format_spmf(db),
                                  support="0.1"))
        mgr_a.publish_heartbeat()   # A advertises its queued job
        mgr_b.tick()   # B steals u and starts it (held in its dataset)
        _wait_for(lambda: "u" in gate.run_order, "B to start u")
        monkeypatch.setattr(store_a, "delete", flaky_delete)
        gate.release.set()
        await_terminal(store_b, "hold")
        _wait_for(lambda: (master_a.miner.queue_size() == 0
                           and master_a.miner.running_count() == 0
                           and master_b.miner.running_count() == 0
                           and store_b.status("u") in ("finished",
                                                       "failure")),
                  "both replicas to settle")
        entries = [e.partition(":")[2]
                   for e in client.lrange("fsm:status:log:u")]
        return {"failed_del": failed, "runs": gate.run_order.count("u"),
                "terminals": [e for e in entries
                              if e in ("finished", "failure")],
                "parity": text_of(P, store_b.patterns("u")) == want}
    finally:
        gate.release.set()
        master_b.shutdown()
        master_a.shutdown()
        client.close()
        mini.close()


@pytest.mark.parametrize("pkg", NAMES)
def test_a_stolen_job_is_not_settled_by_its_victim(pkg, monkeypatch):
    rec = _stolen_blip_drill(PKGS[pkg], monkeypatch)
    assert rec["failed_del"] == ["fsm:admission:rep-a:u"] and rec["parity"]
    if pkg == "port":
        # A finds B's token on the lease and drops the job: B settles it
        assert rec == dict(rec, runs=1, terminals=["finished"])
    else:
        # the reference runs it on A too, trusting its local lease, and
        # settles it a second time (ROADMAP Queue C 12)
        assert rec["runs"] == 2 and len(rec["terminals"]) == 2


# ------------------------------------ Queue C 11: a token that fell


def _lost_reply_drill(P):
    """A held job's lease expires; the renewal's re-take under a fresh
    token lands in the store, but its reply is lost as the store goes
    away, so the replica still holds the old token: the job stalls, a
    write is spooled under the old token, the phantom lease expires, and
    the store returns.  Returns the tokens SET on the uid's lease key in
    order, and what the replay did."""
    from test_torch_storeguard import _lease, _scfg, cuttable_store

    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    Store = cuttable_store(P)
    store = Store(clock=clock)
    tokens, lose = [], [False]

    def set_px(key, value, px_ms, nx=False):
        ok = Store.set_px(store, key, value, px_ms, nx=nx)
        if key == "fsm:lease:u1" and ok:
            tokens.append(json.loads(value)["token"])
            if lose[0]:
                lose[0] = False
                store.cut = True
                raise ConnectionError("injected: the SET landed, its "
                                      "reply was lost")
        return ok

    store.set_px = set_px
    mgr = _lease(P, store, "lr-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    mgr.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "lr-a",
                                        "request": {"x": "1"}}))
    ctl = P.jobctl.register("u1")
    try:
        mgr.attach("u1", ctl)
        t[0] = 10.0   # the lease expired, unclaimed
        lose[0] = True
        mgr.renew_all()
        stalled = ctl.stalled
        g.set("u1", "fsm:pattern:u1", "[1]")   # DOWN: spooled
        t[0] = 20.0   # the phantom lease expires too
        store.cut = False
        g.tick()
        return {"tokens": tokens, "stalled": stalled,
                "pattern": store.raw("fsm:pattern:u1"),
                "lost": ctl.lease_lost, "drained": g.drained(),
                "holder": json.loads(store.peek("fsm:lease:u1"))["token"]}
    finally:
        P.jobctl.release("u1")


@pytest.mark.parametrize("pkg", NAMES)
def test_replay_after_a_lost_retake_reply_never_lowers_the_token(pkg):
    rec = _lost_reply_drill(PKGS[pkg])
    first, phantom = rec["tokens"][:2]
    assert phantom > first
    assert rec["stalled"] and rec["pattern"] == "[1]" and not rec["lost"]
    assert rec["drained"]
    if pkg == "port":
        # the replay re-takes the lease under a fresh, larger token
        assert rec["tokens"][2] > phantom == rec["tokens"][1]
        assert rec["holder"] == rec["tokens"][2]
    else:
        # the reference re-takes it under the spool's token: the uid's
        # tokens fall (ROADMAP Queue C 11)
        assert rec["tokens"] == [first, phantom, first]


def _flap_after_retake_drill(P):
    """A held job's lease expires unclaimed during an outage with two
    writes spooled.  The store returns, the replay gate re-takes the
    lease, the first write lands, and the store flaps away again before
    the second.  When it returns for good the replay resumes.  Returns
    what the store and the job hold then."""
    from test_torch_storeguard import _lease, _scfg, cuttable_store

    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "fl-a", 5.0, clock)
    g = P.storeguard.StoreGuard(store, lease_mgr=mgr,
                                scfg=_scfg(P, down_after=1), clock=clock)
    mgr.attach_guard(g)
    mgr.acquire("u1")
    store.journal_set("u1", json.dumps({"replica": "fl-a",
                                        "request": {"x": "1"}}))
    ctl = P.jobctl.register("u1")
    try:
        mgr.attach("u1", ctl)
        store.cut = True
        g.set("u1", "fsm:pattern:u1", "[1]")   # DOWN: spooled
        g.set("u1", "fsm:stats:u1", "{}")
        t[0] = 10.0   # the lease expired, unclaimed
        store.cut = False
        store.cut_on_set_prefix = "fsm:pattern:u1"   # the flap
        g.tick()
        flapped = {"down": g.state == P.storeguard.DOWN,
                   "pattern": store.raw("fsm:pattern:u1"),
                   "spooled": g.spool_entries()}
        store.cut = False
        g.tick()
        return {"flapped": flapped, "drained": g.drained(),
                "stats": store.raw("fsm:stats:u1"), "lost": ctl.lease_lost,
                "holder": json.loads(store.peek("fsm:lease:u1"))["token"]
                == mgr.token_of("u1")}
    finally:
        P.jobctl.release("u1")


@pytest.mark.parametrize("pkg", NAMES)
def test_replay_resumed_after_a_flap_keeps_the_retaken_lease(pkg):
    """The replay that re-took the lease resumes after the flap under the
    token it took, drains, and leaves the job unfenced (on the port the
    token is a fresh one, on the reference the spool's own)."""
    assert _flap_after_retake_drill(PKGS[pkg]) == {
        "flapped": {"down": True, "pattern": "[1]", "spooled": 1},
        "drained": True, "stats": "{}", "lost": False, "holder": True}


# ------------------------- Queue C 13: a status after an adopter's failure


def _stale_status_drill(P, monkeypatch):
    """Replica B holds job ``u`` in its dataset load while its lease
    lapses; replica A adopts ``u`` and fails it (written on the store
    directly).  B's link to the store then goes away and its guard
    proves the outage, so B skips its lease fence after the load; the
    store returns before B's ``dataset`` status is written.  Returns
    ``u``'s status and status log once B is idle."""
    from test_torch_storeguard import _GuardConfig, _lease, cuttable_store

    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    store = cuttable_store(P)(clock=clock)
    mgr = _lease(P, store, "c13-b", 5.0, clock)
    with _GuardConfig(P):
        miner = P.actors.Miner(store, workers=1, lease_mgr=mgr)
    g = miner._guard
    gate = Gate(P, monkeypatch, block_uids=["u"])
    real_status = g.status
    healed = []

    def status(uid, value, gate=None):
        if uid == "u" and value == "dataset" and not healed:
            store.cut = False   # back between the skipped fence and here
            g.tick()
            healed.append(g.state)
        return real_status(uid, value, gate=gate)

    monkeypatch.setattr(g, "status", status)
    db = P.synth.synthetic_db(seed=69, n_sequences=60, n_items=9,
                              mean_itemsets=3.0, mean_itemset_size=1.2)
    try:
        miner.submit(req(P, "u", algorithm="SPADE_TPU",
                         sequences=P.spmf.format_spmf(db), support="0.1"))
        assert gate.entered.wait(60), "B never started u"
        t[0] = 10.0   # B's lease lapsed; A adopts u and fails it
        store.set_px("fsm:lease:u", json.dumps({"replica": "c13-a",
                                                "token": 99}), 5000)
        store.add_status("u", "failure")
        store.journal_clear("u")
        store.delete("fsm:lease:u")
        store.cut = True
        assert g.note_error(ConnectionError("injected: B's link is gone"))
        gate.release.set()
        _wait_for(lambda: (miner.queue_size() == 0
                           and miner.running_count() == 0), "B to settle")
        return {"healed": healed, "status": store.status("u"),
                "log": [e.partition(":")[2]
                        for e in store.lrange("fsm:status:log:u")]}
    finally:
        gate.release.set()
        store.cut = False
        miner.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_no_status_lands_after_an_adopters_failure(pkg, monkeypatch):
    rec = _stale_status_drill(PKGS[pkg], monkeypatch)
    assert rec["healed"] == ["healthy"]
    if pkg == "port":
        # B's first direct write proves the lease, finds it gone, and
        # fences the job: A's failure stays the uid's last word
        assert rec == dict(rec, status="failure",
                           log=["started", "failure"])
    else:
        # the reference writes B's status over A's settled failure, and
        # the uid is left with no terminal status (ROADMAP Queue C 13)
        assert rec == dict(rec, status="dataset",
                           log=["started", "failure", "dataset"])


# ------------------------- Queue C 14: a heartbeat behind busy workers


class _Idle:
    """The little of a Miner a heartbeat thread that never ticks reads."""


@pytest.mark.parametrize("pkg", NAMES)
def test_heartbeat_thread_shortens_the_switch_interval(pkg):
    """A heartbeat tick's store replies each wait for the GIL, which a
    CPU-bound worker hands over once a switch interval: the port's lease
    manager lowers the interval to ``HEARTBEAT_SWITCH_S`` when it starts
    its heartbeat thread; the reference keeps the interpreter's 5 ms
    (ROADMAP Queue C 14)."""
    P = PKGS[pkg]
    mini = MiniRedis()
    before = sys.getswitchinterval()
    sys.setswitchinterval(0.005)
    mgr = P.lease.LeaseManager(P.store.RedisResultStore(port=mini.port),
                               replica_id="hb-a", heartbeat_s=60.0)
    try:
        mgr.start(_Idle())
        got = sys.getswitchinterval()
    finally:
        mgr.stop()
        sys.setswitchinterval(before)
        mini.close()
    if pkg == "port":
        assert got == P.lease.HEARTBEAT_SWITCH_S == 0.001
    else:
        assert got == 0.005


# --------------------------------------------------------- the checker


class _Metrics(BaseHTTPRequestHandler):
    spool = 0

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):  # noqa: N802
        body = (f"fsm_storeguard_spool_entries {_Metrics.spool}\n"
                "fsm_lease_fence_rejections_total 0\n"
                'fsm_storeguard_replays_total{outcome="ok"} 0\n'
                'fsm_storeguard_replays_total{outcome="refused"} 0\n'
                'fsm_storeguard_stalls_total{outcome="entered"} 0\n'
                ).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _crafted(client, case):
    """A settled store of two finished jobs, then one violation."""
    from spark_fsm_tpu_torch.service.model import serialize_patterns

    good = ((1,), (2,))
    for uid in ("j0", "j1"):
        client.set(f"fsm:status:{uid}", "finished")
        client.rpush(f"fsm:status:log:{uid}", "1:started")
        client.rpush(f"fsm:status:log:{uid}", "2:finished")
        client.set(f"fsm:pattern:{uid}", serialize_patterns([(good, 3)]))
    lease_sets = [("j0", 3, "rep-a"), ("j0", 3, "rep-a"),
                  ("j1", 4, "rep-a"), ("j1", 7, "rep-b")]
    if case == "second terminal":
        client.rpush("fsm:status:log:j1", "3:failure")
    elif case == "token falls":
        lease_sets.append(("j1", 5, "rep-b"))
    elif case == "token reused":
        lease_sets.append(("j1", 7, "rep-a"))
    elif case == "journal":
        client.set("fsm:journal:j0", "{}")
    elif case == "lease":
        client.set("fsm:lease:j1", json.dumps({"replica": "rep-a",
                                               "token": 7}))
    elif case == "marker":
        client.set("fsm:admission:rep-a:j1", "1")
    elif case == "spool":
        _Metrics.spool = 2
    elif case == "text":
        client.set("fsm:pattern:j1", serialize_patterns([(((1,),), 3)]))
    return lease_sets


VIOLATIONS = {"second terminal": "settled 2 times",
              "token falls": "token regressed 7 -> 5",
              "token reused": "token 7 reused across replicas",
              "journal": "leftovers=['fsm:journal:j0']",
              "lease": "leftovers=['fsm:lease:j1']",
              "marker": "leftovers=['fsm:admission:rep-a:j1']",
              "spool": "spooled=2.0",
              "text": "j1: PARITY VIOLATION"}


@pytest.mark.parametrize("case", [None, *VIOLATIONS])
def test_checker_catches_each_violation(case):
    mini = MiniRedis()
    client = PKGS["port"].resp.RespClient(port=mini.port)
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Metrics)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _Metrics.spool = 0
    try:
        lease_sets = _crafted(client, case)
        want = PKGS["port"].canonical.patterns_text([(((1,), (2,)), 3)])
        args = (client, {"j0", "j1"}, {"j0": want, "j1": want},
                [server.server_port], lease_sets, f"crafted {case}")
        kw = dict(log=lambda msg: None, quiesce_s=0.3)
        if case is None:
            out = S.check_invariants(*args, **kw)
            assert out["parity_ok"] == 2 and out["lease_sets"] == 4
        else:
            with pytest.raises(AssertionError) as exc:
                S.check_invariants(*args, **kw)
            assert VIOLATIONS[case] in str(exc.value)
            if case == "marker":
                # the reference's round waives the markers
                out = S.check_invariants(*args, waive=("markers",), **kw)
                assert out["waived"] == [
                    "admission markers left: ['fsm:admission:rep-a:j1']"]
    finally:
        server.shutdown()
        server.server_close()
        client.close()
        mini.close()


# ----------------------------------------------------------- the storm


_REFERENCE_CHILD = (
    "import jax; jax.config.update('jax_platforms', 'cpu')\n"
    "import sys\n"
    "sys.argv = ['app'] + sys.argv[1:]\n"
    "from spark_fsm_tpu.service.app import main\n"
    "main()\n")


class _Replica:
    """One replica process of ``pkg``'s ``service.app`` (``--device cpu``
    on the port); its output is drained on a thread for its life."""

    def __init__(self, pkg, cfg_path):
        if pkg == "port":
            argv = [sys.executable, "-m", "spark_fsm_tpu_torch.service.app",
                    "--config", str(cfg_path), "--device", "cpu"]
        else:
            argv = [sys.executable, "-c", _REFERENCE_CHILD, "--config",
                    str(cfg_path)]
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(argv, env=env, cwd=str(ROOT),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines, self.port = [], None
        self.served = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        import re

        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"service on http://[^:]+:(\d+)", line)
            if m and self.port is None:
                self.port = int(m.group(1))
                self.served.set()
        self.served.set()

    def ready(self):
        assert self.served.wait(BOOT_TIMEOUT_S) and self.port is not None, \
            "".join(self.lines[-40:])
        return self.port

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _replica_config(path, proxy_port):
    path.write_text(json.dumps({
        "fault_injection": True,
        "service": {"port": 0, "miner_workers": 1, "queue_depth": 16},
        "store": {"backend": "redis", "host": "127.0.0.1",
                  "port": proxy_port, "timeout_s": 1.0},
        "cluster": {"enabled": True, "lease_ttl_s": LEASE_TTL_S,
                    "recover_every_s": 0.5},
        "storeguard": {"enabled": True, "probe_every_s": 0.25,
                       "down_after": 1, "spool_max_entries": 4096,
                       "stall_max_s": 120.0},
        "observability": {"trace": True, "spine_flush_spans": 8},
        "engine": {"fused": "queue"}}))


def _templates(T):
    """The script's two tiny dataset families, with the oracle's texts."""
    out = []
    for fam in range(2):
        db = T.synth.synthetic_db(seed=100 + fam, n_sequences=80, n_items=10,
                                  mean_itemsets=2.5, mean_itemset_size=1.2)
        want = T.canonical.patterns_text(T.oracle.mine_spade(
            db, T.vertical.abs_minsup(0.1, len(db))))
        out.append((dict(algorithm="SPADE_TPU", source="INLINE",
                         sequences=T.spmf.format_spmf(db), support="0.1"),
                    want))
    return out


@pytest.mark.parametrize("pkg", NAMES)
def test_seeded_storm_holds_every_invariant(pkg, tmp_path):
    from spark_fsm_tpu_torch.utils.netproxy import NetProxy

    T = PKGS["port"]
    mini = SnoopingMiniRedis()
    proxies = [NetProxy("127.0.0.1", mini.port) for _ in range(2)]
    replicas = []
    client = T.resp.RespClient(port=mini.port)
    lines = []
    try:
        for i, proxy in enumerate(proxies):
            cfg = tmp_path / f"replica{i}.json"
            _replica_config(cfg, proxy.port)
            replicas.append(_Replica(pkg, cfg))
        ports = [r.ready() for r in replicas]
        accepted, oracles = set(), {}
        S.storm_round(proxies, ports, STORM_SEED, _templates(T), accepted,
                      oracles, log=lines.append)
        assert accepted, lines
        out = S.check_invariants(client, accepted, oracles, ports,
                                 mini.lease_sets, f"{pkg} seed {STORM_SEED}",
                                 log=lines.append, quiesce_s=40.0,
                                 waive=REFERENCE_WAIVED if pkg == "reference"
                                 else ())
        assert out["parity_ok"] >= 1, lines
    finally:
        for r in replicas:
            r.stop()
        for p in proxies:
            p.close()
        client.close()
        mini.close()
