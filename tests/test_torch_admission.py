"""Admission, deadlines, cancel and kill-restart recovery of the port's
service (``AdmissionQueue``, ``StoreCheckpoint``, ``recover_orphans`` in
``spark_fsm_tpu_torch/service/actors.py``), against the reference's.

Mirrors ``tests/test_admission.py``: each drill runs once with the
reference's Miner/Master and once with the port's (engines on the CPU),
on the same input, with a deterministically blocked worker
(``sources.get_db`` gated on an event).  The two runs must agree on
terminal statuses, shed counts, error text, the queue-depth gauge and,
for the kill-restart drill, byte for byte on the resumed mine's patterns;
that drill kills the port's own queue engine (segmented route) after its
first frontier save and resumes it from that frontier."""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from _torch_cluster_rig import (DRILL_TIMEOUT_S, NAMES, PKGS, Gate,
                                PortOnCpu, await_terminal, counter, req,
                                text_of)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with PortOnCpu():
        yield


def _both(drill, monkeypatch=None):
    records = {name: (drill(PKGS[name], monkeypatch) if monkeypatch
                      is not None else drill(PKGS[name])) for name in NAMES}
    assert records["port"] == records["reference"]
    return records["reference"]


def _error(store, uid):
    return store.get(f"fsm:error:{uid}") or ""


# ----------------------------------------------------------------- overload


def _flood(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"})
    miner = P.actors.Miner(store, workers=1, queue_depth=2)
    try:
        miner.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner.submit(req(P, "q1"))
        miner.submit(req(P, "q2"))
        depth = (miner.queue_size(),
                 counter(P, "fsm_service_queue_depth"))
        hints = []
        for i in range(3):
            with pytest.raises(P.actors.AdmissionShed) as err:
                miner.submit(req(P, f"shed{i}"))
            hints.append(err.value.retry_after_s)
        traces = [(store.status(f"shed{i}"), store.journal_get(f"shed{i}"))
                  for i in range(3)]
        gate.release.set()
        statuses = {u: await_terminal(store, u)
                    for u in ("blocker", "q1", "q2")}
        return {"depth": depth, "sheds": len(hints),
                "hints_ok": all(isinstance(h, int) and 1 <= h <= 3600
                                for h in hints),
                "traces": traces, "statuses": statuses,
                "drained": (miner.queue_size(),
                            counter(P, "fsm_service_queue_depth")),
                "journal": store.journal_uids(),
                "text": text_of(P, store.patterns("q2"))}
    finally:
        gate.release.set()
        miner.shutdown()


def test_flood_sheds_exactly_k_with_retry_after(monkeypatch):
    rec = _both(_flood, monkeypatch)
    assert rec["depth"] == (2, 2) and rec["sheds"] == 3 and rec["hints_ok"]
    assert rec["traces"] == [(None, None)] * 3  # a shed leaves no trace
    assert set(rec["statuses"].values()) == {"finished"}
    assert rec["drained"] == (0, 0) and rec["journal"] == []


def _priority(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"})
    miner = P.actors.Miner(store, workers=1, queue_depth=16)
    try:
        miner.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner.submit(req(P, "p-low", priority="low"))
        miner.submit(req(P, "p-norm"))
        miner.submit(req(P, "p-high", priority="high"))
        gate.release.set()
        statuses = [await_terminal(store, u)
                    for u in ("p-low", "p-norm", "p-high")]
        with pytest.raises(ValueError, match="unknown priority"):
            miner.submit(req(P, "bad", priority="urgent"))
        return {"statuses": statuses, "order": gate.run_order}
    finally:
        gate.release.set()
        miner.shutdown()


def test_priority_classes_drain_high_first(monkeypatch):
    rec = _both(_priority, monkeypatch)
    assert rec["statuses"] == ["finished"] * 3
    assert rec["order"] == ["blocker", "p-high", "p-norm", "p-low"]


def _unbounded(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"})
    miner = P.actors.Miner(store, workers=1, queue_depth=0)
    try:
        miner.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        for i in range(8):
            miner.submit(req(P, f"j{i}"))  # never sheds
        queued = miner.queue_size()
        gate.release.set()
        return {"queued": queued,
                "statuses": [await_terminal(store, f"j{i}")
                             for i in range(8)]}
    finally:
        gate.release.set()
        miner.shutdown()


def test_unbounded_queue_depth_zero_never_sheds(monkeypatch):
    rec = _both(_unbounded, monkeypatch)
    assert rec == {"queued": 8, "statuses": ["finished"] * 8}


# ----------------------------------------------------------- uid conflicts


def _live_uid(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"dup"})
    miner = P.actors.Miner(store, workers=1, queue_depth=8)
    try:
        miner.submit(req(P, "dup"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        with pytest.raises(P.actors.UidConflict):  # running
            miner.submit(req(P, "dup"))
        miner.submit(req(P, "queued-dup"))
        with pytest.raises(P.actors.UidConflict):  # queued
            miner.submit(req(P, "queued-dup"))
        gate.release.set()
        first = [await_terminal(store, u) for u in ("dup", "queued-dup")]
        miner.submit(req(P, "dup"))  # terminal: a resubmit re-runs
        return {"first": first, "again": await_terminal(store, "dup")}
    finally:
        gate.release.set()
        miner.shutdown()


def test_resubmitting_live_uid_is_conflict_not_state_wipe(monkeypatch):
    rec = _both(_live_uid, monkeypatch)
    assert rec == {"first": ["finished", "finished"], "again": "finished"}


# ------------------------------------------------------ deadlines + cancel


def _deadline(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"})
    miner = P.actors.Miner(store, workers=1, queue_depth=8)
    try:
        miner.submit(req(P, "blocker"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner.submit(req(P, "late", deadline_s="0.05"))
        time.sleep(0.15)  # the budget burns on queue wait
        gate.release.set()
        return {"status": await_terminal(store, "late"),
                "error": _error(store, "late").split(":")[0],
                "ran": "late" in gate.run_order,
                "journal": store.journal_get("late"),
                "ctl": P.jobctl.get("late")}
    finally:
        gate.release.set()
        miner.shutdown()


def test_deadline_spent_on_queue_wait_aborts_before_running(monkeypatch):
    rec = _both(_deadline, monkeypatch)
    assert rec == {"status": "failure", "error": "DEADLINE_EXCEEDED",
                   "ran": False, "journal": None, "ctl": None}


def _bad_requests(P):
    store = P.store.ResultStore()
    miner = P.actors.Miner(store, workers=1, queue_depth=8)
    try:
        refused = []
        for uid, value in (("bad1", "-3"), ("bad2", "soon"), ("bad3", "nan"),
                           ("bad4", "inf")):
            with pytest.raises(ValueError) as err:
                miner.submit(req(P, uid, deadline_s=value))
            refused.append(str(err.value))
        return {"refused": refused,
                "statuses": [store.status(f"bad{i}") for i in range(1, 5)]}
    finally:
        miner.shutdown()


def test_bad_deadline_and_priority_rejected_synchronously():
    rec = _both(_bad_requests)
    assert "deadline_s" in rec["refused"][0]
    assert all("finite" in r for r in rec["refused"][2:])
    assert rec["statuses"] == [None] * 4


def _cancel(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"run1"})
    miner = P.actors.Miner(store, workers=1, queue_depth=8)
    try:
        miner.submit(req(P, "run1"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        miner.submit(req(P, "q1"))
        was = [P.jobctl.cancel(u) for u in ("run1", "q1", "nope")]
        gate.release.set()
        return {"was": was,
                "statuses": [await_terminal(store, u) for u in ("run1", "q1")],
                "errors": [_error(store, u).split(":")[0]
                           for u in ("run1", "q1")],
                "q1_ran": "q1" in gate.run_order,
                "journal": store.journal_uids()}
    finally:
        gate.release.set()
        miner.shutdown()


def test_cancel_running_and_queued_jobs(monkeypatch):
    rec = _both(_cancel, monkeypatch)
    assert rec == {"was": ["running", "queued", None],
                   "statuses": ["failure", "failure"],
                   "errors": ["CANCELLED", "CANCELLED"], "q1_ran": False,
                   "journal": []}


# --------------------------------------------------------- HTTP code paths


def _post_raw(port, endpoint, **params):
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{port}{endpoint}"
    try:
        with urllib.request.urlopen(url, data=data, timeout=30) as resp:
            return resp.status, dict(resp.headers), \
                json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read().decode())


def _http_codes(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"web-block"})
    master = P.actors.Master(store=store, queue_depth=1)
    kw = {"device": "cpu"} if P.name == "port" else {}
    server = P.app.make_server(0, master=master, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_port
    job = dict(algorithm="SPADE", source="INLINE", sequences="1 -1 2 -2\n",
               support="1.0")
    try:
        out = []
        code, _, body = _post_raw(port, "/train", uid="web-block", **job)
        out.append((code, body["status"]))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        code, _, body = _post_raw(port, "/train", uid="web-q1", **job)
        out.append((code, body["status"]))
        code, headers, body = _post_raw(port, "/train", uid="web-shed", **job)
        retry_after = int(headers.get("Retry-After"))
        out.append((code, body["status"], "queue full" in body["data"]["error"],
                    retry_after >= 1,
                    body["data"]["retry_after_s"] == str(retry_after)))
        code, _, body = _post_raw(port, "/train", uid="web-block", **job)
        out.append((code, "live" in body["data"]["error"]))
        for uid in ("web-block", "web-nope", "web-q1"):
            code, _, body = _post_raw(port, f"/admin/cancel/{uid}")
            out.append((code, body.get("was")))
        out.append(await_terminal(store, "web-q1"))
        out.append(_error(store, "web-q1").split(":")[0])
        code, _, body = _post_raw(port, "/train", uid="web-q2", **job)
        out.append((code, body["status"]))  # the slot came back
        gate.release.set()
        out.append((await_terminal(store, "web-block"),
                    _error(store, "web-block").split(":")[0]))
        out.append(await_terminal(store, "web-q2"))
        return out
    finally:
        gate.release.set()
        master.shutdown()
        server.shutdown()
        server.server_close()


def test_http_429_retry_after_409_conflict_and_cancel(monkeypatch):
    rec = _both(_http_codes, monkeypatch)
    assert rec == [(200, "started"), (200, "started"),
                   (429, "failure", True, True, True), (409, True),
                   (200, "running"), (404, None), (200, "queued"),
                   "failure", "CANCELLED", (200, "started"),
                   ("failure", "CANCELLED"), "finished"]


# -------------------------------------------------- shutdown drain (full q)


def _drain(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"blocker"})
    miner = P.actors.Miner(store, workers=1, queue_depth=3)
    miner.submit(req(P, "blocker"))
    assert gate.entered.wait(DRILL_TIMEOUT_S)
    for i in range(3):
        miner.submit(req(P, f"backlog{i}"))
    done = threading.Event()

    def drain():
        miner.shutdown(join_timeout_s=DRILL_TIMEOUT_S)
        done.set()

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.time() + DRILL_TIMEOUT_S
    while not miner._stopping and time.time() < deadline:
        time.sleep(0.01)
    try:
        miner.submit(req(P, "drain-shed"))
        shed = False
    except P.actors.AdmissionShed:
        shed = True
    shed_trace = store.status("drain-shed")
    gate.release.set()
    assert done.wait(DRILL_TIMEOUT_S), "shutdown drain hung"
    return {"shed": shed, "shed_trace": shed_trace,
            "blocker": store.status("blocker"),
            "backlog": [(store.status(f"backlog{i}"),
                         "shutting down" in _error(store, f"backlog{i}"),
                         store.journal_get(f"backlog{i}")) for i in range(3)],
            "journal": store.journal_uids(), "queued": miner.queue_size()}


def test_shutdown_drain_under_full_queue_fails_backlog_durably(monkeypatch):
    rec = _both(_drain, monkeypatch)
    assert rec == {"shed": True, "shed_trace": None, "blocker": "finished",
                   "backlog": [("failure", True, None)] * 3,
                   "journal": [], "queued": 0}


# ----------------------------------------------------- kill-restart drill


class _Kill(BaseException):
    """A simulated hard kill: a BaseException, so no supervision layer
    catches it and the store is left as a SIGKILL would leave it."""


class _KillingCheckpoint:
    """A StoreCheckpoint that 'kills the process' right after its first
    frontier save lands."""

    def __init__(self, inner):
        self.inner, self.every_s, self.saves = inner, 0.0, 0

    def load(self):
        return self.inner.load()

    def save(self, state):
        self.inner.save(state)
        self.saves += 1
        raise _Kill


def orphan_checkpointed_job(P, store, uid, db_text, support="0.1",
                            extra=None):
    """Leave ``store`` as a kill -9 mid-mine would: a journal intent of a
    dead incarnation (``extra`` adds to it), status 'started', the first
    frontier save of ``P``'s own engine, no results.  Returns the saves
    made and the request."""
    req_data = {"algorithm": "SPADE_TPU", "source": "INLINE",
                "sequences": db_text, "support": support, "checkpoint": "1",
                "checkpoint_every_s": "0", "uid": uid}
    store.journal_set(uid, json.dumps(dict({
        "uid": uid, "incarnation": "dead-incarnation", "ts": 0,
        "checkpoint": True, "priority": "normal", "request": req_data},
        **(extra or {}))))
    store.add_status(uid, "started")
    ckpt = _KillingCheckpoint(P.actors.StoreCheckpoint(store, uid,
                                                       every_s=0.0))
    r = P.model.ServiceRequest("fsm", "train", dict(req_data))
    with pytest.raises(_Kill):
        P.plugins.get_plugin(r).extract(r, P.spmf.parse_spmf(db_text), {},
                                        checkpoint=ckpt)
    assert store.get(f"fsm:frontier:{uid}") is not None
    assert store.patterns(uid) is None
    return ckpt.saves, req_data


def _kill_restart(P):
    db = P.synth.synthetic_db(seed=31, n_sequences=120, n_items=10,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    store = P.store.ResultStore()
    saves, _ = orphan_checkpointed_job(P, store, "drill",
                                       P.spmf.format_spmf(db))
    store.journal_set("plain", json.dumps({
        "uid": "plain", "incarnation": "dead-incarnation", "ts": 0,
        "checkpoint": False, "priority": "normal",
        "request": {"algorithm": "SPADE", "source": "INLINE",
                    "sequences": "1 -1 2 -2\n", "support": "1.0",
                    "uid": "plain"}}))
    store.add_status("plain", "started")
    store.journal_set("settled", json.dumps({
        "uid": "settled", "incarnation": "dead-incarnation", "ts": 0,
        "checkpoint": False, "priority": "normal", "request": {}}))
    store.add_status("settled", "finished")
    master = P.actors.Master(store=store)  # the rebooted incarnation
    try:
        report = P.actors.recover_orphans(master)
        status = await_terminal(store, "drill")
        stats = json.loads(P.envelope.unwrap(
            store.get("fsm:stats:drill"))[0])
        want = P.canonical.patterns_text(P.oracle.mine_spade(
            db, P.vertical.abs_minsup(0.1, len(db))))
        text = text_of(P, store.patterns("drill"))
        assert text == want
        return {"saves": saves, "report": report, "status": status,
                "route": stats.get("fused"),
                "resumed_nodes": stats.get("resumed_nodes", 0) > 0,
                "text": text, "plain": store.status("plain"),
                "plain_error": "interrupted by restart" in _error(store,
                                                                  "plain"),
                "settled": store.status("settled"),
                "journal": store.journal_uids()}
    finally:
        master.shutdown()


def test_kill_restart_drill_resumes_checkpointed_and_fails_orphans():
    rec = _both(_kill_restart)
    assert rec["saves"] == 1
    assert rec["report"] == {"resumed": ["drill"], "failed": ["plain"],
                             "cleared": ["settled"], "quarantined": []}
    assert rec["status"] == "finished"
    assert rec["route"] == "queue" and rec["resumed_nodes"]
    assert rec["plain"] == "failure" and rec["plain_error"]
    assert rec["settled"] == "finished" and rec["journal"] == []


def _idempotent(P, monkeypatch):
    store = P.store.ResultStore()
    gate = Gate(P, monkeypatch, block_uids={"held"})
    master = P.actors.Master(store=store)
    try:
        master.miner.submit(req(P, "held"))
        assert gate.entered.wait(DRILL_TIMEOUT_S)
        report = P.actors.recover_orphans(master)
        during = store.status("held")
        gate.release.set()
        return {"report": report, "during": during,
                "end": await_terminal(store, "held")}
    finally:
        gate.release.set()
        master.shutdown()


def test_recovery_is_idempotent_and_skips_live_jobs(monkeypatch):
    rec = _both(_idempotent, monkeypatch)
    assert rec == {"report": {"resumed": [], "failed": [], "cleared": [],
                              "quarantined": []},
                   "during": "started", "end": "finished"}
