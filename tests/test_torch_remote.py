"""The actor-protocol TCP entry on the port (``spark_fsm_tpu_torch/service/
remote.py``), against the reference's ``tests/test_remote_api.py``.

Each test of the reference is one test here, parametrised over the two
packages (``_torch_cluster_rig.PKGS``): each package's Master (the port's
engines on the CPU) sits behind its own ``serve_remote_background``, the
same lines go over a real socket, and the replies must be equal, save the
uids each Master draws and the walls.
"""

import json
import socket
import time

import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, Twins, assert_covers

T = Twins(PKGS)


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


def test_covers_the_reference():
    assert_covers(globals(), "test_remote_api.py")


class _Remote:
    """``P``'s Master behind its own TCP entry."""

    def __init__(self, P):
        self.P = P

    def __enter__(self):
        self.master = self.P.actors.Master(store=self.P.store.ResultStore())
        self.server = self.P.remote.serve_remote_background(self.master)
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.master.shutdown()

    def client(self):
        return self.P.remote.RemoteClient(port=self.server.port)

    def raw(self):
        sock = socket.create_connection(("127.0.0.1", self.server.port),
                                        timeout=10)
        return sock, sock.makefile("rwb")


def _wait_finished(client, uid, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        resp = client.request("status", {"uid": uid})
        if resp["status"] in ("finished", "failure"):
            return resp
        time.sleep(0.02)
    raise TimeoutError("job did not finish")


def _sans_uid(resp, uid):
    """A reply with the Master's drawn uid spelled ``<uid>``."""
    return json.loads(json.dumps(resp).replace(uid, "<uid>"))


def _lifecycle(P):
    with _Remote(P) as r:
        client = r.client()
        resp = client.request("train", {
            "algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n2 -1 1 -2\n",
            "support": "0.5"})
        uid = resp["data"]["uid"]
        final = _wait_finished(client, uid)
        got = client.request("get:patterns", {"uid": uid})
        client.close()
    patterns = json.loads(got["data"]["patterns"])
    rec = {"train": _sans_uid(resp, uid), "final": final["status"],
           "get": _sans_uid(got, uid)}
    assert resp["status"] == "started" and final["status"] == "finished"
    assert {"support": 3, "itemsets": [[1]]} in patterns
    assert {"support": 2, "itemsets": [[1], [2]]} in patterns
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_train_status_get_over_socket(pkg):
    T.held(pkg, _lifecycle)


def _register_track(P):
    with _Remote(P) as r:
        client = r.client()
        replies = [client.request("register:clicks", {
            "site": "shop", "user": "visitor", "timestamp": "ts",
            "group": "session", "item": "sku"})]
        for visitor, ts, session, sku in [("u1", 1, 1, 7), ("u1", 2, 2, 8),
                                          ("u2", 1, 3, 7), ("u2", 2, 4, 8)]:
            replies.append(client.request("track:clicks", {
                "shop": "main", "visitor": visitor, "ts": ts,
                "session": session, "sku": sku}))
        resp = client.request("train", {
            "algorithm": "SPADE", "source": "TRACKED", "topic": "clicks",
            "support": "0.9"})
        uid = resp["data"]["uid"]
        final = _wait_finished(client, uid)
        got = client.request("get:patterns", {"uid": uid})
        client.close()
    rec = {"replies": replies, "final": final["status"],
           "get": _sans_uid(got, uid)}
    assert all(x["status"] == "finished" for x in replies)
    assert rec["final"] == "finished"
    assert {"support": 2, "itemsets": [[7], [8]]} in json.loads(
        got["data"]["patterns"])
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_register_track_mine_over_socket(pkg):
    T.held(pkg, _register_track)


def _malformed(P):
    lines = [b"this is not json\n", b"[1, 2, 3]\n",
             b'{"service": "fsm", "task": "status", "data": null}\n',
             b'{"service": "fsm", "task": "frobnicate", "data": {}}\n',
             b'{"service": "fsm", "task": "status", "data": {"uid": "x"}}\n']
    with _Remote(P) as r:
        raw, f = r.raw()
        replies = []
        for line in lines:
            f.write(line)
            f.flush()
            replies.append(json.loads(f.readline()))
        raw.close()
    assert replies[0]["status"] == "failure" \
        and "malformed" in replies[0]["data"]["error"]
    assert [x["status"] for x in replies[1:4]] == ["failure"] * 3
    assert replies[4]["task"] == "status"
    return {"replies": replies}


@pytest.mark.parametrize("pkg", NAMES)
def test_malformed_requests_keep_connection(pkg):
    T.held(pkg, _malformed)


def _blank_lines(P):
    with _Remote(P) as r:
        c1, c2 = r.client(), r.client()
        c1._file.write(b"\n\n")
        c1._file.flush()
        replies = [c1.request("status", {"uid": "nope"}),
                   c2.request("status", {"uid": "nope"})]
        c1.close()
        c2.close()
    assert [x["task"] for x in replies] == ["status", "status"]
    return {"replies": replies}


@pytest.mark.parametrize("pkg", NAMES)
def test_blank_lines_skipped_and_concurrent_clients(pkg):
    T.held(pkg, _blank_lines)


def _oversized(P):
    real = P.remote.MAX_LINE
    P.remote.MAX_LINE = 1024
    try:
        with _Remote(P) as r:
            raw, f = r.raw()
            f.write(b'{"service": "fsm", "task": "status", "data": {"x": "'
                    + b"A" * 5000 + b'"}}\n')
            f.flush()
            replies = [json.loads(f.readline())]
            f.write(b'{"service": "fsm", "task": "status", '
                    b'"data": {"uid": "x"}}\n')
            f.flush()
            replies.append(json.loads(f.readline()))
            raw.close()
    finally:
        P.remote.MAX_LINE = real
    assert replies[0]["status"] == "failure" \
        and "exceeds" in replies[0]["data"]["error"]
    assert replies[1]["task"] == "status"
    return {"replies": replies}


@pytest.mark.parametrize("pkg", NAMES)
def test_oversized_line_drained_and_framing_kept(pkg):
    T.held(pkg, _oversized)


def _prediction(P):
    with _Remote(P) as r:
        client = r.client()
        resp = client.request("train", {
            "algorithm": "TSR", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n1 -1 3 -2\n2 -1 3 -2\n",
            "k": "5", "minconf": "0.3", "max_side": "1"})
        uid = resp["data"]["uid"]
        final = _wait_finished(client, uid)
        got = client.request("get:prediction", {"uid": uid, "items": "1"})
        client.close()
    preds = json.loads(got["data"]["predictions"])
    rec = {"final": final["status"], "get": _sans_uid(got, uid)}
    assert final["status"] == "finished" and got["status"] == "finished"
    assert preds and all(p["item"] != 1 and p["antecedent"] == [1]
                         for p in preds)
    top = {p["item"]: p for p in preds}
    assert top[2]["support"] == 2 and top[2]["antecedent_support"] == 3
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_prediction_over_socket(pkg):
    T.held(pkg, _prediction)
