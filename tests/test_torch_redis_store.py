"""The port's Redis-protocol store (``spark_fsm_tpu_torch/service/store.py``
``RedisResultStore`` over ``service/resp.py``) on the wire, against the
reference's.

Mirrors ``tests/test_redis_store.py`` over the copied in-process server
(``tests/_torch_miniredis.py``): the client round trip, the store
contract, the write-ahead journal, key expiry on a virtual clock, cursor
SCAN walks and the lease layer's walks.  Where both packages drive the
same calls, each talks to its own MiniRedis and the two servers must end
with the same keys, values and command stream.  The end-to-end mine goes
through each package's ``Master`` (the port's engines on the CPU) on a
Redis-backed store, and ``/get/patterns`` must answer byte-identical
bodies."""

import json
import socket
import threading
import urllib.parse
import urllib.request

import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, await_terminal
from _torch_miniredis import MiniRedis


@pytest.fixture()
def servers():
    """One MiniRedis per package."""
    minis = {name: MiniRedis() for name in NAMES}
    yield minis
    for mini in minis.values():
        mini.close()


def _state(mini):
    return {"kv": dict(mini.kv), "lists": {k: list(v) for k, v in
                                           mini.lists.items()},
            "commands": list(mini.commands_seen)}


def test_encode_command_bytes():
    for args in (("SET", "k", "v"), ("SET", "lease", "r\r\nx", "PX", "5",
                                     "NX"), ("SCAN", "0", "MATCH", "a*")):
        port = PKGS["port"].resp.encode_command(*args)
        assert port == PKGS["reference"].resp.encode_command(*args)
    assert PKGS["port"].resp.encode_command("SET", "k", "v") == \
        b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"


@pytest.mark.parametrize("pkg", NAMES)
def test_client_roundtrip(pkg):
    P = PKGS[pkg]
    mini = MiniRedis()
    try:
        c = P.resp.RespClient(port=mini.port)
        assert c.ping()
        c.set("a", "hello\r\nworld")  # CRLF inside a bulk string survives
        assert c.get("a") == "hello\r\nworld" and c.get("missing") is None
        assert (c.rpush("l", "x"), c.rpush("l", "y")) == (1, 2)
        assert c.lrange("l") == ["x", "y"] and c.llen("l") == 2
        assert c.lpop("l") == "x" and c.lrange("l") == ["y"]
        assert c.lpop("missing") is None
        assert (c.incr("n"), c.incr("n")) == (1, 2)
        assert c.delete("a") == 1 and c.get("a") is None
        with pytest.raises(P.resp.RespError, match="unknown command"):
            c.command("FLUSHALL")
        c.close()
    finally:
        mini.close()


def _contract(P, mini):
    store = P.store.RedisResultStore(port=mini.port)
    store.add_status("u1", "started")
    store.add_status("u1", "finished")
    out = [store.status("u1"), [s for _, s in store.status_log("u1")]]
    store.add_patterns("u1", '[{"support": 3}]')
    store.add_rules("u1", "[]")
    store.add_fields("t", '{"item": "sku"}')
    store.track("t", '{"sku": 5}')
    out += [store.patterns("u1"), store.rules("u1"), store.fields("t"),
            store.tracked("t"), store.incr("fsm:metric:jobs_submitted")]
    store.clear_job("u1")
    out += [store.patterns("u1"), store.status("u1"), store.status_log("u1")]
    return out


def test_store_contract_over_wire(servers):
    out = {name: _contract(PKGS[name], servers[name]) for name in NAMES}
    assert out["port"] == out["reference"] == [
        "finished", ["started", "finished"], '[{"support": 3}]', "[]",
        '{"item": "sku"}', ['{"sku": 5}'], 1, None, "finished", []]
    # the port sent the reference's commands, and the servers hold the same
    # data (the status-log entries carry wall-clock stamps)
    port, ref = (_state(servers[n]) for n in ("port", "reference"))
    assert port["commands"] == ref["commands"]
    assert {"SET", "RPUSH", "INCR"} <= set(port["commands"])
    assert port["kv"] == ref["kv"]
    assert port["lists"].keys() == ref["lists"].keys()


def _journal(P, mini):
    store = P.store.RedisResultStore(port=mini.port)
    store.journal_set("j1", '{"incarnation": "a"}')
    store.journal_set("j2", '{"incarnation": "b"}')
    store.set("fsm:status:j1", "started")  # not a journal key
    out = [store.journal_uids(), store.journal_get("j1")]
    store2 = P.store.RedisResultStore(port=mini.port)  # the rebooted one
    out.append(store2.journal_uids())
    store2.journal_clear("j1")
    out.append(store.journal_uids())
    return out


def test_journal_contract_over_wire(servers):
    out = {name: _journal(PKGS[name], servers[name]) for name in NAMES}
    assert out["port"] == out["reference"] == [
        ["j1", "j2"], '{"incarnation": "a"}', ["j1", "j2"], ["j2"]]
    port, ref = (_state(servers[n]) for n in ("port", "reference"))
    assert port == ref
    assert "SCAN" in port["commands"] and "KEYS" not in port["commands"]


def test_key_expiry_over_wire_with_virtual_clock():
    P = PKGS["port"]
    t = [0.0]
    server = MiniRedis(clock=lambda: t[0])
    try:
        c = P.resp.RespClient(port=server.port)
        assert c.set_px("lease", "holder-a", 5000, nx=True) is True
        assert c.set_px("lease", "holder-b", 5000, nx=True) is False
        assert c.get("lease") == "holder-a"
        assert 0 < c.pttl("lease") <= 5000
        t[0] = 4.0
        assert c.pexpire("lease", 5000) is True
        t[0] = 8.0  # past the first deadline: renewed
        assert c.get("lease") == "holder-a"
        t[0] = 9.5
        assert c.get("lease") is None and c.pttl("lease") == -2
        assert c.pexpire("lease", 1000) is False
        assert c.set_px("lease", "holder-b", 5000, nx=True) is True
        c.set("lease", "holder-b2")  # plain SET clears the TTL
        assert c.pttl("lease") == -1
        t[0] = 100.0
        assert c.get("lease") == "holder-b2"
        assert c.set_px("claim", "x", 1000) is True
        assert (c.delete("claim"), c.delete("claim")) == (1, 0)
        c.close()
    finally:
        server.close()


def test_inproc_store_expiry_matches_wire_semantics():
    t = [0.0]
    s = PKGS["port"].store.ResultStore(clock=lambda: t[0])
    assert s.set_px("lease", "a", 2000, nx=True) is True
    assert s.set_px("lease", "b", 2000, nx=True) is False
    assert 0 < s.pttl("lease") <= 2000
    t[0] = 1.5
    assert s.pexpire("lease", 2000) is True
    t[0] = 3.0
    assert s.get("lease") == "a"
    t[0] = 3.6
    assert s.get("lease") is None and s.pttl("lease") == -2
    assert s.pexpire("lease", 500) is False
    assert s.set_px("lease", "b", 1000, nx=True) is True
    assert s.keys("lease") == ["lease"]
    t[0] = 5.0
    assert s.keys("lease") == []
    s.set_px("claim", "x", 1000)
    s.set("claim", "y")
    t[0] = 50.0
    assert s.get("claim") == "y"
    assert (s.delete("claim"), s.delete("claim")) == (1, 0)


def _scan(P, mini):
    store = P.store.RedisResultStore(port=mini.port)
    want = {f"fsm:journal:j{i:05d}" for i in range(1200)}
    for k in sorted(want):
        store.set(k, "{}")
    store.set("fsm:status:unrelated", "x")
    mini.commands_seen.clear()
    got = list(store.scan_iter("fsm:journal:", count=100))
    assert set(got) == want and len(got) == len(want)
    walk = list(mini.commands_seen)
    cur, batch = store.scan_keys("fsm:journal:", "0", count=50)
    cur2, batch2 = store.scan_keys("fsm:journal:", cur, count=50)
    mini.commands_seen.clear()
    uids = store.journal_uids()
    return {"walk": walk, "step": (len(batch), cur != "0",
                                   batch2[0] > batch[-1]),
            "uids": len(uids), "uid_walk": list(mini.commands_seen)}


def test_scan_walks_large_keyspace_incrementally(servers):
    out = {name: _scan(PKGS[name], servers[name]) for name in NAMES}
    assert out["port"] == out["reference"]
    rec = out["port"]
    assert rec["walk"].count("SCAN") >= 12 and "KEYS" not in rec["walk"]
    assert rec["step"] == (50, True, True)
    assert rec["uids"] == 1200
    assert "SCAN" in rec["uid_walk"] and "KEYS" not in rec["uid_walk"]


def test_inproc_scan_matches_wire_semantics():
    t = [0.0]
    s = PKGS["port"].store.ResultStore(clock=lambda: t[0])
    for i in range(25):
        s.set(f"fsm:replica:r{i:02d}", "{}")
    s.set_px("fsm:replica:dying", "{}", 1000)
    seen, cursor, steps = [], "0", 0
    while True:
        cursor, batch = s.scan_keys("fsm:replica:", cursor, count=7)
        seen.extend(batch)
        steps += 1
        if cursor == "0":
            break
    assert steps >= 4 and len(seen) == len(set(seen)) == 26
    t[0] = 2.0
    assert "fsm:replica:dying" not in list(s.scan_iter("fsm:replica:"))


def _lease_walks(P, mini):
    store = P.store.RedisResultStore(port=mini.port)
    mgr = P.lease.LeaseManager(store, replica_id="scan-a", lease_ttl_s=30,
                               heartbeat_s=0)
    peer = P.lease.LeaseManager(store, replica_id="scan-b", lease_ttl_s=30,
                                heartbeat_s=0)

    class _IdleMiner:  # the Miner surface the steal scan reads
        def idle_capacity(self):
            return 1

        def queue_size(self):
            return 0

    mgr._miner = _IdleMiner()
    peer._miner = None
    peer.publish_heartbeat()
    raw = json.loads(P.envelope.unwrap(store.peek("fsm:replica:scan-b"))[0])
    raw.update({"queued": 1, "steal": True})  # a loaded-looking peer
    store.set_px("fsm:replica:scan-b", P.envelope.wrap(json.dumps(raw)),
                 30000)
    store.set("fsm:admission:scan-b:job1", "1")
    mini.commands_seen.clear()
    peers = [p["replica"] for p in mgr.peers()]
    mgr.steal_once()  # walks the peer's admission namespace
    return {"peers": peers, "commands": sorted(set(mini.commands_seen))}


def test_lease_walks_use_scan_not_keys(servers):
    out = {name: _lease_walks(PKGS[name], servers[name]) for name in NAMES}
    assert out["port"] == out["reference"]
    assert out["port"]["peers"] == ["scan-b"]
    assert "SCAN" in out["port"]["commands"]
    assert "KEYS" not in out["port"]["commands"]


def test_store_fails_fast_when_down():
    with pytest.raises(OSError):
        PKGS["port"].store.RedisResultStore(port=1)  # nothing listens


def test_client_resyncs_after_protocol_error():
    P = PKGS["port"]
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    replies = [b",3.14\r\n", b"+PONG\r\n"]  # a RESP3 double, then PONG

    def serve_conn(conn):
        try:
            while True:
                if not conn.recv(65536):
                    return
                conn.sendall(replies.pop(0))
        except (OSError, IndexError):
            conn.close()

    def accept_loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve_conn, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    c = P.resp.RespClient(port=srv.getsockname()[1])
    with pytest.raises(P.resp.RespProtocolError):
        c.ping()
    assert c._sock is None  # poisoned
    assert c.ping()         # a fresh stream
    c.close()
    srv.close()


# ------------------------------------------------------ end-to-end mine


def _get(port, endpoint, **params):
    url = f"http://127.0.0.1:{port}{endpoint}"
    data = urllib.parse.urlencode(params).encode()
    with urllib.request.urlopen(url, data=data, timeout=60) as resp:
        return resp.read().decode()


def _mine_over_redis(P, mini, db_text):
    store = P.store.RedisResultStore(port=mini.port)
    master = P.actors.Master(store=store)
    kw = {"device": "cpu"} if P.name == "port" else {}
    server = P.app.make_server(0, master=master, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        started = json.loads(_get(server.server_port, "/train", uid="e2e",
                                  algorithm="SPADE_TPU", source="INLINE",
                                  sequences=db_text, support="0.1"))
        status = await_terminal(store, "e2e", timeout=60)
        body = _get(server.server_port, "/get/patterns", uid="e2e")
        in_server = mini.kv["fsm:pattern:e2e"] == store.patterns("e2e")
        return started["status"], status, body, in_server
    finally:
        master.shutdown()
        server.shutdown()
        server.server_close()


def test_store_end_to_end_mine(servers):
    """A train job through each package's Master on a Redis-backed store:
    the results live in the server's dict, and ``/get/patterns`` bodies
    are byte-identical."""
    db = PKGS["port"].synth.synthetic_db(seed=23, n_sequences=150,
                                         n_items=12, mean_itemsets=3.0)
    text = PKGS["port"].spmf.format_spmf(db)
    with PortOnCpu():
        out = {name: _mine_over_redis(PKGS[name], servers[name], text)
               for name in NAMES}
    assert out["port"] == out["reference"]
    started, status, body, in_server = out["port"]
    assert (started, status, in_server) == ("started", "finished", True)
    assert json.loads(body)["data"]["patterns"] != "[]"
