"""The port's copy of the partition-chaos TCP proxy
(``spark_fsm_tpu_torch/utils/netproxy.py``) through the cases of
``tests/test_netproxy.py``: the storm harness's network fault plane,
proven against a local echo server and MiniRedis.

The modes under test are the storm harness's vocabulary: blackhole
(half-open partition — bytes swallowed, connection held), delay
(latency cliff), refuse (fast connection failure), reset (mid-stream
close), heal (clean recovery), and ASYMMETRY (two proxies to one
upstream, partitioned independently — the per-replica partition shape
scripts/storm_smoke.py drives)."""

import socket
import threading
import time

import pytest

from spark_fsm_tpu_torch.utils.netproxy import NetProxy


@pytest.fixture()
def echo():
    """Line-oriented echo server on an ephemeral loopback port."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve(conn):
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                conn.sendall(chunk)
        except OSError:
            pass
        finally:
            conn.close()

    def accept():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()
    yield srv.getsockname()[1]
    srv.close()


def _connect(port, timeout=2.0):
    return socket.create_connection(("127.0.0.1", port), timeout=timeout)


def _roundtrip(sock, payload=b"ping\n"):
    sock.sendall(payload)
    return sock.recv(65536)


def test_passthrough_and_stats(echo):
    proxy = NetProxy("127.0.0.1", echo)
    try:
        s = _connect(proxy.port)
        assert _roundtrip(s, b"hello") == b"hello"
        assert _roundtrip(s, b"world") == b"world"
        # the pipe thread counts AFTER forwarding: poll briefly
        deadline = time.monotonic() + 2.0
        st = proxy.stats()
        while time.monotonic() < deadline and (
                st["bytes_up"] < 10 or st["bytes_down"] < 10):
            time.sleep(0.01)
            st = proxy.stats()
        assert st["connections"] == 1
        assert st["bytes_up"] == 10 and st["bytes_down"] == 10
        s.close()
    finally:
        proxy.close()


def test_blackhole_swallows_then_heal_restores(echo):
    proxy = NetProxy("127.0.0.1", echo)
    try:
        s = _connect(proxy.port, timeout=0.3)
        assert _roundtrip(s) == b"ping\n"
        proxy.blackhole(True)
        s.sendall(b"lost\n")
        with pytest.raises(socket.timeout):
            s.recv(65536)  # half-open: nothing comes back, no close
        assert proxy.stats()["swallowed_bytes"] >= 5
        proxy.heal()
        # the old stream swallowed bytes mid-conversation — a client
        # reconnects (exactly what RespClient does after a timeout)
        s.close()
        s2 = _connect(proxy.port, timeout=2.0)
        assert _roundtrip(s2, b"back\n") == b"back\n"
        s2.close()
    finally:
        proxy.close()


def test_delay_adds_latency(echo):
    proxy = NetProxy("127.0.0.1", echo)
    try:
        s = _connect(proxy.port, timeout=5.0)
        assert _roundtrip(s) == b"ping\n"
        proxy.delay(0.25)
        t0 = time.monotonic()
        assert _roundtrip(s) == b"ping\n"
        assert time.monotonic() - t0 >= 0.25
        proxy.heal()
        s.close()
    finally:
        proxy.close()


def test_refuse_and_reset(echo):
    proxy = NetProxy("127.0.0.1", echo)
    try:
        s = _connect(proxy.port)
        assert _roundtrip(s) == b"ping\n"
        # reset: the live stream dies NOW
        assert proxy.reset_all() >= 1
        with pytest.raises(OSError):
            if s.recv(65536) == b"":  # orderly close also counts
                raise ConnectionResetError
        s.close()
        # refuse: new connections die immediately
        proxy.refuse(True)
        s2 = _connect(proxy.port)
        s2.settimeout(2.0)
        assert s2.recv(65536) == b""  # closed on accept
        s2.close()
        proxy.heal()
        s3 = _connect(proxy.port)
        assert _roundtrip(s3) == b"ping\n"
        s3.close()
    finally:
        proxy.close()


def test_asymmetric_partition_two_proxies_one_upstream(echo):
    """The per-replica partition shape: A's proxy black-holed, B's
    clean — same upstream."""
    pa = NetProxy("127.0.0.1", echo)
    pb = NetProxy("127.0.0.1", echo)
    try:
        sa = _connect(pa.port, timeout=0.3)
        sb = _connect(pb.port, timeout=2.0)
        pa.blackhole(True)
        sa.sendall(b"a\n")
        with pytest.raises(socket.timeout):
            sa.recv(65536)
        assert _roundtrip(sb, b"b\n") == b"b\n"  # B unaffected
        sa.close()
        sb.close()
    finally:
        pa.close()
        pb.close()


def test_proxy_fronts_miniredis_for_resp_client(echo):
    """End-to-end with the real RESP client + MiniRedis: a blackhole
    surfaces as a transport timeout (what RedisResultStore hands the
    storeguard), and a healed proxy serves a fresh connection."""
    import sys

    sys.path.insert(0, "tests")
    from test_redis_store import MiniRedis

    from spark_fsm_tpu_torch.service.resp import RespClient

    mini = MiniRedis()
    proxy = NetProxy("127.0.0.1", mini.port)
    try:
        c = RespClient(port=proxy.port, timeout=0.5)
        assert c.ping()
        c.set("k", "v")
        assert c.get("k") == "v"
        proxy.blackhole(True)
        with pytest.raises(OSError):
            c.get("k")
        proxy.heal()
        assert c.ping()  # transparent reconnect through the clean proxy
        assert c.get("k") == "v"
        c.close()
    finally:
        proxy.close()
        mini.close()
