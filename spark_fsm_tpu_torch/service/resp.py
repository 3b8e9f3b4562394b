"""Minimal RESP2 (Redis Serialization Protocol) client over stdlib sockets.

The reference persists results/metadata in Redis through a JVM client
(SURVEY.md sec 2 "Redis sink/cache").  This rebuild talks the wire
protocol directly — no third-party client package — which keeps the Redis
seam real and testable without a Redis server: the test suite
runs ``RedisResultStore`` against an in-process RESP server
(tests/test_redis_store.py), and the same bytes reach a production Redis.

Covers what the store needs: command pipelining-free request/response with
simple strings, errors, integers, bulk strings, and arrays.

Port: a copy of ``spark_fsm_tpu/service/resp.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional, Tuple, Union


class RespError(RuntimeError):
    """Server-side error reply (RESP '-ERR ...')."""


class RespProtocolError(ConnectionError):
    """Malformed/unknown bytes on the reply stream — the connection can no
    longer be trusted to be in sync and must be discarded."""


# Error ELEMENTS inside an array reply surface as RespError values (raising
# mid-array would desync the stream); top-level errors raise.
Reply = Union[None, int, str, RespError, List["Reply"]]


def encode_command(*args: Union[str, bytes, int]) -> bytes:
    """Encode one command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode("utf-8")
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class RespClient:
    """Blocking request/response client; thread-safe via a send lock."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 10.0) -> None:
        self._host, self._port, self._timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()
        self._connect()  # fail fast if nothing listens

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout)
        self._buf = b""

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""

    # ---------------------------------------------------------------- io

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + trailing \r\n
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        payload, self._buf = self._buf[:n], self._buf[n + 2:]
        return payload

    def _read_reply(self, depth: int = 0) -> Reply:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":  # simple string
            return rest.decode("utf-8")
        if kind == b"-":  # error
            err = RespError(rest.decode("utf-8"))
            if depth:  # an error ELEMENT of an array: the remaining
                return err  # elements must still be consumed — no raise
            raise err
        try:
            if kind == b":":  # integer
                return int(rest)
            if kind == b"$":  # bulk string
                n = int(rest)
                if n == -1:
                    return None
                return self._read_exact(n).decode("utf-8")
            if kind == b"*":  # array
                n = int(rest)
                if n == -1:
                    return None
                return [self._read_reply(depth + 1) for _ in range(n)]
        except ValueError as exc:  # malformed length/integer
            raise RespProtocolError(f"malformed RESP reply {line!r}") from exc
        raise RespProtocolError(f"unknown RESP reply type {line!r}")

    # ------------------------------------------------------------ command

    def command(self, *args: Union[str, bytes, int]) -> Reply:
        with self._lock:
            if self._sock is None:
                self._connect()  # transparent reconnect after a poisoning
            try:
                self._sock.sendall(encode_command(*args))
                return self._read_reply()
            except RespError:
                raise  # server error reply — the stream is still in sync
            except OSError:
                # A timeout/transport/protocol error mid-reply leaves the
                # stream desynced (a late remainder would be parsed as the
                # NEXT command's reply) — drop the connection so the next
                # command starts on a fresh, in-sync socket instead of
                # reading off-by-one replies from this one.
                self.close()
                raise

    # convenience wrappers (the subset the store uses)

    def set(self, key: str, value: str) -> None:
        self.command("SET", key, value)

    def set_px(self, key: str, value: str, px_ms: int,
               nx: bool = False) -> bool:
        """``SET key value PX px_ms [NX]`` — the lease-acquisition
        primitive.  Redis replies +OK on success and Null when NX
        refused the write; True/False respectively."""
        args = ["SET", key, value, "PX", int(px_ms)]
        if nx:
            args.append("NX")
        return self.command(*args) == "OK"

    def pexpire(self, key: str, px_ms: int) -> bool:
        """PEXPIRE — lease heartbeat renewal; False = key gone (lost)."""
        return self.command("PEXPIRE", key, int(px_ms)) == 1

    def pttl(self, key: str) -> int:
        """PTTL in ms; -1 = no expiry, -2 = no such key."""
        reply = self.command("PTTL", key)
        assert isinstance(reply, int)
        return reply

    def get(self, key: str) -> Optional[str]:
        reply = self.command("GET", key)
        assert reply is None or isinstance(reply, str)
        return reply

    def rpush(self, key: str, value: str) -> int:
        reply = self.command("RPUSH", key, value)
        assert isinstance(reply, int)
        return reply

    def lrange(self, key: str, start: int = 0, stop: int = -1) -> List[str]:
        reply = self.command("LRANGE", key, start, stop)
        if reply is None:
            return []
        assert isinstance(reply, list)
        return [r for r in reply if isinstance(r, str)]

    def lpop(self, key: str) -> Optional[str]:
        reply = self.command("LPOP", key)
        assert reply is None or isinstance(reply, str)
        return reply

    def llen(self, key: str) -> int:
        reply = self.command("LLEN", key)
        assert isinstance(reply, int)
        return reply

    def ltrim(self, key: str, start: int, stop: int) -> None:
        self.command("LTRIM", key, start, stop)

    def delete(self, key: str) -> int:
        reply = self.command("DEL", key)
        assert isinstance(reply, int)
        return reply

    def incr(self, key: str) -> int:
        reply = self.command("INCR", key)
        assert isinstance(reply, int)
        return reply

    def keys(self, pattern: str) -> List[str]:
        reply = self.command("KEYS", pattern)
        if reply is None:
            return []
        assert isinstance(reply, list)
        return [r for r in reply if isinstance(r, str)]

    def scan(self, cursor: str = "0", match: Optional[str] = None,
             count: Optional[int] = None) -> "Tuple[str, List[str]]":
        """One SCAN step: ``SCAN cursor [MATCH pat] [COUNT n]`` →
        ``(next_cursor, keys)``.  The cursor is treated as an OPAQUE
        string round-tripped verbatim (real Redis hands back decimal
        bucket cursors, MiniRedis hands back the last key) — "0" starts
        and terminates the iteration in both."""
        args: List[Union[str, bytes, int]] = ["SCAN", cursor]
        if match is not None:
            args += ["MATCH", match]
        if count is not None:
            args += ["COUNT", int(count)]
        reply = self.command(*args)
        assert isinstance(reply, list) and len(reply) == 2, reply
        nxt, batch = reply
        assert isinstance(nxt, str)
        if batch is None:
            batch = []
        assert isinstance(batch, list)
        return nxt, [k for k in batch if isinstance(k, str)]

    def ping(self) -> bool:
        return self.command("PING") == "PONG"
