"""Partition-chaos TCP proxy — the storm harness's network fault plane.

A fault-site guard (utils/faults) can make one CALL fail, but a store
outage is a property of the WIRE: half-open connections, black holes
that swallow bytes without closing, latency cliffs, mid-stream resets,
and per-replica asymmetry (replica A partitioned from the store while
B still talks to it).  :class:`NetProxy` sits between one client
(e.g. a service replica) and one upstream (e.g. MiniRedis/Redis) and
injects exactly those, per proxy — so the storm harness
(scripts/storm_smoke.py) gives each replica ITS OWN proxy and
partitions them asymmetrically by flipping modes per instance.

Modes (thread-safe, effective immediately, composable):

- ``blackhole(True)``: bytes in either direction are silently
  swallowed (held connections stay open — the client's recv just
  never returns data: the classic half-open partition).  New
  connections are accepted and equally black-holed.
- ``delay(seconds)``: every forwarded chunk waits first (latency
  injection; 0 restores).
- ``refuse(True)``: new connections are accepted and immediately
  closed (the connection-refused-ish fast failure), existing ones
  keep flowing.
- ``reset_all()``: hard-close every live connection NOW (mid-stream
  reset); the proxy keeps listening.
- ``heal()``: clear blackhole/delay/refuse.

Counters (``stats()``) record connections, forwarded bytes per
direction, swallowed bytes, and resets — the harness prints them next
to the invariant report.

Stdlib sockets + threads only; no external packages.

Port: a copy of ``spark_fsm_tpu/utils/netproxy.py``; it does no device
work, so nothing in it changed.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Tuple


class _Pipe(threading.Thread):
    """One direction of one proxied connection."""

    def __init__(self, proxy: "NetProxy", src: socket.socket,
                 dst: socket.socket, direction: str):
        super().__init__(daemon=True,
                         name=f"netproxy-{proxy.port}-{direction}")
        self.proxy = proxy
        self.src = src
        self.dst = dst
        self.direction = direction  # "up" (client->upstream) | "down"

    def run(self) -> None:
        try:
            while True:
                try:
                    chunk = self.src.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                p = self.proxy
                if p._blackhole:
                    # swallow silently; keep reading so the sender's
                    # buffers drain and the hole looks bottomless
                    with p._lock:
                        p._stats["swallowed_bytes"] += len(chunk)
                    continue
                if p._delay_s > 0:
                    time.sleep(p._delay_s)
                    if p._blackhole:  # flipped during the sleep
                        with p._lock:
                            p._stats["swallowed_bytes"] += len(chunk)
                        continue
                try:
                    self.dst.sendall(chunk)
                except OSError:
                    break
                with p._lock:
                    p._stats[f"bytes_{self.direction}"] += len(chunk)
        finally:
            # one side closing tears both down (half-closed TCP is not
            # part of the RESP conversation this proxy exists for)
            for s in (self.src, self.dst):
                try:
                    s.close()
                except OSError:
                    pass


class NetProxy:
    """TCP proxy to ``(upstream_host, upstream_port)`` listening on an
    ephemeral loopback port (``.port``)."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1") -> None:
        self.upstream = (upstream_host, int(upstream_port))
        self._blackhole = False
        self._delay_s = 0.0
        self._refuse = False
        self._closed = False
        self._lock = threading.Lock()
        self._conns: List[Tuple[socket.socket, socket.socket]] = []
        self._stats: Dict[str, int] = {
            "connections": 0, "refused": 0, "resets": 0,
            "bytes_up": 0, "bytes_down": 0, "swallowed_bytes": 0}
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True,
                         name=f"netproxy-{self.port}-accept").start()

    # ------------------------------------------------------------- server

    def _accept(self) -> None:
        while True:
            try:
                client, _ = self._srv.accept()
            except OSError:
                return  # closed
            if self._refuse or self._closed:
                with self._lock:
                    self._stats["refused"] += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                with self._lock:
                    self._stats["refused"] += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._lock:
                self._stats["connections"] += 1
                self._conns.append((client, up))
                # prune dead pairs so a long storm doesn't hoard fds
                self._conns = [(c, u) for c, u in self._conns
                               if c.fileno() != -1]
            _Pipe(self, client, up, "up").start()
            _Pipe(self, up, client, "down").start()

    # -------------------------------------------------------------- modes

    def blackhole(self, on: bool = True) -> None:
        self._blackhole = bool(on)

    def delay(self, seconds: float) -> None:
        self._delay_s = max(0.0, float(seconds))

    def refuse(self, on: bool = True) -> None:
        self._refuse = bool(on)

    def reset_all(self) -> int:
        """Hard-close every live proxied connection; returns how many
        pairs were torn down.  The listener stays up."""
        with self._lock:
            conns, self._conns = self._conns, []
        n = 0
        for client, up in conns:
            alive = client.fileno() != -1 or up.fileno() != -1
            for s in (client, up):
                try:
                    s.close()
                except OSError:
                    pass
            n += 1 if alive else 0
        with self._lock:
            self._stats["resets"] += n
        return n

    def heal(self) -> None:
        """Clear every injected mode (live connections that died under
        blackhole/reset stay dead — clients reconnect through the now-
        clean proxy, exactly like a healed network)."""
        self._blackhole = False
        self._delay_s = 0.0
        self._refuse = False

    @property
    def modes(self) -> Dict[str, object]:
        return {"blackhole": self._blackhole, "delay_s": self._delay_s,
                "refuse": self._refuse}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        self.reset_all()
