"""An in-process RESP2 server for the port's replicated-service tests and
``chip_smoke.py``'s phase 26: the production store speaks Redis on the wire
(``spark_fsm_tpu_torch/service/resp.py``), and no Redis server runs beside
the tests or on the card's host.

``MiniRedis`` is a copy of the class in ``tests/test_redis_store.py``
(the reference's store tests), and ``SnoopingMiniRedis`` a copy of the
lease-snooping subclass ``scripts/storm_smoke.py`` builds.  This module
imports nothing of ``jax`` or ``spark_fsm_tpu``, so the card's host, which
has neither, can run it."""

import json
import socket
import threading


class MiniRedis:
    """RESP2 server on a loopback socket implementing the command subset
    the store uses: SET[ PX ms][ NX]/GET/RPUSH/LRANGE/LPOP/LLEN/LTRIM/
    DEL/INCR/KEYS/SCAN/PEXPIRE/PTTL/TTL/PING.

    Key expiry (the lease layer's substrate) runs on ``self.clock``
    (default ``time.monotonic``) with Redis-style lazy purge, so lease
    tests can drive a virtual clock instead of sleeping out TTLs."""

    def __init__(self, clock=None):
        self.kv = {}
        self.lists = {}
        self.expiry = {}  # key -> clock() deadline
        self.clock = clock if clock is not None else \
            __import__("time").monotonic
        self.lock = threading.Lock()
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        self.commands_seen = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        buf = b""

        def read_line():
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    raise ConnectionError
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            return line

        def read_exact(n):
            nonlocal buf
            while len(buf) < n + 2:
                chunk = conn.recv(65536)
                if not chunk:
                    raise ConnectionError
                buf += chunk
            payload, buf = buf[:n], buf[n + 2:]
            return payload

        try:
            while True:
                line = read_line()
                assert line[:1] == b"*", line
                nargs = int(line[1:])
                args = []
                for _ in range(nargs):
                    hdr = read_line()
                    assert hdr[:1] == b"$", hdr
                    args.append(read_exact(int(hdr[1:])).decode())
                conn.sendall(self._dispatch(args))
        except (ConnectionError, OSError):
            conn.close()

    def _alive(self, key):
        """Lazy expiry purge (callers hold the lock)."""
        deadline = self.expiry.get(key)
        if deadline is not None and self.clock() >= deadline:
            self.expiry.pop(key, None)
            self.kv.pop(key, None)
            self.lists.pop(key, None)
            return False
        return key in self.kv or key in self.lists

    def _dispatch(self, args):
        cmd, rest = args[0].upper(), args[1:]
        self.commands_seen.append(cmd)
        with self.lock:
            if cmd == "PING":
                return b"+PONG\r\n"
            if cmd == "SET":
                px, nx = None, False
                opts = [o.upper() for o in rest[2:]]
                i = 0
                while i < len(opts):
                    if opts[i] == "PX":
                        px = int(rest[3 + i])
                        i += 2
                    elif opts[i] == "NX":
                        nx = True
                        i += 1
                    else:
                        return b"-ERR syntax error\r\n"
                if nx and self._alive(rest[0]):
                    return b"$-1\r\n"  # NX refused: Null reply
                self.kv[rest[0]] = rest[1]
                if px is not None:
                    self.expiry[rest[0]] = self.clock() + px / 1000.0
                else:
                    self.expiry.pop(rest[0], None)  # plain SET clears TTL
                return b"+OK\r\n"
            if cmd == "GET":
                self._alive(rest[0])
                v = self.kv.get(rest[0])
                if v is None:
                    return b"$-1\r\n"
                vb = v.encode()
                return b"$%d\r\n%s\r\n" % (len(vb), vb)
            if cmd == "PEXPIRE":
                if not self._alive(rest[0]):
                    return b":0\r\n"
                self.expiry[rest[0]] = self.clock() + int(rest[1]) / 1000.0
                return b":1\r\n"
            if cmd in ("PTTL", "TTL"):
                if not self._alive(rest[0]):
                    return b":-2\r\n"
                deadline = self.expiry.get(rest[0])
                if deadline is None:
                    return b":-1\r\n"
                left = max(0.0, deadline - self.clock())
                return b":%d\r\n" % int(left * 1000 if cmd == "PTTL"
                                        else round(left))
            if cmd == "RPUSH":
                lst = self.lists.setdefault(rest[0], [])
                lst.extend(rest[1:])
                return b":%d\r\n" % len(lst)
            if cmd == "LRANGE":
                lst = self.lists.get(rest[0], [])
                start, stop = int(rest[1]), int(rest[2])
                stop = len(lst) if stop == -1 else stop + 1
                out = [b"*%d\r\n" % len(lst[start:stop])]
                for v in lst[start:stop]:
                    vb = v.encode()
                    out.append(b"$%d\r\n%s\r\n" % (len(vb), vb))
                return b"".join(out)
            if cmd == "LPOP":
                lst = self.lists.get(rest[0], [])
                if not lst:
                    return b"$-1\r\n"
                vb = lst.pop(0).encode()
                return b"$%d\r\n%s\r\n" % (len(vb), vb)
            if cmd == "LLEN":
                return b":%d\r\n" % len(self.lists.get(rest[0], []))
            if cmd == "LTRIM":
                lst = self.lists.get(rest[0])
                if lst is not None:
                    start, stop = int(rest[1]), int(rest[2])
                    stop = len(lst) if stop == -1 else stop + 1
                    self.lists[rest[0]] = lst[start:stop]
                return b"+OK\r\n"
            if cmd == "DEL":
                n = 0
                for k in rest:
                    alive = self._alive(k)
                    self.expiry.pop(k, None)
                    n += ((self.kv.pop(k, None) is not None) +
                          (self.lists.pop(k, None) is not None)) if alive \
                        else 0
                return b":%d\r\n" % n
            if cmd == "INCR":
                self._alive(rest[0])
                v = int(self.kv.get(rest[0], "0")) + 1
                self.kv[rest[0]] = str(v)
                return b":%d\r\n" % v
            if cmd == "KEYS":
                # prefix globs only — all the store's journal/lease
                # scans need
                assert rest[0].endswith("*"), rest
                pre = rest[0][:-1]
                ks = sorted(k for k in list(self.kv) + list(self.lists)
                            if k.startswith(pre) and self._alive(k))
                out = [b"*%d\r\n" % len(ks)]
                for k in ks:
                    kb = k.encode()
                    out.append(b"$%d\r\n%s\r\n" % (len(kb), kb))
                return b"".join(out)
            if cmd == "SCAN":
                # cursor iteration: the cursor is OPAQUE to clients
                # (real Redis returns decimal bucket cursors; here it is
                # the last key of the previous batch — "0" starts AND
                # terminates in both, which is all RespClient.scan
                # relies on).  Keys alive for the whole iteration are
                # returned exactly once.
                cursor, match, count = rest[0], None, 10
                i = 1
                while i < len(rest):
                    opt = rest[i].upper()
                    if opt == "MATCH":
                        match = rest[i + 1]
                        i += 2
                    elif opt == "COUNT":
                        count = int(rest[i + 1])
                        i += 2
                    else:
                        return b"-ERR syntax error\r\n"
                pre = ""
                if match is not None:
                    assert match.endswith("*"), match  # prefix globs only
                    pre = match[:-1]
                ks = sorted(k for k in list(self.kv) + list(self.lists)
                            if k.startswith(pre) and self._alive(k))
                if cursor != "0":
                    import bisect
                    ks = ks[bisect.bisect_right(ks, cursor):]
                batch = ks[:max(1, count)]
                nxt = "0" if len(ks) <= len(batch) else batch[-1]
                nb = nxt.encode()
                out = [b"*2\r\n", b"$%d\r\n%s\r\n" % (len(nb), nb),
                       b"*%d\r\n" % len(batch)]
                for k in batch:
                    kb = k.encode()
                    out.append(b"$%d\r\n%s\r\n" % (len(kb), kb))
                return b"".join(out)
            return b"-ERR unknown command '%s'\r\n" % cmd.encode()

    def close(self):
        self.srv.close()


class SnoopingMiniRedis(MiniRedis):
    """MiniRedis recording every ``fsm:lease:*`` SET as (uid, token,
    replica): the evidence stream of the lease-token monotonicity
    invariant (tokens never decrease per uid; a token is reused only by
    the replica that held it)."""

    def __init__(self, clock=None):
        super().__init__(clock=clock)
        self.lease_sets = []  # (uid, token, replica)

    def _dispatch(self, args):
        cmd = args[0].upper()
        if cmd == "SET" and args[1].startswith("fsm:lease:") \
                and args[1] != "fsm:lease:token":
            try:
                rec = json.loads(args[2])
                self.lease_sets.append(
                    (args[1][len("fsm:lease:"):],
                     int(rec.get("token", -1)),
                     str(rec.get("replica", "?"))))
            except (ValueError, TypeError):
                pass
        return super()._dispatch(args)
