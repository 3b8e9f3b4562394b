"""An in-process Elasticsearch stand-in and the writers of a sequence
database as the service's source rows, for ``tests/test_torch_sources.py``
on the CPU and ``chip_smoke.py``'s phase 30 on the card.

``MiniES`` is a copy of the class in ``tests/test_elastic_piwik_sources.py``
(the reference's source tests): the search/scroll HTTP API over a
class-level document list.  ``serve()`` runs it on a loopback port.  The
writers lay a database out as the ELASTIC, JDBC (sqlite) and PIWIK sources
read it back: one event a (sequence, itemset, item), the user a zero-padded
sequence index and the group and timestamp the itemset's index, so the
source rebuilds the same sequences in the same order.  This module imports
nothing of ``jax`` or ``spark_fsm_tpu``, so the card's host, which has
neither, can run it."""

import contextlib
import json
import sqlite3
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MiniES(BaseHTTPRequestHandler):
    """Two-page scroll over a class-level document list."""

    docs: list = []
    page_size_seen: list = []
    scrolls: dict = {}
    short_pages: bool = False

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length") or 0)) or b"{}")
        if self.path.startswith("/_search/scroll"):
            sid = body["scroll_id"]
            offset = MiniES.scrolls.get(sid)
            if offset is None:
                self._send(404, {"error": "no such scroll"})
                return
            size = MiniES.scrolls["size"]
            if MiniES.short_pages:  # multi-shard behavior: short non-final
                size = 1            # pages mid-scroll
            hits = MiniES.docs[offset:offset + size]
            MiniES.scrolls[sid] = offset + len(hits)
            self._send(200, {"_scroll_id": sid,
                             "hits": {"hits": [{"_source": d} for d in hits]}})
            return
        # /{index}/_search?scroll=1m
        size = int(body.get("size", 10))
        MiniES.page_size_seen.append(size)
        MiniES.scrolls = {"s1": size, "size": size}
        hits = MiniES.docs[:size]
        MiniES.scrolls["s1"] = len(hits)
        self._send(200, {"_scroll_id": "s1",
                         "hits": {"hits": [{"_source": d} for d in hits]}})

    def _send(self, code, obj):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@contextlib.contextmanager
def serve():
    """MiniES on a loopback port; yields its base URL."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), MiniES)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()


def events(db):
    """(site, user, timestamp, group, item) a (sequence, itemset, item)."""
    width = len(str(max(len(db) - 1, 0)))
    for s, seq in enumerate(db):
        user = f"u{s:0{width}d}"
        for j, itemset in enumerate(seq):
            for item in itemset:
                yield ("s", user, j, j, int(item))


def es_docs(db):
    """The database as ELASTIC documents (default role names)."""
    return [{"site": site, "user": user, "timestamp": ts, "group": grp,
             "item": item} for site, user, ts, grp, item in events(db)]


def write_clicks(path, db):
    """The database as a sqlite ``clicks`` table whose group column is
    ``grp`` (a field spec maps it onto the ``group`` role)."""
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE clicks (site, user, timestamp, grp, item)")
    conn.executemany("INSERT INTO clicks VALUES (?,?,?,?,?)", events(db))
    conn.commit()
    conn.close()


def write_piwik(path, db, idsite=1):
    """The database as a Piwik ecommerce export: one
    ``piwik_log_conversion_item`` row a purchased item, epoch times."""
    conn = sqlite3.connect(path)
    conn.execute("""CREATE TABLE piwik_log_conversion_item (
        idsite INTEGER, idvisitor TEXT, server_time INTEGER,
        idorder INTEGER, idaction_sku INTEGER)""")
    conn.executemany(
        "INSERT INTO piwik_log_conversion_item VALUES (?,?,?,?,?)",
        ((idsite, user, ts, grp, item)
         for _, user, ts, grp, item in events(db)))
    conn.commit()
    conn.close()
