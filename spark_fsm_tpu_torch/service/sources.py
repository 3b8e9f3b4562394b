"""Sequence sources — the reference's pluggable L1/L2 data layer.

The reference builds ``RDD[(Int, String)]`` sequence databases from
Elasticsearch, JDBC, flat files, and Piwik (SURVEY.md sec 1 L1, sec 2
"Sequence sources"); the rebuild keeps the same selection contract
(``source`` request param) and SPMF line format but returns an in-memory
``SequenceDB`` — device sharding happens downstream in the engines, which
is this framework's analog of Spark partitioning (SURVEY.md sec 2.2).

Registered sources:
  FILE     — SPMF-format text file (``path`` param).
  INLINE   — SPMF text embedded in the request (``data`` param's
             ``sequences`` key); handy for tests and small jobs.
  TRACKED  — events previously ingested via /track for a topic, grouped
             into per-(site,user) sequences ordered by timestamp: the
             reference's track->mine loop without an external store.
  SYNTH    — seeded synthetic DB (no-egress stand-in for the public
             benchmark datasets; see data/synth.py).
  JDBC     — SQL database via stdlib sqlite3 (``db``/``url`` + ``query``
             or ``table``), with the same field-role mapping as TRACKED.
  ELASTIC  — Elasticsearch search/scroll HTTP API (``url`` + ``index``),
             hit ``_source`` fields role-mapped like TRACKED/JDBC.
  PIWIK    — Piwik analytics DB export (sqlite): the ecommerce item log
             grouped into per-visitor purchase sequences.

Port: a copy of ``spark_fsm_tpu/service/sources.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Tuple

from spark_fsm_tpu_torch.data.spmf import SequenceDB, load_spmf, parse_spmf
from spark_fsm_tpu_torch.service.model import ServiceRequest
from spark_fsm_tpu_torch.service.store import ResultStore


class SourceError(ValueError):
    pass


def file_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    path = req.param("path")
    if not path:
        raise SourceError("FILE source needs a 'path' parameter")
    return load_spmf(path)


def inline_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    text = req.param("sequences")
    if text is None:
        raise SourceError("INLINE source needs a 'sequences' parameter")
    return parse_spmf(text)


ROLES = ("site", "user", "timestamp", "group", "item")


def field_map(store: ResultStore, topic: str) -> Dict[str, str]:
    """role -> event-field-name mapping for a topic.

    The reference's register step exists precisely to map *arbitrary*
    source fields onto the site/user/timestamp/group/item roles (SURVEY.md
    sec 2 "Registrar / field spec", sec 3.4).  A registered spec for the
    topic (``/register``, stored as ``fsm:fields:<topic>``) supplies the
    mapping; unregistered roles default to their own name.
    """
    mapping = {r: r for r in ROLES}
    spec_json = store.fields(topic)
    if spec_json:
        try:
            spec = json.loads(spec_json)
        except ValueError:
            spec = {}
        for role in ROLES:
            name = spec.get(role)
            if isinstance(name, str) and name:
                mapping[role] = name
    return mapping


def events_to_db(events: List[dict], fm: Dict[str, str],
                 origin: str) -> SequenceDB:
    """Group role-mapped events into an SPMF sequence database.

    Shared by the TRACKED and JDBC sources: sequence key = (site, user);
    each distinct group id forms ONE itemset (even if its rows interleave
    in time with other groups), and itemsets are ordered by the group's
    first timestamp — the reference's field-spec semantics (SURVEY.md
    sec 2 "Registrar / field spec").
    """
    # group key = (tag, id): tag 0 for numeric ids, 1 for string ids, so
    # mixed id types keep one deterministic sort order
    sessions: Dict[Tuple[str, str], Dict[tuple, List[Tuple[int, int]]]] = {}
    for ev in events:
        key = (str(ev.get(fm["site"], "")), str(ev.get(fm["user"], "")))
        ts_raw = ev.get(fm["timestamp"])
        ts = int(ts_raw) if ts_raw not in (None, "") else 0
        g_raw = ev.get(fm["group"])
        # group ids may be arbitrary strings (e.g. Piwik order ids like
        # 'ORD-1001'); the tagged tuple keeps numeric and string ids in
        # one deterministic sort order for the first-timestamp tiebreak
        if g_raw in (None, ""):
            group = (0, ts)
        else:
            try:
                group = (0, int(g_raw))
            except (TypeError, ValueError):
                group = (1, str(g_raw))
        if fm["item"] not in ev or ev[fm["item"]] is None:
            # spec registered/changed after this event was recorded
            raise SourceError(
                f"{origin} event has no field {fm['item']!r} (the "
                f"registered 'item' role); event keys: {sorted(ev)} — "
                f"fix the /register spec or the source data")
        item = int(ev[fm["item"]])
        sessions.setdefault(key, {}).setdefault(group, []).append((ts, item))
    db: SequenceDB = []
    for key in sorted(sessions):
        groups = sessions[key]
        # itemset order = (first timestamp of the group, group id)
        order = sorted(groups, key=lambda g: (min(ts for ts, _ in groups[g]), g))
        itemsets = [tuple(sorted({item for _, item in groups[g]}))
                    for g in order]
        if itemsets:
            db.append(tuple(itemsets))
    return db


def tracked_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    """Events ingested via /track, grouped per the topic's field spec."""
    topic = req.param("topic", "item")
    events = store.tracked(topic)
    if not events:
        raise SourceError(f"no tracked events for topic {topic!r}")
    fm = field_map(store, topic)
    return events_to_db([json.loads(e) for e in events], fm,
                        origin=f"tracked topic {topic!r}")


def _sqlite_path(req: ServiceRequest, source_name: str) -> str:
    """Resolve the ``db``/``url`` params both sqlite-backed sources share."""
    url = req.param("url")
    path = req.param("db")
    if url:
        if not url.startswith("sqlite:///"):
            raise SourceError(
                f"{source_name} url {url!r} unsupported: this build speaks "
                f"sqlite:///path (no network egress for remote databases)")
        path = url[len("sqlite:///"):]
    if not path:
        raise SourceError(f"{source_name} source needs a 'db' (sqlite file "
                          f"path) or 'url' (sqlite:///path) parameter")
    return path


def jdbc_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    """SQL database source — the reference's JdbcSource seam, implemented
    on stdlib sqlite3 (a SQL database that needs no server).

    Params: ``db`` = sqlite file path (or ``url`` = ``sqlite:///path``),
    plus ``query`` (SQL whose result columns carry the role fields) or
    ``table`` (SELECT * FROM table).  Column-name -> role mapping comes
    from the topic's registered field spec, exactly like TRACKED.
    """
    path = _sqlite_path(req, "JDBC")
    query = req.param("query")
    table = req.param("table")
    if query is None:
        if not table:
            raise SourceError("JDBC source needs a 'query' or 'table' "
                              "parameter")
        if not table.replace("_", "").isalnum():
            raise SourceError(f"invalid table name {table!r}")
        query = f"SELECT * FROM {table}"
    events = _sqlite_events(path, query, ())
    if not events:
        raise SourceError(f"JDBC query returned no rows: {query!r}")
    fm = field_map(store, req.param("topic", "item"))
    return events_to_db(events, fm, origin="JDBC row")


def _sqlite_events(path: str, query: str, params: tuple) -> List[dict]:
    """Run one SQL query read-only; rows as column-name dicts."""
    import sqlite3

    try:
        # open read-only so a typo'd path errors instead of creating a db;
        # percent-encode the path so '?', '#', '%' in filenames survive the
        # URI parse
        from urllib.parse import quote
        conn = sqlite3.connect(f"file:{quote(path)}?mode=ro", uri=True)
    except sqlite3.OperationalError as exc:
        raise SourceError(f"cannot open sqlite db {path!r}: {exc}") from exc
    try:
        cur = conn.execute(query, params)
        if cur.description is None:  # empty/comment-only/non-SELECT query
            raise SourceError(f"query returned no result set: {query!r}")
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]
    except sqlite3.Error as exc:
        raise SourceError(f"query failed: {exc}") from exc
    finally:
        conn.close()


def elastic_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    """Elasticsearch source — the reference's ElasticSource seam, speaking
    the real search/scroll HTTP API via stdlib urllib.

    Params: ``url`` = ``http(s)://host:port``, ``index``; optional
    ``query`` (JSON ES query object; default match_all) and ``page_size``
    (scroll page, default 1000).  Hit ``_source`` fields map onto the
    site/user/timestamp/group/item roles via the topic's registered field
    spec, exactly like TRACKED/JDBC.  Protocol-tested against an
    in-process mini-ES (tests/test_elastic_piwik_sources.py); the same
    bytes reach a production cluster.
    """
    import urllib.error
    import urllib.request

    url = (req.param("url") or "").rstrip("/")
    index = req.param("index")
    if not url.startswith(("http://", "https://")) or not index:
        raise SourceError("ELASTIC source needs 'url' (http(s)://host:port) "
                          "and 'index' parameters")
    if "/" in index or index.startswith(("_", "-")):
        raise SourceError(f"invalid index name {index!r}")
    try:
        page_size = int(req.param("page_size", "1000"))
        es_query = json.loads(req.param("query") or '{"match_all": {}}')
    except ValueError as exc:
        raise SourceError(f"bad ELASTIC parameter: {exc}") from exc

    def post_json(endpoint: str, obj: dict) -> dict:
        request = urllib.request.Request(
            endpoint, data=json.dumps(obj).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(request, timeout=30) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise SourceError(f"Elasticsearch request to {endpoint} "
                              f"failed: {exc}") from exc

    events: List[dict] = []
    scroll_id = None
    try:
        page = post_json(f"{url}/{index}/_search?scroll=1m",
                         {"size": page_size, "query": es_query})
        while True:
            # capture the scroll id FIRST: even a zero-hit search opened a
            # server-side scroll context that the finally must free
            scroll_id = page.get("_scroll_id", scroll_id)
            hits = page["hits"]["hits"]
            if not hits:
                break  # ES's documented scroll termination: an EMPTY page
            # (a short page is NOT the end — multi-shard scrolls may
            # legitimately return fewer than `size` hits mid-scroll)
            events.extend(h["_source"] for h in hits)
            if page.get("_scroll_id") is None:
                break
            page = post_json(f"{url}/_search/scroll",
                             {"scroll": "1m", "scroll_id": scroll_id})
    except (KeyError, TypeError) as exc:
        raise SourceError(
            f"malformed Elasticsearch response (missing {exc})") from exc
    finally:
        if scroll_id is not None:
            # free the scroll context (clusters cap open scrolls at ~500);
            # best-effort — the 1m keepalive reaps it anyway
            request = urllib.request.Request(
                f"{url}/_search/scroll", method="DELETE",
                data=json.dumps({"scroll_id": scroll_id}).encode("utf-8"),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(request, timeout=10).close()
            except (urllib.error.URLError, OSError):
                pass
    if not events:
        raise SourceError(f"Elasticsearch query matched no documents in "
                          f"index {index!r}")
    fm = field_map(store, req.param("topic", "item"))
    return events_to_db(events, fm, origin="Elasticsearch hit")


def piwik_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    """Piwik analytics source — the reference's PiwikSource seam.

    Reads the ecommerce item log (``piwik_log_conversion_item``: one row
    per purchased item) the way the reference mines Piwik commerce data:
    site = idsite, user = idvisitor, timestamp = server_time, itemset
    group = idorder, item = idaction_sku.  Params: ``db``/``url`` =
    sqlite path of the (exported) Piwik database, optional ``idsite``
    filter.  server_time may be a DATETIME string or an epoch integer.
    """
    path = _sqlite_path(req, "PIWIK")
    idsite = req.param("idsite")
    # DATETIME strings go through strftime('%s', ...); numeric values are
    # epochs and pass through directly.  The typeof() dispatch matters:
    # strftime on an INTEGER would interpret it as a Julian day number
    # (strftime('%s', 2000000) = -38066760000, not NULL), so a COALESCE
    # fallback would silently mis-order mixed-type columns.
    query = (
        "SELECT idsite AS site, idvisitor AS user, "
        "CASE WHEN typeof(server_time) = 'text' "
        # text: DATETIME via strftime; COALESCE keeps TEXT-affinity numeric
        # epochs (e.g. a CSV import) instead of collapsing them to NULL
        "THEN COALESCE(CAST(strftime('%s', server_time) AS INTEGER), "
        "CAST(server_time AS INTEGER)) "
        "ELSE CAST(server_time AS INTEGER) END AS timestamp, "
        'idorder AS "group", idaction_sku AS item '
        "FROM piwik_log_conversion_item")
    params: tuple = ()
    if idsite is not None:
        query += " WHERE idsite = ?"
        try:
            params = (int(idsite),)
        except ValueError as exc:
            raise SourceError(f"bad idsite {idsite!r}: {exc}") from exc
    events = _sqlite_events(path, query, params)
    if not events:
        raise SourceError("no Piwik conversion items"
                          + (f" for idsite {idsite}" if idsite else ""))
    # roles are fixed by the Piwik schema (aliased above) — no field spec
    return events_to_db(events, {r: r for r in ROLES}, origin="Piwik row")


def synth_source(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    from spark_fsm_tpu_torch.data import synth

    name = req.param("dataset", "bms_webview1")
    scale = float(req.param("scale", "0.01"))
    gen = getattr(synth, f"{name}_like", None)
    if gen is None:
        raise SourceError(f"unknown synthetic dataset {name!r}")
    return gen(scale=scale)


SOURCES: Dict[str, Callable[[ServiceRequest, ResultStore], SequenceDB]] = {
    "FILE": file_source,
    "INLINE": inline_source,
    "TRACKED": tracked_source,
    "SYNTH": synth_source,
    "ELASTIC": elastic_source,
    "JDBC": jdbc_source,
    "PIWIK": piwik_source,
}


def register(name: str,
             fn: Callable[[ServiceRequest, ResultStore], SequenceDB]) -> None:
    SOURCES[name.upper()] = fn


def get_db(req: ServiceRequest, store: ResultStore) -> SequenceDB:
    name = (req.param("source") or "FILE").upper()
    if name not in SOURCES:
        raise SourceError(f"unknown source {name!r}")
    return SOURCES[name](req, store)
