"""The ELASTIC, PIWIK and JDBC (SQL) sources on the port
(``spark_fsm_tpu_torch/service/sources.py``), against the reference's
``tests/test_elastic_piwik_sources.py`` and ``tests/test_sql_source.py``.

Each test of the two reference files is one test here, parametrised over
the two packages (``_torch_cluster_rig.PKGS``): the same rows and
documents go to each package's source, and the record (the
``SequenceDB`` each builds, the ``SourceError`` texts with the scratch
directory spelled ``<tmp>``) must be equal.  The Elasticsearch stand-in is
``tests/_torch_minies.py``'s copy of ``MiniES``.  Four more cases lay one
seeded database out as a SQL table, as a SQL query's rows, as a Piwik
export and as Elasticsearch documents, and train ``SPADE_TPU`` on it
through each package's Master (the port's engines on the CPU): the
stored bodies must be equal by SHA-256, and equal to the copied oracle.
"""

import hashlib
import json
import os
import shutil
import sqlite3
import tempfile

import pytest

import _torch_minies as ES
from _torch_cluster_rig import (NAMES, PKGS, PortOnCpu, Twins, assert_covers,
                                await_terminal, text_of)
from _torch_minies import MiniES

T = Twins(PKGS)
_URL = []


@pytest.fixture(scope="module", autouse=True)
def _mini_es():
    with ES.serve() as url:
        _URL.append(url)
        yield
        _URL.clear()


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


def test_covers_the_reference():
    assert_covers(globals(), "test_elastic_piwik_sources.py",
                  "test_sql_source.py")


class _Scratch:
    """A scratch directory for one scenario; records spell it ``<tmp>``."""

    def __enter__(self):
        self.path = tempfile.mkdtemp(prefix="torch_sources_")
        return self

    def __exit__(self, *exc):
        shutil.rmtree(self.path, ignore_errors=True)

    def __truediv__(self, name):
        return os.path.join(self.path, name)

    def clean(self, text):
        return text.replace(self.path, "<tmp>")


def _treq(P, **data):
    return P.model.ServiceRequest("fsm", "train",
                                  {k: str(v) for k, v in data.items()})


def _errors(P, tmp, calls):
    """The SourceError text of each call (each must raise one)."""
    out = []
    for fn, data, match in calls:
        with pytest.raises(P.sources.SourceError, match=match) as exc:
            fn(_treq(P, **data), P.store.ResultStore())
        out.append(tmp.clean(str(exc.value)) if tmp else str(exc.value))
    return out


# ------------------------------------------------------------ Elasticsearch


def _elastic_scroll(P):
    MiniES.docs = [
        {"shop": "s", "visitor": "u1", "ts": 1, "basket": 1, "sku": 3},
        {"shop": "s", "visitor": "u1", "ts": 2, "basket": 2, "sku": 5},
        {"shop": "s", "visitor": "u2", "ts": 1, "basket": 3, "sku": 3},
        {"shop": "s", "visitor": "u2", "ts": 2, "basket": 4, "sku": 5},
        {"shop": "s", "visitor": "u2", "ts": 2, "basket": 4, "sku": 7},
    ]
    MiniES.page_size_seen = []
    store = P.store.ResultStore()
    store.add_fields("clicks", json.dumps({
        "site": "shop", "user": "visitor", "timestamp": "ts",
        "group": "basket", "item": "sku"}))
    db = P.sources.elastic_source(_treq(
        P, url=_URL[0], index="events", topic="clicks", page_size=2), store)
    rec = {"pages": MiniES.page_size_seen, "db": db}
    assert rec == {"pages": [2], "db": [((3,), (5,)), ((3,), (5, 7))]}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_elastic_scroll_and_field_spec(pkg):
    T.held(pkg, _elastic_scroll)


def _elastic_short_pages(P):
    MiniES.docs = [{"site": "s", "user": "u", "timestamp": t, "group": t,
                    "item": t + 1} for t in range(5)]
    MiniES.short_pages = True
    try:
        db = P.sources.elastic_source(_treq(
            P, url=_URL[0], index="events", page_size=2),
            P.store.ResultStore())
    finally:
        MiniES.short_pages = False
    assert db == [((1,), (2,), (3,), (4,), (5,))]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_elastic_short_scroll_pages_not_truncated(pkg):
    T.held(pkg, _elastic_short_pages)


def _elastic_errors(P):
    src = P.sources.elastic_source
    calls = [(src, {"index": "x"}, "needs 'url'"),
             (src, {"url": _URL[0], "index": "a/b"}, "invalid index")]
    out = _errors(P, None, calls)
    MiniES.docs = []
    out += _errors(P, None, [
        (src, {"url": _URL[0], "index": "events"}, "matched no documents"),
        (src, {"url": "http://127.0.0.1:1", "index": "events"}, "failed")])
    return {"errors": out}


@pytest.mark.parametrize("pkg", NAMES)
def test_elastic_errors(pkg):
    T.held(pkg, _elastic_errors)


# ------------------------------------------------------------------ Piwik


def _piwik_table(path, rows, time_type="TEXT", order_type="INTEGER"):
    conn = sqlite3.connect(path)
    conn.execute(f"""CREATE TABLE piwik_log_conversion_item (
        idsite INTEGER, idvisitor TEXT, server_time {time_type},
        idorder {order_type}, idaction_sku INTEGER)""")
    conn.executemany(
        "INSERT INTO piwik_log_conversion_item VALUES (?,?,?,?,?)", rows)
    conn.commit()
    conn.close()
    return path


def _piwik_purchases(P):
    with _Scratch() as tmp:
        path = _piwik_table(tmp / "piwik.sqlite", [
            (1, "A", "2024-01-01 10:00:00", 1, 3),
            (1, "A", "2024-01-02 10:00:00", 2, 5),
            (1, "B", "2024-01-01 11:00:00", 3, 3),
            (1, "B", "2024-01-01 11:00:00", 3, 7),
            (2, "C", "2024-01-01 12:00:00", 4, 9)])
        store = P.store.ResultStore()
        rec = {"site1": P.sources.piwik_source(
            _treq(P, db=path, idsite=1), store),
            "all": P.sources.piwik_source(_treq(P, db=path), store)}
    assert rec["site1"] == [((3,), (5,)), ((3, 7),)]
    assert ((9,),) in rec["all"] and len(rec["all"]) == 3
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_piwik_purchase_sequences(pkg):
    T.held(pkg, _piwik_purchases)


def _piwik_epochs(P):
    with _Scratch() as tmp:
        path = _piwik_table(tmp / "p2.sqlite", [(1, "A", 200, 2, 5),
                                                (1, "A", 100, 1, 3)],
                            time_type="INTEGER")
        db = P.sources.piwik_source(_treq(P, db=path), P.store.ResultStore())
    assert db == [((3,), (5,))]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_piwik_epoch_timestamps(pkg):
    T.held(pkg, _piwik_epochs)


def _piwik_mixed(P):
    with _Scratch() as tmp:
        path = _piwik_table(tmp / "p4.sqlite", [
            (1, "A", 2000000, 2, 5), (1, "A", "1970-01-01 00:00:01", 1, 3),
            (1, "A", "3000000", 3, 9)], time_type="")
        db = P.sources.piwik_source(_treq(P, db=path), P.store.ResultStore())
    assert db == [((3,), (5,), (9,))]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_piwik_mixed_timestamp_types(pkg):
    T.held(pkg, _piwik_mixed)


def _piwik_varchar(P):
    with _Scratch() as tmp:
        path = _piwik_table(tmp / "p3.sqlite", [
            (1, "A", "2024-01-01 10:00:00", "ORD-1001", 3),
            (1, "A", "2024-01-01 10:00:00", "ORD-1001", 7),
            (1, "A", "2024-01-02 10:00:00", "ORD-1002", 5)],
            order_type="TEXT")
        db = P.sources.piwik_source(_treq(P, db=path), P.store.ResultStore())
    assert db == [((3, 7), (5,))]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_piwik_varchar_order_ids(pkg):
    T.held(pkg, _piwik_varchar)


def _piwik_errors(P):
    src = P.sources.piwik_source
    with _Scratch() as tmp:
        errors = _errors(P, tmp, [
            (src, {}, "needs a 'db'"),
            (src, {"db": tmp / "nope.sqlite"}, "cannot open")])
    return {"errors": errors}


@pytest.mark.parametrize("pkg", NAMES)
def test_piwik_errors(pkg):
    T.held(pkg, _piwik_errors)


# -------------------------------------------------------------------- SQL


def _mkdb(path, rows, cols=("site", "user", "timestamp", "grp", "item")):
    conn = sqlite3.connect(path)
    conn.execute(f"CREATE TABLE clicks ({', '.join(cols)})")
    conn.executemany(
        f"INSERT INTO clicks VALUES ({', '.join('?' * len(cols))})", rows)
    conn.commit()
    conn.close()


def _sql_table(P):
    with _Scratch() as tmp:
        path = tmp / "clicks.db"
        _mkdb(path, [("s", "A", 100, 10, 1), ("s", "A", 105, 10, 3),
                     ("s", "A", 200, 20, 2), ("s", "B", 50, 7, 4)])
        store = P.store.ResultStore()
        store.add_fields("item", json.dumps({"group": "grp"}))
        db = P.sources.jdbc_source(_treq(P, db=path, table="clicks"), store)
    assert db == [((1, 3), (2,)), ((4,),)]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_table_with_registered_spec(pkg):
    T.held(pkg, _sql_table)


def _sql_query(P):
    with _Scratch() as tmp:
        path = tmp / "q.db"
        _mkdb(path, [("s", "A", 1, 1, 9), ("s", "A", 2, 2, 8)])
        store = P.store.ResultStore()
        store.add_fields("item", json.dumps({"group": "grp"}))
        db = P.sources.get_db(_treq(
            P, source="JDBC", url=f"sqlite:///{path}",
            query="SELECT * FROM clicks WHERE item > 8"), store)
    assert db == [((9,),)]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_query_and_url_form(pkg):
    T.held(pkg, _sql_query)


def _sql_alias(P):
    with _Scratch() as tmp:
        path = tmp / "alias.db"
        conn = sqlite3.connect(path)
        conn.execute("CREATE TABLE ev (host, visitor, at, batch, sku)")
        conn.executemany("INSERT INTO ev VALUES (?,?,?,?,?)", [
            ("h", "v1", 1, 1, 5), ("h", "v1", 2, 2, 6)])
        conn.commit()
        conn.close()
        db = P.sources.jdbc_source(_treq(
            P, db=path,
            query="SELECT host AS site, visitor AS user, at AS timestamp, "
                  "batch AS 'group', sku AS item FROM ev"),
            P.store.ResultStore())
    assert db == [((5,), (6,))]
    return {"db": db}


@pytest.mark.parametrize("pkg", NAMES)
def test_column_aliasing_in_query(pkg):
    T.held(pkg, _sql_alias)


def _sql_errors(P):
    src = P.sources.jdbc_source
    with _Scratch() as tmp:
        x = tmp / "x.db"
        errors = _errors(P, tmp, [
            (src, {"table": "clicks"}, "'db'"),
            (src, {"db": x}, "'query' or 'table'"),
            (src, {"db": x, "table": "a; DROP"}, "invalid table name"),
            (src, {"db": tmp / "missing.db", "table": "t"}, "cannot open"),
            (src, {"url": "postgres://h/d", "table": "t"}, "unsupported")])
        path = tmp / "empty.db"
        _mkdb(path, [])
        errors += _errors(P, tmp, [
            (src, {"db": path, "table": "clicks"}, "no rows"),
            (src, {"db": path, "query": "SELECT * FROM nope"},
             "query failed"),
            (src, {"db": path, "query": "-- nothing"}, "no result set")])
        created = os.path.exists(tmp / "missing.db")
    assert not created
    return {"errors": errors, "created": created}


@pytest.mark.parametrize("pkg", NAMES)
def test_errors(pkg):
    T.held(pkg, _sql_errors)


def _sql_no_item(P):
    with _Scratch() as tmp:
        path = tmp / "noitem.db"
        conn = sqlite3.connect(path)
        conn.execute("CREATE TABLE t (site, user, timestamp)")
        conn.execute("INSERT INTO t VALUES ('s', 'u', 1)")
        conn.commit()
        conn.close()
        errors = _errors(P, tmp, [(P.sources.jdbc_source,
                                   {"db": path, "table": "t"}, "'item' role")])
    return {"errors": errors}


@pytest.mark.parametrize("pkg", NAMES)
def test_missing_item_column(pkg):
    T.held(pkg, _sql_no_item)


# --------------------------------------- each source trains SPADE_TPU


def _train_from(P, source):
    """One seeded database laid out for ``source``, read back by the
    source and mined by ``SPADE_TPU`` through ``P``'s Master."""
    db = P.synth.synthetic_db(seed=71, n_sequences=120, n_items=10,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    want = P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(0.1, len(db))))
    store = P.store.ResultStore()
    master = P.actors.Master(store=store)
    with _Scratch() as tmp:
        data = {"algorithm": "SPADE_TPU", "support": "0.1", "uid": "src"}
        if source in ("table", "query"):
            path = tmp / "clicks.db"
            ES.write_clicks(path, db)
            store.add_fields("item", json.dumps({"group": "grp"}))
            data.update(source="JDBC", db=path)
            data.update({"table": "clicks"} if source == "table" else
                        {"query": "SELECT * FROM clicks"})
        elif source == "piwik":
            path = tmp / "piwik.sqlite"
            ES.write_piwik(path, db)
            data.update(source="PIWIK", db=path, idsite="1")
        else:
            MiniES.docs = ES.es_docs(db)
            data.update(source="ELASTIC", url=_URL[0], index="clicks",
                        page_size="50")
        try:
            read = P.sources.get_db(
                P.model.ServiceRequest("fsm", "train", data), store)
            resp = master.handle(P.model.ServiceRequest("fsm", "train", data))
            assert resp.status != "failure", resp.data
            status = await_terminal(store, "src")
        finally:
            master.shutdown()
        body = store.patterns("src")
    rec = {"same_db": read == list(db), "status": status,
           "sha": hashlib.sha256(body.encode()).hexdigest(),
           "oracle": text_of(P, body) == want,
           "sequences": json.loads(store.get("fsm:stats:src"))["sequences"]}
    assert rec["same_db"] and status == "finished" and rec["oracle"]
    return rec


@pytest.mark.parametrize("source", ["table", "query", "piwik", "elastic"])
@pytest.mark.parametrize("pkg", NAMES)
def test_source_trains_spade_with_parity(pkg, source):
    T.held(pkg, _train_from, source)
