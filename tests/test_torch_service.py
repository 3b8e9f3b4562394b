"""The port's service (``spark_fsm_tpu_torch/service``) against the
reference's (``spark_fsm_tpu/service``) over HTTP, on the CPU.

One process boots both: the reference's ``serve_background()`` and the
port's ``serve_background(device="cpu")``, on two ephemeral ports.  Both
get the same requests over inputs made from a seed by the copied
``data/synth.py``, and answer with byte-identical ``/get/patterns``,
``/get/rules`` and failure envelopes, ``/predict`` envelopes equal but
for the wall-clock fields, and ``/status`` envelopes equal but for the
keys listed in ``EXCLUDED``.  Also: cancellation and ``deadline_s``
abort a running CPU mine with the reference's status and error text,
the knobs the port does not serve yet are refused, and a boot without
``device`` resolves ``cuda`` and raises on a box without a card."""

import dataclasses
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from spark_fsm_tpu import config as JC
from spark_fsm_tpu.service import app as JA
from spark_fsm_tpu_torch import config as TC
from spark_fsm_tpu_torch.data.spmf import format_spmf
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.service import app as TA
from spark_fsm_tpu_torch.utils import shapes as TS

# /status stats keys that legitimately differ between the two services
EXCLUDED = {
    "mine_s": "wall time of the mine",
    "dataset_s": "wall time of the source load",
    "results_per_s": "derived from mine_s",
    "wait_s": "the port's engines time their blocking counter readbacks; "
              "the reference's have no such stat",
    "push_wall_s": "wall time of a stream push",
    "phase_s": "wall times of a stream push's stages",
}
# the reference counts a whole-mine dispatch as one kernel launch; the
# port's whole-mine engines launch B1 once a wave and count each launch
# (a partitioned mine's slices are whole-mine when it counts waves)
WHOLE_MINE_ROUTES = ("queue", True)


def _whole_mine(stats):
    return stats.get("fused") in WHOLE_MINE_ROUTES or (
        stats.get("fused") == "partitioned" and "waves" in stats)


# /predict stats keys that are wall-clock readings
PREDICT_TIMING = ("e2e_ms", "window_wait_ms", "exec_ms")
# the routing keys compared explicitly
ROUTING = ("fused", "resident", "store_cache_hit")


@pytest.fixture(scope="module")
def servers():
    ref = JA.serve_background()
    port = TA.serve_background(device="cpu")
    yield ref, port
    for srv in (ref, port):
        srv.master.shutdown()
        srv.shutdown()


def _call(srv, endpoint, **params):
    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{srv.server_port}{endpoint}"
    try:
        with urllib.request.urlopen(url, data=data, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _both(servers, endpoint, **params):
    return [_call(s, endpoint, **params) for s in servers]


def _await(srv, uid, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        code, body = _call(srv, f"/status/{uid}")
        st = json.loads(body)
        if st["status"] in ("finished", "failure"):
            return st
        time.sleep(0.03)
    raise AssertionError(f"{uid} never finished")


def _db(seed=3, n=300):
    return synthetic_db(seed=seed, n_sequences=n, n_items=20,
                        mean_itemsets=3.0)


def _split_status(st):
    """-> (envelope without stats and error, stats, error's first line)."""
    data = dict(st["data"])
    stats = json.loads(data.pop("stats", "{}"))
    error = data.pop("error", None)
    return (dict(st, data=data), stats,
            None if error is None else error.splitlines()[0])


def _assert_status_equal(ref_st, port_st):
    r_env, r_stats, r_err = _split_status(ref_st)
    p_env, p_stats, p_err = _split_status(port_st)
    assert p_env == r_env
    assert p_err == r_err
    skip = set(EXCLUDED)
    if _whole_mine(r_stats):
        skip.add("kernel_launches")
    keep = lambda s: {k: v for k, v in s.items() if k not in skip}  # noqa: E731
    assert keep(p_stats) == keep(r_stats)
    for key in ROUTING:
        assert p_stats.get(key) == r_stats.get(key), key
    return r_stats


def _assert_predict_equal(servers, uid, items):
    out = []
    for code, body in _both(servers, "/predict", uid=uid, items=items):
        env = json.loads(body)
        stats = env["data"].pop("stats", None)
        if stats is not None:
            stats = {k: v for k, v in json.loads(stats).items()
                     if k not in PREDICT_TIMING}
        out.append((code, env, stats))
    assert out[1] == out[0]
    return json.loads(out[0][1]["data"].get("predictions", "[]"))


def _train_both(servers, uid, get, **params):
    """Train on both services with one uid, hold /status, /get/{get} and
    /predict to each other; returns the reference's stats."""
    for code, body in _both(servers, "/train", uid=uid, **params):
        assert code == 200 and json.loads(body)["status"] == "started", body
    ref_st, port_st = (_await(s, uid) for s in servers)
    assert ref_st["status"] == "finished", ref_st
    stats = _assert_status_equal(ref_st, port_st)
    ref_get, port_get = _both(servers, f"/get/{get}", uid=uid)
    assert port_get == ref_get
    assert json.loads(ref_get[1])["data"][get] != "[]"
    preds = [_assert_predict_equal(servers, uid, items)
             for items in ("", "1,2", _observed(ref_get[1], get))]
    assert any(preds)
    return stats


def _observed(body, get):
    """A prefix some mined rule fires on: the first rule's antecedent, or
    the first itemset of the first multi-itemset pattern."""
    mined = json.loads(json.loads(body)["data"][get])
    if get == "rules":
        return ",".join(map(str, mined[0]["antecedent"]))
    first = next(p for p in mined if len(p["itemsets"]) > 1)
    return ",".join(map(str, first["itemsets"][0]))


# ------------------------------------------------------------ sources

def test_spade_tpu_file_source(servers, tmp_path):
    path = tmp_path / "db.spmf"
    path.write_text(format_spmf(_db()))
    stats = _train_both(servers, "file-spade", "patterns",
                        algorithm="SPADE_TPU", source="FILE",
                        path=str(path), support="0.05")
    assert stats["fused"] == "queue"


def test_spade_tpu_inline_source(servers):
    _train_both(servers, "inline-spade", "patterns", algorithm="SPADE_TPU",
                source="INLINE", sequences=format_spmf(_db(4)),
                support="0.04")


def test_spade_tpu_tracked_source(servers):
    for srv in servers:
        code, _ = _call(srv, "/register/clicks", site="site", user="user",
                        timestamp="timestamp", item="item")
        assert code == 200
    for s, seq in enumerate(_db(5, 120)):
        for ts, itemset in enumerate(seq):
            for item in itemset:
                for code, body in _both(servers, "/track/clicks",
                                        site="shop", user=f"u{s}",
                                        timestamp=str(ts), item=str(item)):
                    assert code == 200, body
    _train_both(servers, "tracked-spade", "patterns", algorithm="SPADE_TPU",
                source="TRACKED", topic="clicks", support="0.05")


# ------------------------------------------------------------ engines

ENGINES = {
    "cspade": ("patterns", dict(algorithm="SPADE_TPU", support="0.05",
                                maxgap="2", maxwindow="5")),
    "spam": ("patterns", dict(algorithm="SPAM_TPU", support="0.05")),
    "tsr": ("rules", dict(algorithm="TSR_TPU", k="20", minconf="0.5")),
    "tsr-side2": ("rules", dict(algorithm="TSR_TPU", k="20", minconf="0.5",
                                max_side="2")),
    "spade-cpu": ("patterns", dict(algorithm="SPADE", support="0.05")),
    "cspade-cpu": ("patterns", dict(algorithm="SPADE", support="0.05",
                                    maxgap="1")),
    "spam-cpu": ("patterns", dict(algorithm="SPAM", support="0.05")),
    "tsr-cpu": ("rules", dict(algorithm="TSR", k="10", minconf="0.4")),
    "auto-patterns": ("patterns", dict(algorithm="AUTO", support="0.05")),
    "auto-rules": ("rules", dict(algorithm="AUTO", k="10", minconf="0.4")),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_bodies_equal_reference(servers, name):
    get, params = ENGINES[name]
    stats = _train_both(servers, "engine-" + name, get, source="INLINE",
                        sequences=format_spmf(_db()), **params)
    if name == "tsr":
        assert stats["resident"] is True
    if name.startswith("auto"):
        assert stats["planner_engine"] == (
            "TSR_TPU" if get == "rules" else "SPAM_TPU")


def test_auto_routes_a_sparse_db_to_spade(servers):
    from spark_fsm_tpu_torch.data.synth import sub_crossover_db

    stats = _train_both(servers, "auto-sparse", "patterns",
                        algorithm="AUTO", source="INLINE",
                        sequences=format_spmf(sub_crossover_db()),
                        support="2")
    assert stats["planner_engine"] == "SPADE_TPU"


@pytest.fixture()
def two_partitions():
    saved_ref, saved_port = JC.get_config(), TC.get_config()
    JC.set_config(dataclasses.replace(
        JC.Config(), partition=JC.PartitionConfig(enabled=True, parts=2)))
    TC.set_config(dataclasses.replace(
        TC.Config(), partition=TC.PartitionConfig(enabled=True, parts=2)))
    yield
    JC.set_config(saved_ref)
    TC.set_config(saved_port)


@pytest.mark.parametrize("name,get,params", [
    ("spade", "patterns", dict(algorithm="SPADE_TPU", support="0.05")),
    ("cspade", "patterns", dict(algorithm="SPADE_TPU", support="0.05",
                                maxgap="2")),
    ("spam", "patterns", dict(algorithm="SPAM_TPU", support="0.05")),
    ("tsr", "rules", dict(algorithm="TSR_TPU", k="20", minconf="0.5",
                          max_side="2")),
])
def test_two_partitions_equal_reference(servers, two_partitions, name, get,
                                        params):
    _train_both(servers, "part-" + name, get, source="INLINE",
                sequences=format_spmf(_db(6)), **params)


# ------------------------------------------------------------ streams

@pytest.mark.parametrize("topic,extra,route", [
    ("inc", {}, "incremental"),
    ("remine", {"incremental": "0"}, "re-mine"),
    ("cstr", {"maxgap": "2"}, "re-mine"),
    ("tsr", {"algorithm": "TSR_TPU", "k": "10", "minconf": "0.4"},
     "re-mine"),
])
def test_stream_pushes_equal_reference(servers, topic, extra, route):
    """/stream/{topic} pushes: the same window route, push answers and
    /get bodies after every push, three pushes into a window of two."""
    params = dict(support="0.2", max_batches="2", algorithm="SPADE_TPU")
    params.update(extra)
    get = "rules" if "k" in params else "patterns"
    for push in range(3):
        seqs = format_spmf(_db(40 + push, 60))
        ref, port = _both(servers, f"/stream/{topic}", sequences=seqs,
                          **params)
        assert port == ref and ref[0] == 200, ref
        assert json.loads(ref[1])["status"] == "finished", ref
        ref_get, port_get = _both(servers, f"/get/{get}",
                                  uid=f"stream:{topic}")
        assert port_get == ref_get
    assert json.loads(ref[1])["data"]["evicted_batches"] == "1"
    ref_st, port_st = (json.loads(_call(s, f"/status/stream:{topic}")[1])
                       for s in servers)
    stats = _assert_status_equal(ref_st, port_st)
    assert stats["route"] == route


# ------------------------------------------------------------ failures

@pytest.mark.parametrize("endpoint,params", [
    ("/train", dict(uid="bad-algo", algorithm="NOPE", source="INLINE",
                    sequences="1 -2", support="0.5")),
    ("/status/deadbeef", {}),
    ("/get/patterns", dict(uid="deadbeef")),
    ("/get/rules", dict(uid="deadbeef")),
    ("/predict", dict(uid="deadbeef", items="1")),
    ("/predict", dict(uid="deadbeef")),
    ("/nowhere", {}),
])
def test_failure_envelopes_equal_reference(servers, endpoint, params):
    ref, port = _both(servers, endpoint, **params)
    assert port == ref
    assert ref[0] in (200, 400, 404)


@pytest.mark.parametrize("uid,params", [
    ("no-support", dict(algorithm="SPADE_TPU")),
    ("spam-maxgap", dict(algorithm="SPAM_TPU", support="0.05",
                         maxgap="2")),
])
def test_job_failures_equal_reference(servers, uid, params):
    for code, body in _both(servers, "/train", uid=uid, source="INLINE",
                            sequences=format_spmf(_db()), **params):
        assert code == 200, body
    ref_st, port_st = (_await(s, uid) for s in servers)
    assert ref_st["status"] == "failure"
    _assert_status_equal(ref_st, port_st)


# ------------------------------------------------------------ aborts

_LONG = dict(algorithm="TSR", k="400", minconf="0.05")


def _long_db():
    return synthetic_db(seed=11, n_sequences=1500, n_items=80,
                        mean_itemsets=6.0)


def test_deadline_aborts_a_cpu_mine_like_the_reference(servers):
    seqs = format_spmf(_long_db())
    for code, body in _both(servers, "/train", uid="deadline",
                            source="INLINE", sequences=seqs,
                            deadline_s="0.3", **_LONG):
        assert code == 200, body
    ref_st, port_st = (_await(s, "deadline") for s in servers)
    assert ref_st["status"] == "failure"
    _, _, err = _split_status(ref_st)
    assert err.startswith("DEADLINE_EXCEEDED"), err
    _assert_status_equal(ref_st, port_st)


def test_cancel_aborts_a_running_cpu_mine_like_the_reference(servers):
    seqs = format_spmf(_long_db())
    for srv in servers:
        code, body = _call(srv, "/train", uid="cancel-me", source="INLINE",
                           sequences=seqs, **_LONG)
        assert code == 200, body
    for srv in servers:
        deadline = time.time() + 60
        while time.time() < deadline:
            st = json.loads(_call(srv, "/status/cancel-me")[1])["status"]
            if st != "started":
                break
            time.sleep(0.02)
    answers = _both(servers, "/admin/cancel/cancel-me")
    for code, body in answers:
        assert code == 200, body
    assert answers[0] == answers[1]
    ref_st, port_st = (_await(s, "cancel-me") for s in servers)
    _, _, err = _split_status(ref_st)
    assert err.startswith("CANCELLED"), err
    _assert_status_equal(ref_st, port_st)


# ------------------------------------------------------------ boot

def test_admin_stats_name_the_port_backend(servers):
    ref, port = (json.loads(b) for _, b in _both(servers, "/admin/stats"))
    assert port["backend"] == "cpu"
    assert port["devices"] == torch.cuda.device_count()
    assert port["prewarm"] is None
    assert port["shape_keys_recorded"] == len(TS.recorded())
    assert port["algorithms"] == ref["algorithms"]
    for block in ("store_cache", "cspade_cache", "tsr_cache"):
        assert set(port[block]) == set(ref[block])
    for endpoint in ("/admin/ping", "/admin/algorithms"):
        ref_body, port_body = _both(servers, endpoint)
        assert port_body == ref_body
    # the boot [prewarm] batch envelope is empty: both warm the /predict
    # ladder of the [predict] defaults alone, key for key
    reports = [json.loads(body) for code, body in
               _both(servers, "/admin/prewarm")]
    ref_r, port_r = ((r["enumerated"], r["backend"],
                      [(row["shape_key"], row["kind"], row.get("error"))
                       for row in r["keys"]]) for r in reports)
    assert port_r == ref_r and port_r[0] and port_r[1] == "cpu"


@pytest.mark.parametrize("section,value", [
    ("engine", {"mesh_devices": 2}),
    ("distributed", {"enabled": True}),
    ("meshguard", {"enabled": True}),
])
def test_unported_knobs_are_refused(section, value):
    with pytest.raises(NotImplementedError, match="A13b steps 5–7"):
        TC.parse_config({section: value})
    cfg = TC.Config()
    setattr(cfg, section, dataclasses.replace(getattr(cfg, section), **value))
    saved = TC.get_config()
    with pytest.raises(NotImplementedError, match="A13b steps 5–7"):
        TC.set_config(cfg)
    assert TC.get_config() is saved


@pytest.mark.parametrize("section", ["prewarm", "fusion"])
def test_warm_path_knobs_are_accepted(section):
    """[prewarm] and [fusion] are served: the config takes them."""
    saved = TC.get_config()
    try:
        cfg = TC.parse_config({section: {"enabled": True}})
        TC.set_config(cfg)
        assert getattr(TC.get_config(), section).enabled
    finally:
        TC.set_config(saved)


def test_boot_without_a_device_resolves_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        TA.serve_background()
    # main() configures logging and the process-wide config before it
    # boots: keep both as they were for the tests after this one
    monkeypatch.setattr(TA.logging, "basicConfig", lambda **kw: None)
    monkeypatch.setattr(TC, "_active", TC.get_config())
    monkeypatch.setattr(sys, "argv", ["app", "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        TA.main()
    monkeypatch.setattr(sys, "argv", ["app", "--port", "0",
                                      "--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        TA.main()
