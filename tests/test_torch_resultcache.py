"""The result-reuse tier on the port (``spark_fsm_tpu_torch/service/
resultcache.py`` with ``data/spmf.py``'s ``fingerprint_db``,
``file_validator`` and ``parse_spmf``), against the reference's
``tests/test_resultcache.py``.

Each scenario is one test parametrised over the two packages
(``_torch_cluster_rig.PKGS``): it runs once with each package's Master,
Miners and engines (the port's on the CPU) on the same seeded input and
returns a record: every job's terminal status, how it was served
(``served_from_cache``, ``coalesced_into``), the SHA-256 of its stored
body, whether the body equals the copied oracle at the request's own
parameters, and the ``fsm_rescache_*`` counters it moved (the byte
families are left out: an entry holds its own wall-clock stamp).  The
port's record must equal the reference's.

The reference's ``test_file_validator_mismatch_falls_back_to_cold_mine``
submits its repeat as soon as the first job reads FINISHED, before
``on_finished`` publishes the entry, and so fails now and then; its
twin waits for the entry itself (ROADMAP A16).
"""

import contextlib
import hashlib
import importlib
import json
import threading
import time
import types

import pytest

from _torch_cluster_rig import (NAMES, PKGS, PortOnCpu, Twins, assert_covers,
                                await_terminal)

FAMILIES = ("fsm_rescache_hits", "fsm_rescache_misses",
            "fsm_rescache_coalesced", "fsm_rescache_dominated_serves",
            "fsm_rescache_evictions", "fsm_rescache_errors",
            "fsm_rescache_peer_hints")


def _ns(name):
    P = PKGS[name]
    root = "spark_fsm_tpu_torch" if name == "port" else "spark_fsm_tpu"
    ns = types.SimpleNamespace(**vars(P))
    ns.tsr = importlib.import_module(f"{root}.models.tsr")
    ns.integrity = importlib.import_module(f"{root}.service.integrity")
    return ns


C = {name: _ns(name) for name in NAMES}
T = Twins(C, families=FAMILIES)


@pytest.fixture(autouse=True)
def _on_cpu():
    with PortOnCpu():
        yield


@contextlib.contextmanager
def _config(P, cfg: dict):
    """Boot config ``cfg`` for the scenario; the old one restored after."""
    old = P.config.get_config()
    P.config.set_config(P.config.parse_config(cfg))
    try:
        yield
    finally:
        P.config.set_config(old)


RESCACHE_ON = {"rescache": {"enabled": True}}


@contextlib.contextmanager
def _blocky(P):
    """A registered source that blocks its dataset load on an Event: the
    leader stays in flight while followers attach."""
    gate = threading.Event()

    def blocky(req, store):
        assert gate.wait(60), "blocky gate never opened"
        return P.spmf.parse_spmf(req.param("sequences"))

    P.sources.register("BLOCKY", blocky)
    try:
        yield gate
    finally:
        gate.set()
        P.sources.SOURCES.pop("BLOCKY", None)


@contextlib.contextmanager
def _master(P, store, **kw):
    master = P.actors.Master(store=store, **kw)
    try:
        yield master
    finally:
        master.shutdown()


def _db(P, seed=5, n=60):
    return P.synth.synthetic_db(seed=seed, n_sequences=n, n_items=9,
                                mean_itemsets=3.0, mean_itemset_size=1.2)


def _submit(P, master, uid, text, source="INLINE", **params):
    d = {"algorithm": "TSR_TPU", "source": source, "k": "8",
         "minconf": "0.4", "max_side": "2", "uid": uid}
    if source == "FILE":
        d["path"] = str(text)
    else:
        d["sequences"] = text
    d.update({k: str(v) for k, v in params.items()})
    resp = master.handle(P.model.ServiceRequest("fsm", "train", d))
    assert resp.status != "failure", resp.data
    return resp


def _stats(store, uid):
    return json.loads(store.get(f"fsm:stats:{uid}") or "{}")


def _sha(text) -> str:
    return hashlib.sha256((text or "").encode()).hexdigest()


def _rules(P, store, uid) -> str:
    return P.canonical.rules_text(P.model.deserialize_rules(store.rules(uid)))


def _patterns(P, store, uid) -> str:
    return P.canonical.patterns_text(
        P.model.deserialize_patterns(store.patterns(uid)))


def _job(P, store, uid, kind="rules", want=None) -> dict:
    """One job's record: status, how it was served, its body's digest and
    its equality with ``want`` (the oracle text) when given."""
    status = await_terminal(store, uid)
    st = _stats(store, uid)
    row = {"status": status, "served": st.get("served_from_cache"),
           "coalesced_into": st.get("coalesced_into")}
    if status == "finished":
        text = (_rules if kind == "rules" else _patterns)(P, store, uid)
        row["sha"] = _sha(text)
        if want is not None:
            row["oracle"] = text == want
            assert text == want, uid
    return row


def _published(store, n: int = 1):
    """Wait until ``n`` cache entries are in ``store``: an entry is
    published after its job reads FINISHED."""
    _wait_for(lambda: len(store.keys("fsm:rescache:")) >= n,
              f"{n} published cache entries")


def _wait_for(cond, what: str, timeout: float = 60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.01)
    raise TimeoutError(what)


# ------------------------------------------------------------- fingerprints


def _fingerprint_spellings(P):
    S = P.spmf
    a = S.parse_spmf("1 3 -1 2 -1 2 4 -2\n5 -1 6 -2\n")
    b = S.parse_spmf("3 1 3 -1 2 -1 4 2 -2\n5 -1 6 -1 -2\n")
    c = S.parse_spmf("1 3 -1 2 -1 2 4 -2\n5 -1 7 -2\n")
    rec = {"fp": [S.fingerprint_db(x) for x in (a, b, c)],
           "boundaries": S.fingerprint_db(S.parse_spmf("1 2 -2\n"))
           != S.fingerprint_db(S.parse_spmf("1 -1 2 -2\n"))}
    assert rec["fp"][0] == rec["fp"][1] != rec["fp"][2]
    assert rec["boundaries"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_fingerprint_canonical_across_spellings(pkg):
    """Spellings of one content share a fingerprint, and the fingerprints
    are the reference's digests."""
    T.held(pkg, _fingerprint_spellings)


def _disabled_by_default(P):
    with _master(P, P.store.ResultStore()) as master:
        rec = {"instance": master.miner._rescache is not None}
    assert rec == {"instance": False}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_by_default_no_instance(pkg):
    T.held(pkg, _disabled_by_default)


# ------------------------------------------------------- serving + parity


def _exact_and_dominated_tsr(P):
    db = _db(P, seed=31)
    text = P.spmf.format_spmf(db)
    store = P.store.ResultStore()
    oracle = lambda k, side=2: P.canonical.rules_text(  # noqa: E731
        P.tsr.mine_tsr_cpu(db, k, 0.4, max_side=side))
    rec = {}
    with _config(P, RESCACHE_ON), _master(P, store) as master:
        for uid, params, want in (
                ("cold", {}, oracle(8)), ("hit", {}, oracle(8)),
                ("domk", {"k": 4}, oracle(4)),
                ("doms", {"k": 8, "max_side": 1}, oracle(8, 1)),
                ("bigk", {"k": 12}, oracle(12))):
            _submit(P, master, uid, text, **params)
            rec[uid] = _job(P, store, uid, want=want)
            _published(store)
    assert rec["cold"]["served"] is None
    assert rec["hit"]["served"] == "exact"
    assert rec["hit"]["sha"] == rec["cold"]["sha"]
    assert rec["domk"]["served"] == "dominated"
    assert rec["doms"]["served"] in (None, "dominated")
    assert rec["bigk"]["served"] is None
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_exact_hit_and_dominated_tsr_parity(pkg):
    T.held(pkg, _exact_and_dominated_tsr)


def _dominated_spade(P):
    db = _db(P, seed=37, n=80)
    text = P.spmf.format_spmf(db)
    store = P.store.ResultStore()
    spade = lambda s, **kw: dict(algorithm="SPADE_TPU", support=s,  # noqa: E731
                                 k="", minconf="", max_side="", **kw)
    pat = lambda res: P.canonical.patterns_text(res)  # noqa: E731
    rec = {}
    with _config(P, RESCACHE_ON), _master(P, store) as master:
        for uid, params, want in (
                ("cold", spade(4), pat(P.oracle.mine_spade(db, 4))),
                ("dom", spade(8), pat(P.oracle.mine_spade(db, 8))),
                ("domrel", spade(0.1), pat(P.oracle.mine_spade(db, 8))),
                ("low", spade(2), pat(P.oracle.mine_spade(db, 2))),
                ("gap", spade(4, maxgap=1), pat(P.oracle.mine_cspade(
                    db, 4, maxgap=1, maxwindow=None)))):
            _submit(P, master, uid, text, **params)
            rec[uid] = _job(P, store, uid, "patterns", want)
            _published(store)
    assert [rec[u]["served"] for u in ("cold", "dom", "domrel", "low",
                                       "gap")] == [
        None, "dominated", "dominated", None, None]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_dominated_spade_minsup_parity_and_misses(pkg):
    T.held(pkg, _dominated_spade)


def _threshold_guard(P):
    servable = P.resultcache._servable
    ent = {
        "algo": "TSR_TPU", "kind": "rules",
        "params": {"algo": "TSR_TPU", "kind": "rules", "k": 2,
                   "minconf": 0.4, "max_side": None},
        "n_sequences": 20, "uid": "u",
        "payload": json.dumps([
            {"antecedent": [1], "consequent": [2], "support": 10,
             "antecedent_support": 20},
            {"antecedent": [3], "consequent": [4], "support": 9,
             "antecedent_support": 18},
        ]),
    }

    def want(k, minconf, max_side=None):
        return {"algo": "TSR_TPU", "kind": "rules", "k": k,
                "minconf": minconf, "max_side": max_side}

    def served(e, w):
        got = servable(e, w)
        if got is None:
            return None
        payload, mode, n = got
        return mode, n, _sha(payload)

    ent_ex = dict(ent, params=dict(ent["params"], k=5))
    ent_side = dict(ent, params=dict(ent["params"], max_side=1))
    rec = {
        "same_k_higher_conf": served(ent, want(2, 0.8)),
        "k1": served(ent, want(1, 0.4)), "k1_conf": served(ent, want(1, 0.5)),
        "exact": served(ent, want(2, 0.4)), "bigk": served(ent, want(3, 0.4)),
        "lowconf": served(ent, want(2, 0.3)),
        "exhaustive": served(ent_ex, want(5, 0.5)),
        "exhaustive_k2": served(ent_ex, want(2, 0.8)),
        "side": served(ent, want(2, 0.4, max_side=1)),
        "looser_side": served(ent_side, want(1, 0.4)),
        "looser_side2": served(ent_side, want(1, 0.4, max_side=2)),
        "k1_support": P.model.deserialize_rules(
            servable(ent, want(1, 0.4))[0])[0][2],
    }
    assert rec["same_k_higher_conf"] is None
    assert rec["k1"][:2] == ("dominated", 1) and rec["k1_support"] == 10
    assert rec["exact"] == ("exact", 2, _sha(ent["payload"]))
    assert rec["bigk"] is None and rec["lowconf"] is None
    assert rec["exhaustive"][:2] == ("dominated", 2)
    assert rec["exhaustive_k2"][:2] == ("dominated", 0)
    assert rec["side"][:2] == ("dominated", 2)
    assert rec["looser_side"] is None and rec["looser_side2"] is None
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_rules_dominance_threshold_guard_unit(pkg):
    T.held(pkg, _threshold_guard)


# ------------------------------------------------------------- coalescing


def _coalescing_fanout(P):
    db = _db(P, seed=41)
    text = P.spmf.format_spmf(db)
    store = P.store.ResultStore()
    with _config(P, RESCACHE_ON), _blocky(P) as gate, \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "blk", P.spmf.format_spmf(_db(P, seed=42)),
                source="BLOCKY")
        for uid in ("L", "F1", "F2"):
            _submit(P, master, uid, text)
        followers = master.miner._rescache.stats()["inflight_followers"]
        journaled = {uid: json.loads(store.journal_get(uid))[
            "coalesced_into"] for uid in ("F1", "F2")}
        gate.set()
        rec = {uid: _job(P, store, uid) for uid in ("blk", "L", "F1", "F2")}
        rec["followers"] = followers
        rec["journaled"] = journaled
        rec["fanout"] = [store.rules(u) == store.rules("L")
                         for u in ("F1", "F2")]
        rec["journal_after"] = [store.journal_get(u) for u in ("F1", "F2")]
    assert followers == 2 and journaled == {"F1": "L", "F2": "L"}
    assert rec["fanout"] == [True, True]
    assert rec["F1"]["coalesced_into"] == rec["F2"]["coalesced_into"] == "L"
    assert rec["journal_after"] == [None, None]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_coalescing_fanout(pkg):
    T.held(pkg, _coalescing_fanout)


def _leader_cancel(P):
    db = _db(P, seed=43)
    text = P.spmf.format_spmf(db)
    store = P.store.ResultStore()
    want = P.canonical.rules_text(P.tsr.mine_tsr_cpu(db, 8, 0.4,
                                                     max_side=2))
    with _config(P, RESCACHE_ON), _blocky(P) as gate, \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "blk", P.spmf.format_spmf(_db(P, seed=44)),
                source="BLOCKY")
        _submit(P, master, "L", text)
        _submit(P, master, "F", text)
        followers = master.miner._rescache.stats()["inflight_followers"]
        cancelled = master.cancel("L")
        gate.set()
        rec = {"followers": followers, "cancel": cancelled,
               "blk": _job(P, store, "blk"), "L": _job(P, store, "L"),
               "L_error": "CANCELLED" in store.get("fsm:error:L"),
               "F": _job(P, store, "F", want=want),
               "F_journal": store.journal_get("F")}
    assert rec["followers"] == 1 and rec["cancel"] == "queued"
    assert rec["L"]["status"] == "failure" and rec["L_error"]
    assert rec["F"]["status"] == "finished" and rec["F_journal"] is None
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_leader_cancel_redispatches_followers(pkg):
    T.held(pkg, _leader_cancel)


def _cancelled_follower(P):
    db = _db(P, seed=47)
    text = P.spmf.format_spmf(db)
    store = P.store.ResultStore()
    with _config(P, RESCACHE_ON), _blocky(P) as gate, \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "blk", P.spmf.format_spmf(_db(P, seed=48)),
                source="BLOCKY")
        _submit(P, master, "L", text)
        _submit(P, master, "F", text)
        cancels = [master.cancel("F"), master.cancel("L")]
        gate.set()
        rec = {"cancels": cancels, "blk": _job(P, store, "blk"),
               "L": _job(P, store, "L"), "F": _job(P, store, "F"),
               "F_error": "CANCELLED" in store.get("fsm:error:F"),
               "F_journal": store.journal_get("F")}
    assert rec["cancels"] == ["queued", "queued"]
    assert rec["L"]["status"] == rec["F"]["status"] == "failure"
    assert rec["F_error"] and rec["F_journal"] is None
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_cancelled_follower_not_revived_by_leader_teardown(pkg):
    T.held(pkg, _cancelled_follower)


def _follower_recovery(P):
    store = P.store.ResultStore()
    req = {"algorithm": "TSR_TPU", "source": "INLINE",
           "sequences": "1 -1 2 -2\n", "k": "4", "minconf": "0.4"}
    for uid, extra in (("dead-L", {}),
                       ("dead-F", {"coalesced_into": "dead-L"})):
        store.journal_set(uid, json.dumps({
            "uid": uid, "incarnation": "dead-incarnation",
            "replica": None, "ts": time.time(), "checkpoint": False,
            "priority": "normal", "request": dict(req, uid=uid),
            **extra}))
        store.add_status(uid, "started")
    with _master(P, store) as master:
        report = P.actors.recover_orphans(master)
        rec = {"failed": sorted(report["failed"])}
        for uid in ("dead-L", "dead-F"):
            rec[uid] = (store.status(uid), "interrupted by restart"
                        in store.get(f"fsm:error:{uid}"),
                        store.journal_get(uid))
    assert rec["failed"] == ["dead-F", "dead-L"]
    assert rec["dead-L"] == rec["dead-F"] == ("failure", True, None)
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_follower_recovery_after_kill(pkg):
    T.held(pkg, _follower_recovery)


# ------------------------------------------------------- knobs + eviction


def _lru_eviction(P):
    store = P.store.ResultStore()
    text = P.spmf.format_spmf(_db(P, seed=51, n=30))
    with _config(P, {"rescache": {"enabled": True, "max_bytes": 1}}), \
            _master(P, store) as master:
        evictions0 = P.resultcache._EVICTIONS.total()
        _submit(P, master, "a", text, k=4)
        rec = {"a": _job(P, store, "a")}
        # the entry is stored, then evicted, after "a" reads FINISHED
        _wait_for(lambda: P.resultcache._EVICTIONS.total() > evictions0,
                  "the eviction of a's entry")
        rec["keys"] = store.keys("fsm:rescache:")
        _submit(P, master, "b", text, k=4)
        rec["b"] = _job(P, store, "b")
    assert rec["keys"] == [] and rec["b"]["served"] is None
    assert rec["a"]["sha"] == rec["b"]["sha"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_lru_eviction_by_byte_budget(pkg):
    rec = T.held(pkg, _lru_eviction)
    assert rec["moved"]["fsm_rescache_evictions_total"] >= 1


def _flags_off(P):
    store = P.store.ResultStore()
    text = P.spmf.format_spmf(_db(P, seed=53, n=30))
    cfg = {"rescache": {"enabled": True, "dominance": False,
                        "coalesce": False}}
    with _config(P, cfg), _master(P, store) as master:
        rec = {}
        for uid in ("a", "b"):
            _submit(P, master, uid, text, k=4)
            rec[uid] = _job(P, store, uid)
    assert rec["b"]["served"] is None and rec["a"]["sha"] == rec["b"]["sha"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_dominance_and_coalesce_flags_off(pkg):
    T.held(pkg, _flags_off)


def _cluster_mode(P):
    store = P.store.ResultStore()
    text = P.spmf.format_spmf(_db(P, seed=61, n=40))
    cfg = {"rescache": {"enabled": True},
           "cluster": {"enabled": True, "replica_id": "rc-test",
                       "lease_ttl_s": 30.0}}
    with _config(P, cfg), _blocky(P) as gate, \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "blk", P.spmf.format_spmf(_db(P, seed=62, n=40)),
                source="BLOCKY")
        _submit(P, master, "L", text)
        _submit(P, master, "F", text)
        gate.set()
        rec = {uid: _job(P, store, uid) for uid in ("blk", "L", "F")}
        _published(store, 2)  # blk's and L's; F was L's follower
        _submit(P, master, "hit", text)
        rec["hit"] = _job(P, store, "hit")
        rec["journal"] = store.keys("fsm:journal:")
        rec["held"] = master.miner._lease.held_uids()
    assert rec["F"]["coalesced_into"] == "L"
    assert rec["hit"]["served"] == "exact"
    assert rec["journal"] == [] and rec["held"] == []
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_cluster_mode_serve_and_coalesce(pkg):
    T.held(pkg, _cluster_mode)


# ------------------------------------------------------- FILE fingerprints


def _file_validator_unlocks(P, tmp):
    db = _db(P, seed=70)
    path = tmp / f"data-{P.name}.spmf"
    path.write_text(P.spmf.format_spmf(db))
    deterministic = (P.spmf.file_validator(str(path))
                     == P.spmf.file_validator(str(path)))
    store = P.store.ResultStore()
    want = P.canonical.rules_text(P.tsr.mine_tsr_cpu(db, 5, 0.4,
                                                     max_side=2))
    rec = {"deterministic": deterministic}
    with _config(P, RESCACHE_ON), \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "cold", path, source="FILE")
        rec["cold"] = _job(P, store, "cold")
        _published(store)
        _submit(P, master, "hit", path, source="FILE")
        rec["hit"] = _job(P, store, "hit")
        _submit(P, master, "dom", path, source="FILE", k=5)
        rec["dom"] = _job(P, store, "dom", want=want)
    assert deterministic and rec["cold"]["served"] is None
    assert rec["hit"]["served"] == "exact"
    assert rec["hit"]["sha"] == rec["cold"]["sha"]
    assert rec["dom"]["served"] == "dominated"
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_file_validator_unlocks_admission_fp_and_dominance(pkg, tmp_path):
    T.held(pkg, _file_validator_unlocks, tmp_path)


def _file_validator_mismatch(P, tmp):
    """A path rewritten under a learned mapping mines the new content
    cold; each repeat is submitted once the entry it should hit is
    published (the reference test's race, closed)."""
    db1, db2 = _db(P, seed=71), _db(P, seed=72, n=50)
    path = tmp / f"mut-{P.name}.spmf"
    path.write_text(P.spmf.format_spmf(db1))
    store = P.store.ResultStore()
    want2 = P.canonical.rules_text(P.tsr.mine_tsr_cpu(db2, 8, 0.4,
                                                      max_side=2))
    rec = {}
    with _config(P, RESCACHE_ON), \
            _master(P, store, miner_workers=1) as master:
        _submit(P, master, "one", path, source="FILE")
        rec["one"] = _job(P, store, "one")
        _published(store, 1)
        _submit(P, master, "one-hit", path, source="FILE")
        rec["one-hit"] = _job(P, store, "one-hit")
        path.write_text(P.spmf.format_spmf(db2))
        _submit(P, master, "two", path, source="FILE")
        rec["two"] = _job(P, store, "two", want=want2)
        _published(store, 2)
        _submit(P, master, "two-hit", path, source="FILE")
        rec["two-hit"] = _job(P, store, "two-hit")
    assert rec["one-hit"]["served"] == "exact"
    assert rec["two"]["served"] is None
    assert rec["two-hit"]["served"] == "exact"
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_file_validator_mismatch_falls_back_to_cold_mine(pkg, tmp_path):
    T.held(pkg, _file_validator_mismatch, tmp_path)


# ------------------------------------------ cross-replica coalesce hint


def _peer_inflight_hint(P, monkeypatch):
    store = P.store.ResultStore()
    mk = lambda rid: P.lease.LeaseManager(  # noqa: E731
        store, replica_id=rid, lease_ttl_s=30.0, heartbeat_s=0)
    mgr_a, mgr_b = mk("rc-a"), mk("rc-b")
    gate, entered = threading.Event(), threading.Event()
    real = P.sources.get_db

    def gated(req, store_):
        if req.uid == "L":
            entered.set()
            assert gate.wait(60)
        return real(req, store_)

    text = P.spmf.format_spmf(_db(P, seed=80, n=40))
    hints0 = P.obs.REGISTRY.snapshot()["fsm_rescache_peer_hints_total"]
    rec = {}
    with _config(P, RESCACHE_ON), monkeypatch.context() as mp, \
            _master(P, store, miner_workers=1, lease_mgr=mgr_a) as master_a, \
            _master(P, store, miner_workers=1, lease_mgr=mgr_b) as master_b:
        mp.setattr(P.sources, "get_db", gated)
        try:
            _submit(P, master_a, "L", text)
            assert entered.wait(60)
            mgr_a.publish_heartbeat()
            rec["inflight"] = master_a.miner.inflight_fps() != []
            rec["peers"] = [p["replica"] for p in mgr_b.peers()]
            resp = master_b.handle(P.model.ServiceRequest("fsm", "train", {
                "algorithm": "TSR_TPU", "source": "INLINE",
                "sequences": text, "k": "8", "minconf": "0.4",
                "max_side": "2", "uid": "dup"}))
            rec["shed"] = (resp.data.get("http_status"),
                           int(resp.data["retry_after_s"]) >= 1,
                           "peer replica" in resp.data["error"])
            rec["trace"] = (store.status("dup"), store.journal_get("dup"))
            rec["hints"] = P.obs.REGISTRY.snapshot()[
                "fsm_rescache_peer_hints_total"] - hints0
            gate.set()
            rec["L"] = _job(P, store, "L")
            _published(store)
            _submit(P, master_b, "dup", text)
            rec["dup"] = _job(P, store, "dup")
        finally:
            gate.set()
    assert rec["inflight"] and rec["peers"] == ["rc-a"]
    assert rec["shed"] == ("429", True, True) and rec["hints"] == 1
    assert rec["trace"] == (None, None)
    assert rec["dup"]["served"] == "exact"
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_peer_inflight_hint_sheds_with_steal_path_retry(pkg, monkeypatch):
    T.held(pkg, _peer_inflight_hint, monkeypatch)


def _sidecar_heal(P):
    text = P.spmf.format_spmf(_db(P, seed=61))
    store = P.store.ResultStore()
    with _config(P, RESCACHE_ON):
        with _master(P, store, miner_workers=1) as master:
            _submit(P, master, "warm", text)
            rec = {"warm": _job(P, store, "warm")}
            _published(store)
        [ekey] = store.keys("fsm:rescache:")
        skey = P.resultcache.sidecar_key_for(ekey)
        rec["sidecar_written"] = store.peek(skey) is not None
        store.delete(skey)
        scr = P.integrity.Scrubber(store, scrub_every_s=0.0, batch=256)
        tally = scr.scrub()
        rec["tally"] = (tally["repaired"], tally["quarantined"])
        ent_payload = P.envelope.unwrap(store.peek(ekey))[0]
        side = json.loads(P.envelope.unwrap(store.peek(skey))[0])
        rec["healed"] = (side["digest"] == json.loads(ent_payload)["digest"],
                         side["bytes"] == len(ent_payload))
        with _master(P, store, miner_workers=1) as master:
            _submit(P, master, "served", text)
            rec["served"] = _job(P, store, "served")
    assert rec["tally"] == (1, 0) and rec["healed"] == (True, True)
    assert rec["served"]["served"] == "exact"
    assert rec["served"]["sha"] == rec["warm"]["sha"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_crash_between_entry_and_sidecar_heals_on_next_boot(pkg):
    T.held(pkg, _sidecar_heal)


def test_twin_covers_every_reference_test():
    assert_covers(globals(), "test_resultcache.py")
