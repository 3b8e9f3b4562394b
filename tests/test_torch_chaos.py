"""The chaos suite on the port's engines: an injected failure at every
registered fault site of ``spark_fsm_tpu_torch/utils/faults.py``, against
the reference's ``tests/test_chaos.py``.

Each scenario is one test parametrised over the two packages
(``_torch_cluster_rig.PKGS``): the drill runs once with the reference's
modules and engines and once with the port's (engines on the CPU), on the
same seeded input, and returns a record (terminal status, stored text,
journal and lease bookkeeping, the site's counters).  The port's case
holds its record equal to the reference's (``_held``).  Where the port's
documented rule differs (ROADMAP "Known differences": no kernel-to-plain
downgrade on a dispatch fault, no resident-round fallback) the port's
case asserts the port's outcome, a clean failure with nothing lost, and
says so.  ``COVERED`` is pinned to the port's ``KNOWN_SITES``; three
sites' drills live in ``tests/test_torch_planes.py`` (the OOM ladder,
the watchdog hang, ``fusion.dispatch``) and the map names them there.

Deterministic: nth/every triggers, and the reference's pinned seed
(``SPARKFSM_CHAOS_SEED``, default 1299827) for probability triggers.
The autouse fixture disarms both packages' registries and watchdog
policies around every scenario and resets both packages' engine-cache
breakers.  Scenarios that assert a cache entry or a guard's state wait
for that event itself, never for a job's status.
"""

import importlib
import json
import os
import re
import threading
import time
import types

import numpy as np
import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, Twins

CHAOS_SEED = int(os.environ.get("SPARKFSM_CHAOS_SEED", "1299827"))
SCENARIO_DEADLINE_S = 300.0
WAIT_S = 120.0
HERE = os.path.dirname(os.path.abspath(__file__))

_EXTRA = {
    "devcache": "service.devcache", "retry": "utils.retry",
    "watchdog": "utils.watchdog", "kafka": "streaming.kafka",
    "consumer": "streaming.consumer", "fusion": "service.fusion",
    "prewarm": "service.prewarm", "shapes": "utils.shapes",
    "resultcache": "service.resultcache", "rule_trie": "ops.rule_trie",
    "tsr": "models.tsr",
}


def _chaos_ns(name):
    P = PKGS[name]
    root = "spark_fsm_tpu_torch" if name == "port" else "spark_fsm_tpu"
    ns = types.SimpleNamespace(**vars(P))
    for attr, mod in _EXTRA.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.spade = importlib.import_module(
        f"{root}.models.{'spade' if name == 'port' else 'spade_tpu'}")
    return ns


C = {name: _chaos_ns(name) for name in NAMES}

# site -> scenario names; the sweep test pins this to the port's registry
PLANES = "test_torch_planes.py::"
COVERED: dict = {
    # held in tests/test_torch_planes.py, on the port against the reference
    "device.oom": [PLANES + "test_oom_degradation_ladder_halves_width",
                   PLANES + "test_oom_mid_mine_equals_reference",
                   PLANES + "test_oom_on_a_fused_launch_halves_it"],
    "device.dispatch": [
        PLANES + "test_dispatch_hang_fails_launch_via_watchdog"],
    "fusion.dispatch": [
        PLANES + "test_fusion_dispatch_fault_degrades_group_to_solo_with_parity",
        PLANES + "test_fusion_dispatch_fault_queue_wave_degrades_direct"],
}


def covers(*sites):
    def deco(fn):
        for s in sites:
            COVERED.setdefault(s, []).append(fn.__name__)
        return fn
    return deco


def _caches(P):
    return (P.devcache.spade_engine_cache, P.devcache.cspade_engine_cache,
            P.devcache.tsr_engine_cache)


@pytest.fixture(autouse=True)
def _chaos_hygiene():
    """No injection, watchdog policy or open breaker leaks in or out of a
    scenario, in either package."""
    with PortOnCpu():
        for P in C.values():
            P.faults.disarm()
            P.watchdog.configure(slack=None)
            for cache in _caches(P):
                cache.breaker.success()
        yield
        for P in C.values():
            P.faults.disarm()
            P.watchdog.configure(slack=None)
            assert P.faults.armed() == {}, P.name


def _bounded(P, fn):
    """A hang is a failure with a named site, never a wedged run."""
    return P.watchdog.run_with_deadline(fn, SCENARIO_DEADLINE_S,
                                        site="chaos.suite")


# run ``scenario(P, *args)`` for a package; the port's record must equal
# the reference's
_held = Twins(C).held


def _delta(P, site, before):
    now = P.faults.counters().get(site, {"calls": 0, "injected": 0})
    was = before.get(site, {"calls": 0, "injected": 0})
    return {k: now[k] - was[k] for k in ("calls", "injected")}


def _db(P):
    return P.synth.synthetic_db(seed=17, n_sequences=120, n_items=10,
                                mean_itemsets=3.0, mean_itemset_size=1.3)


def _rule_db(P, seed=23):
    return P.synth.synthetic_db(seed=seed, n_sequences=40, n_items=7,
                                mean_itemsets=3.0, mean_itemset_size=1.2)


def _resident_db(P):
    return P.synth.synthetic_db(seed=29, n_sequences=90, n_items=9,
                                mean_itemsets=3.0, mean_itemset_size=1.2)


def _on_cpu(P):
    return {"device": "cpu"} if P.name == "port" else {}


def _tsr(P, vdb, k, minconf, **kw):
    if P.name == "port":
        return P.tsr.TsrTorch(vdb, k, minconf, device="cpu", **kw)
    return P.tsr.TsrTPU(vdb, k, minconf, **kw)


def _mine_tsr(P, db, k, minconf, **kw):
    mine = P.tsr.mine_tsr_torch if P.name == "port" else P.tsr.mine_tsr_tpu
    return mine(db, k, minconf, **_on_cpu(P), **kw)


def _kernel_tsr(P, db, k, minconf, **kw):
    """A TSR engine on the kernel path: the reference's ``use_pallas``
    (interpret mode off the TPU); the port's ``use_kernel`` set after
    construction (B2's wrapper runs its plain version on the CPU)."""
    vdb = P.vertical.build_vertical(db, min_item_support=1)
    if P.name == "port":
        eng = _tsr(P, vdb, k, minconf, **kw)
        eng.use_kernel = True
        return eng
    return _tsr(P, vdb, k, minconf, use_pallas=True, **kw)


def _classic(P, vdb, minsup, **kw):
    cls = P.spade.SpadeTorch if P.name == "port" else P.spade.SpadeTPU
    return cls(vdb, minsup, **_on_cpu(P), **kw)


def _spade_text(P, db, rel):
    return P.canonical.patterns_text(P.oracle.mine_spade(
        db, P.vertical.abs_minsup(rel, len(db))))


def _submit_data(uid):
    return {"algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
            "uid": uid}


def _await(P, store, uid, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = store.status(uid)
        if st in ("finished", "failure"):
            return st
        time.sleep(0.02)
    raise TimeoutError(f"job {uid} reached no terminal status")


def _wait_for(cond, what, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _run_train(P, store, data, timeout=WAIT_S):
    """Submit one train job through the package's Master; (uid, terminal
    status)."""
    master = P.actors.Master(store=store)
    try:
        resp = master.handle(P.model.ServiceRequest("fsm", "train",
                                                    dict(data)))
        assert resp.status != "failure", resp.data
        uid = resp.data["uid"]
        return uid, _await(P, store, uid, timeout)
    finally:
        master.shutdown()


def _stored_text(P, store, uid):
    raw = store.patterns(uid)
    return None if raw is None else P.canonical.patterns_text(
        P.model.deserialize_patterns(raw))


def _stored_rules(P, store, uid):
    raw = store.rules(uid)
    return None if raw is None else P.canonical.rules_text(
        P.model.deserialize_rules(raw))


def _retries(P):
    return P.retry.retry_counters().get("store.checkpoint", {}).get(
        "retries", 0)


# ---------------------------------------------------------------- registry


def test_every_registered_site_is_covered():
    """The sweep is the port's registry, which is the reference's; a site
    covered in ``test_torch_planes.py`` names a test that is there."""
    from spark_fsm_tpu.utils import faults as JF
    from spark_fsm_tpu_torch.utils import faults

    assert faults.KNOWN_SITES == JF.KNOWN_SITES
    assert set(COVERED) == set(faults.KNOWN_SITES), (
        f"uncovered: {set(faults.KNOWN_SITES) - set(COVERED)}, "
        f"unknown: {set(COVERED) - set(faults.KNOWN_SITES)}")
    with open(os.path.join(HERE, "test_torch_planes.py")) as fh:
        planes = set(re.findall(r"^def (test_\w+)", fh.read(), re.M))
    for names in COVERED.values():
        for name in names:
            if "::" in name:
                assert name.split("::")[1] in planes, name


@pytest.mark.parametrize("pkg", NAMES)
def test_registry_validates_arms(pkg):
    F = C[pkg].faults
    with pytest.raises(ValueError, match="unknown fault site"):
        F.arm("store.flush", nth=1)
    with pytest.raises(ValueError, match="exactly one"):
        F.arm("store.set", nth=1, every=2)
    with pytest.raises(ValueError, match="delay_s"):
        F.arm("store.set", nth=1, exc="none")
    assert F.armed() == {}


def _trigger_shapes(P):
    F = P.faults
    calls = []
    with F.injected("store.set", every=2, match="chaos-trigger"):
        for i in range(6):
            try:
                F.fault_site("store.set", key=f"chaos-trigger-{i}")
                calls.append("ok")
            except F.FaultInjected:
                calls.append("boom")
    outcomes = []
    for _ in range(2):
        hits = []
        with F.injected("store.set", p=0.5, seed=CHAOS_SEED,
                        match="chaos-trigger"):
            for i in range(16):
                try:
                    F.fault_site("store.set", key=f"chaos-trigger-{i}")
                    hits.append(0)
                except F.FaultInjected:
                    hits.append(1)
        outcomes.append(hits)
    assert calls == ["ok", "boom", "ok", "boom", "ok", "boom"]
    assert outcomes[0] == outcomes[1] and sum(outcomes[0]) > 0
    return {"calls": calls, "seeded": outcomes[0]}


@pytest.mark.parametrize("pkg", NAMES)
def test_trigger_shapes_are_deterministic(pkg):
    _held(pkg, _trigger_shapes)


# ------------------------------------------------------------- store I/O


def _store_set_scenario(P):
    db = _db(P)
    store = P.store.ResultStore()
    before, r0 = P.faults.counters(), _retries(P)
    with P.faults.injected("store.set", nth=1, match="fsm:frontier:"):
        uid, status = _bounded(P, lambda: _run_train(P, store, {
            "algorithm": "SPADE_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "support": "0.1",
            "checkpoint": "1", "checkpoint_every_s": "0"}))
    assert status == "finished", store.get(f"fsm:error:{uid}")
    text = _stored_text(P, store, uid)
    assert text == _spade_text(P, db, 0.1)
    assert _retries(P) >= r0 + 1
    return {"status": status, "text": text,
            "journal": store.journal_get(uid),
            "site": _delta(P, "store.set", before)}


@covers("store.set")
@pytest.mark.parametrize("pkg", NAMES)
def test_store_set_fault_retried_during_checkpointed_job(pkg):
    _held(pkg, _store_set_scenario)


def _store_rpush_scenario(P):
    db = _db(P)
    minsup = P.vertical.abs_minsup(0.05, len(db))
    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, "chaos-rpush", every_s=0.0)
    eng = _classic(P, P.vertical.build_vertical(db, min_item_support=minsup),
                   minsup, node_batch=4, pipeline_depth=2,
                   pool_bytes=32 << 20)
    before, r0 = P.faults.counters(), _retries(P)
    with P.faults.injected("store.rpush", nth=1,
                           match="fsm:frontier:results:chaos-rpush"):
        got = _bounded(P, lambda: eng.mine(checkpoint_cb=ckpt.save,
                                           checkpoint_every_s=0.0))
    text = P.canonical.patterns_text(got)
    assert text == _spade_text(P, db, 0.05)
    state = ckpt.load()
    assert state is not None
    assert _retries(P) >= r0 + 1
    return {"text": text, "site": _delta(P, "store.rpush", before)}


@covers("store.rpush")
@pytest.mark.parametrize("pkg", NAMES)
def test_store_rpush_fault_retried_mid_mine(pkg):
    _held(pkg, _store_rpush_scenario)


def _store_get_scenario(P):
    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, "chaos-get")
    ckpt.save({"version": 1, "stack": [{"steps": [[0, 1]], "s": [], "i": []}],
               "results_done": 0, "results": [[[[1]], 3]]})
    before, r0 = P.faults.counters(), _retries(P)
    with P.faults.injected("store.get", nth=1, match="fsm:frontier:chaos-get"):
        state = P.actors.StoreCheckpoint(store, "chaos-get").load()
    assert state is not None and state["results"] == [[[[1]], 3]]
    assert _retries(P) >= r0 + 1
    return {"state": state, "site": _delta(P, "store.get", before)}


@covers("store.get")
@pytest.mark.parametrize("pkg", NAMES)
def test_store_get_fault_retried_on_resume_load(pkg):
    _held(pkg, _store_get_scenario)


# ---------------------------------------------------------- checkpoint.save


def _checkpoint_save_scenario(P):
    db = _db(P)
    store = P.store.ResultStore()
    before = P.faults.counters()
    with P.faults.injected("checkpoint.save", nth=1):
        uid, status = _bounded(P, lambda: _run_train(P, store, {
            "algorithm": "SPADE_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "support": "0.1",
            "checkpoint": "1", "checkpoint_every_s": "0", "retries": "2"}))
    assert status == "finished", store.get(f"fsm:error:{uid}")
    text = _stored_text(P, store, uid)
    assert text == _spade_text(P, db, 0.1)
    return {"status": status, "text": text,
            "journal": store.journal_get(uid),
            "site": _delta(P, "checkpoint.save", before)}


@covers("checkpoint.save")
@pytest.mark.parametrize("pkg", NAMES)
def test_checkpoint_save_fault_job_still_finishes_with_parity(pkg):
    _held(pkg, _checkpoint_save_scenario)


# -------------------------------------------------------------- kafka.poll


class _Rec:
    def __init__(self, value):
        self.value = value


class _FakeKafka:
    def __init__(self, polls):
        self._polls = list(polls)

    def poll(self, timeout_ms=None):
        return self._polls.pop(0) if self._polls else {}


def _kafka_scenario(P):
    dbs = [P.synth.synthetic_db(seed=s, n_sequences=12, n_items=6,
                                mean_itemsets=2.0) for s in (1, 2, 3)]
    polls = [{"tp0": [_Rec(P.spmf.format_spmf(db).encode())]} for db in dbs]
    fetch = P.kafka.KafkaFetch(_FakeKafka(polls))
    got = []
    pc = P.consumer.PollConsumer(fetch, got.append, poll_interval_s=0)
    before = P.faults.counters()
    with P.faults.injected("kafka.poll", every=2):
        stats = _bounded(P, lambda: pc.run(max_polls=10))
    assert got == dbs
    assert stats["errors"] >= 2 and stats["stopped"] == "max_polls"
    return {"batches": got, "errors": stats["errors"],
            "stopped": stats["stopped"],
            "site": _delta(P, "kafka.poll", before)}


@covers("kafka.poll")
@pytest.mark.parametrize("pkg", NAMES)
def test_flaky_poll_backs_off_and_loses_nothing(pkg):
    _held(pkg, _kafka_scenario)


# ---------------------------------------------------------- device.dispatch


def _dispatch_kernel_scenario(P):
    """The reference re-pools a failed kernel geometry onto jnp with
    parity; the port raises out of the mine (ROADMAP "Known differences":
    no kernel-to-plain downgrade on a dispatch fault)."""
    db = _rule_db(P)
    want = P.canonical.rules_text(_kernel_tsr(P, db, 8, 0.4,
                                              max_side=2).mine())
    eng = _kernel_tsr(P, db, 8, 0.4, max_side=2)
    before = P.faults.counters()
    with P.faults.injected("device.dispatch", nth=1, match="kernel"):
        if P.name == "port":
            with pytest.raises(P.faults.FaultInjected):
                _bounded(P, eng.mine)
            return {"site": _delta(P, "device.dispatch", before),
                    "fallback": [k for k in eng.stats
                                 if k.startswith("pallas_fallback")]}
        got = _bounded(P, eng.mine)
    assert P.canonical.rules_text(got) == want
    assert any(k.startswith("pallas_fallback_km") for k in eng.stats)
    return {"site": _delta(P, "device.dispatch", before)}


def _dispatch_service_failure(P):
    """The port's outcome of a dispatch fault through the service: a
    clean terminal failure that names the site, nothing stored, the
    journal and the lease settled; the unarmed resubmit equals the
    oracle.  The reference's service absorbs the same fault with a
    re-pool onto jnp, so this record is the port's alone."""
    db = _rule_db(P)
    store = P.store.ResultStore()
    mgr = P.lease.LeaseManager(store, replica_id="chaos-dispatch",
                               lease_ttl_s=30.0, heartbeat_s=0)
    master = P.actors.Master(store=store, lease_mgr=mgr)
    data = {"algorithm": "TSR_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "k": "8",
            "minconf": "0.4", "max_side": "2"}
    try:
        with P.faults.injected("device.dispatch", every=1):
            resp = master.handle(P.model.ServiceRequest(
                "fsm", "train", dict(data, uid="chaos-kernel")))
            assert resp.status == "started", resp.data
            status = _await(P, store, "chaos-kernel")
        err = store.get("fsm:error:chaos-kernel") or ""
        rec = {"status": status, "names_site": "'device.dispatch'" in err,
               "rules": store.rules("chaos-kernel"),
               "journal": store.journal_get("chaos-kernel"),
               "lease": _wait_for(
                   lambda: store.peek("fsm:lease:chaos-kernel") is None,
                   "the failed job's lease to settle")}
        resp = master.handle(P.model.ServiceRequest(
            "fsm", "train", dict(data, uid="chaos-kernel")))
        assert resp.status == "started", resp.data
        rec["resubmit"] = _await(P, store, "chaos-kernel")
        rec["parity"] = _stored_rules(P, store, "chaos-kernel") == \
            P.canonical.rules_text(P.tsr.mine_tsr_cpu(db, 8, 0.4,
                                                      max_side=2))
        return rec
    finally:
        master.shutdown()


@covers("device.dispatch")
@pytest.mark.parametrize("pkg", NAMES)
def test_dispatch_fault_degrades_kernel_to_jnp_with_parity(pkg):
    """Reference: the kernel-to-jnp downgrade, rules byte-identical.
    Port (ROADMAP "Known differences": no kernel-to-plain downgrade on a
    dispatch fault): the kernel-path mine raises at the fault, and
    through the service the job fails cleanly, nothing is stored, its
    journal and lease settle, and the unarmed resubmit equals the
    oracle."""
    rec = _dispatch_kernel_scenario(C[pkg])
    assert rec["site"]["injected"] == 1
    if pkg == "port":
        assert rec == {"site": {"calls": 1, "injected": 1}, "fallback": []}
        assert _dispatch_service_failure(C["port"]) == {
            "status": "failure", "names_site": True, "rules": None,
            "journal": None, "lease": True, "resubmit": "finished",
            "parity": True}


def _queue_dispatch_scenario(P):
    db = _db(P)
    store = P.store.ResultStore()
    before = P.faults.counters()
    with P.faults.injected("device.dispatch", nth=1, match="queue_launch"):
        uid, status = _bounded(P, lambda: _run_train(P, store, {
            "algorithm": "SPADE_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "support": "0.1",
            "retries": "2"}))
    assert status == "finished", store.get(f"fsm:error:{uid}")
    text = _stored_text(P, store, uid)
    assert text == _spade_text(P, db, 0.1)
    return {"status": status, "text": text,
            "journal": store.journal_get(uid),
            "site": _delta(P, "device.dispatch", before)}


@covers("device.dispatch")
@pytest.mark.parametrize("pkg", NAMES)
def test_dispatch_fault_in_queue_mine_is_supervised(pkg):
    _held(pkg, _queue_dispatch_scenario)


def _fused_broker_scenario(P):
    db_a, db_b = _rule_db(P), _rule_db(P, seed=29)

    def mk(db):
        return _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 8,
                    0.4, max_side=2)

    want = [P.canonical.rules_text(mk(db).mine()) for db in (db_a, db_b)]
    FZ = P.fusion
    FZ.configure(P.config.FusionConfig(enabled=True, window_ms=250.0))
    b = FZ.broker()
    before = P.faults.counters()
    out = {}
    try:
        b.hold()
        ts = [threading.Thread(target=lambda k=k, db=db: out.setdefault(
            k, mk(db).mine())) for k, db in ((0, db_a), (1, db_b))]
        with P.faults.injected("device.dispatch", nth=1, match="jnp"):
            for t in ts:
                t.start()
            _wait_for(lambda: b.pending() >= 2, "two pending waves")
            b.release()
            for t in ts:
                t.join(WAIT_S)
                assert not t.is_alive(), "degraded mine wedged"
    finally:
        b.release()
        assert b.drain(10.0)
        FZ.configure(None)
    got = [P.canonical.rules_text(out[i]) for i in (0, 1)]
    assert got == want
    site = _delta(P, "device.dispatch", before)
    assert site["injected"] == 1, "the drill fired nowhere on the broker"
    return {"rules": got, "site": site}


@covers("device.dispatch")
@pytest.mark.parametrize("pkg", NAMES)
def test_device_dispatch_fault_fires_on_fused_broker_path(pkg):
    _held(pkg, _fused_broker_scenario)


def _deadline_scenario(P):
    db = _rule_db(P)
    store = P.store.ResultStore()
    with P.faults.injected("device.dispatch", every=1, delay_s=0.6,
                           exc="none", match="jnp"):
        uid, status = _bounded(P, lambda: _run_train(P, store, {
            "algorithm": "TSR_TPU", "source": "INLINE",
            "sequences": P.spmf.format_spmf(db), "k": "8", "minconf": "0.4",
            "max_side": "2", "deadline_s": "0.5", "retries": "3"}))
    err = store.get(f"fsm:error:{uid}") or ""
    return {"status": status, "deadline": err.startswith("DEADLINE_EXCEEDED"),
            "journal": store.journal_get(uid),
            "released": P.jobctl.get(uid) is None,
            "retried": int(store.get("fsm:metric:jobs_retried") or 0)}


@pytest.mark.parametrize("pkg", NAMES)
def test_deadline_expiry_mid_mine_fails_fast_and_durable(pkg):
    rec = _held(pkg, _deadline_scenario)
    assert rec == {"status": "failure", "deadline": True, "journal": None,
                   "released": True, "retried": 0}


# ----------------------------------------------------------- prewarm.compile


def _prewarm_scenario(P):
    spec = P.shapes.WorkloadSpec(n_sequences=8, n_items=2, n_words=1)
    with P.faults.injected("prewarm.compile", nth=1):
        report = _bounded(P, lambda: P.prewarm.run(spec, **_on_cpu(P)))
    rows = report["keys"]
    errs = [r for r in rows if "error" in r]
    assert len(rows) >= 2
    assert len(errs) == 1 and "injected fault" in errs[0]["error"], rows
    assert report["total_wall_s"] >= 0
    return {"keys": sorted(r["shape_key"] for r in rows),
            "errored": [r["shape_key"] for r in errs]}


@covers("prewarm.compile")
@pytest.mark.parametrize("pkg", NAMES)
def test_prewarm_compile_fault_is_isolated_per_key(pkg):
    _held(pkg, _prewarm_scenario)


# -------------------------------------------------------------- devcache.put


def _devcache_scenario(P):
    db = _db(P)
    minsup = P.vertical.abs_minsup(0.1, len(db))
    want = _spade_text(P, db, 0.1)
    cache = P.devcache.SpadeEngineCache()
    cache.breaker = P.retry.CircuitBreaker("chaos-devcache", threshold=2,
                                           cooldown_s=1.0)
    text = P.canonical.patterns_text
    kw = _on_cpu(P)
    with P.faults.injected("devcache.put", every=1):
        for _ in range(2):
            with pytest.raises(P.faults.FaultInjected):
                cache.mine(db, minsup, stats_out={}, **kw)
        opened = cache.breaker.state()
        snap = cache.breaker.snapshot()
        got = _bounded(P, lambda: cache.mine(db, minsup, stats_out={}, **kw))
        assert text(got) == want
    fallbacks = cache.stats["breaker_fallbacks"]
    time.sleep(1.05)
    stats: dict = {}
    assert text(_bounded(P, lambda: cache.mine(
        db, minsup, stats_out=stats, **kw))) == want
    probe = (cache.breaker.state(), stats["store_cache_hit"])
    stats = {}
    assert text(_bounded(P, lambda: cache.mine(
        db, minsup, stats_out=stats, **kw))) == want
    hit = stats["store_cache_hit"]
    cache.clear()
    return {"opened": opened, "opens": snap["opens"] >= 1,
            "failures": snap["failures"] >= 2, "fallbacks": fallbacks,
            "probe": probe, "hit": hit}


@covers("devcache.put")
@pytest.mark.parametrize("pkg", NAMES)
def test_devcache_breaker_opens_then_half_open_probe_recovers(pkg):
    rec = _held(pkg, _devcache_scenario)
    assert rec == {"opened": "open", "opens": True, "failures": True,
                   "fallbacks": 1, "probe": ("closed", False), "hit": True}


@pytest.mark.parametrize("pkg", NAMES)
def test_breaker_probe_expiry_recovers_from_dead_probe(pkg):
    t = [0.0]
    br = C[pkg].retry.CircuitBreaker("chaos-probe", threshold=1,
                                     cooldown_s=10.0, clock=lambda: t[0])
    br.failure()
    assert br.state() == "open"
    t[0] = 10.0
    assert br.allow() is True
    assert br.allow() is False
    t[0] = 20.0
    assert br.allow() is True
    br.success()
    assert br.state() == "closed" and br.allow() is True


# ----------------------------------------------- consumer backoff + leaks


def _backoff_scenario(P):
    def fetch():
        raise RuntimeError("broker down")

    pc = P.consumer.PollConsumer(fetch, lambda b: None, poll_interval_s=0.01,
                                 max_consecutive_errors=4, max_backoff_s=0.08)
    waits = []
    orig_wait = pc._stop.wait

    def spy_wait(t):
        waits.append(t)
        return orig_wait(0)

    pc._stop.wait = spy_wait
    stats = _bounded(P, lambda: pc.run(max_polls=10))
    assert len(waits) == 3 and waits[0] >= 0.01
    assert waits[0] < waits[-1] <= 0.08
    return {"stopped": stats["stopped"], "errors": stats["errors"],
            "backoff_waits": stats["backoff_waits"]}


@pytest.mark.parametrize("pkg", NAMES)
def test_consumer_error_backoff_grows_and_is_bounded(pkg):
    assert _held(pkg, _backoff_scenario) == {
        "stopped": "errors", "errors": 4, "backoff_waits": 3}


@pytest.mark.parametrize("pkg", NAMES)
def test_consumer_stop_counts_leaked_thread(pkg):
    P = C[pkg]
    release = threading.Event()
    pc = P.consumer.PollConsumer(lambda: P.spmf.parse_spmf("1 -2\n"),
                                 lambda batch: release.wait(20),
                                 poll_interval_s=0)
    pc.start()
    _wait_for(lambda: pc.stats["polls"] >= 1, "the first poll", 10)
    base = P.consumer.consumer_health()["leaked_threads"]
    pc.stop(join_timeout_s=0.05)
    try:
        assert pc.stats["leaked_threads"] == 1
        assert P.consumer.consumer_health()["leaked_threads"] == base + 1
        pc.stop(join_timeout_s=0.05)
        assert pc.stats["leaked_threads"] == 1
        assert P.consumer.consumer_health()["leaked_threads"] == base + 1
    finally:
        release.set()


# ------------------------------------------- admission + journal + deadline


def _admit_scenario(P):
    store = P.store.ResultStore()
    master = P.actors.Master(store=store)
    before = P.faults.counters()
    try:
        with P.faults.injected("service.admit", nth=1):
            resp = master.handle(P.model.ServiceRequest(
                "fsm", "train", _submit_data("chaos-admit")))
        rec = {"refused": resp.status,
               "names": "injected fault" in resp.data["error"],
               "status": store.status("chaos-admit"),
               "journal": store.journal_get("chaos-admit")}
        uid, status = _bounded(P, lambda: _run_train(
            P, store, _submit_data("chaos-admit")))
        rec["resubmit"] = status
        rec["site"] = _delta(P, "service.admit", before)
        return rec
    finally:
        master.shutdown()


@covers("service.admit")
@pytest.mark.parametrize("pkg", NAMES)
def test_admit_fault_is_clean_synchronous_failure(pkg):
    rec = _held(pkg, _admit_scenario)
    assert rec["refused"] == "failure" and rec["names"]
    assert rec["status"] is None and rec["journal"] is None
    assert rec["resubmit"] == "finished"


def _journal_scenario(P):
    store = P.store.ResultStore()
    miner = P.actors.Miner(store, workers=1, queue_depth=2)
    req = P.model.ServiceRequest
    before = P.faults.counters()
    try:
        with P.faults.injected("service.journal", nth=1):
            with pytest.raises(P.faults.FaultInjected):
                miner.submit(req("fsm", "train",
                                 _submit_data("chaos-journal")))
        rec = {"status": store.status("chaos-journal"),
               "journal": store.journal_get("chaos-journal"),
               "reserved": miner._q._reserved, "queued": miner.queue_size()}
        for i in range(2):
            miner.submit(req("fsm", "train", _submit_data(f"chaos-fill{i}")))
        rec["fills"] = [_await(P, store, f"chaos-fill{i}") for i in range(2)]
        with P.faults.injected("store.set", nth=1,
                               match="fsm:status:chaos-late"):
            with pytest.raises(P.faults.FaultInjected):
                miner.submit(req("fsm", "train", _submit_data("chaos-late")))
        rec["late_journal"] = store.journal_get("chaos-late")
        miner.submit(req("fsm", "train", _submit_data("chaos-late")))
        rec["late"] = _await(P, store, "chaos-late")
        rec["site"] = _delta(P, "service.journal", before)
        return rec
    finally:
        miner.shutdown()


@covers("service.journal")
@pytest.mark.parametrize("pkg", NAMES)
def test_journal_write_fault_fails_submit_without_slot_leak(pkg):
    rec = _held(pkg, _journal_scenario)
    assert rec["status"] is None and rec["journal"] is None
    assert rec["reserved"] == 0 and rec["queued"] == 0
    assert rec["fills"] == ["finished", "finished"]
    assert rec["late_journal"] is None and rec["late"] == "finished"


# ------------------------------------------------------- admin endpoints


def _post_raw(port, endpoint, **params):
    import urllib.error
    import urllib.parse
    import urllib.request

    data = urllib.parse.urlencode(params).encode()
    url = f"http://127.0.0.1:{port}{endpoint}"
    try:
        with urllib.request.urlopen(url, data=data, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def _admin_scenario(P):
    cfg0 = P.config.get_config()
    srv = P.app.serve_background(**_on_cpu(P))
    port = srv.server_port
    try:
        rec = {}
        code, body = _post_raw(port, "/admin/faults", action="list")
        rec["refused"] = (code, "fault injection disabled" in body["error"])
        code, health = _post_raw(port, "/admin/health")
        rec["health"] = (code, sorted(set(health) & {
            "faults", "retry", "watchdog", "breakers", "consumers", "jobs"}),
            health["faults"]["enabled"], sorted(health["breakers"]),
            "leaked_threads" in health["consumers"],
            "jobs_retried" in health["jobs"])
        cfg = P.config.Config()
        cfg.fault_injection = True
        P.config.set_config(cfg)
        code, body = _post_raw(port, "/admin/faults", action="arm",
                               site="store.get", nth="1", match="chaos-admin")
        rec["arm"] = (code, body["armed"])
        code, body = _post_raw(port, "/admin/faults", action="disarm",
                               site="store.get")
        rec["disarm"] = (code, body["armed"])
        code, body = _post_raw(port, "/admin/faults", action="arm",
                               site="nope.nope", nth="1")
        rec["unknown"] = (code, "unknown fault site" in body["error"])
        return rec
    finally:
        P.faults.disarm()
        P.config.set_config(cfg0)
        srv.master.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_admin_faults_gated_and_health_reports_subsystems(pkg):
    rec = _held(pkg, _admin_scenario)
    assert rec["refused"] == (403, True)
    assert rec["health"] == (200, ["breakers", "consumers", "faults", "jobs",
                                   "retry", "watchdog"], False,
                             ["cspade_cache", "store_cache", "tsr_cache"],
                             True, True)
    assert rec["arm"][0] == 200 and rec["arm"][1]["store.get"]["nth"] == 1
    assert rec["disarm"] == (200, {}) and rec["unknown"] == (500, True)


# ------------------------------------------------------------- lease.*


def _lease_miner(P, store, rid, ttl=5.0, heartbeat_s=0.0, depth=8):
    mgr = P.lease.LeaseManager(store, replica_id=rid, lease_ttl_s=ttl,
                               heartbeat_s=heartbeat_s)
    return P.actors.Miner(store, workers=1, queue_depth=depth,
                          lease_mgr=mgr), mgr


def _gated(P, uid):
    """Hold ``uid``'s run at its dataset read until released."""
    gate, entered = threading.Event(), threading.Event()
    real = P.sources.get_db

    def gated(req, store_):
        if req.uid == uid:
            entered.set()
            assert gate.wait(WAIT_S), "gate never freed"
        return real(req, store_)

    P.sources.get_db = gated
    return gate, entered, real


def _lease_acquire_scenario(P):
    store = P.store.ResultStore()
    mgr = P.lease.LeaseManager(store, replica_id="chaos-acq",
                               lease_ttl_s=5.0, heartbeat_s=0)
    master = P.actors.Master(store=store, lease_mgr=mgr)
    before = P.faults.counters()
    try:
        with P.faults.injected("lease.acquire", nth=1):
            resp = master.handle(P.model.ServiceRequest(
                "fsm", "train", _submit_data("chaos-lease")))
        rec = {"refused": (resp.status, resp.data["http_status"],
                           "lease acquisition" in resp.data["error"]),
               "trace": (store.status("chaos-lease"),
                         store.journal_get("chaos-lease"),
                         store.peek("fsm:lease:chaos-lease")),
               "reserved": master.miner._q._reserved}
        resp = master.handle(P.model.ServiceRequest(
            "fsm", "train", _submit_data("chaos-lease")))
        rec["resubmit"] = (resp.status, _await(P, store, "chaos-lease"))
        rec["site"] = _delta(P, "lease.acquire", before)
        return rec
    finally:
        master.shutdown()


@covers("lease.acquire")
@pytest.mark.parametrize("pkg", NAMES)
def test_lease_acquire_fault_is_clean_503_with_zero_trace(pkg):
    rec = _held(pkg, _lease_acquire_scenario)
    assert rec["refused"] == ("failure", "503", True)
    assert rec["trace"] == (None, None, None) and rec["reserved"] == 0
    assert rec["resubmit"] == ("started", "finished")


def _lease_renew_scenario(P):
    store = P.store.ResultStore()
    miner, mgr = _lease_miner(P, store, "chaos-renew", ttl=0.9,
                              heartbeat_s=None)
    gate, entered, real = _gated(P, "chaos-held")
    try:
        with P.faults.injected("lease.renew", every=1):
            miner.submit(P.model.ServiceRequest(
                "fsm", "train", _submit_data("chaos-held")))
            assert entered.wait(WAIT_S)
            ctl = P.jobctl.get("chaos-held")
            fenced = bool(_wait_for(lambda: ctl.lease_lost,
                                    "the heartbeat to fence the job", 30))
            gate.set()
            status = _await(P, store, "chaos-held")
        err = store.get("fsm:error:chaos-held") or ""
        return {"fenced": fenced, "status": status,
                "lease_lost": err.startswith("LEASE_LOST"),
                "journal": store.journal_get("chaos-held"),
                "released": P.jobctl.get("chaos-held") is None,
                "retried": int(store.get("fsm:metric:jobs_retried") or 0),
                "injected": P.faults.counters()["lease.renew"]["injected"]
                >= 1}
    finally:
        P.sources.get_db = real
        gate.set()
        miner.shutdown()


@covers("lease.renew")
@pytest.mark.parametrize("pkg", NAMES)
def test_lease_renew_fault_job_runs_until_ttl_then_self_fences(pkg):
    assert _held(pkg, _lease_renew_scenario) == {
        "fenced": True, "status": "failure", "lease_lost": True,
        "journal": None, "released": True, "retried": 0, "injected": True}


def _lease_steal_scenario(P):
    store = P.store.ResultStore()
    miner_a, mgr_a = _lease_miner(P, store, "chaos-victim", ttl=30.0)
    miner_b, mgr_b = _lease_miner(P, store, "chaos-thief", ttl=30.0)
    gate, entered, real = _gated(P, "chaos-blocker")
    before = P.faults.counters()
    try:
        miner_a.submit(P.model.ServiceRequest(
            "fsm", "train", _submit_data("chaos-blocker")))
        assert entered.wait(WAIT_S)
        miner_a.submit(P.model.ServiceRequest(
            "fsm", "train", _submit_data("chaos-q1")))
        mgr_a.publish_heartbeat()
        with P.faults.injected("lease.steal", every=1):
            stolen = mgr_b.steal_once()
        rec = {"stolen": stolen,
               "markers": store.keys("fsm:admission:chaos-victim:"),
               "holder": json.loads(
                   store.peek("fsm:lease:chaos-q1"))["replica"],
               "site": _delta(P, "lease.steal", before)}
        gate.set()
        rec["status"] = _await(P, store, "chaos-q1")
        rec["journals"] = _wait_for(lambda: store.journal_uids() == [],
                                    "every journal intent to settle")
        return rec
    finally:
        P.sources.get_db = real
        gate.set()
        miner_a.shutdown()
        miner_b.shutdown()


@covers("lease.steal")
@pytest.mark.parametrize("pkg", NAMES)
def test_lease_steal_fault_leaves_job_with_victim(pkg):
    rec = _held(pkg, _lease_steal_scenario)
    assert rec["stolen"] == 0 and rec["holder"] == "chaos-victim"
    assert rec["markers"] == ["fsm:admission:chaos-victim:chaos-q1"]
    assert rec["site"]["injected"] >= 1 and rec["status"] == "finished"


# ---------------------------------------------------------- device.resident


@covers("device.resident")
@pytest.mark.parametrize("point", ["segment", "readback", "records"])
@pytest.mark.parametrize("pkg", NAMES)
def test_resident_fault_at_each_point(pkg, point):
    """Reference: the faulted round falls back to the host path from its
    original state, rules equal to the fault-free run, the fallback
    counted.  Port (ROADMAP "Known differences": no resident-round
    fallback): the mine raises at the fault (the site's counters 1/1,
    ``resident_fallbacks`` 0), and a checkpointed mine faulted after its
    first snapshot resumes that snapshot to the fault-free rules."""
    P = C[pkg]
    db = _resident_db(P)
    want = P.canonical.rules_text(_mine_tsr(P, db, 20, 0.4, max_side=None,
                                            resident="never"))
    before = P.faults.counters()
    eng = _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 20,
               0.4, max_side=None, resident="always")
    with P.faults.injected("device.resident", nth=1, match=point):
        if pkg == "port":
            with pytest.raises(P.faults.FaultInjected):
                _bounded(P, eng.mine)
        else:
            got = _bounded(P, eng.mine)
    assert _delta(P, "device.resident", before) == {"calls": 1,
                                                    "injected": 1}
    if pkg == "reference":
        assert P.canonical.rules_text(got) == want
        assert eng.stats.get("resident_fallbacks", 0) == 1, eng.stats
        return
    assert eng.stats.get("resident_fallbacks", 0) == 0
    # nothing lost: a checkpointed mine faulted past its first snapshot
    # resumes the persisted frontier and reaches the same rules
    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, f"chaos-res-{point}", every_s=0.0)
    eng = _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 20,
               0.4, max_side=None, resident="always")
    nth = 1 if point == "records" else 2
    with P.faults.injected("device.resident", nth=nth, match=point):
        with pytest.raises(P.faults.FaultInjected):
            _bounded(P, lambda: eng.mine(checkpoint_cb=ckpt.save,
                                         checkpoint_every_s=0.0))
    state = P.actors.StoreCheckpoint(store, f"chaos-res-{point}").load()
    assert state is not None and eng.stats.get("checkpoints", 0) >= 1
    eng2 = _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 20,
                0.4, max_side=None, resident="always")
    got = _bounded(P, lambda: eng2.mine(resume=state))
    assert P.canonical.rules_text(got) == want


def _resident_kill_scenario(P):
    rng = np.random.default_rng(37)
    db = [[[int(it)] for it in (list(range(8))
                                + rng.integers(8, 13, size=3).tolist())]
          for _ in range(40)]
    want = P.canonical.rules_text(_mine_tsr(P, db, 150, 0.3, max_side=None,
                                            resident="never"))

    class Killed(Exception):
        pass

    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, "chaos-resident", every_s=0.0)
    saves = []

    def cb(state):
        ckpt.save(state)
        saves.append(len(state["stack"]))
        if len(saves) == 2:
            raise Killed

    eng = _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 150,
               0.3, max_side=None, resident="always")
    with pytest.raises(Killed):
        _bounded(P, lambda: eng.mine(checkpoint_cb=cb,
                                     checkpoint_every_s=0.0))
    state = P.actors.StoreCheckpoint(store, "chaos-resident",
                                     every_s=0.0).load()
    assert state is not None and state["stack"]
    eng2 = _tsr(P, P.vertical.build_vertical(db, min_item_support=1), 150,
                0.3, max_side=None, resident="always")
    got = P.canonical.rules_text(_bounded(P, lambda: eng2.mine(
        resume=state)))
    assert eng2.stats["resumed_nodes"] == len(state["stack"])
    assert eng2.stats.get("resident_rounds", 0) >= 1, eng2.stats
    assert got == want
    return {"saves": saves, "resumed_nodes": eng2.stats["resumed_nodes"],
            "rules": got}


@covers("device.resident")
@pytest.mark.parametrize("pkg", NAMES)
def test_resident_kill_restart_resumes_persisted_frontier(pkg):
    """A resume, not a fallback: exact parity on both packages, and the
    port's snapshots and resumed frontier equal the reference's."""
    _held(pkg, _resident_kill_scenario)


# -------------------------------------------- result-reuse tier


def _rescache_config(P):
    old = P.config.get_config()
    P.config.set_config(P.config.parse_config({"rescache": {"enabled": True}}))
    return old


def _tsr_data(P):
    return {"algorithm": "TSR", "source": "INLINE",
            "sequences": P.spmf.format_spmf(_rule_db(P)), "k": "5",
            "minconf": "0.4"}


def _rescache_lookup_scenario(P):
    old = _rescache_config(P)
    try:
        data = _tsr_data(P)
        store = P.store.ResultStore()
        _, st = _bounded(P, lambda: _run_train(P, store,
                                               dict(data, uid="rcl-prime")))
        assert st == "finished"
        # the prime's cache entry itself, never its status
        _wait_for(lambda: store.keys("fsm:rescache:"), "the cache entry")
        before = P.faults.counters()
        with P.faults.injected("rescache.lookup", every=1):
            _, st = _bounded(P, lambda: _run_train(
                P, store, dict(data, uid="rcl-cold")))
        stats = json.loads(P.envelope.unwrap(
            store.get("fsm:stats:rcl-cold"))[0])
        return {"status": st, "cold": "served_from_cache" not in stats,
                "same": store.rules("rcl-cold") == store.rules("rcl-prime"),
                "journals": _wait_for(lambda: store.keys("fsm:journal:")
                                      == [], "the journal to settle"),
                "site": _delta(P, "rescache.lookup", before)}
    finally:
        P.config.set_config(old)


@covers("rescache.lookup")
@pytest.mark.parametrize("pkg", NAMES)
def test_rescache_lookup_fault_degrades_to_cold_mine(pkg):
    rec = _held(pkg, _rescache_lookup_scenario)
    assert rec["status"] == "finished" and rec["cold"] and rec["same"]
    assert rec["site"]["injected"] >= 1


def _rescache_store_scenario(P):
    old = _rescache_config(P)
    try:
        data = _tsr_data(P)
        store = P.store.ResultStore()
        before = P.faults.counters()
        with P.faults.injected("rescache.store", every=1):
            _, st = _bounded(P, lambda: _run_train(P, store,
                                                   dict(data, uid="rcs-a")))
            # the store attempt itself, faulted: the entry's event
            _wait_for(lambda: _delta(P, "rescache.store",
                                     before)["injected"] >= 1,
                      "the cache store attempt")
        rec = {"status": st, "entries": store.keys("fsm:rescache:")}
        _, rec["repeat"] = _bounded(P, lambda: _run_train(
            P, store, dict(data, uid="rcs-b")))
        rec["same"] = store.rules("rcs-b") == store.rules("rcs-a")
        rec["journals"] = _wait_for(
            lambda: store.keys("fsm:journal:") == [], "the journal to settle")
        return rec
    finally:
        P.config.set_config(old)


@covers("rescache.store")
@pytest.mark.parametrize("pkg", NAMES)
def test_rescache_store_fault_keeps_job_green(pkg):
    assert _held(pkg, _rescache_store_scenario) == {
        "status": "finished", "entries": [], "repeat": "finished",
        "same": True, "journals": True}


# ----------------------------------------------------------- storeguard


def _storeguard_probe_scenario(P):
    SG = P.storeguard
    SG.uninstall()
    scfg = P.config.parse_config({"storeguard": {
        "enabled": True, "probe_every_s": 0, "down_after": 1}}).storeguard
    store = P.store.ResultStore()
    g = SG.StoreGuard(store, scfg=scfg)
    try:
        with P.faults.injected("storeguard.probe", every=1):
            rec = {"probe": g.probe_once(), "down": g.state == SG.DOWN}
            g.rpush("u1", "fsm:frontier:results:u1", "[1]")
            g.set("u1", "fsm:frontier:u1", '{"meta": 1}')
            rec["held"] = (store.peek("fsm:frontier:u1"), g.spool_entries())
            g.tick()
            rec["still"] = (g.state == SG.DOWN, g.spool_entries())
        g.tick()
        rec["healed"] = (g.state == SG.HEALTHY, g.drained(),
                         store.lrange("fsm:frontier:results:u1"),
                         store.peek("fsm:frontier:u1"))
        return rec
    finally:
        SG.uninstall()


@covers("storeguard.probe")
@pytest.mark.parametrize("pkg", NAMES)
def test_storeguard_probe_fault_drives_down_then_recovers_clean(pkg):
    assert _held(pkg, _storeguard_probe_scenario) == {
        "probe": "unreachable", "down": True, "held": (None, 2),
        "still": (True, 2), "healed": (True, True, ["[1]"], '{"meta": 1}')}


def _storeguard_replay_scenario(P):
    SG = P.storeguard
    SG.uninstall()
    scfg = P.config.parse_config({"storeguard": {
        "enabled": True, "probe_every_s": 0, "down_after": 1}}).storeguard
    store = P.store.ResultStore()
    g = SG.StoreGuard(store, scfg=scfg)
    ctl = P.jobctl.register("rpl-1")
    try:
        with P.faults.injected("storeguard.probe", every=1):
            assert g.probe_once() == "unreachable"
        g.rpush("rpl-1", "fsm:frontier:results:rpl-1", "[1, 2]")
        g.set("rpl-1", "fsm:frontier:rpl-1",
              json.dumps({"results_total": 2, "results_inline": [],
                          "stack": []}))
        spooled = g.spool_entries()
        with P.faults.injected("storeguard.replay", nth=2):
            g.tick()
        return {"spooled": spooled,
                "healthy": g.state == SG.HEALTHY and g.drained(),
                "fenced": ctl.lease_lost,
                "meta": store.peek("fsm:frontier:rpl-1"),
                "resume": P.actors.StoreCheckpoint(store, "rpl-1").load()}
    finally:
        P.jobctl.release("rpl-1")
        SG.uninstall()


@covers("storeguard.replay")
@pytest.mark.parametrize("pkg", NAMES)
def test_storeguard_replay_fault_degrades_terminal_never_corrupt(pkg):
    assert _held(pkg, _storeguard_replay_scenario) == {
        "spooled": 2, "healthy": True, "fenced": True, "meta": None,
        "resume": None}


# ------------------------------------------------------------ store.corrupt


def _bitrot_checkpoint_scenario(P):
    store = P.store.ResultStore()
    ckpt = P.actors.StoreCheckpoint(store, "rot-1", every_s=0.0)
    a, b, c = [[[[1]], 3]], [[[[1], [2]], 2]], [[[[2]], 2]]
    ckpt.save({"version": 1, "stack": [{"x": 1}], "results_done": 0,
               "results": list(a)})
    ckpt.save({"version": 1, "stack": [{"x": 2}], "results_done": 1,
               "results": list(b)})
    ckpt.save({"version": 1, "stack": [], "results_done": 2,
               "results": list(c)})
    before = P.faults.counters()
    with P.faults.injected("store.corrupt", nth=2,
                           match="fsm:frontier:results:"):
        healed = ckpt.load()
    assert healed is not None, "corrupt delta must heal, not restart"
    rec = {"healed": (healed["results"], healed["stack"]),
           "chunks": store.llen("fsm:frontier:results:rot-1"),
           "quarantine": store.peek(
               "fsm:quarantine:frontier:results:rot-1#1") is not None,
           "again": ckpt.load()["results"],
           "site": _delta(P, "store.corrupt", before)}
    ckpt.save({"version": 1, "stack": [], "results_done": 2,
               "results": list(c)})
    rec["resumed"] = ckpt.load()["results"]
    return rec


@covers("store.corrupt")
@pytest.mark.parametrize("pkg", NAMES)
def test_bitrot_checkpoint_delta_heals_to_last_good_snapshot(pkg):
    a, b, c = [[[[1]], 3]], [[[[1], [2]], 2]], [[[[2]], 2]]
    assert _held(pkg, _bitrot_checkpoint_scenario) == {
        "healed": (a + b, [{"x": 2}]), "chunks": 1, "quarantine": True,
        "again": a + b, "site": {"calls": 2, "injected": 1},
        "resumed": a + b + c}


def _bitrot_rescache_scenario(P):
    RC = P.resultcache
    store = P.store.ResultStore()
    payload = json.dumps([[[[1]], 5]])
    ent = json.dumps({"algo": "SPADE_TPU", "kind": "patterns", "params": {},
                      "n_sequences": 10, "uid": "u-rot",
                      "digest": P.rule_trie.rules_digest(payload),
                      "ts": 1.0, "payload": payload})
    key = RC.entry_key("fp-rot", "SPADE_TPU")
    store.set(key, P.envelope.wrap(ent))
    RC.write_sidecar(store, key, json.loads(ent), len(ent))
    rec = {"intact": RC.open_entry(store, "fp-rot", "SPADE_TPU") is not None}
    with P.faults.injected("store.corrupt", nth=1, match="fsm:rescache:"):
        rec["rotten"] = RC.open_entry(store, "fp-rot", "SPADE_TPU")
    rec["gone"] = (store.peek(key), store.peek(RC.sidecar_key_for(key)))
    rec["kept"] = store.peek(
        "fsm:quarantine:rescache:fp-rot:SPADE_TPU") is not None
    rec["later"] = RC.open_entry(store, "fp-rot", "SPADE_TPU")
    return rec


@covers("store.corrupt")
@pytest.mark.parametrize("pkg", NAMES)
def test_bitrot_rescache_entry_quarantined_never_served(pkg):
    assert _held(pkg, _bitrot_rescache_scenario) == {
        "intact": True, "rotten": None, "gone": (None, None), "kept": True,
        "later": None}
