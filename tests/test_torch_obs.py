"""The flight recorder and the cluster plane on the port
(``spark_fsm_tpu_torch/utils/obs.py``, ``service/obsplane.py``), against
the reference's ``tests/test_obs.py`` and ``tests/test_obsplane.py``.

Each scenario is one test parametrised over the two packages
(``_torch_cluster_rig.PKGS``): it runs once with each package's modules
(engines on the CPU) on the same seeded input and returns a record; the
port's record must equal the reference's (``Twins.held``).  The census
tests hold Queue C 9: the span sites of a traced mine's dump equal the
reference's on the TSR host loop, the TSR kernel path, the SPADE queue
route (with and without the records fetch past the prefix) and a TSR
mine through the fusion broker, and on the port the ``tsr.prep`` and
``tsr.launch`` spans count ``kernel_launches``.

Named exceptions (ROADMAP "Known differences"): the queue route's
``kernel_launches`` (one B1 launch a wave on the port, one dispatch a
mine in the reference) is left out of the census record, and so are the
port's ``b1.launch`` spans, one a launch, which the census holds to
``kernel_launches`` on the port instead; the port has no
``fsm_tsr_resident_fallbacks_total`` family (no resident-round
fallback, ``ops/resident_frontier.py``).
"""

import collections
import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from _torch_cluster_rig import (NAMES, PKGS, PortOnCpu, Twins, assert_covers,
                                await_terminal)

_EXTRA = {"tsr": "models.tsr", "queue": "models.spade_queue"}
# modules the reference imports only when a route first needs them; both
# packages import them before a scrape so the family sets compare
_LAZY = ("streaming.consumer", "parallel.partition", "ops.resident_frontier")
# the one family the port leaves out by design (no resident-round
# fallback: spark_fsm_tpu_torch/ops/resident_frontier.py)
PORT_ABSENT_FAMILIES = {"fsm_tsr_resident_fallbacks_total"}


def _ns(name):
    P = PKGS[name]
    root = "spark_fsm_tpu_torch" if name == "port" else "spark_fsm_tpu"
    ns = types.SimpleNamespace(**vars(P))
    for attr, mod in _EXTRA.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.root = root
    return ns


C = {name: _ns(name) for name in NAMES}
T = Twins(C)


@pytest.fixture(autouse=True)
def _planes_reset():
    """Both packages start from tracing-off defaults and leave no trace
    rings, spine sink, SLO windows, injections or brokers behind."""
    with PortOnCpu():
        was = {n: P.obs.tracing_enabled() for n, P in C.items()}
        for P in C.values():
            P.faults.disarm()
            P.fusion.configure(None)
        yield
        for n, P in C.items():
            P.obs.configure_tracing(was[n], max_spans=512, max_jobs=16)
            P.obs.clear_traces()
            P.obsplane.uninstall()
            P.obsplane.clear_slo()
            P.faults.disarm()
            b = P.fusion.broker()
            if b is not None:
                b.release()
                assert b.drain(10.0)
            P.fusion.configure(None)


def _tsr(P, db, kernel: bool = False, **kw):
    """The TSR engine at ``kernel``: the reference's ``use_pallas`` (its
    Pallas kernel in interpret mode off the TPU), the port's kernel path
    on the CPU (``use_kernel`` set after construction, B2's plain
    version on the CPU tensors)."""
    vdb = P.vertical.build_vertical(db, min_item_support=1)
    if P.name == "reference":
        return P.tsr.TsrTPU(vdb, 10, 0.4, max_side=2, use_pallas=kernel,
                            **kw)
    eng = P.tsr.TsrTorch(vdb, 10, 0.4, max_side=2, device="cpu", **kw)
    eng.use_kernel = kernel
    return eng


def _queue(P, db, minsup):
    vdb = P.vertical.build_vertical(db, min_item_support=minsup)
    if P.name == "reference":
        return P.queue.QueueSpadeTPU(vdb, minsup)
    return P.queue.QueueSpadeTorch(vdb, minsup, device="cpu")


# ------------------------------------------------------------ registry


def _histogram_bucket_edges(P):
    h = P.obs.Histogram("fsm_test_edges_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.10001, 1.0, 10.0, 11.0):
        h.observe(v)
    by_le = {dict(key)["le"]: val
             for suffix, key, val in h.samples() if suffix == "_bucket"}
    assert by_le == {"0.1": 2, "1": 4, "10": 5, "+Inf": 6}
    counts = {s: v for s, key, v in h.samples() if s == "_count"}
    sums = {s: v for s, key, v in h.samples() if s == "_sum"}
    assert counts["_count"] == 6
    assert abs(sums["_sum"] - 22.25001) < 1e-9
    return {"by_le": by_le, "count": counts["_count"],
            "sum": round(sums["_sum"], 9)}


@pytest.mark.parametrize("pkg", NAMES)
def test_histogram_bucket_edges(pkg):
    T.held(pkg, _histogram_bucket_edges)


def _raises(fn) -> str:
    try:
        fn()
    except Exception as exc:  # the record names the class
        return type(exc).__name__
    return "no error"


def _histogram_rejects_bad_edges(P):
    got = [_raises(lambda: P.obs.Histogram("fsm_test_bad_seconds",
                                           buckets=(1.0, 1.0))),
           _raises(lambda: P.obs.Histogram("fsm_test_bad2_seconds",
                                           buckets=()))]
    assert got == ["ValueError"] * 2
    return {"errors": got}


@pytest.mark.parametrize("pkg", NAMES)
def test_histogram_rejects_bad_edges(pkg):
    T.held(pkg, _histogram_rejects_bad_edges)


def _fresh_counter_emits_zero_sample(P):
    c = P.obs.REGISTRY.counter("fsm_test_untouched_total")
    rec = {"sample": ("", (), 0.0) in c.samples(),
           "scraped": "fsm_test_untouched_total 0"
           in P.obs.REGISTRY.render_prometheus()}
    assert rec == {"sample": True, "scraped": True}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_fresh_counter_emits_zero_sample(pkg):
    T.held(pkg, _fresh_counter_emits_zero_sample)


def _histogram_bucket_mismatch_raises(P):
    R = P.obs.REGISTRY
    a = R.histogram("fsm_test_ladder_seconds", buckets=(0.5, 5.0))
    same = R.histogram("fsm_test_ladder_seconds", buckets=(0.5, 5.0)) is a
    err = _raises(lambda: R.histogram("fsm_test_ladder_seconds",
                                      buckets=(1.0, 2.0)))
    assert same and err == "ValueError"
    return {"same": same, "mismatch": err}


@pytest.mark.parametrize("pkg", NAMES)
def test_histogram_bucket_mismatch_raises(pkg):
    T.held(pkg, _histogram_bucket_mismatch_raises)


def _registry_enforces_naming_scheme(P):
    O = P.obs
    got = [_raises(lambda: O.Counter("jobs_total")),
           _raises(lambda: O.Counter("fsm_Bad_Case")),
           _raises(lambda: O.REGISTRY.counter(
               "fsm_trace_spans_total").inc(-1)),
           _raises(lambda: O.REGISTRY.gauge("fsm_trace_spans_total"))]
    assert got == ["ValueError"] * 4
    return {"errors": got}


@pytest.mark.parametrize("pkg", NAMES)
def test_registry_enforces_naming_scheme(pkg):
    T.held(pkg, _registry_enforces_naming_scheme)


def _collector_failure_does_not_break_scrape(P):
    P.obs.REGISTRY.register_collector("_test_boom", lambda: 1 / 0)
    try:
        ok = "fsm_trace_spans_total" in P.obs.REGISTRY.render_prometheus()
    finally:
        P.obs.REGISTRY.register_collector("_test_boom", lambda: [])
    assert ok
    return {"scraped": ok}


@pytest.mark.parametrize("pkg", NAMES)
def test_collector_failure_does_not_break_scrape(pkg):
    T.held(pkg, _collector_failure_does_not_break_scrape)


# ------------------------------------------------------ flight recorder


def _ring_eviction_order(P):
    O = P.obs
    O.configure_tracing(True, max_spans=3, max_jobs=4)
    with O.trace("job-ring"):
        for i in range(6):
            with O.span("step", i=i):
                pass
    dump = O.trace_dump("job-ring")
    rec = {"sites": [s["site"] for s in dump["spans"]],
           "i": [s.get("attrs", {}).get("i") for s in dump["spans"]][:2],
           "dropped": dump["dropped_spans"], "n": dump["n_spans"]}
    assert rec == {"sites": ["step", "step", "job"], "i": [4, 5],
                   "dropped": 4, "n": 3}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_ring_eviction_order(pkg):
    T.held(pkg, _ring_eviction_order)


def _job_ring_eviction(P):
    O = P.obs
    O.configure_tracing(True, max_spans=8, max_jobs=2)
    for uid in ("j1", "j2", "j3"):
        with O.trace(uid):
            pass
    rec = {uid: O.trace_dump(uid) is not None for uid in ("j1", "j2", "j3")}
    rec["last"] = O.last_trace_id()
    assert rec == {"j1": False, "j2": True, "j3": True, "last": "j3"}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_job_ring_eviction(pkg):
    T.held(pkg, _job_ring_eviction)


def _thread_safety_concurrent_actor_spans(P):
    O = P.obs
    O.configure_tracing(True, max_spans=200, max_jobs=16)
    n_threads, n_spans = 8, 50
    errors = []

    def work(k):
        try:
            with O.trace(f"job-{k}"):
                for i in range(n_spans):
                    with O.span("step", thread=k, i=i) as sp:
                        sp.event("tick", i=i)
        except Exception as exc:  # the assert below reports it
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    rec = {}
    for k in range(n_threads):
        dump = O.trace_dump(f"job-{k}")
        steps = [s for s in dump["spans"] if s["site"] == "step"]
        assert all(s["attrs"]["thread"] == k for s in steps)
        rec[k] = (len(steps), dump["dropped_spans"],
                  sorted(s["attrs"]["i"] for s in steps) == list(
                      range(n_spans)))
    assert set(rec.values()) == {(n_spans, 0, True)}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_thread_safety_concurrent_actor_spans(pkg):
    T.held(pkg, _thread_safety_concurrent_actor_spans)


def _disabled_cost_pin(P):
    O = P.obs
    O.configure_tracing(False)
    before = O.recorder_stats()
    spans0 = O.REGISTRY.counter("fsm_trace_spans_total").snapshot()
    s1 = O.span("tsr.launch", km=1, width=128)
    s2 = O.span("tsr.readback")
    with s1 as sp:
        sp.event("never_recorded")
        sp.set(x=1)
    O.trace_event("never_recorded")
    with O.trace("ghost-job") as root:
        root.event("nope")
    rec = {"singleton": s1 is s2, "recorder": O.recorder_stats() == before,
           "dump": O.trace_dump("ghost-job"),
           "spans_metric": O.REGISTRY.counter(
               "fsm_trace_spans_total").snapshot() == spans0}
    assert rec == {"singleton": True, "recorder": True, "dump": None,
                   "spans_metric": True}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_cost_pin(pkg):
    T.held(pkg, _disabled_cost_pin)


def _span_without_active_trace_is_noop(P):
    O = P.obs
    O.configure_tracing(True, max_spans=16, max_jobs=4)
    box = []
    t = threading.Thread(
        target=lambda: box.append(O.span("orphan") is O.span("orphan2")))
    t.start()
    t.join()
    O._recorder.begin("explicit", {})
    with O.span("pinned", trace_id="explicit"):
        pass
    rec = {"orphan_noop": box,
           "explicit": [s["site"] for s in O.trace_dump("explicit")["spans"]]}
    assert rec == {"orphan_noop": [True], "explicit": ["pinned"]}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_span_without_active_trace_is_noop(pkg):
    T.held(pkg, _span_without_active_trace_is_noop)


def _scrape_does_not_consume_chaos_triggers(P):
    m = P.actors.Master()
    try:
        none = {"calls": 0, "injected": 0}
        before = P.faults.counters().get("store.get", none)
        with P.faults.injected("store.get", nth=1):
            P.obs.REGISTRY.render_prometheus()
            P.obs.REGISTRY.snapshot()
            after = P.faults.counters().get("store.get", before)
        rec = {k: after.get(k, 0) - before.get(k, 0)
               for k in ("calls", "injected")}
        assert rec == {"calls": 0, "injected": 0}, (before, after)
        return rec
    finally:
        m.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_scrape_does_not_consume_chaos_triggers(pkg):
    T.held(pkg, _scrape_does_not_consume_chaos_triggers)


# ------------------------------------------------- acceptance: OOM trace


def _oom_ladder_trace_dump(P):
    """A traced TSR mine on the kernel path under an armed device.oom:
    the launch span carries the RESOURCE_EXHAUSTED event, its half-width
    re-plan children nest under it, and every launch span carries the
    predicted seconds beside its wall."""
    db = P.synth.synthetic_db(seed=29, n_sequences=60, n_items=14,
                              mean_itemsets=3.0, mean_itemset_size=1.3)
    P.obs.configure_tracing(True, max_spans=4096, max_jobs=4)
    eng = _tsr(P, db, kernel=True)
    with P.faults.injected("device.oom", nth=1):
        with P.obs.trace("oom-mine", algorithm="TSR_TPU"):
            rules = eng.mine()
    spans = P.obs.trace_dump("oom-mine")["spans"]
    oom = [s for s in spans for e in s.get("events", ())
           if e["name"] == "resource_exhausted"]
    assert oom, sorted({s["site"] for s in spans})
    parent = oom[0]
    error = [e for e in parent["events"]
             if e["name"] == "resource_exhausted"][0]["error"]
    kids = [s for s in spans if s["parent_id"] == parent["span_id"]
            and s["site"] == "tsr.launch"]
    launches = [s for s in spans if s["site"] == "tsr.launch"]
    readbacks = [s for s in spans if s["site"] == "tsr.readback"]
    rec = {
        "rules": P.canonical.rules_text(rules),
        "degraded_launches": eng.stats.get("degraded_launches", 0),
        "parent": (parent["site"], parent["attrs"]["width"],
                   parent["attrs"]["point"]),
        "exhausted": "RESOURCE_EXHAUSTED" in error,
        "kid_widths": sorted(k["attrs"]["width"] for k in kids),
        "launches_timed": all("predicted_s" in s["attrs"]
                              and s["duration_s"] is not None
                              for s in launches),
        "readbacks_measured": bool(readbacks) and all(
            "measured_s" in s["attrs"] for s in readbacks),
        "drift_seen": P.obs.costmodel_drift() is not None,
    }
    assert rec["degraded_launches"] >= 1 and rec["exhausted"]
    assert rec["kid_widths"] == [rec["parent"][1] // 2] * 2
    assert rec["launches_timed"] and rec["readbacks_measured"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_oom_ladder_trace_dump(pkg):
    T.held(pkg, _oom_ladder_trace_dump)


# ---------------------------------------- Queue C 9: the span-site census


def _census(P, uid, run):
    P.obs.configure_tracing(True, max_spans=1 << 15, max_jobs=8)
    with P.obs.trace(uid):
        out = run()
    dump = P.obs.trace_dump(uid)
    assert dump["dropped_spans"] == 0
    sites = collections.Counter(s["site"] for s in dump["spans"])
    return out, dict(sorted(sites.items())), dump["spans"]


def _census_db(P):
    return P.synth.synthetic_db(seed=7, n_sequences=50, n_items=12,
                                mean_itemsets=3.0, mean_itemset_size=1.3)


def _tsr_census(P, route):
    """The span sites of a traced TSR mine; tracing moves no counter."""
    db = _census_db(P)
    kernel = route == "kernel"
    base = _tsr(P, db, kernel=kernel)
    want = base.mine()
    eng = _tsr(P, db, kernel=kernel)
    got, sites, _ = _census(P, f"census-{route}", eng.mine)
    assert got == want
    for key in ("kernel_launches", "evaluated", "traffic_units"):
        assert eng.stats[key] == base.stats[key], key
    spans = sites.get("tsr.launch", 0) + sites.get("tsr.prep", 0)
    assert spans == eng.stats["kernel_launches"]
    return {"sites": sites, "kernel_launches": eng.stats["kernel_launches"],
            "rules": P.canonical.rules_text(got)}


@pytest.mark.parametrize("route", ["host", "kernel"])
@pytest.mark.parametrize("pkg", NAMES)
def test_span_launch_count_matches_engine_counter(pkg, route):
    """Queue C 9, TSR: the dump's span sites (``tsr.prep``,
    ``tsr.dispatch``, ``tsr.launch``, ``tsr.readback``) equal the
    reference's on the host loop and on the kernel path, and the
    ``tsr.prep`` + ``tsr.launch`` spans equal ``kernel_launches``."""
    rec = T.held(pkg, _tsr_census, route)
    assert rec["sites"]["tsr.prep"] == 1
    assert rec["sites"]["tsr.dispatch"] == rec["sites"]["tsr.readback"]


# (seed, n_sequences, n_items, mean_itemsets, minsup): records within the
# one-shot prefix, and past it (the second records fetch)
QUEUE_DBS = {"prefix": (17, 120, 10, 3.0, 6), "big_fetch": (3, 60, 5, 9.0, 3)}


def _queue_census(P, which):
    seed, n, ni, mi, minsup = QUEUE_DBS[which]
    db = P.synth.synthetic_db(seed=seed, n_sequences=n, n_items=ni,
                              mean_itemsets=mi, mean_itemset_size=1.3)
    eng = _queue(P, db, minsup)
    got, sites, spans = _census(P, f"census-queue-{which}", eng.mine)
    assert got is not None
    if P.name == "port":
        assert sites.pop("b1.launch") == eng.stats["kernel_launches"]
    fetch = [s["attrs"] for s in spans if s["site"] == "queue.readback"]
    return {"sites": sites, "patterns": P.canonical.patterns_text(got),
            "n_patterns": len(got), "waves": eng.stats["waves"],
            "candidates": eng.stats["candidates"],
            "readback_points": sorted(a.get("point", "") for a in fetch),
            "bound_s": [("bound_s" in a) for a in fetch]}


@pytest.mark.parametrize("which", sorted(QUEUE_DBS))
@pytest.mark.parametrize("pkg", NAMES)
def test_queue_route_span_census(pkg, which):
    """Queue C 9, the SPADE queue route: one ``queue.dispatch`` and one
    ``queue.readback`` (with ``bound_s``) a mine, and a second
    ``queue.readback`` (``point="big_fetch"``) when the records pass the
    one-shot prefix.  ``kernel_launches`` differs by design (one B1
    launch a wave on the port) and is left out of the record, with the
    port's ``b1.launch`` spans, which equal it."""
    rec = T.held(pkg, _queue_census, which)
    big = which == "big_fetch"
    assert (rec["n_patterns"] > 4096) == big
    assert rec["sites"]["queue.readback"] == 1 + big


def _fusion_census(P):
    """A TSR host-loop mine through the fusion broker under a job
    context: the broker's spans land in the job's trace, each dispatch's
    ``tsr.dispatch`` span says ``fusion``, and the engine's own counter
    holds the prep only (the launches are the broker's)."""
    db = _census_db(P)
    want = _tsr(P, db).mine()
    P.fusion.configure(P.config.FusionConfig(enabled=True, window_ms=1.0))
    eng = _tsr(P, db)
    ctl = P.jobctl.register("census-fusion")
    try:
        with P.jobctl.activate(ctl):
            got, sites, spans = _census(P, "census-fusion", eng.mine)
    finally:
        P.jobctl.release("census-fusion")
    assert got == want
    assert all(s["attrs"].get("fusion") is True
               for s in spans if s["site"] == "tsr.dispatch")
    spans_n = sites.get("tsr.launch", 0) + sites.get("tsr.prep", 0)
    assert spans_n == eng.stats["kernel_launches"]
    assert sites["fusion.launch"] == eng.stats["fusion_launches"]
    return {"sites": sites, "kernel_launches": eng.stats["kernel_launches"],
            "fusion_launches": eng.stats["fusion_launches"],
            "rules": P.canonical.rules_text(got)}


@pytest.mark.parametrize("pkg", NAMES)
def test_fusion_route_span_census(pkg):
    T.held(pkg, _fusion_census)


# ------------------------------------------------------- HTTP endpoints


def _serve(P):
    if P.name == "port":
        return P.app.serve_background(device="cpu")
    return P.app.serve_background()


def _metrics_endpoint_and_trace_404(P):
    for mod in _LAZY:
        importlib.import_module(f"{P.root}.{mod}")
    P.obs.configure_tracing(False)
    srv = _serve(P)
    try:
        port = srv.server_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            ctype = r.headers["Content-Type"].split(";")[0]
            text = r.read().decode()
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/admin/trace/nope", timeout=30)
            code, error = 200, ""
        except urllib.error.HTTPError as exc:
            code = exc.code
            error = json.loads(exc.read().decode())["error"]
    finally:
        srv.master.shutdown()
        srv.shutdown()
    families = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
    # families that tests register by hand are left out: other files in
    # the same process may have made them in one package only
    families = {f for f in families if not f.startswith("fsm_test_")}
    if P.name == "port":
        assert not families & PORT_ABSENT_FAMILIES
        families |= PORT_ABSENT_FAMILIES
    rec = {"content_type": ctype, "code": code,
           "tracing_disabled": "tracing disabled" in error,
           "spans_type": "# TYPE fsm_trace_spans_total counter" in text,
           "fault_sites": "fsm_fault_site_calls_total" in text,
           "families": sorted(families)}
    assert rec["content_type"] == "text/plain" and code == 404
    assert rec["spans_type"] and rec["fault_sites"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_metrics_endpoint_and_trace_404(pkg):
    """``/metrics`` and the 404 of a disabled trace; the packages' sets of
    families are equal save ``PORT_ABSENT_FAMILIES``."""
    T.held(pkg, _metrics_endpoint_and_trace_404)


# ================================================== the cluster plane


def _counter(P, name):
    snap = P.obs.REGISTRY.snapshot()[name]
    return sum(snap.values()) if isinstance(snap, dict) else snap


def _rig(P, ttl=10.0):
    t = [0.0]
    store = P.store.ResultStore(clock=lambda: t[0])

    def mk(rid):
        return P.lease.LeaseManager(store, replica_id=rid, lease_ttl_s=ttl,
                                    heartbeat_s=0, clock=lambda: t[0])
    return t, store, mk


def _priority_vocabulary(P):
    assert P.obsplane.PRIORITIES == P.actors.PRIORITIES
    return {"priorities": list(P.obsplane.PRIORITIES)}


@pytest.mark.parametrize("pkg", NAMES)
def test_priority_vocabulary_matches_actors(pkg):
    T.held(pkg, _priority_vocabulary)


def _split_brain_spine(P):
    t, store, mk = _rig(P, ttl=10.0)
    a, b = mk("rep-a"), mk("rep-b")
    plane_a = P.obsplane.TraceSpine(store, a)
    plane_b = P.obsplane.TraceSpine(store, b)
    a.acquire("drill")
    store.journal_set("drill", json.dumps({"replica": "rep-a"}))
    rejected0 = _counter(P, "fsm_lease_fence_rejections_total")
    spine0 = dict(P.obs.REGISTRY.snapshot()["fsm_trace_spine_writes_total"])
    out = [plane_a.flush("drill", [
        {"span_id": 1, "site": "lifecycle.admitted", "ts": 100.0},
        {"span_id": 2, "site": "queue.dispatch", "ts": 101.0}])]
    t[0] = 30.0
    store.journal_set("drill", json.dumps({"replica": "rep-b"}))
    adopted = b.adopt_expired("drill")
    n_chunks = len(store.spine_chunks("drill"))
    out.append(plane_a.flush("drill", [
        {"span_id": 3, "site": "stale.mine", "ts": 130.0}]))
    unchanged = len(store.spine_chunks("drill")) == n_chunks
    a.forget("drill")
    out.append(plane_a.flush("drill", [
        {"span_id": 4, "site": "stale.settled", "ts": 131.0}]))
    out.append(plane_b.flush("drill", [
        {"span_id": 1, "site": "lifecycle.adopted", "ts": 140.0},
        {"span_id": 2, "site": "job", "ts": 141.0}]))
    merged = P.obsplane.merged_timeline(store, "drill")
    tok = {s["replica"]: s["token"] for s in merged["spans"]}
    spine = P.obs.REGISTRY.snapshot()["fsm_trace_spine_writes_total"]
    rec = {"flushes": out, "adopted": adopted, "unchanged": unchanged,
           "sites": [s["site"] for s in merged["spans"]],
           "ts": [s["ts"] for s in merged["spans"]],
           "replicas": merged["replicas"],
           "tokens_rise": tok["rep-b"] > tok["rep-a"],
           "rejected": _counter(P, "fsm_lease_fence_rejections_total")
           - rejected0,
           "spine": {k: spine[k] - spine0.get(k, 0) for k in spine}}
    assert rec["flushes"] == ["ok", "fenced", "fenced", "ok"]
    assert rec["adopted"] is True and rec["unchanged"]
    assert "stale.mine" not in rec["sites"]
    assert rec["ts"] == sorted(rec["ts"]) and rec["tokens_rise"]
    assert rec["rejected"] > 0 and rec["spine"]["outcome=fenced"] >= 2
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_split_brain_spine_appends_are_fenced(pkg):
    T.held(pkg, _split_brain_spine)


def _spine_unleased_uid(P):
    _, store, mk = _rig(P)
    plane = P.obsplane.TraceSpine(store, mk("rep-a"))
    out = plane.flush("stream:topic", [
        {"span_id": 9, "site": "stream.push", "ts": 1.0}])
    chunk = json.loads(P.envelope.unwrap(
        store.spine_chunks("stream:topic")[0])[0])
    rec = {"flush": out, "token": chunk["token"], "replica": chunk["replica"]}
    assert rec == {"flush": "ok", "token": None, "replica": "rep-a"}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_spine_unleased_uid_writes_with_null_token(pkg):
    T.held(pkg, _spine_unleased_uid)


def _spine_retention(P):
    _, store, mk = _rig(P)
    plane = P.obsplane.TraceSpine(store, mk("rep-a"), max_chunks=3)
    outs = [plane.flush("u", [{"span_id": i, "site": "s", "ts": float(i)}])
            for i in range(7)]
    chunks = P.obsplane.spine_chunks(store, "u")
    rec = {"flushes": outs,
           "kept": [c["spans"][0]["span_id"] for c in chunks]}
    assert rec == {"flushes": ["ok"] * 7, "kept": [4, 5, 6]}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_spine_retention_keeps_newest_chunks(pkg):
    T.held(pkg, _spine_retention)


def _merged_timeline_dedupes(P):
    _, store, mk = _rig(P)
    a = mk("rep-a")
    plane = P.obsplane.TraceSpine(store, a)
    spans = [{"span_id": 1, "site": "job.submit", "ts": 10.0},
             {"span_id": 2, "site": "job", "ts": 11.0}]
    out = [plane.flush("u", spans)]
    local = {"trace_id": "u", "attrs": {"algorithm": "SPADE"},
             "dropped_spans": 0,
             "spans": spans + [{"span_id": 3, "site": "job.sink",
                                "ts": 12.0}]}
    merged = P.obsplane.merged_timeline(store, "u", local,
                                        replica_id="rep-a",
                                        boot_id=plane.boot_id)
    plane2 = P.obsplane.TraceSpine(store, a)
    out.append(plane2.flush("u", [{"span_id": 1, "site": "job.resumed",
                                   "ts": 20.0}]))
    merged2 = P.obsplane.merged_timeline(store, "u")
    rec = {"flushes": out, "n": merged["n_spans"],
           "ids": [s["span_id"] for s in merged["spans"]],
           "attrs": merged["attrs"], "boots_differ":
           plane2.boot_id != plane.boot_id, "n2": merged2["n_spans"],
           "sites2": [s["site"] for s in merged2["spans"]]}
    assert rec["n"] == 3 and rec["ids"] == [1, 2, 3] and rec["n2"] == 3
    assert rec["boots_differ"] and "job.resumed" in rec["sites2"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_merged_timeline_dedupes_local_ring_against_spine(pkg):
    T.held(pkg, _merged_timeline_dedupes)


def _sliding_quantiles(P):
    t = [1000.0]
    sq = P.obs.SlidingQuantiles(window_s=60.0, max_samples=512,
                                clock=lambda: t[0])
    for i in range(100):
        sq.observe(i / 100.0, priority="high")
    rec = {"full": sq.stats(priority="high")}
    t[0] += 120.0
    rec["aged"] = sq.stats(priority="high")
    sq.observe(5.0, priority="high")
    rec["burst"] = sq.stats(priority="high")["count"]
    rec["low"] = sq.stats(priority="low")
    rec["zero_window"] = _raises(
        lambda: P.obs.SlidingQuantiles(window_s=0))
    assert rec["full"]["count"] == 100 and rec["full"]["max"] == 0.99
    assert abs(rec["full"]["p99"] - 0.98) < 0.02
    assert rec["aged"] == {"count": 0} and rec["burst"] == 1
    assert rec["zero_window"] == "ValueError"
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_sliding_quantiles_window_and_exactness(pkg):
    T.held(pkg, _sliding_quantiles)


def _observe_job_feeds_histograms(P):
    P.obsplane.clear_slo()
    key = "priority=high,tenant=default"
    h0 = P.obs.REGISTRY.snapshot()["fsm_job_e2e_seconds"]
    P.obsplane.observe_job("high", 2.0, 0.5, 1.5)
    P.obsplane.observe_job("high", 4.0, 1.0, 3.0)
    snap = P.obsplane.slo_snapshot()
    h1 = P.obs.REGISTRY.snapshot()["fsm_job_e2e_seconds"]
    row = snap["priorities"]["high"]
    rec = {"high": row, "low": snap["priorities"]["low"]["e2e"],
           "count": h1[key]["count"] - h0[key]["count"],
           "low_seeded": "priority=low,tenant=default" in h1,
           "adoption_family": "fsm_job_time_to_adoption_seconds_count"
           in P.obs.REGISTRY.render_prometheus()}
    assert row["e2e"]["count"] == 2 and row["e2e"]["p99"] == 4.0
    assert rec["count"] == 2 and rec["low_seeded"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_observe_job_feeds_histograms_and_slo_snapshot(pkg):
    T.held(pkg, _observe_job_feeds_histograms)


def _tenant_label(P):
    P.obsplane.clear_slo()
    P.obsplane.seed_tenant("gold")
    h = P.obs.REGISTRY.snapshot()["fsm_job_e2e_seconds"]
    seeded = all(f"priority={p},tenant=gold" in h
                 for p in P.obsplane.PRIORITIES)
    P.obsplane.observe_job("normal", 3.0, 1.0, 2.0, tenant="gold")
    P.obsplane.observe_job("normal", 9.0, 1.0, 8.0, tenant="nope")
    h = P.obs.REGISTRY.snapshot()["fsm_job_e2e_seconds"]
    snap = P.obsplane.slo_snapshot()
    rec = {"seeded": seeded,
           "gold_count": h["priority=normal,tenant=gold"]["count"] >= 1,
           "nope_label": any(",tenant=nope" in k for k in h),
           "gold": snap["tenants"]["gold"],
           "default": snap["tenants"]["default"]["count"]}
    P.obsplane.clear_slo()
    assert rec["seeded"] and rec["gold_count"] and not rec["nope_label"]
    assert rec["gold"]["count"] == 1 and rec["gold"]["p99"] == 3.0
    assert rec["default"] == 1
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_tenant_label_and_per_tenant_slo_quantiles(pkg):
    T.held(pkg, _tenant_label)


def _slo_digest(P):
    P.obsplane.clear_slo()
    empty = P.obsplane.slo_digest()
    P.obsplane.observe_job("high", 1.0, 0.1, 0.9)
    P.obsplane.observe_job("low", 7.0, 0.1, 6.9)
    rec = {"empty": empty, "digest": P.obsplane.slo_digest()}
    P.obsplane.clear_slo()
    assert rec == {"empty": {"p99": None, "n": 0},
                   "digest": {"p99": 7.0, "n": 2}}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_slo_digest_compact_and_heartbeat_merge_shape(pkg):
    T.held(pkg, _slo_digest)


def _adoption_and_steal(P):
    before = P.obs.REGISTRY.snapshot()
    P.obsplane.observe_adoption(2.5)
    P.obsplane.observe_steal_latency(0.4)
    after = P.obs.REGISTRY.snapshot()
    rec = {fam: after[fam]["all"]["count"] - before[fam]["all"]["count"]
           for fam in ("fsm_job_time_to_adoption_seconds",
                       "fsm_job_steal_latency_seconds")}
    assert rec == {"fsm_job_time_to_adoption_seconds": 1,
                   "fsm_job_steal_latency_seconds": 1}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_adoption_and_steal_histograms_seeded_and_observable(pkg):
    T.held(pkg, _adoption_and_steal)


class _FakeMiner:
    def __init__(self, queued=0, running=0, workers=2, sheds=0.0,
                 ewma=None):
        self._q, self._r, self._w = queued, running, workers
        self._sheds, self._ewma = sheds, ewma

    def queue_size(self):
        return self._q

    def running_count(self):
        return self._r

    def worker_count(self):
        return self._w

    def idle_capacity(self):
        return max(0, self._w - self._r - self._q)

    def sheds_total(self):
        return self._sheds

    def wall_ewma(self):
        return self._ewma


def _cluster_view(P):
    t, store, mk = _rig(P, ttl=10.0)
    a, b = mk("rep-a"), mk("rep-b")
    a._miner = _FakeMiner(queued=3, running=1, workers=2, sheds=5,
                          ewma=0.8)
    b._miner = _FakeMiner(queued=0, running=0, workers=4)
    b.acquire("held-job")
    a.publish_heartbeat()
    b.publish_heartbeat()
    view = a.cluster_view(max_age_s=0)
    rows = {r["replica"]: r for r in view["replicas"]}
    fams = {name: rows_ for name, kind, help, rows_
            in P.obsplane._cluster_collector(a)()}
    totals = dict(view["totals"])
    rec = {"totals": {k: totals[k] for k in (
        "replicas", "queued", "running", "free", "held", "sheds")},
        "churn": totals["lease_churn"] >= 1,
        "self": rows["rep-a"]["self"], "b_held": rows["rep-b"]["held"],
        "gauges": {f: fams[f][0][1] for f in (
            "fsm_cluster_replicas", "fsm_cluster_queue_depth",
            "fsm_cluster_in_flight", "fsm_cluster_leases_held")}}
    t[0] = 30.0
    rec["after_expiry"] = b.cluster_view(max_age_s=0)["totals"]["replicas"]
    sv = b.shed_view()
    rec["shed"] = (sv["replicas"], "peer_free" in sv)
    assert rec["totals"] == {"replicas": 2, "queued": 3, "running": 1,
                             "free": 4, "held": 1, "sheds": 5}
    assert rec["churn"] and rec["self"] is True and rec["b_held"] == 1
    assert rec["after_expiry"] == 1 and rec["shed"] == (1, True)
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_cluster_view_aggregates_heartbeat_snapshots(pkg):
    T.held(pkg, _cluster_view)


def _shed_view(P):
    t, store, mk = _rig(P)
    a, b = mk("rep-a"), mk("rep-b")
    b._miner = _FakeMiner(workers=4)
    b.publish_heartbeat()
    a._peers_cache = (-1e18, [])
    sv = a.shed_view()
    assert sv == {"replica": "rep-a", "replicas": 2, "peer_free": 4,
                  "peer_queued": 0}
    return {"shed": sv}


@pytest.mark.parametrize("pkg", NAMES)
def test_shed_view_reports_peer_free_capacity(pkg):
    T.held(pkg, _shed_view)


def _lifecycle_spine_end_to_end(P):
    P.obs.configure_tracing(True, max_spans=512, max_jobs=8)
    P.obsplane.clear_slo()
    store = P.store.ResultStore()
    mgr = P.lease.LeaseManager(store, replica_id="solo1", lease_ttl_s=30,
                               heartbeat_s=0)
    miner = P.actors.Miner(store, workers=1, queue_depth=8, lease_mgr=mgr)
    try:
        miner.submit(P.model.ServiceRequest("fsm", "train", {
            "algorithm": "SPADE", "source": "INLINE",
            "sequences": "1 -1 2 -2\n1 -1 2 -2\n", "support": "1.0",
            "uid": "solo-job", "priority": "high"}))
        status = await_terminal(store, "solo-job")
        deadline = time.time() + 10.0
        while time.time() < deadline:
            chunks = P.obsplane.spine_chunks(store, "solo-job")
            sites = {s["site"] for c in chunks for s in c["spans"]}
            if "job" in sites:
                break
            time.sleep(0.01)
        tokens = [json.loads(P.envelope.unwrap(raw)[0])["token"]
                  for raw in store.spine_chunks("solo-job")]
        merged = P.obsplane.merged_timeline(
            store, "solo-job", P.obs.trace_dump("solo-job"),
            replica_id="solo1", boot_id=P.obsplane.plane().boot_id)
        ids = [(s["replica"], s["span_id"]) for s in merged["spans"]]
        ts = [s["ts"] for s in merged["spans"]]
        slo = P.obsplane.slo_snapshot()["priorities"]["high"]
        want = ("job.submit", "lifecycle.admitted", "lifecycle.started",
                "lifecycle.settled", "job")
        rec = {"status": status, "marks": {w: w in sites for w in want},
               "first_token_held": tokens[0] is not None,
               "no_duplicates": len(ids) == len(set(ids)),
               "ordered": ts == sorted(ts),
               "slo": (slo["e2e"]["count"] >= 1,
                       slo["queue_wait"]["count"] >= 1),
               "patterns": store.patterns("solo-job")}
        assert status == "finished" and all(rec["marks"].values()), sites
        assert rec["no_duplicates"] and rec["ordered"]
        assert rec["slo"] == (True, True)
        return rec
    finally:
        miner.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_miner_writes_lifecycle_spine_and_slo_end_to_end(pkg):
    T.held(pkg, _lifecycle_spine_end_to_end)


def _no_spine_flush_without_install(P):
    P.obsplane.uninstall()
    P.obs.configure_tracing(True, max_spans=16, max_jobs=4)
    with P.obs.trace("plain-job"):
        with P.obs.span("step"):
            pass
    P.obs.flush_trace("plain-job")
    rec = {"pending": P.obs._recorder.take_pending("plain-job"),
           "n": P.obs.trace_dump("plain-job")["n_spans"]}
    assert rec == {"pending": [], "n": 2}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_no_spine_flush_without_install(pkg):
    T.held(pkg, _no_spine_flush_without_install)


def test_twin_covers_every_reference_test():
    assert_covers(globals(), "test_obs.py", "test_obsplane.py")
