"""The usage meter on the port (``spark_fsm_tpu_torch/service/usage.py``
and its deposit sites in the engines, the fusion broker and the
predictor), against the reference's ``tests/test_usage.py``.

Each scenario is one test parametrised over the two packages
(``_torch_cluster_rig.PKGS``) and returns a record (per-job vectors,
tenant rollups, ledger rows, the ``fsm_usage_*`` counters it moved); the
port's record must equal the reference's.  Launches and traffic units
compare exactly; seconds only as ``> 0`` (they are walls).

The conservation scenarios feed each broker its own package's waves:
the reference's table-lookup waves are numpy, the port's are torch
(``test_torch_planes._table_wave``, whose port-only test holds the sums;
here the per-job split is held against the reference's too).  The port's
broker bills a launch per leaf of its OOM ladder (``service/fusion.py``,
``_launch_solo`` and ``_attribute_fused``), where the reference has no
ladder in its broker; ``test_conservation_exact_under_halved_fused_launch``
holds that the sum still equals the broker's launch counter exactly
(ROADMAP "Known differences").
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from _torch_cluster_rig import NAMES, PKGS, PortOnCpu, Twins, assert_covers
from test_torch_planes import _oom_db, _kernel_path, _table_wave

C = PKGS
T = Twins(C, families=("fsm_usage_launches", "fsm_usage_traffic_units",
                       "fsm_usage_flushes"))
DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _usage_hygiene():
    """No meter or broker leaks across tests, in either package: the
    engines probe module globals, so a leaked install would bill every
    later dispatch in the session."""
    with PortOnCpu():
        for P in C.values():
            P.usage.uninstall()
            P.fusion.configure(None)
        yield
        for P in C.values():
            b = P.fusion.broker()
            if b is not None:
                b.release()
                assert b.drain(10.0), "fusion broker still busy at exit"
            P.fusion.configure(None)
            P.usage.uninstall()
            P.config.set_config(P.config.parse_config({}))
            P.faults.disarm()


def _install(P, store=None):
    P.config.set_config(P.config.parse_config(
        {"usage": {"enabled": True, "flush_every_s": 0.0}}))
    m = P.usage.install(store if store is not None
                        else P.store.ResultStore(), None)
    m.stop()  # deterministic flushes only (flush_now / tick)
    return m


@contextlib.contextmanager
def _jobs(P, *uids_tenants):
    ctls = []
    for uid, tenant in uids_tenants:
        ctl = P.jobctl.register(uid)
        ctl.tenant = tenant
        ctls.append(ctl)
    try:
        yield ctls
    finally:
        for uid, _ in uids_tenants:
            P.jobctl.release(uid)


def _vec(v):
    """A settled vector with its seconds read as "> 0"."""
    if v is None:
        return None
    return {k: (val > 0 if "seconds" in k else val)
            for k, val in sorted(v.items())}


# ----------------------------------------------------- apportionment unit


def _split_integral(P):
    split = P.usage.split_integral
    rec = {"fixed": [split(7, [3, 2, 2]), split(1, [2, 1, 1]),
                     split(1, [1, 1]), split(10, [0, 0]), split(0, [5, 3]),
                     split(3, [])]}
    rng = np.random.default_rng(7)
    sweep = []
    for _ in range(200):
        n = int(rng.integers(1, 9))
        total = int(rng.integers(0, 10_000))
        weights = [float(w) for w in rng.random(n)]
        out = split(total, weights)
        assert sum(out) == total and all(v >= 0 for v in out)
        sweep.append(out)
    rec["sweep"] = sweep
    assert rec["fixed"] == [[3, 2, 2], [1, 0, 0], [1, 0], [5, 5], [0, 0],
                            []]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_split_integral_is_exact_and_deterministic(pkg):
    T.held(pkg, _split_integral)


# -------------------------------------------------- conservation invariant


def _np_table_eval(km):
    def fn(p1, s1, xy):
        t = np.asarray(p1)[:, 0].astype(np.int64)
        s = np.asarray(s1)[:, 0].astype(np.int64)
        xyn = np.asarray(xy)
        xs = np.where(xyn[:, 0] >= 0, t[np.maximum(xyn[:, 0], 0)], 0)
        ys = np.where(xyn[:, 1] >= 0, s[np.maximum(xyn[:, 1], 0)], 0)
        return np.stack([xs.sum(axis=1), ys.sum(axis=1)])
    return fn


def _wave(P, uid, *, base, m=8, cands=None, n_seq=64):
    """The reference test's table-lookup wave, in each package's own
    tensors (numpy for the reference, torch for the port)."""
    if P.name == "port":
        return _table_wave(uid, base=base, m=m, cands=cands, n_seq=n_seq)
    p1 = np.arange(m, dtype=np.uint32)[:, None] + np.uint32(base)
    cands = cands if cands is not None else [((0,), (1,)), ((2, 3), (4,))]
    pools = {}
    for r, (x, y) in enumerate(cands):
        km = 1
        while km < max(len(x), len(y)):
            km *= 2
        pools.setdefault(km, []).append(r)
    return P.fusion.EvalWave(uid=uid, priority="normal", cands=cands,
                             pools=pools, p1=p1, s1=p1 + np.uint32(100_000),
                             eval_fn=_np_table_eval, put=lambda x: x,
                             cap=lambda km: 8192, lane=32, n_seq=n_seq,
                             n_words=1)


def _conservation(P, mode):
    _install(P)
    b = P.fusion.FusionBroker(window_s=0.25, max_jobs=8, max_width=16384)
    b.hold()
    uids = (("cons-a", "acme"), ("cons-b", "globex"))
    with _jobs(P, *uids):
        if mode == "fused":
            waves = [_wave(P, "cons-a", base=1),
                     _wave(P, "cons-b", base=1000,
                           cands=[((1,), (0,)), ((4,), (2, 5)),
                                  ((6, 7), (3,))])]
        else:
            waves = [_wave(P, "cons-a", base=1, m=8192, n_seq=990_000),
                     _wave(P, "cons-b", base=7, m=8192, n_seq=990_000)]
        for w in waves:
            b.submit(w)
        b.release()
        results = [w.result() for w in waves]
        vecs = {uid: P.usage.settle(uid) for uid, _ in uids}
    st = b.stats
    rec = {"broker": {k: st[k] for k in (
        "fused_groups", "rejected_groups", "solo_waves", "launches",
        "traffic_units", "cross_job_launches")},
        "jobs": {u: _vec(v) for u, v in vecs.items()},
        "sups": [[np.asarray(r[0]).tolist(), np.asarray(r[1]).tolist()]
                 for r in results]}
    got = {k: sum(v[k] for v in vecs.values())
           for k in ("launches", "traffic_units")}
    assert got == {"launches": st["launches"],
                   "traffic_units": st["traffic_units"]}
    assert sum(v["device_seconds_measured"] for v in vecs.values()) > 0.0
    if mode == "fused":
        assert st["fused_groups"] == 1 and st["cross_job_launches"] >= 1
    else:
        assert st["rejected_groups"] == 1 and st["solo_waves"] == 2
        assert all(v["launches"] >= 1 for v in vecs.values())
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_conservation_exact_under_cross_job_fusion(pkg):
    T.held(pkg, _conservation, "fused")


@pytest.mark.parametrize("pkg", NAMES)
def test_conservation_exact_under_degraded_solo_dispatch(pkg):
    T.held(pkg, _conservation, "solo")


def test_conservation_exact_under_halved_fused_launch():
    """The port's broker halves a launch that runs out of device memory
    and bills each leaf (the reference's broker has no ladder): two jobs'
    first fused launch under an injected OOM, and the per-tenant launches
    and traffic still sum exactly to the broker's counters."""
    P = C["port"]
    _install(P)
    dbs = {"a": _oom_db(), "b": P.synth.synthetic_db(
        seed=37, n_sequences=60, n_items=14, mean_itemsets=3.0,
        mean_itemset_size=1.3)}
    P.fusion.configure(P.config.FusionConfig(enabled=True, window_ms=250.0))
    b = P.fusion.broker()
    # the process keeps one broker, whose counters run across tests
    s0 = dict(b.stats)
    b.hold()
    engs = {k: _kernel_path(db, 10, max_side=2) for k, db in dbs.items()}
    launches0 = P.usage._LAUNCHES.total()
    with _jobs(P, ("half-a", "acme"), ("half-b", "globex")) as ctls:
        def mine(k, ctl):
            with P.jobctl.activate(ctl):
                engs[k].mine()

        ts = [threading.Thread(target=mine, args=(k, ctl))
              for k, ctl in zip(engs, ctls)]
        with P.faults.injected("device.oom", nth=1):
            for t in ts:
                t.start()
            deadline = time.monotonic() + DEADLINE_S
            while b.pending() < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert b.pending() >= 2
            b.release()
            for t in ts:
                t.join(DEADLINE_S)
                assert not t.is_alive(), "fused mine wedged"
        vecs = [P.usage.settle(u) for u in ("half-a", "half-b")]
    assert engs["a"].stats.get("degraded_launches", 0) >= 1
    launches = b.stats["launches"] - s0["launches"]
    assert sum(v["launches"] for v in vecs) == launches
    assert (sum(v["traffic_units"] for v in vecs)
            == b.stats["traffic_units"] - s0["traffic_units"])
    assert P.usage._LAUNCHES.total() - launches0 == launches


def _tenant_rollup(P):
    m = _install(P)
    P.obsplane.seed_tenant("acme")
    before = P.usage._LAUNCHES.total()
    with _jobs(P, ("ctr-1", "acme")):
        P.usage.deposit("ctr-1", launches=5, traffic_units=640,
                        seconds_measured=0.25)
        vec = P.usage.settle("ctr-1")
    rep = m.report()
    rec = {"vec": _vec(vec), "counter": P.usage._LAUNCHES.total() - before,
           "acme": (rep["tenants"]["acme"]["launches"],
                    rep["tenants"]["acme"]["traffic_units"])}
    assert rec["counter"] == vec["launches"] == 5
    assert rec["acme"] == (5, 640)
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_conservation_counters_match_tenant_rollup(pkg):
    T.held(pkg, _tenant_rollup)


# ------------------------------------------------ kill -9 / adoption drill


def _adoption(P):
    store = P.store.ResultStore()
    _install(P, store)
    uid = "adopt-1"
    P.obsplane.seed_tenant("acme")
    with _jobs(P, (uid, "acme")):
        P.usage.deposit(uid, launches=4, traffic_units=400,
                        seconds_est=0.4, seconds_measured=0.5)
        ckpt = P.actors.StoreCheckpoint(store, uid, every_s=0.0)
        ckpt.save({"stack": [1, 2], "fingerprint": "fp", "results": [],
                   "results_done": 0})
        P.usage.drop(uid)
    with _jobs(P, (uid, "acme")):
        state = P.actors.StoreCheckpoint(store, uid).load()
        adopted = P.usage.job_view(uid)
        P.usage.deposit(uid, launches=2, traffic_units=100,
                        seconds_measured=0.1)
        vec = P.usage.settle(uid)
        P.usage.flush_now()
        row = P.usage.get().ledger_rows(store)["acme"]
    first = (row["jobs"][uid]["launches"], row["totals"]["launches"])
    with _jobs(P, (uid, "acme")):
        P.usage.deposit(uid, launches=3, traffic_units=50)
        P.usage.settle(uid)
        P.usage.flush_now()
        row = P.usage.get().ledger_rows(store)["acme"]
    rec = {"stripped": state is not None and "usage" not in state,
           "adopted": adopted["launches"],
           "vec": (vec["launches"], vec["traffic_units"]),
           "ledger": first,
           "replaced": (row["jobs"][uid]["launches"],
                        row["totals"]["launches"])}
    assert rec == {"stripped": True, "adopted": 4, "vec": (6, 500),
                   "ledger": (6, 6), "replaced": (3, 3)}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_attribution_survives_checkpoint_adoption_no_double_billing(pkg):
    T.held(pkg, _adoption)


def _fenced_drop(P):
    m = _install(P)
    with _jobs(P, ("fence-1", "acme")):
        P.usage.deposit("fence-1", launches=7, traffic_units=10)
        P.usage.drop("fence-1")
        settled = P.usage.settle("fence-1")
    rec = {"settled": settled, "acme": m.report()["tenants"].get(
        "acme", {}).get("launches", 0)}
    assert rec == {"settled": None, "acme": 0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_fenced_holder_drops_without_settling(pkg):
    T.held(pkg, _fenced_drop)


# ------------------------------------------------------------ avoided cost


def _avoided(P):
    m = _install(P)
    P.obsplane.seed_tenant("acme")
    before = P.usage._AVOIDED.total()
    for mode, secs in (("exact", 0.5), ("dominated", 0.25),
                       ("coalesced", 0.125)):
        P.usage.credit_avoided("acme", secs, mode)
    first = m.report()["tenants"]["acme"]["avoided_device_seconds"]
    moved = P.usage._AVOIDED.total() - before
    P.usage.credit_avoided("nobody-registered-this", 0.5, "exact")
    P.usage.credit_avoided("acme", -1.0, "exact")
    rep = m.report()["tenants"]
    rec = {"acme": first, "counter": round(moved, 9),
           "default": rep["default"]["avoided_device_seconds"],
           "acme_after": rep["acme"]["avoided_device_seconds"]}
    assert rec == {"acme": pytest.approx(0.875), "counter": 0.875,
                   "default": pytest.approx(0.5),
                   "acme_after": pytest.approx(0.875)}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_avoided_cost_credits_per_mode(pkg):
    T.held(pkg, _avoided)


# ---------------------------------------------------------- disabled path


def _disabled(P):
    U = P.usage
    assert U.get() is None
    before = U._LAUNCHES.total()
    U.deposit("ghost", launches=5, traffic_units=100, seconds_measured=1.0)
    U.deposit_tenant("acme", launches=3)
    U.credit_avoided("acme", 1.0, "exact")
    rec = {"settle": U.settle("ghost"), "view": U.job_view("ghost"),
           "snapshot": U.checkpoint_snapshot("ghost")}
    U.resume("ghost", {"launches": 9})
    U.drop("ghost")
    U.tick()
    rec.update(flush=U.flush_now(), report=U.report(), stats=U.stats(),
               counter=U._LAUNCHES.total() - before)
    P.fusion.FusionBroker._attribute_fused([], [], 0.0, 0.0)
    assert rec == {"settle": None, "view": None, "snapshot": None,
                   "flush": 0, "report": {"enabled": False}, "stats": None,
                   "counter": 0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_disabled_path_is_one_global_read(pkg):
    T.held(pkg, _disabled)


def _config_validation(P):
    parse = P.config.parse_config
    errors = []
    for bad in ({"window_s": 0}, {"flush_every_s": -1}, {"top_jobs": 0}):
        try:
            parse({"usage": bad})
            errors.append("accepted")
        except ValueError:
            errors.append("ValueError")
    cfg = parse({"usage": {"enabled": True}})
    rec = {"errors": errors, "enabled": cfg.usage.enabled,
           "window_s": cfg.usage.window_s}
    assert rec == {"errors": ["ValueError"] * 3, "enabled": True,
                   "window_s": 300.0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_config_validation(pkg):
    T.held(pkg, _config_validation)


# ------------------------------------------- per-family cost-model drift


def _family_drift(P):
    O = P.obs
    O._family_ewma.pop("tsr-resident", None)
    O._family_ewma.pop("tsr-eval", None)
    samples = O._COSTMODEL_SAMPLES.total()
    global_drift = O.costmodel_drift()
    O.observe_costmodel_family("tsr-resident", 0.1, 0.3)
    rec = {"samples_still": O._COSTMODEL_SAMPLES.total() == samples,
           "global_still": O.costmodel_drift() == global_drift,
           "resident": round(O.costmodel_family_drift()["tsr-resident"], 9)}
    O.observe_costmodel_family("not-a-family", 0.1, 0.2)
    O.observe_costmodel_family("spam", 0.0, 0.2)
    rec["unknown_dropped"] = "not-a-family" not in O.costmodel_family_drift()
    O.observe_costmodel(0.2, 0.2, family="tsr-eval")
    rec["samples_moved"] = O._COSTMODEL_SAMPLES.total() - samples
    rec["eval_seen"] = O.costmodel_family_drift()["tsr-eval"] > 0.0
    rec["families"] = list(O.COSTMODEL_FAMILIES)
    assert rec["samples_still"] and rec["global_still"]
    assert rec["resident"] == pytest.approx(3.0)
    assert rec["unknown_dropped"] and rec["samples_moved"] == 1
    assert rec["eval_seen"]
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_family_drift_isolated_from_global_ewma(pkg):
    T.held(pkg, _family_drift)


# ---------------------------------------------------------- read path


def _jobless(P):
    store = P.store.ResultStore()
    m = _install(P, store)
    P.obsplane.seed_tenant("acme")
    P.usage.deposit_tenant("acme", launches=1, traffic_units=256,
                           seconds_measured=0.01)
    P.usage.deposit_tenant("unregistered", launches=1)
    rep = m.report(store)
    row = P.usage.get().ledger_rows(store)["acme"]
    rec = {"acme": rep["tenants"]["acme"]["launches"],
           "default": rep["tenants"]["default"]["launches"],
           "ledger": row["totals"]["launches"],
           "read_path": row["read_path"]["traffic_units"],
           "second_flush": P.usage.flush_now()}
    assert rec == {"acme": 1, "default": 1, "ledger": 1, "read_path": 256,
                   "second_flush": 0}
    return rec


@pytest.mark.parametrize("pkg", NAMES)
def test_jobless_deposit_folds_to_tenant_and_flushes(pkg):
    T.held(pkg, _jobless)


def test_twin_covers_every_reference_test():
    assert_covers(globals(), "test_usage.py")
