"""The engines' service planes in the port, on the CPU, beside the
reference's: TSR's OOM half-width ladder, the dispatch watchdog, the
fusion broker's fault posture, usage conservation, the cost model's
families and the resident route's registry counters.

Mirrors the reference's ``tests/test_chaos.py`` (the ``device.oom``,
``device.dispatch`` hang and ``fusion.dispatch`` scenarios) and
``tests/test_usage.py`` (conservation under fusion and under solo
dispatch).  The OOM ladder lives on TSR's kernel path: on the CPU an
engine takes it when ``use_kernel`` is set after construction, and B2's
wrapper runs its plain version on the CPU tensors, as the reference's
``use_pallas=True`` runs its Pallas kernel in interpret mode off the
TPU."""

import threading
import time

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data.vertical import build_vertical as j_build_vertical
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.ops import ragged_batch as JRB
from spark_fsm_tpu.ops import resident_frontier as JRF
from spark_fsm_tpu.utils import faults as JF
from spark_fsm_tpu.utils import obs as JO
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch import config as TC
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models import tsr as TT
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.models.spade_queue import QueueSpadeTorch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_torch
from spark_fsm_tpu_torch.ops import ragged_batch as RB
from spark_fsm_tpu_torch.ops import resident_frontier as RF
from spark_fsm_tpu_torch.service import fusion as FZ
from spark_fsm_tpu_torch.service import usage
from spark_fsm_tpu_torch.service.store import ResultStore
from spark_fsm_tpu_torch.utils import faults, jobctl, obs, watchdog
from spark_fsm_tpu_torch.utils.canonical import patterns_text, rules_text

DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _planes_hygiene():
    """No injection, watchdog policy, broker or meter leaks in or out."""
    faults.disarm()
    watchdog.configure(slack=None)
    FZ.configure(None)
    usage.uninstall()
    yield
    faults.disarm()
    watchdog.configure(slack=None)
    b = FZ.broker()
    if b is not None:
        b.release()
        assert b.drain(10.0)
    FZ.configure(None)
    usage.uninstall()
    TC.set_config(TC.parse_config({}))


def _oom_db():
    return synthetic_db(seed=29, n_sequences=60, n_items=14,
                        mean_itemsets=3.0, mean_itemset_size=1.3)


def _rule_db():
    return synthetic_db(seed=23, n_sequences=40, n_items=7,
                        mean_itemsets=3.0, mean_itemset_size=1.2)


def _kernel_path(db, k, **kw):
    """A CPU TSR engine on the kernel path (lane 128, flat cap)."""
    eng = TT.TsrTorch(build_vertical(db, min_item_support=1), k, 0.4,
                      device="cpu", **kw)
    eng.use_kernel = True
    return eng


# ----------------------------------------------------------- device.oom


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.00 GiB"),
    faults.InjectedOom("device.oom"),
], ids=["cuda_oom", "injected"])
def test_is_oom_knows_the_cards_own_error(exc):
    """The reference's test reads RESOURCE_EXHAUSTED in the message,
    which the card's own OOM does not carry; the port's also knows the
    type."""
    assert RB.is_oom(exc)
    assert JT._is_oom(exc) == isinstance(exc, faults.InjectedOom)
    assert not RB.is_oom(RuntimeError("CUDA error: invalid argument"))


def test_oom_degradation_ladder_halves_width():
    eng = _kernel_path(_oom_db(), 10, max_side=2)
    m = min(eng.item_cap, eng.vdb.n_items)
    eng.chunk = eng._round_chunk(m)
    p1, s1 = eng._prep(m)
    cands = [((i,), (j,)) for i in range(m) for j in range(m) if i != j]
    assert len(cands) > 128, "need a launch wider than the ladder floor"
    width = RB.next_pow2(len(cands))
    launch = RB.Launch(1, width, list(range(len(cands))), [1] * len(cands))

    def dispatch():
        parts, cols = [], np.empty(len(cands), np.int64)
        base = eng._dispatch_kernel_launch(p1, s1, cands, launch, parts,
                                           cols, 0, [])
        arr = torch.cat(parts, dim=1).numpy()
        return base, len(parts), arr[0, cols], arr[1, cols]

    _, n0, sup0, supx0 = dispatch()  # fault-free baseline
    assert n0 == 1
    with faults.injected("device.oom", nth=1):
        base, n, sup, supx = dispatch()
    assert eng.stats["degraded_launches"] == 1
    assert (base, n) == (len(cands), 2)  # two half-width launches
    np.testing.assert_array_equal(sup, sup0)
    np.testing.assert_array_equal(supx, supx0)
    # a launch at the floor width cannot halve: the OOM raises
    floor = RB.Launch(1, 128, list(range(100)), [1] * 100)
    with faults.injected("device.oom", nth=1):
        with pytest.raises(faults.InjectedOom):
            eng._dispatch_kernel_launch(p1, s1, cands, floor, [],
                                        np.empty(len(cands), np.int64), 0,
                                        [])


def test_oom_mid_mine_equals_reference():
    """An injected OOM on the first kernel launch of a mine: the ladder
    absorbs it in both packages alike (``degraded_launches``) and the
    rule texts are byte-identical to the fault-free mine's."""
    db = _oom_db()
    want = _kernel_path(db, 10, max_side=2).mine()
    eng = _kernel_path(db, 10, max_side=2)
    with faults.injected("device.oom", nth=1):
        got = eng.mine()
    ref = JT.TsrTPU(j_build_vertical(db, min_item_support=1), 10, 0.4,
                    max_side=2, use_pallas=True)
    with JF.injected("device.oom", nth=1):
        ref_got = ref.mine()
    assert rules_text(got) == rules_text(want) == j_rules_text(ref_got)
    assert eng.stats["degraded_launches"] == ref.stats["degraded_launches"]
    assert eng.stats["degraded_launches"] >= 1
    assert not any(k.startswith("pallas_fallback") for k in ref.stats)


def test_oom_on_a_fused_launch_halves_it():
    """With fusion on, the broker launches the kernel path's waves: an
    injected OOM on the first (cross-job) launch halves it through the
    same ladder as the direct path, the jobs' rule texts stay those of
    their fault-free mines, and the halving lands in ``degraded_launches``
    of the jobs whose wave it carried."""
    dbs = {"a": _oom_db(), "b": synthetic_db(seed=37, n_sequences=60,
                                             n_items=14, mean_itemsets=3.0,
                                             mean_itemset_size=1.3)}
    want = {k: _kernel_path(db, 10, max_side=2).mine()
            for k, db in dbs.items()}
    FZ.configure(TC.FusionConfig(enabled=True, window_ms=250.0))
    b = FZ.broker()
    # the process keeps one broker, whose counters run across tests
    s0 = dict(b.stats)
    b.hold()
    engs = {k: _kernel_path(db, 10, max_side=2) for k, db in dbs.items()}
    out = {}
    ts = [threading.Thread(target=lambda k=k: out.setdefault(
        k, engs[k].mine())) for k in engs]
    with faults.injected("device.oom", nth=1):
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
    for k in dbs:
        assert rules_text(out[k]) == rules_text(want[k])
    assert b.stats["cross_job_launches"] - s0["cross_job_launches"] >= 1
    # absorbed by the ladder, no re-dispatch
    assert b.stats["degraded"] == s0["degraded"]
    assert engs["a"].stats.get("degraded_launches", 0) >= 1
    assert engs["b"].stats.get("degraded_launches", 0) >= 1


# ------------------------------------------------------ device.dispatch


def test_dispatch_hang_fails_launch_via_watchdog():
    """A hung readback must not wedge the worker: the watchdog deadline
    fails the launch with WatchdogTimeout, and a retry is exact."""
    db = _rule_db()
    want = TT.mine_tsr_torch(db, 8, 0.4, max_side=2, device="cpu")
    wd0 = watchdog.stats()
    watchdog.configure(slack=100.0, floor_s=0.5)
    eng = TT.TsrTorch(build_vertical(db, min_item_support=1), 8, 0.4,
                      max_side=2, device="cpu")
    with faults.injected("device.dispatch", nth=1, match="readback",
                         delay_s=90.0, exc="none"):
        t0 = time.monotonic()
        with pytest.raises(watchdog.WatchdogTimeout):
            eng.mine()
        wall = time.monotonic() - t0
    wd = watchdog.stats()
    assert wd["timeouts"] >= wd0["timeouts"] + 1
    assert wd["leaked_threads"] >= wd0["leaked_threads"] + 1
    assert wall < 60.0  # the 90 s hang was not waited out
    got = TT.mine_tsr_torch(db, 8, 0.4, max_side=2, device="cpu")
    assert rules_text(got) == rules_text(want)


# ------------------------------------------------------ fusion.dispatch


def test_fusion_dispatch_fault_degrades_group_to_solo_with_parity():
    db_a = _rule_db()
    db_b = synthetic_db(seed=29, n_sequences=40, n_items=7,
                        mean_itemsets=3.0, mean_itemset_size=1.2)
    mk = lambda db: TT.TsrTorch(build_vertical(db, min_item_support=1),  # noqa: E731
                                8, 0.4, max_side=2, device="cpu")
    want_a, want_b = mk(db_a).mine(), mk(db_b).mine()
    FZ.configure(TC.FusionConfig(enabled=True, window_ms=250.0))
    b = FZ.broker()
    degraded0 = b.stats["degraded"]
    b.hold()
    out = {}
    ts = [threading.Thread(target=lambda k=k, db=db: out.setdefault(
        k, mk(db).mine())) for k, db in (("a", db_a), ("b", db_b))]
    with faults.injected("fusion.dispatch", nth=1, match="window"):
        for t in ts:
            t.start()
        deadline = time.monotonic() + DEADLINE_S
        while b.pending() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.pending() >= 2
        b.release()
        for t in ts:
            t.join(DEADLINE_S)
            assert not t.is_alive(), "degraded mine wedged"
    assert rules_text(out["a"]) == rules_text(want_a)
    assert rules_text(out["b"]) == rules_text(want_b)
    assert b.stats["degraded"] > degraded0


def test_fusion_dispatch_fault_queue_wave_degrades_direct():
    db = synthetic_db(seed=17, n_sequences=120, n_items=10,
                      mean_itemsets=3.0, mean_itemset_size=1.3)
    vdb = build_vertical(db, min_item_support=6)
    want = QueueSpadeTorch(vdb, 6, device="cpu").mine()
    assert want is not None
    FZ.configure(TC.FusionConfig(enabled=True))
    b = FZ.broker()
    degraded0 = b.stats["degraded"]
    with faults.injected("fusion.dispatch", nth=1, match="queue"):
        got = QueueSpadeTorch(vdb, 6, device="cpu").mine()
    assert got is not None
    assert patterns_text(got) == patterns_text(want)
    assert patterns_text(got) == patterns_text(mine_spade(db, 6))
    assert b.stats["degraded"] > degraded0


# ---------------------------------------------------------------- usage


def _install():
    TC.set_config(TC.parse_config({"usage": {"enabled": True,
                                             "flush_every_s": 0.0}}))
    m = usage.install(ResultStore(), None)
    m.stop()  # deterministic flushes only
    return m


def _job(uid, tenant):
    ctl = jobctl.register(uid)
    ctl.tenant = tenant
    return ctl


def _table_wave(uid, *, base, m=8, cands=None, n_seq=64):
    cands = cands if cands is not None else [((0,), (1,)), ((2, 3), (4,))]
    rows = torch.arange(m, dtype=torch.int32)[:, None] + base
    ones = torch.full((1, 1), -1, dtype=torch.int32)
    pools = {}
    for r, (x, y) in enumerate(cands):
        km = RB.next_pow2(max(len(x), len(y)))
        pools.setdefault(km, []).append(r)

    def evaluate(km):
        def fn(p1, s1, xy):
            live = xy >= 0
            t, s = p1[:, 0].long(), s1[:, 0].long()
            return torch.stack([
                torch.where(live[:, 0], t[xy[:, 0].clamp(min=0).long()],
                            0).sum(1),
                torch.where(live[:, 1], s[xy[:, 1].clamp(min=0).long()],
                            0).sum(1)])
        return fn

    return FZ.EvalWave(uid=uid, priority="normal", cands=cands, pools=pools,
                       p1=torch.cat([rows, ones]),
                       s1=torch.cat([rows + 100_000, ones]),
                       eval_fn=evaluate, put=torch.from_numpy,
                       cap=lambda km: 8192, lane=32, n_seq=n_seq, n_words=1)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "solo"])
def test_usage_conservation(fused):
    """Per-job attribution sums exactly to the broker's own launch and
    traffic counters, under a cross-job fused window and under a
    cost-model-rejected window dispatched per job."""
    _install()
    b = FZ.FusionBroker(window_s=0.25, max_jobs=8, max_width=16384)
    b.hold()
    uids = ("cons-a", "cons-b")
    _job(uids[0], "acme")
    _job(uids[1], "globex")
    try:
        if fused:
            waves = [_table_wave(uids[0], base=1),
                     _table_wave(uids[1], base=1000,
                                 cands=[((1,), (0,)), ((4,), (2, 5)),
                                        ((6, 7), (3,))])]
        else:
            waves = [_table_wave(uids[0], base=1, m=8192, n_seq=990_000),
                     _table_wave(uids[1], base=7, m=8192, n_seq=990_000)]
        for w in waves:
            b.submit(w)
        b.release()
        for w in waves:
            w.result()
        if fused:
            assert b.stats["fused_groups"] == 1
            assert b.stats["cross_job_launches"] >= 1
        else:
            assert b.stats["rejected_groups"] == 1
            assert b.stats["solo_waves"] == 2
        vecs = [usage.settle(u) for u in uids]
        assert all(v is not None for v in vecs)
        assert sum(v["launches"] for v in vecs) == b.stats["launches"]
        assert (sum(v["traffic_units"] for v in vecs)
                == b.stats["traffic_units"])
        assert all(v["launches"] >= 1 for v in vecs) or fused
        assert sum(v["device_seconds_measured"] for v in vecs) > 0.0
    finally:
        for u in uids:
            jobctl.release(u)


def test_engine_dispatches_deposit_usage():
    """A TSR host-loop mine, a resident mine and a SPAM mine under a job
    context each deposit their launches and traffic."""
    _install()
    db = _rule_db()
    for uid, run in (
            ("use-tsr", lambda s: TT.mine_tsr_torch(
                db, 8, 0.4, max_side=2, device="cpu", stats_out=s)),
            ("use-res", lambda s: TT.mine_tsr_torch(
                db, 8, 0.4, resident="always", device="cpu", stats_out=s)),
            ("use-spam", lambda s: mine_spam_torch(
                db, 2, device="cpu", density_crossover=0.5, stats_out=s))):
        _job(uid, "acme")
        try:
            s = {}
            with jobctl.activate(jobctl.get(uid)):
                run(s)
            vec = usage.settle(uid)
        finally:
            jobctl.release(uid)
        assert vec is not None and vec["launches"] >= 1, (uid, vec)
        assert vec["traffic_units"] > 0 and vec["readback_bytes"] > 0
        if uid == "use-res":
            assert s.get("resident") is True
            assert vec["launches"] == s["resident_segments"]


# ------------------------------------------------------------ cost model


def test_costmodel_families():
    """TSR's direct readbacks feed the global EWMA and the tsr-eval
    family; resident segments and SPAM waves feed their family gauges
    only; a fused group feeds tsr-fused."""
    db = _rule_db()
    TT.mine_tsr_torch(db, 8, 0.4, max_side=2, device="cpu")
    fam = obs.costmodel_family_drift()
    assert "tsr-eval" in fam and obs.costmodel_drift() is not None
    before = obs.costmodel_drift()
    s = {}
    TT.mine_tsr_torch(db, 8, 0.4, resident="always", device="cpu",
                      stats_out=s)
    mine_spam_torch(db, 2, device="cpu", density_crossover=0.5)
    assert s.get("resident") is True
    fam = obs.costmodel_family_drift()
    assert {"tsr-resident", "spam"} <= set(fam)
    assert obs.costmodel_drift() == before  # family-only surfaces
    b = FZ.FusionBroker(window_s=0.25, max_jobs=8, max_width=16384)
    b.hold()
    waves = [_table_wave("fam-a", base=1), _table_wave("fam-b", base=50)]
    for w in waves:
        b.submit(w)
    b.release()
    for w in waves:
        w.result()
    assert "tsr-fused" in obs.costmodel_family_drift()
    assert obs.COSTMODEL_FAMILIES == JO.COSTMODEL_FAMILIES


# ------------------------------------------------------- resident route


def _resident_counts(rf):
    out = {}
    for metric in (rf._SEGMENTS, rf._WAVES, rf._SPILLS, rf._DEFERRED,
                   rf._HANDOFFS, rf._READBACK):
        for _, key, value in metric.samples():
            out[(metric.name, key)] = value
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def test_resident_registry_counters_equal_reference():
    """The fsm_tsr_resident_* families move by what the reference's move
    after the same resident mine, and the exported counters agree."""
    db = synthetic_db(seed=5, n_sequences=120, n_items=10,
                      mean_itemsets=3.0)
    deltas = []
    for pkg, mine, rf in (("ref", JT.mine_tsr_tpu, JRF),
                          ("port", TT.mine_tsr_torch, RF)):
        c0 = _resident_counts(rf)
        s = {}
        kw = {} if pkg == "ref" else {"device": "cpu"}
        got = mine(db, 8, 0.5, max_side=None, resident="always",
                   stats_out=s, **kw)
        deltas.append((_delta(c0, _resident_counts(rf)),
                       (rules_text if pkg == "port" else j_rules_text)(got),
                       {k: s.get(k, 0) for k in TT.RESIDENT_EXPORT_KEYS}))
    assert deltas[1] == deltas[0]
    assert deltas[1][0][("fsm_tsr_resident_segments_total", ())] >= 1


def test_planner_counters_equal_reference():
    """The fsm_planner_* families count a host-loop mine's launches as the
    reference's count its jnp path's."""
    db = _rule_db()
    cal = JRB._CALIBRATE
    JRB.set_overhead_calibration(False)
    try:
        got = []
        for rb, mine, kw in ((JRB, JT.mine_tsr_tpu, {}),
                             (RB, TT.mine_tsr_torch, {"device": "cpu"})):
            c0 = (rb._PLAN_LAUNCHES.total(), rb._PLAN_SUPERBATCHES.total())
            mine(db, 8, 0.4, max_side=2, **kw)
            got.append((rb._PLAN_LAUNCHES.total() - c0[0],
                        rb._PLAN_SUPERBATCHES.total() - c0[1]))
        assert got[1] == got[0] and got[1][0] >= 1
    finally:
        JRB.set_overhead_calibration(cal)
