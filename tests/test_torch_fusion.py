"""Cross-job launch fusion in the port (``spark_fsm_tpu_torch/service/
fusion.py``) against the reference's broker, on the CPU.

The reference's ``tests/test_fusion.py`` at three altitudes, each run
through both packages where the outcome is deterministic:

- broker unit (table-lookup waves, no device work): the fused group
  demuxes per job, a ``high`` wave never waits out the window, the window
  closes on ``max_jobs``/``max_width``, the cost model rejects an
  unprofitable group, one job's pipelined waves fuse without a cross-job
  label; the broker's stats and its ``fsm_fusion_*`` counts equal the
  reference broker's under ``hold()``/``release()`` (the reference's live
  overhead recalibration pinned off: the port's factor is 1);
- engines: two TSR mines lined up in a held window fuse, each rule text
  byte-identical to its solo mine, to the reference's and to brute force;
  a lone wave plans the launches the direct path plans; the resident
  route never waits in a window;
- the service: two ``/train`` jobs through a two-worker Master fuse.

Plus the fused store's layout (the port's prep stores end in an all-ones
row that the reference's do not have): two jobs whose candidates leave
slots of ``xy`` unused (-1), fused, give each job the (sup, supx) of its
solo launch and of the reference broker."""

import threading
import time

import numpy as np
import pytest
import torch

from spark_fsm_tpu import config as JC
from spark_fsm_tpu.data.vertical import build_vertical as j_build_vertical
from spark_fsm_tpu.models.tsr import TsrTPU, mine_tsr_tpu
from spark_fsm_tpu.ops import ragged_batch as JRB
from spark_fsm_tpu.service import fusion as JFZ
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch import config as TC
from spark_fsm_tpu_torch.data.spmf import format_spmf
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models.tsr import (
    TsrTorch, brute_force_rules, mine_tsr_torch)
from spark_fsm_tpu_torch.ops import rule_support as RS
from spark_fsm_tpu_torch.ops.ragged_batch import next_pow2
from spark_fsm_tpu_torch.service import fusion as TFZ
from spark_fsm_tpu_torch.service.actors import Master
from spark_fsm_tpu_torch.service.model import (
    ServiceRequest, deserialize_rules)
from spark_fsm_tpu_torch.service.store import ResultStore
from spark_fsm_tpu_torch.utils import jobctl
from spark_fsm_tpu_torch.utils.canonical import rules_text

DEADLINE_S = 60.0
PACKAGES = (JFZ, TFZ)


@pytest.fixture(autouse=True)
def _fusion_hygiene():
    """No broker policy leaks in or out, and the reference's plan-time
    overhead is its committed constant (the port's never recalibrates)."""
    calibrate = JRB._CALIBRATE
    JRB.set_overhead_calibration(False)
    for fz in PACKAGES:
        fz.configure(None)
    yield
    for fz in PACKAGES:
        b = fz.broker()
        if b is not None:
            b.release()
            assert b.drain(10.0), "fusion broker still busy at test exit"
        fz.configure(None)
    JRB.set_overhead_calibration(calibrate)


def _enable(fz, **kw):
    cfgmod = JC if fz is JFZ else TC
    fz.configure(cfgmod.FusionConfig(enabled=True, **kw))
    return fz.broker()


# ------------------------------------------------------- synthetic waves
#
# Table-lookup evaluators in place of device work: p1/s1 rows carry
# distinctive per-job values and the evaluator sums each lane's gathered
# rows, so a lane resolved to the wrong job changes the numbers.  The
# port's tables are int32 tensors with the all-ones last row of its
# stores; the reference's are its [m, 1] uint32 arrays.


def _ref_eval(km):
    def fn(p1, s1, xy):
        t = np.asarray(p1)[:, 0].astype(np.int64)
        s = np.asarray(s1)[:, 0].astype(np.int64)
        xyn = np.asarray(xy)
        xs = np.where(xyn[:, 0] >= 0, t[np.maximum(xyn[:, 0], 0)], 0)
        ys = np.where(xyn[:, 1] >= 0, s[np.maximum(xyn[:, 1], 0)], 0)
        return np.stack([xs.sum(axis=1), ys.sum(axis=1)])
    return fn


def _port_eval(km):
    def fn(p1, s1, xy):
        t, s = p1[:, 0].long(), s1[:, 0].long()
        live = xy >= 0
        xs = torch.where(live[:, 0], t[xy[:, 0].clamp(min=0).long()], 0)
        ys = torch.where(live[:, 1], s[xy[:, 1].clamp(min=0).long()], 0)
        return torch.stack([xs.sum(1), ys.sum(1)])
    return fn


def _pools(cands):
    pools = {}
    for r, (x, y) in enumerate(cands):
        side = max(len(x), len(y))
        km = 1
        while km < side:
            km *= 2
        pools.setdefault(km, []).append(r)
    return pools


def _wave(fz, uid, *, base, m=8, cands=None, priority="normal", n_seq=64):
    cands = cands if cands is not None else [((0,), (1,)), ((2, 3), (4,))]
    if fz is JFZ:
        p1 = (np.arange(m, dtype=np.uint32)[:, None] + np.uint32(base))
        s1 = p1 + np.uint32(100_000)
        ev, put = _ref_eval, (lambda x: x)
    else:
        rows = torch.arange(m, dtype=torch.int32)[:, None] + base
        ones = torch.full((1, 1), -1, dtype=torch.int32)
        p1 = torch.cat([rows, ones])
        s1 = torch.cat([rows + 100_000, ones])
        ev, put = _port_eval, torch.from_numpy
    return fz.EvalWave(uid=uid, priority=priority, cands=cands,
                       pools=_pools(cands), p1=p1, s1=s1, eval_fn=ev,
                       put=put, cap=lambda km: 8192, lane=32, n_seq=n_seq,
                       n_words=1)


def _check(wave):
    sups, supxs, report = wave.result()
    t = np.asarray(wave.p1)[:, 0].astype(np.int64)
    s = np.asarray(wave.s1)[:, 0].astype(np.int64)
    assert sups.tolist() == [sum(int(t[i]) for i in x) for x, _ in wave.cands]
    assert supxs.tolist() == [sum(int(s[j]) for j in y)
                              for _, y in wave.cands]
    return {k: v for k, v in report.items() if k != "window_wait_s"}


def _fusion_counts(fz):
    """The broker's registry counters (``fsm_fusion_*``), per series."""
    out = {}
    for metric in (fz._WAVES_TOTAL, fz._LAUNCHES_TOTAL, fz._DEGRADED_TOTAL,
                   fz._REJECTED_TOTAL):
        for _, key, value in metric.samples():
            out[(metric.name, key)] = value
    return out


def _held_group(fz, waves, **broker_kw):
    """Submit ``waves`` into a held window of a fresh broker, release it,
    and return (reports, broker stats, fsm_fusion_* deltas)."""
    c0 = _fusion_counts(fz)
    b = fz.FusionBroker(**broker_kw)
    b.hold()
    for w in waves:
        b.submit(w)
    assert b.pending() == len(waves)
    b.release()
    reports = [_check(w) for w in waves]
    assert b.drain(10.0)
    c1 = _fusion_counts(fz)
    delta = {k: v - c0.get(k, 0.0) for k, v in c1.items()
             if v != c0.get(k, 0.0)}
    return reports, dict(b.stats), delta


def _both_held(make_waves, **broker_kw):
    got = [_held_group(fz, make_waves(fz), **broker_kw) for fz in PACKAGES]
    assert got[1] == got[0]
    return got[1]


def test_fused_group_demuxes_per_job():
    reports, stats, _ = _both_held(
        lambda fz: [_wave(fz, "job-a", base=1),
                    _wave(fz, "job-b", base=1000,
                          cands=[((1,), (0,)), ((4,), (2, 5)),
                                 ((6, 7), (3,))])],
        window_s=0.25, max_jobs=8, max_width=16384)
    r1, r2 = reports
    assert r1["fused_jobs"] == 2 and r2["fused_jobs"] == 2
    assert r1["cross_job_launches"] >= 1
    assert stats["fused_groups"] == 1 and stats["cross_job_launches"] >= 1


def test_high_priority_never_waits_out_the_window():
    b = TFZ.FusionBroker(window_s=30.0, max_jobs=8, max_width=16384)
    lo = _wave(TFZ, "job-lo", base=1, priority="low")
    b.submit(lo)
    time.sleep(0.25)
    assert not lo.done, "a lone low wave must wait for the window"
    t0 = time.monotonic()
    hi = _wave(TFZ, "job-hi", base=500, priority="high")
    b.submit(hi)
    _check(hi)
    _check(lo)
    assert time.monotonic() - t0 < 10.0
    assert b.stats["waves"] == 2


def test_window_closes_on_max_jobs_and_width():
    b = TFZ.FusionBroker(window_s=30.0, max_jobs=2, max_width=16384)
    t0 = time.monotonic()
    b.submit(_wave(TFZ, "a", base=1))
    w2 = _wave(TFZ, "b", base=100)
    b.submit(w2)
    _check(w2)  # 2 waves == max_jobs: due immediately
    assert time.monotonic() - t0 < 10.0

    b2 = TFZ.FusionBroker(window_s=30.0, max_jobs=8, max_width=64)
    t0 = time.monotonic()
    wide = _wave(TFZ, "c", base=1, m=256,
                 cands=[((i,), (i + 1,)) for i in range(0, 128, 2)])
    b2.submit(wide)
    _check(wide)  # 64 pending lanes >= max_width 64: due immediately
    assert time.monotonic() - t0 < 10.0


def test_cost_model_rejects_unprofitable_group():
    reports, stats, delta = _both_held(
        lambda fz: [_wave(fz, "big-a", base=1, m=8192, n_seq=990_000),
                    _wave(fz, "big-b", base=7, m=8192, n_seq=990_000)],
        window_s=0.25, max_jobs=8, max_width=16384)
    assert [r["fused_jobs"] for r in reports] == [1, 1]
    assert stats["rejected_groups"] == 1 and stats["fused_groups"] == 0
    assert stats["solo_waves"] == 2
    assert delta[("fsm_fusion_rejected_total", ())] == 1


def test_intra_job_waves_fuse_without_cross_job_label():
    def waves(fz):
        w1 = _wave(fz, "job-a", base=1)
        w2 = _wave(fz, "job-a", base=999, cands=[((5,), (6,))])
        w2.p1, w2.s1 = w1.p1, w1.s1  # one pipeline's shared prep
        return [w1, w2]

    reports, stats, _ = _both_held(waves, window_s=0.25, max_jobs=8,
                                   max_width=16384)
    assert reports[1]["fused_jobs"] == 2
    assert reports[1]["cross_job_launches"] == 0
    assert stats["cross_job_launches"] == 0


# ------------------------------------------------------ fused store layout


def _tsr_preps(seed):
    """A TSR engine's first-round prep pair of each package over the same
    seeded database (60 sequences, so both jobs share the fusion key)."""
    db = synthetic_db(seed=seed, n_sequences=60, n_items=8,
                      mean_itemsets=3.0, mean_itemset_size=1.2)
    eng = TsrTorch(build_vertical(db, min_item_support=1), 6, 0.4,
                   device="cpu")
    ref = TsrTPU(j_build_vertical(db, min_item_support=1), 6, 0.4)
    m = min(eng.item_cap, eng.vdb.n_items)
    eng.chunk = eng._round_chunk(m)
    ref.chunk = ref._round_chunk(m)
    ref._round_m = m
    return eng, eng._prep(m), ref, ref._prep(m), m


def test_fused_store_layout_keeps_each_jobs_pad_row():
    """Candidates whose X or Y is shorter than their km leave -1 slots,
    which read the store's all-ones last row.  Fused, each job's
    (sup, supx) must equal its solo launch's and the reference broker's:
    the fused store holds the jobs' real rows, zero rows up to m_pad and
    one all-ones row, with offsets counting real rows only."""
    (ea, (pa, sa), ra, (jpa, jsa), ma), (eb, (pb, sb), rb, (jpb, jsb), mb) = (
        _tsr_preps(31), _tsr_preps(47))
    assert ma >= 5 and mb >= 5
    cands_a = [((0,), (1, 2)), ((3, 4), (0,)), ((1,), (2,)),
               ((0, 1, 2), (4,))]
    cands_b = [((2,), (0, 1)), ((4,), (3,)), ((0, 3), (1, 2))]
    got = {}
    for fz in PACKAGES:
        b = fz.FusionBroker(window_s=0.25, max_jobs=8, max_width=16384)
        b.hold()
        if fz is TFZ:
            ws = [fz.EvalWave(uid=u, priority="normal", cands=c,
                              pools=_pools(c), p1=p, s1=s,
                              eval_fn=e._eval_fn, put=e._put,
                              cap=e._plain_cap(), lane=32, n_seq=e.n_seq,
                              n_words=e.n_words)
                  for u, c, p, s, e in (("a", cands_a, pa, sa, ea),
                                        ("b", cands_b, pb, sb, eb))]
        else:
            ws = [fz.EvalWave(uid=u, priority="normal", cands=c,
                              pools=_pools(c), p1=p, s1=s,
                              eval_fn=e._eval_fn, put=e._put,
                              cap=lambda km: 8192, lane=32, n_seq=e.n_seq,
                              n_words=e.n_words)
                  for u, c, p, s, e in (("a", cands_a, jpa, jsa, ra),
                                        ("b", cands_b, jpb, jsb, rb))]
        for w in ws:
            b.submit(w)
        b.release()
        res = [w.result() for w in ws]
        assert [r[2]["fused_jobs"] for r in res] == [2, 2]
        got[fz] = ([(r[0].tolist(), r[1].tolist()) for r in res],
                   res[0][2]["m_pad"])
    for (cands, p, s), (sup, supx) in zip(
            ((cands_a, pa, sa), (cands_b, pb, sb)), got[TFZ][0]):
        km = max(max(len(x), len(y)) for x, y in cands)
        xy = torch.full((len(cands), 2, km), -1, dtype=torch.int32)
        for i, (x, y) in enumerate(cands):
            xy[i, 0, :len(x)] = torch.tensor(x)
            xy[i, 1, :len(y)] = torch.tensor(y)
        solo = RS.rule_supports_plain(p, s, xy)
        assert (sup, supx) == (solo[0].tolist(), solo[1].tolist())
    assert got[TFZ] == got[JFZ]
    assert got[TFZ][1] == next_pow2(ma + mb)


# ---------------------------------------------------------- engine parity


def _mk_db(seed):
    return synthetic_db(seed=seed, n_sequences=60, n_items=8,
                        mean_itemsets=3.0, mean_itemset_size=1.2)


def _mine(db, *, uid=None, stats=None, pipeline=None):
    eng = TsrTorch(build_vertical(db, min_item_support=1), 6, 0.4,
                   max_side=2, device="cpu")
    if pipeline is not None:
        eng.PIPELINE_DEPTH = pipeline  # instance override (tests only)
    if uid is None:
        rules = eng.mine()
    else:
        try:
            with jobctl.activate(jobctl.register(uid)):
                rules = eng.mine()
        finally:
            jobctl.release(uid)
    if stats is not None:
        stats.update(eng.stats)
    return rules


def test_cross_job_fused_parity_oracle():
    db_a, db_b = _mk_db(31), _mk_db(47)
    solo_a, solo_b = _mine(db_a), _mine(db_b)
    b = _enable(TFZ, window_ms=200.0, max_jobs=8, max_width=16384)
    b.hold()
    out, stats = {}, {"a": {}, "b": {}}
    run = lambda k, db: out.setdefault(  # noqa: E731
        k, _mine(db, uid=f"job-{k}", stats=stats[k]))
    ts = [threading.Thread(target=run, args=("a", db_a)),
          threading.Thread(target=run, args=("b", db_b))]
    for t in ts:
        t.start()
    deadline = time.monotonic() + DEADLINE_S
    while b.pending() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert b.pending() >= 2, "both jobs' first waves should be in window"
    b.release()
    for t in ts:
        t.join(DEADLINE_S)
        assert not t.is_alive(), "fused mine did not finish"
    for k, db, solo in (("a", db_a, solo_a), ("b", db_b, solo_b)):
        assert rules_text(out[k]) == rules_text(solo)
        assert rules_text(solo) == j_rules_text(mine_tsr_tpu(
            db, 6, 0.4, max_side=2)) == rules_text(
                brute_force_rules(db, 6, 0.4, max_side=2))
        assert stats[k].get("fusion_waves", 0) >= 1
    assert b.stats["cross_job_launches"] >= 1
    assert stats["a"].get("fusion_fused_waves", 0) >= 1


def test_lone_wave_dispatches_like_direct_path():
    """A wave alone in its window plans the launches the direct path
    plans, in both packages alike."""
    db = _mk_db(53)
    direct = TsrTorch(build_vertical(db, min_item_support=1), 6, 0.4,
                      max_side=2, device="cpu")
    want = direct.mine()
    fused = {}
    for fz in PACKAGES:
        _enable(fz, window_ms=1.0, max_jobs=8, max_width=16384)
        s = {}
        if fz is TFZ:
            got = _mine(db, uid="lone", stats=s, pipeline=1)
            assert rules_text(got) == rules_text(want)
        else:
            eng = TsrTPU(j_build_vertical(db, min_item_support=1), 6, 0.4,
                         max_side=2)
            eng.PIPELINE_DEPTH = 1
            got = eng.mine()
            s = eng.stats
            assert j_rules_text(got) == rules_text(want)
        fused[fz] = (s["fusion_launches"], s.get("fusion_fused_waves", 0))
    assert fused[TFZ] == fused[JFZ]
    # every dispatch became one solo broker wave planning the direct
    # path's launches (the direct count holds one prep launch a round)
    assert fused[TFZ] == (direct.stats["kernel_launches"]
                          - direct.stats["deepening_rounds"], 0)


def test_resident_dispatch_bypasses_fusion_window():
    db = synthetic_db(seed=61, n_sequences=90, n_items=9,
                      mean_itemsets=3.0, mean_itemset_size=1.2)
    want = mine_tsr_torch(db, 20, 0.4, max_side=None, resident="never",
                          device="cpu")
    b = _enable(TFZ, window_ms=30_000.0, max_jobs=8, max_width=16384)
    before = dict(b.stats)
    s = {}
    t0 = time.monotonic()
    got = mine_tsr_torch(db, 20, 0.4, max_side=None, resident="always",
                         device="cpu", stats_out=s)
    wall = time.monotonic() - t0
    delta = {k: b.stats.get(k, 0) - before.get(k, 0) for k in b.stats}
    assert rules_text(got) == rules_text(want)
    assert s.get("resident") is True, s
    assert wall < 25.0, f"resident mine waited on the fusion window: {wall}"
    assert delta["solo_waves"] >= 1, delta
    assert delta["fused_groups"] == 0 and delta["cross_job_launches"] == 0


# --------------------------------------------------------------- service


def test_service_cross_job_fusion_stats_and_parity():
    from spark_fsm_tpu_torch.service import plugins
    from spark_fsm_tpu_torch.service.app import _fusion_stats

    plugins.set_device("cpu")
    db_a, db_b = _mk_db(61), _mk_db(67)
    want_a, want_b = _mine(db_a), _mine(db_b)
    store = ResultStore()
    b = _enable(TFZ, window_ms=250.0, max_jobs=8, max_width=16384)
    master = Master(store=store, miner_workers=2)
    try:
        b.hold()
        uids = {}
        for k, db in (("a", db_a), ("b", db_b)):
            resp = master.handle(ServiceRequest("fsm", "train", {
                "algorithm": "TSR_TPU", "source": "INLINE",
                "sequences": format_spmf(db), "k": "6", "minconf": "0.4",
                "max_side": "2", "priority": "normal"}))
            assert resp.status != "failure", resp.data
            uids[k] = resp.data["uid"]
        deadline = time.monotonic() + DEADLINE_S
        while b.pending() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.pending() >= 2
        b.release()
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline:
            if all(store.status(u) in ("finished", "failure")
                   for u in uids.values()):
                break
            time.sleep(0.02)
        for k, want in (("a", want_a), ("b", want_b)):
            assert store.status(uids[k]) == "finished"
            got = deserialize_rules(store.rules(uids[k]))
            assert rules_text(got) == rules_text(want)
        assert b.stats["cross_job_launches"] >= 1
        fs = _fusion_stats()
        assert fs["enabled"] and fs["cross_job_launches"] >= 1
    finally:
        master.shutdown()


def test_disabled_path_is_one_global_read():
    assert not TFZ.eval_enabled()
    assert TFZ.submit_eval(cands=[], pools={}, p1=None, s1=None,
                           eval_fn=None, put=None, cap=None, lane=32,
                           n_seq=64, n_words=1) is None
    b = TFZ.broker()
    before = dict(b.stats) if b is not None else None
    assert TFZ.dispatch_wave("queue", lambda: 41 + 1) == 42
    if b is not None:
        assert b.stats == before
    s = {}
    _mine(_mk_db(71), stats=s)
    assert not any(k.startswith("fusion") for k in s)
