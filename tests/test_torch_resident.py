"""Port parity for TSR's resident-frontier route
(``ops/resident_frontier.py`` and ``TsrTorch._mine_resident``) on the CPU
against the reference's ``resident_frontier`` and ``TsrTPU`` (its jnp
while-loop program): the host functions (caps, roots, packing), single
waves of the device body at both widths, the route each ``resident``
value takes, the stats of whole mines (Queue C 2's inputs), the
defer-and-handoff and the overflow-spill fixtures of ``tests/test_tsr.py``
with equal ``resident_*`` counters, and snapshots resumed across the two
packages.  The reference's planner calibration is pinned off
(``tests/conftest.py``), so ``overhead_units`` is deterministic."""

import json

import numpy as np
import pytest
import torch

from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu.data.vertical import build_vertical as j_build
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.ops import resident_frontier as JRF
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models import tsr as T
from spark_fsm_tpu_torch.ops import resident_frontier as RF
from spark_fsm_tpu_torch.ops import rule_support as RS
from spark_fsm_tpu_torch.utils.canonical import rules_text
from tests.test_oracle import ZAKI_DB, random_db

_SYN5 = dict(seed=5, n_sequences=120, n_items=10, mean_itemsets=3.0)
# the overflow fixture's caps, pinned in both packages
_TINY_CAPS = dict(nb=32, ring=128, r_cap=256, d_cap=32)
# small caps with a narrow width distinct from the wide one (64 -> 32)
_WAVE_CAPS = dict(nb=64, ring=256, r_cap=512, d_cap=64)
# keys a whole mine's stats may differ in: the reference's shape registry
# key (not ported) and the port's counter waits (a wall time)
_UNSHARED = ("shape_key", "wait_s")


def _deep_db(n_seq=50, run=10, extra=6, seed=7):
    """``tests/test_tsr.py``'s fixture: every sequence holds the ordered
    run 0..run-1 plus a few noise items, so rules with run-length sides
    have full support and over-ladder children stay live."""
    rng = np.random.default_rng(seed)
    db = []
    for _ in range(n_seq):
        items = list(range(run)) + rng.integers(
            run, run + extra, size=3).tolist()
        db.append([[int(it)] for it in items])
    return db


def _both(db, k, minconf, **kw):
    """The same mine through both packages; returns (port rules text, port
    stats, reference rules text, reference stats)."""
    got, want = {}, {}
    a = T.mine_tsr_torch(db, k, minconf, device="cpu", stats_out=got, **kw)
    b = JT.mine_tsr_tpu(db, k, minconf, stats_out=want, **kw)
    return rules_text(a), got, j_rules_text(b), want


def _shared(stats):
    return {k: v for k, v in stats.items() if k not in _UNSHARED}


def _same_caps(a, b):
    return all(getattr(a, f) == getattr(b, f)
               for f in ("nb", "ring", "r_cap", "km", "d_cap", "i_max"))


# ------------------------------------------------------------ host functions


@pytest.mark.parametrize("n_seq", [1, 120, 99_000, 990_000, 5_000_000])
@pytest.mark.parametrize("n_words", [1, 3])
def test_caps_for_equals_reference(n_seq, n_words):
    for m in (1, 64, 256, 4096):
        for budget in (1 << 20, 4 << 30, 16 << 30, 76 << 30):
            want = JRF.caps_for(n_seq, n_words, m, budget)
            got = RF.caps_for(n_seq, n_words, m, budget)
            assert (got is None) == (want is None), (m, budget)
            if got is not None:
                assert _same_caps(got, want), (m, budget)
                assert got.nb_late == want.nb_late
                row = n_seq * n_words * 4
                assert RF.working_set_bytes(got, row, m) == \
                    JRF.working_set_bytes(want, row, m)


@pytest.mark.parametrize("max_side", [None, 1, 2, 3])
def test_root_entries_equal_reference(max_side):
    rng = np.random.default_rng(3)
    for m in (1, 2, 7, 40):
        sup_l = sorted(rng.integers(1, 60, m).tolist(), reverse=True)
        for minsup in (1, 10, 30):
            for num, den in ((1, 2), (9, 10), (0, 1)):
                assert RF.root_entries(sup_l, minsup, num, den, max_side) \
                    == JRF.root_entries(sup_l, minsup, num, den, max_side)


def _entries(rng, n, km, over=False):
    out = []
    for _ in range(n):
        nx = int(rng.integers(1, km + 2 if over else km + 1))
        ny = int(rng.integers(1, km + 1))
        picks = rng.choice(40, nx + ny, replace=False).tolist()
        out.append((int(rng.integers(1, 50)), tuple(sorted(picks[:nx])),
                    tuple(sorted(picks[nx:])), bool(rng.integers(2)),
                    int(rng.integers(2)), int(rng.integers(1, 60)),
                    int(rng.integers(0, 60))))
    return out


def test_pack_state_and_unpack_round_trip_equal_reference():
    rng = np.random.default_rng(11)
    caps = RF.ResidentCaps(nb=32, ring=64, r_cap=48, d_cap=16)
    jcaps = JRF.ResidentCaps(nb=32, ring=64, r_cap=48, d_cap=16)
    entries = _entries(rng, 50, caps.km, over=True)
    results = [(int(rng.integers(1, 50)), int(rng.integers(50, 90)),
                (int(a),), (int(b), int(c)))
               for a, b, c in rng.integers(0, 40, (30, 3))]
    got = RF.pack_state(entries, results, caps)
    want = JRF.pack_state(entries, results, jcaps)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_defer"] > 0
    ring_args = [got[n] for n in RF.RING_FIELDS]
    for minsup in (1, 25):
        back = RF.unpack_entries(*ring_args, 0, got["n_entries"], minsup)
        assert back == JRF.unpack_entries(*ring_args, 0, got["n_entries"],
                                          minsup)
        if minsup == 1:
            assert back == [e for e in entries
                            if len(e[1]) <= caps.km and len(e[2]) <= caps.km]
        recs = RF.unpack_results(got["rec_xy"], got["rec_sup"],
                                 got["rec_supx"], len(results), minsup)
        assert recs == JRF.unpack_results(got["rec_xy"], got["rec_sup"],
                                          got["rec_supx"], len(results),
                                          minsup)
        assert recs == [r for r in results if r[0] >= minsup]
    # frontiers that do not fit route to the host loop in both packages
    for ents, res in ((entries * 2, results), (entries, results * 2),
                      (_entries(rng, 3, caps.km + 1, over=True), [])):
        assert (RF.pack_state(ents, res, caps) is None) == \
            (JRF.pack_state(ents, res, jcaps) is None)
    assert RF.pack_state(entries * 2, results, caps) is None


# ------------------------------------------------------------ one wave


def _round_inputs(db, m):
    """The round's preps in both layouts, from the NumPy engine's dense
    rows: the reference's ``[m, S, W]`` uint32 pair, the port's flat
    ``[m + 1, S*W]`` int32 stores with the all-ones pad row."""
    vdb = build_vertical(db, min_item_support=1)
    cpu = T.TsrCPU(vdb, 5, 0.5)
    p1, s1 = cpu._prep(m)

    def flat(rows):
        out = np.full((m + 1, rows.shape[1] * rows.shape[2]), -1, np.int32)
        out[:m] = rows.reshape(m, -1).view(np.int32)
        return torch.from_numpy(out)

    sup = cpu._sup_sorted[:m].astype(np.int64).tolist()
    return vdb, (p1, s1), (flat(p1), flat(s1)), sup


def _ref_carry(state, minsup):
    import jax.numpy as jnp

    i32 = jnp.int32
    return (
        jnp.asarray(state["exy"]), jnp.asarray(state["bound"]),
        jnp.asarray(state["psup"]), jnp.asarray(state["psupx"]),
        jnp.asarray(state["cr"]), jnp.asarray(state["side"]),
        i32(0), i32(state["n_entries"]),
        jnp.asarray(state["rec_xy"]), jnp.asarray(state["rec_sup"]),
        jnp.asarray(state["rec_supx"]), i32(state["n_results"]),
        jnp.asarray(state["topk"]), i32(state["n_results"]), i32(minsup),
        jnp.bool_(False), i32(0), i32(0), i32(0),
        jnp.asarray(state["dxy"]), jnp.asarray(state["dbound"]),
        jnp.asarray(state["dpsup"]), jnp.asarray(state["dpsupx"]),
        jnp.asarray(state["dcr"]), jnp.asarray(state["dside"]),
        i32(state["n_defer"]))


@pytest.mark.parametrize("narrow", [False, True])
def test_waves_equal_reference_segment_fn(narrow):
    """Three single waves (``wave_end`` 1, 2, 3 in the reference's
    program) from the roots of a round: after each, every carry field and
    the 10 counters equal the reference's."""
    import jax.numpy as jnp

    db = synthetic_db(seed=42, n_sequences=200, n_items=14,
                      mean_itemsets=4.0, mean_itemset_size=1.3)
    m, k, num, den = 14, 6, 2, 5
    vdb, (jp1, js1), (p1, s1), sup_l = _round_inputs(db, m)
    caps = RF.ResidentCaps(**_WAVE_CAPS)
    jcaps = JRF.ResidentCaps(**_WAVE_CAPS)
    state = RF.pack_state(RF.root_entries(sup_l, 1, num, den, None), [], caps)
    nb = caps.nb_late if narrow else caps.nb
    assert nb == (32 if narrow else 64) and state["n_entries"] == m
    carry = RF.carry_from_state(state, 1, torch.device("cpu"))
    sup_t = torch.tensor(sup_l, dtype=torch.int32)
    fn = JRF.segment_fn(jcaps, narrow)
    jc = _ref_carry(JRF.pack_state(JRF.root_entries(sup_l, 1, num, den, None),
                                   [], jcaps), 1)
    args = (jnp.asarray(jp1), jnp.asarray(js1),
            jnp.asarray(np.asarray(sup_l, np.int32)), jnp.int32(num),
            jnp.int32(den), jnp.int32(k), jnp.int32(1 << 30))
    for w in range(1, 4):
        jc, jctr = fn(*args, jnp.int32(w), *jc)
        RF.wave(carry, p1, s1, sup_t, num, den, k, 1 << 30, nb,
                vdb.n_words, RS.rule_supports)
        assert carry.ctr.tolist() == np.asarray(jctr).tolist(), w
        for name, a in zip(RF.CARRY_FIELDS, jc):
            if name in RF.COUNTERS:
                assert int(a) == int(carry.ctr[RF.COUNTERS.index(name)]), name
            elif name == "topk":
                np.testing.assert_array_equal(carry.topk.numpy(), a)
            else:
                np.testing.assert_array_equal(
                    carry.arrays([name])[0], np.asarray(a), err_msg=name)
    rec_count, oflow, waves = carry.ctr.tolist()[:3]
    assert waves == 3 and not oflow and rec_count > 0


def test_wave_overflow_commits_nothing():
    """A wave whose pushes overflow the ring leaves every buffer and
    counter as it was, with the overflow flag raised."""
    db = synthetic_db(seed=42, n_sequences=200, n_items=14,
                      mean_itemsets=4.0, mean_itemset_size=1.3)
    m = 14
    vdb, _, (p1, s1), sup_l = _round_inputs(db, m)
    caps = RF.ResidentCaps(nb=32, ring=16, r_cap=256, d_cap=32)
    state = RF.pack_state(RF.root_entries(sup_l, 1, 1, 2, None), [], caps)
    carry = RF.carry_from_state(state, 1, torch.device("cpu"))
    before = {n: carry.arrays([n])[0] for n in RF.RING_FIELDS
              + RF.RECORD_FIELDS + RF.DEFER_FIELDS}
    ctr = carry.ctr.tolist()
    RF.wave(carry, p1, s1, torch.tensor(sup_l, dtype=torch.int32), 1, 2, 5,
            1 << 30, caps.nb, vdb.n_words, RS.rule_supports)
    after = carry.ctr.tolist()
    assert after[1] == 1
    assert after[:1] + after[2:] == ctr[:1] + ctr[2:]
    for n, a in before.items():
        np.testing.assert_array_equal(carry.arrays([n])[0], a, err_msg=n)


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("resident", ["auto", "always", "never", True, False])
@pytest.mark.parametrize("max_side", [None, 3, 2])
def test_routing_equals_reference(resident, max_side):
    db = synthetic_db(**_SYN5)
    port = T.TsrTorch(build_vertical(db, min_item_support=1), 8, 0.5,
                      max_side=max_side, resident=resident, device="cpu")
    ref = JT.TsrTPU(j_build(db, min_item_support=1), 8, 0.5,
                    max_side=max_side, resident=resident)
    m = port.vdb.n_items
    got, want = port._resident_route(m), ref._resident_route(m)
    assert got == want
    assert got == (resident in ("always", True)
                   or (resident == "auto" and max_side != 2))
    if got:
        assert _same_caps(port._resident_caps, ref._resident_caps)


def test_structural_limits_override_always():
    db = synthetic_db(**_SYN5)
    vdb, jvdb = build_vertical(db, min_item_support=1), j_build(db, min_item_support=1)
    m = vdb.n_items
    for kw in (dict(k=RF.K_PAD + 1, minconf=0.5),
               dict(k=8, minconf=0.12345678)):
        port = T.TsrTorch(vdb, kw["k"], kw["minconf"], resident="always",
                          device="cpu")
        ref = JT.TsrTPU(jvdb, kw["k"], kw["minconf"], resident="always")
        assert port._resident_route(m) == ref._resident_route(m)
    assert not T.TsrTorch(vdb, RF.K_PAD + 1, 0.5, resident="always",
                          device="cpu")._resident_route(m)
    assert not T.TsrCPU(vdb, 8, 0.5, resident="always")._resident_route(m)


# ------------------------------------------------------------ whole mines


@pytest.mark.parametrize("case", ["zaki", "synthetic_seed5"])
def test_queue_c2_inputs_report_the_reference_stats(case):
    """Queue C 2: at the default ``max_side`` the ``auto`` route is the
    resident one, and the port's stats equal the reference's key for key
    (``shape_key`` and the port's counter waits aside)."""
    db, k = (ZAKI_DB, 5) if case == "zaki" else (synthetic_db(**_SYN5), 8)
    got, gs, want, ws = _both(db, k, 0.5)
    assert got == want
    assert _shared(gs) == _shared(ws)
    assert gs["resident"] is True
    assert gs["resident_rounds"] == 1
    assert gs["kernel_launches"] == (2 if case == "zaki" else 3)
    assert T.resident_counters(gs) == JT.resident_counters(ws)


@pytest.mark.parametrize("seed", range(3))
def test_unlimited_parity_with_brute_force(seed):
    rng = np.random.default_rng(300 + seed)
    db = random_db(rng, n_seq=25, n_items=6, max_itemsets=5, max_set=2)
    brute = j_rules_text(JT.brute_force_rules(db, 10, 0.4, max_side=6))
    got, gs, want, ws = _both(db, 10, 0.4, max_side=None, resident="always")
    assert got == want == brute
    assert _shared(gs) == _shared(ws)


def test_deep_defer_and_handoff_equal_reference():
    db = _deep_db()
    hs = {}
    host = rules_text(T.mine_tsr_torch(db, 300, 0.3, max_side=None,
                                       resident="never", device="cpu",
                                       stats_out=hs))
    got, gs, want, ws = _both(db, 300, 0.3, max_side=None, resident="always")
    assert got == want == host
    assert hs.get("evaluated_km8", 0) > 0, hs
    assert gs["resident_deferred"] > 0 and gs["resident_handoffs"] >= 1, gs
    assert "resident_spills" not in gs
    assert _shared(gs) == _shared(ws)


def test_overflow_spill_with_pinned_caps_equals_reference(monkeypatch):
    db = synthetic_db(seed=42, n_sequences=200, n_items=14,
                      mean_itemsets=4.0, mean_itemset_size=1.3)
    host = rules_text(T.mine_tsr_torch(db, 40, 0.4, max_side=None,
                                       resident="never", device="cpu"))
    monkeypatch.setattr(RF, "caps_for",
                        lambda *a, **k: RF.ResidentCaps(**_TINY_CAPS))
    monkeypatch.setattr(JRF, "caps_for",
                        lambda *a, **k: JRF.ResidentCaps(**_TINY_CAPS))
    got, gs, want, ws = _both(db, 40, 0.4, max_side=None, resident="always")
    assert got == want == host
    assert gs["resident_spills"] >= 1, gs
    assert T.resident_counters(gs) == JT.resident_counters(ws)
    assert _shared(gs) == _shared(ws)


# ------------------------------------------------------------ checkpoints


class _Crash(Exception):
    pass


def _snapshot(eng, saves=2):
    saved = []

    def cb(state):
        saved.append(state)
        if len(saved) == saves:
            raise _Crash

    with pytest.raises(_Crash):
        eng.mine(checkpoint_cb=cb, checkpoint_every_s=0.0)
    return json.loads(json.dumps(saved[-1]))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_segment_snapshots_resume_across_packages(direction):
    """Snapshots taken at segment boundaries (the checkpointed schedule: 1,
    then 4, 16, ... waves a segment) are equal in both packages, and each
    package's resumes in the other on the resident route, byte-identical
    to the host loop's mine."""
    db = _deep_db(n_seq=40, run=8, seed=11)
    kw = dict(max_side=None, resident="always")
    want = j_rules_text(JT.mine_tsr_tpu(db, 150, 0.3, max_side=None,
                                        resident="never"))
    ref = JT.TsrTPU(j_build(db, min_item_support=1), 150, 0.3, **kw)
    port = T.TsrTorch(build_vertical(db, min_item_support=1), 150, 0.3,
                      device="cpu", **kw)
    ref_snap, port_snap = _snapshot(ref), _snapshot(port)
    assert port_snap == ref_snap
    assert port_snap["stack"], "crash came after the frontier emptied"
    state = ref_snap if direction == "ref_to_port" else port_snap
    dst = (T.TsrTorch(build_vertical(db, min_item_support=1), 150, 0.3,
                      device="cpu", **kw)
           if direction == "ref_to_port"
           else JT.TsrTPU(j_build(db, min_item_support=1), 150, 0.3, **kw))
    text = rules_text if direction == "ref_to_port" else j_rules_text
    assert text(dst.mine(resume=state)) == want
    assert dst.stats["resumed_nodes"] == len(state["stack"])
    assert dst.stats.get("resident_rounds", 0) >= 1, dst.stats
