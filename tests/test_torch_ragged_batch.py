"""The port's copy of the ragged launch planner against the reference's
(``spark_fsm_tpu/ops/ragged_batch.py``, its overhead calibration pinned
off): the same launch plans over a seeded grid of pools, caps and sequence
geometries, and the same cost-model integers, which the port keeps as exact
lane x sequence-word ratios instead of the reference's float times."""

import numpy as np
import pytest

from spark_fsm_tpu.ops import ragged_batch as JRB
from spark_fsm_tpu_torch.ops import ragged_batch as RB

# sequence axes: the full Kosarak axis, the quantum's boundaries (the
# 16,384-lane step sits near 495,030 sequence-words), and small axes where
# the overhead clamps
GEOMETRIES = [(990_000, 1), (495_000, 1), (495_030, 1), (495_031, 1),
              (247_515, 2), (77_504, 1), (9_900, 3), (2_048, 2), (301, 1),
              (25, 40), (1, 1)]


@pytest.fixture(autouse=True)
def _pin_reference_calibration():
    JRB.set_overhead_calibration(False)
    yield
    JRB.set_overhead_calibration(True)


def test_cost_model_integers_match_reference():
    rng = np.random.default_rng(0)
    seqs = [s for s, _ in GEOMETRIES] + rng.integers(1, 3_000_000, 4000).tolist()
    for s in seqs:
        for w in (1, 2, 3, 40):
            assert RB.overhead_units(s, w) == JRB.overhead_units(s, w), (s, w)
            assert (RB.dispatch_quantum_lanes(s, w)
                    == JRB.dispatch_quantum_lanes(s, w)), (s, w)
    assert RB.overhead_units(0, 1) == JRB.overhead_units(0, 1)
    assert RB.dispatch_quantum_lanes(0, 1) == JRB.dispatch_quantum_lanes(0, 1)


def _plans_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.km, a.width, a.rows, a.kms) == (b.km, b.width, b.rows, b.kms)
        assert (a.traffic_units, a.mixed, a.borrowed) == (
            b.traffic_units, b.mixed, b.borrowed)


@pytest.mark.parametrize("seed", range(6))
def test_plans_match_reference_on_a_seeded_grid(seed):
    rng = np.random.default_rng(1000 + seed)
    for trial in range(40):
        pools, start = {}, 0
        for km in rng.choice(RB.KM_LADDER, rng.integers(1, 5), replace=False):
            n = int(rng.choice([rng.integers(1, 40), rng.integers(40, 700),
                                rng.integers(700, 20_000)]))
            pools[int(km)] = list(range(start, start + n))
            start += n
        s, w = GEOMETRIES[trial % len(GEOMETRIES)]
        overhead = RB.overhead_units(s, w)
        assert overhead == JRB.overhead_units(s, w)
        chunk = int(rng.choice([64, 512, 4096, RB.dispatch_quantum_lanes(s, w)]))
        raw = int(rng.choice([128, 1024, 8192]))
        caps = [lambda km: chunk,
                lambda km: max(32, min(chunk, raw // km))]
        for cap in caps:
            for lane in (32, 128):
                _plans_equal(
                    RB.plan_launches(pools, cap=cap, lane=lane,
                                     overhead=overhead),
                    JRB.plan_launches(pools, cap=cap, lane=lane,
                                      overhead=overhead, record=False))


def test_every_candidate_lands_once_and_tails_merge():
    pools = {1: list(range(900)), 2: list(range(900, 964)),
             4: list(range(964, 1000))}
    plan = RB.plan_launches(pools, cap=lambda km: 8192, lane=128,
                            overhead=RB.overhead_units(990_000, 1))
    rows = [r for L in plan for r in L.rows]
    assert sorted(rows) == list(range(1000))
    assert all(L.width >= len(L.rows) and L.width & (L.width - 1) == 0
               for L in plan)
    assert any(L.mixed for L in plan)


def test_stager_packs_and_recycles():
    st = RB.XYStager()
    L = RB.Launch(2, 4, [1, 0], [1, 2])
    cands = [((3,), (1, 2)), ((0,), (5,))]
    buf = st.take(L, cands)
    assert buf.shape == (4, 2, 2)
    assert buf[:2].tolist() == [[[0, -1], [5, -1]], [[3, -1], [1, 2]]]
    assert (buf[2:] == -1).all()
    st.release([buf])
    assert st.take(L, cands) is buf
