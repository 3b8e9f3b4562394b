"""Port parity for the TSR slice: ``mine_tsr_torch(device="cpu")`` against
the reference's ``mine_tsr_tpu`` (its jnp evaluator on the CPU) and
``brute_force_rules``, byte for byte over ``rules_text``, on the fixtures of
``tests/test_tsr.py``; the search's own counters against the reference's; the
NumPy engines against each other; checkpoints across the two packages; and
the options the port refuses."""

import json

import numpy as np
import pytest

from spark_fsm_tpu.data.spmf import parse_spmf as j_parse
from spark_fsm_tpu.data.vertical import build_vertical as j_build
from spark_fsm_tpu.models import tsr as JT
from spark_fsm_tpu.utils.canonical import rules_text as j_rules_text
from spark_fsm_tpu_torch import TsrTorch, mine_tsr_torch
from spark_fsm_tpu_torch.data.spmf import parse_spmf
from spark_fsm_tpu_torch.data.synth import synthetic_db
from spark_fsm_tpu_torch.data.vertical import build_vertical
from spark_fsm_tpu_torch.models import tsr as T
from spark_fsm_tpu_torch.utils.canonical import rules_text
from tests.test_oracle import ZAKI_DB, random_db

MULTIWORD_DB = [tuple((1 + (i * 7 + j) % 5,) for j in range(40))
                for i in range(12)]


def _random(seed, **kw):
    rng = np.random.default_rng(seed)
    return random_db(rng, **(dict(n_seq=25, n_items=6, max_itemsets=5,
                                  max_set=2) | kw))


def _parity(db, k, minconf, max_side=2, **kw):
    got = rules_text(mine_tsr_torch(db, k, minconf, max_side=max_side,
                                    device="cpu", **kw))
    ref = j_rules_text(JT.mine_tsr_tpu(db, k, minconf, max_side=max_side, **kw))
    brute = j_rules_text(JT.brute_force_rules(db, k, minconf,
                                              max_side=max_side))
    assert got == ref == brute, f"\n--- port ---\n{got}\n--- ref ---\n{ref}"
    return got


@pytest.mark.parametrize("case", [
    "zaki", "zaki_high_conf", "side3", "multiword",
    *[f"random{seed}_{k}_{c}" for seed in range(5)
      for k, c in ((5, 0.5), (10, 0.3))],
])
def test_rules_match_reference_and_brute_force(case):
    if case == "zaki":
        _parity(ZAKI_DB, 5, 0.5)
    elif case == "zaki_high_conf":
        _parity(ZAKI_DB, 3, 0.9)
    elif case == "side3":
        rng = np.random.default_rng(7)
        db = random_db(rng, n_seq=20, n_items=5, max_itemsets=6, max_set=2)
        _parity(db, 8, 0.4, max_side=3)
    elif case == "multiword":
        assert build_vertical(MULTIWORD_DB).n_words == 2
        _parity(MULTIWORD_DB, 6, 0.3)
    else:
        seed, k, c = case[len("random"):].split("_")
        _parity(_random(100 + int(seed)), int(k), float(c))


def test_tie_inclusive_topk():
    text = "1 -1 2 -2\n1 -1 3 -2\n1 -1 2 -2\n1 -1 3 -2\n"
    got = mine_tsr_torch(parse_spmf(text), 1, 0.0, device="cpu")
    sups = [r[2] for r in got]
    assert sups.count(max(sups)) >= 2
    assert rules_text(got) == j_rules_text(JT.mine_tsr_tpu(j_parse(text), 1, 0.0))


def test_empty():
    assert mine_tsr_torch(parse_spmf("1 -2\n"), 5, 0.5, device="cpu") == []


def test_iterative_deepening():
    db = synthetic_db(seed=21, n_sequences=300, n_items=30, mean_itemsets=5.0)
    want = JT.mine_tsr_tpu(db, 10, 0.5, max_side=2, item_cap=64)
    eng = TsrTorch(build_vertical(db, min_item_support=1), 10, 0.5,
                   max_side=2, item_cap=2, device="cpu")
    got = eng.mine()
    assert eng.stats["deepening_rounds"] > 1
    assert rules_text(got) == j_rules_text(want)


@pytest.mark.parametrize("chunk,cap", [(64, 256), (16, 4)])
def test_search_counters_match_reference(chunk, cap):
    # with a pinned chunk the search pops, prunes and plans exactly as the
    # reference does, so its counters agree one for one
    db = synthetic_db(seed=21, n_sequences=300, n_items=30, mean_itemsets=5.0)
    mine = dict(max_side=2, chunk=chunk, item_cap=cap)
    got, want = {}, {}
    a = mine_tsr_torch(db, 10, 0.5, device="cpu", stats_out=got, **mine)
    b = JT.mine_tsr_tpu(db, 10, 0.5, stats_out=want, **mine)
    assert rules_text(a) == j_rules_text(b)
    assert got.get("resident") is not True
    for key in ("evaluated", "pruned_conf", "deepening_rounds",
                "kernel_launches", "traffic_units"):
        assert got[key] == want[key], key
    # the per-km fill counters, keyed as the reference keys them
    per_km = JT._KM_STAT_PREFIXES
    assert {k: v for k, v in got.items() if k.startswith(per_km)} \
        == {k: v for k, v in want.items() if k.startswith(per_km)}


def test_cpu_engine_matches_reference_cpu_engine():
    rng = np.random.default_rng(17)
    for _ in range(4):
        db = random_db(rng, n_seq=24, n_items=7, max_itemsets=5, max_set=2)
        got, want = {}, {}
        a = T.mine_tsr_cpu(db, 8, 0.4, stats_out=got)
        b = JT.mine_tsr_cpu(db, 8, 0.4, stats_out=want)
        assert rules_text(a) == j_rules_text(b)
        assert got["evaluated"] == want["evaluated"]


def test_helpers_match_reference():
    db = parse_spmf("1 -1 2 -1 3 -2\n2 -1 1 -1 3 -2\n1 3 -2\n")
    for x, y in (((1,), (3,)), ((1, 2), (3,)), ((1,), (1,))):
        assert T.rule_counts_direct(db, x, y) == JT.rule_counts_direct(db, x, y)
    for sup, supx, c in ((1, 2, 0.5), (49, 100, 0.5), (2, 3, 0.5), (0, 0, 0.5),
                         (7, 10, 0.7)):
        assert T.conf_ok(sup, supx, c) == JT.conf_ok(sup, supx, c)
    db = _random(5)
    assert rules_text(T.brute_force_rules(db, 6, 0.4)) == j_rules_text(
        JT.brute_force_rules(db, 6, 0.4))


class _Crash(Exception):
    pass


def _snapshot(eng, saves=2):
    """Mine until the ``saves``-th checkpoint, then crash; the snapshot
    after a JSON round trip (the service's store format)."""
    saved = []

    def cb(state):
        saved.append(state)
        if len(saved) == saves:
            raise _Crash

    with pytest.raises(_Crash):
        eng.mine(checkpoint_cb=cb, checkpoint_every_s=0.0)
    state = json.loads(json.dumps(saved[-1]))
    assert state["stack"], "crash came after the frontier emptied"
    return state


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_interchange(direction):
    db = synthetic_db(seed=5, n_sequences=200, n_items=20, mean_itemsets=4.0)
    kw = dict(max_side=2, chunk=8)
    want = j_rules_text(JT.mine_tsr_tpu(db, 12, 0.4, **kw))
    ref = JT.TsrTPU(j_build(db, min_item_support=1), 12, 0.4, **kw)
    port = TsrTorch(build_vertical(db, min_item_support=1), 12, 0.4,
                    device="cpu", **kw)
    assert port.frontier_fingerprint() == ref.frontier_fingerprint()
    src, dst = (ref, port) if direction == "ref_to_port" else (port, ref)
    state = _snapshot(src)
    text = rules_text if dst is port else j_rules_text
    assert text(dst.mine(resume=state)) == want
    assert dst.stats["resumed_nodes"] == len(state["stack"])


def test_frontier_state_matches_reference_field_for_field():
    db = _random(3)
    ref = JT.TsrTPU(j_build(db, min_item_support=1), 5, 0.5, max_side=2)
    port = TsrTorch(build_vertical(db, min_item_support=1), 5, 0.5,
                    max_side=2, device="cpu")
    queue = [(-7, (0,), (1, 2), True, 1, 7, 9), (-2, (3,), (4,), False, 0, 2, 0)]
    results = [(5, 8, (0,), (1,)), (4, 4, (2, 3), (1,))]
    assert port.frontier_state(queue, results, 6, 3) == ref.frontier_state(
        queue, results, 6, 3)


@pytest.mark.parametrize("kw,what", [
    (dict(mesh="local"), "mesh"),
    (dict(partition_parts=2), "partition"),
    (dict(shape_buckets=True), "shape_buckets"),
])
def test_unported_options_raise(kw, what):
    if what == "mesh":
        # ported (Queue A item 6): a 1-rank mesh finds the same rules on
        # the host loop, as the reference's mesh route does
        from spark_fsm_tpu_torch.parallel.mesh import local_mesh
        mesh = local_mesh("cpu")
        for side in (2, None):
            stats = {}
            got = mine_tsr_torch(ZAKI_DB, 5, 0.5, mesh=mesh, max_side=side,
                                 stats_out=stats)
            assert rules_text(got) == rules_text(mine_tsr_torch(
                ZAKI_DB, 5, 0.5, device="cpu", max_side=side))
            assert not stats.get("resident")
        assert mesh.reduce_stats()["all_reduces"] > 0
        return
    if what == "shape_buckets":
        # ported (Queue A item 9): the bucketed mine finds the same rules
        got = mine_tsr_torch(ZAKI_DB, 5, 0.5, device="cpu", **kw)
        assert rules_text(got) == rules_text(
            mine_tsr_torch(ZAKI_DB, 5, 0.5, device="cpu"))
        return
    # ported (Queue A item 11): two class slices find the reference's
    # partitioned rules and one device's, one exchange a deepening round
    for side in (2, None):
        stats, ref_stats = {}, {}
        got = mine_tsr_torch(ZAKI_DB, 5, 0.5, device="cpu", max_side=side,
                             stats_out=stats, **kw)
        ref = JT.mine_tsr_tpu(ZAKI_DB, 5, 0.5, max_side=side,
                              stats_out=ref_stats, **kw)
        assert rules_text(got) == j_rules_text(ref) == rules_text(
            mine_tsr_torch(ZAKI_DB, 5, 0.5, device="cpu", max_side=side))
        assert stats["partition_exchanges"] == stats["deepening_rounds"]
        # key for key but the known differences (ROADMAP.md)
        drop = ("shape_key", "wait_s")
        assert ({k: v for k, v in stats.items() if k not in drop}
                == {k: v for k, v in ref_stats.items() if k not in drop})


@pytest.mark.parametrize("resident", ["always", True])
def test_resident_always_runs_the_resident_route(resident):
    # the route is pinned even where auto's heuristic picks the host loop
    stats, want = {}, {}
    got = mine_tsr_torch(ZAKI_DB, 5, 0.5, max_side=2, device="cpu",
                         resident=resident, stats_out=stats)
    ref = JT.mine_tsr_tpu(ZAKI_DB, 5, 0.5, max_side=2, resident=resident,
                          stats_out=want)
    assert stats["resident"] is True and want["resident"] is True
    assert stats["resident_rounds"] == want["resident_rounds"] == 1
    assert rules_text(got) == j_rules_text(ref) == j_rules_text(
        JT.brute_force_rules(ZAKI_DB, 5, 0.5, max_side=2))


@pytest.mark.parametrize("resident", ["auto", "never", False])
def test_host_loop_runs_for_resident_auto_and_never(resident):
    stats = {}
    got = mine_tsr_torch(ZAKI_DB, 5, 0.5, max_side=2, device="cpu",
                         resident=resident, stats_out=stats)
    assert stats.get("resident") is not True
    assert rules_text(got) == j_rules_text(
        JT.brute_force_rules(ZAKI_DB, 5, 0.5, max_side=2))


def test_use_kernel_and_device_rules():
    vdb = build_vertical(ZAKI_DB, min_item_support=1)
    with pytest.raises(ValueError, match="use_kernel"):
        TsrTorch(vdb, 5, 0.5, device="cpu", use_kernel=True)
    assert TsrTorch(vdb, 5, 0.5, device="cpu").use_kernel is False
    assert TsrTorch(vdb, 5, 0.5, device="cpu", use_kernel=False).use_kernel is False
    with pytest.raises(ValueError, match="resident"):
        TsrTorch(vdb, 5, 0.5, device="cpu", resident="sometimes")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mine_tsr_torch(ZAKI_DB, 5, 0.5)
