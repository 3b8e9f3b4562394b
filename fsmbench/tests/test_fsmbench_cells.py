"""Each cell's loop and reference at a tiny size on the CPU, where the
port's entries run their plain versions; the reference against the frozen
oracles; a configuration, a mix and a metric added as files only."""

import json

import pytest

from fsmbench.gen.synth import make_db, synthetic_db_fast
from fsmbench.harness import BENCH_DIR, ROOT, Bench, run
from fsmbench.reference import fast, oracle
from fsmbench.reference.vertical import build_vertical

CELLS = ["bms2-spade.repeat", "gazelle-cspade.cold"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_cpu(tiny_bench, cell, trace):
    line = run(cell, 2**31 + 11, 0.3, trace, bench=tiny_bench, device="cpu")
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["worst_mine_mismatch"] == {"value": 0, "limit": 0}
    wanted = {m["name"] for m in tiny_bench.metrics(cell, trace)}
    got = set(line["metrics"])
    assert got <= wanted
    if not trace:
        assert {"setup_s", "mine_s"} <= got   # memory is a device reading
    else:
        # on the CPU nothing runs on a device: its metrics stay out
        assert "device_idle_share" not in got and "b1_roofline" not in got
        assert line["device"]["busy_s"] == 0.0


def test_repeat_mines_hit_the_cache(tiny_bench):
    bench = tiny_bench
    cfg = bench.load_json("configs", "bms2-spade")
    mix = bench.load_json("traffic", "repeat")
    algo = bench.module("algos", "spade")
    db = make_db(cfg["data"], 5)
    d = algo.miner(cfg, mix, "cpu")
    _, first = d.mine(db)
    res, again = d.mine(db)
    d.close()
    assert first["store_cache_hit"] is False
    assert again["store_cache_hit"] is True and again["kernel_launches"] > 0
    assert res == algo.reference(cfg, db)


@pytest.mark.parametrize("seed", [1, 2, 3, 2**32 + 7])
def test_fast_spade_equals_frozen_oracle(seed):
    db = synthetic_db_fast(seed, 700, 90, 4.6, zipf_s=1.15)
    for minsup in (3, 7):
        want = oracle.mine_spade(db, minsup)
        assert fast.mine_spade(build_vertical(db, minsup), minsup) == want


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("gap,window", [(2, 5), (None, 3), (1, None),
                                        (None, None)])
def test_fast_cspade_equals_frozen_oracle(seed, gap, window):
    db = synthetic_db_fast(seed, 400, 40, 2.5, zipf_s=1.1)
    minsup = 5
    want = oracle.mine_cspade(db, minsup, gap, window)
    got = fast.mine_cspade(build_vertical(db, minsup), minsup, gap, window)
    assert got == want


def test_fast_cspade_equals_brute_force():
    db = synthetic_db_fast(9, 60, 8, 3.0, zipf_s=1.1)
    want = oracle.brute_force_mine_constrained(db, 4, 2, 5,
                                               max_pattern_itemsets=8,
                                               max_itemset_size=3)
    got = fast.mine_cspade(build_vertical(db, 4), 4, 2, 5)
    assert got == want


def test_same_seed_same_database():
    data = json.loads((BENCH_DIR / "configs" / "bms2-spade.json")
                      .read_text())["data"]
    small = dict(data, n_sequences=300, n_items=64)
    assert make_db(small, 2**31 + 5) == make_db(small, 2**31 + 5)
    assert make_db(small, 1) != make_db(small, 2)


def test_seeds_relabel_one_database():
    """Every seed mines the same patterns up to the names of the items."""
    data = json.loads((BENCH_DIR / "configs" / "gazelle-cspade.json")
                      .read_text())["data"]
    small = dict(data, n_sequences=400, n_items=40)
    got = [fast.mine_cspade(build_vertical(make_db(small, s), 5), 5, 2, 5)
           for s in (1, 2**31 + 1)]
    assert got[0] != got[1]
    # the names keep their order: the same patterns, position by position
    shape = [[(len(p), [len(x) for x in p], n) for p, n in r] for r in got]
    assert shape[0] == shape[1]


def test_added_configuration_mix_and_metric_as_files(tmp_path):
    """A later cell needs only new files: a configuration, a mix and a
    per-layer metric from a temporary folder, named in a manifest."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((BENCH_DIR / "configs" / "bms2-spade.json").read_text())
    cfg.update(name="tiny-spade", minsup_abs=3)
    cfg["data"].update(n_sequences=250, n_items=40, max_itemsets=40)
    (tmp_path / "configs" / "tiny-spade.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "once.json").write_text(json.dumps(
        {"name": "once", "mode": "cold", "warm_mines": 1,
         "fail_unless": [["patterns", ">", 0]]}))
    (tmp_path / "metrics" / "patterns_per_mine.py").write_text(
        "def read(rec):\n    return rec.stat_per_mine('patterns')\n")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny-spade.once",
                                  "config": "tiny-spade", "traffic": "once",
                                  "chips": 1, "why": "a test's cell"})
    manifest["per_layer"].append({
        "name": "patterns_per_mine", "unit": "count/mine", "better": "higher",
        "source": "program_counter", "layer": "SPADE engines",
        "moves": "mine_s", "workloads": ["tiny-spade.once"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    bench = Bench(path, [tmp_path, BENCH_DIR])
    line = run("tiny-spade.once", 3, 0.2, True, bench=bench, device="cpu")
    assert line["correct"] is True
    assert line["metrics"]["patterns_per_mine"]["value"] > 0
    assert set(line["metrics"]) == {"patterns_per_mine"}


def test_unknown_cell_is_refused(tiny_bench):
    from fsmbench.harness import RunError

    with pytest.raises(RunError):
        run("no-such.cell", 1, 0.1, False, bench=tiny_bench, device="cpu")
