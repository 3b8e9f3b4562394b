"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""

import json
import re

import pytest

from fsmbench.harness import BENCH_DIR, ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["fsmbench"]
    assert MANIFEST["command"] == ["python3", "fsmbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for e in MANIFEST[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves_to_files(cell):
    bench = Bench()
    w = bench.cell(cell)
    assert w["chips"] == 1
    cfg = bench.load_json("configs", w["config"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert (ROOT / entry["file"]).is_file()
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]
    mix = bench.load_json("traffic", w["traffic"])
    assert mix["name"] == w["traffic"]
    algo = bench.module("algos", cfg["algorithm"])
    assert callable(algo.miner) and callable(algo.reference)
    e2e = [m["name"] for m in bench.metrics(cell, trace=False)]
    per = [m["name"] for m in bench.metrics(cell, trace=True)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for name in e2e + per:
        assert callable(bench.module("metrics", name).read)


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_files_stay_under_paths():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("fsmbench/")
    assert all(p.suffix in (".json", ".py", ".md", "")
               for p in BENCH_DIR.rglob("*") if p.is_file()
               and "__pycache__" not in p.parts)
