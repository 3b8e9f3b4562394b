"""The comparison that decides ``correct`` has to fail what is wrong: the
control (the reference with float16 supports) and each fault a cell can
have, planted under the timed path of a whole run on the CPU.  The fault
of a multi-card exchange has no place here: every cell runs on one card.
On a card, both cells run and come out correct."""

import json

import pytest

from fsmbench.control import readings
from fsmbench.harness import BENCH_DIR, ROOT, Bench, run

from fsmbench.tests.conftest import write_tiny

CELLS = ["bms2-spade.repeat", "gazelle-cspade.cold"]


def test_control_fails_where_supports_pass_2048(tmp_path):
    """At 12,000 sequences the most frequent items pass float16's exact
    range; every seed's control differs from the exact reference."""
    (tmp_path / "configs").mkdir()
    for name, n, minsup in (("bms2-spade", 12000, 120),
                            ("gazelle-cspade", 12000, 120)):
        cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
        cfg["data"].update(n_sequences=n, max_itemsets=40)
        cfg["minsup_abs"] = minsup
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench = Bench(ROOT / "BENCHMARK.json", [tmp_path, BENCH_DIR])
    for cell in CELLS:
        got = readings(cell, [1, 2, 2**31 + 3], bench=bench)
        assert min(got.values()) > 0, (cell, got)


def _answer_altered(orig):
    def mine(*args, **kwargs):
        res = orig(*args, **kwargs)
        (p, s), rest = res[0], res[1:]
        return [(p, s + 1)] + rest
    return mine


def _half_batch(orig, method):
    """Half of the sequences left out, the supports scaled from the rest."""
    def mine(*args, **kwargs):
        args = list(args)
        i = 1 if method else 0
        db, minsup = args[i], args[i + 1]
        args[i], args[i + 1] = db[:len(db) // 2], max(1, minsup // 2)
        return [(p, 2 * s) for p, s in orig(*args, **kwargs)]
    return mine


def _plant(monkeypatch, cell, fault):
    """``state_unchanged``: the device step whose output the search reads
    (B1's pair supports on the queue route, the windowed count of the
    max-start states for cSPADE) hands back its output buffer as it was,
    all zero, so the search never leaves the roots.  ``half_batch``: the
    entry mines the first half of the sequences at half the support and
    doubles every support.  ``answer_altered``: the entry's first pattern
    comes back with its support one higher."""
    import torch

    from spark_fsm_tpu_torch.models import spade_constrained
    from spark_fsm_tpu_torch.ops import maxstart_torch
    from spark_fsm_tpu_torch.ops import pair_support
    from spark_fsm_tpu_torch.service import devcache

    if fault == "state_unchanged":
        if cell == "bms2-spade.repeat":
            monkeypatch.setattr(
                pair_support, "pair_supports",
                lambda pt, items, n, n_words=1, n_live=None: torch.zeros(
                    pt.shape[0], n, dtype=torch.int32, device=pt.device))
        else:
            monkeypatch.setattr(
                maxstart_torch, "support", lambda m, window: torch.zeros(
                    m.shape[0], dtype=torch.int32, device=m.device))
        return
    if cell == "bms2-spade.repeat":
        orig = devcache.SpadeEngineCache.mine
        new = (_answer_altered(orig) if fault == "answer_altered"
               else _half_batch(orig, method=True))
        monkeypatch.setattr(devcache.SpadeEngineCache, "mine", new)
        return
    orig = spade_constrained.mine_cspade_torch
    new = (_answer_altered(orig) if fault == "answer_altered"
           else _half_batch(orig, method=False))
    monkeypatch.setattr(spade_constrained, "mine_cspade_torch", new)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_planted_fault_comes_out_incorrect(tmp_path, monkeypatch, cell,
                                             fault):
    bench = Bench(ROOT / "BENCHMARK.json", [write_tiny(tmp_path), BENCH_DIR])
    _plant(monkeypatch, cell, fault)
    line = run(cell, 2**31 + 29, 0.2, False, bench=bench, device="cpu")
    assert line["correct"] is False
    assert line["checks"]["worst_mine_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_mine_that_raises_is_unanswered(tmp_path, monkeypatch, cell):
    """A mine of the window that raises has no answer: it counts as failed
    and the run is not correct."""
    bench = Bench(ROOT / "BENCHMARK.json", [write_tiny(tmp_path), BENCH_DIR])
    algo = bench.module("algos", bench.load_json(
        "configs", bench.cell(cell)["config"])["algorithm"])
    orig = algo.miner
    calls = []

    def miner(cfg, mix, device):
        d = orig(cfg, mix, device)
        mine = d.mine

        def flaky(db):
            calls.append(1)
            if len(calls) == int(mix["warm_mines"]) + 1:
                raise RuntimeError("planted: the device step failed")
            return mine(db)
        d.mine = flaky
        return d
    monkeypatch.setattr(algo, "miner", miner)
    line = run(cell, 7, 0.2, False, bench=bench, device="cpu")
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"]["unanswered_mines"]["value"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_the_card(cuda_card, cell):
    line = run(cell, 2**31 + 41, 2.0, False, device="cuda")
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["kind"] == cuda_card


@pytest.mark.parametrize("cell", CELLS)
def test_drawn_databases_check_out(tmp_path, cell):
    """The output check over databases drawn from other seeds: each seed
    draws different work, and the port's mine equals the reference's."""
    from fsmbench.drawn import readings as drawn

    bench = Bench(ROOT / "BENCHMARK.json", [write_tiny(tmp_path), BENCH_DIR])
    got = drawn(cell, [3, 2**31 + 17], bench=bench, device="cpu")
    assert all(g["mismatch"] == 0 and g["path_taken"] for g in got.values())
    assert len({g["patterns"] for g in got.values()}) == 2, got


def test_drawn_check_sees_a_planted_fault(tmp_path, monkeypatch):
    from fsmbench.drawn import readings as drawn

    bench = Bench(ROOT / "BENCHMARK.json", [write_tiny(tmp_path), BENCH_DIR])
    _plant(monkeypatch, "gazelle-cspade.cold", "answer_altered")
    got = drawn("gazelle-cspade.cold", [4], bench=bench, device="cpu")
    assert got[4]["mismatch"] > 0
