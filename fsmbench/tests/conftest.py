"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's cells
at a tiny size, and the look for a card that the ``cuda`` tests take."""

import json
from pathlib import Path

import pytest

from fsmbench.harness import BENCH_DIR, ROOT, Bench

# (sequences, items, minsup, longest sequence) of each configuration at the
# tests' size; rows stay wider than one bitmap word, as at full size
TINY = {"bms2-spade": (400, 80, 4, 40), "gazelle-cspade": (500, 48, 6, 40)}


def write_tiny(base: Path) -> Path:
    """``configs/`` under ``base`` with every configuration cut to
    :data:`TINY`; the rest is found in the benchmark's own folder."""
    (base / "configs").mkdir(parents=True, exist_ok=True)
    for name, (n, items, minsup, longest) in TINY.items():
        cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
        cfg["data"].update(n_sequences=n, n_items=items, max_itemsets=longest)
        cfg["minsup_abs"] = minsup
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return base


@pytest.fixture
def tiny_bench(tmp_path) -> Bench:
    return Bench(ROOT / "BENCHMARK.json", [write_tiny(tmp_path), BENCH_DIR])


@pytest.fixture
def cuda_card():
    """Skips unless torch sees a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's cells run on one")
    return torch.cuda.get_device_name(0)
