"""One run of one cell: set-up, the measured window, the reference, the line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds everything by name, in the first of its search directories
that has it (``fsmbench/`` itself by default):

- ``configs/<config>.json``: the database's shape and scale, the mine's
  parameters (``algorithm``, ``minsup_abs``, ...) and the guarantees;
- ``traffic/<mix>.json``: ``mode`` (which entry the algorithm's miner
  calls), ``warm_mines`` (set-up mines) and ``fail_unless`` (what a mine's
  statistics must show to count as having taken the cell's path);
- ``algos/<algorithm>.py``: ``miner(config, mix, device)``, an object
  with ``mine(db) -> (patterns, stats)`` and ``close()``, and
  ``reference(config, db, count)``, the plain reference's patterns;
- ``metrics/<metric>.py``: ``read(records)`` returns the metric or
  ``None``; an optional ``install(records)`` puts in the wrappers it
  reads from and returns their undo.

A run makes the database from the seed, warms up with the mix's set-up
mines, then mines in a closed loop (one client, the next mine when the
last one returns) until ``seconds`` have passed.  Once the window has
closed and the program's state is freed, the reference mines the same
database once and every mine of the window is held to it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from fsmbench.records import Mine, Records

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names no run may hold (the JAX package is spark_fsm_tpu;
# the port, spark_fsm_tpu_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_fsm_tpu")


class RunError(Exception):
    """A run that must end without a result line; ``code`` is its exit code."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared as whole names."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def guard_imports(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: forbidden modules are loaded: "
                       f"{', '.join(found)}", code=3)


class Bench:
    """``BENCHMARK.json`` and the directories its names are found in."""

    def __init__(self, manifest: Path = ROOT / "BENCHMARK.json",
                 search: Sequence[Path] = (BENCH_DIR,)):
        self.manifest = json.loads(Path(manifest).read_text())
        self.search = [Path(p) for p in search]

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for base in self.search:
            path = base / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise RunError(f"no {kind}/{name}{suffix} under "
                       f"{', '.join(map(str, self.search))}")

    def load_json(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        key = f"fsmbench_{kind}_{name}".replace("-", "_").replace(".", "_")
        mod = sys.modules.get(key)
        if mod is None or getattr(mod, "__file__", None) != str(path):
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return mod

    def cell(self, workload: str) -> dict:
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(cells: {', '.join(sorted(cells))})", code=2)
        return cells[workload]

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The cell's metrics for this kind of run: end-to-end ones without
        the trace, per-layer ones with it."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def compare(got, want) -> int:
    """Patterns that differ between a mine and the reference: the size of
    the symmetric difference of their (pattern, support) sets, or 1 where
    the sets agree but the lists do not (order or duplicates)."""
    if got == want:
        return 0
    n = len(set(got) ^ set(want))
    return n if n else 1


def _passes(stats: dict, rules) -> bool:
    ops = {"==": lambda a, b: a == b, ">": lambda a, b: a > b,
           ">=": lambda a, b: a >= b}
    return all(key in stats and ops[op](stats[key], want)
               for key, op, want in rules)


def _device_checks(device: str, chips: int):
    import torch

    if device != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: this benchmark "
                       "runs on a CUDA card", code=2)
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} card(s), torch sees "
                       f"{torch.cuda.device_count()}", code=2)
    return torch.cuda.get_device_name(0)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        bench: Optional[Bench] = None, device: str = "cuda",
        t_start: Optional[float] = None, log=sys.stderr) -> dict:
    """Run one cell and return its result line as a dict.  ``device`` is
    ``"cuda"`` on the card; the tests pass ``"cpu"``, where the port's
    entries run their plain versions and no device metric exists.  Raises
    :class:`RunError` where the run must print no result."""
    t0 = time.perf_counter() if t_start is None else t_start
    bench = bench or Bench()
    cell = bench.cell(workload)
    kind = _device_checks(device, int(cell["chips"]))
    import torch

    cfg = bench.load_json("configs", cell["config"])
    mix = bench.load_json("traffic", cell["traffic"])
    algo = bench.module("algos", cfg["algorithm"])
    gen = bench.module("gen", "synth")
    readers = [(m, bench.module("metrics", m["name"]))
               for m in bench.metrics(workload, trace)]
    rec = Records()

    # set-up: the database from the seed, the program, its warm-up mines
    phases = {"start": time.perf_counter() - t0}
    db = gen.make_db(cfg["data"], seed)
    phases["database"] = time.perf_counter() - t0
    miner = algo.miner(cfg, mix, device)
    setup_stats = {}
    for k in range(int(mix.get("warm_mines", 1))):
        _, stats = miner.mine(db)
        _sync(device)
        phases[f"warm mine {k + 1}"] = time.perf_counter() - t0
        if k == 0:
            setup_stats = stats
    guard_imports("after set-up")
    undo = [u for _, r in readers if hasattr(r, "install")
            for u in [r.install(rec)] if u is not None]
    tracer = None
    if trace:
        from fsmbench.trace import Tracer

        tracer = Tracer(cuda=device == "cuda")
    setup_peak = torch.cuda.max_memory_allocated() if kind else 0
    if kind:
        torch.cuda.reset_peak_memory_stats()
    if tracer:
        tracer.start()

    # the window: a closed loop of mines, every one of them timed
    results, attempted, failed, raised = [], 0, 0, []
    rec.on = True
    w0, w_ns0 = rec.clock0 = (time.perf_counter(), time.time_ns())
    rec.setup_s = w0 - t0
    while time.perf_counter() - w0 < seconds:
        attempted += 1
        m0 = time.perf_counter()
        try:
            res, stats = miner.mine(db)
            _sync(device)
        except Exception as exc:  # a mine that fails is counted, not fatal
            failed += 1
            raised.append(f"{type(exc).__name__}: {exc}")
            results.append(None)
            continue
        rec.mines.append(Mine(time.perf_counter() - m0, stats))
        results.append(res)
        if not _passes(stats, mix.get("fail_unless", ())):
            failed += 1
    w1 = time.perf_counter()
    w_ns1 = time.time_ns()
    rec.on = False
    first_stats = rec.mines[0].stats if rec.mines else None
    rec.window_s = w1 - w0
    rec.window_ns = (w_ns0, w_ns1)
    host = []
    if tracer:
        tracer.stop()
        rec.device_events, host = tracer.events()
    for u in reversed(undo):
        u()
    if kind:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    peak = max(setup_peak, rec.memory_peak_bytes or 0)

    metrics = {}
    for m, reader in readers:
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out_device = {"platform": "gpu" if kind else "cpu",
                  "kind": kind or "cpu", "count": int(cell["chips"]),
                  "memory_peak_bytes": peak}
    extra = {}
    if trace:
        from fsmbench.trace import breakdown

        out_device["busy_s"] = rec.device_busy_s() or 0.0
        out_device["window_s"] = (w_ns1 - w_ns0) / 1e9
        bd = breakdown(rec, host, rec.epoch_spans())
        if bd:
            extra["breakdown"] = bd

    # the program's state goes before the reference runs
    miner.close()
    del miner, rec, host
    gc.collect()
    if kind:
        torch.cuda.empty_cache()
    guard_imports("after the window")

    t_ref = time.perf_counter()
    want = algo.reference(cfg, db)
    ref_s = time.perf_counter() - t_ref
    diffs = [compare(r, want) for r in results if r is not None]
    checks = {
        "unanswered_mines": {"value": len(raised), "limit": 0},
        "worst_mine_mismatch": {"value": max(diffs, default=0), "limit": 0},
    }
    correct = bool(diffs) and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    for msg in raised[:3]:
        print(f"mine failed: {msg}", file=log)
    print("first set-up mine's counters: " + json.dumps(
        {k: v for k, v in setup_stats.items()
         if isinstance(v, (bool, int, float, str))}), file=log)
    if first_stats is not None:
        print("first window mine's counters: " + json.dumps(
            {k: v for k, v in first_stats.items()
             if isinstance(v, (bool, int, float, str))}),
            file=log)
    print("set-up, seconds from process start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=log)
    print(f"reference: {len(want)} patterns in {ref_s:.3f} s; "
          f"{len(diffs)} mines compared; window {seconds} s, "
          f"{attempted} attempted, {failed} failed", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": out_device, **extra,
            "checks": checks}
