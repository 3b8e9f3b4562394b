"""The port stands alone: it imports neither ``jax`` nor anything of the
``spark_fsm_tpu`` package.

The import check runs in a subprocess, because this test process has
already imported jax (tests/conftest.py).  There a ``sys.meta_path`` finder
refuses ``jax`` and ``spark_fsm_tpu`` (the exact package and its
submodules, not the ``spark_fsm_tpu_torch`` prefix), every port module is
imported, and a tiny SPADE mine (through the router: the queue engine),
the same mine pinned to the dense and the classic engines, a tiny TSR mine
(on the resident-frontier route), tiny SPAM mines (the pure-bitmap and the
hybrid plan), a tiny cSPADE mine and a two-push stream through both
window miners (``streaming.*``) run on the CPU, the vertical build through
the native tokenizer, and a rule trie is built from TSR and SPADE output
and scored (``ops.rule_trie``, ``service.predictor``), and the SPADE,
SPAM, TSR, cSPADE and incremental mines run again on a 1-rank gloo mesh
(``parallel.mesh``, ``parallel.multihost``, ``parallel.launch``) and the
SPADE, SPAM, TSR and cSPADE mines once more in two class partitions
(``parallel.partition``), and the service boots on the CPU
(``service.app``), answers a TSR train, get and predict round trip and
prewarms an envelope (``service.prewarm``, ``utils.shapes``' enumerator,
``utils.jitcache``)."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import spark_fsm_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "spark_fsm_tpu_torch"

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        for banned in ("jax", "spark_fsm_tpu"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import spark_fsm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from spark_fsm_tpu_torch import mine_spade_torch, parse_spmf
from spark_fsm_tpu_torch.models.oracle import mine_spade
from spark_fsm_tpu_torch.utils.canonical import patterns_text
db = parse_spmf("1 3 -1 2 -1 2 4 -2\n1 -1 2 -2\n3 -1 2 4 -2\n1 3 -1 4 -2\n")
for fused in ("auto", "dense", "never"):
    assert patterns_text(mine_spade_torch(db, 2, device="cpu", fused=fused)) == patterns_text(mine_spade(db, 2))
from spark_fsm_tpu_torch.data import fasttok
assert fasttok.backend() == "native", fasttok.reason()
from spark_fsm_tpu_torch import mine_tsr_torch
from spark_fsm_tpu_torch.models.tsr import mine_tsr_cpu
from spark_fsm_tpu_torch.utils.canonical import rules_text
assert rules_text(mine_tsr_torch(db, 3, 0.5, device="cpu")) == rules_text(mine_tsr_cpu(db, 3, 0.5))
from spark_fsm_tpu_torch import mine_spam_torch
from spark_fsm_tpu_torch.models.spam_bitmap import mine_spam_cpu
for kw in ({}, {"density_crossover": 0.9}):
    assert patterns_text(mine_spam_torch(db, 2, device="cpu", **kw)) == patterns_text(mine_spade(db, 2))
    assert patterns_text(mine_spam_cpu(db, 2, **kw)) == patterns_text(mine_spade(db, 2))
from spark_fsm_tpu_torch.models.oracle import mine_cspade
from spark_fsm_tpu_torch.models.spade_constrained import mine_cspade_torch
assert patterns_text(mine_cspade_torch(db, 2, maxgap=1, maxwindow=2, device="cpu")) == patterns_text(mine_cspade(db, 2, maxgap=1, maxwindow=2))
from spark_fsm_tpu_torch.streaming import IncrementalWindowMiner, WindowMiner
inc = IncrementalWindowMiner(2, max_batches=2, device="cpu")
rem = WindowMiner(2, max_batches=2, device="cpu")
for b in (db[:2], db[2:], db[1:3]):
    assert patterns_text(inc.push(b)) == patterns_text(rem.push(b)) == patterns_text(mine_spade(inc.window.sequences(), 2))
assert inc.stats["swept_batches"] == 3 and inc.window.evicted_batches == 1
tstats = {}
mine_tsr_torch(db, 3, 0.5, device="cpu", stats_out=tstats)
assert tstats["resident"] is True, tstats
from spark_fsm_tpu_torch import build_trie, predict_host, rules_from_patterns, score_wave
from spark_fsm_tpu_torch.service import model, predictor
rules = mine_tsr_torch(db, 3, 0.5, device="cpu") + rules_from_patterns(mine_spade(db, 2))
trie = build_trie(rules, depth_floor=4, device="cpu")
waves = score_wave(trie, [[], [1], [1, 3], [2, 4]], 3)
assert waves == [predict_host(rules, p, 3) for p in ([], [1], [1, 3], [2, 4])] and waves[1], waves
assert predictor.predict_rules(model.serialize_rules(rules), "rules", [3, 1], 3, device="cpu") == waves[2]
from spark_fsm_tpu_torch.parallel import launch, multihost
from spark_fsm_tpu_torch.parallel.mesh import local_mesh
mesh = local_mesh("cpu")
assert patterns_text(mine_spade_torch(db, 2, mesh=mesh)) == patterns_text(mine_spade(db, 2))
assert patterns_text(mine_spam_torch(db, 2, mesh=mesh)) == patterns_text(mine_spade(db, 2))
assert rules_text(mine_tsr_torch(db, 3, 0.5, mesh=mesh)) == rules_text(mine_tsr_cpu(db, 3, 0.5))
assert patterns_text(mine_cspade_torch(db, 2, maxgap=1, maxwindow=2, mesh=mesh)) == patterns_text(mine_cspade(db, 2, maxgap=1, maxwindow=2))
inc = IncrementalWindowMiner(2, max_batches=2, mesh=mesh)
assert patterns_text(inc.push(db)) == patterns_text(mine_spade(db, 2))
assert mesh.reduce_stats()["all_reduces"] > 0 and not multihost.is_multihost(mesh)
assert launch.free_port() > 0
from spark_fsm_tpu_torch.parallel import partition
assert patterns_text(mine_spade_torch(db, 2, device="cpu", partition_parts=2)) == patterns_text(mine_spade(db, 2))
assert patterns_text(mine_spam_torch(db, 2, device="cpu", partition_parts=2)) == patterns_text(mine_spade(db, 2))
assert rules_text(mine_tsr_torch(db, 3, 0.5, device="cpu", partition_parts=2)) == rules_text(mine_tsr_cpu(db, 3, 0.5))
assert patterns_text(mine_cspade_torch(db, 2, maxgap=1, maxwindow=2, device="cpu", partition_parts=2)) == patterns_text(mine_cspade(db, 2, maxgap=1, maxwindow=2))
assert partition.tallies()["mines"] == {"tsr": 1, "spade": 1, "spam": 1, "cspade": 1}
import json, time, urllib.parse, urllib.request
from spark_fsm_tpu_torch.service.app import serve_background
srv = serve_background(device="cpu")
def post(endpoint, **params):
    url = f"http://127.0.0.1:{srv.server_port}{endpoint}"
    with urllib.request.urlopen(url, data=urllib.parse.urlencode(params).encode(), timeout=60) as r:
        return json.loads(r.read().decode())
from spark_fsm_tpu_torch.data.spmf import format_spmf
assert post("/train", uid="iso", algorithm="TSR_TPU", k="3", minconf="0.5", source="INLINE", sequences=format_spmf(db))["status"] == "started"
for _ in range(600):
    if post("/status/iso")["status"] in ("finished", "failure"):
        break
    time.sleep(0.05)
assert post("/status/iso")["status"] == "finished"
assert model.deserialize_rules(post("/get/rules", uid="iso")["data"]["rules"]) == mine_tsr_cpu(db, 3, 0.5)
got = json.loads(post("/predict", uid="iso", items="3,1", m="3")["data"]["predictions"])
assert got == predict_host(mine_tsr_cpu(db, 3, 0.5), [1, 3], 3), got
assert post("/admin/stats")["backend"] == "cpu"
report = post("/admin/prewarm", sequences="4", items="4", tsr="1")
assert report["keys"] and not [r for r in report["keys"] if "error" in r], report
listing = post("/admin/shapes")
assert listing["enumerated"] == report["enumerated"] and isinstance(listing["drift"], list)
srv.master.shutdown(); srv.shutdown()
from spark_fsm_tpu_torch.utils import jitcache, shapes
assert jitcache.enable_compile_counter() and jitcache.compile_counts()["count"] == 0
assert jitcache.enable_compile_cache()
assert shapes.enumerate_shapes(shapes.WorkloadSpec(n_sequences=4, n_items=4, tsr=True, fusion_jobs=2), device="cpu")
for name in ("ops.extend_prune", "ops.spam_bitops", "models.spam_bitmap", "service.planner",
             "data.fasttok", "models.spade_queue", "models.spade_fused",
             "ops.resident_frontier", "ops.maxstart_torch", "ops.maxstart_np",
             "models.spade_constrained", "streaming.window",
             "streaming.incremental", "ops.rule_trie", "service.model",
             "service.predictor", "parallel.mesh", "parallel.multihost",
             "parallel.launch", "parallel.partition", "config",
             "service.app", "service.actors", "service.plugins",
             "service.devcache", "service.store", "service.sources",
             "service.remote", "service.fusion", "service.meshguard",
             "service.resultcache", "service.lease", "streaming.consumer",
             "streaming.kafka", "utils.obs", "utils.jobctl", "utils.shapes",
             "service.prewarm", "utils.jitcache", "service.fleet"):
    assert "spark_fsm_tpu_torch." + name in names, name
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the blocker let jax through")
assert not any(m == "jax" or m.startswith(("jax.", "spark_fsm_tpu."))
               or m == "spark_fsm_tpu" for m in sys.modules), "leaked import"
print("IMPORTED", len(names))
"""


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(
        spark_fsm_tpu_torch.__path__, "spark_fsm_tpu_torch.")]


def test_port_imports_and_mines_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"IMPORTED {len(_port_modules())}" in proc.stdout


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _smoke_helpers():
    """The ``tests/_torch_*.py`` helpers that ``chip_smoke.py`` imports:
    they run on the card's host, which has neither jax nor the
    reference."""
    names = {name for name in _imported_names(ROOT / "chip_smoke.py")
             if name.startswith("_torch_")}
    return sorted(ROOT / "tests" / f"{name}.py" for name in names)


def test_no_source_line_imports_jax_or_the_reference():
    helpers = _smoke_helpers()
    for name in ("_torch_miniredis.py", "_torch_storm.py",
                 "_torch_minies.py"):
        assert ROOT / "tests" / name in helpers
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + helpers)
    assert len(files) > 10
    assert PORT / "service" / "fleet.py" in files
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_fsm_tpu"), (path, name)
