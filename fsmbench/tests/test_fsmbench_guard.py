"""The import guard, the reference's independence of the port, and the
runs that must print no result."""

import ast
import json
import os
import subprocess
import sys

import pytest

from fsmbench.harness import BENCH_DIR, ROOT, RunError, forbidden_modules, \
    guard_imports


def test_forbidden_names_compare_whole():
    names = ["spark_fsm_tpu_torch", "spark_fsm_tpu_torch.models.spade",
             "jaxtyping", "flaxen", "numpy", "torch"]
    assert forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "spark_fsm_tpu", "spark_fsm_tpu.models.spade_tpu"]
    assert forbidden_modules(names + bad) == sorted(bad)


def test_guard_refuses_a_loaded_jax(monkeypatch):
    import types

    guard_imports("clean")
    monkeypatch.setitem(sys.modules, "spark_fsm_tpu.models",
                        types.ModuleType("spark_fsm_tpu.models"))
    with pytest.raises(RunError) as err:
        guard_imports("after set-up")
    assert err.value.code != 0 and "spark_fsm_tpu.models" in str(err.value)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py"))
                         + sorted((BENCH_DIR / "gen").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "typing", "dataclasses", "math", "numpy",
                    "fsmbench"}, tops


def test_reference_loads_no_port_module():
    code = ("import sys; import fsmbench.reference.fast, "
            "fsmbench.reference.oracle, fsmbench.gen.synth; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'spark_fsm_tpu_torch', 'spark_fsm_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run_cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "fsmbench/run.py", "--workload", "bms2-spade.repeat",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_bare_benchmark_folder_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "fsmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
