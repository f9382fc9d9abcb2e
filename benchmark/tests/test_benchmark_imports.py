"""What the benchmark may import, compared by whole top-level names: the port's
package is named ``repmode_tpu_torch``, which begins with the JAX package's
name, so a prefix match would be wrong."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NEVER = {"jax", "jaxlib", "flax", "repmode_tpu", "bench_torch", "tools_torch", "chip_smoke"}
HARNESS = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE / "reference")))
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert "repmode_tpu_torch" not in found and not found & NEVER
    assert found <= {"__future__", "benchmark", "contextlib", "functools", "importlib", "math",
                     "numpy", "pathlib", "torch", "typing"}


def test_whole_name_compare(monkeypatch):
    monkeypatch.setitem(sys.modules, "repmode_tpu_torch_fake", sys)
    assert "repmode_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repmode_tpu.sub", sys)
    assert "repmode_tpu" in run.loaded_forbidden()


def test_a_run_of_the_cells_loads_no_jax():
    code = ("import sys, torch; from benchmark import cell, run, calibrate, faults; "
            "import repmode_tpu_torch.cli.args, repmode_tpu_torch.train.loop, "
            "repmode_tpu_torch.infer.predict; print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_alone_it_exits_without_a_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([*bench["command"][:1], "-m", "benchmark.run", "--workload",
                          bench["workloads"][0]["name"], "--seed", "2147483999", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()
