"""What the harness loads and where it refuses to report: no module of the
JAX stack or the JAX package (top-level names compared whole: the port is
``slampp_tpu_torch``), nothing of the port in the references, and no result
without a card or without the port."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "slampp_tpu", "bench", "chip_smoke"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if "reference" in path.parts or "traffic" in path.parts:
        assert "slampp_tpu_torch" not in names


def test_a_tiny_run_loads_no_jax():
    code = (
        "import json, sys\n"
        "from portbench import harness\n"
        "from portbench.tests._cells import TINY\n"
        "for cell in sorted(TINY):\n"
        "    harness.run_cell(cell, 77, 0.2, False, device='cpu', overrides=TINY[cell])\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'slampp_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "sphere2500.gn_f64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_result_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
