"""The cell venice871_sim3.lm on the CPU at a small size, with the look for a
card skipped: ``correct`` is true for the program as it is, and false with
its timed path broken underneath (a step that returns its state unchanged,
half of the observations left out of the step, an answer altered where it
is produced); and such a run loads nothing of the JAX stack or package."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver

ROOT = Path(__file__).resolve().parents[2]
CELL = "venice871_sim3.lm"
# above the sparse Schur engine's 1500-vertex gate
SMALL = {"generator": {"n_cams": 24, "n_points": 1600, "mean_track": 4}}
SEED = 4294967311


def _run(**kw):
    return harness.run_cell(CELL, SEED, 0.5, False, device="cpu", overrides=SMALL, **kw)


def _faults(monkeypatch, fault):
    step, opt = SparseSchurSolver.damped_step, LevenbergMarquardtSolver.optimize_graph
    if fault == "unchanged":
        def broken(self, graph, alpha):
            _, denom, dxn, chi2 = step(self, graph, alpha)
            return graph.states, denom, dxn, chi2
        monkeypatch.setattr(SparseSchurSolver, "damped_step", broken)
    elif fault == "half_batch":
        def broken(self, graph, alpha):
            edges = {}
            for k, ea in graph.edges.items():
                info = ea.sigma_inv.clone()
                info[len(info) // 2:] = 0.0
                edges[k] = dataclasses.replace(ea, sigma_inv=info)
            return step(self, dataclasses.replace(graph, edges=edges), alpha)
        monkeypatch.setattr(SparseSchurSolver, "damped_step", broken)
    else:
        def broken(self, graph, max_iterations=5, min_dx_norm=0.01):
            out, applied, iterations = opt(self, graph, max_iterations, min_dx_norm)
            xyz = out.states["xyz"].clone()
            xyz[len(xyz) // 2, 0] += 1.0
            return out.replace_states({**out.states, "xyz": xyz}), applied, iterations
        monkeypatch.setattr(LevenbergMarquardtSolver, "optimize_graph", broken)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["window"]["iterations"] == 5 * res["attempted"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_caught(fault, monkeypatch):
    _faults(monkeypatch, fault)
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"] >= 1


def test_control_fails_a_limit():
    res = _run(control=True)
    assert not res["correct"], res["checks"]


def test_a_small_run_loads_no_jax():
    code = (
        "import json, sys\n"
        "from portbench import harness\n"
        f"harness.run_cell({CELL!r}, 77, 0.2, False, device='cpu', overrides={SMALL!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'slampp_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
