"""A run of each cell on the CPU at a small size, with the look for a card
skipped: ``correct`` is true for the program as it is, and false with its
timed path broken underneath, once for each fault the cell can have (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced; in a pose graph also one pose moved
by 0.1 m, a fault that the chi2 of the whole graph hardly sees).  A cell on one card has no exchange
between chips to leave out."""

import dataclasses

import pytest
import torch

from portbench import harness
from portbench.tests._cells import TINY
from slampp_tpu_torch.linear import ba_schur
from slampp_tpu_torch.linear.partitioned import PartitionedSolver

CELLS = sorted(TINY)
SEED = 4294967311


def _run(cell):
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu", overrides=TINY[cell])


def _half(mask):
    out = mask.clone()
    out[len(out) // 2:] = False
    return out


def _sphere_faults(monkeypatch, fault):
    gn_step, opt = PartitionedSolver.gn_step, PartitionedSolver.optimize_fused
    if fault == "unchanged":
        def step(self, graph):
            states, dxn, chi2 = gn_step(self, graph)
            return graph.states, dxn, chi2
        monkeypatch.setattr(PartitionedSolver, "gn_step", step)
    elif fault == "half_batch":
        def step(self, graph):
            edges = {k: dataclasses.replace(ea, valid=_half(ea.valid))
                     for k, ea in graph.edges.items()}
            return gn_step(self, dataclasses.replace(graph, edges=edges))
        monkeypatch.setattr(PartitionedSolver, "gn_step", step)
    else:
        shift = 1.0 if fault == "altered" else 0.1

        def optimize(self, graph, n_iters=5):
            states, dxn, c0, c1 = opt(self, graph, n_iters)
            (name, x), = states.items()
            x = x.clone()
            x[len(x) // 2, 0] += shift
            return {name: x}, dxn, c0, c1
        monkeypatch.setattr(PartitionedSolver, "optimize_fused", optimize)


def _venice_faults(monkeypatch, fault):
    step = ba_schur.BigBASolver.step
    if fault == "unchanged":
        def broken(self, cams, lms, alpha):
            _, _, dxn, chi2, denom = step(self, cams, lms, alpha)
            return cams, lms, dxn, chi2, denom
    elif fault == "half_batch":
        def broken(self, cams, lms, alpha):
            info = self.plan.obs_info.clone()
            info[len(info) // 2:] = 0.0
            plan = self.plan._replace(obs_info=info)
            return ba_schur.ba_schur_lm_step(plan, cams, lms, alpha, sc_f64=self.sc_f64,
                                             pair_f32=self.pair_f32)
    else:
        def broken(self, cams, lms, alpha):
            nc, nl, dxn, chi2, denom = step(self, cams, lms, alpha)
            nl = nl.clone()
            nl[len(nl) // 2, 0] += 1.0
            return nc, nl, dxn, chi2, denom
    monkeypatch.setattr(ba_schur.BigBASolver, "step", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("unchanged", "half_batch", "altered")
          + (("nudged",) if cell.startswith("sphere") else ())]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, monkeypatch):
    (_sphere_faults if cell.startswith("sphere") else _venice_faults)(monkeypatch, fault)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"] >= 1


def test_reference_runs_with_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res = harness.run_cell("venice871.lm", SEED, 0.2, False, device="cpu",
                               overrides=TINY["venice871.lm"], control=True)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert res["attempted"] >= 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
