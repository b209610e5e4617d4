"""Sim(3) bundle adjustment through the generic LM loop on a held device
graph: ``LevenbergMarquardtSolver.optimize_graph`` against ``optimize``,
its spans, and the benchmark route ``sim3_lm`` (the sparse Schur engine in
float64) against the plain reference ``portbench/reference/sim3_lm.py``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import sim3_lm as ref
from portbench.routes.sim3_lm import Route
from portbench.traffic import venice
from slampp_tpu_torch.apps.sim3 import venice_ba_system
from slampp_tpu_torch.apps.sphere import sphere_system
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver
from tests.test_torch_spans import _names, _tree

ROOT = Path(__file__).resolve().parents[1]
SS_LAYERS = ["ss.edge_terms", "ss.landmarks", "ss.pairs", "ss.assemble", "ss.backsub"]
# above the sparse Schur engine's 1500-vertex gate
SCENE = {"name": "venice", "args": {"n_cams": 24, "n_points": 1600, "mean_track": 4,
                                    "cam_rot_sigma": 0.002, "cam_t_sigma": 0.03}}
SOLVE = {"max_iterations": 5, "min_dx_norm": 0.0, "tau": 1e-3}


def _engine_system(engine):
    """(a fresh system, the solver's keywords) of each engine's small case."""
    if engine == "dense":
        return embed_ba_system_sim3(venice_ba_system(6, 40, 4)), {"engine": "dense"}
    if engine == "v3":
        return sphere_system(60), {"engine": "v3"}
    return embed_ba_system_sim3(venice_ba_system(20, 1500, 3)), {"use_schur": True}


@pytest.mark.parametrize("engine", ["dense", "v3", "schur_sparse"])
def test_optimize_is_optimize_graph_on_a_snapshot(engine):
    sys_a, kw = _engine_system(engine)
    sys_b, _ = _engine_system(engine)
    a = LevenbergMarquardtSolver(sys_a, device="cpu", **kw)
    b = LevenbergMarquardtSolver(sys_b, device="cpu", **kw)
    assert b._resolve_engine() == engine
    applied = a.optimize(4, 0.0)

    start = sys_b.snapshot("cpu")
    kept = {t: x.clone() for t, x in start.states.items()}
    graph, applied_b, iterations = b.optimize_graph(start, 4, 0.0)
    again, applied_c, iterations_c = b.optimize_graph(start, 4, 0.0)
    for t, x in start.states.items():  # the held start is left as it was
        assert torch.equal(x, kept[t])
    sys_b.update_states(graph.states)

    assert (applied_b, iterations, a.n_iterations) == (applied, 4, 4)
    assert (applied_c, iterations_c, b.n_iterations) == (applied, 4, 8)
    final_a = sys_a.snapshot("cpu").states
    for t, x in final_a.items():
        assert torch.equal(x, sys_b.snapshot("cpu").states[t])
        assert torch.equal(graph.states[t], again.states[t])


def test_optimize_graph_refuses_big_ba():
    system = venice_ba_system(6, 40, 4)
    lm = LevenbergMarquardtSolver(system, engine="big_ba", device="cpu")
    with pytest.raises(ValueError, match="big_ba"):
        lm.optimize_graph(system.snapshot("cpu"), 2, 0.0)


@pytest.mark.parametrize("reject", [False, True], ids=["sound", "worse"])
def test_lm_spans_count_the_loop(reject, monkeypatch):
    system, kw = _engine_system("schur_sparse")
    lm = LevenbergMarquardtSolver(system, device="cpu", **kw)
    graph = system.snapshot("cpu")
    if reject:  # every point moved 10 m: the chi2 rises and the gain test rejects
        step = SparseSchurSolver.damped_step

        def worse(self, g, alpha):
            states, denom, dxn, chi2 = step(self, g, alpha)
            return {**states, "xyz": states["xyz"] + 10.0}, denom, dxn, chi2
        monkeypatch.setattr(SparseSchurSolver, "damped_step", worse)
    lm._ss_solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, applied, iterations = lm.optimize_graph(graph, 3, 0.0)
    tree = _tree(prof, ("lm.", "ss."))
    assert _names(tree) == ["lm.solve"]
    passes = tree[0][1]
    assert _names(passes) == ["lm.chi2"] + ["lm.iteration"] * iterations
    assert iterations == 3
    outcomes = []
    for _, inner in passes[1:]:
        names = _names(inner)
        assert names[:6] == SS_LAYERS + ["lm.chi2"] and len(names) == 7
        outcomes.append(names[6])
    assert outcomes.count("lm.accept") == applied
    assert outcomes.count("lm.reject") == iterations - applied
    assert applied == (0 if reject else 3)


@pytest.mark.parametrize("seed", [11, 2147483659])
def test_route_matches_the_reference_in_float64(seed):
    route = Route({"generator": SCENE}, SOLVE, seed, "cpu")
    assert route.lm._resolve_engine() == "schur_sparse"
    route.lm._ss_solver().mixed_precision = False
    raw, iterations = route.solve()
    out = route.output(raw)
    assert iterations == 5
    r = ref.run(route.inputs(), SOLVE, "cpu")
    assert r["iterations"] == 5
    nums = ref.compare(r, out)
    assert nums["resid_err"] < 1e-7, nums
    assert nums["chi2_rel"] < 1e-10, nums
    assert r["chi2"] < 0.5 * r["chi2_accepted"][0]


def test_reference_step_solves_the_full_system():
    cams, pts, oc, op, uv, info, _ = venice.make_venice_ba_arrays(
        n_cams=8, n_points=60, mean_track=4, seed=3)
    prob = ref.Problem(cams, pts, oc, op, uv, info, "cpu")
    alpha = 0.5
    nc, npt, _, _ = prob.step(prob.cams0, prob.points0, alpha, pair_chunk=16)
    # dense: H = J^T W J + alpha I + the anchor, dx = -H^-1 g
    r, Jp, Jc = prob.jacobians(prob.cams0, prob.points0)
    n_c, n_p, m = prob.n_c, prob.n_p, r.shape[0]
    J = torch.zeros(m, 2, 7 * n_c + 3 * n_p, dtype=torch.float64)
    for o in range(m):
        c, p = int(prob.oc[o]), int(prob.op[o])
        J[o, :, 7 * c:7 * c + 7] = Jc[o]
        J[o, :, 7 * n_c + 3 * p:7 * n_c + 3 * p + 3] = Jp[o]
    J = J.reshape(2 * m, -1)
    W = torch.block_diag(*prob.W)
    H = J.T @ W @ J + alpha * torch.eye(J.shape[1], dtype=torch.float64)
    kind, idx = prob.anchor
    a = 7 * idx if kind == "cam" else 7 * n_c + 3 * idx
    d = 7 if kind == "cam" else 3
    H[a:a + d, a:a + d] += torch.eye(d, dtype=torch.float64)
    dx = -torch.linalg.solve(H, J.T @ W @ r.reshape(-1))
    np.testing.assert_allclose((npt - prob.points0).reshape(-1), dx[7 * n_c:], rtol=1e-8,
                               atol=1e-10)
    expect = ref.retract_cameras(prob.cams0, dx[:7 * n_c].reshape(n_c, 7))
    np.testing.assert_allclose(nc, expect, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("part", ["f32_pairs", "f32_edge_terms"])
def test_reference_control_moves_the_step_by_rounding(part):
    cams, pts, oc, op, uv, info, _ = venice.make_venice_ba_arrays(
        n_cams=8, n_points=60, mean_track=4, seed=3)
    exact = ref.Problem(cams, pts, oc, op, uv, info, "cpu")
    rounded = ref.Problem(cams, pts, oc, op, uv, info, "cpu", **{part: True})
    nc, npt, _, _ = exact.step(exact.cams0, exact.points0, 0.5, pair_chunk=16)
    nc32, npt32, _, _ = rounded.step(rounded.cams0, rounded.points0, 0.5, pair_chunk=16)
    assert nc32.dtype == npt32.dtype == torch.float64
    step = torch.cat([(nc - exact.cams0).reshape(-1), (npt - exact.points0).reshape(-1)])
    gap = torch.cat([(nc32 - nc).reshape(-1), (npt32 - npt).reshape(-1)])
    # float32 rounding of one part: the step moves, by far less than itself
    assert 1e-9 < float(gap.abs().max() / step.abs().max()) < 0.05


def test_reference_exp_and_log_are_inverse():
    g = torch.Generator().manual_seed(0)
    v = torch.randn(64, 7, dtype=torch.float64, generator=g)
    v[:, 3:6] *= 0.5  # angles below pi: the log's own range
    v[:8, 6] = 0.0
    v[8:16, 3:6] = 0.0
    back = ref.sim3_log(*ref.sim3_exp(v))
    np.testing.assert_allclose(back, v, rtol=1e-10, atol=1e-12)


def test_reference_loads_no_program():
    code = ("import json, sys\n"
            "import portbench.reference.sim3_lm\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "    ('jax', 'jaxlib', 'flax', 'slampp_tpu', 'slampp_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
