"""The plain references agree with the port on the CPU at small sizes,
with the port in float64 (its exact paths), far inside the cells' limits;
and the venice reference's Schur complement agrees with the full normal
equations solved densely."""

import numpy as np
import pytest
import torch

from portbench.reference import ba_lm, se3_gn
from portbench.routes import ba_lm as ba_route
from portbench.routes import v3_gn
from portbench.tests._cells import TINY


@pytest.mark.parametrize("seed", [5, 3000000019])
def test_se3_gn_matches_the_port_in_float64(seed):
    config = {"generator": {"name": "sphere", "args": TINY["sphere2500.gn_f64"]["generator"]}}
    solve = {"n_iters": 5, "mixed_precision": False, "target": 64, "refine_iters": 0}
    route = v3_gn.Route(config, solve, seed, "cpu")
    out = route.output(route.solve()[0])
    ref = se3_gn.run(route.inputs(), solve, "cpu")
    nums = se3_gn.compare(ref, out)
    assert nums["resid_err"] < 1e-9 and nums["chi2_rel"] < 1e-12


@pytest.mark.parametrize("seed", [5, 3000000019])
def test_ba_lm_matches_the_port_in_float64(seed):
    config = {"generator": {"name": "venice", "args": TINY["venice871.lm"]["generator"]}}
    solve = {"max_iterations": 5, "min_dx_norm": 0.0, "tau": 1e-3, "sc_f64": True,
             "pair_f32": False}
    route = ba_route.Route(config, solve, seed, "cpu")
    raw, steps = route.solve()
    ref = ba_lm.run(route.inputs(), solve, "cpu")
    nums = ba_lm.compare(ref, route.output(raw))
    assert steps == 5 and nums["resid_err"] < 1e-7 and nums["chi2_rel"] < 1e-10


def test_ba_schur_step_solves_the_full_system():
    from portbench.traffic import venice

    cams, pts, oc, op, uv, info, _ = venice.make_venice_ba_arrays(
        n_cams=8, n_points=60, mean_track=4, seed=3)
    prob = ba_lm.Problem(cams, pts, oc, op, uv, info, "cpu")
    alpha = 0.5
    nc, npt, _, _ = prob.step(prob.cams0, prob.points0, alpha, pair_chunk=16)
    # dense: H = J^T W J + alpha I + anchor on camera 0, dx = -H^-1 g
    r, Jp, Jc = ba_lm.residuals_and_jacobians(prob.points0[prob.op], prob.cams0[prob.oc], prob.uv)
    n_c, n_p, m = prob.n_c, prob.n_p, r.shape[0]
    J = torch.zeros(m, 2, 6 * n_c + 3 * n_p, dtype=torch.float64)
    for o in range(m):
        c, p = int(prob.oc[o]), int(prob.op[o])
        J[o, :, 6 * c:6 * c + 6] = Jc[o]
        J[o, :, 6 * n_c + 3 * p:6 * n_c + 3 * p + 3] = Jp[o]
    J = J.reshape(2 * m, -1)
    W = torch.block_diag(*prob.W)
    H = J.T @ W @ J + alpha * torch.eye(J.shape[1], dtype=torch.float64)
    H[:6, :6] += torch.eye(6, dtype=torch.float64)
    dx = -torch.linalg.solve(H, J.T @ W @ r.reshape(-1))
    np.testing.assert_allclose((npt - prob.points0).reshape(-1), dx[6 * n_c:], rtol=1e-8,
                               atol=1e-10)
