"""Sim(3) in slampp_tpu_torch against the JAX package on the same seeded
inputs: every ``geometry/sim3.py`` function in float64 within 1e-12
(both Taylor branches, the worked example of slam_app/Main.h:731-809,
near-pi rotations); every Sim(3) edge type's residual and Jacobian
against ``jax.jacfwd`` within 1e-10 absolute; ``embed_ba_system_sim3``;
dense LM on the embedded ``make_ba_scene`` with the same chi2 trajectory
(1e-9) and accepted steps; the sparse Schur engine at 7 x 7 pose blocks
(its routing tables, built by the port's vectorised symbolic, equal to the
JAX package's loops; its float64 step within 1e-8; the mixed step's
residual within 1e-5) and ``apps/sim3.run_sim3_venice``'s procedure at a
small venice-class size."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jasm
from slampp_tpu.geometry import sim3 as jsim3
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.linear.schur_sparse import SparseSchurSolver as JSS
from slampp_tpu.models import sim3 as jax_msim3
from slampp_tpu.solvers import lm as jax_lm
from slampp_tpu_torch.apps import sim3 as app
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.geometry import sim3
from slampp_tpu_torch.graph.types import get_edge_type
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.models import sim3 as msim3
from slampp_tpu_torch.solvers import LevenbergMarquardtSolver
from slampp_tpu_torch.solvers import lm as lm_mod

from tests._torch_jax_util import ba_scene_text, jax_text_system, port_text_system

torch.set_num_threads(1)
F64 = torch.float64


def _logs(rng, n=12):
    """Random sim(3) vectors and the special cases: a rotation below the
    small-angle threshold, a scale below the small-sigma one, both, no
    motion at all, and rotations within 1e-6 of pi."""
    v = rng.normal(0, 0.6, (n, 7))
    v[0, 3:6] = [1e-9, -2e-9, 5e-10]
    v[1, 6] = 3e-10
    v[2, 3:6], v[2, 6] = [2e-9, 0.0, -1e-9], -4e-10
    v[3] = 0.0
    for i, axis in ((4, [0.0, 0.0, 1.0]), (5, [1.0, 2.0, -0.5])):
        a = np.asarray(axis) / np.linalg.norm(axis)
        v[i, 3:6] = (np.pi - 1e-6) * a
    return v


def _close(got, want, tol):
    want = np.asarray(want)
    scale = np.maximum(np.abs(want), 1.0)
    assert np.all(np.abs(got.detach().numpy() - want) <= tol * scale), (
        float(np.max(np.abs(got.detach().numpy() - want) / scale)))


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _logs(rng), _logs(rng)[::-1].copy()
    X = rng.normal(0, 2.0, (len(a), 3))
    intr = np.tile([500.0, 510.0, 320.0, 240.0, 0.05], (len(a), 1))
    Xl = X + np.array([0.0, 0.0, 6.0])
    ta, tb = (torch.tensor(x, dtype=F64) for x in (a, b))
    tX, tXl, ti = (torch.tensor(x, dtype=F64) for x in (X, Xl, intr))
    vm = jax.vmap
    Ea, Eb = sim3.sim3_exp(ta), sim3.sim3_exp(tb)
    jEa, jEb = vm(jsim3.sim3_exp)(a), vm(jsim3.sim3_exp)(b)
    _close(Ea, jEa, 1e-12)
    _close(sim3.sim3_log(Ea), vm(jsim3.sim3_log)(jEa), 1e-12)
    _close(sim3.compose_tRs(Ea, Eb), vm(jsim3.compose_tRs)(jEa, jEb), 1e-12)
    _close(sim3.inverse_tRs(Ea), vm(jsim3.inverse_tRs)(jEa), 1e-12)
    _close(sim3.transform_tRs(Ea, tX), vm(jsim3.transform_tRs)(jEa, X), 1e-12)
    _close(sim3.inv_transform_tRs(Ea, tX), vm(jsim3.inv_transform_tRs)(jEa, X), 1e-12)
    _close(sim3.plus(ta, 0.1 * tb), vm(jsim3.plus)(a, 0.1 * b), 1e-12)
    _close(sim3.absolute_to_relative(ta, tb), vm(jsim3.absolute_to_relative)(a, b), 1e-12)
    _close(sim3.relative_to_absolute(ta, tb), vm(jsim3.relative_to_absolute)(a, b), 1e-12)
    inv = sim3.xyz_to_invdepth(tXl)
    _close(inv, vm(jsim3.xyz_to_invdepth)(Xl), 1e-12)
    _close(sim3.invdepth_to_xyz(inv), vm(jsim3.invdepth_to_xyz)(np.asarray(inv)), 1e-12)
    _close(sim3.invdepth_plus(inv, 0.1 * tX), vm(jsim3.invdepth_plus)(np.asarray(inv), 0.1 * X),
           1e-12)
    cam = 0.2 * ta
    _close(sim3.project_p2c_xyz(cam, ti, tXl), vm(jsim3.project_p2c_xyz)(0.2 * a, intr, Xl), 1e-12)
    _close(sim3.project_p2c_local_xyz(tXl, ti), vm(jsim3.project_p2c_local_xyz)(Xl, intr), 1e-12)
    _close(sim3.local_to_other(tX, ta, tb), vm(jsim3.local_to_other)(X, a, b), 1e-12)
    _close(sim3.world_to_local(ta, tX), vm(jsim3.world_to_local)(a, X), 1e-12)
    uv = torch.tensor(rng.normal(300, 80, (len(a), 2)), dtype=F64)
    uv[0] = torch.tensor([320.0, 240.0], dtype=F64)  # the principal point
    ray = sim3.backproject_ray(uv, ti)
    _close(ray, vm(jsim3.backproject_ray)(uv.numpy(), intr), 1e-12)
    ray[1] = torch.tensor([0.95, 0.1, np.sqrt(1 - 0.95 ** 2 - 0.01)], dtype=F64)  # picks y
    _close(sim3.tangent_angle_error(ray, tXl),
           vm(jsim3.tangent_angle_error)(ray.numpy(), Xl), 1e-12)
    sq = (ta[:, 3:6] ** 2).sum(-1)
    _close(torch.stack(sim3._sinc_coeffs(sq), -1),
           np.stack(vm(jsim3._sinc_coeffs)(sq.numpy()), -1), 1e-12)
    _close(sim3._W_matrix(ta[:, 3:6], ta[:, 6]), vm(jsim3._W_matrix)(a[:, 3:6], a[:, 6]), 1e-12)


def test_worked_example_round_trip():
    """slam_app/Main.h:731-809: tRs (2, 2, 2, [0, 0.523608, 0], 0.799988)
    has the log (1.62293, 2.23145, 2.74863, 0, 0.523608, 0, -0.223158);
    the port's log equals the JAX package's within 1e-12 and exp returns
    the tRs."""
    tRs = np.array([2.0, 2.0, 2.0, 0.0, 0.523608, 0.0, 0.799988])
    v = sim3.sim3_log(torch.tensor(tRs, dtype=F64))
    np.testing.assert_allclose(v.numpy(), [1.62293, 2.23145, 2.74863, 0.0, 0.523608, 0.0,
                                           -0.223158], atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jsim3.sim3_log(jnp.asarray(tRs))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sim3.sim3_exp(v).numpy(), tRs, rtol=0, atol=1e-12)


# ------------------------------------------------------------------ edges
INTR = np.array([500.0, 510.0, 320.0, 240.0, 0.05])


def _sigma(rng, n):
    """Log scales of 0.02 to 0.1 in size.  Between the small-sigma guard
    (1e-8) and about 1e-3, W's (s - 1) / sigma cancels: the last-bit
    difference of two libraries' exp (XLA's, ATen's) grows there to ~1e-11
    of W, ~1e-9 of a pixel residual, in the JAX package's formula as in the
    port's.  The guard branch itself is held in test_geometry_matches_jax."""
    return rng.choice([-1.0, 1.0], (n, 1)) * rng.uniform(0.02, 0.1, (n, 1))


def _cam(rng, n):
    """camsim3 states: cameras near (0, 0, -5), small rotation and scale,
    so that points near the origin lie in front."""
    log = np.concatenate([rng.normal(0, 0.2, (n, 2)), rng.normal(-5, 0.2, (n, 1)),
                          rng.normal(0, 0.1, (n, 3)), _sigma(rng, n)], 1)
    return np.concatenate([log, np.tile(INTR, (n, 1))], 1)


def _slot_states(rng, vtype, n):
    if vtype == "camsim3":
        return _cam(rng, n)
    if vtype == "xyz":
        return rng.normal(0, 1.0, (n, 3)) + np.array([0.0, 0.0, 3.0])
    if vtype == "invdepth":
        return np.asarray(jax.vmap(jsim3.xyz_to_invdepth)(
            rng.normal(0, 1.0, (n, 3)) + np.array([0.0, 0.0, 4.0])))
    if vtype == "invdist":
        ray = rng.normal(0, 0.2, (n, 3)) + np.array([0.0, 0.0, 1.0])
        ray /= np.linalg.norm(ray, axis=1, keepdims=True)
        return np.concatenate([rng.uniform(0.15, 0.3, (n, 1)), ray], 1)
    if vtype == "sim3":
        return np.concatenate([rng.normal(0, 0.5, (n, 6)), _sigma(rng, n)], 1)
    if vtype == "pose3d":
        return rng.normal(0, 0.5, (n, 6))
    raise AssertionError(vtype)


def _meas(rng, name, n):
    uv = rng.normal([320.0, 240.0], 60.0, (n, 2))
    if name in ("edge_pose_sim3", "edge_pose_cam_sim3"):
        return np.concatenate([rng.normal(0, 0.3, (n, 6)), _sigma(rng, n)], 1)
    if "_ls" in name:
        return np.concatenate([uv, np.tile(INTR, (n, 1))], 1)
    return uv


SIM3_EDGES = [n for n in (
    "edge_p2c_xyz_sim3_g", "edge_p2c_invdepth_sim3_g", "edge_p2c_xyz_sim3_ls",
    "edge_p2c_invdepth_sim3_ls", "edge_p2c_xyz_sim3_lo", "edge_p2c_invdepth_sim3_lo",
    "edge_p2c_invdist_sim3_ls", "edge_p2c_invdist_sim3_lo", "edge_pose_sim3",
    "edge_pose_cam_sim3")] + [n + "_angle" for n in (
        "edge_p2c_xyz_sim3_g", "edge_p2c_invdepth_sim3_g", "edge_p2c_xyz_sim3_ls",
        "edge_p2c_invdepth_sim3_ls", "edge_p2c_invdist_sim3_ls", "edge_p2c_xyz_sim3_lo",
        "edge_p2c_invdepth_sim3_lo", "edge_p2c_invdist_sim3_lo")]


def jax_edge_jacobians(name, states, meas):
    """The JAX package's residuals and jacfwd Jacobians of one edge type."""
    et = jax_edge_type(name)
    vts = tuple(jax_vertex_type(t) for t in et.vertex_types)
    return jax.jit(jax.vmap(lambda *a: jasm._edge_residual_and_jacobians(
        et, vts, a[:-1], a[-1])))(*states, meas)


@pytest.mark.parametrize("name", SIM3_EDGES)
def test_edge_jacobians_match_jacfwd(name):
    rng = np.random.default_rng(len(name))
    et = get_edge_type(name)
    n = 16
    states = [_slot_states(rng, t, n) for t in et.vertex_types]
    meas = _meas(rng, name, n)
    r, jacs = et.jacobian_fn(tuple(torch.tensor(s, dtype=F64) for s in states),
                             torch.tensor(meas, dtype=F64))
    jr, jjacs = jax_edge_jacobians(name, states, meas)
    assert len(jacs) == len(jjacs) == et.arity
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-10)
    np.testing.assert_allclose(r.numpy(), et.error_fn(
        tuple(torch.tensor(s, dtype=F64) for s in states), torch.tensor(meas, dtype=F64)).numpy(),
        rtol=0, atol=0)
    for J, jJ in zip(jacs, jjacs):
        assert np.isfinite(np.asarray(jJ)).all()
        np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=0, atol=1e-10)


# -------------------------------------------------------------- embedding
@pytest.fixture(scope="module")
def embedded():
    text = ba_scene_text(10, 200, seed=5)
    return (msim3.embed_ba_system_sim3(port_text_system(text)),
            jax_msim3.embed_ba_system_sim3(jax_text_system(text)))


def test_embed_matches_jax(embedded):
    system, jsystem = embedded
    assert system._vorder == jsystem._vorder
    assert system.vertex_type_names == jsystem.vertex_type_names == ["camsim3", "xyz"]
    for vid in jsystem._vorder:
        np.testing.assert_allclose(system.vertex_state(vid), np.asarray(jsystem.vertex_state(vid)),
                                   rtol=0, atol=1e-12)
    rec, jrec = system._edges["edge_p2c_xyz_sim3_g"], jsystem._edges["edge_p2c_xyz_sim3_g"]
    assert rec["vids"] == [list(v) for v in jrec["vids"]]
    np.testing.assert_array_equal(np.stack(rec["meas"]), np.stack(jrec["meas"]))
    np.testing.assert_array_equal(np.stack(rec["sigma_inv"]), np.stack(jrec["sigma_inv"]))
    assert abs(float(assembly.graph_chi2(system.snapshot("cpu")))
               - float(jasm.graph_chi2(jsystem.snapshot()))) <= 1e-12 * float(
        jasm.graph_chi2(jsystem.snapshot()))


def test_lm_trajectory_matches_jax(monkeypatch):
    """ref_parity.py's sim3_ba_10cam_200pts: dense LM, 20 iterations: every
    candidate's chi2 within 1e-9 of the JAX package's, the same accepted
    steps."""
    text = ba_scene_text(10, 200, seed=5)
    system = msim3.embed_ba_system_sim3(port_text_system(text))
    jsystem = jax_msim3.embed_ba_system_sim3(jax_text_system(text))
    seen, jseen = [], []
    chi2_fn, jchi2_fn = assembly.graph_chi2, jax_lm._chi2

    def record(graph):
        out = chi2_fn(graph)
        seen.append(float(out))
        return out

    def jrecord(graph):
        out = jchi2_fn(graph)
        jseen.append(float(out))
        return out

    monkeypatch.setattr(assembly, "graph_chi2", record)
    monkeypatch.setattr(jax_lm, "_chi2", jrecord)
    lm = LevenbergMarquardtSolver(system, device="cpu")
    jlm = jax_lm.LevenbergMarquardtSolver(jsystem)
    assert lm.optimize(20, 1e-6) == jlm.optimize(20, 1e-6)
    assert len(seen) == len(jseen) >= 5
    np.testing.assert_allclose(seen, jseen, rtol=1e-9)


# ---------------------------------------------------------- sparse Schur
def test_schur_sparse_bs7_matches_jax(embedded):
    """The sparse Schur engine on the embedded scene (7 x 7 camera blocks,
    3 x 3 landmarks): routing tables equal to the JAX package's, the f64
    damped step within 1e-8, the mixed step's dx solving the damped system
    within 1e-5 (tests/test_torch_schur_sparse.py's bounds)."""
    system, jsystem = embedded
    ss = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    js = JSS(jsystem, mixed_precision=False)
    ss.ensure_symbolic()
    js.ensure_symbolic()
    assert (ss.plan.bs, ss.plan.dl) == (7, 3)
    for f, v in ss.tables.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js.plan, f)), f)
    for f in ("K", "M", "S", "SB", "Ms", "nnzb"):
        assert getattr(ss.v3_plan, f) == getattr(js.v3_plan, f), f
    g, jg = system.snapshot("cpu"), jsystem.snapshot()
    alpha = 1e-2
    new, denom, dxn, chi2 = ss.damped_step(g, alpha)
    jnew, jdenom, jdxn, jchi2 = js.damped_step(jg, alpha)
    for t in jnew:
        want = np.asarray(jnew[t])
        assert np.abs(new[t].numpy() - want).max() <= 1e-8 * max(np.abs(want).max(), 1.0), t
    for a, b in ((denom, jdenom), (dxn, jdxn), (chi2, jchi2)):
        assert abs(float(a) - float(b)) <= 1e-8 * abs(float(b))

    mixed = SparseSchurSolver(system, mixed_precision=True, refine_iters=2, device="cpu")
    mixed.ensure_symbolic()
    H, grad, _ = assembly.assemble_dense(g)
    Hd = H + alpha * torch.eye(H.shape[0], dtype=F64)
    dx = mixed._solve_from_terms(g, mixed._edge_terms(g), alpha)[0]
    assert float((Hd @ dx + grad).norm() / grad.norm()) < 1e-5


def test_run_sim3_venice_small_matches_jax(monkeypatch):
    """apps/sim3.run_sim3_venice's procedure at 16 cameras and 600 points
    (the sparse Schur gate lowered to 300 vertices in both packages):
    the sparse Schur engine taken, chi2 before within 1e-12 and after 3 LM
    iterations within 1e-8 of the JAX package's f64 run of the same
    procedure, the same accepted count; the port's mixed run within 1e-5
    of its own f64 run."""
    from tests._torch_jax_util import jax_sim3_venice

    monkeypatch.setattr(lm_mod, "SPARSE_SCHUR_THRESHOLD", 300)
    monkeypatch.setenv("SLAMPP_SPARSE_SCHUR_THRESHOLD", "300")
    res = app.run_sim3_venice(16, 600, 10, "cpu", iters=3, f64_check=True)
    ref = jax_sim3_venice(16, 600, 10, iters=3, mixed=False)
    assert res["engine"] == "schur_sparse" and res["n_obs"] == ref["n_obs"]
    assert abs(res["chi2_init"] - ref["chi2_init"]) <= 1e-12 * ref["chi2_init"]
    assert res["f64"]["lm_accepted"] == ref["lm_accepted"] == res["lm_accepted"]
    assert abs(res["f64"]["chi2_final"] - ref["chi2_final"]) <= 1e-8 * ref["chi2_final"]
    assert abs(res["chi2_final"] - res["f64"]["chi2_final"]) <= 1e-5 * ref["chi2_final"]
