"""The sparse Schur engine of slampp_tpu_torch (``linear/schur_sparse.py``)
against the JAX package's on ``make_city_trees(n_poses=300,
n_landmarks=60)``: the plan's routing tables equal; in float64 the damped
and dogleg steps within 1e-8 (states, relative denominators and
predictions) and the Gauss-Newton step against the dense f64 solution
(that H's condition number is ~1.3e10, so two correct f64 solves differ by
up to cond * eps ~ 3e-6 along its weakest direction); the mixed path within ``tests/test_partitioned.py``'s bounds
(relative residual 1e-5, chi2 trajectory 1e-5); and the ``auto`` /
``use_schur`` routes of LM and dogleg, which take the engine from 1500
vertices on."""

import numpy as np
import pytest
import torch

import jax

from slampp_tpu.core import assembly as jasm
from slampp_tpu.linear.schur_sparse import SparseSchurSolver as JSS
from slampp_tpu.solvers.dogleg import DoglegSolver as JDL
from slampp_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.solvers import (DoglegSolver, GaussNewtonSolver,
                                      LevenbergMarquardtSolver)
from slampp_tpu_torch.solvers import lm as lm_mod

from tests._torch_jax_util import city_text, jax_text_system, port_text_system

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def systems():
    text = city_text(300, 60)
    return port_text_system(text), jax_text_system(text)


def _solvers(systems, mixed):
    system, jsystem = systems
    ss = SparseSchurSolver(system, mixed_precision=mixed, device="cpu")
    js = JSS(jsystem, mixed_precision=mixed)
    ss.ensure_symbolic()
    js.ensure_symbolic()
    return ss, js, system.snapshot("cpu"), jsystem.snapshot()


def test_plan_matches_jax(systems):
    ss, js, _, _ = _solvers(systems, False)
    p, jp = ss.plan, js.plan
    for f in ("n_p", "n_l", "bs", "dl", "anchor_kind", "anchor_idx", "anchor_dim", "anchor_info",
              "anchor_orig"):
        assert getattr(p, f) == getattr(jp, f), f
    for f, v in ss.tables.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jp, f)), f)
    for f in ("slot_inv", "pl_lm", "pl_pose", "pose_dx_offsets", "lm_dx_offsets", "pp_ei",
              "pp_ej"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)), f)
    # the device forms only the pair corrections the JAX package keeps (the
    # rest it routes to its dummy slot), and flags only the pose-pose H_ij
    # blocks (no other contribution is transposed); its slot table holds
    # them slot-major (each slot's order: tests/test_torch_schur_kernels.py)
    n_pp, n_pl = len(p.pp_ei), len(p.pl_lm)
    dest = np.full(len(ss.tables["src_tflag"]), -1, np.int64)
    kept = int(ss.tables["src_ends"][-1])
    dest[ss.tables["src_perm"][:kept]] = 1
    kept_pairs = np.flatnonzero(dest[3 * n_pp + n_pl:] == 1)
    np.testing.assert_array_equal(
        np.sort(p.pair_e.numpy().astype(np.int64) * n_pl + p.pair_f.numpy()),
        np.sort(ss.tables["pair_e"][kept_pairs] * n_pl + ss.tables["pair_f"][kept_pairs]))
    heads = p.slots.heads.numpy()
    np.testing.assert_array_equal(np.sort(~heads[heads < 0]),
                                  np.flatnonzero(ss.tables["src_tflag"] > 0))
    assert (ss.tables["src_tflag"][2 * n_pp:3 * n_pp] > 0).any()
    assert not ss.tables["src_tflag"][:2 * n_pp].any()
    assert not ss.tables["src_tflag"][3 * n_pp:].any()
    np.testing.assert_array_equal(p.inv_map.numpy(), np.asarray(js._inv_map))
    np.testing.assert_array_equal(p.lm_sort.numpy(), np.asarray(js._lm_sort_dev))
    for f in ("K", "M", "S", "SB", "Ms", "nnzb"):
        assert getattr(ss.v3_plan, f) == getattr(js.v3_plan, f), f


def _states_close(new, jnew, tol):
    for t in jnew:
        want = np.asarray(jnew[t])
        assert np.abs(new[t].numpy() - want).max() <= tol * max(np.abs(want).max(), 1.0), t


@pytest.mark.parametrize("alpha", [1e-2, 0.3])
def test_damped_step_matches_jax_f64(systems, alpha):
    ss, js, g, jg = _solvers(systems, False)
    new, denom, dxn, chi2 = ss.damped_step(g, alpha)
    jnew, jdenom, jdxn, jchi2 = js.damped_step(jg, alpha)
    _states_close(new, jnew, 1e-8)
    for a, b in ((denom, jdenom), (dxn, jdxn), (chi2, jchi2)):
        assert abs(float(a) - float(b)) <= 1e-8 * abs(float(b))


@pytest.mark.parametrize("delta", [0.5, 50.0])
def test_dogleg_step_matches_jax_f64(systems, delta):
    """A trust radius that cuts the step (Cauchy / blend: states, |dx|,
    the predicted reduction and chi2 within 1e-8) and one that takes the
    Gauss-Newton step (the prediction and chi2 within 1e-8; dx itself is
    held by its residual in test_gn_step_matches_jax_f64)."""
    ss, js, g, jg = _solvers(systems, False)
    new, pred, dxn, chi2 = ss.dogleg_step(g, delta)
    jnew, jpred, jdxn, jchi2 = js.dogleg_step(jg, delta)
    for a, b in ((pred, jpred), (chi2, jchi2)):
        assert abs(float(a) - float(b)) <= 1e-8 * abs(float(b))
    if float(jdxn) < delta:  # the GN step
        assert abs(float(dxn) - float(jdxn)) <= 1e-5 * float(jdxn)
        return
    assert abs(float(dxn) - float(jdxn)) <= 1e-8 * float(jdxn)
    _states_close(new, jnew, 1e-8)


def test_gn_step_matches_jax_f64(systems):
    """The GN step against the dense f64 solution of H dx = -g (condition
    ~1.3e10): the port's dx within 1e-7 of it (relative) and the chi2 after
    the step within 1e-8 of the dense step's; the JAX package's dx is
    4.5e-7 from it (its prefix-sum segment sums, linear/schur_sparse.py),
    so its chi2 is held to 1e-6 of the port's.  Both residuals within
    1e-8."""
    ss, js, g, jg = _solvers(systems, False)
    dx = ss._solve_from_terms(g, ss._edge_terms(g), 0.0)[0]
    jterms = js._edge_terms(jg, js._lm_sort_dev)
    jdx = torch.from_numpy(np.array(
        js._solve_from_terms(js.plan, js.v3_plan, js._inv_map, jg, jterms, 0.0)[0]))
    H, grad, _ = assembly.assemble_dense(g)
    dref = torch.linalg.solve(H, -grad)
    for d in (dx, jdx):
        assert float((H @ d + grad).norm() / grad.norm()) < 1e-8
    assert float((dx - dref).norm() / dref.norm()) < 1e-7
    new, dxn, chi2 = ss.gn_step(g)
    jnew, jdxn, jchi2 = js.gn_step(jg)
    c = float(assembly.graph_chi2(g.replace_states(new)))
    c_ref = float(assembly.graph_chi2(g.replace_states(assembly.apply_update(g, dref))))
    jc = float(jasm.graph_chi2(jg.replace_states(jnew)))
    assert abs(c - c_ref) <= 1e-8 * c_ref
    assert abs(c - jc) <= 1e-6 * jc
    assert abs(float(chi2) - float(jchi2)) <= 1e-10 * float(jchi2)


def test_mixed_path_residual_and_trajectory(systems):
    """Mixed mode (equilibrated f32 frames, refine 2): the damped step's
    dx solves (H + alpha I) dx = -g within 1e-5 relative, and five mixed GN
    steps track the f64 ones' chi2 within 1e-5 from the second on
    (tests/test_partitioned.py's bounds)."""
    system, _ = systems
    g = system.snapshot("cpu")
    mixed = SparseSchurSolver(system, mixed_precision=True, refine_iters=2, device="cpu")
    exact = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    mixed.ensure_symbolic()
    alpha = 1e-3
    H, grad, _ = assembly.assemble_dense(g)
    Hd = H + alpha * torch.eye(H.shape[0], dtype=H.dtype)
    dx_ref = torch.linalg.solve(Hd, -grad)
    terms = mixed._edge_terms(g)
    dx = mixed._solve_from_terms(g, terms, alpha)[0]
    assert float((Hd @ dx + grad).norm() / grad.norm()) < 1e-5
    assert abs(float(dx.norm()) - float(dx_ref.norm())) < 5e-3 * float(dx_ref.norm())

    def run(solver):
        graph, chis = g, []
        for _ in range(5):
            states, _, chi2 = solver.gn_step(graph)
            chis.append(float(chi2))
            graph = graph.replace_states(states)
        return np.array(chis + [float(assembly.graph_chi2(graph))])

    c32, c64 = run(mixed), run(exact)
    # the same start, the same converged chi2 (the first iterate may differ
    # along the weakest direction, which washes out by iteration 2)
    assert c32[0] == c64[0]
    np.testing.assert_allclose(c32[2:], c64[2:], rtol=1e-5)
    assert c32[-1] <= c32[0]


def test_lm_and_dogleg_schur_sparse_match_jax(systems):
    """LM and dogleg with engine="schur_sparse" (mixed, the solvers'
    default engine settings) against the JAX package's: the same iterations
    applied, chi2 within 1e-5 (the mixed path's bound)."""
    text = city_text(300, 60)
    for make, jmake in ((lambda s: LevenbergMarquardtSolver(s, engine="schur_sparse",
                                                            device="cpu"),
                         lambda s: JLM(s, engine="schur_sparse")),
                        (lambda s: DoglegSolver(s, engine="schur_sparse", device="cpu"),
                         lambda s: JDL(s, engine="schur_sparse"))):
        s, js = make(port_text_system(text)), jmake(jax_text_system(text))
        assert s.optimize(5) == js.optimize(5)
        assert abs(s.chi2() - js.chi2()) <= 1e-5 * js.chi2()


@pytest.mark.parametrize("kind", ["dogleg-auto", "lm-use_schur", "gn-use_schur", "dogleg-dense"])
def test_auto_routes(kind, monkeypatch):
    """From SPARSE_SCHUR_THRESHOLD vertices on a landmark graph, dogleg's
    "auto" and the use_schur routes of LM and GN take the sparse Schur
    engine, as the JAX package's; below it they stay dense; an explicit
    "dense" stays dense.  The threshold is lowered to 300 here (the JAX
    package's SLAMPP_SPARSE_SCHUR_THRESHOLD, a module constant in the
    port), and one optimize runs through the engine taken."""
    text = city_text(300, 60)
    small = port_text_system(city_text(100, 20))
    make = {"dogleg-auto": lambda s: DoglegSolver(s, device="cpu"),
            "lm-use_schur": lambda s: LevenbergMarquardtSolver(s, use_schur=True, device="cpu"),
            "gn-use_schur": lambda s: GaussNewtonSolver(s, use_schur=True, device="cpu"),
            "dogleg-dense": lambda s: DoglegSolver(s, engine="dense", device="cpu")}[kind]
    monkeypatch.setattr(lm_mod, "SPARSE_SCHUR_THRESHOLD", 300)
    system = port_text_system(text)
    solver = make(system)
    resolve = getattr(solver, "_resolve_engine", None) or solver._resolve_solver
    want = "dense" if kind == "dogleg-dense" else "schur_sparse"
    assert resolve() == want
    assert (getattr(make(small), "_resolve_engine", None) or make(small)._resolve_solver)() in (
        "dense", "schur")
    chi0 = solver.chi2()
    solver.optimize(2)
    assert solver.chi2() < chi0
    engine = getattr(solver, "_ss", None) or getattr(solver, "_sparse_schur", None)
    assert (engine is not None) == (want == "schur_sparse")
