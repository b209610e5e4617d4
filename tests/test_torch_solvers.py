"""The batch solvers of slampp_tpu_torch against the JAX package: Gauss-Newton
on the native and dense engines, Levenberg-Marquardt and dogleg on the dense
and partitioned (v3) engines, the partitioned solver's prior step, the
gated update and the LM damping scale, and the routes that are not ported.
Float64 paths agree with the JAX package to 1e-8 (states, chi2) and take the
same accept / reject decisions; mixed-precision paths are held to the bounds
of tests/test_partitioned.py.  On the CPU every dense kernel call takes its
plain PyTorch version."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jax_asm
from slampp_tpu.linear import partitioned as P
from slampp_tpu.linear.native import NativeBlockSolver as JaxNative
from slampp_tpu.solvers import gauss_newton as jax_gn, lm as jax_lm
from slampp_tpu.solvers.dogleg import DoglegSolver as JaxDL
from slampp_tpu.solvers.lm import LevenbergMarquardtSolver as JaxLM
from slampp_tpu_torch.apps import manhattan
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.linear.native import NativeBlockSolver
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.solvers import DoglegSolver, GaussNewtonSolver, LevenbergMarquardtSolver
from slampp_tpu_torch.solvers.gauss_newton import _gn_step

from _torch_jax_util import jax_solver_reference, jax_system, port_graph, port_system

torch.set_num_threads(1)
N, LOOP = 120, 0.5  # 122 edges: 22 loop closures


def _states_close(port_states, jax_states, atol):
    for k, v in jax_states.items():
        np.testing.assert_allclose(port_states[k].numpy(), np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)


def test_gated_update_and_lm_damping_match_jax():
    """apply_update_gated (threshold 0 is apply_update) and the LM initial
    damping scale against the JAX package, f64."""
    jg = jax_system(N, loop_prob=LOOP).snapshot()
    graph = port_graph(jg)
    dx = np.random.default_rng(0).normal(scale=0.05, size=graph.state_dim)
    for thr in (0.0, 0.06):
        s = assembly.apply_update_gated(graph, torch.from_numpy(dx), thr)
        _states_close(s, jax_asm.apply_update_gated(jg, jnp.asarray(dx), thr), 1e-12)
    _states_close(assembly.apply_update(graph, torch.from_numpy(dx)),
                  jax_asm.apply_update(jg, jnp.asarray(dx)), 1e-12)
    moved = (s["pose2d"] != graph.states["pose2d"]).any(1)
    assert 0 < int(moved.sum()) < graph.states["pose2d"].shape[0]
    d = float(assembly.max_edge_hessian_diag(graph))
    assert abs(d - float(jax_lm._max_edge_hessian_diag(jg))) <= 1e-12 * d


def test_solve_spd_and_the_abort_path():
    """solve_spd matches the library solve on an SPD matrix and carries NaN,
    not an exception, on one that is not positive definite; LM with a
    negative damping scale then aborts before applying a step, as the JAX
    package does."""
    rng = np.random.default_rng(1)
    G = rng.normal(size=(30, 30))
    A = torch.from_numpy(G @ G.T + 30 * np.eye(30))
    b = torch.from_numpy(rng.normal(size=30))
    np.testing.assert_allclose(solve_spd(A, b).numpy(), torch.linalg.solve(A, b).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert bool(torch.isnan(solve_spd(A - 200 * torch.eye(30, dtype=A.dtype), b)).all())
    jlm = JaxLM(jax_system(N, loop_prob=LOOP), tau=-10.0)
    lm = LevenbergMarquardtSolver(port_system(N, loop_prob=LOOP), tau=-10.0, device="cpu")
    assert lm.optimize() == jlm.optimize() == 0
    assert lm.n_iterations == jlm.n_iterations == 1


@pytest.mark.parametrize("kind", ["native", "dense"])
def test_gn_solver_matches_jax(kind):
    """GN per iteration (chi2 at entry, states) and through
    GaussNewtonSolver.optimize (iterations applied, final states, chi2),
    f64 1e-8; "auto" resolves to "native" on a pose graph."""
    jsystem = jax_system(N, loop_prob=LOOP)
    jg = jsystem.snapshot()
    graph = port_graph(jg)
    if kind == "native":
        jstep = JaxNative(jsystem).gn_step
        step = NativeBlockSolver(port_system(N, loop_prob=LOOP), device="cpu").gn_step
    else:
        jstep, step = jax_gn._gn_step, _gn_step
    for _ in range(3):
        js, jn, jc = jstep(jg)
        s, dn, c = step(graph)
        assert abs(float(c) - float(jc)) <= 1e-8 * float(jc)
        assert abs(float(dn) - float(jn)) <= 1e-8 * (1.0 + float(jn))
        _states_close(s, js, 1e-8)
        jg, graph = jg.replace_states(js), graph.replace_states(s)

    jsolver = jax_gn.GaussNewtonSolver(jax_system(N, loop_prob=LOOP), linear_solver=kind)
    system = port_system(N, loop_prob=LOOP)
    solver = GaussNewtonSolver(system, linear_solver=kind, device="cpu")
    assert solver.optimize(5, 0.01) == jsolver.optimize(5, 0.01)
    assert abs(solver.chi2() - jsolver.chi2()) <= 1e-8 * jsolver.chi2()
    _states_close(system.snapshot("cpu").states, jsolver.system.snapshot().states, 1e-8)
    assert GaussNewtonSolver(system, device="cpu")._resolve_solver() == "native"
    assert set(solver.timer.acc) >= {"gn_step", "snapshot", "writeback"}


def _decisions(text, solver):
    """The accept / reject words of LM, or each dogleg iteration's rho and
    radius, from the solvers' verbose lines (same format in both packages)."""
    if solver == "lm":
        return re.findall(r"LM iter \d+: (accepted|rejected)", text)
    return re.findall(r"DL iter \d+: chi2=\S+ (rho=\S+ radius=\S+)", text)


@pytest.mark.parametrize("engine", ["dense", "v3"])
@pytest.mark.parametrize("solver", ["lm", "dl"])
def test_lm_dogleg_f64_match_jax(solver, engine, capsys):
    """LM and dogleg on the dense engine and on the v3 engine in exact f64
    mode (its PartitionedSolver built as the solvers build it, with
    mixed_precision=False): the same accept / reject sequence (LM) or rho and
    radius sequence (dogleg) as the JAX package, the same iterations
    applied, final chi2 and states within 1e-8."""
    jsystem, system = jax_system(N, loop_prob=LOOP), port_system(N, loop_prob=LOOP)
    if solver == "lm":
        js = JaxLM(jsystem, verbose=True, engine=engine)
        ps = LevenbergMarquardtSolver(system, verbose=True, engine=engine, device="cpu")
    else:
        js = JaxDL(jsystem, verbose=True, engine=engine)
        ps = DoglegSolver(system, verbose=True, engine=engine, device="cpu")
    if engine == "v3":
        js._v3 = P.PartitionedSolver(jsystem, refine_iters=2, mixed_precision=False)
        ps._v3 = PartitionedSolver(system, refine_iters=2, mixed_precision=False, device="cpu")
    capsys.readouterr()
    applied_j = js.optimize(5, 0.01)
    out_j = capsys.readouterr().out
    applied = ps.optimize(5, 0.01)
    out = capsys.readouterr().out
    assert applied == applied_j and ps.n_iterations == js.n_iterations
    assert _decisions(out, solver) == _decisions(out_j, solver) and _decisions(out, solver)
    assert abs(ps.chi2() - js.chi2()) <= 1e-8 * js.chi2()
    _states_close(system.snapshot("cpu").states, jsystem.snapshot().states, 1e-8)
    if solver == "dl":
        assert abs(ps.radius - js.radius) <= 1e-8 * js.radius


@pytest.mark.parametrize("solver", ["lm", "dl"])
def test_lm_dogleg_v3_mixed_converge(solver):
    """LM and dogleg through the v3 engine in its default mixed mode reach the
    dense GN optimum within 1e-4 (tests/test_partitioned.py:152-174)."""
    g = port_system(N, loop_prob=LOOP).snapshot("cpu")
    for _ in range(8):
        s, _, _ = _gn_step(g)
        g = g.replace_states(s)
    chi_opt = float(assembly.graph_chi2(g))
    if solver == "lm":
        s = LevenbergMarquardtSolver(port_system(N, loop_prob=LOOP), engine="v3", device="cpu")
        s.optimize(max_iterations=15)
    else:
        s = DoglegSolver(port_system(N, loop_prob=LOOP), engine="v3", initial_radius=10.0,
                         device="cpu")
        s.optimize(max_iterations=20)
    assert s._v3.mixed_precision and s._v3.refine_iters == 2
    assert abs(s.chi2() - chi_opt) / chi_opt < 1e-4


def _prior_case(ps_cls, system, mixed, **kw):
    vorder = list(system._vorder)
    forced = vorder[10:20:3] + vorder[100:110:4]  # scattered vertex ids
    ps = ps_cls(system, target=16, mixed_precision=mixed, refine_iters=3 if mixed else 0,
                forced_separator=forced, **kw)
    ps.symbolic()
    sep = [int(b) for b in ps.separator_blocks]
    for v in forced:
        assert vorder.index(v) in sep
    bs, SB, Ms = 3, len(sep), ps.plan.Ms
    rng = np.random.default_rng(0)
    G = rng.normal(size=(SB * bs, SB * bs))
    sc = np.zeros((Ms, Ms))
    sc[: SB * bs, : SB * bs] = G @ G.T + np.eye(SB * bs)  # SPD prior on the separator frame
    rp = np.zeros(Ms)
    rp[: SB * bs] = rng.normal(size=SB * bs)
    return ps, sep, sc, rp


@pytest.mark.parametrize("mixed", [False, True])
def test_gn_step_prior_matches_jax_and_dense(mixed, monkeypatch):
    """gn_step_prior with a forced separator and a dense SPD prior against
    the JAX package's (same separator; states 1e-8 exact, 5e-5 mixed with its
    separator through the dense kernels) and against the dense solve of
    (H + P) dx = -(g + p) (tests/test_partitioned.py:177-260: 1e-6 exact,
    5e-5 mixed with refinement)."""
    monkeypatch.setattr(P, "_CHAIN_SEP_XLA", False)
    jsystem, system = jax_system(160, seed=4), port_system(160, seed=4)
    jps, jsep, jsc, jrp = _prior_case(P.PartitionedSolver, jsystem, mixed)
    ps, sep, sc, rp = _prior_case(PartitionedSolver, system, mixed, device="cpu")
    assert sep == jsep and ps.plan.Ms == jps.plan.Ms
    jg = jsystem.snapshot()
    graph = port_graph(jg)
    js, jdn, jc = jps.gn_step_prior(jg, jsc, jrp)
    s, dn, c = ps.gn_step_prior(graph, sc, rp)
    assert abs(float(c) - float(jc)) < 1e-9 * max(float(jc), 1.0)
    _states_close(s, js, 5e-5 if mixed else 1e-8)

    H, g, _ = assembly.assemble_dense(graph)
    H, g = H.clone(), g.clone()
    offsets, _ = system._layout()
    vorder = list(system._vorder)
    idx = torch.as_tensor(np.concatenate([np.arange(offsets[vorder[b]], offsets[vorder[b]] + 3)
                                          for b in sep]))
    SB3 = 3 * len(sep)
    H[idx[:, None], idx[None, :]] += torch.from_numpy(sc[:SB3, :SB3])
    g[idx] += torch.from_numpy(rp[:SB3])
    ref = assembly.apply_update(graph, torch.linalg.solve(H, -g))
    for k in ref:
        np.testing.assert_allclose(s[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=5e-5 if mixed else 1e-6)


@pytest.mark.parametrize("make", [
    lambda s: GaussNewtonSolver(s, use_schur=True, device="cpu"),
    lambda s: GaussNewtonSolver(s, linear_solver="schur", device="cpu"),
    lambda s: GaussNewtonSolver(s, linear_solver="schur_sparse", device="cpu"),
    lambda s: LevenbergMarquardtSolver(s, use_schur=True, device="cpu"),
    lambda s: LevenbergMarquardtSolver(s, engine="schur_sparse", device="cpu"),
    lambda s: LevenbergMarquardtSolver(s, engine="big_ba", device="cpu"),
    lambda s: DoglegSolver(s, engine="schur_sparse", device="cpu"),
], ids=["gn-use_schur", "gn-schur", "gn-schur_sparse", "lm-use_schur", "lm-schur_sparse",
        "lm-big_ba", "dl-schur_sparse"])
def test_schur_routes_not_ported_raise(make):
    """The Schur engines are not ported: each route raises and names its
    ROADMAP item, instead of running another engine."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        make(port_system(20))


@pytest.mark.parametrize("cls", [GaussNewtonSolver, LevenbergMarquardtSolver, DoglegSolver])
def test_solvers_run_on_the_card_by_default(cls):
    """Without device="cpu" a solver runs on the card; with no card its
    optimize raises instead of running on the CPU."""
    solver = cls(port_system(20))
    assert solver.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver.optimize()


@pytest.mark.parametrize("phase,nls,engine", [
    ("gn", "lambda", None), ("lm", "lambda-lm", None), ("lm-v3", "lambda-lm", "v3"),
    ("dl", "lambda-dl", None), ("dl-v3", "lambda-dl", "v3"),
])
def test_run_solver_matches_jax_reference(phase, nls, engine, monkeypatch):
    """apps/manhattan.run_solver, as chip_smoke.py drives it, against the JAX
    package's CLI-built solver on the seed-0 manhattan200 graph (the
    reference of tests/_torch_jax_util.py): f64 chi2 within 1e-6 and the
    same iterations applied; mixed v3 chi2 within the bench's 5e-3."""
    monkeypatch.setattr(P, "_CHAIN_SEP_XLA", False)
    chi2_j, applied_j = jax_solver_reference(200, nls, engine)
    res = manhattan.run_solver(200, "cpu", nls, engine)
    tol = 5e-3 if engine == "v3" else 1e-6
    assert abs(res["chi2_final"] - chi2_j) <= tol * chi2_j
    if engine is None:
        assert res["applied"] == applied_j
    assert res["chi2_final"] < res["chi2_init"]
    assert all(bool(torch.isfinite(s).all()) for s in res["states"].values())
    if nls == "lambda":
        assert res["levels"] > 1


def test_prior_runner_and_cli_on_cpu():
    """apps/manhattan.run_prior's mixed step against its dense oracle, and
    the CLI's --solver route, on the CPU."""
    res = manhattan.run_prior(200, "cpu")
    assert res["residual"] < 1e-5 and res["residual_ref"] < 1e-12 and res["chain_mode"]
    assert res["max_state_err"] < 1e-4 * max(1.0, res["max_abs_dx_ref"])
    assert abs(res["dx_norm"] - res["dx_norm_ref"]) <= 1e-4 * res["dx_norm_ref"]
    out = subprocess.run(
        [sys.executable, "-m", "slampp_tpu_torch.apps.manhattan", "60", "cpu", "--solver",
         "lambda-lm", "--engine", "v3"],
        capture_output=True, text=True, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert '"solver": "lambda-lm"' in out.stdout and '"engine": "v3"' in out.stdout
