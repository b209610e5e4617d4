"""The native sparse engines of slampp_tpu_torch against the JAX package:
the v2 plan (equal tables), the v2 factorization and solves (f64, 1e-10),
the mixed refined solve (residual), the supernodal panel block plan and its
assembly (equal plans, f64 1e-12), the native GN step at (v1, panel 8),
(v2, panel 1) and (v2, panel 4) (chi2 1e-9 relative, states 1e-8), mixed v2
(residual bound and converged chi2 within 1e-6), ``optimize_fused`` (eager
on the CPU) and the C++ min-degree ordering (equal orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly as jax_ba, native_host, ordering as jax_ord, sparse_chol2 as jax_sc2
from slampp_tpu.core.assembly import graph_chi2 as jax_graph_chi2
from slampp_tpu.linear.native import NativeBlockSolver as JaxNative, _native_optimize_fused
from slampp_tpu_torch.core import assembly, block_assembly, ordering, sparse_chol2
from slampp_tpu_torch.linear.native import NativeBlockSolver

from _torch_jax_util import (assert_segments_equal, jax_system, pack_v2, permute_blocks,
                             port_block_plan, port_graph, port_system, random_block_spd)

torch.set_num_threads(1)
t = torch.from_numpy


def _tensor_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_v2_matches_jax(seed):
    """col_order, slot_of, rows, cols, the level windows and every padded
    index table equal the JAX package's for the same pairs."""
    _, pairs = random_block_spd(60, 3, extra_pairs=40, seed=seed)
    jp, p = jax_sc2.plan_v2(60, pairs), sparse_chol2.plan_v2(60, pairs, "cpu")
    assert p.slot_of == jp.slot_of
    for f in jp._fields:
        if f == "slot_of":
            continue
        a, b = getattr(p, f), getattr(jp, f)
        if isinstance(b, int):
            assert a == b, f
        else:
            np.testing.assert_array_equal(_tensor_np(a), np.asarray(b), err_msg=f)
    assert p.ud_a.dtype == torch.int64 and len(p.levels) == jp.n_levels


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_factor_solve2_matches_jax(bs, seed):
    """factorize2 / solve2 / spmv2 on the same plan: the factors and the
    solution equal JAX's to 1e-10 (f64), and L L^T = A
    (tests/test_sparse_chol2.py:26-53)."""
    n = 30
    A, pairs = random_block_spd(n, bs, extra_pairs=25, seed=seed)
    plan, jplan = sparse_chol2.plan_v2(n, pairs, "cpu"), jax_sc2.plan_v2(n, pairs)
    Ap = permute_blocks(A, plan.col_order, bs)
    D, O = pack_v2(Ap, plan, bs)
    Ld, Lo = sparse_chol2.factorize2(plan, t(D), t(O))
    Ldj, Loj = jax.jit(lambda d, o: jax_sc2.factorize2(jplan, d, o))(jnp.asarray(D), jnp.asarray(O))
    np.testing.assert_allclose(Ld.numpy(), np.asarray(Ldj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Lo.numpy(), np.asarray(Loj), rtol=0, atol=1e-10)
    Lfull = np.zeros_like(Ap)
    for (i, j), s in plan.slot_of.items():
        Lfull[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = (Ld[s] if i == j else Lo[s - n]).numpy()
    np.testing.assert_allclose(np.tril(Lfull) @ np.tril(Lfull).T, Ap, atol=1e-8)

    b = np.random.default_rng(seed + 7).normal(size=(n, bs))
    x = sparse_chol2.solve2(plan, Ld, Lo, t(b)).numpy()
    xj = jax.jit(lambda a, c, d: jax_sc2.solve2(jplan, a, c, d))(Ldj, Loj, jnp.asarray(b))
    np.testing.assert_allclose(x, np.asarray(xj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.reshape(-1), np.linalg.solve(Ap, b.reshape(-1)), atol=1e-8)
    y = sparse_chol2.spmv2(plan, t(D), t(O), t(b)).numpy()
    np.testing.assert_allclose(y.reshape(-1), Ap @ b.reshape(-1), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("bs", [3, 6])
def test_solve_refined2_by_residual(bs):
    """The mixed refined solve (f32 factor, 3 f64 refinements) against JAX's
    and the dense solve, by the residual: raw f32 dx is not compared."""
    n = 30
    A, pairs = random_block_spd(n, bs, extra_pairs=25, seed=0)
    plan, jplan = sparse_chol2.plan_v2(n, pairs, "cpu"), jax_sc2.plan_v2(n, pairs)
    Ap = permute_blocks(A, plan.col_order, bs)
    D, O = pack_v2(Ap, plan, bs)
    b = np.random.default_rng(3).normal(size=(n, bs))
    x = sparse_chol2.solve_refined2(plan, t(D), t(O), t(b), refine_iters=3).numpy().reshape(-1)
    xj = np.asarray(jax.jit(lambda d, o, r: jax_sc2.solve_refined2(jplan, d, o, r, refine_iters=3))(
        jnp.asarray(D), jnp.asarray(O), jnp.asarray(b))).reshape(-1)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(Ap @ x - b.reshape(-1)) / bn < 1e-9
    assert np.linalg.norm(Ap @ (x - xj)) / bn < 1e-9


@pytest.mark.parametrize("engine", ["v1", "v2"])
@pytest.mark.parametrize("panel", [2, 8])
def test_panel_block_plan_matches_jax(panel, engine):
    """The supernodal block plan on a 93-pose graph (a partial last panel at
    panel 2 and 8) equals JAX's: dx_offsets, panel_diag_slots,
    panel_diag_reg and the reduction plans; the assembled vals / rhs / chi2
    on it equal JAX's to 1e-12, and the unused scalars carry the unit
    diagonal."""
    jsystem = jax_system(93, loop_prob=0.3)
    js = JaxNative(jsystem, panel=panel, engine=engine)
    js.symbolic()
    ns = NativeBlockSolver(port_system(93, loop_prob=0.3), panel=panel, engine=engine, device="cpu")
    ns.symbolic()
    bp, jbp = ns.block_plan, js.block_plan
    assert (bp.n, bp.bs, bp.P, bp.nnzb, bp.anchor_diag_slot, bp.anchor_off) == (
        jbp.n, jbp.bs, jbp.P, jbp.nnzb, jbp.anchor_diag_slot, jbp.anchor_off)
    for f in ("dx_offsets", "panel_diag_slots", "panel_diag_reg", "asm_inv_map", "rhs_inv_map"):
        np.testing.assert_array_equal(getattr(bp, f).numpy(), np.asarray(getattr(jbp, f)), err_msg=f)
    assert_segments_equal(bp.asm_grp, jbp.asm_grp)
    assert_segments_equal(bp.rhs_grp, jbp.rhs_grp)
    assert np.asarray(jbp.panel_diag_reg).sum() == (-93 % panel) * 3

    jg = jsystem.snapshot()
    jv, jr, jc = jax.jit(lambda g: jax_ba.assemble_blocks_sorted(g, jbp))(jg)
    v, r, c = block_assembly.assemble_blocks_sorted(port_graph(jg), bp)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-12)
    assert abs(float(c) - float(jc)) <= 1e-12 * (1.0 + float(jc))
    # the same assembly on the plan handed over from JAX
    v2, _, _ = block_assembly.assemble_blocks_sorted(port_graph(jg), port_block_plan(jbp))
    np.testing.assert_array_equal(v2.numpy(), v.numpy())
    x = np.random.default_rng(1).normal(size=(jbp.n, jbp.P))
    np.testing.assert_array_equal(
        block_assembly.scatter_dx(bp, t(x)).numpy(),
        np.asarray(jax_ba.scatter_dx(jbp, jnp.asarray(x), jbp.bs)))


@pytest.mark.parametrize("engine,panel", [("v1", 8), ("v2", 1), ("v2", 4)])
def test_native_gn_step_matches_jax(engine, panel):
    """NativeBlockSolver.gn_step against the JAX package's on the same
    graph (tests/test_sparse_chol2.py:85-93): chi2 within 1e-9 relative,
    states within 1e-8; the plans agree level for level."""
    jsystem = jax_system(150, loop_prob=0.5)
    jg = jsystem.snapshot()
    js = JaxNative(jsystem, panel=panel, engine=engine)
    jst, jn, jc = js.gn_step(jg)
    ns = NativeBlockSolver(port_system(150, loop_prob=0.5), panel=panel, engine=engine,
                           device="cpu")
    st, dn, c = ns.gn_step(port_graph(jg))
    jlevels = js.plan2.n_levels if engine == "v2" else js.dplan.lvl_diag.shape[0]
    assert ns.n_levels == jlevels > 1
    assert abs(float(c) - float(jc)) <= 1e-9 * float(jc)
    assert abs(float(dn) - float(jn)) <= 1e-8 * (1.0 + float(jn))
    for k in jst:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=0, atol=1e-8)


@pytest.mark.parametrize("panel", [1, 4])
def test_mixed_v2_by_residual_and_converged_chi2(panel):
    """Mixed v2 (f32 factor, one f64 refinement): its dx within the residual
    bound ||H dx + g|| / ||g|| < 1e-5 and JAX's dx through H,
    ||H (dx - dx_jax)|| / ||g|| < 1e-5 (raw f32 dx is not compared: the
    prefix sums round in another order); then iterated to convergence, its
    chi2 within 1e-6 of the f64 v1 optimum (tests/test_sparse_chol2.py:95-113)."""
    jsystem = jax_system(150, loop_prob=0.5)
    jg = jsystem.snapshot()
    graph = port_graph(jg)
    ns = NativeBlockSolver(port_system(150, loop_prob=0.5), panel=panel, engine="v2",
                           mixed_precision=True, refine_iters=1, device="cpu")
    js = JaxNative(jsystem, panel=panel, engine="v2", mixed_precision=True, refine_iters=1)
    ns.symbolic()
    js.symbolic()
    bp, jbp = ns.block_plan, js.block_plan
    vals, rhs, _ = block_assembly.assemble_blocks_sorted(graph, bp)
    n, n_off = ns.plan2.n, ns.plan2.n_off
    x = sparse_chol2.solve_refined2(ns.plan2, vals[:n], vals[n : n + n_off], -rhs[:-1])
    dx = block_assembly.scatter_dx(bp, x)

    @jax.jit
    def jax_dx(g):
        v, r, _ = jax_ba.assemble_blocks_sorted(g, jbp)
        p2 = js.plan2
        xj = jax_sc2.solve_refined2(p2, v[: p2.n], v[p2.n : p2.n + p2.n_off], -r[:-1])
        return jax_ba.scatter_dx(jbp, xj, jbp.bs)

    H, g, _ = assembly.assemble_dense(graph)
    gn = torch.linalg.norm(g)
    assert float(torch.linalg.norm(H @ dx + g) / gn) < 1e-5
    assert float(torch.linalg.norm(H @ (dx - t(np.array(jax_dx(jg))))) / gn) < 1e-5

    ref = NativeBlockSolver(ns.system, device="cpu")

    def converge(solver, gr):
        for _ in range(8):
            states, norm, _ = solver.gn_step(gr)
            if float(norm) < 1e-8:
                break
            gr = gr.replace_states(states)
        return float(assembly.graph_chi2(gr))

    chi_mp, chi_ref = converge(ns, graph), converge(ref, graph)
    assert abs(chi_mp - chi_ref) < 1e-6 * max(1.0, chi_ref)


def test_optimize_fused_matches_jax():
    """optimize_fused (eager on the CPU; a CUDA graph on the card) against
    JAX's _native_optimize_fused: 3 iterations, no early exit; states within
    1e-8, both chi2 within 1e-9 relative, and the same result as chaining
    gn_step by hand."""
    jsystem = jax_system(100, loop_prob=0.5)
    jg = jsystem.snapshot()
    js = JaxNative(jsystem, panel=4, engine="v2")
    js.symbolic()
    jst, jn, jc0, jc = _native_optimize_fused(jg, js.block_plan, js.plan2, 3, False, 2)
    ns = NativeBlockSolver(port_system(100, loop_prob=0.5), panel=4, engine="v2", device="cpu")
    graph = port_graph(jg)
    st, dn, c0, c = ns.optimize_fused(graph, n_iters=3)
    for a, b in ((c0, jc0), (c, jc)):
        assert abs(float(a) - float(b)) <= 1e-9 * float(b)
    assert abs(float(dn) - float(jn)) <= 1e-8 * (1.0 + float(jn))
    for k in jst:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=0, atol=1e-8)
    assert abs(float(c) - float(jax_graph_chi2(jg.replace_states(jst)))) <= 1e-9 * float(c)
    states = graph.states
    for _ in range(3):
        states, _, _ = ns.gn_step(graph.replace_states(states))
    for k in st:
        np.testing.assert_array_equal(st[k].numpy(), states[k].numpy())
    with pytest.raises(ValueError, match="engine='v2'"):
        NativeBlockSolver(ns.system, device="cpu").optimize_fused(graph)


@pytest.mark.parametrize("last", [None, (5, 77, 150)])
@pytest.mark.parametrize("seed", [0, 1])
def test_min_degree_cpp_matches_python_and_jax(seed, last):
    """The port's C++ min-degree (built from csrc/slampp_native.cpp) equals
    its Python version and the JAX package's native ordering, with and
    without constrained_last."""
    n = 200
    _, pairs = random_block_spd(n, 3, extra_pairs=150, seed=seed)
    adj = ordering.block_adjacency(n, pairs)
    order = ordering.min_degree_ordering(adj, last)
    np.testing.assert_array_equal(order, ordering.min_degree_ordering_py(adj, last))
    jadj = jax_ord.block_adjacency(n, pairs)
    np.testing.assert_array_equal(order, native_host.min_degree_order(jadj.indptr, jadj.indices,
                                                                      last))
    np.testing.assert_array_equal(order, jax_ord.min_degree_ordering(jadj, last))
    assert sorted(order) == list(range(n))
    if last:
        assert list(order[-len(last):]) == sorted(last)
    with pytest.raises(ValueError, match="constrained_last"):
        ordering.min_degree_ordering(adj, [n])
