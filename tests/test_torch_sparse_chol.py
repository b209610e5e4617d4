"""The native block-sparse engine of slampp_tpu_torch (v1) against the JAX
package: the unrolled small-block kernels (f64, 1e-12), the host orderings
and symbolic plans (equal), the level-by-level factorization and solves on
the JAX package's own plan (f64, 1e-10, factors compared as well as
solutions), and the native GN step (f64, 1e-8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly as jax_ba, native_host, ordering as jax_ord, sparse_chol as jax_sc, symbolic as jax_sym
from slampp_tpu.linear.native import NativeBlockSolver as JaxNative
from slampp_tpu.ops import small_blocks as jax_sb
from slampp_tpu_torch import interop
from slampp_tpu_torch.core import assembly, block_assembly, ordering, sparse_chol, symbolic
from slampp_tpu_torch.linear.native import NativeBlockSolver
from slampp_tpu_torch.ops import small_blocks

from _torch_jax_util import jax_system, port_graph, port_system

torch.set_num_threads(1)
t = torch.from_numpy


def _random_block_spd(n, bs, extra_pairs, seed):
    """Random SPD block matrix on a chain plus extra off-diagonal pairs
    (tests/test_sparse_chol.py)."""
    rng = np.random.default_rng(seed)
    pairs = {(i + 1, i) for i in range(n - 1)}
    for _ in range(extra_pairs):
        i, j = rng.integers(0, n, 2)
        if i != j:
            pairs.add((max(i, j), min(i, j)))
    pairs = sorted(pairs)
    N = n * bs
    A = np.zeros((N, N))
    for i, j in pairs:
        B = rng.normal(0, 1, (bs, bs))
        A[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = B
        A[j * bs : (j + 1) * bs, i * bs : (i + 1) * bs] = B.T
    A += np.eye(N) * (np.abs(A).sum(axis=1).max() + 1.0)
    return A, [(int(i), int(j)) for i, j in pairs]


def _pack(A, plan, bs):
    vals = np.zeros((plan.nnzb, bs, bs))
    for (i, j), s in plan.slot_of.items():
        vals[s] = A[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs]
    return vals


def _port_plan(jplan):
    return interop.cholesky_plan({k: getattr(jplan, k) for k in jplan.__dataclass_fields__})


def _spd_blocks(rng, B, bs):
    G = rng.normal(size=(B, bs, bs))
    return G @ np.swapaxes(G, 1, 2) + bs * np.eye(bs)


@pytest.mark.parametrize("bs", [3, 6, 12])
def test_small_blocks_match_jax(bs):
    """The unrolled and blocked kernels against the JAX package's, f64 1e-12
    (bs 12 takes the 8-column blocked paths)."""
    rng = np.random.default_rng(bs)
    A = _spd_blocks(rng, 7, bs)
    W = rng.normal(size=(7, 5, bs))
    b = rng.normal(size=(7, bs))
    L = small_blocks.cholesky_blocked(t(A))
    ours = [
        L,
        small_blocks.solve_triangular_right_transpose_blocked(t(W), L),
        small_blocks.solve_lower_blocked(L, t(b)),
        small_blocks.solve_lower_transpose_blocked(L, t(b)),
    ]
    unblocked = bs <= 8  # the fully unrolled forms serve the blocks of the pose graphs
    if unblocked:
        ours += [small_blocks.cholesky_small(t(A)), small_blocks.inverse_spd_small(t(A))]

    @jax.jit
    def theirs(A, W, b):
        Lj = jax_sb.cholesky_blocked(A)
        out = [Lj, jax_sb.solve_triangular_right_transpose_blocked(W, Lj),
               jax_sb.solve_lower_blocked(Lj, b), jax_sb.solve_lower_transpose_blocked(Lj, b)]
        if unblocked:
            out += [jax_sb.cholesky_small(A), jax_sb.inverse_spd_small(A)]
        return out

    pairs = zip(ours, theirs(jnp.asarray(A), jnp.asarray(W), jnp.asarray(b)))
    for x, y in pairs:
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((L @ L.transpose(1, 2)).numpy(), A, rtol=1e-12, atol=1e-12)


def test_small_blocks_clamp_keeps_factor_finite():
    """Static pivoting: an indefinite block (where ``torch.linalg.cholesky``
    fails) factors to finite values with clamp 1e-8, equal to the JAX
    package's, in f64 (1e-12) and f32 (1e-6)."""
    rng = np.random.default_rng(3)
    A = _spd_blocks(rng, 4, 3)
    A[1] = np.diag([1.0, -2.0, 3.0])
    A[2, 2, 2] = -1e-3
    assert not bool(torch.linalg.cholesky_ex(t(A)).info.eq(0).all())
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-6)):
        L = small_blocks.cholesky_blocked(t(A.astype(dtype)), clamp=1e-8)
        Lj = jax_sb.cholesky_blocked(jnp.asarray(A.astype(dtype)), clamp=1e-8)
        assert bool(torch.isfinite(L).all())
        np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_symbolic_plan_matches_jax(seed):
    """The level schedule, fill and padded index arrays equal the JAX
    package's for the same pairs."""
    _, pairs = _random_block_spd(60, 3, extra_pairs=40, seed=seed)
    p, jp = symbolic.symbolic_cholesky(60, pairs), jax_sym.symbolic_cholesky(60, pairs)
    for f in jp.__dataclass_fields__:
        a, b = getattr(p, f), getattr(jp, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    dp = sparse_chol.device_plan(p, "cpu")
    assert dp.n_levels == jp.n_levels and dp.upd_dst.dtype == torch.int64
    pat, parent, level = symbolic.analyze(60, pairs)
    jpat, jparent, jlevel = jax_sym.analyze(60, pairs)
    assert pat == jpat
    np.testing.assert_array_equal(parent, jparent)
    np.testing.assert_array_equal(level, jlevel)


def test_orderings_match_jax_python_branch(monkeypatch):
    """With the JAX package's C++ ordering switched off (in this test only),
    its pure-Python min-degree, nested dissection and RCM equal the port's,
    constrained_last included."""
    monkeypatch.setattr(native_host, "min_degree_order", lambda *a, **k: None)
    n = 120
    _, pairs = _random_block_spd(n, 3, extra_pairs=60, seed=4)
    adj, jadj = ordering.block_adjacency(n, pairs), jax_ord.block_adjacency(n, pairs)
    assert (adj != jadj).nnz == 0
    last = [5, 77]
    cases = [
        (ordering.min_degree_ordering(adj), jax_ord.min_degree_ordering(jadj)),
        (ordering.min_degree_ordering(adj, last), jax_ord.min_degree_ordering(jadj, last)),
        (ordering.nested_dissection_ordering(adj, leaf_size=16, constrained_last=last),
         jax_ord.nested_dissection_ordering(jadj, leaf_size=16, constrained_last=last)),
        (ordering.rcm_ordering(adj), jax_ord.rcm_ordering(jadj)),
    ]
    for a, b in cases:
        np.testing.assert_array_equal(a, b)
    order = cases[1][0]
    assert list(order[-2:]) == last and sorted(order) == list(range(n))
    np.testing.assert_array_equal(ordering.inverse_ordering(order)[order], np.arange(n))


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_factor_solve_on_jax_plan_matches_jax(bs, seed):
    """factorize / solve / solve_refined on the JAX package's own plan
    (through interop): the factor and both solutions equal JAX's to 1e-10
    (f64), and L L^T = A (tests/test_sparse_chol.py:46-67)."""
    n = 30
    A, pairs = _random_block_spd(n, bs, extra_pairs=25, seed=seed)
    jplan = jax_sym.symbolic_cholesky(n, pairs)
    jdp = jax_sc.device_plan(jplan)
    dp = sparse_chol.device_plan(_port_plan(jplan), "cpu")
    vals = _pack(A, jplan, bs)
    b = np.random.default_rng(seed + 100).normal(0, 1, (n, bs))

    Lj = np.asarray(jax.jit(jax_sc.factorize)(jdp, jnp.asarray(vals)))
    L = sparse_chol.factorize(dp, t(vals))
    np.testing.assert_allclose(L.numpy(), Lj, rtol=0, atol=1e-10)
    Lfull = np.zeros_like(A)
    for (i, j), s in jplan.slot_of.items():
        Lfull[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = L[s].numpy()
    np.testing.assert_allclose(Lfull @ Lfull.T, A, atol=1e-8)

    x = sparse_chol.solve(dp, L, t(b)).numpy()
    xj = jax.jit(jax_sc.solve)(jdp, jnp.asarray(Lj), jnp.asarray(b))
    np.testing.assert_allclose(x, np.asarray(xj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.reshape(-1), np.linalg.solve(A, b.reshape(-1)), atol=1e-8)

    xr = sparse_chol.solve_refined(dp, t(vals), t(b), refine_iters=2).numpy()
    xrj = np.asarray(jax.jit(jax_sc.solve_refined)(jdp, jnp.asarray(vals), jnp.asarray(b)))
    np.testing.assert_allclose(xr, xrj, rtol=0, atol=1e-10)
    y = sparse_chol.spmv_symmetric(dp, t(vals), t(b)).numpy()
    np.testing.assert_allclose(y.reshape(-1), A @ b.reshape(-1), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("mixed", [False, True])
def test_native_gn_step_matches_jax(mixed):
    """NativeBlockSolver.gn_step (v1) against the JAX package's on the same
    graph.  Exact f64: states and |dx| within 1e-8 (the port's Python
    min-degree and JAX's C++ ordering may differ, so results are compared,
    not plans).  Mixed (f32 factor, f64 refinement): the refined dx leaves
    the near-null gauge direction inexact in both packages (a few 1e-3
    apart), so it is held to the residual bound of
    tests/test_torch_partitioned.py, ||H dx + g|| / ||g|| < 1e-5, and to
    JAX's dx through H: ||H (dx - dx_jax)|| / ||g|| < 1e-5."""
    jsystem = jax_system(120, loop_prob=0.5)
    jg = jsystem.snapshot()
    jsolver = JaxNative(jsystem, mixed_precision=mixed)
    js, jn, jc = jsolver.gn_step(jg)
    ns = NativeBlockSolver(port_system(120, loop_prob=0.5), mixed_precision=mixed, device="cpu")
    graph = port_graph(jg)
    s, dn, c = ns.gn_step(graph)
    assert abs(float(c) - float(jc)) <= 1e-10 * float(jc)
    assert float(assembly.graph_chi2(graph.replace_states(s))) < 0.1 * float(c)
    assert ns.dplan.n_levels > 1 and ns.block_plan.nnzb == ns.dplan.nnzb
    if not mixed:
        assert abs(float(dn) - float(jn)) <= 1e-8 * (1.0 + float(jn))
        for k in js:
            np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), rtol=0, atol=1e-8)
        return
    H, g, _ = assembly.assemble_dense(graph)
    vals, rhs, _ = block_assembly.assemble_blocks_sorted(graph, ns.block_plan)
    dx = block_assembly.scatter_dx(
        ns.block_plan, sparse_chol.solve_refined(ns.dplan, vals[:-1], -rhs[:-1]))

    @jax.jit
    def jax_dx(jg):
        bp = jsolver.block_plan
        jvals, jrhs, _ = jax_ba.assemble_blocks_sorted(jg, bp)
        return jax_ba.scatter_dx(bp, jax_sc.solve_refined(jsolver.dplan, jvals[:-1], -jrhs[:-1]),
                                 bp.bs)

    dx_j = t(np.array(jax_dx(jg)))
    gn = torch.linalg.norm(g)
    assert float(torch.linalg.norm(H @ dx + g) / gn) < 1e-5
    assert float(torch.linalg.norm(H @ (dx - dx_j)) / gn) < 1e-5
    assert abs(float(dn) - float(torch.linalg.norm(dx))) <= 1e-12 * float(dn)


@pytest.mark.parametrize("kw", [{"engine": "v2"}, {"panel": 2}, {"fused": True}])
def test_native_not_ported_raises(kw):
    """engine='v2', panel > 1 and optimize_fused name their ROADMAP item
    instead of running another engine."""
    system = port_system(20)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 4"):
        if kw.pop("fused", False):
            NativeBlockSolver(system, device="cpu").optimize_fused(system.snapshot("cpu"))
        else:
            NativeBlockSolver(system, device="cpu", **kw)
