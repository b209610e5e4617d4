"""Marginal covariances and eigenvalue analysis of slampp_tpu_torch against
the JAX package and dense NumPy oracles: dense marginals and selected
columns (f64, 1e-10), the MarginalCovariance cache with its batch,
incremental (Woodbury) and failure-recompute paths (1e-8, as
tests/test_marginals.py:44), block Takahashi on the v2 factor (1e-8 against
the dense inverse, 1e-10 against JAX), the recursive sparse batch against
the dense one (1e-7), and Lanczos eigenvalues, dense and on the sparse
operator, at the JAX tests' tolerances (tests/test_aux.py:68-70, :152-160):
the start vectors differ (jax.random against a torch.Generator), so
converged eigenvalues are compared, not Ritz sequences."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jax_asm, sparse_chol2 as jax_sc2
from slampp_tpu.eval import eigenvalues as jax_eig
from slampp_tpu.marginals import marginals as jax_marg, sparse_marginals as jax_sm
from slampp_tpu_torch.core import assembly, sparse_chol2
from slampp_tpu_torch.eval import eigenvalues as eig
from slampp_tpu_torch.geometry import se2
from slampp_tpu_torch.marginals import marginals as marg
from slampp_tpu_torch.marginals import sparse_marginals as sm
from slampp_tpu_torch.models import se2 as m_se2
from slampp_tpu_torch.solvers import GaussNewtonSolver

from _torch_jax_util import jax_system, pack_v2, permute_blocks, port_system, random_block_spd

torch.set_num_threads(1)
t = torch.from_numpy


def _optimized_pair(n, seed, loop_prob=0.5):
    """The same graph in both packages at the same linearization point: the
    port's GN optimum, copied into the JAX system."""
    js, ps = jax_system(n, seed=seed, loop_prob=loop_prob), port_system(n, seed=seed,
                                                                         loop_prob=loop_prob)
    GaussNewtonSolver(ps, device="cpu").optimize(10, 1e-8)
    for vid in js.vertex_index:
        js.set_vertex_state(vid, ps.vertex_state(vid))
    return js, ps


def _dense_H(jsystem):
    return np.array(jax.jit(jax_asm.assemble_dense)(jsystem.snapshot())[0])


def test_dense_marginals_and_columns_match_jax():
    """dense_marginals and marginals_columns against JAX's (1e-10 relative)
    and Sigma H = I; a matrix that is not positive definite gives NaN, as
    lax.linalg.cholesky does, instead of raising."""
    H = _dense_H(jax_system(60, seed=4, loop_prob=0.5))
    S = marg.dense_marginals(t(H)).numpy()
    Sj = np.asarray(jax_marg.dense_marginals(jnp.asarray(H)))
    scale = np.abs(Sj).max()
    np.testing.assert_allclose(S, Sj, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(S @ H, np.eye(H.shape[0]), atol=1e-6)
    cols = np.array([0, 5, 17, 100])
    C = marg.marginals_columns(t(H), t(cols)).numpy()
    np.testing.assert_allclose(
        C, np.asarray(jax_marg.marginals_columns(jnp.asarray(H), jnp.asarray(cols))),
        rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(C, S[:, cols], rtol=0, atol=1e-10 * scale)
    bad = H.copy()
    bad[7, 7] = -1.0
    assert np.isnan(marg.dense_marginals(t(bad)).numpy()).all()
    assert np.isnan(np.asarray(jax_marg.dense_marginals(jnp.asarray(bad)))).all()
    U, Sm = marg.woodbury_blockdiag_downdate(t(H), t(C), t(np.eye(4, H.shape[0])), t(2 * np.eye(4)))
    np.testing.assert_allclose(Sm.numpy(), 0.5 * np.eye(4) + C[:4], rtol=1e-14)


def test_marginal_cache_and_incremental_update_match_jax():
    """update_batch on the optimized graph, then a strong loop edge (10, 50)
    through update_incremental (host Woodbury) at the same linearization
    point: both equal JAX's block_diag (rtol 1e-9, atol 1e-8; the blocks reach
    about 200), and the incremental blocks equal a batch recompute with the
    edge added at the JAX test's tolerance (tests/test_marginals.py:44)."""
    js, ps = _optimized_pair(60, seed=4)
    m, mj = marg.MarginalCovariance(ps, device="cpu"), jax_marg.MarginalCovariance(js)
    m.update_batch()
    mj.update_batch()
    assert set(m.block_diag) == set(mj.block_diag)
    for vid in mj.block_diag:
        np.testing.assert_allclose(m.block_diag[vid], mj.block_diag[vid], rtol=1e-9, atol=1e-8)
    assert np.all(np.linalg.eigvalsh(m.block_diag[0]) > 0)

    vids = (10, 50)
    x0, x1 = (t(ps.vertex_state(v)) for v in vids)
    meas, j0, j1 = (a.numpy() for a in se2.absolute_to_relative_jacobians(x0, x1))
    info = np.eye(3) * 100.0
    offsets, total = ps._layout()
    J = np.zeros((3, total))
    J[:, offsets[vids[0]] : offsets[vids[0]] + 3] = -j0  # r = z - h: J_err = -J_h
    J[:, offsets[vids[1]] : offsets[vids[1]] + 3] = -j1
    assert m.prefer_incremental(3) and mj.prefer_incremental(3)
    m.update_incremental(J, info)
    mj.update_incremental(J, info)
    for vid in mj.block_diag:
        np.testing.assert_allclose(m.block_diag[vid], mj.block_diag[vid], rtol=1e-9, atol=1e-8)
    ps.add_edge("edge_pose2d", vids, meas, info, m_se2.POSE_POSE_INITIALIZERS)
    m2 = marg.MarginalCovariance(ps, device="cpu")
    m2.update_batch()
    for vid in (0, 10, 30, 50):
        np.testing.assert_allclose(m.block_diag[vid], m2.block_diag[vid], atol=1e-8)
    assert m.edge_watermark == mj.edge_watermark == ps.n_edges - 1  # before the add
    m.disable_update()
    assert not m.prefer_incremental(3)


def test_incremental_failure_recomputes_in_batch(capsys):
    """A cache that is not positive definite makes update_incremental print
    JAX's warning and recompute in batch (NonlinearSolver_Lambda.h:731-741)."""
    ps = port_system(40, seed=2, loop_prob=0.5)
    m = marg.MarginalCovariance(ps, device="cpu")
    with pytest.raises(RuntimeError, match="update_batch must run"):
        m.update_incremental(np.zeros((3, ps.state_dim)), np.eye(3))
    m.update_batch()
    want = {k: v.copy() for k, v in m.block_diag.items()}
    m._H = -np.eye(ps.state_dim)
    m.update_incremental(np.zeros((3, ps.state_dim)), np.eye(3))
    assert "restarting with the batch recompute" in capsys.readouterr().err
    for vid, blk in want.items():
        np.testing.assert_array_equal(m.block_diag[vid], blk)


@pytest.mark.parametrize("bs", [3, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_takahashi_matches_dense_inverse_and_jax(bs, seed):
    """The Takahashi plan equals JAX's; every Sigma block on the factor
    pattern equals the dense inverse (1e-8) and JAX's (1e-10)
    (tests/test_sparse_marginals.py)."""
    n = 25
    A, pairs = random_block_spd(n, bs, extra_pairs=20, seed=seed)
    plan, jplan = sparse_chol2.plan_v2(n, pairs, "cpu"), jax_sc2.plan_v2(n, pairs)
    Ap = permute_blocks(A, plan.col_order, bs)
    D, O = pack_v2(Ap, plan, bs)
    Ld, Lo = sparse_chol2.factorize2(plan, t(D), t(O))
    tk, jtk = sm.takahashi_plan(plan), jax_sm.takahashi_plan(jplan)
    for f in jtk._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tk, f)), np.asarray(getattr(jtk, f)),
                                      err_msg=f)
    Sd, So = sm.sparse_marginals(plan, tk, Ld, Lo)
    Ldj, Loj = jax_sc2.factorize2(jplan, jnp.asarray(D), jnp.asarray(O))
    Sdj, Soj = jax.jit(lambda a, b: jax_sm.sparse_marginals(jplan, jtk, a, b))(Ldj, Loj)
    np.testing.assert_allclose(Sd.numpy(), np.asarray(Sdj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(So.numpy(), np.asarray(Soj), rtol=0, atol=1e-10)
    Sigma = np.linalg.inv(Ap)
    for (i, j), s in plan.slot_of.items():
        blk = Sd[s] if i == j else So[s - n]
        np.testing.assert_allclose(blk.numpy(), Sigma[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs],
                                   atol=1e-8, err_msg=f"({i}, {j})")


@pytest.mark.parametrize("panel", [1, 4])
def test_update_batch_sparse_matches_dense_and_jax(panel):
    """The recursive sparse block diagonal (v2 factor + Takahashi) against
    the port's dense update_batch (1e-7) and JAX's update_batch_sparse
    (rtol 1e-10, atol 1e-9; the blocks reach about 70), at panel 1 and at panel 4 with a partial last panel."""
    js, ps = _optimized_pair(82, seed=11)
    m = marg.MarginalCovariance(ps, device="cpu")
    m.update_batch_sparse(panel=panel)
    assert not m.can_update and m.edge_watermark == ps.n_edges
    dense = marg.MarginalCovariance(ps, device="cpu")
    dense.update_batch()
    mj = jax_marg.MarginalCovariance(js)
    mj.update_batch_sparse(panel=panel)
    assert set(m.block_diag) == set(dense.block_diag) == set(mj.block_diag)
    for vid, blk in m.block_diag.items():
        np.testing.assert_allclose(blk, dense.block_diag[vid], rtol=0, atol=1e-7)
        np.testing.assert_allclose(blk, mj.block_diag[vid], rtol=1e-10, atol=1e-9)


def test_eigenvalues_match_jax_and_numpy():
    """Dense Lanczos: the largest and the shift-invert smallest eigenvalue
    (k=1, 80 iterations) and the condition number against numpy.eigvalsh
    and the JAX package's, rtol 1e-6 (tests/test_aux.py:68-70)."""
    H = _dense_H(jax_system(40, seed=3, loop_prob=0.5))
    w = np.linalg.eigvalsh(H)
    lmax, vmax = eig.largest_eigenvalues(t(H), k=1, iters=80)
    lmin, _ = eig.smallest_eigenvalues_shift_invert(t(H), k=1, iters=80)
    jmax, _ = jax_eig.largest_eigenvalues(jnp.asarray(H), k=1, iters=80)
    jmin, _ = jax_eig.smallest_eigenvalues_shift_invert(jnp.asarray(H), k=1, iters=80)
    for ours, theirs, true in ((lmax, jmax, w[-1]), (lmin, jmin, w[0])):
        np.testing.assert_allclose(float(ours[0]), true, rtol=1e-6)
        np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=1e-6)
    v = vmax[:, 0].numpy()
    assert np.linalg.norm(H @ v - w[-1] * v) < 1e-4 * w[-1]
    np.testing.assert_allclose(eig.condition_number(t(H), 80),
                               jax_eig.condition_number(jnp.asarray(H), 80), rtol=1e-5)


def test_sparse_operator_eigenvalues_match_jax_and_numpy():
    """The sparse operator (tests/test_aux.py:120-160): matvec equals the
    dense H to 1e-9; the 3 largest (120 iterations) within 5e-4 and the 2
    smallest by shift-invert through the f64 v3 factorization (80
    iterations) within 1e-4 of numpy and of JAX's."""
    jsystem = jax_system(120, seed=4)
    H = _dense_H(jsystem)
    w = np.linalg.eigvalsh(H)
    ps = port_system(120, seed=4)
    op = eig.SparseSystemOperator(ps, device="cpu")
    x = np.random.default_rng(0).normal(size=op.n)
    np.testing.assert_allclose(op.matvec(t(x)).numpy(), H @ x, rtol=1e-9, atol=1e-9)
    y = op.solve_shifted(t(x), 0.0).numpy()
    np.testing.assert_allclose(H @ y, x, rtol=0, atol=1e-8 * np.abs(x).max())

    lmax, _ = eig.sparse_largest_eigenvalues(ps, k=3, iters=120, device="cpu")
    jmax, _ = jax_eig.sparse_largest_eigenvalues(jsystem, k=3, iters=120)
    top = np.sort(np.abs(w))[::-1][:3]
    ours = np.sort(np.abs(lmax.numpy()))[::-1]
    np.testing.assert_allclose(ours, top, rtol=5e-4)
    np.testing.assert_allclose(ours, np.sort(np.abs(np.asarray(jmax)))[::-1], rtol=5e-4)
    lmin, _ = eig.sparse_smallest_eigenvalues_shift_invert(ps, k=2, iters=80, device="cpu")
    jmin, _ = jax_eig.sparse_smallest_eigenvalues_shift_invert(jsystem, k=2, iters=80)
    np.testing.assert_allclose(np.sort(lmin.numpy()), np.sort(w)[:2], rtol=1e-4)
    np.testing.assert_allclose(np.sort(lmin.numpy()), np.sort(np.asarray(jmin)), rtol=1e-4)
