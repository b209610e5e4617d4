"""Random block-matrix property tests on the port, the `-rmut` analog
(counterpart of tests/test_block_unit.py; reference
src/slam_app/BlockUnit.cpp: randomized block matrix decomposition,
multiplication and addition unit tests, including expected-failure cases
for dimension and layout mismatches).

The random structures exercise the port's BlockSparseMatrix (host
container and its device products), the batched dense kernels
(ops/dense_kernels), the small-block kernels (ops/small_blocks), the
grouped segment sums (ops/segments) and the sparse block Cholesky
(core/sparse_chol2) against dense NumPy oracles, with the JAX package's
tolerances.  The file imports no JAX, so that
``python -m slampp_tpu_torch.apps.main -rmut`` runs it where JAX is not
installed (with ``--noconftest``).  The device work runs on the card when
there is one, else on the CPU, where each kernel wrapper takes its plain
version.
"""

import numpy as np
import pytest
import torch

from slampp_tpu_torch.core.bsm import BlockSparseMatrix
from slampp_tpu_torch.ops.dense_kernels import (
    chol_batched,
    trsm_lower_batched,
    trsm_lower_t_batched,
)
from slampp_tpu_torch.ops.segments import grouped_segsum_last, plan_grouped_segments
from slampp_tpu_torch.ops.small_blocks import (
    cholesky_small,
    inverse_spd_small,
    solve_lower_small,
)

DEV = torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64), device=DEV)


def _np(x):
    return x.cpu().numpy()


N_TRIALS = 12


def _random_bsm(rng, nbr, nbc, br, bc, density=0.3):
    A = BlockSparseMatrix(nbr, nbc, br, bc)
    n = max(1, int(density * nbr * nbc))
    for _ in range(n):
        i = int(rng.integers(0, nbr))
        j = int(rng.integers(0, nbc))
        A.append_block(i, j, rng.normal(size=(br, bc)))
    return A


# --------------------------------------------------------------- container


def test_random_gemm_vs_dense():
    rng = np.random.default_rng(0)
    for t in range(N_TRIALS):
        nbr, nbk, nbc = rng.integers(1, 9, 3)
        br, bk, bc = rng.integers(1, 6, 3)
        A = _random_bsm(rng, nbr, nbk, br, bk)
        B = _random_bsm(rng, nbk, nbc, bk, bc)
        C = A.multiply(B)
        np.testing.assert_allclose(
            C.to_dense(), A.to_dense() @ B.to_dense(), atol=1e-12,
            err_msg=f"trial {t}")


def test_random_add_scale_vs_dense():
    rng = np.random.default_rng(1)
    for t in range(N_TRIALS):
        nbr, nbc = rng.integers(1, 9, 2)
        br, bc = rng.integers(1, 6, 2)
        A = _random_bsm(rng, nbr, nbc, br, bc)
        B = _random_bsm(rng, nbr, nbc, br, bc)
        f = float(rng.normal())
        C = A.add(B, factor=f)
        np.testing.assert_allclose(
            C.to_dense(), A.to_dense() + f * B.to_dense(), atol=1e-12)
        C.scale(2.5)
        np.testing.assert_allclose(
            C.to_dense(), 2.5 * (A.to_dense() + f * B.to_dense()), atol=1e-12)


def test_random_ata_matvec_permute_vs_dense():
    rng = np.random.default_rng(2)
    for t in range(N_TRIALS):
        nbr, nbc = rng.integers(1, 9, 2)
        br, bc = rng.integers(1, 6, 2)
        A = _random_bsm(rng, nbr, nbc, br, bc)
        Ad = A.to_dense()
        np.testing.assert_allclose(A.ata().to_dense(), Ad.T @ Ad, atol=1e-12)
        x = rng.normal(size=Ad.shape[1])
        np.testing.assert_allclose(A.matvec(x), Ad @ x, atol=1e-12)
        rp = rng.permutation(nbr)
        cp = rng.permutation(nbc)
        P = A.permute(rp, cp).to_dense()
        # permute maps original block i to position inv[i]
        for i in range(nbr):
            for j in range(nbc):
                blk = A.find_block(int(rp[i]), int(cp[j]))
                got = P[i * br:(i + 1) * br, j * bc:(j + 1) * bc]
                want = blk if blk is not None else np.zeros((br, bc))
                np.testing.assert_allclose(got, want, atol=1e-12)


def test_random_bsr_roundtrip():
    scipy_sparse = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(3)
    for t in range(N_TRIALS):
        nbr, nbc = rng.integers(1, 9, 2)
        br = bc = int(rng.integers(1, 6))
        A = _random_bsm(rng, nbr, nbc, br, bc)
        bsr = A.to_bsr()
        np.testing.assert_allclose(bsr.toarray(), A.to_dense(), atol=1e-12)
        back = BlockSparseMatrix.from_sparse(bsr.tocsr(), br, bc)
        np.testing.assert_allclose(back.to_dense(), A.to_dense(), atol=1e-12)


# --------------------------------------------- expected-failure (layout) cases


def test_gemm_dim_mismatch_raises():
    A = BlockSparseMatrix(2, 3, 3, 2)
    A.append_block(0, 0, np.eye(3, 2))
    B = BlockSparseMatrix(3, 2, 3, 2)  # inner block dim 3 != 2
    B.append_block(0, 0, np.eye(3, 2))
    with pytest.raises(AssertionError):
        A.multiply(B)


def test_append_block_shape_mismatch_raises():
    A = BlockSparseMatrix(2, 2, 3, 3)
    with pytest.raises(ValueError):
        A.append_block(0, 0, np.eye(4))


# ------------------------------------------------------------ device kernels


def test_batched_cholesky_trsm_random():
    rng = np.random.default_rng(4)
    for M in (8, 16, 24):  # chol_batched contract: M multiple of PB=8
        K = int(rng.integers(2, 9))
        G = rng.normal(size=(K, M, M))
        A = G @ np.swapaxes(G, 1, 2) + M * np.eye(M)
        L = _np(chol_batched(_t(A), clamp=0.0))
        np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-8)
        B = rng.normal(size=(K, M, max(1, M - 1)))
        Y = _np(trsm_lower_batched(_t(L), _t(B)))
        for k in range(K):
            np.testing.assert_allclose(L[k] @ Y[k], B[k], atol=1e-8)
        X = _np(trsm_lower_t_batched(_t(L), _t(Y)))
        for k in range(K):
            np.testing.assert_allclose(L[k].T @ X[k], Y[k], atol=1e-8)


def test_batched_cholesky_identity_pad():
    """Odd sizes go through identity padding to the PB grid — the caller
    contract the solvers rely on (partitioned.py pads separator panels)."""
    rng = np.random.default_rng(14)
    M, Mp, K = 5, 8, 4
    G = rng.normal(size=(K, M, M))
    A = G @ np.swapaxes(G, 1, 2) + M * np.eye(M)
    Ap = np.tile(np.eye(Mp), (K, 1, 1))
    Ap[:, :M, :M] = A
    L = _np(chol_batched(_t(Ap), clamp=0.0))[:, :M, :M]
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-8)


def test_small_block_kernels_random():
    rng = np.random.default_rng(5)
    for d in (2, 3, 6):
        K = 7
        G = rng.normal(size=(K, d, d))
        A = G @ np.swapaxes(G, 1, 2) + d * np.eye(d)
        L = _np(cholesky_small(_t(A)))
        np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-9)
        np.testing.assert_allclose(
            _np(inverse_spd_small(_t(A))), np.linalg.inv(A),
            atol=1e-8)
        b = rng.normal(size=(K, d))
        y = _np(solve_lower_small(_t(L), _t(b)))
        for k in range(K):
            np.testing.assert_allclose(L[k] @ y[k], b[k], atol=1e-9)


def test_grouped_segments_random():
    rng = np.random.default_rng(6)
    for t in range(N_TRIALS):
        n_seg = int(rng.integers(1, 40))
        sizes = rng.integers(0, 30, n_seg)
        m = int(sizes.sum())
        ends = np.cumsum(sizes)
        starts = ends - sizes
        plan = plan_grouped_segments(starts, ends, m).to(DEV)
        data = rng.normal(size=(3, m))
        out = _np(grouped_segsum_last(_t(data), plan))
        want = np.zeros((3, n_seg))
        for g in range(n_seg):
            want[:, g] = data[:, starts[g]:ends[g]].sum(1)
        np.testing.assert_allclose(out, want, atol=1e-10, err_msg=f"trial {t}")


# ------------------------------------------------- sparse block factorization


def test_random_block_cholesky_vs_dense():
    """Random SPD block structures through the v2 scatter-free factorization
    vs a dense solve — the decomposition leg of the reference's random-matrix
    unit tests, at randomized structure/size (not the fixed fixtures of
    test_sparse_chol2)."""
    from slampp_tpu_torch.core import sparse_chol2

    rng = np.random.default_rng(7)
    for t in range(6):
        nb = int(rng.integers(6, 28))
        bs = int(rng.integers(2, 5))
        pairs = {(i + 1, i) for i in range(nb - 1)}
        for _ in range(2 * nb):
            i = int(rng.integers(0, nb))
            j = int(rng.integers(0, nb))
            if i > j:
                pairs.add((i, j))
        N = nb * bs
        Ad = np.zeros((N, N))
        for (i, j) in pairs:
            Ad[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.normal(
                size=(bs, bs))
        Ad = Ad + Ad.T + 4.0 * nb * np.eye(N)
        b = rng.normal(size=(nb, bs))

        plan = sparse_chol2.plan_v2(nb, sorted(pairs), device=DEV)
        order = plan.col_order  # new -> old
        P = np.zeros((N, N))
        for newb in range(nb):
            oldb = order[newb]
            P[newb * bs:(newb + 1) * bs, oldb * bs:(oldb + 1) * bs] = np.eye(bs)
        Ap = P @ Ad @ P.T
        D = np.zeros((plan.n, bs, bs))
        O = np.zeros((plan.n_off, bs, bs))
        for (i, j), s in plan.slot_of.items():
            blk = Ap[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
            if i == j:
                D[s] = blk
            else:
                O[s - plan.n] = blk
        Ld, Lo = sparse_chol2.factorize2(plan, _t(D), _t(O))
        bp = (P @ b.reshape(-1)).reshape(nb, bs)
        x = _np(sparse_chol2.solve2(plan, Ld, Lo, _t(bp)))
        x_ref = np.linalg.solve(Ap, bp.reshape(-1)).reshape(nb, bs)
        np.testing.assert_allclose(x, x_ref, atol=1e-7,
                                   err_msg=f"trial {t} nb={nb} bs={bs}")


def test_slice_to_matches_dense():
    rng = np.random.default_rng(8)
    for t in range(N_TRIALS):
        nbr, nbc = rng.integers(3, 9, 2)
        br, bc = rng.integers(1, 5, 2)
        A = _random_bsm(rng, nbr, nbc, br, bc, density=0.5)
        r0 = int(rng.integers(0, nbr))
        r1 = int(rng.integers(r0 + 1, nbr + 1))
        c0 = int(rng.integers(0, nbc))
        c1 = int(rng.integers(c0 + 1, nbc + 1))
        S = A.slice_to(r0, r1, c0, c1)
        np.testing.assert_allclose(
            S.to_dense(),
            A.to_dense()[r0 * br:r1 * br, c0 * bc:c1 * bc], atol=1e-12)


def test_device_ata_matches_host_oracle_10k():
    """ata_device == host ata == dense oracle at 10k-block scale
    (VERDICT r4 #6: the general device block-sparse AtA)."""
    rng = np.random.default_rng(11)
    nbr, nbc, bs = 900, 700, 3
    A = BlockSparseMatrix(nbr, nbc, bs, bs)
    for _ in range(10_000):
        i = int(rng.integers(nbr))
        j = int(rng.integers(nbc))
        A.append_block(i, j, rng.normal(size=(bs, bs)))
    C = A.ata_device(DEV)
    Ad = A.to_dense()
    ref = Ad.T @ Ad
    np.testing.assert_allclose(C.to_dense(), ref, rtol=1e-9, atol=1e-8)


def test_device_gemm_matches_host_oracle():
    """multiply_device == multiply == dense (ProductOf, BlockMatrix.h:2662)."""
    rng = np.random.default_rng(12)
    A = BlockSparseMatrix(40, 60, 3, 2)
    B = BlockSparseMatrix(60, 50, 2, 4)
    for _ in range(500):
        A.append_block(int(rng.integers(40)), int(rng.integers(60)),
                       rng.normal(size=(3, 2)))
    for _ in range(500):
        B.append_block(int(rng.integers(60)), int(rng.integers(50)),
                       rng.normal(size=(2, 4)))
    C = A.multiply_device(B, DEV)
    ref = A.to_dense() @ B.to_dense()
    np.testing.assert_allclose(C.to_dense(), ref, rtol=1e-9, atol=1e-9)
    Ch = A.multiply(B)
    np.testing.assert_allclose(C.to_dense(), Ch.to_dense(), atol=1e-9)


def test_device_gemm_empty_and_rect():

    A = BlockSparseMatrix(4, 5, 2, 3)
    B = BlockSparseMatrix(5, 3, 3, 2)
    assert A.multiply_device(B, DEV).nnz_blocks == 0
    assert A.ata_device(DEV).nnz_blocks == 0
    A.append_block(1, 2, np.ones((2, 3)))
    B.append_block(2, 1, np.ones((3, 2)))
    C = A.multiply_device(B, DEV)
    np.testing.assert_allclose(C.find_block(1, 1), 3 * np.ones((2, 2)))
