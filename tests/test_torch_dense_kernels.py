"""slampp_tpu_torch/ops/dense_kernels.py against numpy, against the JAX
package's chol_batched, and (marked ``gpu``) the CUDA kernels against their
plain PyTorch versions.

The ``gpu`` cases need no JAX, so they also run where JAX is not installed:
``python -m pytest tests/test_torch_dense_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from slampp_tpu_torch.ops import dense_kernels as dk

torch.set_num_threads(1)

def _spd(rng, K, M, shift=None):
    G = rng.normal(size=(K, M, M))
    return G @ np.swapaxes(G, 1, 2) + (M if shift is None else shift) * np.eye(M)


def _frozen_case(rng, M=24, zero_rows=(3, 11)):
    """PSD matrix of rank M - len(zero_rows): whole rows/columns of A are
    exactly zero, so those pivots are exactly 0 in any precision."""
    G = rng.normal(size=(1, M, M))
    G[:, list(zero_rows), :] = 0.0
    A = G @ np.swapaxes(G, 1, 2)
    keep = np.setdiff1d(np.arange(M), zero_rows)
    A[:, keep, keep] += M
    return A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ----------------------------------------------------------------- plain / CPU


@pytest.mark.parametrize("M", [8, 16, 24])
def test_plain_cholesky_trsm_random(M):
    """tests/test_block_unit.py:132 on the port: clamp=0, numpy oracle."""
    rng = np.random.default_rng(4 + M)
    K = int(rng.integers(2, 9))
    A = _spd(rng, K, M)
    L = dk.chol_batched(torch.from_numpy(A), clamp=0.0).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-8)
    B = rng.normal(size=(K, M, max(1, M - 1)))
    Y = dk.trsm_lower_batched(torch.from_numpy(L), torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(L @ Y, B, atol=1e-8)
    X = dk.trsm_lower_t_batched(torch.from_numpy(L), torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(np.swapaxes(L, 1, 2) @ X, Y, atol=1e-8)


def test_plain_cholesky_identity_pad():
    rng = np.random.default_rng(14)
    M, Mp, K = 5, 8, 4
    A = _spd(rng, K, M)
    Ap = np.tile(np.eye(Mp), (K, 1, 1))
    Ap[:, :M, :M] = A
    L = dk.chol_batched(torch.from_numpy(Ap), clamp=0.0).numpy()[:, :M, :M]
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-8)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_frozen_pivot_matches_jax(dtype, atol):
    """Rank-deficient PSD input, clamp=1e-8: the port's plain chol equals the
    JAX package's chol_batched (its lax reference path on the CPU), and the
    frozen columns come out ~0 with no inf/NaN."""
    jnp = pytest.importorskip("jax.numpy")
    from slampp_tpu.ops import dense_kernels as jdk

    A = _frozen_case(np.random.default_rng(7)).astype(dtype)
    L_jax = np.asarray(jdk.chol_batched(jnp.asarray(A), clamp=1e-8))
    L = dk.chol_batched(torch.from_numpy(A), clamp=1e-8).numpy()
    assert np.isfinite(L).all()
    np.testing.assert_allclose(L, L_jax, rtol=atol, atol=atol)
    for z in (3, 11):
        assert abs(L[0, z, z] - 1e10) < 1e4  # sqrt of the 1e20 freeze value
        assert np.abs(L[0, z + 1 :, z]).max() < 1e-6


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("case", ["sep_1x488x8", "3x40x13", "frozen", "1x1096x8"])
def test_wavefront_trsm_matches_jax(case, bwd):
    """The port's chol_batched and trsm_lower_batched / trsm_lower_t_batched
    (their plain path on a CPU tensor) against the JAX package's (its lax
    panel loop and triangular_solve on the CPU) on the same A and B: f64,
    1e-10 relative (the Cholesky against the scale of its unfrozen entries;
    a frozen pivot is 1e10 in both)."""
    jnp = pytest.importorskip("jax.numpy")
    from slampp_tpu.ops import dense_kernels as jdk

    rng = np.random.default_rng(21)
    if case == "frozen":
        A, S = _frozen_case(rng, M=72, zero_rows=(3, 40, 70)), 8
    else:
        K, M, S = {"sep_1x488x8": (1, 488, 8), "3x40x13": (3, 40, 13),
                   "1x1096x8": (1, 1096, 8)}[case]
        A = _spd(rng, K, M)
    L = dk.chol_batched(torch.from_numpy(A), clamp=1e-8)
    L_jax = np.asarray(jdk.chol_batched(jnp.asarray(A), clamp=1e-8))
    scale = np.abs(L_jax[np.abs(L_jax) < 1e9]).max()
    np.testing.assert_allclose(L.numpy(), L_jax, rtol=1e-10, atol=1e-10 * scale)
    B = torch.from_numpy(rng.normal(size=(A.shape[0], A.shape[1], S)))
    jfn = jdk.trsm_lower_t_batched if bwd else jdk.trsm_lower_batched
    ref = np.asarray(jfn(jnp.asarray(L.numpy()), jnp.asarray(B.numpy())))
    port = dk.trsm_lower_t_batched if bwd else dk.trsm_lower_batched
    X = port(L, B).numpy()
    assert np.isfinite(X).all()
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-10


# CPU rehearsals of the two newer TRSM forms' arithmetic (csrc/dense_kernels.cu),
# in the order the kernels sum, on 32-row blocks (NB)
NB = 32


def _blocks(M, bwd):
    """The row blocks (slices) in wavefront order: fwd ascending, bwd descending."""
    bl = [slice(s, min(s + NB, M)) for s in range(0, M, NB)]
    return bl[::-1] if bwd else bl


def _op_block(L, bi, bp, bwd):
    """Block (i, p) of the operator: L_ip (fwd) or L_pi^T (bwd)."""
    return L[bp, bi].T if bwd else L[bi, bp]


def _invert_diag(D, bwd):
    """invert_diag: column j of D^-1 by substitution on e_j, multiplying by
    the pivots' reciprocals; D^-T for bwd."""
    wp = D.shape[0]
    rcp = 1.0 / np.diag(D)
    V = np.eye(wp)
    for r in range(wp):
        x = V[r] * rcp[r]
        V[r + 1:] -= np.outer(D[r + 1:, r], x)
        V[r] = x
    return V.T if bwd else V


def _sep_model(L, B, bwd):
    """Separator form: per chain (matrix, 8-column group) and block i in
    wavefront order, r_i = B_i minus each published block's product (each
    entry summed over the tile's columns in order), then x_i = D_i^-1 r_i
    (D_i^-T) through the explicit inverse, summed from zero."""
    K, M, S = B.shape
    X = np.zeros_like(B)
    for k in range(K):
        for c0 in range(0, S, 8):
            cols = slice(c0, min(c0 + 8, S))
            done = []
            for bi in _blocks(M, bwd):
                r = B[k, bi, cols].copy()
                for bp in done:
                    A = _op_block(L[k], bi, bp, bwd)
                    for c in range(A.shape[1]):
                        r -= np.outer(A[:, c], X[k, bp, cols][c])
                O = _invert_diag(L[k, bi, bi], bwd)
                x = np.zeros_like(r)
                for c in range(O.shape[1]):
                    x += np.outer(O[:, c], r[c])
                X[k, bi, cols] = x
                done.append(bi)
    return X


def _cols_model(L, B, bwd):
    """Column-tiled form: per matrix and 32 columns, left-looking over the
    blocks in wavefront order (r_i = B_i minus the solved blocks' products,
    in order), then substitution on the diagonal block with the pivots'
    reciprocals (fwd from the first pivot, bwd from the last)."""
    K, M, S = B.shape
    X = np.zeros_like(B)
    for k in range(K):
        for c0 in range(0, S, NB):
            cols = slice(c0, min(c0 + NB, S))
            done = []
            for bi in _blocks(M, bwd):
                v = B[k, bi, cols].copy()
                for bp in done:
                    A = _op_block(L[k], bi, bp, bwd)
                    for c in range(A.shape[1]):
                        v -= np.outer(A[:, c], X[k, bp, cols][c])
                D = L[k, bi, bi]
                rcp = 1.0 / np.diag(D)
                for c in (range(D.shape[0] - 1, -1, -1) if bwd else range(D.shape[0])):
                    x = v[c] * rcp[c]
                    if bwd:
                        v[:c] -= np.outer(D[c, :c], x)
                    else:
                        v[c + 1:] -= np.outer(D[c + 1:, c], x)
                    v[c] = x
                X[k, bi, cols] = v
                done.append(bi)
    return X


def _chol_diag_model(D, clamp):
    """chol_diag: right-looking over one 32-wide diagonal block, each
    column's multipliers scaled by the reciprocal of its exact pivot (d <=
    clamp or NaN frozen at 1e20), each product subtracted in turn."""
    d = np.tril(D)
    for j in range(d.shape[0]):
        piv = d[j, j] if d[j, j] > clamp else d.dtype.type(1e20)
        ljj = np.sqrt(piv)
        col = d[j + 1:, j] * (d.dtype.type(1) / ljj)
        d[j, j], d[j + 1:, j] = ljj, col
        d[j + 1:, j + 1:] -= np.tril(np.outer(col, col))
    return d


def _factor_tile_model(S, n, clamp):
    """factor_tile on the n x n lower tile S in place: per 32-wide panel the
    diagonal block (chol_diag), its inverse (invert_diag), W = a L_d^-T for
    the rows below, and their products summed before one subtraction."""
    for j0 in range(0, n, NB):
        j1 = min(j0 + NB, n)
        S[j0:j1, j0:j1] = _chol_diag_model(S[j0:j1, j0:j1], clamp)
        if j1 < n:
            W = S[j1:n, j0:j1] @ _invert_diag(S[j0:j1, j0:j1], False).T
            S[j1:n, j0:j1] = W
            S[j1:n, j1:n] -= np.tril(W @ W.T)


def _invert_tile_model(S):
    """invert_tile: the lower factor S into L^-1 in place, block column by
    block column from the last: X_JJ = L_JJ^-1, X_RJ = -(X_RR L_RJ) X_JJ."""
    for j0 in range(S.shape[0] - NB, -1, -NB):
        j1 = j0 + NB
        X = _invert_diag(S[j0:j1, j0:j1], False)
        S[j1:, j0:j1] = -((S[j1:, j1:] @ S[j1:, j0:j1]) @ X)
        S[j0:j1, j0:j1] = X


def _tile_product(X, Y):
    """X Y^T as the large form sums it: f64 one sum over the depth; f32
    each 32-deep chunk summed from zero and the chunk sums added in turn."""
    if X.dtype != np.float32:
        return X @ Y.T
    acc = np.zeros((X.shape[0], Y.shape[0]), X.dtype)
    for c0 in range(0, X.shape[1], NB):
        acc += X[:, c0:c0 + NB] @ Y[:, c0:c0 + NB].T
    return acc


def _tiled_tasks(nt):
    """The large form's tasks of one matrix in ticket order, group g by
    group g: the chain's step C(g) (step g - 1 on tile (g, g), factor,
    inverse; then tile (g + 1, g) times L_gg^-T), P(i, g) for i >= g + 2
    (step g - 1, then times L_gg^-T), U(i, j, g - 1) for j > g by columns,
    and U(g + 2, g + 1, g), the tile below the next diagonal."""
    for g in range(nt):
        yield "C", g, g, g - 1
        for i in range(g + 2, nt):
            yield "P", i, g, g - 1
        for j in range(g + 1, nt) if g else ():
            for i in range(j, nt):
                yield "U", i, j, g - 1
        if g + 2 < nt:
            yield "U", g + 2, g + 1, g


def _chol_tiled_model(A, T, clamp):
    """The large Cholesky form's arithmetic, run task by task in ticket order
    (matrix fastest): every task's waits on the tiles' counters (steps
    applied; j + 1 once final) are asserted to hold when it comes up, so the
    order is topological; each tile takes its steps in order, each step's
    products summed from zero (a kT x kT product) and subtracted once."""
    K, M, _ = A.shape
    nt = -(-M // T)
    L = np.zeros_like(A)
    Dinv = np.zeros((K, nt, T, T), A.dtype)
    cnt = np.zeros((K, nt, nt), int)
    blk = [slice(a * T, min(M, a * T + T)) for a in range(nt)]

    def update(k, i, j, st):
        """Tile (i, j) after step st: from A at step 0, else from L."""
        assert cnt[k, i, j] >= st and cnt[k, i, st] >= st + 1 and cnt[k, j, st] >= st + 1
        src = A[k] if st == 0 else L[k]
        return src[blk[i], blk[j]] - _tile_product(L[k, blk[i], blk[st]], L[k, blk[j], blk[st]])

    def panel(k, i, g, C):
        assert cnt[k, g, g] >= g + 1
        L[k, blk[i], blk[g]] = _tile_product(C, Dinv[k, g])
        cnt[k, i, g] = g + 1

    for task in _tiled_tasks(nt):
        for k in range(K):
            kind, i, j, st = task
            if kind == "C":
                g = i
                C = update(k, g, g, st) if st >= 0 else A[k, blk[g], blk[g]]
                n = C.shape[0]
                S = np.zeros((T, T), A.dtype)
                S[:n, :n] = np.tril(C)
                _factor_tile_model(S, n, clamp)
                L[k, blk[g], blk[g]] = S[:n, :n]
                if g + 1 < nt:
                    _invert_tile_model(S)
                    Dinv[k, g] = S
                cnt[k, g, g] = g + 1
                if g + 1 < nt:
                    assert cnt[k, g + 1, g] >= g
                    panel(k, g + 1, g, L[k, blk[g + 1], blk[g]] if g else A[k, blk[g + 1], blk[g]])
            elif kind == "P":
                panel(k, i, j, update(k, i, j, st) if st >= 0 else A[k, blk[i], blk[j]])
            else:
                L[k, blk[i], blk[j]] = update(k, i, j, st)
                cnt[k, i, j] = st + 1
    return np.tril(L)


@pytest.mark.parametrize("T,case", [(64, "partial"), (64, "frozen"), (128, "partial"),
                                    (128, "frozen")])
def test_chol_tiled_model_matches_jax(T, case):
    """The large Cholesky form's arithmetic (csrc/dense_kernels.cu,
    chol_tiled_kernel), rehearsed in f64 task by task in ticket order with
    its counters, against the JAX package's chol_batched (its lax reference
    on the CPU): 1e-10 relative.  Cases: K = 2 with a partial last tile
    (M = 200 at T = 64, 328 at T = 128), and frozen pivots (zero rows in
    the first, a middle and the last tile; L_jj = 1e10, their columns ~0)."""
    jnp = pytest.importorskip("jax.numpy")
    from slampp_tpu.ops import dense_kernels as jdk

    rng = np.random.default_rng(41)
    M = 200 if T == 64 else 328
    zero = (3, 100, M - 1)
    A = _spd(rng, 2, M) if case == "partial" else _frozen_case(rng, M=M, zero_rows=zero)
    L = _chol_tiled_model(A, T, 1e-8)
    ref = np.asarray(jdk.chol_batched(jnp.asarray(A), clamp=1e-8))
    assert np.isfinite(L).all()
    scale = np.abs(ref[np.abs(ref) < 1e9]).max()
    assert np.abs(L - ref).max() <= 1e-10 * np.abs(ref).max()
    assert np.abs(np.where(np.abs(ref) < 1e9, L - ref, 0)).max() <= 1e-10 * scale
    if case == "frozen":
        for z in zero:
            assert abs(L[0, z, z] - 1e10) < 1e4
            assert np.abs(L[0, z + 1:, z]).max(initial=0.0) < 1e-6


def test_chol_tiled_model_f32_residual():
    """The large form's f32 arithmetic (the model above in float32) on a
    seeded SPD matrix of condition ~1e6: its relative residual max |L L^T -
    A| / max |A| stays within twice the plain version's."""
    rng = np.random.default_rng(5)
    M = 328
    Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
    A64 = (Q * np.logspace(0, -6, M)) @ Q.T
    A64 = (A64 + A64.T)[None] / 2
    A = A64.astype(np.float32)

    def resid(L):
        L = L.astype(np.float64)
        return np.abs(L @ np.swapaxes(L, 1, 2) - A64).max() / np.abs(A64).max()

    plain = resid(dk.chol_batched_plain(torch.from_numpy(A)).numpy())
    for T in (64, 128):
        L = _chol_tiled_model(A, T, 1e-8)
        assert L.dtype == np.float32 and np.isfinite(L).all()
        assert resid(L) <= 2 * plain, (T, resid(L), plain)


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("form,case", [
    ("separator", "partial"), ("separator", "frozen"), ("separator", "S43"),
    ("columns", "partial"), ("columns", "frozen"), ("columns", "S43")])
def test_trsm_form_model_matches_jax(form, case, bwd):
    """Each newer TRSM form's arithmetic, rehearsed in f64 in the order its
    kernel sums, against the JAX package's trsm_lower_batched /
    trsm_lower_t_batched (lax triangular_solve on the CPU): 1e-10 relative.
    Cases: a partial last panel (M % 32 = 8), frozen pivots (L_jj = 1e10,
    entries ~1e-10 and no NaN), S = 43 (not a multiple of 8 or 32)."""
    jnp = pytest.importorskip("jax.numpy")
    from slampp_tpu.ops import dense_kernels as jdk

    rng = np.random.default_rng(31)
    if case == "frozen":
        A, S = _frozen_case(rng, M=72, zero_rows=(3, 40, 70)), (8 if form == "separator" else 37)
    elif case == "partial":
        K, M, S = (1, 1000, 8) if form == "separator" else (2, 200, 40)
        A = _spd(rng, K, M)
    else:
        A, S = _spd(rng, 2, 136), 43
    L = dk.chol_batched(torch.from_numpy(A), clamp=1e-8).numpy()
    B = rng.normal(size=(A.shape[0], A.shape[1], S))
    jfn = jdk.trsm_lower_t_batched if bwd else jdk.trsm_lower_batched
    ref = np.asarray(jfn(jnp.asarray(L), jnp.asarray(B)))
    X = (_sep_model if form == "separator" else _cols_model)(L, B, bwd)
    assert np.isfinite(X).all()
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-10
    if case == "frozen":
        assert np.abs(X[0, [3, 40, 70]]).max() < 1e-6 * np.abs(B).max()


def test_cpu_dispatch_launches_no_kernel():
    dk.reset_launches()
    rng = np.random.default_rng(3)
    A = torch.from_numpy(_spd(rng, 2, 16))
    L = dk.chol_batched(A)
    B = torch.from_numpy(rng.normal(size=(2, 16, 8)))
    dk.trsm_lower_t_batched(L, dk.trsm_lower_batched(L, B))
    assert dk.launches == {
        "chol_batched": 0, "trsm_lower_batched": 0, "trsm_lower_t_batched": 0
    }


# ------------------------------------------------------------------ CUDA / gpu


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,M,S", [(3, 16, 5), (2, 40, 13), (55, 192, 48), (1, 488, 8)])
def test_cuda_kernels_match_plain(cuda, dtype, K, M, S):
    rng = np.random.default_rng(M)
    A = torch.from_numpy(_spd(rng, K, M)).to(cuda, dtype)
    B = torch.from_numpy(rng.normal(size=(K, M, S))).to(cuda, dtype)
    dk.reset_launches()
    L = dk.chol_batched(A)
    Y = dk.trsm_lower_batched(L, B)
    X = dk.trsm_lower_t_batched(L, Y)
    torch.cuda.synchronize()
    assert dk.launches == {
        "chol_batched": 1, "trsm_lower_batched": 1, "trsm_lower_t_batched": 1
    }
    # f64: agreement with the plain version; f32: relative residuals
    # (row-order rounding differs from the panel-blocked plain version)
    if dtype == torch.float64:
        tol = 1e-10
        torch.testing.assert_close(L, dk.chol_batched_plain(A), rtol=0, atol=tol)
        torch.testing.assert_close(Y, dk.trsm_lower_batched_plain(L, B), rtol=0, atol=tol)
        torch.testing.assert_close(X, dk.trsm_lower_t_batched_plain(L, Y), rtol=0, atol=tol)
    else:
        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        assert rel(L @ L.transpose(1, 2), A) < 1e-4
        assert rel(L @ Y, B) < 1e-4
        assert rel(L.transpose(1, 2) @ X, Y) < 1e-4
        assert rel(L, dk.chol_batched_plain(A)) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_frozen_pivot_matches_plain(cuda, dtype):
    A = torch.from_numpy(_frozen_case(np.random.default_rng(7))).to(cuda, dtype)
    L = dk.chol_batched(A, clamp=1e-8)
    assert bool(torch.isfinite(L).all())
    torch.testing.assert_close(L, dk.chol_batched_plain(A, 1e-8), rtol=1e-5, atol=1e-5)


def _check_chol(A, L):
    """The Cholesky kernel against its plain version: f64 max |kernel -
    plain| over max |plain| within 1e-10; f32 relative residual within 1e-4;
    the upper triangle exactly zero."""
    ref = dk.chol_batched_plain(A)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(L).all())
    assert not bool(torch.triu(L, 1).any())
    if A.dtype == torch.float64:
        assert float((L - ref).abs().max() / ref.abs().max()) < 1e-10
    else:
        assert float((L @ L.transpose(1, 2) - A).abs().max() / A.abs().max()) < 1e-4


# the first M on each side of the resident / streaming boundary (f32 288 /
# 296, f64 192 / 200 on a 227 KB opt-in; at K = 3 both M above it stream)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side", [0, 8], ids=["resident", "streaming"])
def test_cuda_chol_resident_boundary_matches_plain(cuda, dtype, side):
    M = dk.chol_resident_max_m(dtype) + side
    assert M >= 192  # the dense frames' part blocks are resident in both dtypes
    A = torch.from_numpy(_spd(np.random.default_rng(M), 3, M)).to(cuda, dtype)
    dk.reset_launches()
    _check_chol(A, dk.chol_batched(A))
    assert dk.launches["chol_batched"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_chol_frozen_pivot_resident_matches_plain(cuda, dtype):
    """Frozen pivots in the resident form (M = 192, rows 5, 100, 191 zero):
    L_jj = 1e10 on them, their columns ~0, the rest as the plain version."""
    zero = (5, 100, 191)
    A = torch.from_numpy(_frozen_case(np.random.default_rng(11), M=192, zero_rows=zero))
    A = A.repeat(4, 1, 1).to(cuda, dtype)
    L = dk.chol_batched(A, clamp=1e-8)
    ref = dk.chol_batched_plain(A, 1e-8)
    assert bool(torch.isfinite(L).all())
    keep = [i for i in range(192) if i not in zero]
    scale = float(ref[:, keep][:, :, keep].abs().max())
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert float((L - ref).abs().max()) <= tol * float(ref.abs().max())
    assert float((L[:, keep][:, :, keep] - ref[:, keep][:, :, keep]).abs().max()) <= tol * scale
    for z in zero:
        assert abs(float(L[0, z, z]) - 1e10) < 1e4
        if z + 1 < 192:
            assert float(L[:, z + 1:, z].abs().max()) < 1e-6


def _device_spd(cuda, M):
    gen = torch.Generator(device=cuda).manual_seed(M)
    G = torch.randn(1, M, M, device=cuda, dtype=torch.float64, generator=gen)
    return G @ G.transpose(1, 2) / M + torch.eye(M, device=cuda, dtype=torch.float64)


# large M, up to the largest M the one-CTA kernel took before the large
# form (f64 3104, f32 6336; the plain version would take minutes there): by
# relative residual against A
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,tol", [(torch.float64, 1024, 1e-10),
                                         (torch.float64, 3104, 1e-10),
                                         (torch.float32, 2048, 1e-4),
                                         (torch.float32, 6336, 1e-4)])
def test_cuda_chol_largest_m_residual(cuda, dtype, M, tol):
    A = _device_spd(cuda, M)
    L = dk.chol_batched(A.to(dtype))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
    L64 = L.double()
    assert float((L64 @ L64.transpose(1, 2) - A).abs().max() / A.abs().max()) < tol


# the first M beyond the one-CTA kernel's old limits (f64 3104, f32 6336)
# raised in an earlier design; the large form takes any M that memory holds,
# so these factor like any other
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M", [(torch.float64, 3112), (torch.float32, 6344)])
def test_cuda_chol_beyond_one_cta_limit_factors(cuda, dtype, M):
    A = _device_spd(cuda, M)
    L = dk.chol_batched(A.to(dtype))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
    L64 = L.double()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((L64 @ L64.transpose(1, 2) - A).abs().max() / A.abs().max()) < tol


# the sphere2500 graph's f64 separator (Ms = 3952, also cityTrees10k's
# sparse-Schur separator) was beyond the one-CTA kernel's largest f64 M
# (3104), and the exact v3 engine raised there once; the large form
# factors it, and M = 6400 beyond it, as the plain version does
@pytest.mark.gpu
@pytest.mark.parametrize("M", [3952, 6400])
def test_cuda_chol_f64_separator_matches_plain(cuda, M):
    A = _device_spd(cuda, M)
    dk.reset_launches()
    L = dk.chol_batched(A)
    ref = dk.chol_batched_plain(A)
    torch.cuda.synchronize()
    assert dk.launches["chol_batched"] == 1
    assert bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
    assert float((L - ref).abs().max() / ref.abs().max()) < 1e-10


# both sides of each crossover of chol_large_from (measured on an H100
# with scripts/chol_forms_ab.py): f32 from M = 392, and 440 at K >= 40; f64
# from 296, and 392 at K >= 40
CHOL_CROSSOVERS = [
    (torch.float32, 1, 384, "streaming"), (torch.float32, 1, 392, "large"),
    (torch.float32, 40, 432, "streaming"), (torch.float32, 40, 440, "large"),
    (torch.float64, 1, 288, "streaming"), (torch.float64, 1, 296, "large"),
    (torch.float64, 40, 384, "streaming"), (torch.float64, 40, 392, "large")]


# the form the plan takes at the paths' shapes: resident part frames, the
# sphere's streamed (40, 320) frames, sphere1000's (17, 320) f64 frames and
# every separator in the large form; and both sides of each crossover
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,K,M,form", [
    (torch.float32, 55, 192, "resident"), (torch.float64, 55, 192, "resident"),
    (torch.float32, 40, 320, "streaming"), (torch.float64, 40, 320, "streaming"),
    (torch.float64, 17, 320, "large"),
    (torch.float32, 1, 488, "large"), (torch.float64, 1, 1472, "large"),
    (torch.float32, 1, 3952, "large"), (torch.float64, 1, 3952, "large")] + CHOL_CROSSOVERS)
def test_cuda_chol_forms_at_the_path_shapes(cuda, dtype, K, M, form):
    assert dk.chol_form(dtype, K, M) == form


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,K,M,form", CHOL_CROSSOVERS)
def test_cuda_chol_crossover_sides_match_plain(cuda, dtype, K, M, form):
    assert dk.chol_form(dtype, K, M) == form
    A = _device_frozen(cuda, K, M, ()).to(dtype)
    _check_large(A, dk.chol_batched(A))


def _check_large(A, L, clamp=1e-8, zero=()):
    """The large form against the plain version: f64 max |kernel - plain|
    over the largest unfrozen |plain| within 1e-10; f32 relative residual
    within 1e-4 (over the unfrozen rows and columns); the upper triangle
    exactly zero; frozen pivots L_jj = 1e10 with their columns ~0."""
    ref = dk.chol_batched_plain(A, clamp)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
    keep = [i for i in range(A.shape[1]) if i not in zero]
    if A.dtype == torch.float64:
        scale = float(ref[:, keep][:, :, keep].abs().max())
        assert float((L - ref).abs().max()) < 1e-10 * scale
    else:
        LLt = (L.double() @ L.double().transpose(1, 2))[:, keep][:, :, keep]
        Ak = A.double()[:, keep][:, :, keep]
        assert float((LLt - Ak).abs().max() / Ak.abs().max()) < 1e-4
    for z in zero:
        assert abs(float(L[0, z, z]) - 1e10) < 1e4
        if z + 1 < A.shape[1]:
            assert float(L[:, z + 1:, z].abs().max()) < 1e-6


def _device_frozen(cuda, K, M, zero, seed=3):
    """K seeded PSD matrices made on the card, rows and columns ``zero``
    exactly zero (frozen pivots in any precision), the rest shifted by 1."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    G = torch.randn(K, M, M, device=cuda, dtype=torch.float64, generator=gen)
    G[:, list(zero), :] = 0
    A = G @ G.transpose(1, 2) / M
    keep = [i for i in range(M) if i not in zero]
    A[:, keep, keep] += 1.0
    return A


# the large form (64-wide tiles on a ticketed task graph) at the paths'
# separators, against the plain version
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M", [(torch.float32, 488), (torch.float64, 488),
                                     (torch.float32, 1472), (torch.float64, 1472),
                                     (torch.float32, 3952), (torch.float64, 3952),
                                     (torch.float32, 5344), (torch.float64, 5344),
                                     (torch.float64, 6400)])
def test_cuda_chol_large_form_matches_plain(cuda, dtype, M):
    A = _device_spd(cuda, M).to(dtype)
    assert dk.chol_form(dtype, 1, M) == "large"
    dk.reset_launches()
    L = dk.chol_batched(A)
    assert dk.launches["chol_batched"] == 1
    _check_large(A, L)


# frozen pivots at a separator M (in the first, a middle and the last
# tile), and two matrices at a large M
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,M,zero", [(1, 3952, (7, 2000, 3951)), (2, 2048, ())],
                         ids=["frozen", "K2"])
def test_cuda_chol_large_form_frozen_and_batched(cuda, dtype, K, M, zero):
    A = _device_frozen(cuda, K, M, zero).to(dtype)
    assert dk.chol_form(dtype, K, M) == "large"
    _check_large(A, dk.chol_batched(A, clamp=1e-8), zero=zero)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_chol_large_form_is_deterministic(cuda, dtype):
    """Each tile takes its steps in order and every sum has a fixed order:
    two launches on the same input give the same bits."""
    A = _device_spd(cuda, 1472).to(dtype)
    assert torch.equal(dk.chol_batched(A), dk.chol_batched(A))


@pytest.mark.gpu
def test_cuda_chol_large_form_graph_replay(cuda):
    """The large form (its workspace zeroed on the stream, then one launch,
    no cooperative launch) captured in a CUDA graph and replayed on new
    matrices: each replay within 1e-10 of the plain version and equal to an
    eager launch."""
    M, f64 = 1472, torch.float64
    A = _device_spd(cuda, M)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        dk.chol_batched(A)  # plans and attributes before the capture
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L = dk.chol_batched(A)
    for seed in (5, 6):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        G = torch.randn(1, M, M, device=cuda, dtype=f64, generator=gen)
        A.copy_(G @ G.transpose(1, 2) / M + torch.eye(M, device=cuda, dtype=f64))
        graph.replay()
        torch.cuda.synchronize()
        _check_large(A, L)
        assert torch.equal(L, dk.chol_batched(A))


def _check_trsm(bwd, L, B):
    """A TRSM kernel against its plain version: f64 max |kernel - plain|
    over max |plain| within 1e-10; f32 relative residual within 1e-4."""
    fn = dk.trsm_lower_t_batched if bwd else dk.trsm_lower_batched
    plain = dk.trsm_lower_t_batched_plain if bwd else dk.trsm_lower_batched_plain
    X = fn(L, B)
    ref = plain(L, B)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(X).all())
    if L.dtype == torch.float64:
        assert float((X - ref).abs().max() / ref.abs().max()) < 1e-10
    else:
        Lop = L.transpose(1, 2) if bwd else L
        assert float((Lop @ X - B).abs().max() / B.abs().max()) < 1e-4


# the main path's shapes, several column groups in one cluster with S not a
# multiple of 8, a partial panel, one panel, and M beyond the resident size
# (f64 from 584, f32 from 928)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("K,M,S", [(1, 488, 8), (55, 192, 48), (55, 192, 8), (55, 192, 43),
                                   (3, 40, 13), (2, 8, 1), (1, 1032, 8), (1, 1096, 8)])
def test_cuda_trsm_match_plain(cuda, dtype, bwd, K, M, S):
    rng = np.random.default_rng(M + S)
    L = dk.chol_batched(torch.from_numpy(_spd(rng, K, M)).to(cuda, dtype))
    B = torch.from_numpy(rng.normal(size=(K, M, S))).to(cuda, dtype)
    dk.reset_launches()
    _check_trsm(bwd, L, B)
    assert dk.launches["trsm_lower_t_batched" if bwd else "trsm_lower_batched"] == 1


def _device_chol(cuda, M, dtype, K=1):
    """Cholesky factors of K well-conditioned (M, M) SPD matrices, made on
    the card (a large M would take seconds through numpy)."""
    gen = torch.Generator(device=cuda).manual_seed(M + K - 1)  # K = 1: _device_spd's draws
    G = torch.randn(K, M, M, device=cuda, dtype=torch.float64, generator=gen)
    A = G @ G.transpose(1, 2) / M + torch.eye(M, device=cuda, dtype=torch.float64)
    return torch.linalg.cholesky(A).to(dtype).contiguous()


def _device_rhs(cuda, K, M, S, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    return torch.randn(K, M, S, device=cuda, dtype=torch.float64, generator=gen).to(dtype)


# large M on the separator form, up to and beyond the largest M the cluster
# form's plan took before it (f64 7680, f32 12288): the separator form has
# no cap on M
@pytest.mark.gpu
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype,M", [(torch.float64, 3104), (torch.float64, 7680),
                                     (torch.float32, 6336), (torch.float32, 12288)])
def test_cuda_trsm_large_m_matches_plain(cuda, dtype, bwd, M):
    _check_trsm(bwd, _device_chol(cuda, M, dtype), _device_rhs(cuda, 1, M, 8, dtype))


# the first M beyond the cluster form's last plan (f64 7688, f32 12296)
# used to raise; the separator form solves them like any other M
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M", [(torch.float64, 7688), (torch.float32, 12296)])
def test_cuda_trsm_beyond_largest_plan_raises(cuda, dtype, M):
    assert dk.trsm_form(dtype, 1, M, 8, False) == "separator"
    _check_trsm(False, _device_chol(cuda, M, dtype), _device_rhs(cuda, 1, M, 8, dtype))


def _forms_cases():
    """(dtype, bwd, K, M, S, form): the paths' shapes that changed form, and
    both sides of each crossover of plan_trsm (separator_from,
    columns_first; measured on an H100 with scripts/trsm_forms_ab.py).  K =
    None stands for the card's SM count (one column-tiled CTA per SM)."""
    f32, f64 = torch.float32, torch.float64
    cases = []
    for dt in (f32, f64):
        for bwd in (False, True):
            cases += [(dt, bwd, 1, 3952, 8, "separator"), (dt, bwd, 1, 5344, 8, "separator"),
                      (dt, bwd, 2, 5344, 8, "separator")]
        cases += [(dt, False, 40, 320, 176, "columns"), (dt, False, 11, 200, 960, "columns"),
                  (dt, False, 17, 320, 152, "columns"), (dt, True, 40, 320, 176, "columns")]
        cases += [(dt, True, 1, 536, 8, "cluster"), (dt, True, 1, 544, 8, "separator")]
    cases += [(f32, False, 157, 192, 408, "columns"), (f32, False, 12, 232, 832, "columns"),
              (f32, False, 1, 1144, 8, "cluster"), (f32, False, 1, 1152, 8, "separator"),
              (f64, False, 1, 664, 8, "cluster"), (f64, False, 1, 672, 8, "separator"),
              (f64, False, 17, 320, 8, "cluster"), (f64, False, 40, 320, 8, "separator"),
              (f32, True, 17, 320, 8, "cluster"), (f32, True, 40, 320, 8, "separator"),
              (f64, True, 16, 320, 8, "cluster"), (f64, True, 17, 320, 8, "separator"),
              (f32, False, 13, 192, 32, "cluster"), (f32, False, 32, 192, 16, "columns"),
              (f64, False, 31, 192, 16, "cluster"), (f64, False, 32, 192, 16, "columns"),
              (f32, False, None, 192, 8, "columns"), (f64, True, None, 192, 8, "columns"),
              (f32, False, -1, 192, 8, "cluster"), (f64, False, 1, 488, 48, "cluster")]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bwd,K,M,S,form", _forms_cases())
def test_cuda_trsm_forms_match_plain(cuda, dtype, bwd, K, M, S, form):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    K = sms if K is None else sms - 1 if K == -1 else K
    assert dk.trsm_form(dtype, K, M, S, bwd) == form
    L, B = _device_chol(cuda, M, dtype, K), _device_rhs(cuda, K, M, S, dtype)
    dk.reset_launches()
    _check_trsm(bwd, L, B)
    assert dk.launches["trsm_lower_t_batched" if bwd else "trsm_lower_batched"] == 1


# frozen pivots (L_jj = 1e10) at a separator M, in the separator form
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_cuda_trsm_separator_frozen_pivot_matches_plain(cuda, dtype, bwd):
    M, zero = 3952, [7, 2000, 3951]
    gen = torch.Generator(device=cuda).manual_seed(3)
    G = torch.randn(1, M, M, device=cuda, dtype=torch.float64, generator=gen)
    G[:, zero, :] = 0
    A = G @ G.transpose(1, 2) / M
    keep = [i for i in range(M) if i not in zero]
    A[:, keep, keep] += 1.0
    L = dk.chol_batched(A.to(dtype), clamp=1e-8)
    assert dk.trsm_form(dtype, 1, M, 8, bwd) == "separator"
    B = _device_rhs(cuda, 1, M, 8, dtype)
    _check_trsm(bwd, L, B)
    X = (dk.trsm_lower_t_batched if bwd else dk.trsm_lower_batched)(L, B)
    assert float(X[0, zero].abs().max()) < 1e-6 * float(B.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_trsm_separator_graph_replay(cuda, dtype):
    """The separator form (a workspace zeroed on the stream, then one
    launch) captured in a CUDA graph and replayed on new right-hand sides."""
    L = _device_chol(cuda, 3952, dtype)
    B = _device_rhs(cuda, 1, 3952, 8, dtype)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        dk.trsm_lower_t_batched(L, B)  # plans and attributes before the capture
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        X = dk.trsm_lower_t_batched(L, B)
    for seed in (5, 6):
        B.copy_(torch.randn(B.shape, device=cuda, dtype=torch.float64,
                            generator=torch.Generator(device=cuda).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        ref = dk.trsm_lower_t_batched_plain(L, B)
        if dtype == torch.float64:
            assert float((X - ref).abs().max() / ref.abs().max()) < 1e-10
        else:
            assert float((L.transpose(1, 2) @ X - B).abs().max() / B.abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_cuda_trsm_frozen_pivot_matches_plain(cuda, dtype, bwd):
    rng = np.random.default_rng(9)
    A = torch.from_numpy(_frozen_case(rng, M=488, zero_rows=(5, 200, 487))).to(cuda, dtype)
    L = dk.chol_batched(A, clamp=1e-8)
    _check_trsm(bwd, L, torch.from_numpy(rng.normal(size=(1, 488, 8))).to(cuda, dtype))


@pytest.mark.gpu
def test_cuda_rejects_unsupported_input(cuda):
    A = torch.eye(16, device=cuda).repeat(2, 1, 1)
    with pytest.raises(ValueError):
        dk.chol_batched(torch.eye(12, device=cuda).repeat(2, 1, 1))  # M % 8
    with pytest.raises(ValueError):
        dk.chol_batched(A.transpose(1, 2))  # non-contiguous
    with pytest.raises(TypeError):
        dk.chol_batched(A.half())
    with pytest.raises(ValueError):
        dk.trsm_lower_batched(A, torch.zeros(2, 16, 8, device=cuda)[:, :, ::2])
    buf = torch.zeros(2 * 16 * 8 + 1, device=cuda)
    with pytest.raises(ValueError):  # contiguous, but 4 bytes off a 16-byte boundary
        dk.trsm_lower_batched(A, buf[1:].view(2, 16, 8))
