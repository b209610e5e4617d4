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
