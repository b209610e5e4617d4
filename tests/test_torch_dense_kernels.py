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
# 296, f64 192 / 200 on a 227 KB opt-in)
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


# large M, where the update takes W^T 16 (f64 1024, f32 2048) and 8
# columns at a time, up to the largest M per dtype (the plain version would
# take minutes there): by relative residual against A; and M + 8 raises
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M", [(torch.float64, 3112), (torch.float32, 6344)])
def test_cuda_chol_beyond_largest_m_raises(cuda, dtype, M):
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        dk.chol_batched(torch.eye(M, device=cuda, dtype=dtype)[None])


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


def _device_chol(cuda, M, dtype):
    """Cholesky factor of a well-conditioned (1, M, M) SPD matrix, made on
    the card (a large M would take seconds through numpy)."""
    return torch.linalg.cholesky(_device_spd(cuda, M)).to(dtype).contiguous()


# M where each CTA no longer holds every x_p (f64 from 2568, f32 from 5128),
# up to the largest M with a plan on a 227 KB opt-in (f64 7680, f32 12288)
@pytest.mark.gpu
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype,M", [(torch.float64, 3104), (torch.float64, 7680),
                                     (torch.float32, 6336), (torch.float32, 12288)])
def test_cuda_trsm_large_m_matches_plain(cuda, dtype, bwd, M):
    L = _device_chol(cuda, M, dtype)
    B = torch.randn(1, M, 8, device=cuda, dtype=torch.float64,
                    generator=torch.Generator(device=cuda).manual_seed(1)).to(dtype)
    _check_trsm(bwd, L, B)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M", [(torch.float64, 7688), (torch.float32, 12296)])
def test_cuda_trsm_beyond_largest_plan_raises(cuda, dtype, M):
    L = torch.eye(M, device=cuda, dtype=dtype)[None]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        dk.trsm_lower_batched(L, torch.zeros(1, M, 8, device=cuda, dtype=dtype))


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
