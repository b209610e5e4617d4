"""Block-Jacobi preconditioned conjugate gradient on the dense-assembled
Gauss-Newton system (counterpart of ``slampp_tpu/linear/pcg.py``; reference
CNonlinearSolver_SPCG, include/slam/NonlinearSolver_SPCG.h:61).

The JAX package ran the iterations as one ``lax.while_loop``; here they are
a Python loop that reads the residual norm back once per iteration.
"""

from __future__ import annotations

import torch


def pcg_solve(
    H: torch.Tensor,
    b: torch.Tensor,
    block_size: int = 0,
    tol: float = 1e-10,
    max_iters: int = 250,
) -> torch.Tensor:
    """Solve H x = b by PCG with a (block-)Jacobi preconditioner.

    ``block_size`` 0 or 1 selects scalar Jacobi; otherwise, when H's leading
    dimension is a multiple of ``block_size``, the preconditioner is the
    inverse of the block diagonal (else scalar Jacobi, as in the JAX
    package).
    """
    N = H.shape[0]
    if block_size and block_size > 1 and N % block_size == 0:
        nb = N // block_size
        blocks = H.reshape(nb, block_size, nb, block_size)
        ar = torch.arange(nb, device=H.device)
        Minv = torch.linalg.inv(blocks[ar, :, ar, :])

        def precond(r):
            return torch.einsum("bij,bj->bi", Minv, r.reshape(nb, block_size)).reshape(-1)

    else:
        d = torch.diagonal(H)
        dinv = torch.where(d.abs() > 1e-300, 1.0 / d, torch.zeros_like(d))

        def precond(r):
            return dinv * r

    b2 = torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(max_iters):
        if not bool(torch.dot(r, r) > tol * tol * b2):
            break
        Hp = H @ p
        alpha = rz / torch.clamp_min(torch.dot(p, Hp), 1e-300)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-300)
        p = z + beta * p
        rz = rz_new
    return x
