"""Why the f32 separator Cholesky lost accuracy: a CPU rehearsal on the first
(1, 3952, 3952) float32 separator of a sphere2500 dogleg run.

    python scripts/chol_update_order.py

Captures the separator that ``DoglegSolver(engine="v3")`` hands to
``chol_batched`` on its first iteration (the CPU runs the plain versions),
then factors it with a float32 blocked Cholesky (32-wide panels, the
kernel's structure) in six variants, and prints each one's residual
max |L L^T - A| / max |A| and the relative error of a float64 solve through
it against a float64 factorization, beside ``cholesky_ex`` in float32:

  * the panel by substitution or by the diagonal block's explicit inverse;
  * the pivot as the correctly rounded sqrt and reciprocal, or as a
    reciprocal square root biased by 1 or 2 ulp (MUFU.RSQ's error);
  * the trailing update as A -= W W^T (the products summed first, as the
    plain version), or as the panel's 32 rank-1 updates subtracted in turn
    (each product rounding at the entry's magnitude, as the one-CTA kernel
    did before the update order was repaired).

A few minutes on a CPU, most of it the sequential updates.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from slampp_tpu_torch.apps import manhattan, sphere  # noqa: E402
from slampp_tpu_torch.ops import dense_kernels as dk  # noqa: E402

NB = 32


class _Captured(Exception):
    pass


def capture_separator() -> np.ndarray:
    """The first separator matrix (M > 3000) of a 5-iteration dogleg run."""
    orig = dk.chol_batched

    def grab(A, clamp=1e-8):
        if A.shape[-1] > 3000:
            raise _Captured(A[0].detach().clone().numpy())
        return orig(A, clamp)

    dk.chol_batched = grab
    try:
        manhattan.make_solver(sphere.sphere_system(2500), "lambda-dl", torch.device("cpu"),
                              "v3").optimize(5, 0.01)
    except _Captured as c:
        return c.args[0]
    finally:
        dk.chol_batched = orig
    raise RuntimeError("no separator was factored")


def _biased(x: np.float32, ulps: int) -> np.float32:
    for _ in range(abs(ulps)):
        x = np.nextafter(x, np.float32(np.inf if ulps > 0 else -np.inf))
    return np.float32(x)


def blocked_cholesky(A: np.ndarray, panel="substitution", rsqrt_ulps=0, rank1=False):
    """float32 right-looking Cholesky in 32-wide panels (see the module
    note for the variants)."""
    M = A.shape[0]
    O = torch.from_numpy(A.copy())
    for j0 in range(0, M, NB):
        j1 = min(j0 + NB, M)
        D = O[j0:j1, j0:j1].clone()
        Ld = torch.zeros_like(D)
        for j in range(j1 - j0):
            d = np.float32(D[j, j].item())
            if rsqrt_ulps:
                inv = _biased(np.float32(1.0) / np.sqrt(d), rsqrt_ulps)
                ljj = np.float32(d * inv)
            else:
                ljj = np.float32(np.sqrt(d))
                inv = np.float32(np.float32(1.0) / ljj)
            Ld[j, j] = float(ljj)
            col = D[j + 1:, j] * torch.tensor(inv)
            Ld[j + 1:, j] = col
            D[j + 1:, j + 1:] -= torch.outer(col, col)
        O[j0:j1, j0:j1] = Ld
        if j1 == M:
            break
        Ap = O[j1:, j0:j1]
        if panel == "inverse":
            Di = torch.linalg.solve_triangular(Ld.double(), torch.eye(j1 - j0, dtype=torch.float64),
                                               upper=False).float()
            W = Ap @ Di.T
        else:
            W = torch.linalg.solve_triangular(Ld, Ap.T.contiguous(), upper=False).T.contiguous()
        O[j1:, j0:j1] = W
        T = O[j1:, j1:]
        if rank1:
            for t in range(j1 - j0):
                T -= torch.outer(W[:, t], W[:, t])
        else:
            T -= W @ W.T
    return torch.tril(O)


def main() -> int:
    torch.set_num_threads(8)
    A = capture_separator()
    A64 = torch.from_numpy(A.astype(np.float64))
    L64 = torch.linalg.cholesky(A64)
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(A.shape[0], 1)))
    x64 = torch.cholesky_solve(b, L64)
    print(json.dumps({"M": A.shape[0], "cond": float(torch.linalg.cond(A64))}), flush=True)

    def report(name, L):
        Ld = L.double()
        x = torch.cholesky_solve(b, Ld)
        print(json.dumps({"variant": name,
                          "residual": float((Ld @ Ld.T - A64).abs().max() / A64.abs().max()),
                          "solve_rel_err": float((x - x64).norm() / x64.norm())}), flush=True)

    for name, kw in (("substitution, exact pivot, products summed first", {}),
                     ("explicit inverse, exact pivot, products summed first",
                      {"panel": "inverse"}),
                     ("substitution, rsqrt +1 ulp, products summed first", {"rsqrt_ulps": 1}),
                     ("substitution, rsqrt -2 ulp, products summed first", {"rsqrt_ulps": -2}),
                     ("substitution, exact pivot, products subtracted in turn", {"rank1": True}),
                     ("explicit inverse, rsqrt +2 ulp, products subtracted in turn",
                      {"panel": "inverse", "rsqrt_ulps": 2, "rank1": True})):
        report(name, blocked_cholesky(A, **kw))
    report("cholesky_ex, float32", torch.linalg.cholesky_ex(torch.from_numpy(A))[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
