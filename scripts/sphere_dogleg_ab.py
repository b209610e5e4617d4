"""Dogleg on the mixed v3 engine at sphere2500 after the CLI's 5 iterations,
with the port's kernels against their plain versions, on one CUDA card.

    python scripts/sphere_dogleg_ab.py

Runs ``DoglegSolver(engine="v3").optimize(5, 0.01)`` on the seed-0 sphere2500
graph (``apps/sphere.sphere_system``) five ways: on the card with the three
kernels, with the plain Cholesky in place of ``chol_batched``, with the plain
TRSMs in place of the two kernel solves, with all three plain, and on the CPU
(plain versions).  Prints each run's chi2 after every iteration, and its
final chi2 and distance from ``chip_smoke.JAX_REF["sphere-dl-v3-5"]`` (the
JAX package with float32 Jacobians rounded from float64).  Then it takes the (1, 3952, 3952)
float32 separator matrices that the kernel run factored, one per iteration,
and factors each with ``chol_batched``, the plain version and
``torch.linalg.cholesky_ex``: the residual max |L L^T - A| / max |A| and the
relative error of a float64 solve through each factor against a float64
factorization, beside A's condition number.  Ends with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import JAX_REF  # noqa: E402
from slampp_tpu_torch.apps import manhattan, sphere  # noqa: E402
from slampp_tpu_torch.ops import dense_kernels as dk  # noqa: E402

KERNELS = {k: getattr(dk, k) for k in ("chol_batched", "trsm_lower_batched",
                                       "trsm_lower_t_batched")}


def dogleg(label, device, plain=(), capture=None):
    """One 5-iteration dogleg optimize with the kernels named in ``plain``
    swapped for their plain versions; ``capture`` collects the separator
    matrices handed to the Cholesky."""
    ref = JAX_REF["sphere-dl-v3-5"][0]
    for name, fn in KERNELS.items():
        use = getattr(dk, f"{name}_plain") if name in plain else fn
        if capture is not None and name == "chol_batched":
            def use(A, fn=use):
                if A.shape[-1] > 3000:
                    capture.append(A.detach().clone())
                return fn(A)
        setattr(dk, name, use)
    try:
        solver = manhattan.make_solver(sphere.sphere_system(2500), "lambda-dl",
                                       torch.device(device), "v3")
        solver.verbose = True  # one "DL iter" line per iteration
        print(f"== {label}", flush=True)
        applied = solver.optimize(5, 0.01)
        chi2 = solver.chi2()
    finally:
        for name, fn in KERNELS.items():
            setattr(dk, name, fn)
    print(json.dumps({"run": label, "applied": applied, "chi2": chi2,
                      "rel_err": abs(chi2 - ref) / ref}), flush=True)


def separator_factors(mats):
    g = torch.Generator(device="cuda").manual_seed(0)
    for it, A in enumerate(mats):
        A64 = A.double()[0]
        b = torch.randn(A64.shape[0], 1, device="cuda", dtype=torch.float64, generator=g)
        x64 = torch.cholesky_solve(b, torch.linalg.cholesky(A64))
        out = {"iteration": it, "M": A64.shape[0], "cond": float(torch.linalg.cond(A64))}
        for name, fn in (("kernel", KERNELS["chol_batched"]),
                         ("plain", dk.chol_batched_plain),
                         ("cholesky_ex", lambda a: torch.linalg.cholesky_ex(a)[0])):
            L = fn(A)[0].double()
            x = torch.cholesky_solve(b, L)
            out[name] = {"residual": float((L @ L.T - A64).abs().max() / A64.abs().max()),
                         "solve_rel_err": float((x - x64).norm() / x64.norm())}
        print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sphere_dogleg_ab: no CUDA device", file=sys.stderr)
        return 1
    mats = []
    dogleg("card, kernels", "cuda", capture=mats)
    dogleg("card, plain Cholesky", "cuda", ("chol_batched",))
    dogleg("card, plain TRSMs", "cuda", ("trsm_lower_batched", "trsm_lower_t_batched"))
    dogleg("card, all plain", "cuda", tuple(KERNELS))
    dogleg("cpu", "cpu")
    separator_factors(mats)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
