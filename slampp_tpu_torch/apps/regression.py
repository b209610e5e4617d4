"""Golden-value regression suite on the port (counterpart of
``scripts/regression.py``).

The reference's correctness contract is ``scripts/tests/unit_tests.sh``
(md5-pinned datasets, exact iteration counts, rounded denormalized chi2).
Its datasets are not in the repository, so the suite pins synthetic ones by
generator seed and the md5 of the generated text, with the golden chi2 of
``scripts/regression_goldens.json``.  The port's generators write the JAX
package's text byte for byte, so the md5s are the same goldens.  The file
is only read here (recording new goldens stays with the JAX package's
script).

    python -m slampp_tpu_torch.apps.regression [--device cpu]

prints one line per case and ``regression: PASS``; exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_PATH = os.path.join(ROOT, "scripts", "regression_goldens.json")
TOL_CHI2 = 1e-6  # relative; generator and solvers are deterministic

# (name, generator, gen_kwargs, mode): the unit_tests.sh matrix of batch
# pose-only 2D / 3D, incremental 2D and BA batch with Schur
CONFIGS = [
    ("manhattan300_batch", "manhattan", dict(n_poses=300, loop_prob=0.6, loop_separation=20, loop_radius=5.0, seed=0), "batch"),
    ("manhattan1000_batch", "manhattan", dict(n_poses=1000, loop_prob=0.3, loop_separation=30, loop_radius=4.0, seed=1), "batch"),
    ("manhattan300_incremental", "manhattan", dict(n_poses=300, loop_prob=0.6, loop_separation=20, loop_radius=5.0, seed=0), "incremental"),
    ("sphere300_batch", "sphere", dict(n_poses=300, n_rings=15, seed=0), "batch"),
    ("ba_small_schur", "ba", dict(n_cams=10, n_points=120, obs_per_point=5, seed=0), "ba"),
]


def _gen(kind, kwargs) -> str:
    from slampp_tpu_torch.io import datasets

    make = {"manhattan": datasets.make_manhattan, "sphere": datasets.make_sphere,
            "ba": datasets.make_ba_scene}[kind]
    return make(**kwargs)[0]


def run_config(kind, kwargs, mode, device) -> dict:
    """One case: {"md5", "chi2", "iterations"} as the JAX script reports
    them."""
    from slampp_tpu_torch.graph.system import GraphSystem
    from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
    from slampp_tpu_torch.models import se2 as m_se2
    from slampp_tpu_torch.solvers import (
        GaussNewtonSolver,
        IncrementalSolver,
        LevenbergMarquardtSolver,
    )

    text = _gen(kind, kwargs)
    md5 = hashlib.md5(text.encode()).hexdigest()
    with g2o_file(text) as path:
        recs = parse_file(path)
    if mode == "incremental":
        system = GraphSystem()
        solver = IncrementalSolver(system, solve_period=10, max_iterations=3, device=device)
        for r in recs:
            if r.kind == "edge2":
                system.add_edge("edge_pose2d", r.ids, r.values, r.info,
                                m_se2.POSE_POSE_INITIALIZERS)
                solver.incremental_step(r.ids)
        solver.optimize(5, 0.01)
        iters = solver.n_iterations
    else:
        system = build_system(recs)
        if mode == "ba":
            solver = LevenbergMarquardtSolver(system, use_schur=True, device=device)
        else:
            solver = GaussNewtonSolver(system, device=device)
        iters = solver.optimize(5, 0.01)
    return {"md5": md5, "chi2": solver.chi2(), "iterations": iters}


def run(device="cuda") -> dict:
    """Every case against its golden: {name: {md5, chi2, iterations, golden,
    md5_ok, chi2_rel_err, ok}}."""
    from slampp_tpu_torch.utils.device import require_device

    device = torch.device(device)
    require_device(device, "regression")
    with open(GOLDEN_PATH) as f:
        goldens = json.load(f)
    out = {}
    for name, kind, kwargs, mode in CONFIGS:
        res = run_config(kind, kwargs, mode, device)
        g = goldens[name]
        rel = abs(g["chi2"] - res["chi2"]) / max(1.0, abs(g["chi2"]))
        out[name] = {**res, "golden": g, "md5_ok": g["md5"] == res["md5"],
                     "chi2_rel_err": rel,
                     "ok": g["md5"] == res["md5"] and rel <= TOL_CHI2}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    results = run(args.device)
    failures = 0
    for name, r in results.items():
        failures += not r["ok"]
        print(f"{'OK' if r['ok'] else 'FAIL'} {name}: chi2={r['chi2']:.6f} "
              f"(golden {r['golden']['chi2']:.6f}) iterations={r['iterations']} "
              f"md5={'ok' if r['md5_ok'] else 'MISMATCH'}")
    print("regression:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
