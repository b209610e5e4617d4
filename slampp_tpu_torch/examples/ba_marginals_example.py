"""Schur-based covariance recovery in BA (counterpart of
``examples/ba_marginals_example.py``; reference src/ba_marginals_example,
3DV'17).

Optimizes a synthetic BA scene, then recovers camera covariances from the
inverse Schur complement and landmark covariances from them, comparing
against the dense reference algorithm.
"""

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.io.datasets import make_ba_scene
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.linear.schur import build_schur_plan
from slampp_tpu_torch.marginals import dense_marginals, schur_marginals
from slampp_tpu_torch.solvers import LevenbergMarquardtSolver


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    dev = args.device
    text, _ = make_ba_scene(n_cams=8, n_points=80, obs_per_point=5, seed=0)
    with g2o_file(text) as path:
        system = build_system(parse_file(path))

    solver = LevenbergMarquardtSolver(system, use_schur=True, device=dev)
    solver.optimize(10, 1e-8)
    print("chi2 after BA:", solver.chi2())

    graph = system.snapshot(dev)
    plan = build_schur_plan(system).to(dev)
    H, _, _ = assembly.assemble_dense(graph)
    alpha = 1e-3  # lift the mono gauge for the covariance query
    Sigma_cc, Sigma_ll = schur_marginals(H, plan, alpha=alpha)
    print("camera-0 position std:", np.sqrt(np.diag(Sigma_cc.cpu().numpy())[:3]))
    print("first landmark covariance diag:", np.diag(Sigma_ll[0].cpu().numpy()))

    # cross-check one landmark block against the dense reference algorithm
    Sigma_ref = dense_marginals(H + alpha * torch.eye(H.shape[0], dtype=H.dtype, device=dev))
    off = int(plan.lm_offsets[0])
    ref_blk = Sigma_ref[off : off + 3, off : off + 3].cpu().numpy()
    match = np.allclose(Sigma_ll[0].cpu().numpy(), ref_blk, atol=1e-7)
    print("dense-reference match:", match)
    return match


if __name__ == "__main__":
    main()
