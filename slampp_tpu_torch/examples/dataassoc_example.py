"""Data association with marginal-covariance gating (counterpart of
``examples/dataassoc_example.py``; reference src/slam_dataassoc_example).

Candidate loop closures are accepted or rejected by a Mahalanobis (chi2)
gate computed from the marginal covariances of the candidate endpoints:
optimize a Manhattan graph, recover the block-diagonal marginal
covariances (MarginalCovariance, the reference CMarginalCovariance,
Marginals.h:6914), then score true closures (small residual) and wrong
associations (perturbed endpoints) with the chi2 gate and report the
separation.

    python -m slampp_tpu_torch.examples.dataassoc_example [--poses 300] [--device cpu]
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.marginals.marginals import MarginalCovariance
from slampp_tpu_torch.solvers.gauss_newton import GaussNewtonSolver


def np_abs_to_rel(p1, p2):
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = np.cos(p1[2]), np.sin(p1[2])
    a = (p2[2] - p1[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * de + s * dn, -s * de + c * dn, a])


def gate_chi2(system, cov, i, j, meas, meas_info):
    """Mahalanobis distance of a candidate relative-pose measurement under
    the current estimate and marginal covariances (innovation gating)."""
    pred = np_abs_to_rel(system.vertex_state(i), system.vertex_state(j))
    innov = meas - pred
    innov[2] = (innov[2] + np.pi) % (2 * np.pi) - np.pi
    # innovation covariance ~ Sigma_i + Sigma_j (block-diagonal marginals;
    # conservative without the cross term) + measurement covariance
    S = cov.block_diag[i] + cov.block_diag[j] + np.linalg.inv(meas_info)
    return float(innov @ np.linalg.solve(S, innov))


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0],
                      lambda ap: ap.add_argument("--poses", type=int, default=300))
    text, gt = make_manhattan(n_poses=args.poses, loop_prob=0.1, seed=0)
    with g2o_file(text) as path:
        system = build_system(parse_file(path))

    gn = GaussNewtonSolver(system, device=args.device)
    gn.optimize(max_iterations=10)

    cov = MarginalCovariance(system, device=args.device)
    cov.update_batch()

    info = np.diag([400.0, 400.0, 2500.0])
    rng = np.random.default_rng(1)
    order = list(system._vorder)

    true_scores, false_scores = [], []
    for _ in range(30):
        # true association: a geometrically consistent relative measurement
        i, j = sorted(rng.choice(len(order), 2, replace=False))
        vi, vj = order[i], order[j]
        meas = np_abs_to_rel(system.vertex_state(vi), system.vertex_state(vj))
        meas += rng.normal(0, 0.03, 3)
        true_scores.append(gate_chi2(system, cov, vi, vj, meas, info))
        # wrong association: same measurement claimed for a different endpoint
        k = order[(j + len(order) // 3) % len(order)]
        false_scores.append(gate_chi2(system, cov, vi, k, meas, info))

    thresh = 7.815  # chi2(3 dof, 95%)
    tp = sum(s < thresh for s in true_scores)
    tn = sum(s >= thresh for s in false_scores)
    print(f"true associations:  median gate chi2 = {np.median(true_scores):.2f} "
          f"({tp}/30 accepted at 95%)")
    print(f"wrong associations: median gate chi2 = {np.median(false_scores):.2f} "
          f"({tn}/30 rejected at 95%)")
    return tp, tn


if __name__ == "__main__":
    main()
