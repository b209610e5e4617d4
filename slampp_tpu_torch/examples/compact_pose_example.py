"""Compact pose SLAM: keyframe pruning with marginalized relative-pose
priors (counterpart of ``examples/compact_pose_example.py``; reference
src/slam_compact_pose_example and the IJRR study src/slam_compact_pose_ijrr).

A reduced pose graph keeps every k-th pose and the loop-closure endpoints;
each chain of pruned poses becomes one synthetic SE(2) relative edge
between the flanking keyframes, with the marginal information of the
pruned segment.  The compact graph is checked against the full graph's
trajectory (ATE after alignment).

    python -m slampp_tpu_torch.examples.compact_pose_example [--poses 600] [--keep 3] [--device cpu]
"""

import numpy as np

from slampp_tpu_torch.eval.error_eval import ate_rmse as ate
from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.solvers.gauss_newton import GaussNewtonSolver


def np_abs_to_rel(p1, p2):
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = np.cos(p1[2]), np.sin(p1[2])
    a = p2[2] - p1[2]
    a = (a + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * de + s * dn, -s * de + c * dn, a])


def compact_system(full: GraphSystem, keep_every: int) -> GraphSystem:
    """The compact graph: every ``keep_every``-th pose and all loop-closure
    endpoints are kept; chains of pruned poses are marginalized into one
    synthetic relative-pose edge between the flanking keyframes."""
    order = list(full._vorder)
    keyframes = set(order[::keep_every]) | {order[-1]}
    # loop-closure endpoints must survive
    for tname in full.edge_type_names:
        for vids in full._edges[tname]["vids"]:
            i, j = vids
            if abs(order.index(j) - order.index(i)) > 1:
                keyframes.update(vids)

    compact = GraphSystem()
    for v in order:
        if v in keyframes:
            compact.add_vertex("pose2d", v, full.vertex_state(v))
    # odometry between consecutive keyframes: the chain composed from the
    # full graph's current estimate; for a chain of k unit-information
    # odometry steps the marginal information is info / k (exact for linear
    # chains)
    rec = full._edges["edge_pose2d"]
    kf_sorted = [v for v in order if v in keyframes]
    pos = {v: i for i, v in enumerate(order)}
    for a, b in zip(kf_sorted[:-1], kf_sorted[1:]):
        meas = np_abs_to_rel(full.vertex_state(a), full.vertex_state(b))
        k = pos[b] - pos[a]
        info = np.diag([400.0, 400.0, 2500.0]) / max(k, 1)
        compact.add_edge("edge_pose2d", (a, b), meas, info)
    # loop closures survive verbatim
    for e, vids in enumerate(rec["vids"]):
        i, j = vids
        if abs(pos[j] - pos[i]) > 1 and i in keyframes and j in keyframes:
            compact.add_edge("edge_pose2d", vids, rec["meas"][e], rec["sigma_inv"][e])
    return compact


def main(argv=None):
    def add(ap):
        ap.add_argument("--poses", type=int, default=600)
        ap.add_argument("--keep", type=int, default=3, help="keep every k-th pose")

    args = parse_args(argv, __doc__.splitlines()[0], add)
    text, gt = make_manhattan(n_poses=args.poses, loop_prob=0.1, seed=0)
    with g2o_file(text) as path:
        full = build_system(parse_file(path))

    gn = GaussNewtonSolver(full, device=args.device)
    gn.optimize(max_iterations=10)
    full_chi2 = gn.chi2()

    compact = compact_system(full, args.keep)
    gn2 = GaussNewtonSolver(compact, device=args.device)
    gn2.optimize(max_iterations=10)

    # compare keyframe trajectories (ATE after alignment)
    kf = sorted(compact.vertex_index.keys())
    t_full = np.stack([full.vertex_state(v)[:2] for v in kf])
    t_comp = np.stack([compact.vertex_state(v)[:2] for v in kf])
    err = ate(t_comp, t_full)
    print(f"full graph: {full.n_vertices} poses, {full.n_edges} edges, chi2={full_chi2:.2f}")
    print(f"compact:    {compact.n_vertices} poses, {compact.n_edges} edges, chi2={gn2.chi2():.2f}")
    print(f"keyframe ATE compact-vs-full: {err:.4f} m")
    return err


if __name__ == "__main__":
    main()
