"""Compact pose SLAM, the IJRR'15 data-association study (counterpart of
``examples/compact_pose_ijrr_study.py``).

Reference: src/slam_compact_pose_ijrr/Main.cpp (4,222 LoC; Ila et al.,
IJRR).  The decision loop implemented here reproduces its behaviors:

  * per incoming odometry step, the DISTANCE PROBABILITY between the new
    pose and every stored pose is evaluated from the marginal relative-pose
    covariance Sigma_d (diagonal blocks + last column of the covariance —
    the same mpart_Diagonal | mpart_LastColumn policy the reference
    configures, include/slam_app/Main.h:1373; Gaussian CPD gate,
    Main.cpp:349-350);
  * candidates above the match probability threshold trigger "sensor
    matching" (here: lookup of the dataset's true loop closures);
  * a matched loop is accepted only if its INFORMATION GAIN
    0.5 * log det((Sigma_e + Sigma_d) / Sigma_e) clears the gain threshold
    (CDistancesUtils::f_Information_Gain, include/slam/Distances.h:445);
  * a pose with no sufficient expected gain is NOT kept: its odometry is
    COMPOUNDED into a cumulative edge (measurement composition with
    first-order covariance composition), exactly the keep-pose rule of
    Main.cpp:693-1011.

Outputs the compact-vs-full statistics the IJRR experiments tabulate:
kept poses, compounded steps, attempted matches, accepted/discarded loops,
final chi2, and keyframe ATE against the full graph.

Usage: python -m slampp_tpu_torch.examples.compact_pose_ijrr_study [--poses 400]
       [--gain-thresh 0.5] [--match-prob 0.1] [--device cpu]
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args


def se2_compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([
        a[0] + c * b[0] - s * b[1],
        a[1] + s * b[0] + c * b[1],
        (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi,
    ])


def se2_compose_cov(a, Sa, b, Sb):
    """First-order covariance of a (+) b (tail-to-tail compounding,
    Smith-Self-Cheeseman)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    J1 = np.array([
        [1.0, 0.0, -s * b[0] - c * b[1]],
        [0.0, 1.0, c * b[0] - s * b[1]],
        [0.0, 0.0, 1.0],
    ])
    J2 = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return J1 @ Sa @ J1.T + J2 @ Sb @ J2.T


def se2_rel(p1, p2):
    """p1^-1 (+) p2 and its Jacobians wrt p1, p2."""
    c, s = np.cos(p1[2]), np.sin(p1[2])
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    d = np.array([c * de + s * dn, -s * de + c * dn,
                  (p2[2] - p1[2] + np.pi) % (2 * np.pi) - np.pi])
    J1 = np.array([
        [-c, -s, -s * de + c * dn],
        [s, -c, -c * de - s * dn],
        [0.0, 0.0, -1.0],
    ])
    J2 = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return d, J1, J2


def gaussian_cpd_window(mean, var, thresh):
    """P(|x| < thresh) per coordinate for N(mean, var) — the v_GaussianCPD
    difference of Main.cpp:349; returns the min over coordinates."""
    from math import erf, sqrt

    p = []
    for m, v, t in zip(mean, var, thresh):
        sd = sqrt(max(v, 1e-12))
        cdf = lambda x: 0.5 * (1.0 + erf((x - m) / (sd * sqrt(2.0))))
        p.append(cdf(t) - cdf(-t))
    return min(p)


def info_gain(Sigma_e, Sigma_d):
    """0.5 log det((Sigma_e + Sigma_d)/Sigma_e) — Distances.h:445."""
    s, ld0 = np.linalg.slogdet(Sigma_e)
    s, ld1 = np.linalg.slogdet(Sigma_e + Sigma_d)
    return 0.5 * (ld1 - ld0)


def main(argv=None):
    def add(ap):
        ap.add_argument("--poses", type=int, default=400)
        ap.add_argument("--gain-thresh", type=float, default=3.0)
        ap.add_argument("--match-prob", type=float, default=0.1)
        ap.add_argument("--dist-window", type=float, default=4.0)
        ap.add_argument("--max-compound", type=int, default=6, help="force-keep a pose after this many compounded steps (odometry-length retention, the reference compact-edge-length limit)")

    args = parse_args(argv, __doc__.splitlines()[0], add)
    dev = args.device

    from slampp_tpu_torch.core import assembly
    from slampp_tpu_torch.eval.error_eval import ate_rmse as ate
    from slampp_tpu_torch.graph.system import GraphSystem
    from slampp_tpu_torch.io.datasets import make_manhattan
    from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
    from slampp_tpu_torch.solvers.gauss_newton import GaussNewtonSolver

    text, gt = make_manhattan(
        n_poses=args.poses, loop_prob=0.5, loop_separation=8, loop_radius=4.0,
        seed=0,
    )
    with g2o_file(text) as path:
        full = build_system(parse_file(path))

    # split the dataset into odometry chain + true loop closures
    rec = full._edges["edge_pose2d"]
    odo, loops = [], {}
    for e, (i, j) in enumerate(rec["vids"]):
        if abs(j - i) == 1:
            odo.append((i, j, np.asarray(rec["meas"][e]),
                        np.asarray(rec["sigma_inv"][e])))
        else:
            loops.setdefault(max(i, j), []).append(
                (min(i, j), np.asarray(rec["meas"][e]),
                 np.asarray(rec["sigma_inv"][e])))
    odo.sort(key=lambda t: t[0])

    compact = GraphSystem()
    compact.add_vertex("pose2d", 0, np.zeros(3))
    kept = [0]  # dataset pose id of each kept pose, in order
    n_compound = n_match_attempts = n_loops_kept = n_loops_discarded = 0
    pend_meas, pend_cov = None, None  # cumulative odometry edge
    n_pend_steps = 0

    def optimize(iters=3):
        gn = GaussNewtonSolver(compact, linear_solver="dense", device=dev)
        gn.optimize(iters, 0.001)

    def covariance():
        """Dense covariance of the compact system (small by construction —
        that is the point of compact pose SLAM)."""
        H, _, _ = assembly.assemble_dense(compact.snapshot(dev))
        return np.linalg.inv(H.cpu().numpy())

    sigma_e_default = None
    for (i, j, meas, info) in odo:
        Sigma_o = np.linalg.inv(info)
        sigma_e_default = Sigma_o
        n_pend_steps += 1
        if pend_meas is None:
            pend_meas, pend_cov = meas, Sigma_o
        else:
            pend_cov = se2_compose_cov(pend_meas, pend_cov, meas, Sigma_o)
            pend_meas = se2_compose(pend_meas, meas)

        # tentatively add the pose; evaluate distance probability and
        # information gain against EVERY kept pose (the reference evaluates
        # the distance to all stored poses, Main.cpp:900-1011)
        prev_id = kept[-1]
        new_state = se2_compose(compact.vertex_state(prev_id), pend_meas)
        compact.add_vertex("pose2d", j, new_state)
        compact.add_edge("edge_pose2d", (prev_id, j), pend_meas,
                         np.linalg.inv(pend_cov))
        optimize(1)
        Sig = covariance()
        offsets, _ = compact._layout()
        oj = offsets[j]
        true_loops = {c: (m, w) for c, m, w in loops.get(j, [])}
        f_max_gain = 0.0
        accepted = []
        for cand in kept[:-1]:  # exclude the immediate predecessor
            oc = offsets[cand]
            S = np.zeros((6, 6))
            S[:3, :3] = Sig[oc:oc + 3, oc:oc + 3]
            S[3:, 3:] = Sig[oj:oj + 3, oj:oj + 3]
            S[:3, 3:] = Sig[oc:oc + 3, oj:oj + 3]
            S[3:, :3] = S[:3, 3:].T
            d, J1, J2 = se2_rel(compact.vertex_state(cand),
                                compact.vertex_state(j))
            Jd = np.hstack([J1, J2])
            Sigma_d = Jd @ S @ Jd.T
            prob = gaussian_cpd_window(
                d[:2], np.diag(Sigma_d)[:2],
                [args.dist_window, args.dist_window])
            if prob < args.match_prob:
                continue
            Sigma_e = pend_cov if cand not in true_loops else np.linalg.inv(
                true_loops[cand][1])
            g = info_gain(Sigma_e, Sigma_d)
            f_max_gain = max(f_max_gain, g)
            n_match_attempts += 1  # sensor matching attempted
            if cand in true_loops:
                if g >= args.gain_thresh:
                    accepted.append((cand,) + true_loops[cand])
                else:
                    n_loops_discarded += 1
        keep = (f_max_gain >= args.gain_thresh or bool(accepted)
                or j == odo[-1][1]
                or n_pend_steps >= args.max_compound)
        if keep:
            for (cand, lmeas, linfo) in accepted:
                compact.add_edge("edge_pose2d", (cand, j), lmeas, linfo)
                n_loops_kept += 1
            kept.append(j)
            pend_meas, pend_cov = None, None
            n_pend_steps = 0
            optimize(3 if accepted else 1)
        else:
            # roll back the tentative pose: rebuild without it
            state = {v: compact.vertex_state(v) for v in kept}
            edges = [
                (tuple(v), m, w)
                for tname in compact.edge_type_names
                for v, m, w in zip(
                    compact._edges[tname]["vids"],
                    compact._edges[tname]["meas"],
                    compact._edges[tname]["sigma_inv"])
                if j not in v
            ]
            compact = GraphSystem()
            for v in kept:
                compact.add_vertex("pose2d", v, state[v])
            for v, m, w in edges:
                compact.add_edge("edge_pose2d", v, m, w)
            n_compound += 1

    optimize(8)

    # full graph baseline
    gn_full = GaussNewtonSolver(full, device=dev)
    gn_full.optimize(10, 0.001)
    t_full = np.stack([full.vertex_state(v)[:2] for v in kept])
    t_comp = np.stack([compact.vertex_state(v)[:2] for v in kept])
    err = ate(t_comp, t_full)

    gn_c = GaussNewtonSolver(compact, device=dev)
    print(f"full:    {full.n_vertices} poses, {full.n_edges} edges, "
          f"chi2={gn_full.chi2():.2f}")
    print(f"compact: {compact.n_vertices} poses, {compact.n_edges} edges, "
          f"chi2={gn_c.chi2():.2f}")
    print(f"compounded steps: {n_compound}  match attempts: {n_match_attempts}")
    print(f"loops kept: {n_loops_kept}  loops discarded: {n_loops_discarded}")
    print(f"keyframe ATE compact-vs-full: {err:.4f} m")
    return {"compact": compact.n_vertices, "full": full.n_vertices, "loops_kept": n_loops_kept,
            "ate": err}


if __name__ == "__main__":
    main()
