"""Batch library-usage demo (counterpart of ``examples/simple_example.py``;
reference src/slam_simple_example/Main.cpp:56-85).

Builds a tiny SE(2) pose graph through the library API, runs batch
Gauss-Newton, prints chi2 and the poses.
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.models import se2
from slampp_tpu_torch.solvers import GaussNewtonSolver


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    system = GraphSystem()
    info = np.linalg.inv(np.diag([0.02, 0.02, 0.01]))  # information matrix

    # a square loop with odometry + one loop closure
    meas = [
        (0, 1, [1.0, 0.0, np.pi / 2]),
        (1, 2, [1.05, 0.02, np.pi / 2]),
        (2, 3, [0.97, -0.01, np.pi / 2]),
        (3, 4, [1.01, 0.01, np.pi / 2]),
    ]
    for i, j, m in meas:
        system.add_edge("edge_pose2d", (i, j), np.array(m), info, se2.POSE_POSE_INITIALIZERS)
    # loop closure: pose 4 should coincide with pose 0
    system.add_edge("edge_pose2d", (0, 4), np.array([0.0, 0.0, 0.0]), info)

    solver = GaussNewtonSolver(system, verbose=True, device=args.device)
    print("initial chi2:", solver.chi2())
    solver.optimize(max_iterations=10, min_dx_norm=1e-9)
    print("final chi2:", solver.chi2())
    for v in range(5):
        print(f"pose {v}:", np.round(system.vertex_state(v), 4))
    return solver.chi2()


if __name__ == "__main__":
    main()
