"""Online (incremental) library-usage demo (counterpart of
``examples/online_example.py``; reference
src/slam_online_example/Main.cpp:39-79).

Streams edges through IncrementalSolver.incremental_step, the analog of
calling solver.Incremental_Step per added edge.
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.models import se2
from slampp_tpu_torch.solvers import IncrementalSolver


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    system = GraphSystem()
    solver = IncrementalSolver(system, solve_period=1, max_iterations=5, verbose=True,
                               device=args.device)
    info = np.linalg.inv(np.diag([0.02, 0.02, 0.01]))

    stream = [
        ((0, 1), [1.0, 0.0, np.pi / 2]),
        ((1, 2), [1.05, 0.02, np.pi / 2]),
        ((2, 3), [0.97, -0.01, np.pi / 2]),
        ((3, 4), [1.01, 0.01, np.pi / 2]),
        ((0, 4), [0.0, 0.0, 0.0]),  # loop closure triggers a solve
    ]
    for vids, m in stream:
        system.add_edge("edge_pose2d", vids, np.array(m), info, se2.POSE_POSE_INITIALIZERS)
        solved = solver.incremental_step(vids)
        print(f"edge {vids}: solved={solved}")

    solver.optimize(max_iterations=5)
    print("final chi2:", solver.chi2())
    return solver.chi2()


if __name__ == "__main__":
    main()
