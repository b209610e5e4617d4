"""Incremental BA with consistency markers and covariance experiments
(counterpart of ``examples/incremental_ba_3dv_example.py``; reference
src/incremental_ba_3dv, the 3DV'17 paper driver).

A BA dataset streams in camera by camera, with CONSISTENCY_MARKER records
delimiting optimizable states; at each marker the system is optimized and
the camera marginal covariances are recovered through the Schur complement
(BAMarginals.h), tracking how uncertainty contracts as observations
accumulate.

    python -m slampp_tpu_torch.examples.incremental_ba_3dv_example [--cams 10] [--points 120] [--device cpu]
"""

import numpy as np

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io.datasets import make_ba_scene_incremental
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.linear.schur import build_schur_plan
from slampp_tpu_torch.marginals.ba_marginals import schur_marginals
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver


def main(argv=None):
    def add(ap):
        ap.add_argument("--cams", type=int, default=10)
        ap.add_argument("--points", type=int, default=120)

    args = parse_args(argv, __doc__.splitlines()[0], add)
    dev = args.device
    text, gt = make_ba_scene_incremental(n_cams=args.cams, n_points=args.points, seed=0)
    with g2o_file(text) as path:
        records = parse_file(path)

    system = GraphSystem()
    marker_no = 0
    traces = []

    def on_marker(s):
        nonlocal marker_no
        marker_no += 1
        lm = LevenbergMarquardtSolver(s, use_schur=True, pad=True, device=dev)
        lm.optimize(5, 0.01)
        # camera marginals through the Schur complement (3DV'17 path)
        H, _, _ = assembly.assemble_dense(s.snapshot(dev))
        plan = build_schur_plan(s).to(dev)
        Sigma_cc = schur_marginals(H, plan, alpha=1e-6)[0].cpu().numpy()
        cam_trace = float(np.trace(Sigma_cc)) / max(Sigma_cc.shape[0], 1)
        traces.append(cam_trace)
        print(
            f"marker #{marker_no}: {s.n_vertices} vertices, "
            f"chi2={lm.chi2():.2f}, mean camera variance={cam_trace:.3e}"
        )

    build_system(records, system=system, on_marker=on_marker)
    print(f"\n{marker_no} consistency markers processed")
    if len(traces) >= 3:
        print(
            "uncertainty contraction (first -> last marker): "
            f"{traces[0]:.3e} -> {traces[-1]:.3e}"
        )
    return traces


if __name__ == "__main__":
    main()
