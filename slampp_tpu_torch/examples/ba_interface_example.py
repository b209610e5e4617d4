"""BA facade demo (counterpart of ``examples/ba_interface_example.py``;
reference src/ba_interface_example/Main.cpp:83-146): bundle adjustment
through the BAOptimizer facade.
"""

import numpy as np

from slampp_tpu_torch.apps.ba_optimizer import BAOptimizer
from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.io.datasets import make_ba_scene
from slampp_tpu_torch.io.parser import g2o_file, parse_file


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    # synthesize a scene, then feed it through the facade API
    text, (gt_cams, gt_pts) = make_ba_scene(n_cams=8, n_points=80, seed=0)
    with g2o_file(text) as path:
        recs = parse_file(path)

    opt = BAOptimizer(use_schur=True, verbose=True, device=args.device)
    for r in recs:
        if r.kind == "vertex_cam":
            opt.add_camera(r.ids[0], r.values[:6], r.values[6:11])
        elif r.kind == "vertex_xyz":
            opt.add_point(r.ids[0], r.values)
        elif r.kind == "edge_p2c":
            opt.add_observation(r.ids[0], r.ids[1], r.values, r.info)

    print("initial chi2:", opt.chi2())
    opt.optimize(max_iterations=10, min_dx_norm=1e-6)
    print("final chi2:", opt.chi2())
    print("camera 0 pose:", np.round(opt.get_camera(0), 4))

    marg = opt.marginals()
    some_point = max(opt.system.vertex_index)
    print("point covariance diag:", np.diag(marg.block_diag[some_point]))
    return opt


if __name__ == "__main__":
    main()
