"""Sim(3) landmark-parameterization study, ACRA'15 (counterpart of
``examples/ba_parameter_acra_example.py``; reference src/ba_parameter_acra,
the experiment behind the Sim3 edge classes, Sim3_Types.h:247-3598).

The same SfM problem is solved with landmarks parameterized as global XYZ,
global inverse depth and local-from-other inverse distance, and the
convergence (chi2 per LM iteration) is compared.

    python -m slampp_tpu_torch.examples.ba_parameter_acra_example [--device cpu]
"""

import numpy as np
import torch

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.geometry import sim3 as g_sim3
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io.parser import _np_quat_to_aa, _np_rot_to_quat
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def make_cams(n_cams):
    cams = []
    for c in range(n_cams):
        a = 2 * np.pi * c / n_cams
        center = np.array([6 * np.cos(a), 6 * np.sin(a), 1.0])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 0, 1], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_c2w = np.stack([x, y, z], axis=1)
        aa = _np_quat_to_aa(_np_rot_to_quat(R_c2w))
        tRs = np.concatenate([center, aa, [1.0]])
        cams.append(g_sim3.sim3_log(_t(tRs)).numpy())
    return cams


def build(param: str, seed=0, n_cams=6, n_pts=40):
    rng = np.random.default_rng(seed)
    intr = np.array([400.0, 400.0, 320.0, 240.0, 0.0])
    cams = make_cams(n_cams)
    system = GraphSystem()
    for c, log in enumerate(cams):
        system.add_vertex("camsim3", c, np.concatenate([log, intr]))
    pts = rng.normal(0, 1.5, (n_pts, 3))

    n_obs = 0
    for p in range(n_pts):
        pid = n_cams + p
        noisy = pts[p] + rng.normal(0, 0.1, 3)
        owner = int(rng.integers(0, n_cams))
        # a landmark needs >= 2 valid views to be constrained (otherwise H is
        # singular)
        views = []
        for c in rng.choice(n_cams, 3, replace=False):
            x_loc = g_sim3.world_to_local(_t(cams[int(c)]), _t(pts[p])).numpy()
            if x_loc[2] < 0.3:
                continue
            uv = g_sim3.project_p2c_xyz(_t(cams[int(c)]), _t(intr), _t(pts[p])).numpy()
            views.append((int(c), uv + rng.normal(0, 0.5, 2)))
        if len(views) < 2:
            continue
        if param == "xyz":
            system.add_vertex("xyz", pid, noisy)
        elif param == "invdepth":
            system.add_vertex("invdepth", pid, g_sim3.xyz_to_invdepth(_t(noisy)).numpy())
        else:  # invdist, landmark owned by `owner` (local frame)
            x_loc = g_sim3.world_to_local(_t(cams[owner]), _t(noisy)).numpy()
            d = np.linalg.norm(x_loc)
            system.add_vertex("invdist", pid,
                              np.concatenate([[1.0 / max(d, 1e-3)], x_loc / max(d, 1e-3)]))
        for c, uv in views:
            if param == "xyz":
                system.add_edge("edge_p2c_xyz_sim3_g", (pid, c), uv, np.eye(2))
            elif param == "invdepth":
                system.add_edge("edge_p2c_invdepth_sim3_g", (pid, c), uv, np.eye(2))
            else:
                if c == owner:
                    continue
                system.add_edge("edge_p2c_invdist_sim3_lo", (pid, owner, c), uv, np.eye(2))
            n_obs += 1
    return system, n_obs


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    print("ACRA'15 Sim(3) landmark parameterization study "
          "(chi2 per GN iteration, identical scene):\n")
    out = {}
    for param in ["xyz", "invdepth", "invdist"]:
        system, n_obs = build(param)
        # LM, as in the reference study (BA auto-upgrades to LM; the scale
        # gauge leaves one exact zero mode that undamped GN cannot factor)
        lm = LevenbergMarquardtSolver(system, device=args.device)
        chis = [lm.chi2()]
        for _ in range(6):
            lm.optimize(max_iterations=1, min_dx_norm=1e-9)
            chis.append(lm.chi2())
        tail = "  ".join(f"{c:9.2f}" for c in chis)
        print(f"{param:9s} ({n_obs:3d} obs): {tail}")
        out[param] = chis
    return out


if __name__ == "__main__":
    main()
