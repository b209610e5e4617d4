"""BA optimizer facade, a stable embedding API (counterpart of
``slampp_tpu/apps/ba_optimizer.py``).

Capability parity with the reference's ``ba_interface_example``
(src/ba_interface_example/Main.cpp:83-146): the ``CBAOptimizer`` pimpl facade
that hides the solver machinery behind add_camera / add_point /
add_observation / optimize / get_* calls for client code.  The solvers run
on ``device``: the card by default, an error without one.
"""

from __future__ import annotations

import numpy as np
import torch


class BAOptimizer:
    """Facade over GraphSystem + LM + Schur for bundle adjustment."""

    def __init__(self, use_schur: bool = True, verbose: bool = False, device="cuda"):
        from slampp_tpu_torch.graph.system import GraphSystem
        from slampp_tpu_torch.utils.device import require_device

        self.device = torch.device(device)
        require_device(self.device, "BAOptimizer")
        self.system = GraphSystem()
        self.use_schur = use_schur
        self.verbose = verbose
        self._solver = None

    # --- building -----------------------------------------------------------
    def add_camera(self, cam_id: int, pose_w2c, intrinsics, const: bool = False):
        """pose_w2c: (t(3), axis-angle(3)) world-to-camera; intrinsics:
        (fx, fy, cx, cy, k)."""
        state = np.concatenate([np.asarray(pose_w2c, float), np.asarray(intrinsics, float)])
        self.system.add_vertex("cam", cam_id, state, const=const)

    def add_point(self, point_id: int, xyz, const: bool = False):
        self.system.add_vertex("xyz", point_id, np.asarray(xyz, float), const=const)

    def add_observation(self, point_id: int, cam_id: int, uv, info=None):
        info = np.eye(2) if info is None else np.asarray(info, float)
        self.system.add_edge("edge_p2c", (point_id, cam_id), np.asarray(uv, float), info)

    # --- solving ------------------------------------------------------------
    def _lm(self, verbose: bool = False):
        from slampp_tpu_torch.solvers import LevenbergMarquardtSolver

        return LevenbergMarquardtSolver(self.system, use_schur=self.use_schur, verbose=verbose,
                                        device=self.device)

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        self._solver = self._lm(self.verbose)
        return self._solver.optimize(max_iterations, min_dx_norm)

    def chi2(self) -> float:
        if self._solver is None:
            self._solver = self._lm()
        return self._solver.chi2()

    # --- accessors ----------------------------------------------------------
    def get_camera(self, cam_id: int) -> np.ndarray:
        return self.system.vertex_state(cam_id)[:6]

    def get_point(self, point_id: int) -> np.ndarray:
        return self.system.vertex_state(point_id)

    def marginals(self):
        from slampp_tpu_torch.marginals import MarginalCovariance

        m = MarginalCovariance(self.system, device=self.device)
        m.update_batch()
        return m

    def save_solution(self, path: str) -> None:
        with open(path, "w") as f:
            for vid in sorted(self.system.vertex_index):
                st = self.system.vertex_state(vid)
                f.write(" ".join("%.10f" % x for x in st) + "\n")
