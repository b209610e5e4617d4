"""Route ``sim3_invdist_lm``: Levenberg-Marquardt Sim(3) bundle adjustment
with local inverse-distance landmarks through the generic LM loop
(``solvers/lm.py``) on the sparse Schur engine
(``linear/schur_sparse.py``: ternary edges, couplings summed per
(landmark, camera), the reduced camera system on the v3 engine).

Set-up (counted in ``setup_s``): generate the scene from the seed (the
configuration's ``generator``, a module of ``portbench/traffic`` that
returns the arrays ``cams``, ``points``, ``obs_cam``, ``obs_pt``, ``uv``
and ``info``), build the cam / xyz graph from them
(``apps/sim3.ba_system_from_arrays``), embed it in Sim(3) with
inverse-distance landmarks (``models/sim3.embed_ba_system_sim3_invdist``),
the solver with ``use_schur`` (which has to resolve to the sparse Schur
engine), its host symbolic phase, and one device snapshot of the graph
kept as the start.  One solve is ``optimize_graph(start, max_iterations,
min_dx_norm)`` from that same start; its iterations are the steps it
reports, accepted or rejected.  The solve key ``mixed_precision`` (absent
in the cell: the engine's default, a float32 camera factor with one
float64 refinement) sets the factor's precision, for diagnostic readings
(``portbench/readings.py --solve``).  The set-up's phases and the plan's counts
(ternary edges, coupling rows, kept pairs, head blocks) go to standard
error as one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from portbench import traffic


class Route:
    def __init__(self, config: dict, solve: dict, seed: int, device):
        from slampp_tpu_torch.apps.sim3 import ba_system_from_arrays
        from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3_invdist
        from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver

        phases = {}
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            t1 = time.perf_counter()
            phases[name] = t1 - t0
            t0 = t1

        self.arrays = a = traffic.generate(config["generator"], seed)
        lap("generate_s")
        ba_system = ba_system_from_arrays(a["cams"], a["points"], a["obs_cam"], a["obs_pt"],
                                          a["uv"], a["info"])
        lap("build_s")
        system = embed_ba_system_sim3_invdist(ba_system)
        del ba_system
        lap("embed_s")
        self.max_iterations = int(solve["max_iterations"])
        self.min_dx_norm = float(solve["min_dx_norm"])
        self.lm = LevenbergMarquardtSolver(system, use_schur=True, tau=float(solve["tau"]),
                                           device=device)
        engine = self.lm._resolve_engine()
        if engine != "schur_sparse":
            raise ValueError(f"the route needs the sparse Schur engine, the solver resolved to "
                             f"{engine!r}")
        ss = self.lm._ss_solver()
        ss.mixed_precision = bool(solve.get("mixed_precision", ss.mixed_precision))
        lap("symbolic_s")
        self.start = system.snapshot(device)
        lap("snapshot_s")
        p, v3p = ss.plan, ss.v3_plan
        info = {"route": "sim3_invdist_lm", "setup_phases": phases, "n_obs": system.n_edges,
                "n_landmarks": p.n_l, "n_ternary": p.n_ternary, "n_rows": p.n_rows,
                "n_pairs_kept": p.n_pairs, "n_heads": p.n_heads,
                "v3_plan": {"K": v3p.K, "M": v3p.M, "S": v3p.S, "SB": v3p.SB, "Ms": v3p.Ms,
                            "ch_ok": v3p.ch_ok}}
        if self.start.device.type == "cuda":  # the Cholesky forms of the f32 factor
            from slampp_tpu_torch.ops import dense_kernels as dk

            info["chol_forms"] = {f"({k}, {m})": dk.chol_form(torch.float32, k, m, device)
                                  for k, m in ((v3p.K, v3p.M), (1, v3p.Ms))}
        print(json.dumps(info), file=sys.stderr, flush=True)

    def solve(self):
        """One timed solve: (its raw outputs, the LM iterations it ran)."""
        graph, _, iterations = self.lm.optimize_graph(self.start, self.max_iterations,
                                                      self.min_dx_norm)
        return graph.states, iterations

    def inputs(self) -> dict:
        """What the reference is handed: the generator's arrays."""
        return self.arrays

    def output(self, raw) -> dict:
        return {"cams": raw["camsim3"], "points": raw["invdist"]}

    def release(self) -> None:
        self.lm = self.start = None
