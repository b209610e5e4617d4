"""Route ``ba_lm``: Levenberg-Marquardt bundle adjustment through
``BigBASolver`` (the observation-driven Schur engine), built from raw
observation arrays with ``BigBASolver.from_arrays``.

Set-up (counted in ``setup_s``): generate the scene from the seed (the
configuration's ``generator``, a module of ``portbench/traffic`` that
returns the arrays ``cams``, ``points``, ``obs_cam``, ``obs_pt``, ``uv``
and ``info``), the program's host symbolic phase and device pair table.
One solve restores the start cameras and points (device tensors kept from
set-up) and runs ``optimize(max_iterations, min_dx_norm)``, whose loop
reads each step's norm, gain and chi2 back to the host; every step it
takes, accepted or rejected, is one LM iteration.
"""

from __future__ import annotations

from portbench import traffic


class Route:
    def __init__(self, config: dict, solve: dict, seed: int, device):
        from slampp_tpu_torch.linear.ba_schur import BigBASolver

        self.arrays = a = traffic.generate(config["generator"], seed)
        self.max_iterations = int(solve["max_iterations"])
        self.min_dx_norm = float(solve["min_dx_norm"])
        self.solver = BigBASolver.from_arrays(
            a["cams"], a["points"], a["obs_cam"], a["obs_pt"], a["uv"], a["info"],
            tau=float(solve["tau"]), sc_f64=bool(solve["sc_f64"]),
            pair_f32=bool(solve["pair_f32"]), device=device)
        self.start = (self.solver._cams, self.solver._lms)
        self.steps = 0
        step = self.solver.step

        def counted(*args):
            self.steps += 1
            return step(*args)

        self.solver.step = counted

    def solve(self):
        """One timed solve: (its raw outputs, the LM iterations it ran)."""
        self.solver._cams, self.solver._lms = self.start
        self.steps = 0
        self.solver.optimize(max_iterations=self.max_iterations, min_dx_norm=self.min_dx_norm)
        return (self.solver._cams, self.solver._lms), self.steps

    def inputs(self) -> dict:
        """What the reference is handed: the generator's arrays."""
        return self.arrays

    def output(self, raw) -> dict:
        cams, points = raw
        return {"cams": cams, "points": points}

    def release(self) -> None:
        self.solver = self.start = None
