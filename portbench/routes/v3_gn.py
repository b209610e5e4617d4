"""Route ``v3_gn``: Gauss-Newton on a pose graph through the v3 engine's
``PartitionedSolver.optimize_fused``, the graph handed to the program as
g2o text.

Set-up (counted in ``setup_s``): generate the text from the seed (the
configuration's ``generator``, a module of ``portbench/traffic`` that
returns g2o text), write it to a temporary file under TMPDIR, parse it
and build the system, the host symbolic phase, the device snapshot.  One solve is
``optimize_fused(graph, n_iters)`` from the same start states, ended by the
host read of the chi2 it returns: the latency of re-optimizing the map.
"""

from __future__ import annotations

import os
import tempfile

import torch

from portbench import traffic


class Route:
    def __init__(self, config: dict, solve: dict, seed: int, device):
        from slampp_tpu_torch.io.parser import build_system, parse_file
        from slampp_tpu_torch.linear.partitioned import PartitionedSolver

        self.text = traffic.generate(config["generator"], seed)
        fd, path = tempfile.mkstemp(suffix=".g2o")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(self.text)
            self.system = build_system(parse_file(path))
        finally:
            os.unlink(path)
        self.n_iters = int(solve["n_iters"])
        self.solver = PartitionedSolver(
            self.system, target=int(solve["target"]),
            mixed_precision=bool(solve["mixed_precision"]),
            refine_iters=int(solve["refine_iters"]), device=device)
        self.solver.symbolic()
        self.graph = self.system.snapshot(device)
        # the program's pose rows in ascending vertex id
        ids = sorted(self.system.vertex_index)
        self.perm = torch.as_tensor([self.system.vertex_index[v][1] for v in ids],
                                    device=self.graph.device)

    def solve(self):
        """One timed solve: (its raw outputs, the GN iterations it ran)."""
        states, _, _, chi2 = self.solver.optimize_fused(self.graph, n_iters=self.n_iters)
        return (states, float(chi2)), self.n_iters

    def inputs(self) -> dict:
        """What the reference is handed: the text both sides read."""
        return {"text": self.text}

    def output(self, raw) -> dict:
        """A solve's outputs as the reference's ``compare`` takes them."""
        states, chi2 = raw
        (x,) = states.values()
        return {"states": x[self.perm], "chi2": chi2}

    def release(self) -> None:
        self.solver = self.graph = self.system = None
