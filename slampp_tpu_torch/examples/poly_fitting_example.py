"""Non-SLAM NLS demo: cubic polynomial fitting with a custom vertex and
edge type (counterpart of ``examples/poly_fitting_example.py``; reference
src/poly_fitting_example/Main.cpp:145-188): the framework is a general
sparse least-squares engine, not just SLAM.  The port's edge types bring
their Jacobian: here the closed form -[1, x, x^2, x^3].
"""

import numpy as np
import torch

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.graph.types import (
    EdgeType,
    VertexType,
    register_edge_type,
    register_vertex_type,
)
from slampp_tpu_torch.solvers import GaussNewtonSolver


def _powers(x):
    return torch.stack([torch.ones_like(x), x, x**2, x**3], -1)  # (E, 4)


def _error(xs, z):
    """(E, 1): y - c(x), batched over the samples."""
    return (z[:, 1] - (xs[0] * _powers(z[:, 0])).sum(-1))[:, None]


def _jacobian(xs, z):
    return _error(xs, z), (-_powers(z[:, 0])[:, None, :],)


# custom vertex: the 4 cubic coefficients; custom edge: one (x, y) sample
COEFFS = register_vertex_type(VertexType(name="poly_coeffs", dim=4, retract=lambda c, d: c + d))
SAMPLE = register_edge_type(EdgeType(name="poly_sample", vertex_types=("poly_coeffs",), res_dim=1,
                                     meas_dim=2, error_fn=_error, jacobian_fn=_jacobian))


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    rng = np.random.default_rng(0)
    true_c = np.array([0.5, -1.2, 0.3, 0.05])
    xs = np.linspace(-3, 3, 50)
    ys = np.polyval(true_c[::-1], xs) + rng.normal(0, 0.05, len(xs))

    system = GraphSystem()
    system.add_vertex("poly_coeffs", 0, np.zeros(4))
    for x, y in zip(xs, ys):
        system.add_edge("poly_sample", (0,), np.array([x, y]), np.eye(1) / 0.05**2)

    solver = GaussNewtonSolver(system, linear_solver="dense", device=args.device)
    solver.optimize(max_iterations=10, min_dx_norm=1e-12)
    est = system.vertex_state(0)
    print("true coeffs:", true_c)
    print("est coeffs: ", np.round(est, 4))
    print("chi2:", solver.chi2(), " dof:", system.chi2_dof())
    return est, solver.chi2(), system.chi2_dof()


if __name__ == "__main__":
    main()
