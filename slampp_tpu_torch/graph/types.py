"""Vertex/edge *type* registry (counterpart of ``slampp_tpu/graph/types.py``).

The registry is the JAX package's, holding torch callables that are batched
over a leading axis instead of written per item for ``vmap``:

* ``VertexType.retract(states (B, state_dim), delta (B, dim)) -> (B, state_dim)``
* ``EdgeType.error_fn(states tuple of (E, state_dim_k), meas (E, meas_dim)) -> (E, res_dim)``
* ``EdgeType.jacobian_fn(states, meas) -> (r (E, res_dim), (J_0, ..., J_{arity-1}))``
  with ``J_k`` of shape (E, res_dim, dim_k): d error(retract(x_k, d_k)) / d d_k
  at d_k = 0.

Conventions as in the JAX package: ``error_fn`` is the residual
``z (-) h(x)``; the Gauss-Newton system is ``H dx = -g`` with
``H = J^T W J``, ``g = J^T W r``.

* ``EdgeType.robust_weight_fn(r (E, res_dim), sigma_inv (E, res_dim, res_dim)) -> (E,)``
  the IRLS weight that multiplies ``sigma_inv`` in assembly (models/robust.py).
* ``EdgeType.fused_terms(ea, states, order) -> (H_pose, g_pose, D_lm, g_lm, B, chi2)``
  and ``EdgeType.fused_chi2(ea, states) -> chi2``: a pose-landmark edge
  type's fused forms (a hand-written kernel on the card,
  ops/sim3_kernels.py), which the sparse Schur engine's edge terms,
  ``assembly.edge_chi2`` and ``assembly.max_edge_hessian_diag`` take in
  place of ``jacobian_fn`` / ``error_fn`` for CUDA operands
  (``assembly.takes_fused``); rows of the terms in ``order`` ((E,) int64,
  or None for the edge order).

The JAX package differentiated each ``error_fn`` through the retractions
with ``jax.jacfwd`` (``slampp_tpu/core/assembly.py:32-48``).  Here every
edge type brings its ``jacobian_fn``: the SE(2), SE(3), BA, ROCV and
Spheron types and the Sim(3) G reprojection edges (the full-width Sim(3)
path) have analytic ones; the other Sim(3) edges (LS, LO, the pose edges
and the angle-error variants) take :func:`autodiff_jacobian`, the same
construction as the JAX package's on ``torch.func``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class VertexType:
    name: str
    dim: int
    retract: Callable
    is_landmark: bool = False
    _state_dim: Optional[int] = None
    local_diff: Optional[Callable] = None

    @property
    def state_dim(self) -> int:
        return self._state_dim if self._state_dim is not None else self.dim


@dataclasses.dataclass(frozen=True)
class EdgeType:
    name: str
    vertex_types: tuple  # tuple[str, ...] of VertexType names, slot order
    res_dim: int
    meas_dim: int
    error_fn: Callable
    jacobian_fn: Optional[Callable] = None
    robust_weight_fn: Optional[Callable] = None
    fused_terms: Optional[Callable] = None
    fused_chi2: Optional[Callable] = None

    @property
    def arity(self) -> int:
        return len(self.vertex_types)


TYPE_REGISTRY: dict = {"vertex": {}, "edge": {}}


def register_vertex_type(vt: VertexType) -> VertexType:
    TYPE_REGISTRY["vertex"][vt.name] = vt
    return vt


def register_edge_type(et: EdgeType) -> EdgeType:
    if et.jacobian_fn is None:
        raise ValueError(
            f"edge type {et.name!r}: the port needs an analytic jacobian_fn "
            "(it has no autodiff path)"
        )
    TYPE_REGISTRY["edge"][et.name] = et
    return et


def get_vertex_type(name: str) -> VertexType:
    return TYPE_REGISTRY["vertex"][name]


def get_edge_type(name: str) -> EdgeType:
    return TYPE_REGISTRY["edge"][name]


def autodiff_jacobian(error_fn: Callable, vertex_types: tuple) -> Callable:
    """A ``jacobian_fn`` by forward-mode autodiff: per edge, ``jacfwd`` of
    ``error_fn(retract(x_k, d_k), ...)`` at d = 0, vmapped over the edges
    (``torch.func``; the JAX package's ``jax.jacfwd`` of the same
    function).  ``error_fn`` and the retractions must accept unbatched
    (state_dim,) inputs and branch only through ``torch.where``."""

    def jacobian_fn(states, meas):
        vts = tuple(get_vertex_type(n) for n in vertex_types)

        def one(xs, z):
            def err(*deltas):
                return error_fn(tuple(vt.retract(x, d) for vt, x, d in zip(vts, xs, deltas)), z)

            zeros = tuple(x.new_zeros(vt.dim) for vt, x in zip(vts, xs))
            return torch.func.jacfwd(err, argnums=tuple(range(len(vts))))(*zeros)

        return error_fn(states, meas), torch.func.vmap(one)(tuple(states), meas)

    return jacobian_fn
