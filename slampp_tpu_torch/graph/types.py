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

The port has no autodiff path (the JAX package used ``jax.jacfwd``), so an
edge type must bring its analytic ``jacobian_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
