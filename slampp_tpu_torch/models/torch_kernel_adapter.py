"""The NumPy-kernel interface of ``models/np_kernels.py`` for any registered
type, through its torch callables (counterpart of
``slampp_tpu/models/jax_kernel_adapter.py``).

FastL (solvers/fastl.py) keeps its live system on the host and wants
batched NumPy residual / Jacobian / retract kernels.  The SE(2) family has
hand-written NumPy copies; every other type (SE(3), ...) gets these
adapters, which call the type's registered ``jacobian_fn``, ``retract`` and
``local_diff`` on CPU float64 tensors made from the NumPy inputs: the same
linearization the batch solvers assemble, at the cost of a few hundred
small torch operations per batch.  FastL's per-step work is host work by
design (the reference's FastL is a CPU solver), so this stays on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def make_edge_lin(name: str):
    """``NP_EDGE_LIN``-compatible: (slot_states, meas) -> (r, jacs)."""
    et = get_edge_type(name)

    def call(slot_states, meas):
        r, jacs = et.jacobian_fn(tuple(_t(s) for s in slot_states), _t(meas))
        return r.numpy(), tuple(j.numpy() for j in jacs)

    call.arity = et.arity
    return call


def make_retract(tname: str):
    """``NP_RETRACT``-compatible: (states, delta) -> states."""
    vt = get_vertex_type(tname)

    def call(states, delta):
        return vt.retract(_t(states), _t(delta)).numpy()

    return call


def make_local_diff(tname: str):
    """``NP_LOCAL_DIFF``-compatible: (cur, ref) -> tangent difference; a type
    without ``local_diff`` takes the leading ``dim`` entries of cur - ref."""
    vt = get_vertex_type(tname)

    def call(cur, ref):
        if vt.local_diff is not None:
            return vt.local_diff(_t(cur), _t(ref)).numpy()
        return (np.asarray(cur) - np.asarray(ref))[:, : vt.dim]

    return call
