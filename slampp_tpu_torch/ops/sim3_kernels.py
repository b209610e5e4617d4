"""The Sim(3) global reprojection edge (``edge_p2c_xyz_sim3_g``: a world
XYZ point seen by a ``camsim3`` camera) in two fused forms on the card: its
blocks of the sparse Schur engine's linear system with chi2
(``sim3_g_terms``, under ``ss.edge_terms``; the LM loop's initial damping
scale is the diagonal maximum of its Hpp and Dl) and its chi2 alone
(``sim3_g_chi2``, under ``lm.chi2``).

The JAX package computed them as XLA-fused elementwise code (``_g_jacobians``
in ``slampp_tpu/models/sim3.py``, ``edge_chi2`` in
``slampp_tpu/core/assembly.py``); no Pallas kernel.  The call sites take
these forms for CUDA operands only (``core/assembly.takes_fused``): CPU
operands keep the generic path (``models/sim3._g_jacobians`` with the
einsums of ``linear/schur_sparse.pl_terms``, ``assembly.edge_chi2`` and
``assembly.max_edge_hessian_diag`` on ``jacobian_fn`` / ``error_fn``),
which is the kernel's reference.  Each function here launches the
hand-written kernel (``csrc/sim3_kernels.cu``, built at first use into the
kernels' library by ``ops/_cuda.py``) or raises: on a build failure, a
refused launch, or operands the kernel does not take (other than float64
points, cameras, measurements and information, int64 indices and a bool
mask, on one card, contiguous; ``meas`` and ``sigma_inv`` 16-byte aligned,
the kernel reads them as ``double2``).  The kernel reads the indices as the
graph snapshot and the engine's plan made them, in range: checking them on
the card would cost a host read a call.

Operands: ``points`` (n_l, 3) and ``cams`` (n_c, 12: the sim(3) log, then
fx fy cx cy k) are the graph's ``xyz`` and ``camsim3`` states;
``local_idx`` (E, 2) the (point, camera) index of each edge, ``meas``
(E, 2), ``sigma_inv`` (E, 2, 2) and ``valid`` (E,) its ``EdgeArrays``.

``launches`` counts the kernel launches per form; ``reset_launches``
clears it.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.ops import _cuda

launches = {"sim3_g_terms": 0, "sim3_g_chi2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _spec(points, cams, local_idx, meas, sigma_inv, valid, order=None):
    """(the number of edges, the kernel's operands as
    ``_cuda.check_operands`` rows)."""
    m = local_idx.shape[0] if local_idx.dim() == 2 else -1
    f64, i64 = torch.float64, torch.int64
    # (operand, shape, dtype, alignment in bytes the kernel's loads need)
    ops = [(points, (points.shape[0], 3), f64, 8), (cams, (cams.shape[0], 12), f64, 8),
           (local_idx, (m, 2), i64, 8), (meas, (m, 2), f64, 16),
           (sigma_inv, (m, 2, 2), f64, 16), (valid, (m,), torch.bool, 1)]
    if order is not None:
        ops.append((order, (m,), i64, 8))
    return m, ops


def sim3_g_terms(points, cams, local_idx, meas, sigma_inv, valid, order=None):
    """(Hpp (E, 7, 7), gp (E, 7), Dl (E, 3, 3), gl (E, 3), B (E, 7, 3),
    chi2): with W = ``sigma_inv``, Hpp = Jc^T W Jc, gp = (W Jc)^T r,
    Dl = Jp^T W Jp, gl = (W Jp)^T r, B = Jc^T W Jp, row i of each the edge
    ``order[i]`` (``order`` (E,) int64, or None for the edge order);
    chi2 = sum of r^T W r over the ``valid`` edges (the terms are not
    masked), a 0-d tensor.  float64 and contiguous outputs."""
    ops = (points, cams, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(*ops, order)
    _cuda.check_operands("sim3_g_terms", spec)
    new = points.new_empty
    outs = (new((m, 7, 7)), new((m, 7)), new((m, 3, 3)), new((m, 3)), new((m, 7, 3)), new(()))
    _cuda.launch_reduction("sim3_g_terms", "slampp_sim3_g_workspace", "slampp_sim3_g_terms_f64",
                           points.device, m, (*ops, order), outs)
    launches["sim3_g_terms"] += 1
    return outs


def sim3_g_chi2(points, cams, local_idx, meas, sigma_inv, valid):
    """sum of r^T W r over the valid edges (operands as
    :func:`sim3_g_terms`), a 0-d tensor on the operands' device."""
    ops = (points, cams, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(*ops)
    _cuda.check_operands("sim3_g_chi2", spec)
    chi2 = points.new_empty(())
    _cuda.launch_reduction("sim3_g_chi2", "slampp_sim3_g_workspace", "slampp_sim3_g_chi2_f64",
                           points.device, m, ops, (chi2,))
    launches["sim3_g_chi2"] += 1
    return chi2
