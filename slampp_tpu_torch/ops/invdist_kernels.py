"""The Sim(3) inverse-distance reprojection edges (``edge_p2c_invdist_sim3_lo``:
a landmark local to its owner camera, seen by another camera;
``edge_p2c_invdist_sim3_ls``: seen by its owner) in two fused forms each on
the card: their terms of the sparse Schur engine's linear system with chi2
(``invdist_lo_terms`` / ``invdist_ls_terms``, under ``ss.edge_terms``; the
LM loop's initial damping scale is the diagonal maximum of their camera
and landmark blocks) and their chi2 alone (``invdist_lo_chi2`` /
``invdist_ls_chi2``, under ``lm.chi2``).

The JAX package differentiated these edges with ``jax.jacfwd`` under XLA
(``slampp_tpu/models/sim3.py``); no Pallas kernel.  The call sites take
these forms for CUDA operands only (``core/assembly.takes_fused``): CPU
operands keep the generic path (``models/sim3._p2c_invdist_lo_jacobians``
/ ``_p2c_invdist_ls_jacobians`` with the einsums of
``SparseSchurSolver._edge_terms``, ``assembly.edge_chi2`` and
``assembly.max_edge_hessian_diag`` on ``jacobian_fn`` / ``error_fn``),
which is the kernel's reference.  Each function here launches the
hand-written kernel (``csrc/invdist_kernels.cu``, built at first use into
the kernels' library by ``ops/_cuda.py``) or raises: on a build failure, a
refused launch, or operands the kernel does not take (other than float64
landmarks, cameras, measurements and information, int64 indices and a bool
mask, on one card, contiguous; the LO edge's ``meas`` and either edge's
``sigma_inv`` 16-byte aligned, the kernel reads them as ``double2``).  The
kernel reads the indices as the graph snapshot made them, in range:
checking them on the card would cost a host read a call.

Operands: ``lm`` (n_l, 4: q, then the ray) and ``cams`` (n_c, 12: the
sim(3) log, then fx fy cx cy k) are the graph's ``invdist`` and ``camsim3``
states; ``local_idx`` the (landmark, owner, observer) index of each LO
edge (E, 3) or the landmark of each LS edge (E, 1); ``meas`` (E, 2) for LO,
(E, 7) for LS (u, v, then the owner's intrinsics); ``sigma_inv`` (E, 2, 2)
(symmetric) and ``valid`` (E,) the edges' ``EdgeArrays``.  Rows of the
terms come in the edge order.

``launches`` counts the kernel launches per form; ``reset_launches``
clears it.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.ops import _cuda

launches = {"invdist_lo_terms": 0, "invdist_lo_chi2": 0, "invdist_ls_terms": 0,
            "invdist_ls_chi2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _spec(lm, cams, local_idx, meas, sigma_inv, valid):
    """(the number of edges, the kernel's operands as ``_cuda.check_operands``
    rows); ``cams`` None for the LS edge."""
    lo = cams is not None
    m = local_idx.shape[0] if local_idx.dim() == 2 else -1
    f64, i64 = torch.float64, torch.int64
    # (operand, shape, dtype, alignment in bytes the kernel's loads need)
    ops = [(lm, (lm.shape[0], 4), f64, 8)]
    if lo:
        ops.append((cams, (cams.shape[0], 12), f64, 8))
    ops += [(local_idx, (m, 3 if lo else 1), i64, 8),
            (meas, (m, 2), f64, 16) if lo else (meas, (m, 7), f64, 8),
            (sigma_inv, (m, 2, 2), f64, 16), (valid, (m,), torch.bool, 1)]
    return m, ops


def _launch(form, symbol, ops, outs, m, device):
    _cuda.launch_reduction(form, "slampp_invdist_workspace", symbol, device, m, ops, outs)
    launches[form] += 1
    return outs


def invdist_lo_terms(lm, cams, local_idx, meas, sigma_inv, valid):
    """(H_oo, H_cc, H_oc (E, 7, 7), g_o, g_c (E, 7), D (E, 1, 1), g_l (E, 1),
    B (2E, 7, 1), chi2) of the LO edges: with W = ``sigma_inv`` and the
    Jacobians J_q, J_o, J_c of the landmark, owner and observer slots,
    H_ab = J_a^T W J_b, g_a = J_a^T W r, D = J_q^T W J_q, g_l = J_q^T W r,
    B rows [0, E) J_o^T W J_q and [E, 2E) J_c^T W J_q; chi2 = sum of
    r^T W r over the ``valid`` edges (the terms are not masked), a 0-d
    tensor.  float64 and contiguous outputs, rows in the edge order."""
    ops = (lm, cams, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(*ops)
    _cuda.check_operands("invdist_lo_terms", spec)
    new = lm.new_empty
    outs = (new((m, 7, 7)), new((m, 7, 7)), new((m, 7, 7)), new((m, 7)), new((m, 7)),
            new((m, 1, 1)), new((m, 1)), new((2 * m, 7, 1)), new(()))
    return _launch("invdist_lo_terms", "slampp_invdist_lo_terms_f64", ops, outs, m, lm.device)


def invdist_lo_chi2(lm, cams, local_idx, meas, sigma_inv, valid):
    """sum of r^T W r over the valid LO edges (operands as
    :func:`invdist_lo_terms`), a 0-d tensor on the operands' device."""
    ops = (lm, cams, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(*ops)
    _cuda.check_operands("invdist_lo_chi2", spec)
    return _launch("invdist_lo_chi2", "slampp_invdist_lo_chi2_f64", ops, (lm.new_empty(()),), m,
                   lm.device)[0]


def invdist_ls_terms(lm, local_idx, meas, sigma_inv, valid):
    """(D (E, 1, 1), g_l (E, 1), chi2) of the LS edges, as
    :func:`invdist_lo_terms` gives them for its landmark slot."""
    ops = (lm, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(lm, None, *ops[1:])
    _cuda.check_operands("invdist_ls_terms", spec)
    outs = (lm.new_empty((m, 1, 1)), lm.new_empty((m, 1)), lm.new_empty(()))
    return _launch("invdist_ls_terms", "slampp_invdist_ls_terms_f64", ops, outs, m, lm.device)


def invdist_ls_chi2(lm, local_idx, meas, sigma_inv, valid):
    """sum of r^T W r over the valid LS edges (operands as
    :func:`invdist_ls_terms`), a 0-d tensor on the operands' device."""
    ops = (lm, local_idx, meas, sigma_inv, valid)
    m, spec = _spec(lm, None, *ops[1:])
    _cuda.check_operands("invdist_ls_chi2", spec)
    return _launch("invdist_ls_chi2", "slampp_invdist_ls_chi2_f64", ops, (lm.new_empty(()),), m,
                   lm.device)[0]
