"""Robust losses and their IRLS weights (counterpart of
``slampp_tpu/models/robust.py``; reference include/slam/RobustUtils.h,
include/geometry/RobustLoss.h).

Each loss gives the weight w(e) = psi(e) / e, which multiplies an edge's
information matrix in assembly (BaseTypes_Binary.h:772); chi2 and the LM
damping scale stay unweighted.  The reference's default robustification
scales the error norm by 16 * 1.4826 and uses Huber with parameter 1.345
(RobustUtils.h:74-95).  ``robustify`` registers the robust variant of an
edge type (the analog of the CBaseEdge::Robust option) and
``apply_robust_to_system`` rebinds every edge type of a system to its
variant, as the JAX package's CLI does for ``--robust``.

Weight functions are batched: ``fn(r (E, res), sigma_inv (E, res, res)) -> (E,)``.
"""

from __future__ import annotations

import dataclasses

import torch

from slampp_tpu_torch.graph.types import EdgeType, get_edge_type, register_edge_type


# weight functions w(e) = psi(e) / e (reference RobustLoss.h operator())
def huber_weight(e, param=1.345):
    """CHuberLoss (RobustLoss.h:55)."""
    return torch.where(e <= param, 1.0, param / torch.clamp_min(e, 1e-300))


def cauchy_weight(e, param=2.3849):
    """CCauchyLoss (RobustLoss.h:111): w = 1 / (1 + (e / a)^2)."""
    return 1.0 / (1.0 + (e / param) ** 2)


def tukey_weight(e, param=4.6851):
    """CTukeyBiweightLoss (RobustLoss.h:162): w = (1 - (e / c)^2)^2 inside, 0 out."""
    t = 1.0 - (e / param) ** 2
    return torch.where(e <= param, t * t, 0.0)


def hampel_weight(e, a=1.5, b=3.5, c=8.0):
    """CHampelLoss (RobustLoss.h:214), three-part redescending."""
    w_mid = a / torch.clamp_min(e, 1e-300)
    w_tail = a * (c - e) / torch.clamp_min((c - b) * e, 1e-300)
    return torch.where(e <= a, 1.0, torch.where(e <= b, w_mid,
                                                torch.where(e <= c, w_tail, 0.0)))


def logistic_weight(e, param=1.205):
    """CLogisticLoss (RobustLoss.h:296): w = tanh(e / a) / (e / a)."""
    t = e / param
    return torch.where(t < 1e-8, 1.0, torch.tanh(t) / torch.clamp_min(t, 1e-300))


def fair_weight(e, param=1.3998):
    """CFairLoss (RobustLoss.h:345): w = 1 / (1 + e / a)."""
    return 1.0 / (1.0 + e / param)


def welsch_weight(e, param=2.9846):
    """CWelschLoss (RobustLoss.h:393): w = exp(-(e / a)^2)."""
    return torch.exp(-((e / param) ** 2))


LOSSES = {
    "huber": huber_weight,
    "cauchy": cauchy_weight,
    "tukey": tukey_weight,
    "hampel": hampel_weight,
    "logistic": logistic_weight,
    "fair": fair_weight,
    "welsch": welsch_weight,
}

# the reference's default error-norm scale: 16 * 1.4826 ~ 593 / 25
DEFAULT_SCALE = 593.0 / 25.0


def error_norm_weight_fn(loss: str = "huber", scale: float = DEFAULT_SCALE, **kw):
    """CRobustify_ErrorNorm_Default (RobustUtils.h:60-103): the weight of the
    scaled error norm."""
    w = LOSSES[loss]

    def fn(r, sigma_inv):
        return w(torch.linalg.vector_norm(r, dim=-1) / scale, **kw)

    return fn


def chi2_weight_fn(loss: str = "huber", scale: float = 1.0, **kw):
    """CRobustify_Chi2_Default (RobustUtils.h:115-130): the weight of the
    whitened (chi) error."""
    w = LOSSES[loss]

    def fn(r, sigma_inv):
        chi2 = torch.einsum("ei,eij,ej->e", r, sigma_inv, r)
        return w(torch.sqrt(torch.clamp_min(chi2, 0.0)) / scale, **kw)

    return fn


def robustify(et: EdgeType, loss: str = "huber", scale: float = DEFAULT_SCALE,
              on_chi2: bool = False) -> EdgeType:
    """Register and return the robust variant of an edge type,
    ``<name>_robust_<loss>``."""
    fn = (chi2_weight_fn if on_chi2 else error_norm_weight_fn)(loss, scale)
    return register_edge_type(
        dataclasses.replace(et, name=f"{et.name}_robust_{loss}", robust_weight_fn=fn)
    )


def apply_robust_to_system(system, loss: str = "huber", scale: float = DEFAULT_SCALE,
                           on_chi2: bool = False) -> None:
    """Rebind every edge type of ``system`` to its robust variant in place,
    registering the variant where it is missing (the reference selects the
    robust policy at compile time, CRobustify_ErrorNorm_Default,
    RobustUtils.h:60).  A variant registered earlier is reused as it is,
    as in the JAX package."""
    renames = {}
    for tname in list(system._edges):
        et = get_edge_type(tname)
        if et.robust_weight_fn is not None:
            continue
        new_name = f"{tname}_robust_{loss}"
        try:
            get_edge_type(new_name)
        except KeyError:
            robustify(et, loss=loss, scale=scale, on_chi2=on_chi2)
        renames[tname] = new_name
    for old, new in renames.items():
        system._edges[new] = system._edges.pop(old)
