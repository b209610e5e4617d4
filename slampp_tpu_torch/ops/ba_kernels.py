"""The monocular reprojection (p2c) linearization and chi2 of the BA Schur
engine (``linear/ba_schur.py``): per observation the residual, the point
and camera Jacobians, their products with the 2 x 2 information, and the
sum of r^T W r.

The JAX package computed them as XLA-fused elementwise code
(``_p2c_jacs_analytic`` and ``ba_chi2_only`` in
``slampp_tpu/linear/ba_schur.py``); no Pallas kernel.  Each public function
dispatches on the device of its operands, as ``ops/dense_kernels.py``'s:

* CPU operands take the plain PyTorch version (``*_plain``): the models'
  analytic chain (``models/ba._edge_p2c_jacobians``,
  ``geometry/camera.p2c_error``) and the information products;
* CUDA operands launch the hand-written kernel (``csrc/ba_kernels.cu``,
  built at first use into the kernels' library by ``ops/_cuda.py``) or
  raise: on a build failure, a refused launch, or operands the kernel does
  not take (other than float64 states, uv and information and int64
  indices, on one card, contiguous, 16-byte aligned).  There is no
  fallback from CUDA to the plain version.  The kernel reads the indices
  as the engine's plan made them, in range: checking them on the card
  would cost a host read a call.

The kernel takes monocular observations of 11-wide cameras only (pose 6,
fx fy cx cy k); the graph engines keep ``EDGE_P2C``'s own Jacobians.

``launches`` counts the kernel launches per public function;
``reset_launches`` clears it.
"""

from __future__ import annotations

import torch

from slampp_tpu_torch.geometry import camera as cam_geo
from slampp_tpu_torch.models import ba as ba_models
from slampp_tpu_torch.ops import _cuda

launches = {"p2c_linearize": 0, "p2c_chi2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def p2c_linearize_plain(cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info):
    """(r, Jp, Jc, WJp, WJc, chi2): r (m, 2), Jp (m, 2, 3), Jc (m, 2, 6),
    W Jp, W Jc with W = ``obs_info`` (m, 2, 2), and chi2 = sum r^T W r."""
    r, (Jp, Jc) = ba_models._edge_p2c_jacobians(
        (lm_states[obs_lm], cam_states[obs_cam]), obs_uv)
    W = obs_info
    Wr = torch.einsum("mij,mj->mi", W, r)
    chi2 = (r * Wr).sum()
    WJc = W @ Jc  # (m, 2, 6)
    WJp = W @ Jp  # (m, 2, 3)
    return r, Jp, Jc, WJp, WJc, chi2


def p2c_chi2_plain(cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info):
    """sum over the observations of r^T W r, residuals only."""
    r = cam_geo.p2c_error(lm_states[obs_lm], cam_states[obs_cam], obs_uv)
    return torch.einsum("mi,mij,mj->", r, obs_info, r)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _cuda_args(name: str, cams, lms, obs_cam, obs_lm, uv, info) -> int:
    """Validate the kernel's operands; returns the number of observations."""
    dev = cams.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    m = obs_cam.shape[0] if obs_cam.dim() == 1 else -1
    shapes = ((cams, (cams.shape[0], 11)), (lms, (lms.shape[0], 3)), (obs_cam, (m,)),
              (obs_lm, (m,)), (uv, (m, 2)), (info, (m, 2, 2)))
    for t, want in shapes:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices ({t.device}, {dev})")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: need shape {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:  # the kernel's 16-byte loads of uv and info
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    for t in (cams, lms, uv, info):
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: unsupported dtype {t.dtype} (float64 only)")
    for t in (obs_cam, obs_lm):
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: indices must be int64, got {t.dtype}")
    return m


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def p2c_linearize(cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info):
    """(r, Jp, Jc, WJp, WJc, chi2) of every observation: cam_states (n_c,
    11), lm_states (n_l, 3), obs_cam / obs_lm (m,) int64, obs_uv (m, 2),
    obs_info (m, 2, 2); float64 and contiguous outputs, chi2 a 0-d tensor
    on the operands' device."""
    ops = (cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info)
    if _on_cpu(*ops):
        return p2c_linearize_plain(*ops)
    m = _cuda_args("p2c_linearize", *ops)
    new = cam_states.new_empty
    outs = (new((m, 2)), new((m, 2, 3)), new((m, 2, 6)), new((m, 2, 3)), new((m, 2, 6)),
            new(()))
    _cuda.launch_reduction("p2c_linearize", "slampp_p2c_workspace", "slampp_p2c_linearize_f64",
                           cam_states.device, m, ops, outs)
    launches["p2c_linearize"] += 1
    return outs


def p2c_chi2(cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info):
    """sum of r^T W r over the observations (residuals only; operands as
    ``p2c_linearize``), a 0-d tensor on the operands' device."""
    ops = (cam_states, lm_states, obs_cam, obs_lm, obs_uv, obs_info)
    if _on_cpu(*ops):
        return p2c_chi2_plain(*ops)
    m = _cuda_args("p2c_chi2", *ops)
    chi2 = cam_states.new_empty(())
    _cuda.launch_reduction("p2c_chi2", "slampp_p2c_workspace", "slampp_p2c_chi2_f64",
                           cam_states.device, m, ops, (chi2,))
    launches["p2c_chi2"] += 1
    return chi2
