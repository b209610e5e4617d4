"""Plain reference of Levenberg-Marquardt bundle adjustment on raw
observation arrays, in float64: the normal equations reduced to the
cameras by a Schur complement summed over the pairs of observations that
share a point.

Semantics (SLAM++ ``-us`` BA, ``include/slam/BA_Types.h``,
``NonlinearSolver_Lambda_LM.h``):

* a camera state is (t, axis-angle, fx, fy, cx, cy, k), the world-to-camera
  pose; a point X projects to x = R X + t, (a, b) = (fx x / z, fy y / z),
  d = 1 + k' (a^2 + b^2) with k' = k / ((fx + fy) / 2), and
  (u, v) = (cx + d a, cy + d b); the residual is the measurement minus
  (u, v), weighted by the observation's information matrix;
* a camera moves by right composition of its pose with a 6-vector delta
  (the intrinsics stay), a point by addition; Jacobians here by
  forward-mode automatic differentiation at a zero delta;
* a unary factor of information I on camera 0 anchors the gauge;
* LM: damping alpha on every diagonal entry, starting at tau 1e3; a step
  solves (H + alpha I) dx = -g; its gain ratio is
  (chi2 - chi2(x + dx)) / (alpha |dx|^2 - dx . g); a step with a positive
  ratio is taken and alpha scaled by max(1/3, 1 - (2 rho - 1)^3), else
  alpha is multiplied by nu and nu doubled; a step whose |dx| is not
  finite (a reduced system that is not positive definite) or at most
  ``min_dx_norm`` ends the loop.

Nothing here imports the program; the arrays the generator made are the
inputs both sides read.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import se3


def _project_residual(dX, dc, X, cam, uv):
    pose = se3.compose(cam[0:6], dc)
    Xw = X + dX
    x = se3.quat_rotate(se3.aa_to_quat(pose[3:6]), Xw) + pose[0:3]
    fx, fy, cx, cy, k = cam[6], cam[7], cam[8], cam[9], cam[10]
    a = fx * x[0] / x[2]
    b = fy * x[1] / x[2]
    d = 1.0 + (k / (0.5 * (fx + fy))) * (a * a + b * b)
    return uv - torch.stack([cx + d * a, cy + d * b])


def _zeros(X, cam):
    return torch.zeros_like(X), torch.zeros(X.shape[:-1] + (6,), dtype=X.dtype, device=X.device)


def residuals(X, cam, uv, chunk: int = 1 << 18):
    out = []
    for s in range(0, X.shape[0], chunk):
        e = slice(s, s + chunk)
        dX, dc = _zeros(X[e], cam[e])
        out.append(torch.vmap(_project_residual)(dX, dc, X[e], cam[e], uv[e]))
    return torch.cat(out)


def residuals_and_jacobians(X, cam, uv, chunk: int = 1 << 18):
    """r (m, 2), dr / dX (m, 2, 3), dr / dcam (m, 2, 6)."""
    jac = torch.vmap(torch.func.jacfwd(_project_residual, argnums=(0, 1)))
    rs, jps, jcs = [], [], []
    for s in range(0, X.shape[0], chunk):
        e = slice(s, s + chunk)
        dX, dc = _zeros(X[e], cam[e])
        rs.append(torch.vmap(_project_residual)(dX, dc, X[e], cam[e], uv[e]))
        jp, jc = jac(dX, dc, X[e], cam[e], uv[e])
        jps.append(jp)
        jcs.append(jc)
    return torch.cat(rs), torch.cat(jps), torch.cat(jcs)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32 with 10 mantissa bits, to nearest),
    back in its own dtype."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


class Problem:
    """The observation arrays on ``device``, sorted by point, and the pairs
    of observations of one point.  With ``tf32_products`` the operands of
    the Schur complement's products are rounded to TF32 (the control: the
    reference one precision below the float32 that the configuration
    states)."""

    def __init__(self, cams, points, obs_cam, obs_pt, uv, info, device,
                 tf32_products: bool = False):
        self.tf32_products = tf32_products
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        order = torch.argsort(torch.as_tensor(obs_pt), stable=True)
        self.cams0 = torch.as_tensor(cams, **f64)
        self.points0 = torch.as_tensor(points, **f64)
        self.oc = torch.as_tensor(obs_cam)[order].to(dev)
        self.op = torch.as_tensor(obs_pt)[order].to(dev)
        self.uv = torch.as_tensor(uv)[order].to(**f64)
        self.W = torch.as_tensor(info)[order].to(**f64)
        self.n_c, self.n_p = self.cams0.shape[0], self.points0.shape[0]
        # the pairs (e, f), e <= f, of observations of one point
        m = self.op.shape[0]
        deg = torch.bincount(self.op, minlength=self.n_p)
        first = torch.cumsum(deg, 0) - deg
        reps = deg[self.op] - (torch.arange(m, device=dev) - first[self.op])
        self.pair_e = torch.repeat_interleave(torch.arange(m, device=dev), reps)
        j = torch.arange(self.pair_e.shape[0], device=dev) - torch.repeat_interleave(
            torch.cumsum(reps, 0) - reps, reps)
        self.pair_f = self.pair_e + j

    def chi2(self, cams, points) -> torch.Tensor:
        r = residuals(points[self.op], cams[self.oc], self.uv)
        return torch.einsum("mi,mij,mj->", r, self.W, r)

    def step(self, cams, points, alpha: float, pair_chunk: int = 1 << 21):
        """One damped step: (new cams, new points, |dx|, alpha |dx|^2 - dx . g)."""
        n_c, n_p, dev = self.n_c, self.n_p, cams.device
        r, Jp, Jc = residuals_and_jacobians(points[self.op], cams[self.oc], self.uv)
        WJp, WJc = self.W @ Jp, self.W @ Jc
        eye3 = torch.eye(3, dtype=torch.float64, device=dev)
        eye6 = torch.eye(6, dtype=torch.float64, device=dev)
        D = torch.zeros(n_p, 3, 3, dtype=torch.float64, device=dev)
        D.index_add_(0, self.op, Jp.transpose(1, 2) @ WJp)
        D = D + alpha * eye3
        g_p = torch.zeros(n_p, 3, dtype=torch.float64, device=dev)
        g_p.index_add_(0, self.op, torch.einsum("mri,mr->mi", WJp, r))
        Hcc = torch.zeros(n_c, 6, 6, dtype=torch.float64, device=dev)
        Hcc.index_add_(0, self.oc, Jc.transpose(1, 2) @ WJc)
        Hcc = Hcc + alpha * eye6
        Hcc[0] += eye6  # the gauge anchor
        g_c = torch.zeros(n_c, 6, dtype=torch.float64, device=dev)
        g_c.index_add_(0, self.oc, torch.einsum("mri,mr->mi", WJc, r))
        B = Jc.transpose(1, 2) @ WJp  # (m, 6, 3): d^2 / dcam dpoint of one observation

        # S = Hcc - sum_p B_p D_p^-1 B_p^T: with Y_e = B_e L_p^-T for an
        # observation e of point p (D_p = L_p L_p^T), each pair (e, f) of
        # observations of one point puts Y_e Y_f^T on the camera block
        # (cam_e, cam_f), and its transpose on (cam_f, cam_e) where e != f
        Linv_t = torch.linalg.inv(torch.linalg.cholesky(D)).transpose(1, 2)  # L^-T
        Y = B @ Linv_t[self.op]  # (m, 6, 3)
        if self.tf32_products:
            Y = tf32(Y)
        Sb = torch.zeros(n_c * n_c, 6, 6, dtype=torch.float64, device=dev)
        for a in range(0, self.pair_e.shape[0], pair_chunk):
            e, f = self.pair_e[a:a + pair_chunk], self.pair_f[a:a + pair_chunk]
            P = Y[e] @ Y[f].transpose(1, 2)
            Sb.index_add_(0, self.oc[e] * n_c + self.oc[f], P)
            off = e != f
            Sb.index_add_(0, self.oc[f[off]] * n_c + self.oc[e[off]], P[off].transpose(1, 2))
        S = -Sb.view(n_c, n_c, 6, 6).permute(0, 2, 1, 3).reshape(6 * n_c, 6 * n_c)
        ci = torch.arange(n_c, device=dev)
        S.view(n_c, 6, n_c, 6)[ci, :, ci, :] += Hcc
        Dinv = torch.cholesky_inverse(torch.linalg.cholesky(D))
        rb = torch.einsum("mik,mk->mi", B @ Dinv[self.op], g_p[self.op])
        g_red = g_c.clone().index_add_(0, self.oc, -rb)
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:  # not positive definite: the loop ends, as the program's does
            return cams, points, float("nan"), float("nan")
        dx_c = -torch.cholesky_solve(g_red.reshape(-1, 1), L)[:, 0]
        dxc = dx_c.reshape(n_c, 6)
        bt = torch.zeros(n_p, 3, dtype=torch.float64, device=dev)
        bt.index_add_(0, self.op, torch.einsum("mik,mi->mk", B, dxc[self.oc]))
        dx_p = torch.einsum("pij,pj->pi", Dinv, -g_p - bt)
        new_cams = torch.cat([se3.compose(cams[:, 0:6], dxc), cams[:, 6:]], 1)
        sq = (dx_c * dx_c).sum() + (dx_p * dx_p).sum()
        denom = alpha * sq - ((dxc * g_c).sum() + (dx_p * g_p).sum())
        return new_cams, points + dx_p, float(torch.sqrt(sq)), float(denom)


def run(inputs: dict, solve: dict, device, tf32_products: bool = False) -> dict:
    """LM from the generated start, ``solve["max_iterations"]`` steps at
    most, ``solve["tau"]`` and ``solve["min_dx_norm"]`` as the program takes
    them.  ``inputs``: cams, points, obs_cam, obs_pt, uv, info (NumPy
    arrays).  Returns the final states, the chi2 after the loop and the
    steps taken.  ``tf32_products``: see ``Problem``."""
    max_iterations, min_dx_norm = int(solve["max_iterations"]), float(solve["min_dx_norm"])
    tau = float(solve["tau"])
    prob = Problem(inputs["cams"], inputs["points"], inputs["obs_cam"], inputs["obs_pt"],
                   inputs["uv"], inputs["info"], device, tf32_products)
    cams, points = prob.cams0, prob.points0
    alpha, nu = tau * 1e3, 2.0
    last = float(prob.chi2(cams, points))
    chi2s, before = [last], (cams, points)
    taken = 0
    for _ in range(max_iterations):
        nc, npt, dxn, denom = prob.step(cams, points, alpha)
        if not math.isfinite(dxn) or dxn <= min_dx_norm:
            break
        err = float(prob.chi2(nc, npt))
        rho = (last - err) / max(denom, 1e-300)
        if rho > 0:
            alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            before = (cams, points)
            cams, points, last = nc, npt, err
            chi2s.append(err)
            taken += 1
        else:
            alpha *= nu
            nu *= 2.0
    r = residuals(points[prob.op], cams[prob.oc], prob.uv)
    r_before = residuals(before[1][prob.op], before[0][prob.oc], prob.uv)
    return {"cams": cams, "points": points, "chi2": last, "taken": taken, "problem": prob,
            "residuals": r, "residuals_before": r_before, "chi2_accepted": chi2s}


def summary(ref: dict) -> dict:
    return {"chi2": ref["chi2"], "taken": ref["taken"], "chi2_accepted": ref["chi2_accepted"]}


def compare(ref: dict, out: dict) -> dict:
    """The numbers that can decide ``correct`` for one solve of the program:
    ``resid_err``, the largest gap (pixels) between an observation's
    reprojection residual at its final cameras and points and at the
    reference's; ``chi2_rel``, the relative gap between the chi2 of its
    final states and the reference's; ``resid_step`` and ``chi2_step``,
    the same gaps over the largest change of a residual and the chi2 that
    the reference's last accepted step made.  Residuals do not see the
    gauge (a similarity of the whole scene), which the anchor and the
    damping pin only weakly."""
    prob = ref["problem"]
    cams = out["cams"].to(ref["cams"].device, torch.float64)
    points = out["points"].to(ref["points"].device, torch.float64)
    r = residuals(points[prob.op], cams[prob.oc], prob.uv)
    c = float(torch.einsum("mi,mij,mj->", r, prob.W, r))
    gap = float((r - ref["residuals"]).abs().max())
    moved = float((ref["residuals"] - ref["residuals_before"]).abs().max())
    c_ref = ref["chi2"]
    c_before = ref["chi2_accepted"][-2] if len(ref["chi2_accepted"]) > 1 else c_ref
    return {
        "resid_err": gap,
        "chi2_rel": abs(c - c_ref) / c_ref,
        "resid_step": gap / max(moved, 1e-300),
        "chi2_step": abs(c - c_ref) / max(abs(c_before - c_ref), 1e-300 * c_ref),
    }
