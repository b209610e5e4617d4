"""Plain reference of Levenberg-Marquardt Sim(3) bundle adjustment on raw
observation arrays, in float64: the normal equations reduced to the
cameras by a Schur complement summed over the pairs of observations that
share a point, and solved dense.

Semantics (SLAM++ ``include/slam/Sim3_Types.h``: ``CVertexCamSim3``, world
XYZ points and the global reprojection edge ``CEdgeP2C_XYZ_Sim3_G``; the BA
data embedded as ``src/incremental_ba_3dv/Main.cpp:236-259`` does;
``NonlinearSolver_Lambda_LM.h`` for the loop):

* a Sim(3) element is the 4 x 4 matrix [[s R, t], [0, 1]]; its log
  coordinates (u, w, sigma) are those of the generator
  G = [[sigma I + [w]x, u], [0, 0]], exp(G) the matrix exponential
  (``torch.linalg.matrix_exp``), so t = V u with V = int_0^1 exp(tau
  (sigma I + [w]x)) dtau, R = exp([w]x), s = e^sigma;
* the log takes w from R through its quaternion (angle in [0, pi]),
  sigma = log s, and u = V^-1 t, V read off the exponential of the 6 x 6
  block matrix [[sigma I + [w]x, I], [0, 0]];
* a camera state is (u, w, sigma, fx, fy, cx, cy, k): the log of its
  camera-to-world similarity and five held intrinsics.  The embedding of a
  BA camera (world-to-camera t, axis-angle, fx, fy, cx, cy, k) takes the
  pose with scale 1, inverts it and stores the log of the inverse;
* a world point X projects through x = s^-1 R^T (X - t) to
  (a, b) = (fx x / z, fy y / z), d = 1 + k' (a^2 + b^2) with
  k' = k / (0.5 fx fy) (the Sim(3) solver's normalization; the BA camera's
  is k / (0.5 (fx + fy)), and the generator's k is 0, so both agree here),
  (u, v) = (cx + d a, cy + d b); the residual is the measurement minus
  (u, v), weighted by the observation's information matrix;
* a camera moves by post-multiplication, log(exp(x) exp(d)) for a
  7-vector d (the intrinsics stay), a point by addition; Jacobians here by
  forward-mode automatic differentiation at a zero delta, through the
  matrix exponential of -G(d) applied to the camera-local point;
* the gauge anchor is the one the program's graph adds: a unary factor of
  information I on vertex 0 (camera 0) where the first observation is of
  camera 0, else on that observation's point (``FlatSystem.h:337,432``);
* LM: initial damping alpha = tau times the largest diagonal entry of any
  observation's point or camera Hessian block J^T W J; alpha is added to
  every diagonal entry; a step solves (H + alpha I) dx = -g; its gain ratio
  is (chi2 - chi2(x + dx)) / (alpha |dx|^2 - dx . g~), a step with a
  positive ratio is taken and alpha scaled by max(1/3, 1 - (2 rho - 1)^3),
  else alpha is multiplied by nu and nu doubled; a step whose |dx| is not
  finite or at most ``min_dx_norm`` ends the loop.  One departure from the
  textbook gain test, kept because it is the engine's (and the JAX
  package's): g~ holds the reduced gradient g_c - sum B D^-1 g_p on the
  camera rows and g_p on the point rows, not the gradient itself.

Nothing here imports the program; the arrays the generator made are the
inputs both sides read.
"""

from __future__ import annotations

import math

import torch


def _skew(w):
    o = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([o, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], o, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], o], -1)], -2)


def _generator(v):
    """(..., 4, 4) generator of the log coordinates v = (u, w, sigma)."""
    top = torch.cat([v[..., 6, None, None] * torch.eye(3, dtype=v.dtype, device=v.device)
                     + _skew(v[..., 3:6]), v[..., 0:3, None]], -1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], -2)


def sim3_exp(v):
    """(R, t, s) of the log coordinates v (..., 7)."""
    M = torch.linalg.matrix_exp(_generator(v))
    s = torch.exp(v[..., 6])
    return M[..., :3, :3] / s[..., None, None], M[..., :3, 3], s


def _rot_log(R):
    """Axis-angle of rotation matrices through the quaternion (the largest
    of four pivots), angle in [0, pi]."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    piv = torch.stack([r00 + r11 + r22, r00 - r11 - r22, r11 - r00 - r22, r22 - r00 - r11], -1)
    k = piv.argmax(-1)
    big = torch.sqrt(torch.clamp_min(1.0 + piv.gather(-1, k[..., None])[..., 0], 1e-300)) / 2.0
    f = 0.25 / big
    sx, sy, sz = (R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1])
    px, py, pz = (R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0],
                  R[..., 1, 2] + R[..., 2, 1])
    q = torch.stack([
        torch.stack([big, sx * f, sy * f, sz * f], -1),
        torch.stack([sx * f, big, px * f, py * f], -1),
        torch.stack([sy * f, px * f, big, pz * f], -1),
        torch.stack([sz * f, py * f, pz * f, big], -1)], -2)
    q = q.gather(-2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(vn, q[..., 0])
    scale = torch.where(vn > 1e-300, angle / torch.clamp_min(vn, 1e-300), 2.0 / q[..., 0])
    return q[..., 1:] * scale[..., None]


def sim3_log(R, t, s):
    """Log coordinates (..., 7) of (R, t, s)."""
    w = _rot_log(R)
    sigma = torch.log(s)
    eye = torch.eye(3, dtype=t.dtype, device=t.device).expand(w.shape[:-1] + (3, 3))
    A = sigma[..., None, None] * eye + _skew(w)
    block = torch.cat([torch.cat([A, eye], -1), torch.zeros_like(torch.cat([A, eye], -1))], -2)
    V = torch.linalg.matrix_exp(block)[..., :3, 3:]
    u = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([u, w, sigma[..., None]], -1)


def embed_cameras(cams):
    """BA cameras (t_w2c, axis-angle, fx, fy, cx, cy, k) -> Sim(3) camera
    states (log of the camera-to-world similarity, the intrinsics)."""
    w = cams[:, 3:6]
    R_w2c = torch.linalg.matrix_exp(_skew(w))
    R = R_w2c.transpose(1, 2)
    t = -(R @ cams[:, 0:3, None])[..., 0]
    return torch.cat([sim3_log(R, t, torch.ones_like(t[:, 0])), cams[:, 6:11]], 1)


def retract_cameras(cams, d):
    """log(exp(x) exp(d)) per camera, intrinsics kept."""
    R, t, s = sim3_exp(cams[:, 0:7])
    Rd, td, sd = sim3_exp(d)
    t_new = t + s[:, None] * (R @ td[..., None])[..., 0]
    return torch.cat([sim3_log(R @ Rd, t_new, s * sd), cams[:, 7:]], 1)


def _project(x, intr):
    fx, fy, cx, cy, k = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3], intr[..., 4]
    a = fx * x[..., 0] / x[..., 2]
    b = fy * x[..., 1] / x[..., 2]
    d = 1.0 + (k / (0.5 * fx * fy)) * (a * a + b * b)
    return torch.stack([cx + d * a, cy + d * b], -1)


def _residual(dX, dc, X, Rt, t, s, intr, uv):
    """One observation's residual with its point moved by dX and its camera
    by the post-multiplied delta dc: x = exp(-G(dc)) T^-1 (X + dX)."""
    y = Rt @ (X + dX - t) / s
    E = torch.linalg.matrix_exp(-_generator(dc))
    x = E[:3, :3] @ y + E[:3, 3]
    return uv - _project(x, intr)


class Problem:
    """The observation arrays on ``device``, sorted by point, the pairs of
    observations of one point and the gauge anchor.

    The controls, each the reference one precision below a part that the
    configuration states in float64: ``f32_pairs`` forms the pair products
    Y_e Y_f^T of float32 operands in float32 (the cell's control);
    ``f32_edge_terms`` forms each observation's terms (its residual and
    Jacobians from the states cast to float32, and their products with the
    information matrix) in float32.  Every sum stays float64."""

    def __init__(self, cams, points, obs_cam, obs_pt, uv, info, device,
                 f32_pairs: bool = False, f32_edge_terms: bool = False):
        self.f32_pairs = f32_pairs
        self.f32_edge_terms = f32_edge_terms
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        obs_cam, obs_pt = torch.as_tensor(obs_cam), torch.as_tensor(obs_pt)
        # the program's graph anchors vertex 0 (camera 0) where the first
        # observation holds it, else the first observation's point
        self.anchor = ("cam", 0) if int(obs_cam[0]) == 0 else ("point", int(obs_pt[0]))
        order = torch.argsort(obs_pt, stable=True)
        self.cams0 = embed_cameras(torch.as_tensor(cams, **f64))
        self.points0 = torch.as_tensor(points, **f64)
        self.oc = obs_cam[order].to(dev)
        self.op = obs_pt[order].to(dev)
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

    def _per_obs(self, cams, points):
        R, t, s = sim3_exp(cams[:, 0:7])
        oc = self.oc
        return (points[self.op], R.transpose(1, 2)[oc], t[oc], s[oc], cams[oc, 7:12])

    def residuals(self, cams, points, chunk: int = 1 << 18):
        X, Rt, t, s, intr = self._per_obs(cams, points)
        y = (Rt @ (X - t)[..., None])[..., 0] / s[:, None]
        return torch.cat([self.uv[a:a + chunk] - _project(y[a:a + chunk], intr[a:a + chunk])
                          for a in range(0, X.shape[0], chunk)])

    def chi2(self, cams, points) -> torch.Tensor:
        r = self.residuals(cams, points)
        return torch.einsum("mi,mij,mj->", r, self.W, r)

    def jacobians(self, cams, points, chunk: int = 1 << 18, dtype=torch.float64):
        """r (m, 2), dr / dX (m, 2, 3), dr / dcam (m, 2, 7) at zero deltas,
        evaluated in ``dtype``."""
        X, Rt, t, s, intr = self._per_obs(cams.to(dtype), points.to(dtype))
        uv = self.uv.to(dtype)
        jac = torch.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)))
        rs, jps, jcs = [], [], []
        for a in range(0, X.shape[0], chunk):
            e = slice(a, a + chunk)
            dX = torch.zeros_like(X[e])
            dc = X.new_zeros(dX.shape[0], 7)
            args = (dX, dc, X[e], Rt[e], t[e], s[e], intr[e], uv[e])
            rs.append(torch.vmap(_residual)(*args))
            jp, jc = jac(*args)  # forward mode can widen float32 tangents
            jps.append(jp.to(dtype))
            jcs.append(jc.to(dtype))
        return torch.cat(rs), torch.cat(jps), torch.cat(jcs)

    def max_hessian_diag(self, cams, points) -> float:
        _, Jp, Jc = self.jacobians(cams, points)
        return max(float(torch.einsum("mri,mrs,msi->mi", J, self.W, J).max()) for J in (Jp, Jc))

    def step(self, cams, points, alpha: float, pair_chunk: int = 1 << 21):
        """One damped step: (new cams, new points, |dx|, the gain ratio's
        denominator)."""
        n_c, n_p, dev = self.n_c, self.n_p, cams.device
        dt = torch.float32 if self.f32_edge_terms else torch.float64
        r, Jp, Jc = self.jacobians(cams, points, dtype=dt)
        W = self.W.to(dt)
        WJp, WJc = W @ Jp, W @ Jc
        eye3 = torch.eye(3, dtype=torch.float64, device=dev)
        eye7 = torch.eye(7, dtype=torch.float64, device=dev)
        D = torch.zeros(n_p, 3, 3, dtype=torch.float64, device=dev)
        D.index_add_(0, self.op, (Jp.transpose(1, 2) @ WJp).double())
        D = D + alpha * eye3
        g_p = torch.zeros(n_p, 3, dtype=torch.float64, device=dev)
        g_p.index_add_(0, self.op, torch.einsum("mri,mr->mi", WJp, r).double())
        Hcc = torch.zeros(n_c, 7, 7, dtype=torch.float64, device=dev)
        Hcc.index_add_(0, self.oc, (Jc.transpose(1, 2) @ WJc).double())
        Hcc = Hcc + alpha * eye7
        kind, idx = self.anchor
        if kind == "cam":
            Hcc[idx] += eye7
        else:
            D[idx] += eye3
        g_c = torch.zeros(n_c, 7, dtype=torch.float64, device=dev)
        g_c.index_add_(0, self.oc, torch.einsum("mri,mr->mi", WJc, r).double())
        B = (Jc.transpose(1, 2) @ WJp).double()  # (m, 7, 3)
        del r, Jp, Jc, WJp, WJc

        # S = Hcc - sum_p B_p D_p^-1 B_p^T, through Y_e = B_e L_p^-T
        # (D_p = L_p L_p^T): each pair (e, f) of observations of one point
        # puts Y_e Y_f^T on the camera block (cam_e, cam_f), and its
        # transpose on (cam_f, cam_e) where e != f
        Linv_t = torch.linalg.inv(torch.linalg.cholesky(D)).transpose(1, 2)
        Y = B @ Linv_t[self.op]  # (m, 7, 3)
        Yp = Y.float() if self.f32_pairs else Y
        Sb = torch.zeros(n_c * n_c, 7, 7, dtype=torch.float64, device=dev)
        for a in range(0, self.pair_e.shape[0], pair_chunk):
            e, f = self.pair_e[a:a + pair_chunk], self.pair_f[a:a + pair_chunk]
            P = (Yp[e] @ Yp[f].transpose(1, 2)).double()
            Sb.index_add_(0, self.oc[e] * n_c + self.oc[f], P)
            off = e != f
            Sb.index_add_(0, self.oc[f[off]] * n_c + self.oc[e[off]], P[off].transpose(1, 2))
        S = -Sb.view(n_c, n_c, 7, 7).permute(0, 2, 1, 3).reshape(7 * n_c, 7 * n_c)
        del Sb
        ci = torch.arange(n_c, device=dev)
        S.view(n_c, 7, n_c, 7)[ci, :, ci, :] += Hcc
        Dinv = torch.cholesky_inverse(torch.linalg.cholesky(D))
        rb = torch.einsum("mik,mk->mi", B @ Dinv[self.op], g_p[self.op])
        g_red = g_c.clone().index_add_(0, self.oc, -rb)
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:  # not positive definite: the loop ends, as the program's does
            return cams, points, float("nan"), float("nan")
        dxc = -torch.cholesky_solve(g_red.reshape(-1, 1), L)[:, 0].reshape(n_c, 7)
        bt = torch.zeros(n_p, 3, dtype=torch.float64, device=dev)
        bt.index_add_(0, self.op, torch.einsum("mik,mi->mk", B, dxc[self.oc]))
        dx_p = torch.einsum("pij,pj->pi", Dinv, -g_p - bt)
        sq = (dxc * dxc).sum() + (dx_p * dx_p).sum()
        denom = alpha * sq - ((dxc * g_red).sum() + (dx_p * g_p).sum())
        return (retract_cameras(cams, dxc), points + dx_p, float(torch.sqrt(sq)),
                float(denom))


def run(inputs: dict, solve: dict, device, **control) -> dict:
    """LM from the generated start, embedded in Sim(3):
    ``solve["max_iterations"]`` steps at most, ``solve["tau"]`` and
    ``solve["min_dx_norm"]`` as the program takes them.  ``inputs``: cams,
    points, obs_cam, obs_pt, uv, info (NumPy arrays).  Returns the final
    states, the chi2 after the loop and the steps taken and accepted.
    ``control``: the switches of ``Problem``."""
    max_iterations, min_dx_norm = int(solve["max_iterations"]), float(solve["min_dx_norm"])
    prob = Problem(inputs["cams"], inputs["points"], inputs["obs_cam"], inputs["obs_pt"],
                   inputs["uv"], inputs["info"], device, **control)
    cams, points = prob.cams0, prob.points0
    alpha = float(solve["tau"]) * prob.max_hessian_diag(cams, points)
    nu = 2.0
    last = float(prob.chi2(cams, points))
    chi2s, before = [last], (cams, points)
    taken = iterations = 0
    for _ in range(max_iterations):
        iterations += 1
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
    return {"cams": cams, "points": points, "chi2": last, "taken": taken,
            "iterations": iterations, "problem": prob,
            "residuals": prob.residuals(cams, points),
            "residuals_before": prob.residuals(*before), "chi2_accepted": chi2s}


def summary(ref: dict) -> dict:
    return {"chi2": ref["chi2"], "taken": ref["taken"], "iterations": ref["iterations"],
            "chi2_accepted": ref["chi2_accepted"]}


def compare(ref: dict, out: dict) -> dict:
    """The numbers that can decide ``correct`` for one solve of the program:
    ``resid_err``, the largest gap (pixels) between an observation's
    reprojection residual at its final cameras and points and at the
    reference's; ``chi2_rel``, the relative gap between the chi2 of its
    final states and the reference's; ``resid_step`` and ``chi2_step``,
    the same gaps over the largest change of a residual and the chi2 that
    the reference's last accepted step made.  Residuals see neither the
    gauge (a similarity of the whole scene) nor a camera's own scale, which
    the anchor and the damping pin only weakly, nor how a log is written."""
    prob = ref["problem"]
    cams = out["cams"].to(ref["cams"].device, torch.float64)
    points = out["points"].to(ref["points"].device, torch.float64)
    r = prob.residuals(cams, points)
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
