"""Plain reference of Levenberg-Marquardt Sim(3) bundle adjustment with
local inverse-distance landmarks on raw observation arrays, in float64:
the normal equations reduced to the cameras by a Schur complement over
the pairs of cameras that share a landmark, and solved dense.

Semantics (SLAM++ ``include/slam/Sim3_Types.h``: ``CVertexCamSim3``,
``CVertexInvDist`` and the edges ``CEdgeP2C_InvDist_Sim3_LS`` / ``_LO``;
the parameterization study ``src/ba_parameter_acra``;
``NonlinearSolver_Lambda_LM.h`` for the loop):

* cameras, their embedding, their retraction and the projection are
  those of ``sim3_lm`` (its helpers are imported from there);
* a point's owner is the camera of its first observation in the arrays'
  order.  Its state is (q, ray): the ray is that observation's pixel
  back-projected in the owner's frame, ((u - cx) / (d fx), (v - cy) /
  (d fy), 1) normalized with d = 1 + k' ((u - cx)^2 + (v - cy)^2) (one
  fixed-point step of the distortion; the generator's k is 0), and q is
  one over the distance of the start point from the owner's centre;
* the point in its owner's frame is ray / q.  An observation by the owner
  projects it as it is (LS); one by another camera c carries it to the
  world by the owner's similarity and into c by the inverse of c's (LO):
  x = T_c^-1 T_o (ray / q);
* q moves by addition (the ray stays), a camera by post-multiplication;
  the Jacobians come by forward-mode automatic differentiation at zero
  deltas, of q + dq, T_o exp(d_o) and exp(-d_c) T_c^-1 (matrix
  exponentials of the generators);
* the gauge anchor is a unary factor of information I on camera 0: the
  program's graph anchors vertex 0, and its embedding adds an edge that
  holds camera 0 first;
* the reduced camera system: H_cc holds every LO edge's owner and
  observer blocks and the owner-observer block between them; each
  landmark's couplings J_c^T W J_q are summed per (landmark, camera) into
  one row, for the owner and each observer; S = H_cc + alpha I + the
  anchor - sum over the pairs of rows (e, f) of one landmark of
  B_e B_f^T / D, D = sum J_q^T W J_q + alpha;
* LM and its gain test are ``sim3_lm``'s, with its one departure: the
  gain denominator reads the reduced gradient on the camera rows.

Nothing here imports the program; the arrays the generator made are the
inputs both sides read.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.sim3_lm import _generator, _project, embed_cameras, retract_cameras, \
    sim3_exp


def backproject(uv, intr):
    """Unit rays (n, 3) of pixels ``uv`` under intrinsics (fx, fy, cx, cy, k)."""
    fx, fy, cx, cy, k = (intr[:, i] for i in range(5))
    du, dv = uv[:, 0] - cx, uv[:, 1] - cy
    d = 1.0 + (k / (0.5 * fx * fy)) * (du * du + dv * dv)
    ray = torch.stack([du / d / fx, dv / d / fy, torch.ones_like(du)], 1)
    return ray / torch.linalg.vector_norm(ray, dim=1, keepdim=True)


def _res_ls(dq, q, ray, intr, uv):
    return uv - _project(ray / (q + dq), intr)


def _res_lo(dq, do, dc, q, ray, Ro, to, so, Rc_t, tc, sc, intr, uv):
    """An LO observation's residual with q moved by dq, its owner by the
    post-multiplied delta do and its observer by dc."""
    Eo = torch.linalg.matrix_exp(_generator(do))
    x_o = Eo[:3, :3] @ (ray / (q + dq)) + Eo[:3, 3]
    y = Rc_t @ (so * (Ro @ x_o) + to - tc) / sc
    Ec = torch.linalg.matrix_exp(-_generator(dc))
    return uv - _project(Ec[:3, :3] @ y + Ec[:3, 3], intr)


class Problem:
    """The observations on ``device`` sorted by point, split into the
    owners' own (LS) and the others (LO), the (landmark, camera) coupling
    rows and their pairs.

    The control, the reference one precision below a part that the
    configuration states in float64: ``f32_edge_terms`` forms each
    observation's terms (its residual and Jacobians from the states cast
    to float32, and their products with the information matrix) in
    float32.  Every sum stays float64."""

    def __init__(self, cams, points, obs_cam, obs_pt, uv, info, device,
                 f32_edge_terms: bool = False):
        self.f32_edge_terms = f32_edge_terms
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        oc = torch.as_tensor(obs_cam).to(dev)
        op = torch.as_tensor(obs_pt).to(dev)
        uv = torch.as_tensor(uv).to(**f64)
        m = op.shape[0]
        cams = torch.as_tensor(cams, **f64)
        self.cams0 = embed_cameras(cams)
        self.n_c, self.n_p = cams.shape[0], int(torch.as_tensor(points).shape[0])
        n_c, n_p = self.n_c, self.n_p
        first = torch.full((n_p,), m, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, op, torch.arange(m, device=dev), "amin")
        self.owner = oc[first]
        _, t, _ = sim3_exp(self.cams0[:, 0:7])  # camera-to-world: t is the centre
        self.ray = backproject(uv[first], cams[self.owner, 6:11])
        self.q0 = 1.0 / torch.linalg.vector_norm(torch.as_tensor(points, **f64)
                                                 - t[self.owner], dim=1)

        order = torch.argsort(op, stable=True)
        self.oc, self.op = oc[order], op[order]
        self.uv = uv[order]
        self.W = torch.as_tensor(info).to(**f64)[order]
        self.oo = self.owner[self.op]
        self.ls = torch.nonzero(self.oc == self.oo)[:, 0]
        self.lo = torch.nonzero(self.oc != self.oo)[:, 0]
        # coupling rows (landmark, camera), sorted by landmark then camera:
        # each LO observation couples its landmark to its owner and observer
        lo_p = self.op[self.lo]
        keys = torch.cat([lo_p * n_c + self.oo[self.lo], lo_p * n_c + self.oc[self.lo]])
        rkeys, self.cpl_row = torch.unique(keys, return_inverse=True)
        self.row_pt, self.row_cam = rkeys // n_c, rkeys % n_c
        n_r = rkeys.shape[0]
        # the pairs (e, f), e <= f, of rows of one landmark
        deg = torch.bincount(self.row_pt, minlength=n_p)
        start = torch.cumsum(deg, 0) - deg
        reps = deg[self.row_pt] - (torch.arange(n_r, device=dev) - start[self.row_pt])
        self.pair_e = torch.repeat_interleave(torch.arange(n_r, device=dev), reps)
        j = torch.arange(self.pair_e.shape[0], device=dev) - torch.repeat_interleave(
            torch.cumsum(reps, 0) - reps, reps)
        self.pair_f = self.pair_e + j

    def residuals(self, cams, lm, chunk: int = 1 << 18):
        """(m, 2) residuals at camera states ``cams`` and landmark states
        ``lm`` (n_p, 4) = (q, ray), in the sorted observation order."""
        R, t, s = sim3_exp(cams[:, 0:7])
        x = lm[:, 1:4] / lm[:, 0:1]
        out = []
        for a in range(0, self.op.shape[0], chunk):
            e = slice(a, a + chunk)
            p, c, o = self.op[e], self.oc[e], self.oo[e]
            xo = x[p]
            y = (R[o] @ xo[..., None])[..., 0] * s[o, None] + t[o]
            y = (R[c].transpose(1, 2) @ (y - t[c])[..., None])[..., 0] / s[c, None]
            y = torch.where((c == o)[:, None], xo, y)
            out.append(self.uv[e] - _project(y, cams[c, 7:12]))
        return torch.cat(out)

    def chi2(self, cams, lm) -> torch.Tensor:
        r = self.residuals(cams, lm)
        return torch.einsum("mi,mij,mj->", r, self.W, r)

    def jacobians(self, cams, q, chunk: int = 1 << 17, dtype=torch.float64):
        """(r_ls, Jq_ls) of the LS observations and (r_lo, Jq_lo, J_owner,
        J_observer) of the LO ones, at zero deltas, evaluated in
        ``dtype``."""
        cams, q = cams.to(dtype), q.to(dtype)
        ray, uv = self.ray.to(dtype), self.uv.to(dtype)
        R, t, s = sim3_exp(cams[:, 0:7])
        ls, lo = self.ls, self.lo
        pl = self.op[ls]
        dq = q.new_zeros(ls.shape[0], 1)
        args = (dq, q[pl, None], ray[pl], cams[self.oc[ls], 7:12], uv[ls])
        r_ls = torch.vmap(_res_ls)(*args)
        jq_ls = torch.vmap(torch.func.jacfwd(_res_ls))(*args).to(dtype)
        out = [[], [], [], []]
        jac = torch.vmap(torch.func.jacfwd(_res_lo, argnums=(0, 1, 2)))
        for a in range(0, lo.shape[0], chunk):
            e = lo[a:a + chunk]
            p, c, o = self.op[e], self.oc[e], self.oo[e]
            n = e.shape[0]
            args = (q.new_zeros(n, 1), q.new_zeros(n, 7), q.new_zeros(n, 7), q[p, None],
                    ray[p], R[o], t[o], s[o], R[c].transpose(1, 2), t[c], s[c],
                    cams[c, 7:12], uv[e])
            out[0].append(torch.vmap(_res_lo)(*args))
            for acc, J in zip(out[1:], jac(*args)):  # forward mode can widen float32
                acc.append(J.to(dtype))
        return (r_ls, jq_ls), tuple(torch.cat(x) for x in out)

    def max_hessian_diag(self, cams, q) -> float:
        (_, jq_ls), (_, jq, jo, jc) = self.jacobians(cams, q)
        W_ls, W_lo = self.W[self.ls], self.W[self.lo]
        best = 0.0
        for J, W in ((jq_ls, W_ls), (jq, W_lo), (jo, W_lo), (jc, W_lo)):
            if J.shape[0]:
                best = max(best, float(torch.einsum("mri,mrs,msi->mi", J, W, J).max()))
        return best

    def step(self, cams, q, alpha: float, pair_chunk: int = 1 << 21):
        """One damped step: (new cams, new q, |dx|, the gain ratio's
        denominator)."""
        n_c, n_p, dev = self.n_c, self.n_p, cams.device
        dt = torch.float32 if self.f32_edge_terms else torch.float64
        (r_ls, jq_ls), (r, jq, jo, jc) = self.jacobians(cams, q, dtype=dt)
        ls, lo = self.ls, self.lo
        W_ls, W = self.W[ls].to(dt), self.W[lo].to(dt)
        WJq_ls, WJq, WJo, WJc = W_ls @ jq_ls, W @ jq, W @ jo, W @ jc
        p_ls, p_lo = self.op[ls], self.op[lo]
        o_lo, c_lo = self.oo[lo], self.oc[lo]
        f64 = dict(dtype=torch.float64, device=dev)
        D = torch.zeros(n_p, **f64)
        D.index_add_(0, p_ls, torch.einsum("mri,mri->m", jq_ls, WJq_ls).double())
        D.index_add_(0, p_lo, torch.einsum("mri,mri->m", jq, WJq).double())
        D = D + alpha
        g_p = torch.zeros(n_p, **f64)
        g_p.index_add_(0, p_ls, torch.einsum("mri,mr->m", WJq_ls, r_ls).double())
        g_p.index_add_(0, p_lo, torch.einsum("mri,mr->m", WJq, r).double())
        g_c = torch.zeros(n_c, 7, **f64)
        g_c.index_add_(0, o_lo, torch.einsum("mri,mr->mi", WJo, r).double())
        g_c.index_add_(0, c_lo, torch.einsum("mri,mr->mi", WJc, r).double())
        # camera-camera blocks of the LO edges, then the rows' pair corrections
        Sb = torch.zeros(n_c * n_c, 7, 7, **f64)
        Sb.index_add_(0, o_lo * (n_c + 1), (jo.transpose(1, 2) @ WJo).double())
        Sb.index_add_(0, c_lo * (n_c + 1), (jc.transpose(1, 2) @ WJc).double())
        Hoc = (jo.transpose(1, 2) @ WJc).double()
        Sb.index_add_(0, o_lo * n_c + c_lo, Hoc)
        Sb.index_add_(0, c_lo * n_c + o_lo, Hoc.transpose(1, 2))
        Bo = torch.einsum("mri,mr->mi", WJo, jq[..., 0]).double()  # J_o^T W J_q
        Bc = torch.einsum("mri,mr->mi", WJc, jq[..., 0]).double()
        del r_ls, jq_ls, r, jq, jo, jc, WJq_ls, WJq, WJo, WJc, Hoc
        B = torch.zeros(self.row_pt.shape[0], 7, **f64)
        B.index_add_(0, self.cpl_row, torch.cat([Bo, Bc]))
        Y = B / torch.sqrt(D[self.row_pt])[:, None]
        rc = self.row_cam
        for a in range(0, self.pair_e.shape[0], pair_chunk):
            e, f = self.pair_e[a:a + pair_chunk], self.pair_f[a:a + pair_chunk]
            P = Y[e, :, None] * Y[f, None, :]
            Sb.index_add_(0, rc[e] * n_c + rc[f], -P)
            off = e != f
            Sb.index_add_(0, rc[f[off]] * n_c + rc[e[off]], -P[off].transpose(1, 2))
        S = Sb.view(n_c, n_c, 7, 7).permute(0, 2, 1, 3).reshape(7 * n_c, 7 * n_c)
        del Sb
        S.diagonal().add_(alpha)
        S[0:7, 0:7] += torch.eye(7, **f64)  # the gauge anchor on camera 0
        g_red = g_c.clone().index_add_(0, rc, -B * (g_p / D)[self.row_pt, None])
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:  # not positive definite: the loop ends, as the program's does
            return cams, q, float("nan"), float("nan")
        dxc = -torch.cholesky_solve(g_red.reshape(-1, 1), L)[:, 0].reshape(n_c, 7)
        bt = torch.zeros(n_p, **f64)
        bt.index_add_(0, self.row_pt, (B * dxc[rc]).sum(1))
        dq = (-g_p - bt) / D
        sq = (dxc * dxc).sum() + (dq * dq).sum()
        denom = alpha * sq - ((dxc * g_red).sum() + (dq * g_p).sum())
        return retract_cameras(cams, dxc), q + dq, float(torch.sqrt(sq)), float(denom)

    def landmarks(self, q):
        return torch.cat([q[:, None], self.ray], 1)


def run(inputs: dict, solve: dict, device, **control) -> dict:
    """LM from the generated start, embedded in Sim(3) with inverse-distance
    landmarks: ``solve["max_iterations"]`` steps at most, ``solve["tau"]``
    and ``solve["min_dx_norm"]`` as the program takes them.  ``inputs``:
    cams, points, obs_cam, obs_pt, uv, info (NumPy arrays).  Returns the
    final states, the chi2 after the loop and the steps taken and accepted.
    ``control``: the switches of ``Problem``."""
    max_iterations, min_dx_norm = int(solve["max_iterations"]), float(solve["min_dx_norm"])
    prob = Problem(inputs["cams"], inputs["points"], inputs["obs_cam"], inputs["obs_pt"],
                   inputs["uv"], inputs["info"], device, **control)
    cams, q = prob.cams0, prob.q0
    alpha = float(solve["tau"]) * prob.max_hessian_diag(cams, q)
    nu = 2.0
    last = float(prob.chi2(cams, prob.landmarks(q)))
    chi2s, before = [last], (cams, q)
    taken = iterations = 0
    for _ in range(max_iterations):
        iterations += 1
        nc, nq, dxn, denom = prob.step(cams, q, alpha)
        if not math.isfinite(dxn) or dxn <= min_dx_norm:
            break
        err = float(prob.chi2(nc, prob.landmarks(nq)))
        rho = (last - err) / max(denom, 1e-300)
        if rho > 0:
            alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            before = (cams, q)
            cams, q, last = nc, nq, err
            chi2s.append(err)
            taken += 1
        else:
            alpha *= nu
            nu *= 2.0
    return {"cams": cams, "points": prob.landmarks(q), "chi2": last, "taken": taken,
            "iterations": iterations, "problem": prob,
            "residuals": prob.residuals(cams, prob.landmarks(q)),
            "residuals_before": prob.residuals(before[0], prob.landmarks(before[1])),
            "chi2_accepted": chi2s}


def summary(ref: dict) -> dict:
    return {"chi2": ref["chi2"], "taken": ref["taken"], "iterations": ref["iterations"],
            "chi2_accepted": ref["chi2_accepted"]}


def compare(ref: dict, out: dict) -> dict:
    """The numbers that can decide ``correct`` for one solve of the program,
    as ``sim3_lm.compare`` gives them: ``resid_err`` (pixels),
    ``chi2_rel``, ``resid_step`` and ``chi2_step``, of the residuals at the
    program's final cameras and landmark states (q, ray) against the
    reference's."""
    prob = ref["problem"]
    cams = out["cams"].to(ref["cams"].device, torch.float64)
    lm = out["points"].to(ref["points"].device, torch.float64)
    r = prob.residuals(cams, lm)
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
