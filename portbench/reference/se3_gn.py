"""Plain reference of Gauss-Newton on an SE(3) pose graph given as g2o
text: dense float64 normal equations, solved by ``torch.linalg.cholesky``.

Semantics (SLAM++ ``-po`` batch GN, ``include/slam/SE3_Types.h``,
``FlatSystem.h``):

* an ``EDGE_SE3:AXISANGLE i j z info`` line is the residual
  r = (z_t - h_t, aa(q_z q_h^-1)), h = between(x_i, x_j), with the
  information matrix ``info`` (its row-major upper triangle on the line);
* poses start at zero for the first vertex and are initialized by composing
  the first edge that reaches each new vertex (x_j = compose(x_i, z));
* a unary factor of information I anchors the gauge on vertex 0 of the
  first edge (else its first vertex): H gets I on that pose's block;
* a step solves H dx = -g with H = J^T W J, g = J^T W r, J the derivative
  of r through the right-composition retraction at a zero delta (here by
  forward-mode automatic differentiation), and moves every pose by
  compose(x, dx);
* chi2 is sum r^T W r.

Nothing here imports the program; the text is the one input both sides
read.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import se3


def parse(text: str):
    """(ij (E, 2) int64, z (E, 6), info (E, 6, 6)) of the
    EDGE_SE3:AXISANGLE lines, in file order."""
    ij, z, info = [], [], []
    iu = np.triu_indices(6)
    for line in text.splitlines():
        f = line.split()
        if not f or f[0] != "EDGE_SE3:AXISANGLE":
            continue
        ij.append((int(f[1]), int(f[2])))
        z.append([float(x) for x in f[3:9]])
        m = np.zeros((6, 6))
        m[iu] = [float(x) for x in f[9:30]]
        info.append(m + np.triu(m, 1).T)
    return np.array(ij, np.int64), np.array(z), np.array(info)


def initial_states(ij: np.ndarray, z: np.ndarray):
    """(vertex ids ascending, states (n, 6) float64 on the CPU, anchor id)."""
    states = {}
    for (i, j), zz in zip(ij, z):
        if i not in states:
            states[i] = torch.zeros(6, dtype=torch.float64)
        if j not in states:
            states[j] = se3.compose(states[i], torch.as_tensor(zz))
    i0, j0 = ij[0]
    anchor = 0 if 0 in (i0, j0) else int(i0)
    ids = sorted(states)
    return ids, torch.stack([states[v] for v in ids]), anchor


def _residual(d0, d1, x0, x1, z):
    h = se3.between(se3.compose(x0, d0), se3.compose(x1, d1))
    qe = se3.quat_mul(se3.aa_to_quat(z[3:6]), se3.quat_conj(se3.aa_to_quat(h[3:6])))
    return torch.cat([z[0:3] - h[0:3], se3.quat_to_aa(qe)])


def residuals(x0, x1, z):
    """(E, 6) residuals of edges with endpoint states x0, x1."""
    zero = torch.zeros_like(x0)
    return torch.vmap(_residual)(zero, zero, x0, x1, z)


def edge_terms(x0, x1, z):
    """Residuals (E, 6) and their Jacobians by each endpoint's delta."""
    zero = torch.zeros_like(x0)
    r = torch.vmap(_residual)(zero, zero, x0, x1, z)
    j0, j1 = torch.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)))(zero, zero, x0, x1, z)
    return r, j0, j1


def chi2(x, e0, e1, z, info) -> torch.Tensor:
    r = residuals(x[e0], x[e1], z)
    return torch.einsum("ei,eij,ej->", r, info, r)


def run(inputs: dict, solve: dict, device) -> dict:
    """``solve["n_iters"]`` Gauss-Newton steps from the initial states of
    ``inputs["text"]``.  Returns the vertex ids, the start and final states
    (n, 6), the chi2 at the start and after each step, and the residuals
    after the last step and before it."""
    device = torch.device(device)
    text, n_iters = inputs["text"], int(solve["n_iters"])
    ij, z_np, info_np = parse(text)
    ids, x0, anchor = initial_states(ij, z_np)
    pos = {v: k for k, v in enumerate(ids)}
    e0 = torch.as_tensor([pos[int(i)] for i in ij[:, 0]], device=device)
    e1 = torch.as_tensor([pos[int(j)] for j in ij[:, 1]], device=device)
    z = torch.as_tensor(z_np, dtype=torch.float64, device=device)
    info = torch.as_tensor(info_np, dtype=torch.float64, device=device)
    x = x0.to(device)
    n = len(ids)
    N = 6 * n
    six = torch.arange(6, device=device)
    chi2s = [float(chi2(x, e0, e1, z, info))]
    before = x
    for _ in range(n_iters):
        before = x
        r, j0, j1 = edge_terms(x[e0], x[e1], z)
        H = torch.zeros(N, N, dtype=torch.float64, device=device)
        g = torch.zeros(N, dtype=torch.float64, device=device)
        rows = (6 * e0[:, None] + six, 6 * e1[:, None] + six)
        jac = (j0, j1)
        for a in range(2):
            WJa = info @ jac[a]
            g.index_put_((rows[a],), torch.einsum("eij,ei->ej", WJa, r), accumulate=True)
            for b in range(2):
                Hab = jac[b].transpose(1, 2) @ WJa
                H.index_put_((rows[b][:, :, None], rows[a][:, None, :]), Hab, accumulate=True)
        a0 = 6 * pos[anchor]
        H[a0 + six, a0 + six] += 1.0
        L = torch.linalg.cholesky(H)
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
        x = se3.compose(x, dx.reshape(n, 6))
        chi2s.append(float(chi2(x, e0, e1, z, info)))
    return {"ids": ids, "states": x, "chi2": chi2s, "edges": (e0, e1, z), "info": info,
            "residuals": residuals(x[e0], x[e1], z),
            "residuals_before": residuals(before[e0], before[e1], z)}


def compare(ref: dict, out: dict) -> dict:
    """The numbers that can decide ``correct`` for one solve of the
    program, against the reference after the same number of steps:

    * ``resid_err``: the largest gap (m or rad) between an edge's residual
      at the program's final poses and at the reference's;
    * ``chi2_rel``: the gap between their chi2, over the reference's;
    * ``resid_step``: ``resid_err`` over the largest change of an edge's
      residual in the reference's last step;
    * ``chi2_step``: the chi2 gap over the chi2 that the reference's last
      step removed.

    Residuals do not see the gauge: the unary anchor pins the frame only
    weakly, and the frame of a float32 solve drifts along it without
    changing any measurement.  The ``_step`` numbers hold a gap against how
    far the reference was still moving: where five steps have not
    converged, the later steps amplify rounding into gaps that the raw
    numbers cannot tell from a fault."""
    e0, e1, z = ref["edges"]
    x = out["states"].to(ref["states"].device, torch.float64)
    r = residuals(x[e0], x[e1], z)
    c = float(torch.einsum("ei,eij,ej->", r, ref["info"], r))
    c_ref, c_before = ref["chi2"][-1], ref["chi2"][-2]
    gap = float((r - ref["residuals"]).abs().max())
    moved = float((ref["residuals"] - ref["residuals_before"]).abs().max())
    return {
        "resid_err": gap,
        "chi2_rel": abs(c - c_ref) / c_ref,
        "resid_step": gap / max(moved, 1e-300),
        "chi2_step": abs(c - c_ref) / max(abs(c_before - c_ref), 1e-300 * c_ref),
    }


def summary(ref: dict) -> dict:
    return {"chi2": ref["chi2"]}
