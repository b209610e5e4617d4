"""Multi-view geometry module (counterpart of ``slampp_tpu/geometry/mvg.py``,
the port's own copy; reference layer L13: include/geometry/, 8.8k LoC
header-only): minimal solvers and estimators feeding initializations to BA.
Host NumPy.

Covered capabilities and reference analogs:
  * PnP: P3P (Kneip-style via Grunert's equation system solved through the
    quartic companion matrix) + DLT PnP      (geometry/P3P.h)
  * homography DLT + decomposition           (geometry/Homography.h)
  * two-view: 8-point fundamental, 7-point fundamental, essential from F,
    relative pose from essential             (geometry/TwoView.h)
  * Kabsch/Umeyama alignment                 (geometry/Kabsch.h; also used by
                                              eval/error_eval.py)
  * triangulation: linear DLT + midpoint     (geometry/Triangulate.h)
  * polynomial root finding via companion    (geometry/PolySolve.h,
    matrices                                  Polynomial.h)
  * radial distortion apply/undistort        (geometry/DistortionModel.h)
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------- polynomial
def poly_roots(coeffs: np.ndarray) -> np.ndarray:
    """Roots of a polynomial (highest degree first) via the companion matrix
    (reference PolySolve.h)."""
    c = np.asarray(coeffs, float)
    c = np.trim_zeros(c, "f")
    if len(c) <= 1:
        return np.zeros(0)
    return np.roots(c)


# ---------------------------------------------------------------- distortion
def distort_radial(uv: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Apply the one-parameter radial model used throughout the framework
    (k scaled by mean focal length; BASolverBase.h:260 convention)."""
    fx, fy, cx, cy, k = intrinsics
    kk = k / (0.5 * (fx + fy))
    c = np.array([cx, cy])
    d = uv - c
    r2 = np.sum(d * d, axis=-1, keepdims=True)
    return c + (1.0 + r2 * kk) * d


def undistort_radial(uv: np.ndarray, intrinsics: np.ndarray, iters: int = 5) -> np.ndarray:
    """Invert the radial model by fixed-point iteration
    (reference Undistort_Point2D, BASolverBase.h:225)."""
    fx, fy, cx, cy, k = intrinsics
    kk = k / (0.5 * (fx + fy))
    c = np.array([cx, cy])
    d_obs = uv - c
    d = d_obs.copy()
    for _ in range(iters):
        r2 = np.sum(d * d, axis=-1, keepdims=True)
        d = d_obs / (1.0 + r2 * kk)
    return c + d


# -------------------------------------------------------------- triangulation
def triangulate_dlt(P1: np.ndarray, P2: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Linear (DLT) triangulation of a point from two projection matrices
    (reference Triangulate.h)."""
    A = np.stack(
        [
            x1[0] * P1[2] - P1[0],
            x1[1] * P1[2] - P1[1],
            x2[0] * P2[2] - P2[0],
            x2[1] * P2[2] - P2[1],
        ]
    )
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]


# -------------------------------------------------------------------- 2-view
def fundamental_8pt(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Normalized 8-point fundamental matrix (reference TwoView.h)."""

    def normalize(x):
        mu = x.mean(0)
        d = np.sqrt(((x - mu) ** 2).sum(1)).mean()
        s = np.sqrt(2.0) / max(d, 1e-12)
        T = np.array([[s, 0, -s * mu[0]], [0, s, -s * mu[1]], [0, 0, 1.0]])
        xh = np.concatenate([x, np.ones((len(x), 1))], 1) @ T.T
        return xh, T

    h1, T1 = normalize(x1)
    h2, T2 = normalize(x2)
    A = np.stack([np.outer(h2[i], h1[i]).ravel() for i in range(len(x1))])
    _, _, Vt = np.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(F)
    F = U @ np.diag([S[0], S[1], 0.0]) @ Vt2  # rank-2 enforcement
    F = T2.T @ F @ T1
    return F / F[2, 2] if abs(F[2, 2]) > 1e-12 else F


def fundamental_7pt(x1: np.ndarray, x2: np.ndarray):
    """7-point fundamental: 1 or 3 solutions via the cubic (TwoView.h)."""
    assert len(x1) == 7
    h1 = np.concatenate([x1, np.ones((7, 1))], 1)
    h2 = np.concatenate([x2, np.ones((7, 1))], 1)
    A = np.stack([np.outer(h2[i], h1[i]).ravel() for i in range(7)])
    _, _, Vt = np.linalg.svd(A)
    F1 = Vt[-1].reshape(3, 3)
    F2 = Vt[-2].reshape(3, 3)
    # det(a F1 + (1-a) F2) = 0 -> cubic in a
    coeffs = np.polyfit(
        np.array([0.0, 1.0 / 3, 2.0 / 3, 1.0]),
        [np.linalg.det(a * F1 + (1 - a) * F2) for a in (0.0, 1.0 / 3, 2.0 / 3, 1.0)],
        3,
    )
    sols = []
    for a in poly_roots(coeffs):
        if abs(a.imag) < 1e-9:
            sols.append(a.real * F1 + (1 - a.real) * F2)
    return sols


def essential_from_fundamental(F: np.ndarray, K1: np.ndarray, K2: np.ndarray) -> np.ndarray:
    E = K2.T @ F @ K1
    U, S, Vt = np.linalg.svd(E)
    s = (S[0] + S[1]) / 2.0
    return U @ np.diag([s, s, 0.0]) @ Vt


def pose_from_essential(E: np.ndarray, x1: np.ndarray, x2: np.ndarray, K1, K2):
    """Relative pose (R, t) from E with the cheirality check over the four
    decompositions (TwoView.h)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [
        (U @ W @ Vt, U[:, 2]),
        (U @ W @ Vt, -U[:, 2]),
        (U @ W.T @ Vt, U[:, 2]),
        (U @ W.T @ Vt, -U[:, 2]),
    ]
    P1 = K1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
    best, best_count = None, -1
    for R, t in cands:
        P2 = K2 @ np.hstack([R, t[:, None]])
        count = 0
        for i in range(min(len(x1), 20)):
            X = triangulate_dlt(P1, P2, x1[i], x2[i])
            z1 = X[2]
            z2 = (R @ X + t)[2]
            if z1 > 0 and z2 > 0:
                count += 1
        if count > best_count:
            best, best_count = (R, t), count
    return best


# ------------------------------------------------------------------------ PnP
def pnp_dlt(X: np.ndarray, uv: np.ndarray, K: np.ndarray):
    """DLT PnP (>= 6 points): returns (R, t) world-to-camera (P3P.h family)."""
    xn = np.linalg.solve(K, np.concatenate([uv, np.ones((len(uv), 1))], 1).T).T
    A = []
    for i in range(len(X)):
        x, y = xn[i, 0] / xn[i, 2], xn[i, 1] / xn[i, 2]
        Xi = np.concatenate([X[i], [1.0]])
        A.append(np.concatenate([Xi, np.zeros(4), -x * Xi]))
        A.append(np.concatenate([np.zeros(4), Xi, -y * Xi]))
    _, _, Vt = np.linalg.svd(np.stack(A))
    P = Vt[-1].reshape(3, 4)
    # resolve the global sign by cheirality (points in front of the camera)
    depths = X @ P[2, :3] + P[2, 3]
    if np.median(depths) < 0:
        P = -P
    Rt = P[:, :3]
    U, S, Vt2 = np.linalg.svd(Rt)
    R = U @ Vt2
    if np.linalg.det(R) < 0:
        R = -R
        P = -P
    t = P[:, 3] / np.mean(S)
    return R, t


def p3p_grunert(X: np.ndarray, uv: np.ndarray, K: np.ndarray):
    """P3P via Grunert's quartic (reference P3P.h): up to 4 (R, t) candidates
    from 3 correspondences."""
    xn = np.linalg.solve(K, np.concatenate([uv, np.ones((3, 1))], 1).T).T
    f = xn / np.linalg.norm(xn, axis=1, keepdims=True)
    cos_ab = f[0] @ f[1]
    cos_ac = f[0] @ f[2]
    cos_bc = f[1] @ f[2]
    Rab = np.linalg.norm(X[0] - X[1])
    Rac = np.linalg.norm(X[0] - X[2])
    Rbc = np.linalg.norm(X[1] - X[2])
    if min(Rab, Rac, Rbc) < 1e-12:
        return []
    K1 = (Rbc / Rac) ** 2
    K2 = (Rbc / Rab) ** 2
    # Grunert quartic coefficients (Haralick et al. 1994)
    G4 = (K1 * K2 - K1 - K2) ** 2 - 4 * K1 * K2 * cos_bc**2
    G3 = 4 * (K1 * K2 - K1 - K2) * K2 * (1 - K1) * cos_ab + 4 * K1 * cos_bc * (
        (K1 * K2 - K1 + K2) * cos_ac + 2 * K2 * cos_ab * cos_bc
    )
    G2 = (2 * K2 * (1 - K1) * cos_ab) ** 2 + 2 * (K1 * K2 - K1 - K2) * (
        K1 * K2 + K1 - K2
    ) + 4 * K1 * (
        (K1 - K2) * cos_bc**2 + K1 * (1 - K2) * cos_ac**2 - 2 * (1 + K1) * K2 * cos_ab * cos_ac * cos_bc
    )
    G1 = 4 * (K1 * K2 + K1 - K2) * K2 * (1 - K1) * cos_ab + 4 * K1 * (
        (K1 * K2 - K1 + K2) * cos_ac * cos_bc + 2 * K1 * K2 * cos_ab * cos_ac**2
    )
    G0 = (K1 * K2 + K1 - K2) ** 2 - 4 * K1**2 * K2 * cos_ac**2
    sols = []
    for x in poly_roots(np.array([G4, G3, G2, G1, G0])):
        if abs(x.imag) > 1e-8 or x.real <= 0:
            continue
        x = x.real
        a = Rab / np.sqrt(x**2 - 2 * x * cos_ab + 1)
        b = a * x
        # solve for c via the law of cosines in triangle (a, c, Rac)
        disc = cos_ac**2 - 1 + (Rac / a) ** 2
        if disc < 0:
            continue
        for c in (a * (cos_ac + np.sqrt(disc)), a * (cos_ac - np.sqrt(disc))):
            if c <= 0:
                continue
            if abs(b**2 + c**2 - 2 * b * c * cos_bc - Rbc**2) > 1e-6 * Rbc**2:
                continue
            pc = np.stack([a * f[0], b * f[1], c * f[2]])  # points in cam frame
            R, t, _ = _kabsch_rt(X, pc)
            sols.append((R, t))
    return sols


def _kabsch_rt(A: np.ndarray, B: np.ndarray):
    """Rigid transform R, t with B ~ R A + t (reference Kabsch.h)."""
    mu_a, mu_b = A.mean(0), B.mean(0)
    H = (A - mu_a).T @ (B - mu_b)
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_b - R @ mu_a
    rmse = np.sqrt(np.mean(np.sum((B - (A @ R.T + t)) ** 2, axis=1)))
    return R, t, rmse


def kabsch(A: np.ndarray, B: np.ndarray):
    """Public Kabsch alignment (R, t, rmse) with B ~ R A + t."""
    return _kabsch_rt(A, B)


# -------------------------------------------------------------- homography
def homography_dlt(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """DLT homography x2 ~ H x1 (reference Homography.h)."""
    A = []
    for i in range(len(x1)):
        x, y = x1[i]
        u, v = x2[i]
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A, float))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


# ------------------------------------------------------------ 5-point essential

# monomial ordering for the Stewenius action-matrix method: 10 cubic
# monomials first, then the quotient-ring basis [x^2 xy xz y^2 yz z^2 x y z 1]
_MONO_IDX = {
    (3, 0, 0): 0, (2, 1, 0): 1, (2, 0, 1): 2, (1, 2, 0): 3, (1, 1, 1): 4,
    (1, 0, 2): 5, (0, 3, 0): 6, (0, 2, 1): 7, (0, 1, 2): 8, (0, 0, 3): 9,
    (2, 0, 0): 10, (1, 1, 0): 11, (1, 0, 1): 12, (0, 2, 0): 13,
    (0, 1, 1): 14, (0, 0, 2): 15, (1, 0, 0): 16, (0, 1, 0): 17,
    (0, 0, 1): 18, (0, 0, 0): 19,
}


def _pmul(p, q):
    """Multiply sparse polynomials {exponent_tuple: coeff} in (x, y, z)."""
    out = {}
    for ea, ca in p.items():
        for eb, cb in q.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            out[e] = out.get(e, 0.0) + ca * cb
    return out


def _padd(*ps):
    out = {}
    for p in ps:
        for e, c in p.items():
            out[e] = out.get(e, 0.0) + c
    return out


def _pscale(p, s):
    return {e: c * s for e, c in p.items()}


def essential_5pt(x1: np.ndarray, x2: np.ndarray) -> list:
    """Nister/Stewenius 5-point essential matrix solver.

    ``x1``, ``x2``: (5, 2) NORMALIZED image coordinates (K^-1 applied) of
    corresponding points in the two views.  Returns a list of up to 10 real
    essential matrix candidates (unit Frobenius norm), satisfying
    x2h^T E x1h = 0, det(E) = 0, and 2 E E^T E - tr(E E^T) E = 0.

    Capability parity with the reference's Grobner-basis two-view solver
    (include/geometry/TwoView.h:51, CFivePoint_EssentialSolver_Grobner);
    the implementation here is the standard action-matrix construction.
    """
    x1h = np.concatenate([x1, np.ones((5, 1))], axis=1)
    x2h = np.concatenate([x2, np.ones((5, 1))], axis=1)
    Q = np.stack([np.kron(x2h[i], x1h[i]) for i in range(5)])  # (5, 9)
    _, _, Vt = np.linalg.svd(Q)
    basisE = Vt[-4:][::-1]  # X, Y, Z, W rows (9,) each
    X, Y, Z, W = (b.reshape(3, 3) for b in basisE)

    # symbolic E(x, y, z) = x X + y Y + z Z + W; entries are degree-1 polys
    Ep = [[{(1, 0, 0): X[i, j], (0, 1, 0): Y[i, j],
            (0, 0, 1): Z[i, j], (0, 0, 0): W[i, j]} for j in range(3)]
          for i in range(3)]

    def pe(i, j):
        return Ep[i][j]

    # det(E) = 0
    det = _padd(
        _pmul(pe(0, 0), _padd(_pmul(pe(1, 1), pe(2, 2)), _pscale(_pmul(pe(1, 2), pe(2, 1)), -1.0))),
        _pscale(_pmul(pe(0, 1), _padd(_pmul(pe(1, 0), pe(2, 2)), _pscale(_pmul(pe(1, 2), pe(2, 0)), -1.0))), -1.0),
        _pmul(pe(0, 2), _padd(_pmul(pe(1, 0), pe(2, 1)), _pscale(_pmul(pe(1, 1), pe(2, 0)), -1.0))),
    )

    # trace constraint: 2 E E^T E - tr(E E^T) E = 0 (9 cubic equations)
    EEt = [[_padd(*[_pmul(pe(i, k), pe(j, k)) for k in range(3)])
            for j in range(3)] for i in range(3)]
    tr = _padd(EEt[0][0], EEt[1][1], EEt[2][2])
    eqs = [det]
    for i in range(3):
        for j in range(3):
            term = _padd(*[_pmul(EEt[i][k], pe(k, j)) for k in range(3)])
            eqs.append(_padd(_pscale(term, 2.0), _pscale(_pmul(tr, pe(i, j)), -1.0)))

    A = np.zeros((10, 20))
    for r, eq in enumerate(eqs):
        for e, c in eq.items():
            A[r, _MONO_IDX[e]] = c

    # Gauss-Jordan: A -> [I | M]
    try:
        M = np.linalg.solve(A[:, :10], A[:, 10:])
    except np.linalg.LinAlgError:
        return []

    # action matrix for multiplication by x on the quotient-ring basis
    At = np.zeros((10, 10))
    At[0:6] = -M[0:6]  # x*(x^2, xy, xz, y^2, yz, z^2) are cubic monomials
    At[6, 0] = 1.0  # x*x = x^2
    At[7, 1] = 1.0  # x*y = xy
    At[8, 2] = 1.0  # x*z = xz
    At[9, 6] = 1.0  # x*1 = x
    evals, evecs = np.linalg.eig(At)

    out = []
    for k in range(10):
        if abs(evals[k].imag) > 1e-8:
            continue
        v = evecs[:, k].real
        if abs(v[9]) < 1e-12:
            continue
        x, y, z = v[6] / v[9], v[7] / v[9], v[8] / v[9]
        E = x * X + y * Y + z * Z + W
        n = np.linalg.norm(E)
        if n > 1e-12 and np.isfinite(n):
            out.append(E / n)
    return out


def structure_average(observations: np.ndarray) -> np.ndarray:
    """Average rigid 3D structure from multiple complete observations.

    ``observations``: (n_obs, n_points, 3) — each observation is the same
    rigid point structure in its own coordinate frame.  Kabsch-aligns every
    observation to the first and averages (reference
    include/geometry/StructAverage.h: CAverage_RigidStructure::Calculate).
    """
    obs = np.asarray(observations, float)
    n_obs = obs.shape[0]
    acc = obs[0].copy()
    for i in range(1, n_obs):
        R, t, _ = _kabsch_rt(obs[i], obs[0])
        acc += obs[i] @ R.T + t
    return acc / n_obs
