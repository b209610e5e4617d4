"""The port's multi-view geometry module (slampp_tpu_torch/geometry/mvg.py
and polysolve.py, its own NumPy copies) against synthetic ground truth,
every test of tests/test_mvg.py with its tolerances, and against the JAX
package's module on the same inputs (the same NumPy code: equal to 1e-12)."""

import numpy as np
import pytest

from slampp_tpu.geometry import mvg as jax_mvg
from slampp_tpu.geometry import polysolve as jax_poly
from slampp_tpu_torch.geometry import mvg
from slampp_tpu_torch.geometry import polysolve


def _scene(seed=0, n=30):
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = rng.normal(0, 1.0, (n, 3)) + np.array([0, 0, 6.0])
    # camera 2 pose (world-to-cam2)
    aa = rng.normal(0, 0.2, 3)
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(aa).as_matrix()
    t = np.array([0.8, -0.1, 0.1])

    def proj(P, X):
        x = (X @ P[:, :3].T) + P[:, 3]
        return x[:, :2] / x[:, 2:3]

    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])
    x1 = proj(P1, X)
    x2 = proj(P2, X)
    return K, X, R, t, P1, P2, x1, x2


def test_triangulation_exact():
    K, X, R, t, P1, P2, x1, x2 = _scene()
    for i in range(10):
        Xi = mvg.triangulate_dlt(P1, P2, x1[i], x2[i])
        np.testing.assert_allclose(Xi, X[i], atol=1e-8)


def test_fundamental_8pt_epipolar_constraint():
    K, X, R, t, P1, P2, x1, x2 = _scene()
    F = mvg.fundamental_8pt(x1, x2)
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    res = np.abs(np.einsum("ni,ij,nj->n", h2, F, h1))
    assert res.max() < 1e-6


def test_fundamental_7pt_contains_truth():
    K, X, R, t, P1, P2, x1, x2 = _scene(seed=3)
    sols = mvg.fundamental_7pt(x1[:7], x2[:7])
    assert len(sols) >= 1
    h1 = np.concatenate([x1[:7], np.ones((7, 1))], 1)
    h2 = np.concatenate([x2[:7], np.ones((7, 1))], 1)
    best = min(
        np.abs(np.einsum("ni,ij,nj->n", h2, F, h1)).max() for F in sols
    )
    assert best < 1e-6


def test_pose_from_essential_recovers_rotation():
    K, X, R, t, P1, P2, x1, x2 = _scene(seed=1)
    F = mvg.fundamental_8pt(x1, x2)
    E = mvg.essential_from_fundamental(F, K, K)
    R_est, t_est = mvg.pose_from_essential(E, x1, x2, K, K)
    np.testing.assert_allclose(R_est, R, atol=1e-6)
    t_dir = t / np.linalg.norm(t)
    t_est_dir = t_est / np.linalg.norm(t_est)
    np.testing.assert_allclose(np.abs(t_dir @ t_est_dir), 1.0, atol=1e-6)


def test_pnp_dlt():
    K, X, R, t, P1, P2, x1, x2 = _scene(seed=2)
    R_est, t_est = mvg.pnp_dlt(X, x2, K)
    np.testing.assert_allclose(R_est, R, atol=1e-6)
    np.testing.assert_allclose(t_est, t, atol=1e-6)


def test_p3p_contains_truth():
    K, X, R, t, P1, P2, x1, x2 = _scene(seed=4)
    sols = mvg.p3p_grunert(X[:3], x2[:3], K)
    assert len(sols) >= 1
    errs = [np.linalg.norm(Rs - R) + np.linalg.norm(ts - t) for Rs, ts in sols]
    assert min(errs) < 1e-6


def test_kabsch_alignment():
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (20, 3))
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.2, -0.1, 0.4]).as_matrix()
    t = np.array([1.0, 2.0, -0.5])
    B = A @ R.T + t
    R_est, t_est, rmse = mvg.kabsch(A, B)
    assert rmse < 1e-10
    np.testing.assert_allclose(R_est, R, atol=1e-10)


def test_homography_dlt():
    rng = np.random.default_rng(6)
    H = np.array([[1.1, 0.02, 5.0], [-0.01, 0.95, -3.0], [1e-4, -2e-4, 1.0]])
    x1 = rng.uniform(0, 640, (12, 2))
    h1 = np.concatenate([x1, np.ones((12, 1))], 1) @ H.T
    x2 = h1[:, :2] / h1[:, 2:3]
    H_est = mvg.homography_dlt(x1, x2)
    np.testing.assert_allclose(H_est, H / H[2, 2], atol=1e-8)


def test_distortion_roundtrip():
    intr = np.array([500.0, 500.0, 320.0, 240.0, 0.0005])
    uv = np.array([[100.0, 50.0], [400.0, 300.0]])
    d = mvg.distort_radial(uv, intr)
    u = mvg.undistort_radial(d, intr, iters=20)
    np.testing.assert_allclose(u, uv, atol=1e-8)


def test_essential_5pt_recovers_true_geometry():
    """Stewenius 5-point essential: the true E must be among the candidates
    and all candidates must satisfy the epipolar + essential constraints
    (reference TwoView.h:51 Grobner solver capability)."""
    essential_5pt = mvg.essential_5pt

    rng = np.random.default_rng(3)
    # random two-view geometry
    aa = 0.2 * rng.normal(size=3)
    th = np.linalg.norm(aa)
    k = aa / th
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
    t = np.array([1.0, 0.2, -0.1])
    t /= np.linalg.norm(t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = tx @ R
    E_true /= np.linalg.norm(E_true)

    X = rng.normal(0, 1.0, (5, 3)) + np.array([0, 0, 4.0])
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:3]

    cands = essential_5pt(x1, x2)
    assert len(cands) >= 1
    x1h = np.concatenate([x1, np.ones((5, 1))], 1)
    x2h = np.concatenate([x2, np.ones((5, 1))], 1)
    best = np.inf
    for E in cands:
        # constraints hold for every candidate
        assert abs(np.linalg.det(E)) < 1e-6
        EEt = E @ E.T
        assert np.abs(2 * EEt @ E - np.trace(EEt) * E).max() < 1e-6
        resid = np.abs(np.einsum("ni,ij,nj->n", x2h, E, x1h)).max()
        assert resid < 1e-6
        best = min(best, min(np.abs(E - E_true).max(), np.abs(E + E_true).max()))
    assert best < 1e-6, f"true E not among candidates (best diff {best})"


def test_polysolve_closed_form():
    solve_cubic, solve_quadratic, solve_quartic = (
        polysolve.solve_cubic, polysolve.solve_quadratic, polysolve.solve_quartic)

    np.testing.assert_allclose(
        np.sort(solve_quadratic(2.0, -10.0, 12.0)), [2.0, 3.0], atol=1e-12)
    # x^3 - 6x^2 + 11x - 6 = (x-1)(x-2)(x-3)
    np.testing.assert_allclose(
        np.sort(solve_cubic(1.0, -6.0, 11.0, -6.0)), [1.0, 2.0, 3.0], atol=1e-9)
    # single real root
    r = solve_cubic(1.0, 0.0, 1.0, -2.0)
    np.testing.assert_allclose(np.polyval([1, 0, 1, -2], r), 0.0, atol=1e-9)
    # quartic (x-1)(x+1)(x-2)(x+3)
    c = np.poly([1.0, -1.0, 2.0, -3.0])
    np.testing.assert_allclose(
        np.sort(solve_quartic(*c)), [-3.0, -1.0, 1.0, 2.0], atol=1e-8)
    # random quartics vs numpy roots
    rng = np.random.default_rng(0)
    for _ in range(50):
        c = rng.normal(size=5)
        ours = np.sort(solve_quartic(*c))
        np_real = np.sort([r.real for r in np.roots(c) if abs(r.imag) < 1e-9])
        assert len(ours) == len(np_real), (c, ours, np_real)
        if len(ours):
            np.testing.assert_allclose(ours, np_real, atol=1e-6)


def test_structure_average():
    structure_average = mvg.structure_average

    rng = np.random.default_rng(1)
    P = rng.normal(size=(12, 3))
    obs = []
    for i in range(4):
        aa = 0.3 * rng.normal(size=3)
        th = np.linalg.norm(aa)
        k = aa / th
        K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
        t = rng.normal(size=3)
        noise = 0.01 * rng.normal(size=P.shape)
        obs.append((P + noise) @ R.T + t)
    avg = structure_average(np.stack(obs))
    # the average is in observation-0's frame; residual noise shrinks ~1/sqrt(4)
    rms = np.sqrt(np.mean(np.sum((avg - obs[0]) ** 2, axis=1)))
    assert rms < 0.02


def _jax_cases():
    """(name, args) of every public function on the scenes above."""
    K, X, R, t, P1, P2, x1, x2 = _scene(seed=3)
    F = mvg.fundamental_8pt(x1, x2)
    intr = np.array([500.0, 500.0, 320.0, 240.0, 0.0005])
    rng = np.random.default_rng(7)
    return [
        ("poly_roots", (np.array([1.0, -6.0, 11.0, -6.0]),)),
        ("distort_radial", (x1, intr)),
        ("undistort_radial", (x1, intr)),
        ("triangulate_dlt", (P1, P2, x1[0], x2[0])),
        ("fundamental_8pt", (x1, x2)),
        ("fundamental_7pt", (x1[:7], x2[:7])),
        ("essential_from_fundamental", (F, K, K)),
        ("pose_from_essential", (mvg.essential_from_fundamental(F, K, K), x1, x2, K, K)),
        ("pnp_dlt", (X, x2, K)),
        ("p3p_grunert", (X[:3], x2[:3], K)),
        ("kabsch", (X, X @ R.T + t)),
        ("homography_dlt", (x1[:12], x2[:12])),
        ("essential_5pt", (x1[:5] / 500.0, x2[:5] / 500.0)),
        ("structure_average", (np.stack([X + 0.01 * rng.normal(size=X.shape) for _ in range(3)]),)),
    ]


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [x for item in v for x in _flat(item)]
    return [np.asarray(v, float)]


@pytest.mark.parametrize("name", [c[0] for c in _jax_cases()])
def test_matches_jax_package(name):
    """Each function of the port's copy gives the JAX package's result on
    the same inputs (both NumPy: within 1e-12)."""
    args = dict(_jax_cases())[name]
    got, want = _flat(getattr(mvg, name)(*args)), _flat(getattr(jax_mvg, name)(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_polysolve_matches_jax_package():
    rng = np.random.default_rng(2)
    for _ in range(20):
        c = rng.normal(size=5)
        for fn, k in (("solve_quadratic", 3), ("solve_cubic", 4), ("solve_quartic", 5)):
            np.testing.assert_allclose(getattr(polysolve, fn)(*c[:k]),
                                       getattr(jax_poly, fn)(*c[:k]), rtol=1e-12, atol=1e-12)
