"""Geometry module tour (counterpart of ``examples/geometry_example.py``;
reference src/geometry_example, 672 LoC over include/geometry/):
minimal-solver initialization feeding BA: P3P camera resection, 8-point
fundamental matrix, triangulation and Kabsch alignment.  Host NumPy
(``geometry/mvg.py``); ``--device`` is taken for the examples' common
interface and needs no card.
"""

import numpy as np

from slampp_tpu_torch.examples import parse_args
from slampp_tpu_torch.geometry import mvg


def main(argv=None):
    parse_args(argv, __doc__.splitlines()[0], host_only=True)
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])

    # ground-truth camera
    aa = np.array([0.1, -0.2, 0.05])
    th = np.linalg.norm(aa)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
    t = np.array([0.2, -0.1, 4.0])

    X = rng.normal(0, 1.0, (24, 3))
    x_cam = X @ R.T + t
    uv = (x_cam[:, :2] / x_cam[:, 2:]) * 500.0 + np.array([320.0, 240.0])

    # --- P3P resection (Grunert) from 3 points + 1 disambiguator
    sols = mvg.p3p_grunert(X[:3], uv[:3], K)
    best = min(
        sols,
        key=lambda rt: np.linalg.norm((X[3] @ rt[0].T + rt[1])[:2] / (X[3] @ rt[0].T + rt[1])[2] * 500
                                      + np.array([320.0, 240.0]) - uv[3]),
    )
    print(f"P3P: {len(sols)} solutions; best rotation error "
          f"{np.linalg.norm(best[0] - R):.2e}, translation error {np.linalg.norm(best[1] - t):.2e}")

    # --- two-view: 8-point fundamental + essential -> relative pose
    R2 = np.eye(3)
    t2 = np.array([1.0, 0.0, 0.0])
    x2 = X @ R2.T + t2 + np.array([0, 0, 4.0])
    uv2 = (x2[:, :2] / x2[:, 2:]) * 500.0 + np.array([320.0, 240.0])
    F = mvg.fundamental_8pt(uv, uv2)
    errs = [abs(np.append(uv2[i], 1) @ F @ np.append(uv[i], 1)) /
            np.linalg.norm(F @ np.append(uv[i], 1)) for i in range(len(uv))]
    print(f"8-point F: median epipolar distance {np.median(errs):.2e} px")

    # --- triangulation round trip
    P1 = K @ np.hstack([R, t[:, None]])
    P2 = K @ np.hstack([R2, (t2 + np.array([0, 0, 4.0]))[:, None]])
    Xt = np.stack([mvg.triangulate_dlt(P1, P2, uv[i], uv2[i]) for i in range(8)])
    print(f"triangulation: max error {np.abs(Xt - X[:8]).max():.2e}")

    # --- Kabsch alignment
    Rk, tk, _rmse = mvg.kabsch(X, X @ R.T + t)
    print(f"Kabsch: rotation error {np.linalg.norm(Rk - R):.2e}, "
          f"translation error {np.linalg.norm(tk - t):.2e}")


if __name__ == "__main__":
    main()
