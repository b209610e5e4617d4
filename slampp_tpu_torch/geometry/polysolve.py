"""Closed-form polynomial solvers, host NumPy (counterpart of
``slampp_tpu/geometry/polysolve.py``, the port's own copy).

Capability parity with the reference's geometry polynomial module
(include/geometry/PolySolve.h: CQuadraticEq :236, CCubicEq :372,
CQuarticEq :646) — stable closed-form real-root solvers for degree 2-4 with
derivative-based polishing, used by minimal solvers (P3P, two-view).
"""

from __future__ import annotations

import numpy as np


def solve_quadratic(a: float, b: float, c: float) -> np.ndarray:
    """Real roots of a x^2 + b x + c (citardauq formulation: avoids
    cancellation when b^2 >> 4ac)."""
    if a == 0.0:
        return np.array([-c / b]) if b != 0.0 else np.zeros(0)
    disc = b * b - 4.0 * a * c
    if disc < 0.0:
        return np.zeros(0)
    sq = np.sqrt(disc)
    q = -0.5 * (b + np.copysign(sq, b)) if b != 0.0 else -0.5 * sq
    roots = [q / a]
    if q != 0.0:
        roots.append(c / q)
    return np.unique(np.array(roots))


def solve_cubic(a: float, b: float, c: float, d: float) -> np.ndarray:
    """Real roots of a x^3 + b x^2 + c x + d (trigonometric/Cardano split,
    reference CCubicEq semantics)."""
    if a == 0.0:
        return solve_quadratic(b, c, d)
    b, c, d = b / a, c / a, d / a
    p = c - b * b / 3.0
    q = 2.0 * b**3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    if disc > 0.0:  # one real root (Cardano)
        sq = np.sqrt(disc)
        u = np.cbrt(-q / 2.0 + sq)
        v = np.cbrt(-q / 2.0 - sq)
        roots = np.array([u + v + shift])
    elif abs(disc) < 1e-300:
        if abs(q) < 1e-300:
            roots = np.array([shift])
        else:
            u = np.cbrt(-q / 2.0)
            roots = np.array([2.0 * u + shift, -u + shift])
    else:  # three real roots (trigonometric)
        r = np.sqrt(-(p / 3.0) ** 3)
        phi = np.arccos(np.clip(-q / (2.0 * r), -1.0, 1.0))
        t = 2.0 * np.cbrt(r)
        roots = t * np.cos((phi + 2.0 * np.pi * np.arange(3)) / 3.0) + shift
    return _polish(np.array([1.0, b, c, d]), np.unique(roots))


def solve_quartic(a: float, b: float, c: float, d: float, e: float) -> np.ndarray:
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e (Ferrari resolvent,
    reference CQuarticEq semantics)."""
    if a == 0.0:
        return solve_cubic(b, c, d, e)
    b, c, d, e = b / a, c / a, d / a, e / a
    # depressed quartic y^4 + p y^2 + q y + r, x = y - b/4
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b**3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b**4 / 256.0
    shift = -b / 4.0
    if abs(q) < 1e-13:  # biquadratic
        ys = solve_quadratic(1.0, p, r)
        roots = []
        for y in ys:
            if y >= 0.0:
                roots += [np.sqrt(y) + shift, -np.sqrt(y) + shift]
        return _polish(np.array([1.0, b, c, d, e]), np.unique(np.array(roots)))
    # resolvent cubic: z^3 + 2 p z^2 + (p^2 - 4 r) z - q^2 = 0, take z > 0
    zs = solve_cubic(1.0, 2.0 * p, p * p - 4.0 * r, -q * q)
    zs = zs[zs > 1e-13]
    if len(zs) == 0:
        return np.zeros(0)
    z = float(np.max(zs))
    s = np.sqrt(z)
    u = (p + z - q / s) / 2.0
    v = (p + z + q / s) / 2.0
    # (y^2 + s y + u)(y^2 - s y + v): roots -s/2 +- sqrt(z/4 - u) and
    # +s/2 +- sqrt(z/4 - v)
    roots = []
    for sgn, w in ((-1.0, u), (+1.0, v)):
        disc = z / 4.0 - w
        if disc >= 0.0:
            sq = np.sqrt(disc)
            roots += [sgn * s / 2.0 + sq + shift, sgn * s / 2.0 - sq + shift]
    return _polish(np.array([1.0, b, c, d, e]), np.unique(np.array(roots)))


def _polish(coeffs: np.ndarray, roots: np.ndarray, iters: int = 2) -> np.ndarray:
    """Newton polishing against the monic polynomial (the reference polishes
    roots with the derivative, PolySolve.h CQuadraticFunction::f_Derivative)."""
    der = np.polyder(coeffs)
    for _ in range(iters):
        f = np.polyval(coeffs, roots)
        fp = np.polyval(der, roots)
        step = np.where(np.abs(fp) > 1e-300, f / np.where(fp == 0, 1.0, fp), 0.0)
        roots = roots - step
    return roots
