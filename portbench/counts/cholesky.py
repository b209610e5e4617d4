"""Cholesky of K (M, M) matrices (``chol_batched``): M^3 / 3 operations per
matrix; the lower triangle read once and the full matrix written once
(a frozen copy of ``chip_smoke._bound``'s count)."""

from portbench.roofline import ITEM


def work(shapes, dtype):
    K, M = shapes[0][0], shapes[0][1]
    tri = M * (M + 1) // 2
    return K * M ** 3 / 3, K * (tri + M * M) * ITEM[dtype]
