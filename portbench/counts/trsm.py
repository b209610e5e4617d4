"""Triangular solve of K (M, M) triangles against (K, M, S) right-hand sides
(``trsm_lower_batched``, ``trsm_lower_t_batched``): M^2 S operations per
matrix (its M^2 S / 2 multiply-adds); the triangle read once, the
right-hand sides read once and the output written once (a frozen copy of
``chip_smoke._bound``'s count)."""

from portbench.roofline import ITEM


def work(shapes, dtype):
    K, M = shapes[0][0], shapes[0][1]
    S = shapes[1][2]
    tri = M * (M + 1) // 2
    return K * M * M * S, K * (tri + 2 * M * S) * ITEM[dtype]
