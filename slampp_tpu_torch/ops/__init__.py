"""Low-level batched kernels: segment reductions and the dense Cholesky /
triangular solves with their hand-written CUDA kernels."""
