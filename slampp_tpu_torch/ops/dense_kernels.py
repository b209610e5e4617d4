"""Batched dense SPD factorization and triangular solves — the compute core
of the partitioned (v3) linear solver.

Counterpart of ``slampp_tpu/ops/dense_kernels.py``.  Each public function
dispatches on the device of its input:

* a CPU tensor takes the function's plain PyTorch version (``*_plain``);
* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/dense_kernels.cu``, built at first use by ``ops/_cuda.py``) or
  raises — on a build failure, a refused launch, or an input the kernel does
  not take (dtype other than float32/float64, non-contiguous, M not a
  multiple of ``PB``, data not 16-byte aligned).  There is no fallback from
  CUDA to the plain version.

Both precisions reach the kernel on the card, including the exact f64 mode
of the solver; the JAX package sent f64 to its lax reference only because
f64 is emulated on a TPU.

``launches`` counts kernel launches per public function, so that a run can
show its main path went through the kernels, and ``launch_shapes`` holds
the distinct (function, K, M, S, dtype) launched (S is None for the
Cholesky); ``reset_launches`` clears both.
"""

from __future__ import annotations

import ctypes

import torch

PB = 8  # the callers' padding grid: M is a multiple of PB

launches = {"chol_batched": 0, "trsm_lower_batched": 0, "trsm_lower_t_batched": 0}
launch_shapes: set = set()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _chol_value(D: torch.Tensor, clamp: float) -> torch.Tensor:
    """Unrolled lower Cholesky of (..., n, n) blocks with FROZEN failed
    pivots (JAX ``_chol_value``, dense_kernels.py:69): a pivot not above
    ``clamp`` is replaced by 1e20, so its column's multipliers go to ~0
    instead of being amplified.  Same operation order as the JAX helper."""
    n = D.shape[-1]
    L = torch.zeros_like(D)
    for j in range(n):
        col = D[..., j:, j]  # rows j.. of column j
        for k in range(j):
            col = col - L[..., j:, k] * L[..., j : j + 1, k]
        d = col[..., 0]
        d = torch.where(d > clamp, d, torch.full_like(d, 1e20))
        ljj = torch.sqrt(d)
        L[..., j, j] = ljj
        L[..., j + 1 :, j] = col[..., 1:] * (1.0 / ljj)[..., None]
    return L


def _trsm_right_T_value(C: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """X = C @ L^-T for (..., M, n) C and (..., n, n) lower L."""
    n = L.shape[-1]
    X = []
    for j in range(n):
        v = C[..., :, j]
        for k in range(j):
            v = v - X[k] * L[..., j, k, None]
        X.append(v / L[..., j, j, None])
    return torch.stack(X, -1)


def chol_batched_plain(A: torch.Tensor, clamp: float = 1e-8) -> torch.Tensor:
    """Right-looking panel Cholesky over PB-wide column panels — the port of
    JAX's ``_chol_reference`` (dense_kernels.py:345), pivot freezing and
    all.  ``torch.linalg.cholesky`` is not a substitute: it fails where this
    freezes a pivot."""
    K, M, _ = A.shape
    O = A.clone()
    for j0 in range(0, M, PB):
        j1 = j0 + PB
        Ljj = _chol_value(O[:, j0:j1, j0:j1], clamp)
        W = _trsm_right_T_value(O[:, j1:, j0:j1], Ljj)  # rows below the panel
        O[:, :, j0:j1] = 0.0
        O[:, j0:j1, j0:j1] = Ljj
        O[:, j1:, j0:j1] = W
        O[:, j1:, j1:] -= W @ W.transpose(1, 2)
    return torch.tril(O)


def trsm_lower_batched_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def trsm_lower_t_batched_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L.transpose(1, 2), B, upper=True)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _cuda_args(name: str, *ts: torch.Tensor):
    """Validate CUDA operands for a kernel; returns the dtype suffix."""
    A = ts[0]
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    if A.dtype not in _SUFFIX:
        raise TypeError(f"{name}: unsupported dtype {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[1] % PB:
        raise ValueError(
            f"{name}: need (K, M, M) with M a multiple of {PB}, got {tuple(A.shape)}"
        )
    K, M = A.shape[0], A.shape[1]
    for t in ts:
        if t.device != A.device or t.dtype != A.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:  # the kernels' bulk copies need 16-byte aligned rows
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    if len(ts) > 1:
        B = ts[1]
        if B.dim() != 3 or B.shape[0] != K or B.shape[1] != M or B.shape[2] < 1:
            raise ValueError(f"{name}: need B of shape ({K}, {M}, S), got {tuple(B.shape)}")
    return _SUFFIX[A.dtype]


def _launch(name: str, symbol: str, out: torch.Tensor, shape: tuple, *args) -> None:
    """Launch ``symbol`` and count it under ``name``; ``shape`` is the call's
    (K, M, S)."""
    from slampp_tpu_torch.ops import _cuda

    lib = _cuda.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _cuda.check(lib, getattr(lib, symbol)(*args, stream), name)
    launches[name] += 1
    launch_shapes.add((name, *shape, str(out.dtype).split(".")[1]))


_chol_ws: dict = {}  # (device index, dtype, K, M) -> workspace bytes of the kernel's plan


def _chol_workspace(dtype: torch.dtype, K: int, M: int, device: torch.device) -> int:
    """Bytes of scratch the Cholesky kernel's plan for (K, M) needs on
    ``device`` (the large form's tile counters and inverted diagonal tiles;
    0 for the one-CTA forms), from the kernel's own plan, kept per shape."""
    key = (device.index, dtype, K, M)
    if key not in _chol_ws:
        from slampp_tpu_torch.ops import _cuda

        lib = _cuda.load()
        out = ctypes.c_longlong(0)
        with torch.cuda.device(device):
            _cuda.check(lib, lib.slampp_chol_workspace(int(dtype == torch.float64), K, M,
                                                       ctypes.byref(out)), "chol_batched")
        _chol_ws[key] = out.value
    return _chol_ws[key]


def chol_batched(A: torch.Tensor, clamp: float = 1e-8) -> torch.Tensor:
    """Batched lower Cholesky of (K, M, M) SPD matrices (pivot-frozen, upper
    triangle zeroed).  M must be a multiple of PB (pad with identity)."""
    if A.device.type == "cpu":
        return chol_batched_plain(A, clamp)
    sfx = _cuda_args("chol_batched", A)
    K, M, _ = A.shape
    out = torch.empty_like(A)
    if K:
        nbytes = _chol_workspace(A.dtype, K, M, A.device)
        ws = torch.empty(nbytes, dtype=torch.uint8, device=A.device) if nbytes else None
        _launch("chol_batched", f"slampp_chol_{sfx}", out, (K, M, None),
                A.data_ptr(), out.data_ptr(), K, M, float(clamp),
                None if ws is None else ws.data_ptr())
    return out


def chol_resident_max_m(dtype: torch.dtype, device="cuda") -> int:
    """The largest M at which the Cholesky kernel keeps the matrix resident
    in shared memory on ``device`` (a larger M streams it through the
    output buffer, or takes the large form: ``chol_form``), from the
    kernel's own plan."""
    from slampp_tpu_torch.ops import _cuda

    lib = _cuda.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _cuda.check(lib, lib.slampp_chol_resident_max(int(dtype == torch.float64),
                                                      ctypes.byref(out)), "chol_resident_max_m")
    return out.value


CHOL_FORMS = ("resident", "streaming", "large")


def chol_form(dtype: torch.dtype, K: int, M: int, device="cuda") -> str:
    """The form the Cholesky kernel takes for K (M, M) matrices of ``dtype``
    on ``device``: "resident" (one CTA per matrix, the matrix in shared
    memory), "streaming" (one CTA per matrix, the factor formed in the
    output) or "large" (every SM on each matrix: tiles on a ticketed task
    graph), from the kernel's own plan."""
    from slampp_tpu_torch.ops import _cuda

    lib = _cuda.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _cuda.check(lib, lib.slampp_chol_form(int(dtype == torch.float64), K, M,
                                              ctypes.byref(out)), "chol_form")
    return CHOL_FORMS[out.value]


TRSM_FORMS = ("cluster", "separator", "columns")


def trsm_form(dtype: torch.dtype, K: int, M: int, S: int, bwd: bool, device="cuda") -> str:
    """The form the triangular-solve kernels take for K (M, M) matrices and
    (K, M, S) right-hand sides of ``dtype`` on ``device``: "cluster" (a
    thread-block cluster per matrix and column groups, L resident in shared
    memory), "separator" (every SM on a wavefront of 32-row blocks through
    global memory) or "columns" (a CTA per matrix and 32 columns), from the
    kernels' own plan."""
    from slampp_tpu_torch.ops import _cuda

    lib = _cuda.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _cuda.check(lib, lib.slampp_trsm_form(int(dtype == torch.float64), int(bool(bwd)), K, M, S,
                                              ctypes.byref(out)), "trsm_form")
    return TRSM_FORMS[out.value]


def _trsm(name: str, kind: str, L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    sfx = _cuda_args(name, L, B)
    K, M, _ = L.shape
    S = B.shape[2]
    out = torch.empty_like(B)
    if K:
        # the separator form's ticket counter and per-(chain, block) flags
        ws = torch.empty(1 + K * -(-S // 8) * -(-M // 32), dtype=torch.int32, device=B.device)
        _launch(name, f"slampp_trsm_{kind}_{sfx}", out, (K, M, S),
                L.data_ptr(), B.data_ptr(), out.data_ptr(), K, M, S, ws.data_ptr())
    return out


def trsm_lower_batched(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched X = L^-1 B; L (K, M, M) lower from chol_batched, B (K, M, S)."""
    if L.device.type == "cpu":
        return trsm_lower_batched_plain(L, B)
    return _trsm("trsm_lower_batched", "fwd", L, B)


def trsm_lower_t_batched(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched X = L^-T B; same layout as trsm_lower_batched."""
    if L.device.type == "cpu":
        return trsm_lower_t_batched_plain(L, B)
    return _trsm("trsm_lower_t_batched", "bwd", L, B)
