"""Build and load the hand-written native code (``csrc/``): the CUDA
kernels (``dense_kernels.cu``, ``ba_kernels.cu``, ``sim3_kernels.cu`` and
``schur_kernels.cu``, with ``nvcc``, into one library) and the host
ordering (``slampp_native.cpp``, with the host C++ compiler;
core/ordering.py).

Each library is compiled at first use into a shared library with a plain
C interface under ``slampp_tpu_torch/_build/`` (one file per hash of its
sources and flags, so an edited source rebuilds), then bound through
``ctypes``.
Nothing here runs at import: the CPU tests import every module on machines
that have no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "dense_kernels.cu"
_BA_SOURCE = _PKG / "csrc" / "ba_kernels.cu"
_SIM3_SOURCE = _PKG / "csrc" / "sim3_kernels.cu"
_SCHUR_SOURCE = _PKG / "csrc" / "schur_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",  # optimize the kernels on every core
)

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # filled by load(): path, seconds, ptxas log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_shared(sources, compiler: str, flags, info: dict) -> Path:
    """``compiler flags -o <lib> sources`` into BUILD_DIR (``sources`` one
    path or several, the library named after the first), unless the library
    of these sources and flags is there already; ``info`` gets its path,
    the seconds the build took and the compiler's messages.  Raises when the
    compiler fails."""
    sources = [sources] if isinstance(sources, Path) else list(sources)
    src = b"".join(p.read_bytes() for p in sources)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{sources[0].stem}-{digest}.so"
    if out.exists():
        info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    info.update(path=str(out), seconds=time.perf_counter() - t0, log=proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_shared(
                (_SOURCE, _BA_SOURCE, _SIM3_SOURCE, _SCHUR_SOURCE), _nvcc(), NVCC_FLAGS,
                build_info)))
            ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"slampp_chol_{dt}")
                fn.argtypes = [ptr, ptr, i32, i32, f64, ptr, ptr]
                fn.restype = i32
                for kind in ("fwd", "bwd"):
                    fn = getattr(lib, f"slampp_trsm_{kind}_{dt}")
                    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
                    fn.restype = i32
            lib.slampp_chol_resident_max.argtypes = [i32, ctypes.POINTER(i32)]
            lib.slampp_chol_resident_max.restype = i32
            lib.slampp_chol_workspace.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
            lib.slampp_chol_workspace.restype = i32
            lib.slampp_chol_form.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
            lib.slampp_chol_form.restype = i32
            lib.slampp_trsm_form.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
            lib.slampp_trsm_form.restype = i32
            lib.slampp_p2c_workspace.argtypes = [i64, ctypes.POINTER(i64)]
            lib.slampp_p2c_workspace.restype = i32
            lib.slampp_p2c_linearize_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 8
            lib.slampp_p2c_linearize_f64.restype = i32
            lib.slampp_p2c_chi2_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 3
            lib.slampp_p2c_chi2_f64.restype = i32
            lib.slampp_sim3_g_workspace.argtypes = [i64, ctypes.POINTER(i64)]
            lib.slampp_sim3_g_workspace.restype = i32
            lib.slampp_sim3_g_terms_f64.argtypes = [ptr] * 7 + [i64] + [ptr] * 8
            lib.slampp_sim3_g_terms_f64.restype = i32
            lib.slampp_sim3_g_chi2_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 3
            lib.slampp_sim3_g_chi2_f64.restype = i32
            lib.slampp_slot_sums_f64.argtypes = [i32, i32] + [ptr] * 12 + [i32, i32, ptr, ptr]
            lib.slampp_slot_sums_f64.restype = i32
            lib.slampp_error_string.argtypes = [i32]
            lib.slampp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.slampp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def check_operands(name: str, operands) -> None:
    """Raise unless every (tensor, shape, dtype, alignment in bytes) row of
    ``operands`` is on the first one's CUDA device, of its shape,
    contiguous, of its dtype (else TypeError) and aligned."""
    dev = operands[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t, shape, dtype, align in operands:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices ({t.device}, {dev})")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name}: need {dtype}, got {t.dtype}")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: need {align}-byte aligned operands")


def launch_reduction(what: str, ws_symbol: str, symbol: str, device, m: int, operands,
                     outputs) -> None:
    """Launch the kernel entry point ``symbol(*operands, m, *outputs, ws,
    stream)`` on the current stream of ``device``, with a fresh workspace
    of the bytes ``ws_symbol(m)`` gives (the kernels' partial sums and their
    ticket counter); a None operand passes a null pointer.  Raises naming
    ``what`` if a call returns a CUDA error."""
    import torch

    lib = load()
    nbytes = ctypes.c_longlong(0)
    check(lib, getattr(lib, ws_symbol)(m, ctypes.byref(nbytes)), what)
    ws = torch.empty(nbytes.value, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(lib, getattr(lib, symbol)(*(None if t is None else t.data_ptr() for t in operands),
                                        m, *(t.data_ptr() for t in outputs), ws.data_ptr(),
                                        stream), what)
