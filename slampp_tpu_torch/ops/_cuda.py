"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``slampp_tpu_torch/_build/`` (one file per
source hash, so an edited source rebuilds), then bound through ``ctypes``.
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


def _build() -> Path:
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"dense_kernels-{digest}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"slampp_chol_{dt}")
                fn.argtypes = [ptr, ptr, i32, i32, f64, ptr]
                fn.restype = i32
                for kind in ("fwd", "bwd"):
                    fn = getattr(lib, f"slampp_trsm_{kind}_{dt}")
                    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
                    fn.restype = i32
            lib.slampp_chol_resident_max.argtypes = [i32, ctypes.POINTER(i32)]
            lib.slampp_chol_resident_max.restype = i32
            lib.slampp_error_string.argtypes = [i32]
            lib.slampp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.slampp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
