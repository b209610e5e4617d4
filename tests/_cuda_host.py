"""A kernel source of ``slampp_tpu_torch/csrc/`` built with the host C++
compiler over ``tests/_cuda_host.h`` (each launch rewritten as a call of
its ``host_launch``) and loaded through ctypes, so that a test can run the
kernel's own code on the CPU against its plain version or the generic
path it replaces on the card."""

import ctypes
import os
import re
import shutil
from pathlib import Path

import pytest

from slampp_tpu_torch.ops import _cuda

HOST_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


def host_library(source: Path, n_launches: int) -> ctypes.CDLL:
    """``source`` built for the host (skips without a host C++ compiler);
    ``n_launches`` is the number of ``kernel<T><<<...>>>(...)`` launches
    the source holds.  The caller declares the entry points' argtypes."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    host_h = (Path(__file__).resolve().parent / "_cuda_host.h").read_text()
    src = source.read_text().replace("#include <cuda_runtime.h>", host_h)
    src, n = re.subn(r"(\w+<[\w, ]+>)<<<(.*?)>>>\((.*?)\);",
                     r"host_launch(\2, [&]() { \1(\3); });", src, flags=re.S)
    assert n == n_launches
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    host_src = _cuda.BUILD_DIR / f"{source.stem}_host.cpp"
    tmp = host_src.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(src)
    os.replace(tmp, host_src)
    return ctypes.CDLL(str(_cuda.compile_shared(host_src, cxx, HOST_FLAGS, {})))
