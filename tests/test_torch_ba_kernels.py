"""slampp_tpu_torch/ops/ba_kernels.py: the plain versions of
``p2c_linearize`` and ``p2c_chi2`` against the composition they replaced in
``linear/ba_schur.py`` (bit for bit) and against the JAX package's
``_p2c_jacs_analytic`` / ``ba_chi2_only`` (within 1e-12); the kernel's own
source (``csrc/ba_kernels.cu``) built for the host over
``tests/_cuda_host.h`` and run on the CPU against the plain version; and
(marked ``gpu``) the CUDA kernel against the plain version on the card.

Cases: ``make_venice_ba_arrays(n_cams=12, n_points=400, mean_track=5)``
with a general (non-diagonal) information per observation, and the same
with camera 0's axis-angle at 0 (the Taylor branch), with |aa|^2 just below
and just above 1e-16, with radial distortion k != 0 and fx != fy, and with
one observation.

The ``gpu`` cases need no JAX (it is imported inside the CPU cases only):
``python -m pytest tests/test_torch_ba_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from slampp_tpu_torch.geometry import camera as cam_geo
from slampp_tpu_torch.io.datasets import make_venice_ba_arrays
from slampp_tpu_torch.linear import ba_schur
from slampp_tpu_torch.models import ba as ba_models
from slampp_tpu_torch.ops import ba_kernels as bak

torch.set_num_threads(1)
SCENE = {"n_cams": 12, "n_points": 400, "mean_track": 5}
CASES = ("scene", "aa_zero", "aa_below", "aa_above", "k_nonzero", "m1")
OUTPUTS = ("r", "Jp", "Jc", "WJp", "WJc", "chi2")


def _spd_info(rng, m):
    """(m, 2, 2) symmetric positive definite information matrices with
    off-diagonal terms."""
    G = rng.normal(size=(m, 2, 2))
    return G @ np.swapaxes(G, 1, 2) + 0.5 * np.eye(2)


def _case(name, n_cams=SCENE["n_cams"], n_points=SCENE["n_points"],
          mean_track=SCENE["mean_track"]):
    """(cams, points, obs_cam, obs_lm, uv, info) as numpy arrays."""
    cams, lms, oc, ol, uv, _, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    rng = np.random.default_rng(CASES.index(name))
    info = _spd_info(rng, len(oc))
    direction = np.array([0.48, -0.6, 0.64])  # a unit vector
    if name == "aa_zero":
        cams[0, 3:6] = 0.0
    elif name == "aa_below":
        cams[0, 3:6] = direction * np.sqrt(0.98e-16)
    elif name == "aa_above":
        cams[0, 3:6] = direction * np.sqrt(1.02e-16)
    elif name == "k_nonzero":
        cams[:, 7] = 480.0  # fy != fx
        cams[:, 10] = rng.uniform(-5e-4, 5e-4, len(cams))
    elif name == "m1":
        oc, ol, uv, info = oc[:1], ol[:1], uv[:1], info[:1]
    if name in ("aa_below", "aa_above"):
        sq = float((cams[0, 3:6] ** 2).sum())
        assert (sq < 1e-16) == (name == "aa_below")
    return cams, lms, oc, ol, uv, info


def _tensors(arrays, device="cpu"):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _close(got, want, tol):
    """max |got - want| within tol of max(|want|, 1), per output."""
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * scale, (name, err, scale)


# ----------------------------------------------------------------- plain / CPU


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_replaced_composition(name):
    """The plain versions are, bit for bit, what ``ba_schur_lm_step`` and
    ``ba_chi2_only`` computed before the kernel; CPU operands launch
    nothing."""
    cams, lms, oc, ol, uv, info = _tensors(_case(name))
    bak.reset_launches()
    got = bak.p2c_linearize(cams, lms, oc, ol, uv, info)
    got_chi2 = bak.p2c_chi2(cams, lms, oc, ol, uv, info)
    assert not any(bak.launches.values())

    r, (Jp, Jc) = ba_models._edge_p2c_jacobians((lms[ol], cams[oc]), uv)
    Wr = torch.einsum("mij,mj->mi", info, r)
    want = (r, Jp, Jc, info @ Jp, info @ Jc, (r * Wr).sum())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert g.is_contiguous() and g.dtype == torch.float64
    r2 = cam_geo.p2c_error(lms[ol], cams[oc], uv)
    assert torch.equal(got_chi2, torch.einsum("mi,mij,mj->", r2, info, r2))


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    """Within 1e-12 of the JAX package's ``_p2c_jacs_analytic`` (its
    batch-last r, Jp, Jc; W Jp and W Jc formed from them in numpy) and its
    ``ba_chi2_only``."""
    jnp = pytest.importorskip("jax.numpy")
    from types import SimpleNamespace

    from slampp_tpu.linear import ba_schur as jbs

    arrays = _case(name)
    cams, lms, oc, ol, uv, info = arrays
    got = [t.numpy() for t in bak.p2c_linearize(*_tensors(arrays))]
    got_chi2 = float(bak.p2c_chi2(*_tensors(arrays)))

    jr, jJp, jJc = (np.asarray(a) for a in jbs._p2c_jacs_analytic(
        jnp.asarray(lms[ol]), jnp.asarray(cams[oc]), jnp.asarray(uv)))
    r, Jp, Jc = jr.T, np.moveaxis(jJp, -1, 0), np.moveaxis(jJc, -1, 0)
    plan = SimpleNamespace(obs_cam=jnp.asarray(oc), obs_lm=jnp.asarray(ol),
                           obs_uv=jnp.asarray(uv), obs_info=jnp.asarray(info))
    chi2 = float(jbs.ba_chi2_only(plan, jnp.asarray(cams), jnp.asarray(lms)))
    want = (r, Jp, Jc, info @ Jp, info @ Jc, chi2)
    _close(got, want, 1e-12)
    _close([got_chi2], [chi2], 1e-12)


def test_optimize_on_cpu_launches_nothing():
    """``BigBASolver`` on CPU tensors takes the plain versions throughout."""
    cams, lms, oc, ol, uv, info = _case("scene")
    s = ba_schur.BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, device="cpu")
    bak.reset_launches()
    chi0 = s.chi2()
    assert s.optimize(max_iterations=2, min_dx_norm=0.0) == 2
    assert s.chi2() < chi0
    assert bak.launches == {"p2c_linearize": 0, "p2c_chi2": 0}


# ------------------------------------- the kernel's source, built for the host


def _host_kernel_library():
    """csrc/ba_kernels.cu built with the host C++ compiler over
    tests/_cuda_host.h (each launch rewritten as a call of its
    ``host_launch``), bound through ctypes as ``ops/_cuda.load`` binds the
    card's library."""
    import ctypes
    import os
    import re
    import shutil
    from pathlib import Path

    from slampp_tpu_torch.ops import _cuda

    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    host_h = (Path(__file__).resolve().parent / "_cuda_host.h").read_text()
    src = _cuda._BA_SOURCE.read_text().replace("#include <cuda_runtime.h>", host_h)
    src, n = re.subn(r"(\w+<\w+>)<<<(.*?)>>>\((.*?)\);",
                     r"host_launch(\2, [&]() { \1(\3); });", src, flags=re.S)
    assert n == 1
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    host_src = _cuda.BUILD_DIR / "ba_kernels_host.cpp"
    tmp = host_src.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(src)
    os.replace(tmp, host_src)
    flags = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")
    lib = ctypes.CDLL(str(_cuda.compile_shared(host_src, cxx, flags, {})))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.slampp_p2c_workspace.argtypes = [i64, ctypes.POINTER(i64)]
    lib.slampp_p2c_linearize_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 8
    lib.slampp_p2c_chi2_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 3
    return lib


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host(name):
    """The kernel's own source, run on the host (its CTAs of 128 threads,
    the staged stores, the partial sums and the last CTA's sum), both
    forms against the plain versions within 1e-12."""
    import ctypes

    lib = _host_kernel_library()
    arrays = [np.ascontiguousarray(a) for a in _case(name)]
    m = len(arrays[2])
    outs = [np.full(s, np.nan) for s in ((m, 2), (m, 2, 3), (m, 2, 6), (m, 2, 3), (m, 2, 6), ())]
    chi2 = np.full((), np.nan)
    nbytes = ctypes.c_longlong(0)
    assert lib.slampp_p2c_workspace(m, ctypes.byref(nbytes)) == 0
    ws = np.empty(nbytes.value, np.uint8)
    ptrs = [a.ctypes.data for a in arrays]
    assert lib.slampp_p2c_linearize_f64(*ptrs, m, *(o.ctypes.data for o in outs),
                                        ws.ctypes.data, None) == 0
    assert lib.slampp_p2c_chi2_f64(*ptrs, m, chi2.ctypes.data, ws.ctypes.data, None) == 0
    want = [t.numpy() for t in bak.p2c_linearize_plain(*_tensors(arrays))]
    _close(outs, want, 1e-12)
    _close([chi2], [bak.p2c_chi2_plain(*_tensors(arrays))], 1e-12)


# ------------------------------------------------------------------ CUDA / gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_vs_plain(arrays, dev, tol=1e-12):
    ops = _tensors(arrays, dev)
    got = bak.p2c_linearize(*ops)
    got_chi2 = bak.p2c_chi2(*ops)
    torch.cuda.synchronize()
    want = bak.p2c_linearize_plain(*ops)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float64 and g.shape == w.shape
    _close([t.cpu() for t in got], [t.cpu() for t in want], tol)
    _close([got_chi2.cpu()], [bak.p2c_chi2_plain(*ops).cpu()], tol)
    return got_chi2


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_cases(cuda, name):
    """The kernel against the plain version (on the card) within 1e-12 of
    each output's largest entry, at the CPU cases."""
    _kernel_vs_plain(_case(name), cuda)


@pytest.mark.gpu
def test_kernel_matches_plain_venice_like(cuda):
    """At a venice-like scene of ~10^5 observations, whose count is not a
    multiple of the kernel's 128-thread CTA, and deterministic: each form's
    chi2 bit-identical over repeated calls (the two forms round apart)."""
    arrays = _case("scene", n_cams=200, n_points=20_000, mean_track=6)
    if len(arrays[2]) % 128 == 0:
        arrays = tuple(a[:-1] if i >= 2 else a for i, a in enumerate(arrays))
    assert len(arrays[2]) % 128 and len(arrays[2]) > 50_000
    chi2 = _kernel_vs_plain(arrays, cuda)
    ops = _tensors(arrays, cuda)
    chi2_lin = bak.p2c_linearize(*ops)[5]
    for _ in range(5):
        assert torch.equal(bak.p2c_chi2(*ops), chi2)
        assert torch.equal(bak.p2c_linearize(*ops)[5], chi2_lin)


@pytest.mark.gpu
def test_optimize_launches(cuda):
    """One ``optimize`` step launches ``p2c_linearize`` once, and its two
    ``ba_chi2_only`` (the start and the gain test) ``p2c_chi2`` once each."""
    cams, lms, oc, ol, uv, info = _case("scene")
    s = ba_schur.BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, device=cuda)
    bak.reset_launches()
    s.optimize(max_iterations=1, min_dx_norm=0.0)
    assert bak.launches == {"p2c_linearize": 1, "p2c_chi2": 2}
    ba_schur.ba_chi2_only(s.plan, s._cams, s._lms)
    assert bak.launches == {"p2c_linearize": 1, "p2c_chi2": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("fn", [bak.p2c_linearize, bak.p2c_chi2])
def test_kernel_refuses(cuda, fn):
    """float32 states, a non-contiguous operand and CPU / CUDA mixed
    operands raise; nothing is launched."""
    ops = _tensors(_case("scene"), cuda)
    bak.reset_launches()
    with pytest.raises(TypeError):
        fn(ops[0].float(), *ops[1:])
    with pytest.raises(ValueError):
        fn(ops[0], ops[1].t().contiguous().t(), *ops[2:])
    with pytest.raises(ValueError):
        fn(ops[0], ops[1], ops[2].cpu(), *ops[3:])
    with pytest.raises(ValueError):
        fn(ops[0].cpu(), *ops[1:])
    assert not any(bak.launches.values())
