"""slampp_tpu_torch/ops/invdist_kernels.py, the fused forms of the Sim(3)
inverse-distance edges (the ternary ``edge_p2c_invdist_sim3_lo`` and the
unary ``edge_p2c_invdist_sim3_ls``), against the generic path that CPU
operands keep (``linear/schur_sparse.generic_terms`` on the types'
``jacobian_fn`` and ``assembly.edge_chi2`` on their ``error_fn``): that CPU
operands take the generic path, bit for bit; the kernel's own source
(``csrc/invdist_kernels.cu``) built for the host over
``tests/_cuda_host.h`` and run on the CPU, alone and as the types' fused
forms in the sparse Schur engine, ``graph_chi2`` and
``max_edge_hessian_diag``; and (marked ``gpu``) the CUDA kernel on the
card.

Cases: ``venice_ba_system(12, 300, 4)`` embedded with local
inverse-distance landmarks (934 LO and 368 LS edges), a general
(non-diagonal) information per edge; the cameras' scales as embedded
(sigma = 0), drawn, below 1e-8 and between 1e-8 and 1e-3; every camera's
|omega|^2 just below and just above 1e-16 (the cameras then near the
origin, facing their points); radial distortion k != 0 with fx != fy; a
tenth of the edges invalid; and edge counts that are no multiple of
either form's CTA and odd, so that the observers' couplings start off 16
bytes.

The ``gpu`` cases need no JAX: ``python -m pytest
tests/test_torch_invdist_kernels.py -m gpu --noconftest``.
"""

import ctypes
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from slampp_tpu_torch.apps.sim3 import venice_ba_system
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import EdgeArrays
from slampp_tpu_torch.geometry import sim3
from slampp_tpu_torch.graph.types import TYPE_REGISTRY, get_edge_type
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver, generic_terms
from slampp_tpu_torch.models.sim3 import (_distort_jacobian, _invdist_lo_operands,
                                          _invdist_ls_operands, embed_ba_system_sim3_invdist)
from slampp_tpu_torch.ops import _cuda
from slampp_tpu_torch.ops import invdist_kernels as ik
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver
from _cuda_host import host_library  # tests/ is on the path of every test module

torch.set_num_threads(1)
LO, LS = "edge_p2c_invdist_sim3_lo", "edge_p2c_invdist_sim3_ls"
CASES = ("scene", "sig_drawn", "sig_below", "sig_mid", "om_below", "om_above", "k_nonzero",
         "invalid", "m_odd")
LO_OUT = ("Hoo", "Hcc", "Hoc", "go", "gc", "D", "gl", "B", "chi2")
LS_OUT = ("D", "gl", "chi2")


def _spd_info(rng, m):
    """(m, 2, 2) symmetric positive definite information matrices with
    off-diagonal terms."""
    G = rng.normal(size=(m, 2, 2))
    return G @ np.swapaxes(G, 1, 2) + 0.5 * np.eye(2)


@functools.lru_cache(maxsize=None)
def _scene(n_cams=12, n_points=300, track=4):
    system = embed_ba_system_sim3_invdist(venice_ba_system(n_cams, n_points, track))
    return system


def _case(name, n_cams=12, n_points=300, track=4):
    """(system, CPU graph) of the case: the embedded scene's snapshot with
    the case's states, information and masks (``m_odd`` keeps its edge
    counts: :func:`_operands` cuts them)."""
    system = _scene(n_cams, n_points, track)
    graph = system.snapshot("cpu")
    rng = np.random.default_rng(CASES.index(name))
    cams = graph.states["camsim3"]
    n_c = cams.shape[0]
    if name != "scene":
        cams[:, 6] = torch.as_tensor(rng.uniform(-0.2, 0.2, n_c))
        lm = graph.states["invdist"]
        lm[:, 0] *= torch.as_tensor(1.0 + 0.01 * rng.normal(size=lm.shape[0]))
    if name in ("sig_below", "sig_mid"):
        lo, hi = (1e-9, 9e-9) if name == "sig_below" else (2e-8, 9e-4)
        sig = rng.uniform(lo, hi, n_c) * rng.choice([-1.0, 1.0], n_c)
        if name == "sig_mid":
            # (e^sigma - 1) / sigma loses the digits of 1 / sigma: where the
            # host's exp (the kernel's host build) and torch's (the generic
            # path) round e^sigma a bit apart, which they do at ~4% of
            # arguments, the two paths part by ~1e-16 / sigma.  Arguments at
            # which they agree hold the kernel's branch, not the libraries'
            # exp (on the card both take CUDA's).
            for c in range(n_c):
                while float(torch.exp(torch.tensor(sig[c], dtype=torch.float64))) != math.exp(
                        sig[c]):
                    sig[c] = np.nextafter(sig[c], 1.0)
        cams[:, 6] = torch.as_tensor(sig)
    if name in ("om_below", "om_above"):
        # every camera rotated to ~the identity, near the origin, so that
        # each owner's points lie in front of every observer
        sq = 1.02e-16 if name == "om_above" else 0.98e-16
        direction = torch.tensor([0.48, -0.6, 0.64], dtype=torch.float64)  # a unit vector
        cams[:, 3:6] = direction * np.sqrt(sq)
        cams[:, 0:3] = torch.as_tensor(rng.normal(0.0, 0.05, (n_c, 3)))
        assert ((cams[:, 3:6] ** 2).sum(1) < 1e-16).all() == (name == "om_below")
    if name == "k_nonzero":
        cams[:, 8] = 480.0  # fy != fx
        cams[:, 11] = torch.as_tensor(rng.uniform(-0.01, 0.01, n_c))
        meas = graph.edges[LS].meas
        meas[:, 3] = 480.0
        meas[:, 6] = torch.as_tensor(rng.uniform(-0.01, 0.01, meas.shape[0]))
    for t in (LO, LS):
        ea = graph.edges[t]
        m = ea.meas.shape[0]
        ea.sigma_inv = torch.as_tensor(_spd_info(rng, m))
        if name == "invalid":
            ea.valid[rng.choice(m, m // 10, replace=False)] = False
    return system, graph


def _operands(graph, name, device="cpu"):
    """(LO operands, LS operands) of the fused forms, on ``device``; for
    ``m_odd`` the first 64 k + 37 LO and 256 k + 37 LS edges."""
    lo = _invdist_lo_operands(graph.edges[LO], graph.states)
    ls = _invdist_ls_operands(graph.edges[LS], graph.states)
    if name == "m_odd":
        m_lo, m_ls = lo[2].shape[0], ls[1].shape[0]
        k_lo, k_ls = 64 * (m_lo // 64 - 1) + 37, 256 * (m_ls // 256 - 1) + 37
        lo = lo[:2] + tuple(t[:k_lo].contiguous() for t in lo[2:])
        ls = ls[:1] + tuple(t[:k_ls].contiguous() for t in ls[1:])
        assert k_lo % 2 and k_ls % 2 and k_lo % 64 and k_ls % 256
    return (tuple(t.to(device) for t in lo), tuple(t.to(device) for t in ls))


def _edge_arrays(ops):
    """(states, EdgeArrays) of LO or LS operands, as a snapshot holds them."""
    if len(ops) == 6:
        lm, cams, idx, meas, info, valid = ops
        states = {"invdist": lm, "camsim3": cams}
    else:
        lm, idx, meas, info, valid = ops
        states = {"invdist": lm}
    return states, EdgeArrays(idx, torch.zeros_like(idx), meas, info, valid)


def _generic(monkeypatch):
    """The two types without their fused forms: the generic path on any
    device."""
    for t in (LO, LS):
        monkeypatch.setitem(TYPE_REGISTRY["edge"], t, dataclasses.replace(
            get_edge_type(t), fused_terms=None, fused_chi2=None))


def _reference(ops):
    """The generic path's terms in the fused forms' layout (the LO edge's two
    couplings as one (2E, 7, 1) block) with the chi2 of
    ``assembly.edge_chi2``; the fused forms must be off (``_generic``) for
    CUDA operands."""
    states, ea = _edge_arrays(ops)
    if len(ops) == 6:
        t = generic_terms(get_edge_type(LO), "ter", 0, ea, states)
        return (*t[:7], torch.cat([t[7], t[8]]), assembly.edge_chi2(LO, ea, states))
    t = generic_terms(get_edge_type(LS), "u_lm", None, ea, states)
    return (*t[:2], assembly.edge_chi2(LS, ea, states))


@functools.lru_cache(maxsize=None)
def _host_kernel_library():
    """csrc/invdist_kernels.cu built for the host (``tests/_cuda_host.py``),
    bound through ctypes as ``ops/_cuda.load`` binds the card's library."""
    lib = host_library(_cuda._INVDIST_SOURCE, 1)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.slampp_invdist_workspace.argtypes = [i64, ctypes.POINTER(i64)]
    lib.slampp_invdist_lo_terms_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 11
    lib.slampp_invdist_lo_chi2_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 3
    lib.slampp_invdist_ls_terms_f64.argtypes = [ptr] * 5 + [i64] + [ptr] * 5
    lib.slampp_invdist_ls_chi2_f64.argtypes = [ptr] * 5 + [i64] + [ptr] * 3
    return lib


def _host_run(ops, terms=True):
    """One launch of the kernel's host build on CPU LO operands (6) or LS
    operands (5): the terms form's outputs or the chi2 form's (chi2,), as
    float64 tensors."""
    lib = _host_kernel_library()
    lo = len(ops) == 6
    arrays = [np.ascontiguousarray(t.numpy()) for t in ops]
    m = len(arrays[2 if lo else 1])
    nbytes = ctypes.c_longlong(0)
    assert lib.slampp_invdist_workspace(m, ctypes.byref(nbytes)) == 0
    ws = np.empty(nbytes.value, np.uint8)
    if terms:
        shapes = (((m, 7, 7),) * 3 + ((m, 7),) * 2 + ((m, 1, 1), (m, 1), (2 * m, 7, 1))
                  if lo else ((m, 1, 1), (m, 1)))
        outs = [np.full(s, np.nan) for s in shapes] + [np.full((), np.nan)]
    else:
        outs = [np.full((), np.nan)]
    fn = getattr(lib, f"slampp_invdist_{'lo' if lo else 'ls'}_{'terms' if terms else 'chi2'}_f64")
    assert fn(*(a.ctypes.data for a in arrays), m, *(o.ctypes.data for o in outs),
              ws.ctypes.data, None) == 0
    return tuple(torch.as_tensor(o) for o in outs)


def _host_fused(monkeypatch):
    """The kernel's host build as the two types' fused forms, taken for CPU
    operands; returns the (type, order, outputs) of each ``fused_terms``
    call."""
    seen = []
    for t, operands in ((LO, _invdist_lo_operands), (LS, _invdist_ls_operands)):
        def fused_terms(ea, states, order, t=t, operands=operands):
            out = _host_run(operands(ea, states))
            seen.append((t, order, out))
            return out

        monkeypatch.setitem(TYPE_REGISTRY["edge"], t, dataclasses.replace(
            get_edge_type(t), fused_terms=fused_terms,
            fused_chi2=lambda ea, states, operands=operands: _host_run(
                operands(ea, states), terms=False)[0]))
    monkeypatch.setattr(assembly, "takes_fused", lambda et, ea: et.fused_terms is not None)
    return seen


def _spy(monkeypatch):
    """Records each call of the two types' fused forms, which then run as
    before."""
    calls = []
    for t in (LO, LS):
        et = get_edge_type(t)

        def fused_terms(ea, states, order, et=et):
            calls.append("terms")
            return et.fused_terms(ea, states, order)

        def fused_chi2(ea, states, et=et):
            calls.append("chi2")
            return et.fused_chi2(ea, states)

        monkeypatch.setitem(TYPE_REGISTRY["edge"], t, dataclasses.replace(
            et, fused_terms=fused_terms, fused_chi2=fused_chi2))
    return calls


def _engine_outputs(system, graph):
    ss = SparseSchurSolver(system, device="cpu")
    ss.symbolic()
    return (ss, ss._edge_terms(graph), assembly.graph_chi2(graph),
            assembly.max_edge_hessian_diag(graph))


def _close(got, want, tol, names, scales=None):
    """max |got - want| within tol of max(|want|, 1), per output, or of
    max(scale, 1) where ``scales`` gives one."""
    assert len(got) == len(want) == len(names)
    for k, (name, g, w) in enumerate(zip(names, got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = scales[k] if scales is not None and scales[k] is not None else (
            float(np.abs(w).max()) if w.size else 0.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * max(scale, 1.0), (name, err, scale)


def _scales(ops):
    """The scales :func:`_close` holds each output to: its largest entry,
    but for the LS edge's D and g_l.  Those are rounding: the owner sees
    its landmark along the landmark's own ray, and the projection of
    ray / q does not move with q, so J_q = Jh x / q is zero but for the
    rounding of a sum that cancels.  They are held to the size of what
    cancels: with a = |Jh| |x| / q, max a^T |W| a and max a^T |W| |r|."""
    if len(ops) == 6:
        return None
    lm, idx, meas, info, valid = ops
    v = lm[idx[:, 0]]
    x = v[:, 1:4] / v[:, 0:1]
    intr = meas[:, 2:7]
    a = (_distort_jacobian(x, intr).abs() @ x.abs()[..., None])[..., 0] / v[:, 0:1]
    Wa = info.abs() @ a[..., None]
    r = meas[:, 0:2] - sim3._distort(x, intr)
    Wr = info.abs() @ r.abs()[..., None]
    return [float((a[..., None] * Wa).sum((1, 2)).max()),
            float((a[..., None] * Wr).sum((1, 2)).max()), None]


# ------------------------------------------------------------------------ CPU


@pytest.mark.parametrize("name", ["scene", "sig_drawn", "invalid"])
def test_cpu_operands_keep_the_generic_path(name, monkeypatch):
    """CPU operands never reach the fused forms: the sparse Schur engine's
    edge terms, ``graph_chi2`` and ``max_edge_hessian_diag`` are, bit for
    bit, those of the types without them, and nothing is launched."""
    system, graph = _case(name)
    ik.reset_launches()
    calls = _spy(monkeypatch)
    _, terms, chi2, diag = _engine_outputs(system, graph)
    assert calls == [] and not any(ik.launches.values())
    _generic(monkeypatch)
    _, terms_g, chi2_g, diag_g = _engine_outputs(system, graph)
    assert len(terms) == len(terms_g) == 11
    for a, b in zip(terms, terms_g):
        assert a.dtype == b.dtype == torch.float64 and torch.equal(a, b)
    assert torch.equal(chi2, chi2_g) and torch.equal(diag, diag_g)


@pytest.mark.parametrize("name", ["scene", "sig_drawn", "om_below", "k_nonzero", "invalid"])
def test_engine_takes_fused_forms(name, monkeypatch):
    """With the kernel's host build as the types' fused forms: the engine
    asks for the edge order (``order`` None), passes the ternary type's
    head blocks and its one coupling block on without a copy, and the edge
    terms, ``graph_chi2`` and ``max_edge_hessian_diag`` are within 1e-12 of
    the generic path's."""
    system, graph = _case(name)
    _, terms_g, chi2_g, diag_g = _engine_outputs(system, graph)
    seen = _host_fused(monkeypatch)
    ss, terms, chi2, diag = _engine_outputs(system, graph)
    # the engine's terms, then the damping scale's
    assert [(t, o) for t, o, _ in seen] == [(LO, None), (LS, None)] * 2
    out_lo = seen[0][2]
    for k in (0, 1, 2, 3, 4):  # Hii, Hjj, Hij, gi, gj
        assert terms[k] is out_lo[k]
    assert terms[9] is out_lo[7]  # B: B_o rows, then B_c rows
    assert ss.plan.cpl_pose.shape[0] == out_lo[7].shape[0]
    _close(terms, terms_g, 1e-12, [f"term{i}" for i in range(11)])
    _close([chi2, diag], [chi2_g, diag_g], 1e-12, ("graph_chi2", "diag_max"))


@pytest.mark.parametrize("kind", [LO, LS])
@pytest.mark.parametrize("name", ["sig_drawn", "k_nonzero"])
def test_damping_scale_reads_the_fused_tuples(kind, name, monkeypatch):
    """``max_edge_hessian_diag`` of a graph of one type through its fused
    tuple (ternary: the diagonals of Hii, Hjj and D; unary: of D) equals
    the generic value within 1e-12."""
    _, graph = _case(name)
    one = dataclasses.replace(graph, edges={kind: graph.edges[kind]})
    want = assembly.max_edge_hessian_diag(one)
    _host_fused(monkeypatch)
    got = assembly.max_edge_hessian_diag(one)
    _close([got], [want], 1e-12, ("diag_max",))
    assert float(want) > 0.0


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host(name):
    """The kernel's own source, run on the host (its CTAs, the staged
    stores, the partial sums and the last CTA's sum): both edges' terms and
    chi2 forms against the generic path within 1e-12."""
    _, graph = _case(name)
    for ops, names in zip(_operands(graph, name), (LO_OUT, LS_OUT)):
        want = _reference(ops)
        _close(_host_run(ops), want, 1e-12, names, _scales(ops))
        _close(_host_run(ops, terms=False), want[-1:], 1e-12, ("chi2",))


def test_invalid_edges_leave_chi2_not_the_terms():
    """An invalid edge's terms are written as a valid one's; only chi2
    leaves it out, in both forms."""
    _, graph = _case("invalid")
    for ops in _operands(graph, "invalid"):
        valid = ops[-1]
        assert 0 < int((~valid).sum()) < valid.shape[0]
        all_valid = ops[:-1] + (torch.ones_like(valid),)
        got, full = _host_run(ops), _host_run(all_valid)
        for a, b in zip(got[:-1], full[:-1]):
            assert torch.equal(a, b)
        assert float(got[-1]) < float(full[-1])
        _close(got[-1:], _reference(ops)[-1:], 1e-12, ("chi2",))
        _close(_host_run(ops, terms=False), _reference(ops)[-1:], 1e-12, ("chi2",))


# ------------------------------------------------------------------ CUDA / gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _forms(ops):
    if len(ops) == 6:
        return ik.invdist_lo_terms, ik.invdist_lo_chi2, LO_OUT
    return ik.invdist_ls_terms, ik.invdist_ls_chi2, LS_OUT


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_generic_cases(cuda, name, monkeypatch):
    """The kernel against the generic path on the card within 1e-12 of each
    output's largest entry, at the CPU cases."""
    _, graph = _case(name)
    for ops in _operands(graph, name, cuda):
        terms_fn, chi2_fn, names = _forms(ops)
        got, chi2 = terms_fn(*ops), chi2_fn(*ops)
        with monkeypatch.context() as mp:
            _generic(mp)
            want = _reference(ops)
        _close([t.cpu() for t in got], [t.cpu() for t in want], 1e-12, names,
               _scales([t.cpu() for t in ops]))
        _close([chi2.cpu()], [want[-1].cpu()], 1e-12, ("chi2",))


@pytest.mark.gpu
def test_kernel_matches_generic_large(cuda, monkeypatch):
    """At ~10^5 LO edges, whose count is no multiple of either CTA: within
    1e-12 of the generic path, contiguous float64 outputs, and each form's
    chi2 the same bits over ten calls (the two forms sum in other
    orders)."""
    _, graph = _case("sig_drawn", 200, 20_000, 6)
    for ops in _operands(graph, "sig_drawn", cuda):
        terms_fn, chi2_fn, names = _forms(ops)
        m = ops[-1].shape[0]
        if len(ops) == 6:
            assert m > 50_000
        if m % 64 == 0:
            ops = ops[:-4] + tuple(t[:-1] for t in ops[-4:])
        got, chi2 = terms_fn(*ops), chi2_fn(*ops)
        for _ in range(10):
            assert torch.equal(chi2_fn(*ops), chi2)
            assert torch.equal(terms_fn(*ops)[-1], got[-1])
        with monkeypatch.context() as mp:
            _generic(mp)
            want = _reference(ops)
        for g, w in zip(got, want):
            assert g.is_contiguous() and g.dtype == torch.float64 and g.shape == w.shape
        _close([t.cpu() for t in got], [t.cpu() for t in want], 1e-12, names,
               _scales([t.cpu() for t in ops]))
        _close([chi2.cpu()], [want[-1].cpu()], 1e-12, ("chi2",))


@pytest.mark.gpu
def test_optimize_graph_launches(cuda):
    """One ``optimize_graph(start, 5, 0)`` on the sparse Schur engine
    launches each type's terms form 1 (the initial damping) + 5 times and
    its chi2 form 1 + 5 times (the start and each candidate)."""
    system = embed_ba_system_sim3_invdist(venice_ba_system(130, 1500, 4))
    lm = LevenbergMarquardtSolver(system, use_schur=True, device=cuda)
    assert lm._resolve_engine() == "schur_sparse"
    graph = system.snapshot(cuda)
    ik.reset_launches()
    _, _, iterations = lm.optimize_graph(graph, 5, 0.0)
    assert iterations == 5
    assert ik.launches == {"invdist_lo_terms": 6, "invdist_lo_chi2": 6,
                           "invdist_ls_terms": 6, "invdist_ls_chi2": 6}


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["lo_terms", "lo_chi2", "ls_terms", "ls_chi2"])
def test_kernel_refuses(cuda, form):
    """float32 landmarks, a non-contiguous index, CPU operands, CPU / CUDA
    mixed operands, an index of another width, and ``sigma_inv``
    (both) or the LO edge's ``meas`` off 16 bytes raise; nothing is
    launched."""
    _, graph = _case("scene")
    lo, ls = _operands(graph, "scene", cuda)
    ops = lo if form.startswith("lo") else ls
    fn = getattr(ik, f"invdist_{form}")
    m = ops[-1].shape[0]
    k = len(ops) - 4  # the index's position
    ik.reset_launches()
    with pytest.raises(TypeError):
        fn(ops[0].float(), *ops[1:])
    with pytest.raises(ValueError):
        fn(*ops[:k], torch.stack([ops[k], ops[k]], -1)[..., 0], *ops[k + 1:])
    with pytest.raises(ValueError):
        fn(*(t.cpu() for t in ops))
    with pytest.raises(ValueError):
        fn(*ops[:k], ops[k].cpu(), *ops[k + 1:])
    with pytest.raises(ValueError):
        fn(*ops[:k], torch.zeros((m, 5 - ops[k].shape[1]), dtype=torch.int64, device=cuda),
           *ops[k + 1:])
    info8 = torch.empty(4 * m + 1, dtype=torch.float64, device=cuda)[1:].view(m, 2, 2)
    with pytest.raises(ValueError):
        fn(*ops[:-2], info8.copy_(ops[-2]), ops[-1])
    if form.startswith("lo"):
        meas8 = torch.empty(2 * m + 1, dtype=torch.float64, device=cuda)[1:].view(m, 2)
        with pytest.raises(ValueError):
            fn(*ops[:3], meas8.copy_(ops[3]), *ops[4:])
    assert not any(ik.launches.values())
