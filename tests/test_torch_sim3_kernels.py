"""slampp_tpu_torch/ops/sim3_kernels.py, the Sim(3) xyz G edge's fused
forms, against the generic path that CPU operands keep
(``linear/schur_sparse.pl_terms`` on the type's ``jacobian_fn`` and
``assembly.edge_chi2`` on its ``error_fn``): that CPU operands take the
generic path, bit for bit; the kernel's own source
(``csrc/sim3_kernels.cu``) built for the host over ``tests/_cuda_host.h``
and run on the CPU, alone and as the type's fused forms in the sparse Schur
engine, ``graph_chi2`` and ``max_edge_hessian_diag``; and (marked ``gpu``)
the CUDA kernel on the card.

Cases: ``make_venice_ba_arrays(n_cams=12, n_points=400, mean_track=5)`` in
Sim(3) (each camera's scale e^sigma drawn, its centre and orientation
kept) with a general (non-diagonal) information per edge; camera 0's
|sigma| below 1e-8 and between 1e-8 and 1e-3; its |omega|^2 just below and
just above 1e-16, and below with sigma = 0 (camera 0 then faces its points
from 10 m); radial distortion k != 0 with fx != fy; a tenth of the edges
invalid; an edge count that is no multiple of either form's CTA; and the
edges in a random order, so that the landmark order is no identity.

The ``gpu`` cases need no JAX: ``python -m pytest
tests/test_torch_sim3_kernels.py -m gpu --noconftest``.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from slampp_tpu_torch.apps.sim3 import venice_ba_system
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.geometry import sim3
from slampp_tpu_torch.graph.system import EdgeArrays, GraphSystem
from slampp_tpu_torch.graph.types import TYPE_REGISTRY, get_edge_type
from slampp_tpu_torch.io.datasets import make_venice_ba_arrays
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver, pl_terms
from slampp_tpu_torch.models.sim3 import _xyz_g_operands, embed_ba_system_sim3
from slampp_tpu_torch.ops import _cuda
from slampp_tpu_torch.ops import sim3_kernels as sk
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver
from _cuda_host import host_library  # tests/ is on the path of every test module

torch.set_num_threads(1)
NAME = "edge_p2c_xyz_sim3_g"
CASES = ("scene", "sig_below", "sig_mid", "om_below", "om_above", "om_sig_zero", "k_nonzero",
         "invalid", "m_odd", "perm")
OUTPUTS = ("Hpp", "gp", "Dl", "gl", "B", "chi2")
TERM_SHAPES = ((7, 7), (7,), (3, 3), (3,), (7, 3))


def _spd_info(rng, m):
    """(m, 2, 2) symmetric positive definite information matrices with
    off-diagonal terms."""
    G = rng.normal(size=(m, 2, 2))
    return G @ np.swapaxes(G, 1, 2) + 0.5 * np.eye(2)


def _case(name, n_cams=12, n_points=400, mean_track=5):
    """(points, cams, local_idx, meas, info, valid, order) as numpy arrays:
    cameras (n_c, 12) camsim3 states, ``local_idx`` (E, 2) (point, camera),
    ``order`` the landmark sort of the edges (the engine's ``lm_sort``)."""
    bcams, pts, oc, ol, uv, _, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    rng = np.random.default_rng(CASES.index(name))
    info = _spd_info(rng, len(oc))
    w2c = torch.as_tensor(np.concatenate([bcams[:, 0:6], np.ones((len(bcams), 1))], 1))
    c2w = sim3.inverse_tRs(w2c)
    c2w[:, 6] = torch.as_tensor(np.exp(rng.uniform(-0.2, 0.2, len(bcams))))
    log = sim3.sim3_log(c2w)
    direction = torch.tensor([0.48, -0.6, 0.64], dtype=torch.float64)  # a unit vector
    if name in ("sig_below", "sig_mid"):
        log[0, 6] = 6e-9 if name == "sig_below" else 3e-6
    elif name in ("om_below", "om_above", "om_sig_zero"):
        # camera 0 rotated to ~the identity, 10 m in front of its points
        X0 = torch.as_tensor(pts[ol[oc == 0]])
        t = X0.mean(0) - torch.tensor([0.0, 0.0, 10.0], dtype=torch.float64)
        sq = 1.02e-16 if name == "om_above" else 0.98e-16
        s = 1.0 if name == "om_sig_zero" else float(c2w[0, 6])
        log[0] = sim3.sim3_log(torch.cat([t, direction * np.sqrt(sq),
                                           torch.tensor([s], dtype=torch.float64)]))
        log[0, 3:6] = direction * np.sqrt(sq)
        if name == "om_sig_zero":
            log[0, 6] = 0.0
        assert (float((log[0, 3:6] ** 2).sum()) < 1e-16) == (name != "om_above")
    cams = np.concatenate([log.numpy(), bcams[:, 6:11]], 1)
    if name == "k_nonzero":
        cams[:, 8] = 480.0  # fy != fx
        cams[:, 11] = rng.uniform(-0.01, 0.01, len(cams))
    idx = np.stack([ol, oc], 1).astype(np.int64)
    valid = np.ones(len(oc), bool)
    if name == "invalid":
        valid[rng.choice(len(oc), len(oc) // 10, replace=False)] = False
    if name == "m_odd":  # no multiple of 64 or 256, and an odd count
        keep = 64 * (len(oc) // 64 - 1) + 37
        idx, uv, info, valid = idx[:keep], uv[:keep], info[:keep], valid[:keep]
    if name == "perm":
        p = rng.permutation(len(idx))
        idx, uv, info, valid = idx[p], uv[p], info[p], valid[p]
    order = np.argsort(idx[:, 0], kind="stable")
    if name == "perm":
        assert (order != np.arange(len(order))).any()
    return pts, cams, np.ascontiguousarray(idx), uv, info, valid, order


def _tensors(arrays, device="cpu"):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _system(arrays, n_ls=0):
    """The case as a camsim3 / xyz GraphSystem, its edges in the arrays'
    order; ``n_ls`` unary ``edge_p2c_xyz_sim3_ls`` edges on the first
    points give it a second type with landmark rows."""
    pts, cams, idx, meas, info, _, _ = arrays
    system = GraphSystem()
    n_c = len(cams)
    for c in range(n_c):
        system.add_vertex("camsim3", c, cams[c])
    for p in range(len(pts)):
        system.add_vertex("xyz", n_c + p, pts[p])
    for (p, c), z, w in zip(idx, meas, info):
        system.add_edge(NAME, (n_c + int(p), int(c)), z, w)
    for p in range(n_ls):
        system.add_edge("edge_p2c_xyz_sim3_ls", (n_c + p,),
                        np.array([320.0, 240.0, 500.0, 500.0, 320.0, 240.0, 0.0]), np.eye(2))
    return system


def _snapshot(system, arrays, device="cpu"):
    graph = system.snapshot(device)
    graph.edges[NAME].valid = torch.as_tensor(arrays[5], device=device)
    return graph


def _generic(monkeypatch):
    """The type without its fused forms: the generic path on any device."""
    et = get_edge_type(NAME)
    monkeypatch.setitem(TYPE_REGISTRY["edge"], NAME,
                        dataclasses.replace(et, fused_terms=None, fused_chi2=None))


def _edge_arrays(ops):
    """(states, EdgeArrays) of the operands (points, cams, local_idx, meas,
    sigma_inv, valid), as a graph snapshot holds them."""
    points, cams, idx, meas, info, valid = ops
    return ({"xyz": points, "camsim3": cams},
            EdgeArrays(idx, torch.zeros_like(idx), meas, info, valid))


def _reference(ops, order=None):
    """The generic path's terms (``pl_terms``, rows in ``order``) with the
    chi2 of ``assembly.edge_chi2``; the type's fused forms must be off
    (``_generic``) for CUDA operands."""
    states, ea = _edge_arrays(ops)
    terms = pl_terms(get_edge_type(NAME), 0, ea, states)[:5]
    if order is not None:
        terms = tuple(t[order] for t in terms)
    return (*terms, assembly.edge_chi2(NAME, ea, states))


@functools.lru_cache(maxsize=None)
def _host_kernel_library():
    """csrc/sim3_kernels.cu built for the host (``tests/_cuda_host.py``),
    bound through ctypes as ``ops/_cuda.load`` binds the card's library."""
    lib = host_library(_cuda._SIM3_SOURCE, 1)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.slampp_sim3_g_workspace.argtypes = [i64, ctypes.POINTER(i64)]
    lib.slampp_sim3_g_terms_f64.argtypes = [ptr] * 7 + [i64] + [ptr] * 8
    lib.slampp_sim3_g_chi2_f64.argtypes = [ptr] * 6 + [i64] + [ptr] * 3
    return lib


def _host_run(ops, order=None, terms=True):
    """One launch of the kernel's host build on CPU operands: the terms
    form's (Hpp, gp, Dl, gl, B, chi2), rows in ``order``, or the chi2
    form's (chi2,), as float64 tensors."""
    lib = _host_kernel_library()
    arrays = [np.ascontiguousarray(t.numpy()) for t in ops]
    m = len(arrays[2])
    nbytes = ctypes.c_longlong(0)
    assert lib.slampp_sim3_g_workspace(m, ctypes.byref(nbytes)) == 0
    ws = np.empty(nbytes.value, np.uint8)
    ptrs = [a.ctypes.data for a in arrays]
    if terms:
        order_np = None if order is None else np.ascontiguousarray(order.numpy())
        outs = [np.full((m, *s), np.nan) for s in TERM_SHAPES] + [np.full((), np.nan)]
        assert lib.slampp_sim3_g_terms_f64(*ptrs, None if order_np is None else order_np.ctypes.data,
                                           m, *(o.ctypes.data for o in outs), ws.ctypes.data,
                                           None) == 0
    else:
        outs = [np.full((), np.nan)]
        assert lib.slampp_sim3_g_chi2_f64(*ptrs, m, outs[0].ctypes.data, ws.ctypes.data,
                                          None) == 0
    return tuple(torch.as_tensor(o) for o in outs)


def _host_fused(monkeypatch):
    """The kernel's host build as the type's fused forms, taken for CPU
    operands; returns the ``order`` of each ``fused_terms`` call."""
    seen = []

    def fused_terms(ea, states, order):
        seen.append(order)
        return _host_run(_xyz_g_operands(ea, states), order)

    monkeypatch.setitem(TYPE_REGISTRY["edge"], NAME, dataclasses.replace(
        get_edge_type(NAME), fused_terms=fused_terms,
        fused_chi2=lambda ea, states: _host_run(_xyz_g_operands(ea, states), terms=False)[0]))
    monkeypatch.setattr(assembly, "takes_fused", lambda et, ea: et.fused_terms is not None)
    return seen


def _spy(monkeypatch):
    """Records each call of the type's fused forms, which then run as
    before."""
    et = get_edge_type(NAME)
    calls = []

    def fused_terms(ea, states, order):
        calls.append("terms")
        return et.fused_terms(ea, states, order)

    def fused_chi2(ea, states):
        calls.append("chi2")
        return et.fused_chi2(ea, states)

    monkeypatch.setitem(TYPE_REGISTRY["edge"], NAME, dataclasses.replace(
        et, fused_terms=fused_terms, fused_chi2=fused_chi2))
    return calls


def _engine_outputs(system, graph):
    ss = SparseSchurSolver(system, device="cpu")
    ss.symbolic()
    return (ss, ss._edge_terms(graph), assembly.graph_chi2(graph),
            assembly.max_edge_hessian_diag(graph))


def _close(got, want, tol, names=OUTPUTS):
    """max |got - want| within tol of max(|want|, 1), per output."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * scale, (name, err, scale)


# ------------------------------------------------------------------------ CPU


@pytest.mark.parametrize("name", CASES)
def test_cpu_operands_keep_the_generic_path(name, monkeypatch):
    """CPU operands never reach the fused forms: the sparse Schur engine's
    edge terms (the landmark rows gathered into ``lm_sort``), ``graph_chi2``
    and ``max_edge_hessian_diag`` are, bit for bit, those of the type
    without them, and nothing is launched."""
    arrays = _case(name)
    system = _system(arrays)
    graph = _snapshot(system, arrays)
    sk.reset_launches()
    calls = _spy(monkeypatch)
    ss, terms, chi2, diag = _engine_outputs(system, graph)
    assert ss._lm_rows_fused and calls == [] and not any(sk.launches.values())
    assert torch.equal(ss.plan.lm_sort.cpu(), torch.as_tensor(arrays[6]))

    _generic(monkeypatch)
    ss_g, terms_g, chi2_g, diag_g = _engine_outputs(system, graph)
    assert not ss_g._lm_rows_fused
    assert len(terms) == len(terms_g) == 11
    for a, b in zip(terms, terms_g):
        assert a.dtype == b.dtype == torch.float64 and torch.equal(a, b)
    assert torch.equal(chi2, chi2_g) and torch.equal(diag, diag_g)


@pytest.mark.parametrize("name", CASES)
def test_engine_takes_fused_forms(name, monkeypatch):
    """With the kernel's host build as the type's fused forms: the engine
    passes ``lm_sort`` and takes the landmark rows as they come, the
    damping scale reads the edge-order terms' Hpp and Dl, and the edge
    terms, ``graph_chi2`` and ``max_edge_hessian_diag`` are within 1e-12
    of the generic path's."""
    arrays = _case(name)
    system = _system(arrays)
    graph = _snapshot(system, arrays)
    _generic(monkeypatch)
    _, terms_g, chi2_g, diag_g = _engine_outputs(system, graph)
    monkeypatch.undo()
    seen = _host_fused(monkeypatch)
    ss, terms, chi2, diag = _engine_outputs(system, graph)
    assert ss._lm_rows_fused and len(seen) == 2
    assert torch.equal(seen[0], ss.plan.lm_sort) and seen[1] is None
    _close(terms, terms_g, 1e-12, [f"term{i}" for i in range(11)])
    _close([chi2, diag], [chi2_g, diag_g], 1e-12, ("graph_chi2", "diag_max"))


def test_second_landmark_row_type_takes_the_gather(monkeypatch):
    """With a unary landmark type beside it, the fused type's rows come in
    the edge order (``order`` None) and go through the engine's
    concatenate-and-gather: the generic path's edge terms within 1e-12."""
    arrays = _case("perm")
    system = _system(arrays, n_ls=20)
    graph = _snapshot(system, arrays)
    _generic(monkeypatch)
    _, terms_g, chi2_g, diag_g = _engine_outputs(system, graph)
    monkeypatch.undo()
    seen = _host_fused(monkeypatch)
    ss, terms, chi2, diag = _engine_outputs(system, graph)
    assert not ss._lm_rows_fused and seen == [None, None]
    _close(terms, terms_g, 1e-12, [f"term{i}" for i in range(11)])
    _close([chi2, diag], [chi2_g, diag_g], 1e-12, ("graph_chi2", "diag_max"))


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_host(name):
    """The kernel's own source, run on the host (its CTAs, the staged
    stores, the partial sums and the last CTA's sum): the terms form in
    the landmark order and in the edge order, and the chi2 form, against
    the generic path within 1e-12."""
    arrays = _case(name)
    ops = _tensors(arrays[:6])
    order = torch.as_tensor(arrays[6])
    for o in (order, None):
        _close(_host_run(ops, o), _reference(ops, o), 1e-12)
    _close(_host_run(ops, terms=False), _reference(ops)[5:], 1e-12, ("chi2",))


# ------------------------------------------------------------------ CUDA / gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_generic_cases(cuda, name, monkeypatch):
    """The kernel against the generic path on the card within 1e-12 of
    each output's largest entry, at the CPU cases, in the landmark order
    and in the edge order."""
    arrays = _case(name)
    ops = _tensors(arrays[:6], cuda)
    order = torch.as_tensor(arrays[6], device=cuda)
    got = [sk.sim3_g_terms(*ops, o) for o in (order, None)]
    chi2 = sk.sim3_g_chi2(*ops)
    _generic(monkeypatch)
    for g, o in zip(got, (order, None)):
        _close([t.cpu() for t in g], [t.cpu() for t in _reference(ops, o)], 1e-12)
    _close([chi2.cpu()], [_reference(ops)[5].cpu()], 1e-12, ("chi2",))


@pytest.mark.gpu
def test_kernel_matches_generic_large(cuda, monkeypatch):
    """At ~10^5 edges, whose count is no multiple of either CTA: within
    1e-12 of the generic path, and deterministic: each form's chi2
    bit-identical over repeated calls (the two forms sum in other orders)."""
    arrays = _case("scene", n_cams=200, n_points=20_000, mean_track=6)
    if len(arrays[2]) % 64 == 0:
        arrays = tuple(a[:-1] if i >= 2 else a for i, a in enumerate(arrays[:6])) + (
            np.argsort(arrays[2][:-1, 0], kind="stable"),)
    assert len(arrays[2]) % 64 and len(arrays[2]) > 50_000
    ops = _tensors(arrays[:6], cuda)
    order = torch.as_tensor(arrays[6], device=cuda)
    got = sk.sim3_g_terms(*ops, order)
    chi2 = sk.sim3_g_chi2(*ops)
    for _ in range(5):
        assert torch.equal(sk.sim3_g_chi2(*ops), chi2)
        assert torch.equal(sk.sim3_g_terms(*ops, order)[5], got[5])
    _generic(monkeypatch)
    want = _reference(ops, order)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float64 and g.shape == w.shape
    _close([t.cpu() for t in got], [t.cpu() for t in want], 1e-12)
    _close([chi2.cpu()], [want[5].cpu()], 1e-12, ("chi2",))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3])
def test_optimize_graph_launches(cuda, n):
    """One ``optimize_graph`` of n iterations on the sparse Schur engine
    launches the terms form 1 (the initial damping) + n times and the chi2
    form n + 1 times (the start and each candidate)."""
    system = embed_ba_system_sim3(venice_ba_system(20, 1500, 3))
    lm = LevenbergMarquardtSolver(system, use_schur=True, device=cuda)
    assert lm._resolve_engine() == "schur_sparse"
    graph = system.snapshot(cuda)
    sk.reset_launches()
    _, _, iterations = lm.optimize_graph(graph, n, 0.0)
    assert iterations == n
    assert sk.launches == {"sim3_g_terms": 1 + n, "sim3_g_chi2": n + 1}


@pytest.mark.gpu
@pytest.mark.parametrize("fn", [sk.sim3_g_terms, sk.sim3_g_chi2])
def test_kernel_refuses(cuda, fn):
    """float32 points, a non-contiguous operand, CPU operands, CPU / CUDA
    mixed operands and ``meas`` or ``sigma_inv`` off 16 bytes raise;
    nothing is launched."""
    ops = _tensors(_case("scene")[:6], cuda)
    m = ops[2].shape[0]
    sk.reset_launches()
    with pytest.raises(TypeError):
        fn(ops[0].float(), *ops[1:])
    with pytest.raises(ValueError):
        fn(ops[0], ops[1], ops[2].t().contiguous().t(), *ops[3:])
    with pytest.raises(ValueError):
        fn(*(t.cpu() for t in ops))
    with pytest.raises(ValueError):
        fn(ops[0], ops[1], ops[2].cpu(), *ops[3:])
    with pytest.raises(ValueError):
        fn(ops[0].cpu(), *ops[1:])
    meas8 = torch.empty(2 * m + 1, dtype=torch.float64, device=cuda)[1:].view(m, 2)
    with pytest.raises(ValueError):
        fn(*ops[:3], meas8.copy_(ops[3]), *ops[4:])
    info8 = torch.empty(4 * m + 1, dtype=torch.float64, device=cuda)[1:].view(m, 2, 2)
    with pytest.raises(ValueError):
        fn(*ops[:4], info8.copy_(ops[4]), ops[5])
    assert not any(sk.launches.values())


@pytest.mark.gpu
def test_kernel_takes_an_odd_offset_mask(cuda):
    """A ``valid`` mask that starts at an odd byte (a row slice of a larger
    mask) is taken: the kernel reads it a byte at a time.  Both forms give
    what they give on an aligned copy of it."""
    ops = _tensors(_case("invalid")[:6], cuda)
    m = ops[2].shape[0]
    valid1 = torch.zeros(m + 1, dtype=torch.bool, device=cuda)[1:]
    valid1.copy_(ops[5])
    assert valid1.data_ptr() % 2 == 1
    for fn in (sk.sim3_g_terms, sk.sim3_g_chi2):
        got, want = fn(*ops[:5], valid1), fn(*ops)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
