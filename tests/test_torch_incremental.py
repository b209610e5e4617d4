"""The incremental solvers of slampp_tpu_torch against the JAX package: the
NumPy model kernels and the landmark Jacobians, the parser's incremental
hooks, FastL (with the JAX package's own invariant checks), the windowed
solver on its dense and v3 live engines, every-N Gauss-Newton and
``pcg_solve``.  Everything is float64 on the CPU, where each dense kernel
call takes its plain PyTorch version.  Tolerances: kernels 1e-12; FastL
streamed chi2 1e-9 relative, states 1e-9, final chi2 1e-8; windowed chi2
1e-8 relative; discrete counters equal."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jax_asm
from slampp_tpu.core.assembly import _edge_residual_and_jacobians
from slampp_tpu.graph.system import GraphSystem as JaxGraphSystem
from slampp_tpu.graph.types import get_edge_type as jax_edge_type
from slampp_tpu.graph.types import get_vertex_type as jax_vertex_type
from slampp_tpu.io import parser as jax_parser
from slampp_tpu.linear.pcg import pcg_solve as jax_pcg_solve
from slampp_tpu.models import np_kernels as jax_npk
from slampp_tpu.models import se2 as jax_se2
from slampp_tpu.solvers import IncrementalSolver as JaxIncrementalSolver
from slampp_tpu_torch.apps.incremental import run_incremental
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.io import parser
from slampp_tpu_torch.io.datasets import make_city_trees, make_manhattan, make_rocv
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.linear.pcg import pcg_solve
from slampp_tpu_torch.models import np_kernels as npk
from slampp_tpu_torch.models import se2 as port_se2
from slampp_tpu_torch.solvers import (
    DoglegSolver,
    FastLSolver,
    IncrementalSolver,
    WindowedIncrementalSolver,
)
from slampp_tpu_torch.solvers.fastl import supports_system

from _torch_jax_util import jax_incremental

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
EDGES = ["edge_pose2d", "edge_pose_landmark2d_xy", "edge_pose_landmark2d_rb"]


def _parse(text):
    """(port records, JAX records) of one g2o text."""
    with parser.g2o_file(text) as path:
        return parser.parse_file(path), jax_parser.parse_file(path)


def _stream(solver_of, text):
    """A port solver built on an empty system by ``solver_of``, streamed
    through the parse loop's on_edge hook, then refresh_frozen."""
    system = GraphSystem()
    inc = solver_of(system)
    parser.build_system(_parse(text)[0], problem="se2", system=system,
                        on_edge=lambda s, n: inc.incremental_step())
    inc.refresh_frozen()
    return inc


def _states_close(port_system, jax_system, atol):
    for t, rows in jax_system._vstates.items():
        np.testing.assert_allclose(np.stack(port_system._vstates[t]), np.stack(rows),
                                   rtol=0, atol=atol, err_msg=t)


# ------------------------------------------------------------- model kernels


@pytest.mark.parametrize("name", EDGES)
def test_np_kernels_and_jacobians_match_jax(name):
    """The port's NumPy kernels equal the JAX package's; they, and the
    port's analytic torch Jacobians, match the JAX autodiff linearization
    (jax.jacfwd of the error through the retraction) at 1e-12.  The slots'
    retract / local_diff kernels and torch retractions likewise."""
    jet = jax_edge_type(name)
    jvts = tuple(jax_vertex_type(t) for t in jet.vertex_types)
    et = get_edge_type(name)
    rng = np.random.default_rng(3)
    E = 40
    states = tuple(rng.normal(size=(E, vt.state_dim)) * 2 for vt in jvts)
    meas = rng.normal(size=(E, jet.meas_dim))
    if name == "edge_pose_landmark2d_rb":
        meas[:, 0] = np.abs(meas[:, 0]) + 0.5
    r_np, jacs_np = npk.NP_EDGE_LIN[name](states, meas)
    r_jnp, jacs_jnp = jax_npk.NP_EDGE_LIN[name](states, meas)
    f = jax.vmap(lambda *a: _edge_residual_and_jacobians(jet, jvts, a[:-1], a[-1]))
    r_ad, jacs_ad = f(*[jnp.asarray(s) for s in states], jnp.asarray(meas))
    r_t, jacs_t = et.jacobian_fn(tuple(torch.from_numpy(s) for s in states),
                                 torch.from_numpy(meas))
    e_t = et.error_fn(tuple(torch.from_numpy(s) for s in states), torch.from_numpy(meas))
    for r in (r_np, r_jnp, r_t.numpy(), e_t.numpy()):
        np.testing.assert_allclose(r, np.asarray(r_ad), rtol=0, atol=1e-12)
    for k in range(jet.arity):
        for J in (jacs_np[k], jacs_jnp[k], jacs_t[k].numpy()):
            np.testing.assert_allclose(J, np.asarray(jacs_ad[k]), rtol=0, atol=1e-12)
    for vt_name, x in zip(jet.vertex_types, states):
        jvt, vt = jax_vertex_type(vt_name), get_vertex_type(vt_name)
        d = rng.normal(size=(E, jvt.dim)) * 3
        ref = np.asarray(jax.vmap(jvt.retract)(jnp.asarray(x), jnp.asarray(d)))
        np.testing.assert_allclose(npk.NP_RETRACT[vt_name](x.copy(), d), ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(vt.retract(torch.from_numpy(x), torch.from_numpy(d)).numpy(),
                                   ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(npk.NP_LOCAL_DIFF[vt_name](ref.copy(), x),
                                   jax_npk.NP_LOCAL_DIFF[vt_name](ref.copy(), x), rtol=0, atol=0)
        assert vt.is_landmark == jvt.is_landmark and vt.dim == jvt.dim


# ---------------------------------------------------------------- parser hooks


def _with_markers(text, every=37):
    lines = text.splitlines()
    for i in range(every, len(lines), every):
        lines[i] = "CONSISTENCY_MARKER\n" + lines[i]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("graph", ["city-xy", "city-rb", "manhattan"])
def test_build_system_hooks_match_jax(graph):
    """build_system in the JAX argument order: the on_edge / on_marker call
    sequence, the detected problem, the built states and the dense system
    (H, g, chi2) equal the JAX package's."""
    if graph == "manhattan":
        text = make_manhattan(n_poses=150, loop_prob=0.3, seed=4)[0]
    else:
        kind = graph.split("-")[1]
        text = make_city_trees(n_poses=90, n_landmarks=30, obs_kind=kind, seed=5)[0]
    text = _with_markers(text)
    recs, jrecs = _parse(text)
    assert parser.detect_problem(recs) == jax_parser.detect_problem(jrecs)
    calls, jcalls = [], []
    system = parser.build_system(
        recs, None, None,
        lambda s, n: calls.append(("edge", n, s.n_vertices)),
        lambda s: calls.append(("marker", s.n_edges)))
    jsystem = jax_parser.build_system(
        jrecs, None, None,
        lambda s, n: jcalls.append(("edge", n, s.n_vertices)),
        lambda s: jcalls.append(("marker", s.n_edges)))
    assert calls == jcalls and any(c[0] == "marker" for c in calls)
    assert system._vorder == jsystem._vorder and system.edge_type_names == jsystem.edge_type_names
    _states_close(system, jsystem, 0.0)
    H, g, chi2 = assembly.assemble_dense(system.snapshot("cpu"))
    Hj, gj, chi2_j = jax.jit(jax_asm.assemble_dense)(jsystem.snapshot())
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-12, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-8)
    assert abs(float(chi2) - float(chi2_j)) <= 1e-10 * float(chi2_j)


def test_unported_record_kinds_name_their_item():
    """The ROCV record kinds, which the port refused until their model was
    ported, now build what the JAX package's parse loop builds from the
    same records: the same vertices (the receivers initialized from the
    constant-velocity model, the transmitter's landmark prior), edges and
    on_edge calls, and the same Hessian."""
    text, _ = make_rocv(6, 2, seed=3)
    with parser.g2o_file(text) as path:
        recs, jrecs = parser.parse_file(path), jax_parser.parse_file(path)
    assert {r.kind for r in recs} >= {"edge_rocv_range", "edge_rocv_dt", "rocv_transmitter_uf",
                                      "vertex_posvel", "vertex_rocv_lm"}
    assert parser.detect_problem(recs) == jax_parser.detect_problem(jrecs) == "rocv"
    calls, jcalls = [], []
    system = parser.build_system(recs, None, None,
                                 lambda s, n: calls.append((n, s.n_vertices)))
    jsystem = jax_parser.build_system(jrecs, None, None,
                                      lambda s, n: jcalls.append((n, s.n_vertices)))
    assert calls == jcalls
    assert system._vorder == jsystem._vorder and system.edge_type_names == jsystem.edge_type_names
    _states_close(system, jsystem, 0.0)
    H, g, chi2 = assembly.assemble_dense(system.snapshot("cpu"))
    Hj, gj, chi2_j = jax.jit(jax_asm.assemble_dense)(jsystem.snapshot())
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-12, atol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-8)
    assert abs(float(chi2) - float(chi2_j)) <= 1e-10 * float(chi2_j)


# ----------------------------------------------------------------------- FastL

# a small window so that 300 poses see freezes, a refreeze and fluid
# relinearizations
FASTL_N, FASTL_KW = 300, {"chunk": 16, "window": 32}


def test_fastl_matches_jax():
    """FastL streamed over the seed-0 Manhattan graph at every-vertex
    cadence: the same counters, streamed chi2 within 1e-9 relative, states
    within 1e-9, and the same optimize() return with chi2 within 1e-8."""
    jinc = jax_incremental(FASTL_N, "fastl", **FASTL_KW)
    text = make_manhattan(n_poses=FASTL_N, loop_prob=0.1, seed=0)[0]
    inc = _stream(lambda s: FastLSolver(s, solve_period=1, require_loop_closure=False,
                                        device="cpu", **FASTL_KW), text)
    counters = ("n_solves", "n_freezes", "n_refreezes", "n_relin", "n_full_factor",
                "n_resumed_factor")
    assert [getattr(inc, k) for k in counters] == [getattr(jinc, k) for k in counters]
    assert inc.n_refreezes > 0 and inc.n_relin > 0 and inc._N == jinc._N
    inc._sync_states_to_system()
    jinc._sync_states_to_system()
    _states_close(inc.system, jinc.system, 1e-9)
    chi, chi_j = inc.chi2(), jinc.chi2()
    assert abs(chi - chi_j) <= 1e-9 * chi_j
    assert inc.optimize() == jinc.optimize()
    chi, chi_j = inc.chi2(), jinc.chi2()
    assert abs(chi - chi_j) <= 1e-8 * chi_j


def test_fastl_resident_system_and_resumed_factor():
    """The JAX package's invariants (tests/test_fastl.py), on the port: at
    every 7th solve the resident H equals the from-scratch assembly of the
    system's live edges at the solver's linearization points, plus the unary
    factor and the frozen-chunk Schur prior; after every factor the
    resumed factor equals a full Cholesky of H."""
    checked = {"H": 0}

    class Check(FastLSolver):
        def _solve(self):
            super()._solve()
            if self._H is None or self._lin_stale or self.n_solves % 7:
                return
            n = self._N
            Href = np.zeros((n, n))

            def lin(v):
                t, r = self._slot_vtrow[self._slot_of[v]]
                return self._vt_lin[t][r]

            def off(v):
                return self._slot_off[self._slot_of[v]]

            count = 0
            for tname in self.system.edge_type_names:
                rec = self.system._edges[tname]
                for e, vids in enumerate(rec["vids"]):
                    if any(v in self._frozen_of for v in vids):
                        continue
                    count += 1
                    r, jacs = npk.NP_EDGE_LIN[tname](
                        tuple(lin(v)[None] for v in vids), np.asarray(rec["meas"][e])[None])
                    W = np.asarray(rec["sigma_inv"][e])
                    for a, va in enumerate(vids):
                        for b, vb in enumerate(vids):
                            Ja, Jb = jacs[a][0], jacs[b][0]
                            Href[off(va):off(va) + Ja.shape[1],
                                 off(vb):off(vb) + Jb.shape[1]] += Ja.T @ W @ Jb
            anchor = self.system._unary_anchor
            if anchor is not None and anchor in self._slot_of:
                o = off(anchor)
                Href[np.arange(o, o + 3), np.arange(o, o + 3)] += self.system.unary_information
            sep = self._sep_scalars()
            n0 = self._sc.shape[0]
            if n0 and sep is not None:
                sel = sep[:n0]
                ok = sel >= 0
                Href[np.ix_(sel[ok], sel[ok])] += self._sc[np.ix_(ok, ok)]
            assert count == sum(es.n for es in self._E.values())
            np.testing.assert_allclose(Href, self._H[:n, :n], atol=1e-7)
            checked["H"] += 1

        def _factor(self):
            super()._factor()
            n = self._N
            L = np.linalg.cholesky(self._H[:n, :n] + 1e-12 * np.eye(n))
            np.testing.assert_allclose(np.tril(L), np.tril(self._Lf[:n, :n]), atol=1e-6)

    text = make_manhattan(n_poses=FASTL_N, loop_prob=0.1, seed=0)[0]
    inc = _stream(lambda s: Check(s, solve_period=1, require_loop_closure=False, device="cpu",
                                  **FASTL_KW), text)
    assert checked["H"] > 20 and inc.n_freezes >= 1 and inc.n_resumed_factor > 100


def test_fastl_per_step_path_stays_on_the_host(monkeypatch):
    """The per-step path never snapshots, assembles on the device or builds
    a PartitionedSolver (tests/test_fastl.py's no-dispatch contract);
    chi2() does snapshot."""
    calls = []
    for owner, name in ((GraphSystem, "snapshot"), (assembly, "assemble_dense"),
                        (PartitionedSolver, "symbolic")):
        orig = getattr(owner, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(owner, name, spy)
    text = make_manhattan(n_poses=200, loop_prob=0.1, seed=0)[0]
    inc = _stream(lambda s: FastLSolver(s, solve_period=1, require_loop_closure=False,
                                        device="cpu", chunk=32, window=64), text)
    assert inc.n_solves == 199 and inc.n_freezes > 0 and calls == []
    inc.chi2()
    assert calls == ["snapshot"]


def test_fastl_gating_and_missing_kernels():
    """supports_system checks block sizes (a pose + landmark graph mixes 3
    and 2); a type without NumPy kernels takes the torch kernel adapter
    (models/torch_kernel_adapter.py), as the JAX package takes its own."""
    text = make_city_trees(n_poses=60, n_landmarks=20, seed=1)[0]
    system = parser.build_system(_parse(text)[0])
    assert not supports_system(system)
    manhattan = parser.build_system(_parse(make_manhattan(n_poses=30, seed=1)[0])[0])
    assert supports_system(manhattan)
    inc = FastLSolver(manhattan, device="cpu")
    assert inc._edge_lin_fn("edge_pose2d") is npk.NP_EDGE_LIN["edge_pose2d"]
    lin = inc._edge_lin_fn("edge_pose3d")
    r, (j0, j1) = lin((np.zeros((2, 6)), np.zeros((2, 6))), np.zeros((2, 6)))
    assert lin.arity == 2 and r.shape == (2, 6) and j0.shape == j1.shape == (2, 6, 6)
    assert inc._retract_fn("pose3d")(np.zeros((1, 6)), np.ones((1, 6))).shape == (1, 6)


# -------------------------------------------------------------------- windowed

WINDOWED_N, WINDOWED_KW = 260, {"chunk": 32, "window": 64}


@pytest.fixture(scope="module")
def jax_windowed():
    """One JAX run at its default live engine ("auto": dense below its v3
    threshold at this window)."""
    inc = jax_incremental(WINDOWED_N, "windowed", **WINDOWED_KW)
    out = {"chi2_stream": inc.chi2(),
           "counters": [inc.n_solves, inc.n_freezes, inc.n_refreezes, inc.n_relin]}
    out["optimize_return"] = inc.optimize()
    out["chi2_final"] = inc.chi2()
    return out


@pytest.mark.parametrize("live_engine", ["dense", "v3"])
def test_windowed_matches_jax(jax_windowed, live_engine):
    """The windowed solver through the incremental app, on each live engine,
    against the JAX package's run: streamed and final chi2 within 1e-8
    relative, the same counters and optimize() return; the v3 engine takes
    every full solve."""
    res = run_incremental(WINDOWED_N, "cpu", "windowed", live_engine=live_engine, **WINDOWED_KW)
    c = res["counters"]
    assert [c["n_solves"], c["n_freezes"], c["n_refreezes"], c["n_relin"]] == \
        jax_windowed["counters"]
    assert res["full_solves"]["v3_fallback"] == 0 and res["full_solves"]["tail"] > 0
    other = "dense" if live_engine == "v3" else "v3"
    assert res["full_solves"][live_engine] > 0 and res["full_solves"][other] == 0
    assert res["optimize_return"] == jax_windowed["optimize_return"]
    for k in ("chi2_stream", "chi2_final"):
        assert abs(res[k] - jax_windowed[k]) <= 1e-8 * jax_windowed[k], k
    assert res["states"]["pose2d"].shape == (WINDOWED_N, 3)


# -------------------------------------------------------------------- every-N


@pytest.mark.parametrize("hook", ["vids", "on_edge"])
def test_incremental_solver_matches_jax(hook):
    """Every-N GN on tests/test_incremental.py's graph (150 poses, 0.4 loop
    probability), solve_period 10, 3 iterations: with each edge's vertex ids
    (the loop-closure gate) or through the parser's on_edge hook (no ids:
    every step is a closure).  Same solves and iterations, states within
    1e-9, chi2 and the final optimize within 1e-8."""
    text = make_manhattan(n_poses=150, loop_prob=0.4, loop_separation=15, loop_radius=4.0,
                          seed=2)[0]
    recs, jrecs = _parse(text)
    system, jsystem = GraphSystem(), JaxGraphSystem()
    inc = IncrementalSolver(system, solve_period=10, max_iterations=3, device="cpu")
    jinc = JaxIncrementalSolver(jsystem, solve_period=10, max_iterations=3)
    if hook == "vids":
        for rec, jrec in zip(recs, jrecs):
            system.add_edge("edge_pose2d", rec.ids, rec.values, rec.info,
                            port_se2.POSE_POSE_INITIALIZERS)
            inc.incremental_step(rec.ids)
            jsystem.add_edge("edge_pose2d", jrec.ids, jrec.values, jrec.info,
                             jax_se2.POSE_POSE_INITIALIZERS)
            jinc.incremental_step(jrec.ids)
    else:
        parser.build_system(recs, "se2", system, lambda s, n: inc.incremental_step())
        jax_parser.build_system(jrecs, "se2", jsystem, lambda s, n: jinc.incremental_step())
    assert (inc.n_solves, inc.n_iterations) == (jinc.n_solves, jinc.n_iterations)
    assert inc.n_solves > 2
    _states_close(system, jsystem, 1e-9)
    assert abs(inc.chi2() - jinc.chi2()) <= 1e-8 * (1 + jinc.chi2())
    assert inc.optimize(10, 1e-6) == jinc.optimize(10, 1e-6)
    assert abs(inc.chi2() - jinc.chi2()) <= 1e-8 * (1 + jinc.chi2())


@pytest.mark.parametrize("block_size", [0, 3])
def test_pcg_solve_matches_jax(block_size):
    rng = np.random.default_rng(7)
    G = rng.normal(size=(60, 60))
    H = G @ G.T + 60 * np.eye(60)
    b = rng.normal(size=60)
    x = pcg_solve(torch.from_numpy(H), torch.from_numpy(b), block_size).numpy()
    xj = np.asarray(jax_pcg_solve(jnp.asarray(H), jnp.asarray(b), block_size))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(x, np.linalg.solve(H, b), rtol=0, atol=1e-8 * np.abs(xj).max())


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("entry", ["fastl", "windowed", "every-n", "cli"])
def test_incremental_entry_points_default_to_the_card(entry):
    """Without ``device="cpu"`` the solvers and the app run on the card;
    with no card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        return
    if entry == "cli":
        out = subprocess.run([sys.executable, "-m", "slampp_tpu_torch.apps.incremental", "30"],
                             capture_output=True, text=True, cwd=ROOT)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr and not out.stdout
        return
    cls = {"fastl": FastLSolver, "windowed": WindowedIncrementalSolver,
           "every-n": IncrementalSolver}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(GraphSystem())


def test_port_reads_no_slampp_environment():
    """The JAX package's SLAMPP_* knobs are constructor keywords in the
    port: no module of the port, and not chip_smoke.py, reads one."""
    files = list((ROOT / "slampp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{f.name}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if re.search(r"os\.environ|getenv", line) and "SLAMPP_" in line]
    assert not bad, bad


def test_dogleg_auto_refuses_large_landmark_graphs():
    """DoglegSolver("auto") takes the sparse Schur engine on a landmark
    graph of 1500 vertices or more, as the JAX package does (it used to
    refuse there while that engine was not ported); below that it stays
    dense."""
    text = make_city_trees(n_poses=1500, n_landmarks=60, seed=0)[0]
    system = parser.build_system(_parse(text)[0])
    assert system.n_vertices >= 1500
    assert DoglegSolver(system, device="cpu")._resolve_engine() == "schur_sparse"
    small = parser.build_system(_parse(make_city_trees(n_poses=300, n_landmarks=60,
                                                       seed=0)[0])[0])
    assert DoglegSolver(small, device="cpu")._resolve_engine() == "dense"