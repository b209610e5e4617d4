"""Sim(3) bundle adjustment with local inverse-distance landmarks
(``models/sim3.embed_ba_system_sim3_invdist``: SLAM++'s CVertexInvDist with
the unary LS and ternary LO edges) on the sparse Schur engine's ternary
kind: the closed-form Jacobians against forward-mode autodiff, the
engine's step against the dense engine's, its kept pairs against the
global embedding's, its spans, the benchmark route ``sim3_invdist_lm``
against the plain reference ``portbench/reference/sim3_invdist_lm.py``,
and the binary path's bits unchanged."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench.reference import sim3_invdist_lm as ref
from portbench.reference import sim3_lm as ref_g
from portbench.routes.sim3_invdist_lm import Route
from portbench.routes.sim3_lm import Route as RouteG
from portbench.traffic import venice
from slampp_tpu_torch.apps.sim3 import venice_ba_system
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.types import autodiff_jacobian, get_edge_type
from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3, embed_ba_system_sim3_invdist
from slampp_tpu_torch.solvers.lm import LevenbergMarquardtSolver, _damped_step
from tests.test_torch_spans import _names, _tree

ROOT = Path(__file__).resolve().parents[1]
LS, LO = "edge_p2c_invdist_sim3_ls", "edge_p2c_invdist_sim3_lo"
# above the sparse Schur engine's 1500-vertex gate, with more cameras than
# a track's arc spans (no camera sees a point twice)
N_CAMS, N_POINTS, TRACK = 130, 1500, 4
SCENE = {"name": "venice", "args": {"n_cams": N_CAMS, "n_points": N_POINTS, "mean_track": TRACK,
                                    "cam_rot_sigma": 0.002, "cam_t_sigma": 0.03}}
SOLVE = {"max_iterations": 5, "min_dx_norm": 0.0, "tau": 1e-3}


@pytest.fixture(scope="module")
def scene():
    """(the BA system, its invdist embedding, a snapshot of it)."""
    ba = venice_ba_system(N_CAMS, N_POINTS, TRACK)
    system = embed_ba_system_sim3_invdist(ba)
    return ba, system, system.snapshot("cpu")


def test_embedding_owns_each_point_by_its_first_observation(scene):
    ba, system, graph = scene
    rec = ba._edges["edge_p2c"]
    vids = np.asarray(rec["vids"])
    n_obs, n_pts = len(vids), len(np.unique(vids[:, 0]))
    assert system.edge_count(LS) == n_pts and system.edge_count(LO) == n_obs - n_pts
    assert system.vertex_type_names == ["camsim3", "invdist"]
    assert system._vorder == ba._vorder
    # the gauge: vertex 0 is camera 0, held by the first LO edge
    assert system._unary_anchor == 0 and 0 in system._edges[LO]["vids"][0]
    first = {}
    for (p, c), uv in zip(vids.tolist(), rec["meas"]):
        first.setdefault(p, (c, uv))
    for (p,), z in zip(system._edges[LS]["vids"], system._edges[LS]["meas"]):
        c, uv = first[p]
        np.testing.assert_array_equal(z[0:2], uv)
        np.testing.assert_array_equal(z[2:7], ba.vertex_state(c)[6:11])
    for p, o, _ in system._edges[LO]["vids"]:
        assert o == first[p][0]
    # the start point lies on the owner's ray at its distance, so each
    # owner's own observation reprojects exactly at the start
    r = get_edge_type(LS).error_fn(assembly.slot_states(get_edge_type(LS), graph.edges[LS],
                                                        graph.states), graph.edges[LS].meas)
    assert float(r.abs().max()) < 1e-9
    np.testing.assert_allclose(torch.linalg.vector_norm(graph.states["invdist"][:, 1:4], dim=1),
                               1.0, rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", [LS, LO])
def test_closed_form_jacobians_match_autodiff(scene, name):
    _, _, graph = scene
    et = get_edge_type(name)
    states = assembly.slot_states(et, graph.edges[name], graph.states)
    meas = graph.edges[name].meas
    r, jacs = et.jacobian_fn(states, meas)
    ra, jacs_a = autodiff_jacobian(et.error_fn, et.vertex_types)(states, meas)
    assert torch.equal(r, ra)
    assert [J.shape[1:] for J in jacs] == [(2, 1)] + [(2, 7)] * (et.arity - 1)
    for J, Ja in zip(jacs, jacs_a):
        np.testing.assert_allclose(J, Ja, rtol=0, atol=1e-10)


def test_ternary_step_matches_the_dense_engine(scene):
    _, system, graph = scene
    ss = SparseSchurSolver(system, mixed_precision=False, device="cpu")
    ss.ensure_symbolic()
    H, g, _ = assembly.assemble_dense(graph)
    alpha0 = 1e-3 * float(assembly.max_edge_hessian_diag(graph))  # the LM's first damping
    for alpha in (alpha0, 1e-3 * alpha0):
        new, _, _, chi2 = ss.damped_step(graph, alpha)
        want, _, _, _ = _damped_step(graph, H, g, alpha)
        for t in new:
            np.testing.assert_allclose(new[t], want[t], rtol=0, atol=1e-9, err_msg=t)
        assert float(chi2) == pytest.approx(float(assembly.graph_chi2(graph)), rel=1e-12)
    # the dogleg's pieces: the true gradient and H v without H
    terms = ss._edge_terms(graph)
    np.testing.assert_allclose(ss._gradient(graph, terms), g, rtol=0,
                               atol=1e-12 * float(g.abs().max()))
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(graph.state_dim, dtype=torch.float64, generator=gen)
    Hv = H @ v
    np.testing.assert_allclose(ss._hessian_matvec(graph, terms, v), Hv, rtol=0,
                               atol=1e-12 * float(Hv.abs().max()))
    _, pred, dxn, _ = ss.dogleg_step(graph, 1e-3)
    assert float(dxn) == pytest.approx(1e-3) and float(pred) > 0


def test_kept_pairs_equal_the_global_embedding(scene):
    ba, system, _ = scene
    ss = SparseSchurSolver(system, device="cpu")
    ss.ensure_symbolic()
    glob = SparseSchurSolver(embed_ba_system_sim3(ba), device="cpu")
    glob.ensure_symbolic()
    p, pg = ss.plan, glob.plan
    n_lo = system.edge_count(LO)
    assert (p.n_ternary, p.n_rows, p.n_l, p.dl) == (n_lo, system.n_edges, pg.n_l, 1)
    assert (pg.n_ternary, pg.n_rows) == (0, pg.pl_lm.shape[0])
    assert p.n_pairs == pg.n_pairs == p.slots.pair_e.shape[0]
    # each LO edge's three camera blocks, and no pose-landmark head block
    assert p.n_heads == p.slots.heads.shape[0] and p.n_heads <= 3 * n_lo
    assert (p.hp_pose.shape[0], p.cpl_pose.shape[0]) == (0, 2 * n_lo)


def test_ternary_step_opens_the_rows_span(scene):
    _, system, _ = scene
    lm = LevenbergMarquardtSolver(system, use_schur=True, device="cpu")
    assert lm._resolve_engine() == "schur_sparse"
    lm._ss_solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, applied, iterations = lm.optimize_graph(system.snapshot("cpu"), 2, 0.0)
    passes = _tree(prof, ("lm.", "ss."))[0][1]
    assert iterations == 2 and applied == 2
    for _, inner in passes[1:]:
        assert _names(inner) == ["ss.edge_terms", "ss.rows", "ss.landmarks", "ss.pairs",
                                 "ss.assemble", "ss.backsub", "lm.chi2", "lm.accept"]


def test_other_arities_raise():
    ba = venice_ba_system(6, 40, 4)
    system = embed_ba_system_sim3(ba)
    system.add_vertex("xyz", 10_000, np.zeros(3))
    system.add_edge("edge_p2c_xyz_sim3_lo", (10_000, 0, 0), np.zeros(2), np.eye(2))
    with pytest.raises(ValueError, match="both pose slots"):
        SparseSchurSolver(system, device="cpu").symbolic()


@pytest.mark.parametrize("seed", [11, 2147483659])
def test_route_matches_the_reference_under_the_cells_limits(seed):
    cell, _ = harness.cell_files("venice871_sim3_invdist.lm")
    limits = cell["limits"]
    route = Route({"generator": SCENE}, SOLVE, seed, "cpu")
    assert route.lm._resolve_engine() == "schur_sparse"
    raw, iterations = route.solve()
    assert iterations == 5
    r = ref.run(route.inputs(), SOLVE, "cpu")
    assert r["iterations"] == 5 and r["chi2"] < 0.5 * r["chi2_accepted"][0]
    nums = ref.compare(r, route.output(raw))
    assert all(nums[k] <= v for k, v in limits.items()), nums
    # in float64 end to end the two meet far inside them
    route.lm._ss_solver().mixed_precision = False
    nums = ref.compare(r, route.output(route.solve()[0]))
    assert nums["resid_err"] < 1e-9 and nums["chi2_rel"] < 1e-12, nums
    # the cell's control, the reference with float32 edge terms, fails them
    c = ref.run(route.inputs(), SOLVE, "cpu", **cell["control"]["reference"])
    nums = ref.compare(r, {"cams": c["cams"], "points": c["points"]})
    assert any(nums[k] > v for k, v in limits.items()), nums


def test_route_mixed_precision_key_sets_the_factor():
    # absent, the engine's default (a float32 factor); false, float64 end to
    # end, as the engine set so after its construction gives
    exact = Route({"generator": SCENE}, {**SOLVE, "mixed_precision": False}, 11, "cpu")
    default = Route({"generator": SCENE}, SOLVE, 11, "cpu")
    assert exact.lm._ss_solver().mixed_precision is False
    assert default.lm._ss_solver().mixed_precision is True
    raw_d = default.solve()[0]
    default.lm._ss_solver().mixed_precision = False
    raw_p, raw_e = default.solve()[0], exact.solve()[0]
    assert all(torch.equal(raw_e[k], raw_p[k]) for k in raw_e)
    assert not all(torch.equal(raw_e[k], raw_d[k]) for k in raw_e)


def test_reference_step_solves_the_full_system():
    cams, pts, oc, op, uv, info, _ = venice.make_venice_ba_arrays(
        n_cams=8, n_points=60, mean_track=4, seed=3)
    prob = ref.Problem(cams, pts, oc, op, uv, info, "cpu")
    alpha = 1e-6 * prob.max_hessian_diag(prob.cams0, prob.q0)
    nc, nq, _, _ = prob.step(prob.cams0, prob.q0, alpha, pair_chunk=16)
    # dense: H = J^T W J + alpha I + the anchor on camera 0, dx = -H^-1 g
    (r_ls, jq_ls), (r, jq, jo, jc) = prob.jacobians(prob.cams0, prob.q0)
    n_c, n_p = prob.n_c, prob.n_p
    rows = []
    for k, e in enumerate(prob.ls.tolist()):
        J = torch.zeros(2, 7 * n_c + n_p, dtype=torch.float64)
        J[:, 7 * n_c + int(prob.op[e])] = jq_ls[k, :, 0]
        rows.append((J, r_ls[k], prob.W[e]))
    for k, e in enumerate(prob.lo.tolist()):
        J = torch.zeros(2, 7 * n_c + n_p, dtype=torch.float64)
        o, c = int(prob.oo[e]), int(prob.oc[e])
        J[:, 7 * o:7 * o + 7] += jo[k]
        J[:, 7 * c:7 * c + 7] += jc[k]
        J[:, 7 * n_c + int(prob.op[e])] = jq[k, :, 0]
        rows.append((J, r[k], prob.W[e]))
    H = sum(J.T @ W @ J for J, _, W in rows) + alpha * torch.eye(7 * n_c + n_p,
                                                                 dtype=torch.float64)
    H[0:7, 0:7] += torch.eye(7, dtype=torch.float64)
    dx = -torch.linalg.solve(H, sum(J.T @ W @ res for J, res, W in rows))
    np.testing.assert_allclose(nq - prob.q0, dx[7 * n_c:], rtol=1e-8, atol=1e-12)
    expect = ref_g.retract_cameras(prob.cams0, dx[:7 * n_c].reshape(n_c, 7))
    np.testing.assert_allclose(nc, expect, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("part", ["f32_edge_terms"])
def test_reference_control_moves_the_step_by_rounding(part):
    cams, pts, oc, op, uv, info, _ = venice.make_venice_ba_arrays(
        n_cams=8, n_points=60, mean_track=4, seed=3)
    exact = ref.Problem(cams, pts, oc, op, uv, info, "cpu")
    rounded = ref.Problem(cams, pts, oc, op, uv, info, "cpu", **{part: True})
    alpha = 1e-3 * exact.max_hessian_diag(exact.cams0, exact.q0)  # the LM's first damping
    nc, nq, _, _ = exact.step(exact.cams0, exact.q0, alpha, pair_chunk=16)
    nc32, nq32, _, _ = rounded.step(rounded.cams0, rounded.q0, alpha, pair_chunk=16)
    assert nc32.dtype == nq32.dtype == torch.float64
    step = torch.cat([(nc - exact.cams0).reshape(-1), nq - exact.q0])
    gap = torch.cat([(nc32 - nc).reshape(-1), nq32 - nq])
    # float32 rounding of one part: the step moves, by far less than itself
    assert 1e-9 < float(gap.abs().max() / step.abs().max()) < 0.05


def test_reference_loads_no_program():
    code = ("import json, sys\n"
            "import portbench.reference.sim3_invdist_lm\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "    ('jax', 'jaxlib', 'flax', 'slampp_tpu', 'slampp_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------- the binary path's bits
# sha256 digests of the binary (global XYZ) path on venice871_sim3's small
# case at seed 7, taken from the engine before it took ternary edges: its
# plan's tables, one damped step at alpha 0.5 and one route solve
BINARY_DIGESTS = {
    "plan": "1db16d6cdc979cde17471a7b3f0be1bd0a117a3df64770a51c01ab0f9c2dfd27",
    "step": "ffa14d3a7a5d7aa0e7b607c48f8ca1117ca3f9cec0bcf1f3830c3b49dc7a586a",
    "solve": "372c85245e692af8e8a349db2b48ea6179174b539fddbae83b146ac41e585484",
}
SCENE_G = {"name": "venice", "args": {"n_cams": 24, "n_points": 1600, "mean_track": 4,
                                      "cam_rot_sigma": 0.002, "cam_t_sigma": 0.03}}


def _digest(xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _plan_arrays(p):
    out = [p.slots.out, p.slots.hptr, p.slots.heads, p.slots.pptr, p.slots.pair_e,
           p.slots.pair_f, p.slot_inv, p.pl_lm, p.pl_pose, p.pose_dx_offsets, p.lm_dx_offsets,
           p.pp_ei, p.pp_ej, p.inv_map, p.lm_sort]
    for grp in (p.rsrc_grp, p.lm_grp, p.slots.grp):
        for b in grp.buckets:
            out += [b.seg_ids, b.idx]
    return out


def test_binary_path_keeps_its_bits():
    route = RouteG({"generator": SCENE_G}, SOLVE, 7, "cpu")
    ss = route.lm._ss_solver()
    p = ss.plan
    assert p.rows is None and p.n_ternary == 0 and p.row_lm is p.pl_lm
    states, denom, dxn, chi2 = ss.damped_step(route.start, 0.5)
    raw, iterations = route.solve()
    assert iterations == 5
    assert {"plan": _digest(_plan_arrays(p)),
            "step": _digest([states[t] for t in sorted(states)] + [denom, dxn, chi2]),
            "solve": _digest([raw[t] for t in sorted(raw)])} == BINARY_DIGESTS
