"""Shared helpers of the tests/test_torch_*.py files: build the same graph in
both packages, and hand JAX objects to the port as NumPy arrays through
slampp_tpu_torch.interop."""

import contextlib
import os

import numpy as np


def _with_text_file(text, fn):
    from slampp_tpu_torch.io.parser import g2o_file

    with g2o_file(text) as path:
        return fn(path)


def jax_system(n_poses, seed=0, loop_prob=0.1):
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=loop_prob, seed=seed)
    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def port_system(n_poses, seed=0, loop_prob=0.1):
    from slampp_tpu_torch.io.datasets import make_manhattan
    from slampp_tpu_torch.io.parser import build_system, parse_file

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=loop_prob, seed=seed)
    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def jax_sphere_text(n_poses, n_rings=None, seed=0, landmarks=False):
    """The JAX package's generator on the port's ``io/datasets.sphere_text``
    arguments (``default_rings`` unless ``n_rings``)."""
    from slampp_tpu.io.datasets import make_sphere, make_sphere_landmarks

    from slampp_tpu_torch.io.datasets import default_rings

    rings = default_rings(n_poses) if n_rings is None else n_rings
    make = make_sphere_landmarks if landmarks else make_sphere
    return make(n_poses=n_poses, n_rings=rings, seed=seed)[0]


def jax_sphere_system(n_poses, n_rings=None, seed=0, landmarks=False):
    """The JAX package's sphere graph, as the port's ``apps/sphere.sphere_system``
    builds its own."""
    from slampp_tpu.io.parser import build_system, parse_file

    text = jax_sphere_text(n_poses, n_rings, seed, landmarks)
    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def jax_text_system(text):
    """The JAX package's GraphSystem of a g2o text, through its parser."""
    from slampp_tpu.io.parser import build_system, parse_file

    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def port_text_system(text):
    """The port's GraphSystem of a g2o text, through its parser."""
    from slampp_tpu_torch.io.parser import build_system, parse_file

    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def ba_scene_text(n_cams=8, n_points=120, **kw):
    from slampp_tpu.io.datasets import make_ba_scene

    return make_ba_scene(n_cams=n_cams, n_points=n_points, **kw)[0]


def city_text(n_poses, n_landmarks, seed=0):
    from slampp_tpu.io.datasets import make_city_trees

    return make_city_trees(n_poses=n_poses, n_landmarks=n_landmarks, seed=seed)[0]


def jax_venice_solver(n_cams, n_points, mean_track, sc_f64, pair_f32=True):
    """The JAX package's BigBASolver on ``make_venice_ba_arrays``' seed-0
    scene, as ``bench_venice`` builds it."""
    from slampp_tpu.io.datasets import make_venice_ba_arrays
    from slampp_tpu.linear.ba_schur import BigBASolver

    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    return BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, sc_f64=sc_f64,
                                   pair_f32=pair_f32)


def jax_venice_reference(n_cams=871, n_points=110_000, mean_track=10, sc_f64=False,
                         pair_f32=True):
    """chip_smoke.py's venice reference: ``bench_venice``'s loop (one first
    step, then 5 LM iterations with min_dx_norm=0) in the JAX package on the
    CPU: chi2 before and after, the accepted steps and the seconds it took."""
    import time

    t0 = time.perf_counter()
    solver = jax_venice_solver(n_cams, n_points, mean_track, sc_f64, pair_f32)
    solver._make_step()
    chi2_0 = float(solver._chi2_fn(solver.plan, solver._cams, solver._lms))
    solver._step(solver._cams, solver._lms, 1e-3)[2].block_until_ready()
    applied = solver.optimize(max_iterations=5, min_dx_norm=0.0)
    return {"n_cams": n_cams, "n_points": n_points, "mean_track": mean_track,
            "sc_f64": sc_f64, "pair_f32": pair_f32, "n_obs": int(solver.plan.n_obs),
            "chi2_init": chi2_0,
            "chi2_final": solver.chi2(), "lm_accepted": applied,
            "seconds": time.perf_counter() - t0}


def jax_sim3_venice(n_cams=871, n_points=110_000, mean_track=10, iters=5, mixed=True):
    """apps/sim3.run_sim3_venice's procedure in the JAX package on the CPU:
    the seed-0 venice-class scene as a cam / xyz GraphSystem (cameras
    first, then points, one edge_p2c per observation), embedded in Sim(3),
    LM with ``use_schur`` (the sparse Schur engine; ``mixed=False`` its
    float64 mode), ``iters`` iterations with min_dx_norm 0."""
    import time

    from slampp_tpu.graph.system import GraphSystem
    from slampp_tpu.io.datasets import make_venice_ba_arrays
    from slampp_tpu.linear.schur_sparse import SparseSchurSolver
    from slampp_tpu.models.sim3 import embed_ba_system_sim3
    from slampp_tpu.solvers.lm import LevenbergMarquardtSolver

    t0 = time.perf_counter()
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    ba = GraphSystem()
    n_c = len(cams)
    for c in range(n_c):
        ba.add_vertex("cam", c, cams[c])
    for p in range(len(lms)):
        ba.add_vertex("xyz", n_c + p, lms[p])
    for e in range(len(oc)):
        ba.add_edge("edge_p2c", (n_c + int(ol[e]), int(oc[e])), uv[e], info[e])
    system = embed_ba_system_sim3(ba)
    lm = LevenbergMarquardtSolver(system, use_schur=True)
    engine = lm._resolve_engine()
    out = {"n_cams": n_cams, "n_points": n_points, "mean_track": mean_track, "mixed": mixed,
           "engine": engine, "n_obs": system.n_edges, "chi2_init": lm.chi2()}
    try:
        if engine == "schur_sparse":
            lm._ss = SparseSchurSolver(system, mixed_precision=mixed)
            lm._ss.ensure_symbolic()
        applied = lm.optimize(iters, 0.0)
    except ValueError as exc:  # the sparse Schur engine's separator gate
        return {**out, "error": str(exc), "seconds": time.perf_counter() - t0}
    return {**out, "chi2_final": lm.chi2(), "lm_accepted": applied,
            "seconds": time.perf_counter() - t0}


def jax_spcg(system, max_iters=5, min_dx=0.01):
    """The JAX package's SPCGSolver.optimize, step by step through its
    jitted step, which also returns each step's CG iteration count:
    (chi2, applied, CG counts)."""
    from slampp_tpu.linear.spcg import SPCGSolver

    spcg = SPCGSolver(system)
    spcg.ensure_symbolic()
    step = spcg._step_fn()
    graph = system.snapshot()
    applied, counts = 0, []
    for _ in range(max_iters):
        new_states, dxn, _, k = step(graph)
        counts.append(int(k))
        if not np.isfinite(float(dxn)) or float(dxn) <= min_dx:
            break
        graph = graph.replace_states(new_states)
        applied += 1
    system.update_states(dict(graph.states))
    return spcg.chi2(), applied, counts


def _perturb_states(system, eps, seed):
    """Scale every start state entry by 1 + eps N(0, 1), seeded."""
    rng = np.random.default_rng(seed)
    for lst in system._vstates.values():
        for i, st in enumerate(lst):
            lst[i] = np.asarray(st) * (1.0 + eps * rng.standard_normal(np.shape(st)))
    return system


def jax_sensitivity(seeds=3, eps=1e-15):
    """How the JAX package's own results move when its start states are
    scaled entry by entry by 1 + eps N(0, 1) (``seeds`` seeds): SPCG on
    manhattan500 (chi2, CG counts; at manhattan3500 every step takes the
    200-iteration cap) and dense GN on make_rocv(1000, 8)
    (15 iterations, min_dx_norm 0: chi2 at each step's entry and after),
    unperturbed and perturbed."""
    from slampp_tpu.io.datasets import make_rocv
    from slampp_tpu.solvers import gauss_newton as jgn

    rocv_text = make_rocv(1000, 8, seed=0)[0]
    orig_step = jgn._gn_step
    out = {}
    for seed in [None] + list(range(seeds)):
        name = "jax" if seed is None else f"jax, seed {seed}"
        system = jax_system(500)
        if seed is not None:
            _perturb_states(system, eps, seed)
        chi2, applied, counts = jax_spcg(system)
        out[f"spcg, {name}"] = {"chi2": chi2, "applied": applied, "cg_counts": counts}

        system = jax_text_system(rocv_text)
        if seed is not None:
            _perturb_states(system, eps, seed)
        seen = []

        def step(*a, **k):
            res = orig_step(*a, **k)
            seen.append(float(res[2]))
            return res

        jgn._gn_step = step
        try:
            gn = jgn.GaussNewtonSolver(system, linear_solver="dense")
            applied = gn.optimize(15, 0.0)
        finally:
            jgn._gn_step = orig_step
        out[f"rocv, {name}"] = {"chi2_steps": seen, "chi2": gn.chi2(), "applied": applied}
    return out


def jax_sim3_references():
    """chip_smoke.py's Sim(3), ROCV, Spheron and SPCG references on the CPU:
    the venice871-class Sim(3) procedure at full size (the JAX package's
    sparse Schur engine refuses its reduced camera system at the
    separator gate: the error is recorded) and at 871 cameras and 30,000
    points, which it takes (mixed, as the card runs it); its chi2 at the
    start, before the engine's symbolic phase, at full size; ref_parity.py's
    sim3_ba_10cam_200pts (dense LM, 20 iterations); make_rocv(1000, 8)
    (dense GN, 15 iterations, min_dx_norm 0); make_spheron(64, 2000) (GN
    with use_schur: the sparse Schur engine, mixed); SPCG on
    manhattan3500."""
    from slampp_tpu.io.datasets import make_rocv, make_spheron
    from slampp_tpu.models.sim3 import embed_ba_system_sim3
    from slampp_tpu.solvers.gauss_newton import GaussNewtonSolver
    from slampp_tpu.solvers.lm import LevenbergMarquardtSolver

    out = {"sim3-venice": jax_sim3_venice()}
    out["sim3-venice-ref"] = jax_sim3_venice(871, 30_000, 10)
    system = embed_ba_system_sim3(jax_text_system(ba_scene_text(10, 200, seed=5)))
    lm = LevenbergMarquardtSolver(system)
    applied = lm.optimize(20, 1e-6)
    out["sim3-small"] = {"chi2": lm.chi2(), "applied": applied}
    for phase, text, kw, it, mdx in (
            ("rocv", make_rocv(1000, 8, seed=0)[0], {"linear_solver": "dense"}, 15, 0.0),
            ("spheron", make_spheron(64, 2000, seed=0)[0], {"use_schur": True}, 5, 0.01)):
        system = jax_text_system(text)
        gn = GaussNewtonSolver(system, **kw)
        applied = gn.optimize(it, mdx)
        out[phase] = {"chi2": gn.chi2(), "applied": applied, "solver": gn._resolve_solver()}
    chi2, applied, counts = jax_spcg(jax_system(3500))
    out["spcg"] = {"chi2": chi2, "applied": applied, "cg_counts": counts}
    return out


def jax_ba_references():
    """chip_smoke.py's BA references, on the CPU: the venice871-class scene
    with a float32 SC (float32 pair products, the bench's setting) and a
    float64 one (float64 pair products: with float32 ones the float64 SC's
    LM run follows their rounding, PERF.md), LM on ``make_ba_scene`` with
    the dense Schur engine, dogleg on cityTrees10k through the sparse Schur
    engine, and the Schur marginals of ``make_ba_scene``'s Hessian."""
    from slampp_tpu.core import assembly
    from slampp_tpu.linear.schur import build_schur_plan
    from slampp_tpu.marginals.ba_marginals import schur_marginals
    from slampp_tpu.solvers.dogleg import DoglegSolver
    from slampp_tpu.solvers.lm import LevenbergMarquardtSolver

    out = {"ba-venice": jax_venice_reference(sc_f64=False),
           "ba-venice-f64": jax_venice_reference(sc_f64=True, pair_f32=False)}
    system = jax_text_system(ba_scene_text(20, 500))
    lm = LevenbergMarquardtSolver(system, use_schur=True)
    applied = lm.optimize(5, 0.01)
    out["ba-schur"] = {"n_cams": 20, "n_points": 500, "chi2_final": lm.chi2(), "applied": applied}
    system = jax_text_system(city_text(10000, 100))
    dl = DoglegSolver(system)
    assert dl._resolve_engine() == "schur_sparse"
    applied = dl.optimize(5, 0.01)
    out["city-schur-sparse"] = {"n_poses": 10000, "n_landmarks": 100,
                                "chi2_final": dl.chi2(), "applied": applied}
    system = jax_text_system(ba_scene_text(20, 500))
    H, _, _ = assembly.assemble_dense(system.snapshot())
    cc, ll = schur_marginals(H, build_schur_plan(system), alpha=1e-2)
    cc, ll = np.asarray(cc), np.asarray(ll)
    out["ba-marginals"] = {"trace_cc": float(np.trace(cc)),
                           "trace_ll": float(np.trace(ll, axis1=1, axis2=2).sum()),
                           "cam0": cc[:6, :6].tolist(), "lm0": ll[0].tolist()}
    return out


class VeniceStandIn:
    """What the JAX package's ``build_big_ba_shards`` reads of a
    GraphSystem, made from ``make_venice_ba_arrays``' arrays (cameras are
    vertices 0 .. n_c - 1, landmarks n_c ..; the gauge anchor camera 0, as
    the port's ``from_arrays``), so that no million-edge GraphSystem is
    built."""

    def __init__(self, cams, lms, oc, ol, uv, info):
        n_c = len(cams)
        self._states = np.concatenate([np.asarray(cams), np.pad(np.asarray(lms), ((0, 0), (0, 8)))])
        self.vertex_index = {i: ("cam", i) for i in range(n_c)}
        self.vertex_index.update({n_c + j: ("xyz", j) for j in range(len(lms))})
        self._dims = {"cam": 11, "xyz": 3}
        self._edges = {"edge_p2c": {"vids": list(zip((n_c + np.asarray(ol)).tolist(),
                                                     np.asarray(oc).tolist())),
                                    "meas": uv, "sigma_inv": info}}
        self._unary_anchor = 0

    def vertex_state(self, v):
        return self._states[v][: self._dims[self.vertex_index[v][0]]]


def jax_dist_gn_reference(n_poses=3500, n_steps=5):
    """chip_smoke.py's dist-gn reference: the JAX package's
    distributed_gn_step iterated ``n_steps`` times on a 1-device CPU mesh
    on the seed-0 Manhattan graph: chi2 at each step's input and after the
    last."""
    from slampp_tpu.core.assembly import graph_chi2
    from slampp_tpu.parallel import distributed_gn_step, make_mesh, shard_graph_edges

    mesh = make_mesh(1)
    graph = shard_graph_edges(jax_system(n_poses).snapshot(), mesh)
    chi2 = []
    for _ in range(n_steps):
        states, _, c2 = distributed_gn_step(graph, mesh)
        graph = graph.replace_states(states)
        chi2.append(float(c2))
    return {"n_poses": n_poses, "chi2": chi2, "chi2_final": float(graph_chi2(graph))}


def jax_segsum_exact(data, starts, ends):
    """The JAX package's sorted segment sums (``distributed_ba._segsum``:
    a difference of two entries of one running prefix sum) as one scatter
    sum per segment, which keeps each segment's own rounding: at
    871 / 30,000 the prefix sums' cancellation moves the landmark marginals
    by up to twice their largest entry."""
    import jax
    import jax.numpy as jnp

    ids = jnp.searchsorted(ends, jnp.arange(data.shape[0]), side="right")
    return jax.ops.segment_sum(data, ids, num_segments=starts.shape[0] + 1)[: starts.shape[0]]


def jax_dist_marginals(scene, alpha=1e-2, exact=True):
    """The JAX package's distributed_big_ba_marginals on a 1-device CPU mesh
    on a venice-class scene's arrays: (camera blocks, landmark blocks),
    with exact segment sums (``jax_segsum_exact``) unless ``exact`` is
    false."""
    from slampp_tpu.parallel import distributed_ba as jdba
    from slampp_tpu.parallel.distributed import make_mesh

    mesh = make_mesh(1, axis="lm")
    shards = jdba.build_big_ba_shards(VeniceStandIn(*scene), mesh)
    orig = jdba._segsum
    if exact:
        jdba._segsum = jax_segsum_exact
    jdba._big_marginals_fn.cache_clear()
    try:
        cam_cov, lm_cov = jdba.distributed_big_ba_marginals(shards, mesh, alpha=alpha)
    finally:
        jdba._segsum = orig
        jdba._big_marginals_fn.cache_clear()
    return np.asarray(cam_cov), np.asarray(lm_cov).reshape(-1, 3, 3)[: len(scene[1])]


def _venice_scene(n_cams, n_points, mean_track):
    from slampp_tpu.io.datasets import make_venice_ba_arrays

    return make_venice_ba_arrays(n_cams=n_cams, n_points=n_points, mean_track=mean_track,
                                 seed=0)[:6]


def jax_dist_marginals_reference(n_cams=871, n_points=30_000, mean_track=10, alpha=1e-2):
    """chip_smoke.py's dist-marginals reference: the JAX package's
    distributed marginals (exact segment sums) on the seed-0 venice-class
    scene, summarized by the port's ``apps/distributed.marginals_summary``,
    and how far the JAX package's own prefix-sum result lies from it
    (largest block difference over the largest entry)."""
    from slampp_tpu_torch.apps.distributed import marginals_summary

    scene = _venice_scene(n_cams, n_points, mean_track)
    cam_cov, lm_cov = jax_dist_marginals(scene, alpha)
    cam_p, lm_p = jax_dist_marginals(scene, alpha, exact=False)
    return {"n_cams": n_cams, "n_points": len(scene[1]), "alpha": alpha,
            "prefix_sum_rel_err": {
                "cam": float(np.abs(cam_p - cam_cov).max() / np.abs(cam_cov).max()),
                "lm": float(np.abs(lm_p - lm_cov).max() / np.abs(lm_cov).max())},
            **marginals_summary(cam_cov, lm_cov)}


def port_sc_condition(n_cams=871, n_points=30_000, mean_track=10, alpha=1e-2):
    """The condition number of the damped reduced camera system that
    dist-marginals inverts, from the port on the CPU in a one-rank gloo
    group."""
    import tempfile

    import torch
    import torch.distributed as dist

    from slampp_tpu_torch.apps.distributed import venice_scene
    from slampp_tpu_torch.parallel import distributed_ba as pdb
    from slampp_tpu_torch.parallel.distributed import make_mesh

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            mesh = make_mesh("cpu")
            sh = pdb.build_big_ba_shards_arrays(*venice_scene(n_cams, n_points, mean_track), mesh)
            _, B, BD, _, _, _, Hcc = pdb._local_terms(sh, alpha)
            N = 6 * sh.plan.n_c
            SC = torch.empty((N, N), dtype=torch.float64)
            pdb._sc_part(sh, B, BD, Hcc, SC)
            pdb._damp_cameras(SC, alpha, sh.anchor_cam)
            ev = torch.linalg.eigvalsh(0.5 * (SC + SC.T))
        finally:
            dist.destroy_process_group()
    return float(ev[-1] / ev[0])


def jax_dist_sensitivity(seeds=3, eps=1e-15):
    """How far the JAX package's own distributed results move when the
    start states are scaled entry by entry by 1 + eps N(0, 1): chi2 at each
    of 5 distributed_gn_steps on manhattan3500 (relative), and the
    distributed marginals (exact segment sums) at 871 / 30,000 (largest
    block difference over the largest entry), against the unperturbed
    run."""
    from slampp_tpu.parallel import distributed_gn_step, make_mesh, shard_graph_edges

    def gn(system):
        mesh = make_mesh(1)
        graph = shard_graph_edges(system.snapshot(), mesh)
        chi2 = []
        for _ in range(5):
            states, _, c2 = distributed_gn_step(graph, mesh)
            graph = graph.replace_states(states)
            chi2.append(float(c2))
        return np.asarray(chi2)

    scene = _venice_scene(871, 30_000, 10)
    gn0, (cam0, lm0) = gn(jax_system(3500)), jax_dist_marginals(scene)
    out = {}
    for seed in range(seeds):
        chi2 = gn(_perturb_states(jax_system(3500), eps, seed))
        rng = np.random.default_rng(seed)
        cams, lms = (a * (1.0 + eps * rng.standard_normal(a.shape)) for a in scene[:2])
        cam, lm = jax_dist_marginals((cams, lms) + tuple(scene[2:]))
        out[f"seed {seed}"] = {
            "gn_chi2_rel": (np.abs(chi2 - gn0) / gn0).tolist(),
            "cam_rel": float(np.abs(cam - cam0).max() / np.abs(cam0).max()),
            "lm_rel": float(np.abs(lm - lm0).max() / np.abs(lm0).max())}
    return out


def read_rows(path):
    """A text file of whitespace-separated numbers as a list of float rows
    (rows may differ in length: BA cameras and points)."""
    with open(path) as f:
        return [np.array([float(x) for x in ln.split()]) for ln in f if ln.strip()]


def run_cli(main, argv, workdir):
    """One CLI's ``main(argv)`` run in-process in ``workdir``, where its
    solution.txt, marginals.txt and system.mtx land: (return code, stdout,
    the --json line as a dict)."""
    import contextlib
    import io
    import json

    os.makedirs(workdir, exist_ok=True)
    out = io.StringIO()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out):
        rc = main(list(argv))
    lines = out.getvalue().splitlines()
    return rc, out.getvalue(), json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None


def cli_pair(argv, tmp_path, port_argv=("--device", "cpu")):
    """Both CLIs on the same arguments, each in its own directory under
    ``tmp_path``: {"port": (rc, stdout, json, dir), "jax": (...)}."""
    from slampp_tpu.apps.main import main as jax_main
    from slampp_tpu_torch.apps.main import main as port_main

    out = {}
    for name, main, extra in (("jax", jax_main, ()), ("port", port_main, tuple(port_argv))):
        d = os.path.join(str(tmp_path), name)
        out[name] = (*run_cli(main, list(argv) + list(extra), d), d)
    return out


def assert_cli_match(runs, tol_chi2, tol_solution, tol_marginals=None, solution_scaled=False):
    """The port's CLI run against the JAX CLI's: return codes 0, the same
    problem, solver, iterations and incremental solves, chi2 within
    ``tol_chi2`` relative (of at least 1, as scripts/regression.py holds
    it), solution.txt within ``tol_solution`` absolute per entry (times
    the largest state entry where ``solution_scaled``: mixed routes), and
    marginals.txt (where ``tol_marginals``) within it relative per entry."""
    (rc_p, _, res_p, dir_p), (rc_j, _, res_j, dir_j) = runs["port"], runs["jax"]
    assert rc_p == 0 and rc_j == 0
    for k in ("problem", "solver", "iterations", "incremental_solves"):
        assert res_p[k] == res_j[k], (k, res_p[k], res_j[k])
    assert abs(res_p["chi2"] - res_j["chi2"]) <= tol_chi2 * max(1.0, abs(res_j["chi2"])), (
        res_p["chi2"], res_j["chi2"])
    files = [("solution.txt", tol_solution, False)]
    if tol_marginals is not None:
        files.append(("marginals.txt", tol_marginals, True))
    for name, tol, relative in files:
        rows_p = read_rows(os.path.join(dir_p, name))
        rows_j = read_rows(os.path.join(dir_j, name))
        assert [len(r) for r in rows_p] == [len(r) for r in rows_j], name
        if solution_scaled and not relative:
            tol = tol * max(float(np.abs(r).max()) for r in rows_j)
        for rp, rj in zip(rows_p, rows_j):
            bound = tol * np.abs(rj) if relative else tol
            assert np.all(np.abs(rp - rj) <= bound), (name, rp, rj)


def jax_state_sensitivity(n_poses=200, n_rings=10, seeds=3, eps=1e-15):
    """How far the JAX package's own GN states on sphere200 (the CLI's
    -nls lambda route, native v1, f64) move when its start states are
    scaled by 1 + eps N(0, 1): {seed: (chi2, iterations, max |x - x_0|)},
    seed None being the run as it is."""
    from slampp_tpu.solvers import GaussNewtonSolver

    def run(seed):
        s = jax_sphere_system(n_poses, n_rings)
        if seed is not None:
            _perturb_states(s, eps, seed)
        gn = GaussNewtonSolver(s)
        it = gn.optimize(5, 0.01)
        return gn.chi2(), it, np.concatenate([s.vertex_state(v) for v in sorted(s.vertex_index)])

    chi2, it, x0 = run(None)
    out = {"none": (chi2, it, 0.0)}
    for seed in range(1, seeds + 1):
        c, i, x = run(seed)
        out[str(seed)] = (c, i, float(np.abs(x - x0).max()))
    return out


def jax_cli_references():
    """The JAX CLI's --json results for chip_smoke.py's CLI phases that have
    no solver-level reference: the incremental BA marker path on
    make_ba_scene_incremental(6, 50, 4, seed=1) with -nsp 1 -mnsi 2."""
    import tempfile

    from slampp_tpu.apps.main import main
    from slampp_tpu.io.datasets import make_ba_scene_incremental

    text, _ = make_ba_scene_incremental(n_cams=6, n_points=50, obs_per_point=4, seed=1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "inc_ba.g2o")
        with open(path, "w") as f:
            f.write(text)
        _, _, res = run_cli(main, ["-i", path, "-nsp", "1", "-mnsi", "2", "--json", "-ns",
                                   "-nb", "--no-detailed-timing"], d)
    return {"cli-inc-ba": res}


def random_block_spd(n, bs, extra_pairs, seed):
    """Random SPD block matrix on a chain plus extra off-diagonal pairs
    (tests/test_sparse_chol.py): (A (n*bs, n*bs), sorted pairs (i, j), i > j)."""
    rng = np.random.default_rng(seed)
    pairs = {(i + 1, i) for i in range(n - 1)}
    for _ in range(extra_pairs):
        i, j = rng.integers(0, n, 2)
        if i != j:
            pairs.add((max(i, j), min(i, j)))
    pairs = sorted(pairs)
    A = np.zeros((n * bs, n * bs))
    for i, j in pairs:
        B = rng.normal(0, 1, (bs, bs))
        A[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = B
        A[j * bs : (j + 1) * bs, i * bs : (i + 1) * bs] = B.T
    A += np.eye(n * bs) * (np.abs(A).sum(axis=1).max() + 1.0)
    return A, [(int(i), int(j)) for i, j in pairs]


def permute_blocks(A, order, bs):
    """A with its block rows and columns renumbered: new block b is old
    block order[b] (a v2 plan's col_order)."""
    idx = (np.asarray(order)[:, None] * bs + np.arange(bs)).reshape(-1)
    return A[np.ix_(idx, idx)]


def pack_v2(Ap, plan, bs):
    """The v2 packed layout of ``Ap`` on ``plan``'s pattern: (D (n, bs, bs),
    O (n_off, bs, bs))."""
    D = np.zeros((plan.n, bs, bs))
    O = np.zeros((plan.n_off, bs, bs))
    for (i, j), s in plan.slot_of.items():
        blk = Ap[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs]
        if i == j:
            D[s] = blk
        else:
            O[s - plan.n] = blk
    return D, O


def np_segments(g):
    return (g.m, g.n_seg, [(np.asarray(b.seg_ids), np.asarray(b.idx)) for b in g.buckets])


def port_graph(jg):
    """JAX GraphArrays -> the port's (unpadded snapshots only)."""
    from slampp_tpu_torch import interop

    assert jg.diag_reg is None
    fields = ("local_idx", "offsets", "meas", "sigma_inv", "valid")
    return interop.graph_arrays(
        {k: np.asarray(v) for k, v in jg.states.items()},
        {k: np.asarray(v) for k, v in jg.vertex_offsets.items()},
        {k: {f: np.asarray(getattr(e, f)) for f in fields} for k, e in jg.edges.items()},
        jg.state_dim, jg.unary_offset, jg.unary_dim, jg.unary_information,
    )


def port_block_plan(jbp):
    """JAX BlockPlan -> the port's (a panel-1 plan has no unused scalar)."""
    from slampp_tpu_torch import interop

    assert jbp.P != jbp.bs or not np.asarray(jbp.panel_diag_reg).any()
    return interop.block_plan({
        "n": jbp.n, "bs": jbp.bs, "P": jbp.P, "nnzb": jbp.nnzb,
        "routing": {k: {"pair_transpose": np.asarray(r.pair_transpose), "pairs": r.pairs}
                    for k, r in jbp.routing.items()},
        "anchor_diag_slot": jbp.anchor_diag_slot, "anchor_off": jbp.anchor_off,
        "anchor_dim": jbp.anchor_dim, "unary_information": jbp.unary_information,
        "dx_offsets": np.asarray(jbp.dx_offsets), "state_dim": jbp.state_dim,
        "panel_diag_slots": np.asarray(jbp.panel_diag_slots),
        "panel_diag_reg": np.asarray(jbp.panel_diag_reg),
        "type_order": jbp.type_order,
        "asm_grp": np_segments(jbp.asm_grp), "asm_inv_map": np.asarray(jbp.asm_inv_map),
        "rhs_grp": np_segments(jbp.rhs_grp), "rhs_inv_map": np.asarray(jbp.rhs_inv_map),
    })


def port_v3_plan(jp):
    """JAX V3Plan -> the port's."""
    from slampp_tpu_torch import interop

    def conv(v):
        if hasattr(v, "buckets"):
            return np_segments(v)
        if isinstance(v, int):
            return v
        return np.asarray(v)

    return interop.v3_plan({k: conv(getattr(jp, k)) for k in jp._fields})


def assert_segments_equal(a, b):
    """A port GroupedSegments equals a JAX one, bucket by bucket."""
    assert (a.m, a.n_seg, len(a.buckets)) == (b.m, b.n_seg, len(b.buckets))
    for x, y in zip(a.buckets, b.buckets):
        np.testing.assert_array_equal(x.seg_ids.numpy(), np.asarray(y.seg_ids))
        np.testing.assert_array_equal(x.idx.numpy(), np.asarray(y.idx))


@contextlib.contextmanager
def jax_jacobians(kind="from_f64", factor=1.0, names=("edge_pose3d",), seed=0):
    """Within the block, the JAX package's edge types ``names`` take other
    Jacobians: with ``kind="from_f64"`` jacfwd in float64, rounded to the
    input's dtype (what the port's analytic float32 Jacobians are to ~1e-7;
    JAX's jacfwd through float32 quaternion round trips rounds further off,
    which moves an unconverged mixed-precision trajectory by more than the
    precision it compares); with ``kind="scaled"`` its own times ``factor``
    (1 +- 6e-8 is one float32 rounding); with ``kind="noisy"`` the float64
    ones times 1 + ``factor`` * N(0, 1), a fixed pattern per entry drawn
    from ``seed``, then rounded."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from slampp_tpu import models  # noqa: F401  (registers the types)
    from slampp_tpu.core.assembly import _edge_residual_and_jacobians
    from slampp_tpu.graph import types

    saved = {n: types.get_edge_type(n) for n in names}

    def jacobian_fn(et):
        vts = tuple(types.get_vertex_type(t) for t in et.vertex_types)

        def fn(states, meas):
            if kind == "scaled":
                r, jacs = _edge_residual_and_jacobians(et, vts, states, meas)
                return r, tuple(j * factor for j in jacs)
            r, jacs = _edge_residual_and_jacobians(
                et, vts, tuple(x.astype(jnp.float64) for x in states), meas.astype(jnp.float64))
            if kind == "noisy":
                jacs = tuple(j * (1 + factor * jax.random.normal(
                    jax.random.PRNGKey(seed * 10 + i), j.shape, jnp.float64))
                    for i, j in enumerate(jacs))
            dt = states[0].dtype
            return r.astype(dt), tuple(j.astype(dt) for j in jacs)

        return fn

    try:
        for n, et in saved.items():
            types.TYPE_REGISTRY["edge"][n] = dataclasses.replace(et, jacobian_fn=jacobian_fn(et))
        yield
    finally:
        types.TYPE_REGISTRY["edge"].update(saved)


def jax_batch_solver(system, nls, engine=None):
    """The JAX package's batch solver as its CLI builds it for an SE(2) pose
    graph (``slampp_tpu/apps/main.py:195-228``), ``engine`` overriding the
    LM / dogleg engine."""
    from slampp_tpu.solvers.dogleg import DoglegSolver
    from slampp_tpu.solvers.gauss_newton import GaussNewtonSolver
    from slampp_tpu.solvers.lm import LevenbergMarquardtSolver

    if nls == "lambda-lm":
        return LevenbergMarquardtSolver(system, use_schur=False, engine=engine or "dense")
    if nls == "lambda-dl":
        return DoglegSolver(system, **({"engine": engine} if engine else {}))
    return GaussNewtonSolver(system, use_schur=False)


def jax_solver_reference(n_poses, nls, engine=None, max_iters=5, min_dx=0.01, system=None,
                         robust=None):
    """(chi2 after ``optimize``, iterations applied) of the JAX package on
    ``system`` (default: the seed-0 Manhattan graph); ``robust`` = (loss,
    on_chi2) first rebinds its edge types, as the CLI's ``--robust``."""
    if system is None:
        system = jax_system(n_poses)
    if robust is not None:
        from slampp_tpu.models.robust import apply_robust_to_system

        apply_robust_to_system(system, loss=robust[0], on_chi2=robust[1])
    solver = jax_batch_solver(system, nls, engine)
    applied = solver.optimize(max_iters, min_dx)
    return float(solver.chi2()), int(applied)


def jax_incremental(n_poses, engine, seed=0, loop_prob=0.1, live_engine=None,
                    graph="manhattan", **kw):
    """The JAX package's incremental solver ("fastl", "windowed" or
    "every-n") streamed over the seed-``seed`` Manhattan graph (or with
    ``graph="sphere"`` the sphere of one ring per 50 poses) as the
    port's ``apps/incremental.run_incremental`` drives its own: every-vertex
    cadence unless ``kw`` says otherwise, one ``incremental_step`` per edge
    from the parser's ``on_edge`` hook, then ``refresh_frozen``.
    ``live_engine`` sets the windowed solver's SLAMPP_INC_LIVE_ENGINE for
    its construction.  Returns the solver."""
    from slampp_tpu.graph.system import GraphSystem
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file
    from slampp_tpu.solvers import IncrementalSolver
    from slampp_tpu.solvers.fastl import FastLSolver
    from slampp_tpu.solvers.incremental_windowed import WindowedIncrementalSolver

    cls = {"fastl": FastLSolver, "windowed": WindowedIncrementalSolver,
           "every-n": IncrementalSolver}[engine]
    if graph == "sphere":
        text, problem = jax_sphere_text(n_poses, seed=seed), "se3"
    else:
        text, problem = make_manhattan(n_poses=n_poses, loop_prob=loop_prob, seed=seed)[0], "se2"
    system = GraphSystem()
    saved = os.environ.get("SLAMPP_INC_LIVE_ENGINE")
    if live_engine is not None:
        os.environ["SLAMPP_INC_LIVE_ENGINE"] = live_engine
    try:
        inc = cls(system, **{"solve_period": 1, "require_loop_closure": False, **kw})
    finally:
        if live_engine is not None:
            if saved is None:
                del os.environ["SLAMPP_INC_LIVE_ENGINE"]
            else:
                os.environ["SLAMPP_INC_LIVE_ENGINE"] = saved
    _with_text_file(text, lambda p: build_system(
        parse_file(p), problem=problem, system=system,
        on_edge=lambda s, n: inc.incremental_step()))
    if hasattr(inc, "refresh_frozen"):
        inc.refresh_frozen()
    return inc


def jax_incremental_reference(n_poses, engine, **kw):
    """chip_smoke.py's reference of one incremental phase: the streamed
    chi2, the counters, ``optimize()``'s return and the chi2 after it."""
    inc = jax_incremental(n_poses, engine, **kw)
    out = {"chi2_stream": float(inc.chi2())}
    out.update({k: getattr(inc, k) for k in ("n_solves", "n_freezes", "n_refreezes", "n_relin")
                if hasattr(inc, k)})
    out["optimize_return"] = int(inc.optimize())
    out["chi2_final"] = float(inc.chi2())
    return out


# chip_smoke.py's native phase: (name, engine, panel) of NativeBlockSolver
NATIVE_RUNS = (("v1-p8", "v1", 8), ("v2-p1", "v2", 1), ("v2-p8", "v2", 8))


def jax_native_fused(system, engine, panel, n_iters=5):
    """``n_iters`` chained float64 GN iterations of the JAX package's
    NativeBlockSolver, with no early exit: ``optimize_fused`` for v2, and
    ``gn_step`` chained for v1 (which has no fused form), as the port's
    ``apps/manhattan.run_native`` drives its own.  Returns (states, chi2
    before, chi2 after)."""
    from slampp_tpu.core.assembly import graph_chi2
    from slampp_tpu.linear.native import NativeBlockSolver

    ns = NativeBlockSolver(system, panel=panel, engine=engine)
    graph = system.snapshot()
    if engine == "v2":
        states, _, chi0, chi2 = ns.optimize_fused(graph, n_iters)
        return states, float(chi0), float(chi2)
    states, chi0 = graph.states, None
    for _ in range(n_iters):
        states, _, c = ns.gn_step(graph.replace_states(states))
        chi0 = c if chi0 is None else chi0
    return states, float(chi0), float(graph_chi2(graph.replace_states(states)))


def jax_v3_fused(system, mixed=True, n_iters=5, target=64, refine=0):
    """The JAX package's ``PartitionedSolver.optimize_fused`` as the port's
    ``apps/manhattan.run`` drives its own: (states, chi2 before, chi2 after,
    plan)."""
    from slampp_tpu.linear.partitioned import PartitionedSolver

    ps = PartitionedSolver(system, target=target, mixed_precision=mixed, refine_iters=refine)
    ps.symbolic()
    states, _, chi0, chi2 = ps.optimize_fused(system.snapshot(), n_iters=n_iters)
    p = ps.plan
    return states, float(chi0), float(chi2), {"K": p.K, "M": p.M, "S": p.S, "SB": p.SB,
                                              "Ms": p.Ms, "ch_ok": int(p.ch_ok)}


def jax_sphere_references():
    """chip_smoke.py's sphere phases on the JAX package, one JSON-able dict
    per phase (the port's apps/sphere and apps/incremental graphs)."""
    out = {}
    for phase, n, mixed in (("sphere", 2500, True), ("sphere-exact", 1000, False)):
        _, chi0, chi2, plan = jax_v3_fused(jax_sphere_system(n), mixed)
        out[phase] = {"n_poses": n, "chi2_init": chi0, "chi2_final": chi2, "plan": plan}
    for phase, nls, engine, robust, iters in (("sphere-lm-v3", "lambda-lm", "v3", None, 5),
                                              ("sphere-dl-v3", "lambda-dl", "v3", None, 20),
                                              ("sphere-gn", "lambda", None, None, 5),
                                              ("robust", "lambda-lm", "v3", ("cauchy", True), 5)):
        chi2, applied = jax_solver_reference(2500, nls, engine, iters,
                                             system=jax_sphere_system(2500), robust=robust)
        out[phase] = {"n_poses": 2500, "chi2_final": chi2, "applied": applied}
    # dogleg after the CLI's 5 iterations, with the float32 Jacobians rounded
    # from float64 (what the port's analytic ones are; see jax_jacobians)
    with jax_jacobians():
        chi2, applied = jax_solver_reference(2500, "lambda-dl", "v3", 5,
                                             system=jax_sphere_system(2500))
    out["sphere-dl-v3-5"] = {"n_poses": 2500, "chi2_final": chi2, "applied": applied}
    _, _, out["sphere-gn"]["v2-p1"] = jax_native_fused(jax_sphere_system(2500), "v2", 1)
    chi2, applied = jax_solver_reference(
        300, "lambda-lm", system=jax_sphere_system(300, 10, landmarks=True))
    out["sphere-landmarks"] = {"n_poses": 300, "chi2_final": chi2, "applied": applied}
    out["fastl-se3"] = {"n_poses": 500, **jax_incremental_reference(500, "fastl", graph="sphere")}
    return out


def fastl_se3_sensitivity(n_poses=500, jax_seeds=13, port_seeds=3):
    """FastL on the sphere (one ring per 50 poses) at every vertex, run
    many ways: the JAX package as it is; with its SE(3) Jacobians scaled by
    1 +- 1e-14 and its retraction by 1 + 1e-15; with its Jacobians times
    1 + 1e-15 N(0, 1) per entry (``noisy_lin``), seeds 1 to ``jax_seeds``;
    the port on the CPU as it is and with the same noise, seeds 1 to
    ``port_seeds``; and the port with one, and with all three, of the JAX
    package's kernel adapters in place of its own.  Returns each run's
    streamed chi2, counters, optimize() return and final chi2: how far the
    reference's own trajectory moves with its kernels' rounding, and which
    of the port's adapters its own run depends on."""
    import numpy as np

    from slampp_tpu.models import jax_kernel_adapter as ja

    from slampp_tpu_torch.apps.incremental import run_incremental
    from slampp_tpu_torch.models import torch_kernel_adapter as ta

    keys = ("n_solves", "n_freezes", "n_refreezes", "n_relin")
    makers = ("make_edge_lin", "make_retract", "make_local_diff")

    def jax_run():
        return jax_incremental_reference(n_poses, "fastl", graph="sphere")

    def port_run():
        r = run_incremental(n_poses, "cpu", "fastl", graph="sphere")
        return {"chi2_stream": r["chi2_stream"], **{k: r["counters"][k] for k in keys},
                "optimize_return": r["optimize_return"], "chi2_final": r["chi2_final"]}

    def scaled_lin(orig, f):
        def make(name):
            fn = orig(name)

            def call(slot_states, meas):
                r, jacs = fn(slot_states, meas)
                return r, tuple(j * f for j in jacs)

            call.arity = fn.arity
            return call
        return make

    def noisy_lin(orig, seed, eps=1e-15):
        rng = np.random.default_rng(seed)

        def make(name):
            fn = orig(name)

            def call(slot_states, meas):
                r, jacs = fn(slot_states, meas)
                return r, tuple(np.asarray(j) * (1 + eps * rng.standard_normal(np.shape(j)))
                                for j in jacs)

            call.arity = fn.arity
            return call
        return make

    def scaled_retract(orig, f):
        return lambda name: (lambda s, d, fn=orig(name): fn(s, d) * f)

    def with_makers(module, replace, run):
        saved = {m: getattr(module, m) for m in makers}
        try:
            for m, fn in replace.items():
                setattr(module, m, fn)
            return run()
        finally:
            for m, fn in saved.items():
                setattr(module, m, fn)

    lin, ret = ja.make_edge_lin, ja.make_retract
    out = {"jax": jax_run()}
    for label, replace in (
            ("jax, J x (1 + 1e-14)", {"make_edge_lin": scaled_lin(lin, 1 + 1e-14)}),
            ("jax, J x (1 - 1e-14)", {"make_edge_lin": scaled_lin(lin, 1 - 1e-14)}),
            ("jax, retract x (1 + 1e-15)", {"make_retract": scaled_retract(ret, 1 + 1e-15)}),
            *((f"jax, J x (1 + 1e-15 N), seed {k}", {"make_edge_lin": noisy_lin(lin, k)})
              for k in range(1, jax_seeds + 1))):
        out[label] = with_makers(ja, replace, jax_run)
    out["port"] = port_run()
    for k in range(1, port_seeds + 1):
        out[f"port, J x (1 + 1e-15 N), seed {k}"] = with_makers(
            ta, {"make_edge_lin": noisy_lin(ta.make_edge_lin, k)}, port_run)
    for m in makers:
        out[f"port, JAX's {m}"] = with_makers(ta, {m: getattr(ja, m)}, port_run)
    out["port, JAX kernel adapters"] = with_makers(
        ta, {m: getattr(ja, m) for m in makers}, port_run)
    return out


# FastL's counters, each a gate's decisions summed over the run
_FASTL_GATES = ("n_solves", "n_freezes", "n_refreezes", "n_relin", "n_full_factor",
                "n_resumed_factor")


def _fastl_trace_record(inc):
    """A copy of a FastL solver's resident state after one step, read
    without writing anything back: its counters and {vid: (current,
    linearization point)} of the live slots."""
    rec = {k: int(getattr(inc, k)) for k in _FASTL_GATES}
    rec["N"] = int(inc._N)
    rec["jitter"] = float(np.max(inc._jitter))
    states = {}
    for s, vid in enumerate(inc._slot_vid):
        t, r = inc._slot_vtrow[s]
        states[vid] = (inc._vt_cur[t][r].copy(), inc._vt_lin[t][r].copy())
    rec["states"] = states
    return rec


def fastl_trace(n_poses=500, graph="sphere"):
    """FastL streamed over the sphere (one ring per 50 poses) at every
    vertex on the CPU, with each solver's resident NumPy state copied after
    every step (no chi2() call and no write-back while streaming, so the
    runs are the ones ``--fastl-se3`` makes): the JAX package ("jax"), the
    port ("port"), and the JAX package on the port's kernel adapters
    (``models/torch_kernel_adapter.py``: "jax, port adapters").  Returns
    the traces (one record per step) and each run's streamed chi2,
    ``optimize()`` return and final chi2."""
    from slampp_tpu.models import jax_kernel_adapter as ja
    from slampp_tpu.solvers import fastl as jfastl

    from slampp_tpu_torch.apps.incremental import run_incremental
    from slampp_tpu_torch.models import torch_kernel_adapter as ta
    from slampp_tpu_torch.solvers import fastl as pfastl

    traces = {}
    makers = ("make_edge_lin", "make_retract", "make_local_diff")

    def traced(module, key, run, adapters=None):
        orig = module.FastLSolver.incremental_step
        saved = {m: getattr(ja, m) for m in makers}
        out = traces.setdefault(key, [])

        def step(self, *a, **kw):
            res = orig(self, *a, **kw)
            out.append(_fastl_trace_record(self))
            return res

        module.FastLSolver.incremental_step = step
        try:
            for m, fn in (adapters or {}).items():
                setattr(ja, m, fn)
            return run()
        finally:
            module.FastLSolver.incremental_step = orig
            for m, fn in saved.items():
                setattr(ja, m, fn)

    def jax_run():
        # the streamed and final chi2 once the stream (and its trace) is over
        inc = jax_incremental(n_poses, "fastl", graph=graph)
        chi2_stream = float(inc.chi2())
        return {"chi2_stream": chi2_stream, "optimize_return": int(inc.optimize()),
                "chi2_final": float(inc.chi2())}

    outcomes = {"jax": traced(jfastl, "jax", jax_run)}
    r = traced(pfastl, "port", lambda: run_incremental(n_poses, "cpu", "fastl", graph=graph))
    outcomes["port"] = {k: r[k] for k in ("chi2_stream", "optimize_return", "chi2_final")}
    outcomes["jax, port adapters"] = traced(jfastl, "jax, port adapters", jax_run,
                                            {m: getattr(ta, m) for m in makers})
    return traces, outcomes


def fastl_trace_first_difference(traces, tol=1e-10, a="jax", b="port"):
    """Where the two traces part: for each step the largest state
    difference over the vertices both hold live (current states and
    linearization points apart), the first step beyond ``tol`` and the
    first steps beyond 1e-8, 1e-6, 1e-4 and 1e-2, each with both records'
    counters (every gate's decisions summed), jitter and live size, and the
    first step at which any counter, the live set or the jitter differs."""
    jt, pt = traces[a], traces[b]
    keys = _FASTL_GATES + ("N", "jitter")
    cur, lin, first_gate = [], [], None
    for i, (ra, rb) in enumerate(zip(jt, pt)):
        common = set(ra["states"]) & set(rb["states"])
        dc = max((float(np.abs(ra["states"][v][0] - rb["states"][v][0]).max())
                  for v in common), default=0.0)
        dl = max((float(np.abs(ra["states"][v][1] - rb["states"][v][1]).max())
                  for v in common), default=0.0)
        cur.append(dc)
        lin.append(dl)
        if first_gate is None and (set(ra["states"]) != set(rb["states"])
                                   or any(ra[k] != rb[k] for k in keys)):
            first_gate = {"step": i, **{k: (ra[k], rb[k]) for k in keys},
                          "same_live": set(ra["states"]) == set(rb["states"]),
                          "before": {k: (jt[i - 1][k], pt[i - 1][k]) for k in keys} if i else None}

    def first_beyond(x):
        i = next((i for i, d in enumerate(cur) if max(d, lin[i]) > x), None)
        if i is None:
            return None
        return {"step": i, "cur_diff": cur[i], "lin_diff": lin[i],
                **{k: (jt[i][k], pt[i][k]) for k in keys}}

    return {"runs": (a, b), "steps": (len(jt), len(pt)), "tol": tol,
            "first_beyond_tol": first_beyond(tol),
            "first_beyond": {x: first_beyond(x) for x in (1e-8, 1e-6, 1e-4, 1e-2)},
            "first_gate_difference": first_gate, "cur_diff_by_step": cur,
            "lin_diff_by_step": lin}


def mixed_solver_sensitivity(n_poses=2500, seeds=6):
    """LM and dogleg on the mixed v3 engine on the sphere (one ring per 50
    poses), the JAX package's run as it is, with its float32 Jacobians
    rounded from float64, and scaled by 1 +- 6e-8; dogleg also with the
    float64 Jacobians times 1 + 6e-8 N(0, 1) per entry, seeds 1 to
    ``seeds``, then rounded: (chi2, applied) of each, how far the
    reference's own 5-iteration result moves with float32 rounding."""
    runs = (("as is", contextlib.nullcontext), ("J from f64", jax_jacobians),
            ("J x (1 + 6e-8)", lambda: jax_jacobians("scaled", 1 + 6e-8)),
            ("J x (1 - 6e-8)", lambda: jax_jacobians("scaled", 1 - 6e-8)))
    noisy = tuple((f"J from f64 x (1 + 6e-8 N), seed {k}",
                   lambda k=k: jax_jacobians("noisy", 6e-8, seed=k)) for k in range(1, seeds + 1))
    out = {}
    for nls in ("lambda-lm", "lambda-dl"):
        for label, ctx in runs + (noisy if nls == "lambda-dl" else ()):
            with ctx():
                out[f"{nls} v3, {label}"] = jax_solver_reference(
                    n_poses, nls, "v3", system=jax_sphere_system(n_poses))
    return out


def jax_marginals_reference(n_poses):
    """chip_smoke.py's marginals reference: the seed-0 Manhattan graph after
    5 fused GN iterations (v2, panel 8), then the dense ``update_batch``:
    vertex 0's covariance block and the sum of the block traces."""
    from slampp_tpu.marginals import MarginalCovariance

    system = jax_system(n_poses)
    states, _, _ = jax_native_fused(system, "v2", 8)
    system.update_states(states)
    m = MarginalCovariance(system)
    m.update_batch()
    return {"block0": np.asarray(m.block_diag[0]).tolist(),
            "trace_sum": float(sum(np.trace(b) for b in m.block_diag.values()))}


def jax_eigen_reference(n_poses, iters=80):
    """chip_smoke.py's eigen reference: the largest and the smallest
    (shift-invert through the v3 factorization) eigenvalue of the seed-0
    Manhattan graph's lambda at its initial states, ``iters`` Lanczos
    iterations each, and their ratio."""
    from slampp_tpu.eval.eigenvalues import (sparse_largest_eigenvalues,
                                             sparse_smallest_eigenvalues_shift_invert)

    system = jax_system(n_poses)
    lmax = float(sparse_largest_eigenvalues(system, 1, iters)[0][0])
    lmin = float(sparse_smallest_eigenvalues_shift_invert(system, 1, 0.0, iters)[0][0])
    return {"lmax": lmax, "lmin": lmin, "cond": abs(lmax) / max(abs(lmin), 1e-300)}


if __name__ == "__main__":
    # The JAX package's reference values for chip_smoke.py's solver phases,
    # on the CPU, with the port's chain-mode configuration (separator through
    # the dense kernels):
    #   python tests/_torch_jax_util.py [n_poses]
    # and for its incremental phases (fastl and windowed-v3 at 800 poses,
    # every-n at 500; windowed-v3 takes minutes of JAX compiles):
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --incremental
    # and for its native, marginals and eigen phases (a few GB for the dense
    # marginals' 10500 x 10500 H at 3500 poses):
    #   python tests/_torch_jax_util.py --native [n_poses]
    # and for its sphere phases (sphere2500 v3 and batch solvers, sphere1000
    # v3 in f64, the sphere landmarks, FastL at sphere500):
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --sphere
    # and how far FastL's sphere500 trajectory moves with kernel rounding
    # (the JAX package perturbed, 13 noise seeds; the port as it is and
    # under 3 noise seeds; the port on each of the JAX kernel adapters and
    # on all three; 25 runs, about half an hour on one core):
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --fastl-se3
    # and for its BA phases (venice871 class with a float32 and a float64
    # SC, the dense Schur LM, cityTrees10k dogleg through the sparse Schur
    # engine, the Schur marginals):
    #   python tests/_torch_jax_util.py --ba
    # and for its Sim(3), ROCV, Spheron and SPCG phases (the venice871-class
    # Sim(3) scene at full size, where the JAX package's sparse Schur engine
    # raises at its separator gate, and at 871 cameras / 30,000 points):
    #   python tests/_torch_jax_util.py --sim3
    # and how the JAX package's own SPCG CG counts at manhattan500 and its
    # dense GN chi2 on make_rocv(1000, 8) move with its start states scaled
    # by 1 + 1e-15 N(0, 1) (3 seeds; a few minutes):
    #   python tests/_torch_jax_util.py --sensitivity
    # and the first step at which FastL's sphere500 runs in the two packages
    # part (their resident states copied after every step):
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --fastl-trace
    # and for its CLI phase on the incremental BA marker path (the JAX
    # CLI's --json line; a few seconds):
    #   python tests/_torch_jax_util.py --cli
    # and how far the JAX package's own GN states on sphere200 move with its
    # start states scaled by 1 + 1e-15 N(0, 1) (3 seeds; seconds):
    #   python tests/_torch_jax_util.py --cli-sensitivity
    # and for its distributed phases (JAX's distributed_gn_step iterated 5
    # times on manhattan3500, its distributed marginals of the venice-class
    # scene at 871 / 30,000, both on a 1-device CPU mesh):
    #   python tests/_torch_jax_util.py --dist
    # and how far those JAX results move with the start states scaled by
    # 1 + 1e-15 N(0, 1) (3 seeds; half an hour), after the condition number
    # of the marginals' damped SC (the port's, on the CPU):
    #   python tests/_torch_jax_util.py --dist-sensitivity
    # and how far the mixed v3 LM / dogleg results at sphere2500 move with
    # float32 rounding of the JAX package's Jacobians (14 runs, about half
    # an hour):
    #   python tests/_torch_jax_util.py --mixed-sensitivity
    import json
    import sys

    os.environ["SLAMPP_CHAIN_SEP_XLA"] = "0"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import slampp_tpu  # noqa: F401  (x64 at import)

    if "--dist-sensitivity" in sys.argv:
        print(json.dumps({"dist-marginals SC condition": port_sc_condition()}), flush=True)
        for run, res in jax_dist_sensitivity().items():
            print(json.dumps({"run": run, **res}), flush=True)
        sys.exit(0)
    if "--dist" in sys.argv:
        print(json.dumps({"phase": "dist-gn", **jax_dist_gn_reference()}), flush=True)
        print(json.dumps({"phase": "dist-marginals", **jax_dist_marginals_reference()}),
              flush=True)
        sys.exit(0)
    if "--cli-sensitivity" in sys.argv:
        for run, (chi2, it, dx) in jax_state_sensitivity().items():
            print(json.dumps({"run": run, "chi2": chi2, "iterations": it, "max_state_diff": dx}),
                  flush=True)
        sys.exit(0)
    if "--cli" in sys.argv:
        for phase, ref in jax_cli_references().items():
            print(json.dumps({"phase": phase, **ref}), flush=True)
        sys.exit(0)
    if "--mixed-sensitivity" in sys.argv:
        for run, (chi2, applied) in mixed_solver_sensitivity().items():
            print(json.dumps({"run": run, "chi2": chi2, "applied": applied}), flush=True)
        sys.exit(0)
    if "--sim3" in sys.argv:
        for phase, ref in jax_sim3_references().items():
            print(json.dumps({"phase": phase, **ref}), flush=True)
        sys.exit(0)
    if "--sensitivity" in sys.argv:
        for run, ref in jax_sensitivity().items():
            print(json.dumps({"run": run, **ref}), flush=True)
        sys.exit(0)
    if "--ba" in sys.argv:
        for phase, ref in jax_ba_references().items():
            print(json.dumps({"phase": phase, **ref}), flush=True)
        sys.exit(0)
    if "--fastl-trace" in sys.argv:
        traces, outcomes = fastl_trace()
        print(json.dumps(outcomes), flush=True)
        for pair in (("jax", "port"), ("jax, port adapters", "port"),
                     ("jax", "jax, port adapters")):
            print(json.dumps(fastl_trace_first_difference(traces, a=pair[0], b=pair[1])),
                  flush=True)
        sys.exit(0)
    if "--fastl-se3" in sys.argv:
        for run, res in fastl_se3_sensitivity().items():
            print(json.dumps({"run": run, **res}), flush=True)
        sys.exit(0)
    if "--sphere" in sys.argv:
        for phase, ref in jax_sphere_references().items():
            print(json.dumps({"phase": phase, **ref}), flush=True)
        sys.exit(0)
    if "--incremental" in sys.argv:
        for phase, n, engine, kw in (
                ("fastl", 800, "fastl", {}),
                ("every-n", 500, "every-n", {"solve_period": 10, "max_iterations": 3}),
                ("windowed-v3", 800, "windowed", {"live_engine": "v3"})):
            print(json.dumps({"phase": phase, "n_poses": n,
                              **jax_incremental_reference(n, engine, **kw)}), flush=True)
        sys.exit(0)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 3500
    if "--native" in sys.argv:
        for name, engine, panel in NATIVE_RUNS:
            _, chi0, chi2 = jax_native_fused(jax_system(n), engine, panel)
            print(json.dumps({"phase": "native", "run": name, "n_poses": n, "chi2_init": chi0,
                              "chi2_final": chi2}), flush=True)
        print(json.dumps({"phase": "marginals", "n_poses": n, **jax_marginals_reference(n)}),
              flush=True)
        print(json.dumps({"phase": "eigen", "n_poses": n, **jax_eigen_reference(n)}), flush=True)
        sys.exit(0)
    for phase, nls, engine in (("gn", "lambda", None), ("lm", "lambda-lm", None),
                               ("lm-v3", "lambda-lm", "v3"), ("dl", "lambda-dl", None),
                               ("dl-v3", "lambda-dl", "v3")):
        chi2, applied = jax_solver_reference(n, nls, engine)
        print(json.dumps({"phase": phase, "n_poses": n, "chi2": chi2, "applied": applied}),
              flush=True)
