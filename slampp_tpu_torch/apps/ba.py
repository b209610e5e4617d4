"""Bundle adjustment through the port's Schur engines.

``run_venice`` is the port's counterpart of the bench's venice child
(``bench.py`` ``bench_venice``): a venice871-class scene as arrays
(``io/datasets.make_venice_ba_arrays``), ``BigBASolver.from_arrays``, one
first step, then the LM loop of 5 iterations with ``min_dx_norm=0``.
``run_city_schur`` optimizes a city-trees graph (SE(2) poses and
landmarks) with dogleg or LM whose ``auto`` / ``use_schur`` route takes the
sparse Schur engine from 1500 vertices on (``linear/schur_sparse.py``,
whose pose solve is the v3 engine and its three kernels).  ``run_ba_scene``
runs LM with the dense Schur engine on ``make_ba_scene``'s g2o text, and
``run_ba_marginals`` the Schur marginals there.

    python -m slampp_tpu_torch.apps.ba venice [device] [--cams N] [--points N] [--track N] [--f64] [--profile]
    python -m slampp_tpu_torch.apps.ba city [device] [--poses N] [--landmarks N] [--solver lambda-dl|lambda-lm]
    python -m slampp_tpu_torch.apps.ba scene [device] [--cams N] [--points N]
    python -m slampp_tpu_torch.apps.ba marginals [device] [--cams N] [--points N]

print the result as one JSON object.  The device defaults to ``cuda``;
name ``cpu`` to run on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from slampp_tpu_torch.apps.manhattan import _option, _sync
from slampp_tpu_torch.core.assembly import assemble_dense
from slampp_tpu_torch.io.datasets import make_ba_scene, make_city_trees, make_venice_ba_arrays
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.linear.ba_schur import BigBASolver, ba_chi2_only
from slampp_tpu_torch.linear.schur import build_schur_plan
from slampp_tpu_torch.marginals.ba_marginals import schur_marginals
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.solvers import DoglegSolver, LevenbergMarquardtSolver
from slampp_tpu_torch.utils.device import require_device


def _system(text: str):
    with g2o_file(text) as path:
        return build_system(parse_file(path))


def venice_solver(n_cams: int, n_points: int, mean_track: int, device, sc_f64: bool = False,
                  pair_f32: bool = True):
    """(solver, generation s, symbolic s) of the seed-0 venice-class scene."""
    device = torch.device(device)
    require_device(device, "venice_solver")
    t0 = time.perf_counter()
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, sc_f64=sc_f64,
                                     pair_f32=pair_f32, device=device)
    _sync(device)
    return solver, t_gen, time.perf_counter() - t0


def run_venice(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10, device="cuda",
               sc_f64: bool = False, pair_f32: bool = True, n_iters: int = 5) -> dict:
    """``bench_venice``'s loop on the port: generation, the host symbolic
    phase (with the device pair table), one first step, then ``optimize``
    with ``n_iters`` LM iterations and ``min_dx_norm=0``.  Returns
    iterations/s of that loop, the accepted steps (``lm_accepted``), chi2
    before and after, the set-up split (generation, symbolic, first step),
    the scene's sizes and the card's peak memory.  ``sc_f64`` factors the
    SC in float64, ``pair_f32`` forms the pair products in float32."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    solver, t_gen, t_sym = venice_solver(n_cams, n_points, mean_track, device, sc_f64, pair_f32)
    p = solver.plan
    chi2_0 = float(ba_chi2_only(p, solver._cams, solver._lms))
    t0 = time.perf_counter()
    float(solver.step(solver._cams, solver._lms, 1e-3)[2])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied = solver.optimize(max_iterations=n_iters, min_dx_norm=0.0)
    _sync(device)
    dt = time.perf_counter() - t0
    out = {
        "n_cams": p.n_c, "n_points": p.n_l, "n_obs": p.n_obs, "mean_track": mean_track,
        "n_pairs": int(p.pair_e.shape[0]) - 1, "n_sc_blocks": p.n_distinct, "sc_dim": 6 * p.n_c,
        "sc_f64": sc_f64, "pair_f32": pair_f32, "device": str(device), "n_iters": n_iters,
        "iters_per_sec": n_iters / dt, "t_optimize_s": dt, "lm_accepted": applied,
        "chi2_init": chi2_0, "chi2_final": solver.chi2(),
        "t_generate_s": t_gen, "t_symbolic_s": t_sym, "t_first_step_s": t_first,
    }
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def profile_venice(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10,
                   device="cuda", sc_f64: bool = False, pair_f32: bool = True,
                   top: int = 12) -> dict:
    """Where one warm LM step of the venice scene goes: the ``ba.*`` ranges'
    device spans, busy and idle (``apps/manhattan._profiled``)."""
    from slampp_tpu_torch.apps.manhattan import _profiled

    device = torch.device(device)
    solver, t_gen, t_sym = venice_solver(n_cams, n_points, mean_track, device, sc_f64, pair_f32)
    step = lambda: float(solver.step(solver._cams, solver._lms, 1e-3)[2])  # noqa: E731
    step()
    return {"n_obs": solver.plan.n_obs, "sc_f64": sc_f64, "t_symbolic_s": t_sym,
            **_profiled(step, device, top, prefixes=("ba.",))}


def city_system(n_poses: int, n_landmarks: int):
    """The seed-0 city-trees graph through its g2o text and the parser."""
    return _system(make_city_trees(n_poses=n_poses, n_landmarks=n_landmarks, seed=0)[0])


def run_city_schur(n_poses: int = 10000, n_landmarks: int = 100, device="cuda",
                   solver: str = "lambda-dl", max_iters: int = 5, min_dx: float = 0.01) -> dict:
    """Dogleg ("lambda-dl", engine "auto") or LM ("lambda-lm",
    ``use_schur=True``) on the city-trees graph, as the JAX CLI builds them:
    from 1500 vertices both take the sparse Schur engine.  Returns chi2
    before and after, the iterations applied, the engine taken, the v3
    plan of the reduced pose system, the kernel launches and their shapes,
    the wall time and the final states."""
    device = torch.device(device)
    t0 = time.perf_counter()
    system = city_system(n_poses, n_landmarks)
    t_build = time.perf_counter() - t0
    if solver == "lambda-dl":
        s = DoglegSolver(system, device=device)
    elif solver == "lambda-lm":
        s = LevenbergMarquardtSolver(system, use_schur=True, device=device)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    engine = s._resolve_engine()
    chi2_init = s.chi2()
    dk.reset_launches()
    t0 = time.perf_counter()
    applied = s.optimize(max_iters, min_dx)
    _sync(device)
    t_opt = time.perf_counter() - t0
    launches = dict(dk.launches)
    shapes = sorted(dk.launch_shapes, key=lambda x: (x[0], x[1], x[2], x[3] or 0))
    t_sym = sum(v for k, v in s.timer.acc.items() if k.endswith("symbolic"))
    out = {"n_poses": n_poses, "n_landmarks": n_landmarks, "n_vertices": system.n_vertices,
           "device": str(device), "solver": solver, "engine": engine,
           "chi2_init": chi2_init, "chi2_final": s.chi2(), "applied": applied,
           "iterations": s.n_iterations, "t_build_s": t_build, "t_optimize_s": t_opt,
           "t_symbolic_s": t_sym, "s_per_iter": (t_opt - t_sym) / max(s.n_iterations, 1),
           "launches": launches, "kernel_shapes": shapes,
           "states": system.snapshot(device).states}
    ss = getattr(s, "_ss", None)
    if ss is not None:
        p = ss.v3_plan
        out["plan"] = {"K": p.K, "M": p.M, "S": p.S, "SB": p.SB, "Ms": p.Ms, "ch_ok": p.ch_ok}
    return out


def scene_system(n_cams: int, n_points: int):
    """``make_ba_scene``'s seed-0 scene through its g2o text and the parser."""
    return _system(make_ba_scene(n_cams=n_cams, n_points=n_points)[0])


def run_ba_scene(n_cams: int = 20, n_points: int = 500, device="cuda", max_iters: int = 5,
                 min_dx: float = 0.01) -> dict:
    """LM with the dense Schur engine (``use_schur=True``, landmarks
    eliminated from the dense Hessian) on ``make_ba_scene``: chi2 before
    and after, the iterations applied, the wall time, the final states."""
    device = torch.device(device)
    system = scene_system(n_cams, n_points)
    s = LevenbergMarquardtSolver(system, use_schur=True, device=device)
    chi2_init = s.chi2()
    t0 = time.perf_counter()
    applied = s.optimize(max_iters, min_dx)
    _sync(device)
    return {"n_cams": n_cams, "n_points": n_points, "device": str(device),
            "chi2_init": chi2_init, "chi2_final": s.chi2(), "applied": applied,
            "t_optimize_s": time.perf_counter() - t0,
            "states": system.snapshot(device).states}


def run_ba_marginals(n_cams: int = 20, n_points: int = 500, device="cuda",
                     alpha: float = 1e-2) -> dict:
    """The Schur marginals of ``make_ba_scene``'s Hessian at its initial
    states, lifted by ``alpha`` I (BA's gauge leaves H singular; the JAX
    package's test lifts it the same way): the traces of the camera
    covariance and of the landmark blocks, camera 0's pose block and
    landmark 0's block."""
    device = torch.device(device)
    require_device(device, "run_ba_marginals")
    system = scene_system(n_cams, n_points)
    t0 = time.perf_counter()
    H, _, _ = assemble_dense(system.snapshot(device))
    plan = build_schur_plan(system).to(device)
    sigma_cc, sigma_ll = schur_marginals(H, plan, alpha=alpha)
    _sync(device)
    return {"n_cams": n_cams, "n_points": n_points, "device": str(device), "alpha": alpha,
            "trace_cc": float(torch.diagonal(sigma_cc).sum()),
            "trace_ll": float(torch.diagonal(sigma_ll, dim1=1, dim2=2).sum()),
            "cam0": sigma_cc[:6, :6].cpu().tolist(), "lm0": sigma_ll[0].cpu().tolist(),
            "finite": bool(torch.isfinite(sigma_cc).all() and torch.isfinite(sigma_ll).all()),
            "t_s": time.perf_counter() - t0}


if __name__ == "__main__":
    values = {_option(k) for k in ("--cams", "--points", "--track", "--poses", "--landmarks",
                                   "--solver")}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    what = args[0] if args else "venice"
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    if what == "venice":
        f64 = "--f64" in sys.argv  # float64 SC of float64 pair products
        kw = dict(n_cams=int(_option("--cams") or 871), n_points=int(_option("--points") or 110_000),
                  mean_track=int(_option("--track") or 10), device=dev, sc_f64=f64,
                  pair_f32=not f64)
        res = profile_venice(**kw) if "--profile" in sys.argv else run_venice(**kw)
    elif what == "city":
        res = run_city_schur(int(_option("--poses") or 10000),
                             int(_option("--landmarks") or 100), dev,
                             _option("--solver") or "lambda-dl")
    elif what == "scene":
        res = run_ba_scene(int(_option("--cams") or 20), int(_option("--points") or 500), dev)
    elif what == "marginals":
        res = run_ba_marginals(int(_option("--cams") or 20), int(_option("--points") or 500),
                               dev)
    else:
        raise ValueError(f"unknown run {what!r}: venice, city, scene or marginals")
    res.pop("states", None)
    print(json.dumps(res))
