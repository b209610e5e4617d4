"""Sim(3) bundle adjustment, ROCV and Spheron on the port.

``run_sim3_venice`` is the library route of the reference's 3DV'17
incremental-BA app (``scripts/ref_parity.py``'s Sim(3) case): the
venice871-class cam / xyz scene of ``io/datasets.make_venice_ba_arrays``
(the scene of ``apps/ba.run_venice``) as a GraphSystem, embedded in Sim(3)
(``models/sim3.embed_ba_system_sim3``: camsim3 / xyz,
``edge_p2c_xyz_sim3_g``), then LM with ``use_schur``, which on a landmark
graph of 1500 vertices or more takes the sparse Schur engine: the reduced
camera system (7 x 7 blocks) on the v3 engine and its three kernels.
``run_sim3_small`` is ``ref_parity.py``'s ``sim3_ba_10cam_200pts`` case
(dense LM, 20 iterations), ``run_rocv`` and ``run_spheron`` parse a
generated dataset, detect the problem, build the system and run GN.

    python -m slampp_tpu_torch.apps.sim3 {venice,small,rocv,spheron} [device] [--cams N] [--points N] [--track N] [--f64] [--profile]

print the result as one JSON object.  The device defaults to ``cuda``;
name ``cpu`` to run on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from slampp_tpu_torch.apps.manhattan import _option, _sync
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io.datasets import (make_ba_scene, make_rocv, make_spheron,
                                          make_venice_ba_arrays)
from slampp_tpu_torch.io.parser import build_system, detect_problem, g2o_file, parse_file
from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.ops import schur_kernels
from slampp_tpu_torch.ops import sim3_kernels as sk
from slampp_tpu_torch.solvers import GaussNewtonSolver, LevenbergMarquardtSolver
from slampp_tpu_torch.utils.device import require_device


def venice_ba_system(n_cams: int, n_points: int, mean_track: int) -> GraphSystem:
    """The seed-0 venice-class scene as a cam / xyz GraphSystem
    (``ba_system_from_arrays``)."""
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0)
    return ba_system_from_arrays(cams, lms, oc, ol, uv, info)


def ba_system_from_arrays(cams, lms, obs_cam, obs_pt, uv, info) -> GraphSystem:
    """Observation arrays as a cam / xyz GraphSystem: cameras are vertices
    0..n_cams-1, points follow, one ``edge_p2c`` (point, camera) per
    observation in the arrays' order."""
    system = GraphSystem()
    n_c = len(cams)
    for c in range(n_c):
        system.add_vertex("cam", c, cams[c])
    for p in range(len(lms)):
        system.add_vertex("xyz", n_c + p, lms[p])
    for e in range(len(obs_cam)):
        system.add_edge("edge_p2c", (n_c + int(obs_pt[e]), int(obs_cam[e])), uv[e], info[e])
    return system


def _counted(fn):
    """(fn's result, the dense kernel launches it made, the distinct shapes
    it launched, the Sim(3) edge kernel's launches it made by form, the
    slot-sum kernel's launches), leaving ``dk.launches``,
    ``dk.launch_shapes``, ``sk.launches`` and ``schur_kernels.launches``
    counting on."""
    before, shapes0, fused0 = dict(dk.launches), set(dk.launch_shapes), dict(sk.launches)
    slot0 = dict(schur_kernels.launches)
    dk.launch_shapes.clear()
    out = fn()
    shapes = sorted(dk.launch_shapes, key=lambda s: (s[0], s[1], s[2], s[3] or 0))
    dk.launch_shapes.update(shapes0)
    return (out, {k: v - before[k] for k, v in dk.launches.items()}, shapes,
            {k: v - fused0[k] for k, v in sk.launches.items()},
            {k: v - slot0[k] for k, v in schur_kernels.launches.items()})


def run_sim3_venice(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10,
                    device="cuda", iters: int = 5, f64_check: bool = False) -> dict:
    """Build, embed and optimize the venice-class scene in Sim(3): LM with
    ``use_schur`` (the sparse Schur engine, mixed precision), ``iters``
    iterations with ``min_dx_norm=0`` after one step whose result is
    dropped.  Returns chi2 before and after, the accepted iterations, the
    sizes, the v3 geometry of the reduced camera system, the set-up split
    (build, embed, symbolic, first step), iterations/s of the loop, the
    dense kernel launches per iteration and their shapes, the Sim(3) edge
    kernel's and the slot-sum kernel's launches of the loop alone
    (``sim3_launches``, ``slot_launches``, with ``lm_iterations``), and on
    the card the peak memory.  ``f64_check`` then runs the same LM from the
    same start with the engine in float64 (``mixed_precision=False``, the
    symbolic shared) and adds its chi2, accepted count and launches."""
    device = torch.device(device)
    require_device(device, "run_sim3_venice")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ba_system = venice_ba_system(n_cams, n_points, mean_track)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    system = embed_ba_system_sim3(ba_system)
    t_embed = time.perf_counter() - t0
    start = {t: [s.copy() for s in v] for t, v in system._vstates.items()}

    lm = LevenbergMarquardtSolver(system, use_schur=True, device=device)
    engine = lm._resolve_engine()
    t0 = time.perf_counter()
    ss = lm._ss_solver()
    _sync(device)
    t_sym = time.perf_counter() - t0
    chi2_init = lm.chi2()
    # one step outside the loop, its result dropped (as run_venice's first
    # step): the card's first step allocates the working set and loads
    # its kernels
    t0 = time.perf_counter()
    float(ss.damped_step(system.snapshot(device), 1e-3)[2])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied, launches, shapes, fused, slot = _counted(lambda: lm.optimize(iters, 0.0))
    _sync(device)
    t_opt = time.perf_counter() - t0
    p, v3p = ss.plan, ss.v3_plan
    out = {"n_cams": p.n_p, "n_points": p.n_l, "n_obs": system.n_edges,
           "mean_track": mean_track, "n_pairs_kept": int(p.pair_e.shape[0]),
           "device": str(device), "engine": engine, "iters": iters,
           "chi2_init": chi2_init, "chi2_final": lm.chi2(), "lm_accepted": applied,
           "iters_per_sec": iters / t_opt, "t_optimize_s": t_opt,
           "t_build_s": t_build, "t_embed_s": t_embed, "t_symbolic_s": t_sym,
           "t_first_step_s": t_first,
           "plan": {"K": v3p.K, "M": v3p.M, "S": v3p.S, "SB": v3p.SB, "Ms": v3p.Ms,
                    "ch_ok": v3p.ch_ok},
           "launches_per_iter": {k: v / iters for k, v in launches.items()},
           "kernel_shapes": shapes, "sim3_launches": fused, "slot_launches": slot,
           "lm_iterations": lm.n_iterations}
    if f64_check:
        system.update_states({t: np.stack(v) for t, v in start.items()})
        ss.mixed_precision = False
        lm64 = LevenbergMarquardtSolver(system, use_schur=True, device=device)
        lm64._ss = ss
        t0 = time.perf_counter()
        applied64, launches64, shapes64, fused64, slot64 = _counted(
            lambda: lm64.optimize(iters, 0.0))
        _sync(device)
        out["f64"] = {"chi2_final": lm64.chi2(), "lm_accepted": applied64,
                      "iters_per_sec": iters / (time.perf_counter() - t0),
                      "launches_per_iter": {k: v / iters for k, v in launches64.items()},
                      "kernel_shapes": shapes64, "sim3_launches": fused64,
                      "slot_launches": slot64,
                      "lm_iterations": lm64.n_iterations}
        ss.mixed_precision = True
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def profile_sim3_venice(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10,
                        device="cuda", top: int = 12) -> dict:
    """Where one warm LM step of the embedded venice scene goes: the
    ``ss.*`` and ``v3.*`` ranges' device spans, busy and idle
    (``apps/manhattan._profiled``)."""
    from slampp_tpu_torch.apps.manhattan import _profiled

    device = torch.device(device)
    require_device(device, "profile_sim3_venice")
    system = embed_ba_system_sim3(venice_ba_system(n_cams, n_points, mean_track))
    lm = LevenbergMarquardtSolver(system, use_schur=True, device=device)
    ss = lm._ss_solver()
    graph = system.snapshot(device)
    step = lambda: float(ss.damped_step(graph, 1e-3)[2])  # noqa: E731
    step()
    return {"n_obs": system.n_edges, **_profiled(step, device, top, prefixes=("ss.", "v3."))}


def _text_system(text: str):
    with g2o_file(text) as path:
        records = parse_file(path)
    return detect_problem(records[:1000]), build_system(records)


def run_sim3_small(device="cuda", max_iters: int = 20, min_dx: float = 1e-6) -> dict:
    """``ref_parity.py``'s sim3_ba_10cam_200pts: ``make_ba_scene(10, 200,
    seed=5)`` parsed, embedded in Sim(3), dense LM."""
    device = torch.device(device)
    _, ba_system = _text_system(make_ba_scene(n_cams=10, n_points=200, seed=5)[0])
    system = embed_ba_system_sim3(ba_system)
    lm = LevenbergMarquardtSolver(system, device=device)
    chi2_init = lm.chi2()
    t0 = time.perf_counter()
    applied = lm.optimize(max_iters, min_dx)
    _sync(device)
    return {"device": str(device), "n_vertices": system.n_vertices, "n_edges": system.n_edges,
            "chi2_init": chi2_init, "chi2_final": lm.chi2(), "applied": applied,
            "t_optimize_s": time.perf_counter() - t0,
            "states": system.snapshot(device).states}


def _run_gn(text: str, device, max_iters: int, min_dx: float, use_schur: bool):
    device = torch.device(device)
    problem, system = _text_system(text)
    if use_schur:
        gn = GaussNewtonSolver(system, use_schur=True, device=device)
    else:
        gn = GaussNewtonSolver(system, linear_solver="dense", device=device)
    engine = gn._resolve_solver()
    chi2_init = gn.chi2()
    t0 = time.perf_counter()
    applied, launches, shapes, _, _ = _counted(lambda: gn.optimize(max_iters, min_dx))
    _sync(device)
    return {"problem": problem, "device": str(device), "engine": engine,
            "n_vertices": system.n_vertices, "n_edges": system.n_edges,
            "chi2_init": chi2_init, "chi2_final": gn.chi2(), "applied": applied,
            "iterations": gn.n_iterations, "t_optimize_s": time.perf_counter() - t0,
            "launches": launches, "kernel_shapes": shapes,
            "states": system.snapshot(device).states}


def run_rocv(n_steps: int = 1000, n_transmitters: int = 8, device="cuda",
             max_iters: int = 15, min_dx: float = 0.0) -> dict:
    """``make_rocv`` through parse, detect, build and dense f64 GN."""
    return _run_gn(make_rocv(n_steps, n_transmitters, seed=0)[0], device, max_iters, min_dx,
                   use_schur=False)


def run_spheron(n_poses: int = 64, n_points: int = 2000, device="cuda", max_iters: int = 5,
                min_dx: float = 0.01) -> dict:
    """``make_spheron`` through parse, detect, build and GN with
    ``use_schur``: from 1500 vertices the sparse Schur engine (6 x 6 pose
    blocks on the v3 engine, mixed)."""
    return _run_gn(make_spheron(n_poses, n_points, seed=0)[0], device, max_iters, min_dx,
                   use_schur=True)


if __name__ == "__main__":
    values = {_option(k) for k in ("--cams", "--points", "--track")}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    what = args[0] if args else "venice"
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    if what == "venice":
        kw = dict(n_cams=int(_option("--cams") or 871), n_points=int(_option("--points") or 110_000),
                  mean_track=int(_option("--track") or 10), device=dev)
        res = (profile_sim3_venice(**kw) if "--profile" in sys.argv
               else run_sim3_venice(**kw, f64_check="--f64" in sys.argv))
    elif what == "small":
        res = run_sim3_small(dev)
    elif what == "rocv":
        res = run_rocv(device=dev)
    elif what == "spheron":
        res = run_spheron(device=dev)
    else:
        raise ValueError(f"unknown run {what!r}: venice, small, rocv or spheron")
    res.pop("states", None)
    print(json.dumps(res))
