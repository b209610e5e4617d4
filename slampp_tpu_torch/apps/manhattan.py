"""Batch Gauss-Newton on a generated Manhattan pose graph through the
partitioned (v3) engine — the port's counterpart of the bench's primary row
(``bench.py`` ``bench_manhattan``): generate, parse, symbolic, snapshot, a
first fused ``optimize_fused`` call, then timed repeats with one host sync
at the end.

    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] [--dense-frames] [--profile]

prints one JSON object: ``run``'s result, or with ``--profile`` the layer
and kernel breakdown of one warm call (``profile``).

The batch solvers as the JAX package's CLI builds them for a pose graph
(GN on the native v1 engine, LM and dogleg on the dense or v3 engine), one
``optimize`` with the CLI's defaults (5 iterations, min |dx| 0.01):

    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] --solver lambda|lambda-lm|lambda-dl [--engine v3] [--profile]

prints ``run_solver``'s result, or with ``--profile`` ``profile_solver``'s.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from slampp_tpu_torch.core.assembly import apply_update, assemble_dense
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import build_system, parse_file
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.solvers import DoglegSolver, GaussNewtonSolver, LevenbergMarquardtSolver


def manhattan_system(n_poses: int, seed: int = 0):
    """The seed-``seed`` Manhattan graph, through the g2o text and parser."""
    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=seed)
    with tempfile.NamedTemporaryFile("w", suffix=".g2o", delete=False) as f:
        f.write(text)
        path = f.name
    try:
        return build_system(parse_file(path))
    finally:
        os.unlink(path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_poses: int, device, n_iters: int = 5, target: int = 64, refine: int = 0,
        mixed_precision: bool = True, dense_frames: bool = False, n_rep: int = 10) -> dict:
    """Optimize the Manhattan graph with ``n_iters`` fused GN iterations,
    ``1 + n_rep`` times from the same start.  ``dense_frames`` forces the
    dense-frame branch (the one taken when part interiors are not chains).

    Returns chi2_init / chi2_final (of the first call), the steady-state
    iterations per second (``n_iters`` over the median repeat, each repeat
    timed from a synced device to its one host read), the final states, the
    plan's shape, and the kernel launches made during the call."""
    device = torch.device(device)
    launches0 = dict(dk.launches)
    t0 = time.perf_counter()
    system = manhattan_system(n_poses)
    t_build = time.perf_counter() - t0

    ps = PartitionedSolver(system, target=target, mixed_precision=mixed_precision,
                           refine_iters=refine, device=device)
    t0 = time.perf_counter()
    ps.symbolic()
    t_symbolic = time.perf_counter() - t0
    if dense_frames:
        ps.plan = ps.plan._replace(ch_ok=0)
    graph = system.snapshot(device)

    t0 = time.perf_counter()
    states, _, chi2_init, chi2_final = ps.optimize_fused(graph, n_iters=n_iters)
    chi2_init, chi2_final = float(chi2_init), float(chi2_final)
    t_first = time.perf_counter() - t0

    calls = []  # seconds per repeat; each call ends in its one host sync
    for _ in range(n_rep):
        _sync(device)
        t0 = time.perf_counter()
        float(ps.optimize_fused(graph, n_iters=n_iters)[3])
        calls.append(time.perf_counter() - t0)
    p = ps.plan
    return {
        "n_poses": n_poses, "device": str(device), "mixed_precision": mixed_precision,
        "chain_mode": bool(p.ch_ok), "n_iters": n_iters, "n_rep": n_rep,
        "chi2_init": chi2_init, "chi2_final": chi2_final,
        "iters_per_sec": n_iters / statistics.median(calls) if n_rep else None,
        "call_s": calls,
        "t_build_s": t_build, "t_symbolic_s": t_symbolic, "t_first_s": t_first,
        "plan": {"n": p.n, "K": p.K, "M": p.M, "S": p.S, "SB": p.SB, "Ms": p.Ms,
                 "nnzb": p.nnzb, "ch_ok": p.ch_ok},
        "states": states,
        "launches": {k: v - launches0[k] for k, v in dk.launches.items()},
    }


def _profiled(fn, device: torch.device, top: int) -> dict:
    """torch.profiler over one call of ``fn``: its wall time, the device's
    busy time and idle share, the device span of each ``v3.*`` range and the
    ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # a layer range's device time is its span on the device timeline
    layers = {e.key: {"device_span_us": e.device_time_total, "count": e.count}
              for e in events if e.key.startswith("v3.")}
    kernels = sorted(  # device-side events only (an aten op also carries its kernels' time)
        (e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith("v3.")),
        key=lambda e: -e.self_device_time_total,
    )
    busy_us = sum(e.self_device_time_total for e in kernels)
    return {
        "wall_us": wall_us, "device_busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / wall_us, "layers": layers,
        "device_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key, "device_us": e.self_device_time_total,
                         "count": e.count} for e in kernels[:top]],
    }


def profile(n_poses: int, device, n_iters: int = 5, target: int = 64, refine: int = 0,
            mixed_precision: bool = True, dense_frames: bool = False, top: int = 15) -> dict:
    """Where the time of one warm ``optimize_fused`` call goes (``_profiled``)."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    ps = PartitionedSolver(system, target=target, mixed_precision=mixed_precision,
                           refine_iters=refine, device=device)
    ps.symbolic()
    if dense_frames:
        ps.plan = ps.plan._replace(ch_ok=0)
    graph = system.snapshot(device)
    float(ps.optimize_fused(graph, n_iters=n_iters)[3])  # warm-up
    return {"n_poses": n_poses, "device": str(device), "chain_mode": bool(ps.plan.ch_ok),
            "n_iters": n_iters,
            **_profiled(lambda: float(ps.optimize_fused(graph, n_iters=n_iters)[3]), device, top)}


# ------------------------------------------------------------ batch solvers


def make_solver(system, nls: str, device, engine=None):
    """The batch solver as the JAX package's CLI builds it for an SE(2) pose
    graph (``slampp_tpu/apps/main.py:195-228``): ``lambda`` is
    GaussNewtonSolver (auto: the native v1 engine), ``lambda-lm``
    LevenbergMarquardtSolver (dense), ``lambda-dl`` DoglegSolver (auto:
    dense); ``engine`` overrides the LM / dogleg engine ("v3")."""
    if nls == "lambda-lm":
        return LevenbergMarquardtSolver(system, use_schur=False, engine=engine or "dense",
                                        device=device)
    if nls == "lambda-dl":
        return DoglegSolver(system, device=device, **({"engine": engine} if engine else {}))
    if nls == "lambda":
        if engine is not None:
            raise ValueError("the lambda solver takes no engine; it resolves its linear solver")
        return GaussNewtonSolver(system, use_schur=False, device=device)
    raise ValueError(f"unknown solver {nls!r}")


def run_solver(n_poses: int, device, nls: str, engine=None, max_iters: int = 5,
               min_dx: float = 0.01) -> dict:
    """Optimize the seed-0 Manhattan graph once with a batch solver
    (``make_solver``), ``max_iters`` and ``min_dx`` as the CLI's -mnsi and
    -nset.  Returns chi2 before and after, the iterations applied and run,
    the optimize call's wall time and its time per iteration without the
    host planner (``s_per_iter``), the solver's per-phase times (a nested
    phase, such as ``v3_symbolic`` inside ``solve``, counts in both), the
    kernel launches during the call and the final states."""
    device = torch.device(device)
    t0 = time.perf_counter()
    system = manhattan_system(n_poses)
    t_build = time.perf_counter() - t0
    solver = make_solver(system, nls, device, engine)
    chi2_init = solver.chi2()
    launches0 = dict(dk.launches)
    t0 = time.perf_counter()
    applied = solver.optimize(max_iters, min_dx)
    _sync(device)
    t_opt = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in dk.launches.items()}
    # the host planner runs inside the first optimize; the rate leaves it out
    t_sym = sum(v for k, v in solver.timer.acc.items() if k.endswith("symbolic"))
    out = {
        "n_poses": n_poses, "device": str(device), "solver": nls, "engine": engine,
        "chi2_init": chi2_init, "chi2_final": solver.chi2(), "applied": applied,
        "iterations": solver.n_iterations, "t_build_s": t_build, "t_optimize_s": t_opt,
        "t_symbolic_s": t_sym, "s_per_iter": (t_opt - t_sym) / max(solver.n_iterations, 1),
        "phases": {k: {"s": v, "calls": solver.timer.counts[k]}
                   for k, v in solver.timer.acc.items()},
        "launches": launches,
        "states": system.snapshot(device).states,
    }
    native = getattr(solver, "_native", None)
    if native is not None:
        out["levels"] = native.dplan.n_levels
    return out


def profile_solver(n_poses: int, device, nls: str, engine=None, max_iters: int = 5,
                   min_dx: float = 0.01, top: int = 15) -> dict:
    """Where the time of one warm ``optimize`` call goes (``_profiled``):
    a first call builds the symbolic plan, then the states (and a dogleg's
    trust radius) go back to their start and the profiled call repeats the
    same iterations."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    states0 = system.snapshot("cpu").states
    solver = make_solver(system, nls, device, engine)
    radius0 = getattr(solver, "radius", None)
    solver.optimize(max_iters, min_dx)
    system.update_states(states0)
    if radius0 is not None:
        solver.radius = radius0
    out = {"n_poses": n_poses, "device": str(device), "solver": nls, "engine": engine}
    out.update(_profiled(lambda: out.update(applied=solver.optimize(max_iters, min_dx)),
                         device, top))
    native = getattr(solver, "_native", None)
    if native is not None:
        out["levels"] = native.dplan.n_levels
    return out


def run_prior(n_poses: int, device) -> dict:
    """One ``PartitionedSolver.gn_step_prior`` (mixed, ``refine_iters=2``
    as the solvers build it) on the Manhattan graph with 14 scattered
    vertices forced into the separator and an SPD prior (P, p)
    on the separator frame, made from seed 0, beside the dense float64 oracle
    dx = -(H + P)^-1 (g + p) assembled on the same device.  Returns the
    step's wall time, its kernel launches, the relative residual
    ||(H + P) dx + (g + p)|| / ||g + p|| of its dx and of the oracle's, the
    largest state difference to the oracle's update, both dx norms and
    both chi2 values."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    vorder = list(system._vorder)
    forced = vorder[10 :: max(1, len(vorder) // 14)]
    ps = PartitionedSolver(system, refine_iters=2, forced_separator=forced, device=device)
    ps.symbolic()
    sep = [int(b) for b in ps.separator_blocks]
    bs, Ms, SB = ps.plan.bs, ps.plan.Ms, len(sep)
    rng = np.random.default_rng(0)
    G = rng.normal(size=(SB * bs, SB * bs))
    P = G @ G.T / (SB * bs) + np.eye(SB * bs)
    p = rng.normal(size=SB * bs)
    sc = np.zeros((Ms, Ms))
    sc[: SB * bs, : SB * bs] = P
    rp = np.zeros(Ms)
    rp[: SB * bs] = p
    graph = system.snapshot(device)

    launches0 = dict(dk.launches)
    _sync(device)
    t0 = time.perf_counter()
    new_states, dx_norm, chi2 = ps.gn_step_prior(graph, sc, rp)
    dx_norm = float(dx_norm)
    t_step = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in dk.launches.items()}

    H, g, chi2_ref = assemble_dense(graph)
    offsets, _ = system._layout()
    idx = torch.as_tensor(np.concatenate(
        [np.arange(offsets[vorder[b]], offsets[vorder[b]] + bs) for b in sep]), device=device)
    H = H.clone()
    H[idx[:, None], idx[None, :]] += torch.as_tensor(P, dtype=torch.float64, device=device)
    g = g.clone()
    g[idx] += torch.as_tensor(p, dtype=torch.float64, device=device)
    dx_ref = solve_spd(H, -g)
    ref_states = apply_update(graph, dx_ref)
    # the step's dx, read back from the states through each type's local_diff
    dxp = torch.zeros(graph.state_dim + bs, dtype=torch.float64, device=device)
    for t, st in graph.states.items():
        vt = get_vertex_type(t)
        idx = graph.vertex_offsets[t][:, None] + torch.arange(vt.dim, device=device)
        dxp[idx] = vt.local_diff(new_states[t], st)
    dx = dxp[: graph.state_dim]
    gn = torch.linalg.norm(g)
    return {
        "n_poses": n_poses, "device": str(device), "SB": SB, "n_forced": len(forced),
        "chain_mode": bool(ps.plan.ch_ok),
        "t_step_s": t_step, "launches": launches,
        "residual": float(torch.linalg.norm(H @ dx + g) / gn),
        "residual_ref": float(torch.linalg.norm(H @ dx_ref + g) / gn),
        "max_state_err": max(float((new_states[t] - ref_states[t]).abs().max())
                             for t in ref_states),
        "max_abs_dx_ref": float(dx_ref.abs().max()),
        "dx_norm": dx_norm, "dx_norm_ref": float(torch.linalg.norm(dx_ref)),
        "chi2": float(chi2), "chi2_ref": float(chi2_ref),
        "states": new_states,
    }


def _option(name: str):
    """The value after ``--name`` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(name) + 1] if name in argv else None


if __name__ == "__main__":
    solver_kind, engine_kind = _option("--solver"), _option("--engine")
    values = {solver_kind, engine_kind}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    n = int(args[0]) if args else 3500
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    if solver_kind is not None:
        if "--profile" in sys.argv:
            res = profile_solver(n, dev, solver_kind, engine_kind)
        else:
            res = run_solver(n, dev, solver_kind, engine_kind)
            res.pop("states")
    elif "--profile" in sys.argv:
        res = profile(n, dev, dense_frames="--dense-frames" in sys.argv)
    else:
        res = run(n, dev, dense_frames="--dense-frames" in sys.argv)
        res.pop("states")
    print(json.dumps(res))
