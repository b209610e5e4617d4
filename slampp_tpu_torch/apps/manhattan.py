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

    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] --solver lambda|lambda-lm|lambda-dl|A|spcg [--engine v3] [--profile]

prints ``run_solver``'s result, or with ``--profile`` ``profile_solver``'s.

The native sparse engines (NativeBlockSolver: v1 scatter-add levels or v2
level windows, ``panel`` blocks per supernodal panel), K chained f64 GN
iterations, eagerly or (v2) as ``optimize_fused``'s CUDA graph; the
marginal covariances (dense ``update_batch`` against the recursive sparse
``update_batch_sparse``); the eigenvalue analysis (largest, smallest by
shift-invert through the v3 factorization, condition number):

    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] --native v1|v2 [--panel P] [--fused] [--mixed] [--profile]
    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] --marginals
    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] --eigen

print ``run_native`` (or ``profile_native``), ``run_marginals`` and
``run_eigen``'s results.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from slampp_tpu_torch.core.assembly import apply_update, assemble_dense, graph_chi2, slot_states
from slampp_tpu_torch.eval import eigenvalues as eig
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.linear.native import NativeBlockSolver
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.marginals import MarginalCovariance
from slampp_tpu_torch.models.robust import apply_robust_to_system
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.solvers import DoglegSolver, GaussNewtonSolver, LevenbergMarquardtSolver


def manhattan_system(n_poses: int, seed: int = 0):
    """The seed-``seed`` Manhattan graph, through the g2o text and parser."""
    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=seed)
    with g2o_file(text) as path:
        return build_system(parse_file(path))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_poses: int, device, n_iters: int = 5, target: int = 64, refine: int = 0,
        mixed_precision: bool = True, dense_frames: bool = False, n_rep: int = 10,
        build=manhattan_system) -> dict:
    """Optimize the graph ``build(n_poses)`` (the Manhattan graph unless
    another ``build`` is given) with ``n_iters`` fused GN iterations,
    ``1 + n_rep`` times from the same start.  ``dense_frames`` forces the
    dense-frame branch (the one taken when part interiors are not chains).

    Returns chi2_init / chi2_final (of the first call), the steady-state
    iterations per second (``n_iters`` over the median repeat, each repeat
    timed from a synced device to its one host read), the final states, the
    plan's shape, and the kernel launches made during the call."""
    device = torch.device(device)
    launches0 = dict(dk.launches)
    t0 = time.perf_counter()
    system = build(n_poses)
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


def _profiled(fn, device: torch.device, top: int, prefixes=("v3.",)) -> dict:
    """torch.profiler over one call of ``fn``: its wall time, the device's
    busy time and idle share, the device span of each range whose name
    starts with one of ``prefixes`` and the ``top`` kernels by device
    time."""
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
              for e in events if e.key.startswith(prefixes)}
    kernels = sorted(  # device-side events only (an aten op also carries its kernels' time)
        (e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith(prefixes)),
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
            mixed_precision: bool = True, dense_frames: bool = False, top: int = 15,
            build=manhattan_system) -> dict:
    """Where the time of one warm ``optimize_fused`` call on ``build(n_poses)``
    goes (``_profiled``)."""
    device = torch.device(device)
    system = build(n_poses)
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
    dense), ``A`` ASolver (GN on the explicit Jacobian), ``spcg``
    SPCGSolver (GN with spanning-tree-preconditioned CG); ``engine``
    overrides the LM / dogleg engine ("v3")."""
    if nls == "lambda-lm":
        return LevenbergMarquardtSolver(system, use_schur=False, engine=engine or "dense",
                                        device=device)
    if nls == "lambda-dl":
        return DoglegSolver(system, device=device, **({"engine": engine} if engine else {}))
    if nls == "lambda":
        if engine is not None:
            raise ValueError("the lambda solver takes no engine; it resolves its linear solver")
        return GaussNewtonSolver(system, use_schur=False, device=device)
    if nls in ("A", "spcg") and engine is None:
        from slampp_tpu_torch.linear.spcg import SPCGSolver
        from slampp_tpu_torch.solvers.a_solver import ASolver

        return (ASolver if nls == "A" else SPCGSolver)(system, device=device)
    raise ValueError(f"unknown solver {nls!r}" + (f" with engine {engine!r}" if engine else ""))


def run_solver(n_poses: int, device, nls: str, engine=None, max_iters: int = 5,
               min_dx: float = 0.01, build=manhattan_system, robust=None) -> dict:
    """Optimize the graph ``build(n_poses)`` (the seed-0 Manhattan graph
    unless another ``build`` is given) once with a batch solver
    (``make_solver``), ``max_iters`` and ``min_dx`` as the CLI's -mnsi and
    -nset; ``robust=(loss, on_chi2)`` first rebinds every edge type to its
    robust variant, as the CLI's ``--robust`` does.  Returns chi2 before and
    after, the iterations applied and run, the optimize call's wall time and
    its time per iteration without the host planner (``s_per_iter``), the
    solver's per-phase times (a nested phase, such as ``v3_symbolic`` inside
    ``solve``, counts in both), the kernel launches during the call, with
    ``robust`` the IRLS weights at the final states (their share below 1,
    least and mean), and the final states."""
    device = torch.device(device)
    t0 = time.perf_counter()
    system = build(n_poses)
    t_build = time.perf_counter() - t0
    if robust is not None:
        loss, on_chi2 = robust
        apply_robust_to_system(system, loss=loss, on_chi2=on_chi2)
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
    final = system.snapshot(device)
    out = {
        "n_poses": n_poses, "device": str(device), "solver": nls, "engine": engine,
        "chi2_init": chi2_init, "chi2_final": solver.chi2(), "applied": applied,
        "iterations": solver.n_iterations, "t_build_s": t_build, "t_optimize_s": t_opt,
        "t_symbolic_s": t_sym, "s_per_iter": (t_opt - t_sym) / max(solver.n_iterations, 1),
        "phases": {k: {"s": v, "calls": solver.timer.counts[k]}
                   for k, v in solver.timer.acc.items()},
        "launches": launches,
        "states": final.states,
    }
    if robust is not None:
        out["robust"] = {"loss": robust[0], "on_chi2": robust[1], **_robust_weights(final)}
    if hasattr(solver, "cg_counts"):  # SPCG: CG iterations per GN step, its CUDA graph
        out["cg_counts"] = list(solver.cg_counts)
        out["cg_graph"] = {"nodes": solver.graph_nodes, "capture_s": solver.capture_s}
    native = getattr(solver, "_native", None)
    if native is not None:
        out["levels"] = native.dplan.n_levels
    return out


def _robust_weights(graph) -> dict:
    """The IRLS weights of every robust edge at the graph's states: the
    share below 1, the least and the mean."""
    ws = []
    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        if et.robust_weight_fn is not None:
            r = et.error_fn(slot_states(et, ea, graph.states), ea.meas)
            ws.append(et.robust_weight_fn(r, ea.sigma_inv)[ea.valid])
    w = torch.cat(ws)
    return {"n_edges": int(w.numel()), "share_below_1": float((w < 1.0).double().mean()),
            "min_weight": float(w.min()), "mean_weight": float(w.mean())}


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


# ------------------------------------------------------- native sparse engines


def _native_iterations(ns: NativeBlockSolver, graph, n_iters: int, fused: bool):
    """``n_iters`` chained GN iterations with no early exit: (states, chi2
    before, chi2 after), the chi2 as 0-d tensors.  ``fused`` is
    ``optimize_fused`` (a CUDA graph on the card); otherwise ``gn_step``
    chained eagerly, as the JAX package's v1 has no fused form."""
    if fused:
        states, _, chi0, chi2 = ns.optimize_fused(graph, n_iters)
        return states, chi0, chi2
    states, chi0 = graph.states, None
    for _ in range(n_iters):
        states, _, c = ns.gn_step(graph.replace_states(states))
        chi0 = c if chi0 is None else chi0
    return states, chi0, graph_chi2(graph.replace_states(states))


def run_native(n_poses: int, device, engine: str = "v2", panel: int = 1, mixed: bool = False,
               fused: bool = False, n_iters: int = 5, build=manhattan_system) -> dict:
    """``n_iters`` GN iterations of NativeBlockSolver on the graph
    ``build(n_poses)`` (the Manhattan graph unless another ``build`` is given),
    twice from the same start: the first call builds what the solver caches
    (on the card, the CUDA graph of one iteration), the second is timed from
    a synced device to its host read.  Returns chi2 before and after (of the
    first call), seconds per iteration (second call), the plan's level
    count and panel size, the CUDA graph's node count and capture time when
    ``fused`` on the card, the dense-kernel launches (the native engines
    make none) and the final states."""
    device = torch.device(device)
    system = build(n_poses)
    ns = NativeBlockSolver(system, panel=panel, mixed_precision=mixed, engine=engine,
                           device=device)
    t0 = time.perf_counter()
    ns.symbolic()
    t_symbolic = time.perf_counter() - t0
    graph = system.snapshot(device)
    launches0 = dict(dk.launches)
    t0 = time.perf_counter()
    states, chi0, chi2 = _native_iterations(ns, graph, n_iters, fused)
    chi0, chi2 = float(chi0), float(chi2)
    t_first = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    float(_native_iterations(ns, graph, n_iters, fused)[2])
    t_call = time.perf_counter() - t0
    out = {
        "n_poses": n_poses, "device": str(device), "engine": engine, "panel": panel,
        "P": ns.block_plan.P, "mixed": mixed, "fused": fused, "n_iters": n_iters,
        "levels": ns.n_levels, "nnzb": ns.block_plan.nnzb,
        "chi2_init": chi0, "chi2_final": chi2, "t_symbolic_s": t_symbolic,
        "t_first_s": t_first, "t_call_s": t_call, "s_per_iter": t_call / n_iters,
        "launches": {k: v - launches0[k] for k, v in dk.launches.items()},
        "states": states,
    }
    if fused and device.type == "cuda":
        step = ns.captured_step(graph)
        out.update(graph_nodes=step.nodes, capture_s=step.capture_s)
    return out


def profile_native(n_poses: int, device, engine: str = "v2", panel: int = 1,
                   mixed: bool = False, fused: bool = False, n_iters: int = 1,
                   top: int = 15) -> dict:
    """Where the time of one warm call of ``n_iters`` native GN iterations
    goes (``_profiled``), after a first call that builds the plan and, when
    ``fused`` on the card, the CUDA graph."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    ns = NativeBlockSolver(system, panel=panel, mixed_precision=mixed, engine=engine,
                           device=device)
    graph = system.snapshot(device)
    float(_native_iterations(ns, graph, n_iters, fused)[2])
    out = {"n_poses": n_poses, "device": str(device), "engine": engine, "panel": panel,
           "fused": fused, "n_iters": n_iters, "levels": ns.n_levels}
    out.update(_profiled(lambda: float(_native_iterations(ns, graph, n_iters, fused)[2]),
                         device, top))
    return out


def run_marginals(n_poses: int, device) -> dict:
    """The Manhattan graph brought near its optimum by 5 fused GN iterations
    (v2 engine, panel 8), then its block-diagonal marginal covariances twice:
    ``update_batch`` (dense H on the device, Cholesky, two triangular solves)
    and ``update_batch_sparse`` (v2 factor at panel 1, block Takahashi).  Returns
    the seconds of each, the largest relative difference of a block (over
    the dense block's largest entry), vertex 0's block and the sum of the
    block traces from each, and the chi2 at the linearization point."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    ns = NativeBlockSolver(system, panel=8, engine="v2", device=device)
    states, _, chi2 = _native_iterations(ns, system.snapshot(device), 5, True)
    system.update_states(states)
    dense, sparse = MarginalCovariance(system, device), MarginalCovariance(system, device)
    _sync(device)
    t0 = time.perf_counter()
    dense.update_batch()
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    sparse.update_batch_sparse()
    t_sparse = time.perf_counter() - t0
    rel = max(float(np.abs(sparse.block_diag[v] - b).max() / np.abs(b).max())
              for v, b in dense.block_diag.items())
    return {
        "n_poses": n_poses, "device": str(device), "chi2": float(chi2),
        "n_blocks": len(dense.block_diag), "same_vertices": set(sparse.block_diag) == set(dense.block_diag),
        "t_dense_s": t_dense, "t_sparse_s": t_sparse, "max_rel_block_diff": rel,
        "block0": dense.block_diag[0].tolist(), "block0_sparse": sparse.block_diag[0].tolist(),
        "trace_sum": float(sum(np.trace(b) for b in dense.block_diag.values())),
        "trace_sum_sparse": float(sum(np.trace(b) for b in sparse.block_diag.values())),
    }


def run_eigen(n_poses: int, device, iters: int = 80, target: int = 64) -> dict:
    """The eigenvalue analysis of the Manhattan graph's lambda at its initial
    states, through the entry points: ``sparse_largest_eigenvalues`` and
    ``sparse_smallest_eigenvalues_shift_invert`` (k = 1, ``iters`` Lanczos
    iterations each; the latter factors through the f64 v3 engine and so
    launches the three dense kernels), and their ratio, the condition
    number.  Then, on an operator of its own, one ``solve_shifted`` that
    factors and one that reuses the factor: their seconds and kernel
    launches.  Returns the values, the seconds of each call and the kernel
    launches of the shift-invert call and the distinct kernel shapes it
    launched."""
    device = torch.device(device)
    system = manhattan_system(n_poses)
    _sync(device)
    t0 = time.perf_counter()
    lmax = float(eig.sparse_largest_eigenvalues(system, 1, iters, target, device)[0][0])
    t_largest = time.perf_counter() - t0
    launches0 = dict(dk.launches)
    dk.launch_shapes.clear()
    t0 = time.perf_counter()
    lmin = float(eig.sparse_smallest_eigenvalues_shift_invert(system, 1, 0.0, iters, target,
                                                              device)[0][0])
    t_smallest = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in dk.launches.items()}
    shapes = sorted(dk.launch_shapes, key=lambda s: (s[0], s[1], s[2], s[3] or 0, s[4]))

    op = eig.SparseSystemOperator(system, target, device)
    x = torch.randn(op.n, generator=torch.Generator(device=device).manual_seed(1),
                    dtype=torch.float64, device=device)
    probe = {}
    for name in ("factor_and_solve", "solve"):
        before = dict(dk.launches)
        _sync(device)
        t0 = time.perf_counter()
        op.solve_shifted(x, 0.0)
        _sync(device)
        probe[name] = {"s": time.perf_counter() - t0,
                       "launches": {k: v - before[k] for k, v in dk.launches.items()}}
    return {
        "n_poses": n_poses, "device": str(device), "n": op.n, "iters": iters,
        "plan": {"K": op._p.K, "M": op._p.M, "Ms": op._p.Ms, "ch_ok": op._p.ch_ok},
        "lmax": lmax, "lmin": lmin, "cond": abs(lmax) / max(abs(lmin), 1e-300),
        "t_largest_s": t_largest, "t_smallest_s": t_smallest,
        "launches": launches, "kernel_shapes": shapes, "solve_shifted": probe,
    }


def _option(name: str):
    """The value after ``--name`` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(name) + 1] if name in argv else None


if __name__ == "__main__":
    solver_kind, engine_kind = _option("--solver"), _option("--engine")
    native_kind, panel_size = _option("--native"), _option("--panel")
    values = {solver_kind, engine_kind, native_kind, panel_size}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    n = int(args[0]) if args else 3500
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    if native_kind is not None:
        kw = dict(engine=native_kind, panel=int(panel_size or 1), mixed="--mixed" in sys.argv,
                  fused="--fused" in sys.argv)
        if "--profile" in sys.argv:
            res = profile_native(n, dev, **kw)
        else:
            res = run_native(n, dev, **kw)
            res.pop("states")
    elif "--marginals" in sys.argv:
        res = run_marginals(n, dev)
    elif "--eigen" in sys.argv:
        res = run_eigen(n, dev)
    elif solver_kind is not None:
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
