"""The incremental solvers on a generated pose graph — the port's
counterpart of the bench's ``bench_incremental`` row
(``manhattan3500_incremental_steps_per_sec``, the reference's ``-fL``
role) and of the JAX CLI's ``-nsp`` path: generate the seed-0 graph (the
Manhattan graph, or with ``--graph sphere`` the SE(3) sphere of one ring
per 50 poses), write and parse its g2o text, stream it through
``build_system(..., on_edge=...)`` with one ``incremental_step`` per edge,
then ``refresh_frozen``, ``chi2`` and a final ``optimize``.

    python -m slampp_tpu_torch.apps.incremental [n_poses] [device] [--graph manhattan|sphere] [--engine fastl|windowed|every-n] [--live-engine auto|v3|dense]

prints ``run_incremental``'s result as one JSON object.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.io.datasets import make_manhattan, sphere_text
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.solvers import FastLSolver, IncrementalSolver, WindowedIncrementalSolver
from slampp_tpu_torch.utils.device import require_device

ENGINES = {"fastl": FastLSolver, "windowed": WindowedIncrementalSolver,
           "every-n": IncrementalSolver}
# graph -> (its seed-0 g2o text for n poses, the problem build_system is told)
GRAPHS = {
    "manhattan": (lambda n: make_manhattan(n_poses=n, loop_prob=0.1, seed=0)[0], "se2"),
    "sphere": (sphere_text, "se3"),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _blas_threads():
    """The BLAS libraries' thread counts as threadpoolctl sees them, or None
    without threadpoolctl."""
    try:
        from threadpoolctl import threadpool_info
    except ImportError:
        return None
    return {i["internal_api"]: i["num_threads"] for i in threadpool_info()
            if i["user_api"] == "blas"}


def _launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in dk.launches.items()}


def run_incremental(n_poses: int, device, engine: str = "fastl", optimize: bool = True,
                    graph: str = "manhattan", **solver_kw) -> dict:
    """Stream the seed-0 ``graph`` (``GRAPHS``) through one incremental
    solver at every-vertex cadence (``solve_period=1``,
    ``require_loop_closure=False``, as the bench row; ``solver_kw``
    overrides these and passes the solver's other keywords), then
    ``refresh_frozen``.

    Returns the solves, solves/s over the streaming (parsing the g2o file,
    the parse loop with its solves, and ``refresh_frozen``, as the bench
    row times it),
    the streamed chi2, the solver's counters, its ``PhaseTimer`` phases,
    the kernel launches while streaming and in the final ``optimize``, the
    distinct kernel shapes (name, K, M, S, dtype) launched over the run,
    and ``optimize()``'s return and the chi2 after it."""
    device = torch.device(device)
    require_device(device, "run_incremental")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {sorted(ENGINES)}")
    make_text, problem = GRAPHS[graph]
    text = make_text(n_poses)
    system = GraphSystem()
    kw = {"solve_period": 1, "require_loop_closure": False, **solver_kw}
    inc = ENGINES[engine](system, device=device, **kw)
    dk.launch_shapes.clear()
    launches0 = dict(dk.launches)
    with g2o_file(text) as path:
        t0 = time.perf_counter()
        build_system(parse_file(path), problem=problem, system=system,
                     on_edge=lambda s, n: inc.incremental_step())
        if hasattr(inc, "refresh_frozen"):
            inc.refresh_frozen()
        _sync(device)
        t_stream = time.perf_counter() - t0
    launches_stream = _launch_delta(launches0)
    chi2_stream = inc.chi2()
    out = {
        "n_poses": n_poses, "device": str(device), "graph": graph, "engine": engine,
        "solver_kw": kw,
        "n_edges": system.n_edges, "solves": inc.n_solves, "t_stream_s": t_stream,
        "solves_per_sec": inc.n_solves / t_stream, "chi2_stream": chi2_stream,
        "counters": {k: getattr(inc, k) for k in (
            "n_steps", "n_solves", "n_freezes", "n_refreezes", "n_relin", "n_full_factor",
            "n_resumed_factor", "n_iterations") if hasattr(inc, k)},
    }
    if hasattr(inc, "counts"):
        out["full_solves"] = dict(inc.counts)
    if isinstance(inc, FastLSolver):
        out["live_dim"] = inc._N
        out["blas_pinned"] = inc.blas_pinned
        out["blas_threads"] = _blas_threads()
        out["openblas_num_threads"] = os.environ.get("OPENBLAS_NUM_THREADS")
    if hasattr(inc, "sep_ids"):
        out["separator_vertices"] = len(inc.sep_ids)
    out["launches_stream"] = launches_stream
    if optimize:
        launches0 = dict(dk.launches)
        t0 = time.perf_counter()
        out["optimize_return"] = inc.optimize()
        _sync(device)
        out["t_optimize_s"] = time.perf_counter() - t0
        out["launches_optimize"] = _launch_delta(launches0)
        out["chi2_final"] = inc.chi2()
    out["phases"] = {k: {"s": v, "calls": inc.timer.counts[k]} for k, v in inc.timer.acc.items()}
    out["kernel_shapes"] = sorted(dk.launch_shapes, key=lambda s: (s[0], s[1], s[2], s[3] or 0, s[4]))
    out["states"] = system.snapshot(device).states
    return out


def _option(name: str):
    """The value after ``--name`` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(name) + 1] if name in argv else None


if __name__ == "__main__":
    engine_kind, live_engine = _option("--engine") or "fastl", _option("--live-engine")
    graph_kind = _option("--graph") or "manhattan"
    values = {engine_kind, live_engine, graph_kind}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    n = int(args[0]) if args else 800
    dev = args[1] if len(args) > 1 else "cuda"
    kw = {"live_engine": live_engine} if live_engine else {}
    res = run_incremental(n, dev, engine_kind, graph=graph_kind, **kw)
    res.pop("states")
    print(json.dumps(res, default=lambda o: o.item() if isinstance(o, np.generic) else str(o)))
