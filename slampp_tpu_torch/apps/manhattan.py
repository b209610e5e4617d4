"""Batch Gauss-Newton on a generated Manhattan pose graph through the
partitioned (v3) engine — the port's counterpart of the bench's primary row
(``bench.py`` ``bench_manhattan``): generate, parse, symbolic, snapshot, a
first fused ``optimize_fused`` call, then timed repeats with one host sync
at the end.

    python -m slampp_tpu_torch.apps.manhattan [n_poses] [device] [--dense-frames] [--profile]

prints one JSON object: ``run``'s result, or with ``--profile`` the layer
and kernel breakdown of one warm call (``profile``).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import torch

from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import build_system, parse_file
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.ops import dense_kernels as dk


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


def profile(n_poses: int, device, n_iters: int = 5, target: int = 64, refine: int = 0,
            mixed_precision: bool = True, dense_frames: bool = False, top: int = 15) -> dict:
    """Where the time of one warm ``optimize_fused`` call goes: torch.profiler
    over the call, device time per layer range (v3.assemble, v3.factor,
    v3.backsolve, v3.update), the ``top`` kernels by device time, and the
    device's idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    device = torch.device(device)
    system = manhattan_system(n_poses)
    ps = PartitionedSolver(system, target=target, mixed_precision=mixed_precision,
                           refine_iters=refine, device=device)
    ps.symbolic()
    if dense_frames:
        ps.plan = ps.plan._replace(ch_ok=0)
    graph = system.snapshot(device)
    float(ps.optimize_fused(graph, n_iters=n_iters)[3])  # warm-up
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        float(ps.optimize_fused(graph, n_iters=n_iters)[3])
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
        "n_poses": n_poses, "device": str(device), "chain_mode": bool(ps.plan.ch_ok),
        "n_iters": n_iters, "wall_us": wall_us, "device_busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / wall_us, "layers": layers,
        "top_kernels": [{"name": e.key, "device_us": e.self_device_time_total,
                         "count": e.count} for e in kernels[:top]],
    }


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 3500
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    if "--profile" in sys.argv:
        res = profile(n, dev, dense_frames="--dense-frames" in sys.argv)
    else:
        res = run(n, dev, dense_frames="--dense-frames" in sys.argv)
        res.pop("states")
    print(json.dumps(res))
