"""The multi-rank paths (``parallel/``) run as a user runs them: one spawned
process per rank through ``parallel.distributed.run_ranks``, NCCL on the
card unless the caller names gloo.

``run_dist_gn`` iterates the edge-sharded dense GN step on a Manhattan
graph; ``run_dist_venice`` is ``apps/ba.run_venice``'s loop on the
landmark-sharded ``DistributedBigBASolver`` (the scene made once in the
calling process and handed to every rank); ``run_dist_marginals`` the
distributed marginal covariances; ``run_dist_chunks`` the rank-parallel
chunk elimination against a NumPy sequential elimination;
``run_dist_ba_step`` and ``run_dist_ba_optimize`` one step / the LM loop on
a BA problem given as g2o text or as arrays.  Every runner returns rank 0's
result with ``world``, ``backend`` and each rank's device, after checking
that the ranks agree.

    python -m slampp_tpu_torch.apps.distributed gn [device] [--poses N] [--world W] [--backend B]
    python -m slampp_tpu_torch.apps.distributed venice [device] [--cams N] [--points N] [--track N] [--world W] [--backend B]
    python -m slampp_tpu_torch.apps.distributed marginals [device] [--cams N] [--points N] [--world W] [--backend B]
    python -m slampp_tpu_torch.apps.distributed chunks [device] [--chunks N] [--world W] [--backend B]

print the result as one JSON object.  The device defaults to ``cuda`` and
the backend to NCCL there (one card per rank); ``--backend gloo`` puts
several ranks on one card, staging the collectives through the host.
Name ``cpu`` (gloo) to run on the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from slampp_tpu_torch.apps.manhattan import _option, _sync
from slampp_tpu_torch.core.assembly import graph_chi2
from slampp_tpu_torch.io.datasets import make_manhattan, make_venice_ba_arrays
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.ops import ba_kernels as bak
from slampp_tpu_torch.ops import dense_kernels as dk
from slampp_tpu_torch.parallel.distributed import (
    distributed_gn_step,
    make_mesh,
    run_ranks,
    shard_graph_edges,
)
from slampp_tpu_torch.parallel.distributed_ba import (
    DistributedBigBASolver,
    build_ba_shards,
    build_big_ba_shards,
    build_big_ba_shards_arrays,
    distributed_ba_lm_step,
    distributed_big_ba_marginals,
    distributed_big_ba_step,
)
from slampp_tpu_torch.parallel.distributed_incremental import eliminate_chunks_mesh, pack_chunks


def _text_system(text: str):
    with g2o_file(text) as path:
        return build_system(parse_file(path))


def _big_shards(problem, mesh):
    """BigBAShards of a BA problem: g2o text, or the arrays (cams, lms,
    obs_cam, obs_lm, uv, info) of ``make_venice_ba_arrays``."""
    if isinstance(problem, str):
        return build_big_ba_shards(_text_system(problem), mesh)
    return build_big_ba_shards_arrays(*problem[:6], mesh)


def _agree(results, keys):
    """Rank 0's result with every rank's device, after checking that the
    replicated values in ``keys`` are equal on every rank."""
    for r, res in enumerate(results[1:], 1):
        for k in keys:
            if res[k] != results[0][k]:
                raise RuntimeError(f"rank {r} disagrees with rank 0 on {k}: "
                                   f"{res[k]} != {results[0][k]}")
    return {**results[0], "world": len(results),
            "rank_devices": [res["device"] for res in results]}


def _collectives(mesh, steps: int) -> dict:
    return {"allreduce_calls": mesh.stats.calls,
            "allreduce_bytes_per_step": mesh.stats.bytes / max(steps, 1),
            "allreduce_ms_per_step": mesh.stats.ms() / max(steps, 1)}


# ------------------------------------------------------------------------ GN


def _gn_rank(text, n_steps, backend, device):
    mesh = make_mesh(device, backend, "edges")
    system = _text_system(text)
    graph = shard_graph_edges(system.snapshot("cpu"), mesh)
    # NCCL makes its communicator at the first collective: not in the timing
    mesh.all_reduce(torch.zeros(1, dtype=torch.float64, device=mesh.device))
    mesh.stats.reset()
    dk.reset_launches()
    _sync(mesh.device)
    t0 = time.perf_counter()
    chi2, dx_norm = [], []
    for _ in range(n_steps):
        states, dxn, c2 = distributed_gn_step(graph, mesh)
        graph = graph.replace_states(states)
        chi2.append(float(c2))
        dx_norm.append(float(dxn))
    _sync(mesh.device)
    dt = time.perf_counter() - t0
    out = {"device": str(mesh.device), "backend": mesh.backend, "chi2": chi2,
           "dx_norm": dx_norm, "s_per_step": dt / n_steps, "launches": dict(dk.launches),
           "n_edges_rank": sum(int(ea.valid.shape[0]) for ea in graph.edges.values()),
           "state_dim": graph.state_dim, **_collectives(mesh, n_steps)}
    out["chi2_final"] = float(mesh.all_reduce(graph_chi2(graph)[None])[0])
    out["states"] = {k: v.cpu().numpy() for k, v in graph.states.items()}
    return out


def run_dist_gn(n_poses: int = 3500, world: int = 1, backend: str = None, device="cuda",
                n_steps: int = 5, text: str = None, timeout_s: float = 600.0) -> dict:
    """``n_steps`` edge-sharded GN steps on the seed-0 Manhattan graph (or
    the g2o ``text`` given): chi2 and |dx| of each step (chi2 at the step's
    input), chi2 after the last, the final states, seconds per step, the
    bytes all-reduced per step and the all-reduce time per step."""
    if text is None:
        text = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)[0]
    res = run_ranks(_gn_rank, world, backend, device, (text, n_steps, backend, str(device)),
                    timeout_s)
    return {"n_poses": n_poses, **_agree(res, ("chi2", "dx_norm", "chi2_final"))}


# -------------------------------------------------------------- venice class


def venice_scene(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10):
    """The seed-0 venice-class scene as the arrays the ranks take."""
    return make_venice_ba_arrays(n_cams=n_cams, n_points=n_points, mean_track=mean_track,
                                 seed=0)[:6]


def _venice_rank(problem, n_iters, backend, device):
    mesh = make_mesh(device, backend, "lm")
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    solver = DistributedBigBASolver.from_arrays(*problem, mesh)
    _sync(mesh.device)
    t_sym = time.perf_counter() - t0
    sh = solver.shards
    chi2_0 = solver.chi2()
    t0 = time.perf_counter()
    float(distributed_big_ba_step(sh, mesh, 1e-3)[2])
    t_first = time.perf_counter() - t0
    mesh.stats.reset()
    dk.reset_launches()
    bak.reset_launches()
    t0 = time.perf_counter()
    applied = solver.optimize(max_iterations=n_iters, min_dx_norm=0.0)
    _sync(mesh.device)
    dt = time.perf_counter() - t0
    p2c_launches = dict(bak.launches)
    steps = mesh.stats.calls // 2  # each step all-reduces twice
    collectives = _collectives(mesh, steps)
    out = {"device": str(mesh.device), "backend": mesh.backend, "n_cams": sh.plan.n_c,
           "n_points": sh.n_l, "n_obs_rank": sh.plan.n_obs,
           "n_pairs_rank": int(sh.plan.pair_e.shape[0]) - 1, "sc_dim": 6 * sh.plan.n_c,
           "n_iters": n_iters, "iters_per_sec": n_iters / dt, "t_optimize_s": dt,
           "lm_accepted": applied, "chi2_init": chi2_0, "chi2_final": solver.chi2(),
           "t_symbolic_s": t_sym, "t_first_step_s": t_first, "steps": steps,
           "launches": dict(dk.launches), "p2c_launches": p2c_launches, **collectives}
    if mesh.device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9
    out["n_obs"] = int(mesh.all_reduce(torch.tensor([sh.plan.n_obs], device=mesh.device))[0])
    return out


def run_dist_venice(n_cams: int = 871, n_points: int = 110_000, mean_track: int = 10,
                    world: int = 1, backend: str = None, device="cuda", n_iters: int = 5,
                    scene=None, timeout_s: float = 900.0) -> dict:
    """``apps/ba.run_venice``'s loop on the landmark-sharded solver: the
    scene (made here unless ``scene`` is given), each rank's symbolic phase,
    one first step, then ``optimize`` with ``n_iters`` LM iterations and
    ``min_dx_norm=0``.  Returns run_venice's figures (iterations/s, accepted
    steps, chi2 before and after, the set-up split, peak memory of rank 0)
    plus ``world``, ``backend``, the bytes all-reduced per step and the
    ``dist.allreduce`` time per step."""
    t0 = time.perf_counter()
    if scene is None:
        scene = venice_scene(n_cams, n_points, mean_track)
    t_gen = time.perf_counter() - t0
    res = run_ranks(_venice_rank, world, backend, device,
                    (tuple(scene), n_iters, backend, str(device)), timeout_s)
    return {"mean_track": mean_track, "t_generate_s": t_gen,
            **_agree(res, ("lm_accepted", "chi2_init", "chi2_final"))}


# ------------------------------------------------------------------- BA steps


def _ba_step_rank(problem, alpha, dense, backend, device):
    mesh = make_mesh(device, backend, "lm")
    if dense:
        system = _text_system(problem)
        sh, step = build_ba_shards(system, mesh), distributed_ba_lm_step
        n_l = sum(t == "xyz" for t, _ in system.vertex_index.values())
    else:
        sh, step = _big_shards(problem, mesh), distributed_big_ba_step
        n_l = sh.n_l
    cams, lms, dxn, chi2, denom = step(sh, mesh, alpha)
    lms = mesh.all_gather(lms)[:n_l]
    return {"device": str(mesh.device), "cams": cams.cpu().numpy(), "lms": lms.cpu().numpy(),
            "dx_norm": float(dxn), "chi2": float(chi2), "denom": float(denom)}


def run_dist_ba_step(problem, alpha: float, world: int = 1, backend: str = None, device="cuda",
                     dense: bool = False, timeout_s: float = 600.0) -> dict:
    """One landmark-sharded LM step at damping ``alpha`` on a BA problem
    (g2o text, or venice arrays unless ``dense``): the cameras, every
    landmark (gathered over the ranks), |dx|, chi2 and the gain
    denominator.  ``dense`` takes the dense per-landmark accumulator step."""
    res = run_ranks(_ba_step_rank, world, backend, device,
                    (problem, alpha, dense, backend, str(device)), timeout_s)
    return _agree(res, ("dx_norm", "chi2", "denom"))


def _ba_optimize_rank(problem, max_iterations, min_dx_norm, backend, device):
    mesh = make_mesh(device, backend, "lm")
    if isinstance(problem, str):
        system = _text_system(problem)
        solver = DistributedBigBASolver(system, mesh)
    else:
        system = None
        solver = DistributedBigBASolver.from_arrays(*problem[:6], mesh)
    chi2_0 = solver.chi2()
    applied = solver.optimize(max_iterations, min_dx_norm)
    out = {"device": str(mesh.device), "applied": applied, "chi2_init": chi2_0,
           "chi2_final": solver.chi2(), "cams": solver.shards.cam_states.cpu().numpy(),
           "lms": solver.landmarks.cpu().numpy()}
    if system is not None:
        out["system_chi2"] = float(graph_chi2(system.snapshot("cpu")))
    return out


def run_dist_ba_optimize(problem, world: int = 1, backend: str = None, device="cuda",
                         max_iterations: int = 5, min_dx_norm: float = 0.01,
                         timeout_s: float = 600.0) -> dict:
    """``DistributedBigBASolver.optimize`` on a BA problem (g2o text: each
    rank writes the states back to its GraphSystem, whose chi2 is
    ``system_chi2``; or venice arrays)."""
    res = run_ranks(_ba_optimize_rank, world, backend, device,
                    (problem, max_iterations, min_dx_norm, backend, str(device)), timeout_s)
    return _agree(res, ("applied", "chi2_final"))


# ------------------------------------------------------------------ marginals


def marginals_summary(cam_cov: np.ndarray, lm_cov: np.ndarray) -> dict:
    """What ``chip_smoke.py`` holds the marginals to: the largest entry and
    the trace sum of the camera and of the landmark blocks, the first,
    middle and last blocks, and seeded random combinations sum_k w_k
    Sigma_k of every block (sum_k |w_k| = 1, so that a block's difference
    moves its combination by at most as much)."""
    n_c, n_l = len(cam_cov), len(lm_cov)
    w_c = np.random.default_rng(0).standard_normal(n_c)
    w_l = np.random.default_rng(1).standard_normal(n_l)
    w_c, w_l = w_c / np.abs(w_c).sum(), w_l / np.abs(w_l).sum()
    return {"cam_max": float(np.abs(cam_cov).max()), "lm_max": float(np.abs(lm_cov).max()),
            "cam_trace": float(np.trace(cam_cov, axis1=1, axis2=2).sum()),
            "lm_trace": float(np.trace(lm_cov, axis1=1, axis2=2).sum()),
            "cam_blocks": {str(k): cam_cov[k].tolist() for k in (0, n_c // 2, n_c - 1)},
            "lm_blocks": {str(k): lm_cov[k].tolist() for k in (0, n_l // 2, n_l - 1)},
            "cam_mix": np.einsum("k,kij->ij", w_c, cam_cov).tolist(),
            "lm_mix": np.einsum("k,kij->ij", w_l, lm_cov).tolist()}


def _marginals_rank(problem, alpha, backend, device):
    mesh = make_mesh(device, backend, "lm")
    t0 = time.perf_counter()
    sh = _big_shards(problem, mesh)
    _sync(mesh.device)
    t_sym = time.perf_counter() - t0
    dk.reset_launches()
    t0 = time.perf_counter()
    cam_cov, lm_cov = distributed_big_ba_marginals(sh, mesh, alpha)
    lm_cov = mesh.all_gather(lm_cov)[: sh.n_l]
    _sync(mesh.device)
    out = {"device": str(mesh.device), "n_cams": sh.plan.n_c, "n_points": sh.n_l,
           "t_symbolic_s": t_sym, "t_marginals_s": time.perf_counter() - t0,
           "launches": dict(dk.launches)}
    if mesh.rank == 0:
        out["cam_cov"], out["lm_cov"] = cam_cov.cpu().numpy(), lm_cov.cpu().numpy()
    return out


def run_dist_marginals(n_cams: int = 871, n_points: int = 30_000, mean_track: int = 10,
                       world: int = 1, backend: str = None, device="cuda", alpha: float = 1e-2,
                       problem=None, timeout_s: float = 600.0) -> dict:
    """The distributed block-diagonal marginals of the seed-0 venice-class
    scene (or of ``problem``: g2o text or arrays) at damping ``alpha``:
    rank 0's camera blocks and every landmark block (gathered), with the
    set-up and marginals times."""
    if problem is None:
        problem = tuple(venice_scene(n_cams, n_points, mean_track))
    res = run_ranks(_marginals_rank, world, backend, device,
                    (problem, alpha, backend, str(device)), timeout_s)
    return _agree(res, ("n_cams", "n_points"))


# --------------------------------------------------------------- chunk batches


def random_chunks(n_chunks: int = 64, d: int = 96, seed: int = 0):
    """``n_chunks`` SPD chunk systems of size ``d`` with a random interior
    (a multiple of 3 scalars) and their NumPy sequential eliminations
    (contrib_sc, contrib_rhs, n_interior), as the windowed / FastL freeze
    records cache them."""
    rng = np.random.default_rng(seed)
    chunks, refs = [], []
    for _ in range(n_chunks):
        nint = int(rng.integers(d // 6, d // 3 - 1)) * 3
        A = rng.normal(size=(d, d))
        H = A @ A.T + d * np.eye(d)
        g = rng.normal(size=d)
        chunks.append((H, g, nint))
        L = np.linalg.cholesky(H[:nint, :nint] + 1e-12 * np.eye(nint))
        WU = np.linalg.solve(L, H[:nint, nint:])
        y = np.linalg.solve(L, g[:nint])
        refs.append((H[nint:, nint:] - WU.T @ WU, g[nint:] - WU.T @ y, nint))
    return chunks, refs


def _chunks_rank(Hs, gs, nis, backend, device):
    mesh = make_mesh(device, backend, "chunks")
    out = eliminate_chunks_mesh(Hs, gs, nis, mesh)
    return {"device": str(mesh.device), "out": out if mesh.rank == 0 else None}


def run_dist_chunks(n_chunks: int = 64, d: int = 96, world: int = 1, backend: str = None,
                    device="cuda", seed: int = 0, timeout_s: float = 600.0) -> dict:
    """``eliminate_chunks_mesh`` on ``random_chunks`` packed by
    ``pack_chunks``: the largest difference of each chunk's Schur
    complement and reduced right-hand side from the NumPy sequential
    elimination, over the largest entry."""
    chunks, refs = random_chunks(n_chunks, d, seed)
    Hs, gs, nis, D = pack_chunks(chunks)
    t0 = time.perf_counter()
    res = run_ranks(_chunks_rank, world, backend, device, (Hs, gs, nis, backend, str(device)),
                    timeout_s)
    t = time.perf_counter() - t0
    _, _, _, sc, rhs = res[0]["out"]
    err_sc = err_rhs = 0.0
    for k, (sc_ref, rhs_ref, nint) in enumerate(refs):
        b = slice(nint, nint + len(rhs_ref))
        err_sc = max(err_sc, np.abs(sc[k, b, b] - sc_ref).max() / np.abs(sc_ref).max())
        err_rhs = max(err_rhs, np.abs(rhs[k, b] - rhs_ref).max() / np.abs(rhs_ref).max())
    return {"n_chunks": n_chunks, "D": D, "world": world, "rank_devices":
            [r["device"] for r in res], "err_sc": float(err_sc), "err_rhs": float(err_rhs),
            "finite": bool(np.isfinite(sc).all() and np.isfinite(rhs).all()), "t_s": t}


if __name__ == "__main__":
    values = {_option(k) for k in ("--poses", "--cams", "--points", "--track", "--chunks",
                                   "--world", "--backend")}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    what = args[0] if args else "venice"
    dev = args[1] if len(args) > 1 else "cuda"
    world, be = int(_option("--world") or 1), _option("--backend")
    if what == "gn":
        res = run_dist_gn(int(_option("--poses") or 3500), world, be, dev)
        res.pop("states")
    elif what == "venice":
        res = run_dist_venice(int(_option("--cams") or 871), int(_option("--points") or 110_000),
                              int(_option("--track") or 10), world, be, dev)
    elif what == "marginals":
        res = run_dist_marginals(int(_option("--cams") or 871),
                                 int(_option("--points") or 30_000),
                                 int(_option("--track") or 10), world, be, dev)
        res.update(marginals_summary(res.pop("cam_cov"), res.pop("lm_cov")))
    elif what == "chunks":
        res = run_dist_chunks(int(_option("--chunks") or 64), world=world, backend=be, device=dev)
    else:
        raise ValueError(f"unknown run {what!r}: gn, venice, marginals or chunks")
    print(json.dumps(res))
