"""Entry points of the port beside the JAX package's ``__graft_entry__.py``:
one dense GN step on a 64-pose graph, and the multi-rank dry run.

``entry()`` returns ``(fn, args)``: one Gauss-Newton iteration (dense
assembly, Cholesky, retraction) on an SE(2) pose graph.
``dryrun_multichip(n)`` runs the whole distributed suite at tiny shapes on
``n`` ranks (``parallel.distributed.run_ranks``): (a) pose-graph GN with
the edges sharded, (b) bundle adjustment with landmarks and observations
sharded (the dense step), (c) the venice-class observation-driven step,
(d) the distributed marginals; it raises unless every result is finite.

    python -m slampp_tpu_torch.graft_entry [--world N] [--backend gloo] [--device cpu]

runs both on the card (NCCL, one rank per card, unless a backend is named).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.io.datasets import make_ba_scene, make_manhattan
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file
from slampp_tpu_torch.linear.dense import solve_dense
from slampp_tpu_torch.parallel.distributed import (
    distributed_gn_step,
    make_mesh,
    run_ranks,
    shard_graph_edges,
)
from slampp_tpu_torch.parallel.distributed_ba import (
    build_ba_shards,
    build_big_ba_shards,
    distributed_ba_lm_step,
    distributed_big_ba_marginals,
    distributed_big_ba_step,
)
from slampp_tpu_torch.utils.device import require_device


def _system(text: str):
    with g2o_file(text) as path:
        return build_system(parse_file(path))


def _tiny_system(n_poses: int = 64, seed: int = 0):
    return _system(make_manhattan(n_poses=n_poses, loop_prob=0.5, loop_separation=8,
                                  loop_radius=4.0, seed=seed)[0])


def _gn_step(graph):
    H, g, chi2 = assembly.assemble_dense(graph)
    return assembly.apply_update(graph, solve_dense(H, g)), chi2


def entry(device="cuda"):
    """(fn, example_args): one GN iteration on the 64-pose graph."""
    device = torch.device(device)
    require_device(device, "entry")
    return _gn_step, (_tiny_system().snapshot(device),)


def _dryrun_rank(backend, device):
    mesh = make_mesh(device, backend, "edges")
    out = {"device": str(mesh.device)}
    # (a) pose graph: the edges sharded, the system all-reduced
    graph = shard_graph_edges(_tiny_system().snapshot("cpu"), mesh)
    out["gn_dx_norm"] = float(distributed_gn_step(graph, mesh)[1])
    # (b) BA: landmarks and their observations sharded, the dense step
    ba = _system(make_ba_scene(n_cams=4, n_points=4 * max(mesh.world, 2), obs_per_point=3,
                               seed=0)[0])
    out["ba_dx_norm"] = float(distributed_ba_lm_step(build_ba_shards(ba, mesh), mesh, 1e-3)[2])
    # (c) venice class: observation-driven, no dense Hessian anywhere
    big = build_big_ba_shards(ba, mesh)
    out["big_ba_dx_norm"] = float(distributed_big_ba_step(big, mesh, 1e-3)[2])
    # (d) marginals: camera blocks replicated, landmark blocks rank-local
    cam_cov, lm_cov = distributed_big_ba_marginals(big, mesh, alpha=1e-3)
    out["marginals_finite"] = bool(torch.isfinite(cam_cov).all() and torch.isfinite(lm_cov).all())
    return out


def dryrun_multichip(n_devices: int, backend: str = None, device="cuda",
                     timeout_s: float = 600.0) -> list:
    """The distributed suite (a)-(d) at tiny shapes on ``n_devices`` ranks;
    returns every rank's results and raises RuntimeError if one is not
    finite."""
    res = run_ranks(_dryrun_rank, n_devices, backend, device, (backend, str(device)), timeout_s)
    for r, out in enumerate(res):
        bad = [k for k, v in out.items() if k != "device" and not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"dryrun_multichip: rank {r} gave non-finite {bad}: {out}")
    return res


if __name__ == "__main__":
    def _opt(name, default):
        argv = sys.argv[1:]
        return argv[argv.index(name) + 1] if name in argv else default

    dev = _opt("--device", "cuda")
    fn, args = entry(dev)
    states, chi2 = fn(*args)
    print(f"entry() ok: chi2 {float(chi2):.6f}")
    n = int(_opt("--world", torch.cuda.device_count() if dev != "cpu" else 2))
    dryrun_multichip(n, _opt("--backend", None), dev)
    print(f"dryrun_multichip({n}) ok")
