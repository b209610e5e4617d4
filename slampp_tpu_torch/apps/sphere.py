"""The SE(3) sphere pose graph (sphere2500-like, ``io/datasets.make_sphere``)
through the port's engines: the v3 ``optimize_fused`` path, the batch
solvers as the JAX package's CLI builds them (optionally robustified, as
its ``--robust``), and the native sparse engines.  The functions are
``apps/manhattan.py``'s, given ``build``, the sphere graph's constructor.

    python -m slampp_tpu_torch.apps.sphere [n_poses] [device] [--rings R] [--exact] [--profile]
    python -m slampp_tpu_torch.apps.sphere [n_poses] [device] --solver lambda|lambda-lm|lambda-dl [--engine v3] [--robust LOSS [--on-chi2]] [--landmarks]
    python -m slampp_tpu_torch.apps.sphere [n_poses] [device] --native v1|v2 [--panel P] [--fused]

print ``run`` (``--exact``: the v3 engine in float64; ``--profile``: one
warm call's layer and kernel breakdown), ``run_solver`` or ``run_native``'s
result as one JSON object.  ``R`` defaults to one ring per 50 poses (50 at
2500 poses, the generator's default); ``--landmarks`` adds
``make_sphere_landmarks``' XYZ landmarks (its defaults: 80 points, at most
3 observations a pose).  The device defaults to ``cuda``; name ``cpu`` to
run on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import functools
import json
import sys

import torch

from slampp_tpu_torch.apps import manhattan
from slampp_tpu_torch.io.datasets import sphere_text
from slampp_tpu_torch.io.parser import build_system, g2o_file, parse_file


def sphere_system(n_poses: int, n_rings=None, seed: int = 0, landmarks: bool = False):
    """The sphere graph (``io/datasets.sphere_text``), through the g2o text
    and the parser."""
    with g2o_file(sphere_text(n_poses, n_rings, seed, landmarks)) as path:
        return build_system(parse_file(path))


def _build(n_rings, landmarks: bool = False):
    return functools.partial(sphere_system, n_rings=n_rings, landmarks=landmarks)


def run(n_poses: int, device, n_rings=None, **kw) -> dict:
    """``manhattan.run`` (v3 ``optimize_fused``) on the sphere graph."""
    return manhattan.run(n_poses, device, build=_build(n_rings), **kw)


def profile(n_poses: int, device, n_rings=None, **kw) -> dict:
    """``manhattan.profile`` (one warm ``optimize_fused`` under the profiler)
    on the sphere graph."""
    return manhattan.profile(n_poses, device, build=_build(n_rings), **kw)


def run_solver(n_poses: int, device, nls: str, engine=None, robust=None, n_rings=None,
               landmarks: bool = False, **kw) -> dict:
    """``manhattan.run_solver`` (one batch-solver ``optimize``, ``robust`` =
    (loss, on_chi2) or None) on the sphere graph."""
    return manhattan.run_solver(n_poses, device, nls, engine, build=_build(n_rings, landmarks),
                                robust=robust, **kw)


def run_native(n_poses: int, device, engine: str = "v2", n_rings=None, **kw) -> dict:
    """``manhattan.run_native`` (chained native GN iterations, v2 optionally
    as the CUDA graph) on the sphere graph."""
    return manhattan.run_native(n_poses, device, engine, build=_build(n_rings), **kw)


if __name__ == "__main__":
    opt = manhattan._option
    solver_kind, engine_kind, robust_loss = opt("--solver"), opt("--engine"), opt("--robust")
    native_kind, panel_size, rings = opt("--native"), opt("--panel"), opt("--rings")
    values = {solver_kind, engine_kind, robust_loss, native_kind, panel_size, rings}
    args = [a for a in sys.argv[1:] if not a.startswith("--") and a not in values]
    n = int(args[0]) if args else 2500
    dev = args[1] if len(args) > 1 else "cuda"
    if dev != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {dev!r}; name 'cpu' to run on the CPU")
    rings = int(rings) if rings else None
    if native_kind is not None:
        res = run_native(n, dev, native_kind, n_rings=rings, panel=int(panel_size or 1),
                         fused="--fused" in sys.argv)
    elif solver_kind is not None:
        robust = (robust_loss, "--on-chi2" in sys.argv) if robust_loss else None
        res = run_solver(n, dev, solver_kind, engine_kind, robust, rings,
                         landmarks="--landmarks" in sys.argv)
    elif "--profile" in sys.argv:
        res = profile(n, dev, rings, mixed_precision="--exact" not in sys.argv)
    else:
        res = run(n, dev, rings, mixed_precision="--exact" not in sys.argv)
    res.pop("states", None)
    print(json.dumps(res))
