"""FastL's host model kernels: the NumPy copy (models/np_kernels.py) against
the torch types' own kernels (models/se2.py) on CPU tensors.

FastL linearizes, retracts and takes local differences on the host at every
step.  This script runs ``apps.incremental.run_incremental(n, "cpu",
"fastl")`` with FastL's three kernel hooks first as shipped (NumPy), then
pointed at the torch kernels (``torch.from_numpy``, no copy), in the order
numpy, torch, torch, numpy, and prints one JSON line per run: solves/s,
streamed chi2, chunk relinearizations and the host phases the kernels sit in.

    OPENBLAS_NUM_THREADS=1 OMP_NUM_THREADS=1 python scripts/fastl_kernels_ab.py [n_poses]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slampp_tpu_torch.apps.incremental import run_incremental  # noqa: E402
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type  # noqa: E402
from slampp_tpu_torch.solvers.fastl import FastLSolver  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch_edge_lin(self, tname):
    fn = get_edge_type(tname).jacobian_fn

    def lin(slot_states, meas):
        r, jacs = fn(tuple(_t(s) for s in slot_states), _t(meas))
        return r.numpy(), tuple(j.numpy() for j in jacs)
    return lin


def _torch_retract(self, tname):
    fn = get_vertex_type(tname).retract
    return lambda x, d: fn(_t(x), _t(d)).numpy()


def _torch_ldiff(self, tname):
    fn = get_vertex_type(tname).local_diff or (lambda a, b: a - b)
    return lambda a, b: fn(_t(a), _t(b)).numpy()


NUMPY = (FastLSolver._edge_lin_fn, FastLSolver._retract_fn, FastLSolver._ldiff_fn)
TORCH = (_torch_edge_lin, _torch_retract, _torch_ldiff)
PHASES = ("ingest", "apply", "relinearize_edges", "relinearize", "rebuild")


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    torch.set_num_threads(1)
    for name in ("numpy", "torch", "torch", "numpy"):
        hooks = NUMPY if name == "numpy" else TORCH
        FastLSolver._edge_lin_fn, FastLSolver._retract_fn, FastLSolver._ldiff_fn = hooks
        res = run_incremental(n, "cpu", "fastl", optimize=False)
        print(json.dumps({
            "kernels": name, "n_poses": n, "solves": res["solves"],
            "t_stream_s": res["t_stream_s"], "solves_per_sec": res["solves_per_sec"],
            "chi2_stream": res["chi2_stream"], "n_relin": res["counters"]["n_relin"],
            "phases_s": {k: res["phases"][k]["s"] for k in PHASES if k in res["phases"]},
        }), flush=True)
    FastLSolver._edge_lin_fn, FastLSolver._retract_fn, FastLSolver._ldiff_fn = NUMPY


if __name__ == "__main__":
    main()
