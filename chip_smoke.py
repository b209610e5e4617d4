#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (slampp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its result and time; any failure ends
the run with a non-zero exit code and no result line:

  1. device   a CUDA card must be present (no CPU continuation);
  2. build    the hand-written kernels from slampp_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in float32 and float64, timed against
              the plain version with CUDA events;
  4. main     manhattan3500, mixed precision, chain mode, target 64,
              refine 0, 5 fused GN iterations; chi2 within 5e-3 of the f64
              oracle 404.504, every kernel launched by that run;
  5. dense    the same graph through the dense-frame branch (ch_ok=0);
  6. exact    manhattan500 in float64 end to end; chi2 within 1e-6 of 26.095453.

Then the kernel summary (JSON), the card's name and power limit, and the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# f64 chi2 oracles of the seed-0 Manhattan graphs after 5 GN iterations
# (bench.py _MANHATTAN_F64_CHI2, scripts/tpu_smoke.py)
CHI2_3500, TOL_3500 = 404.504, 5e-3
CHI2_500, TOL_500 = 26.095453, 1e-6
# kernel-against-plain tolerances: f64 max |kernel - plain| over max |plain|;
# f32 relative residual (|L L^T - A| over |A|, |L X - B| over |B|), since the
# kernels round in another order than the panel-blocked plain versions
TOL_F64 = 1e-10
TOL_F32 = 1e-4

SOURCE = "slampp_tpu_torch/csrc/dense_kernels.cu"
REPLACES = {
    "chol_batched": "slampp_tpu/ops/dense_kernels.py:184",
    "trsm_lower_batched": "slampp_tpu/ops/dense_kernels.py:215",
    "trsm_lower_t_batched": "slampp_tpu/ops/dense_kernels.py:236",
}


class Failure(Exception):
    pass


def _line(phase: str, ok: bool, t: float, **info) -> None:
    print(f"[{phase}] {'ok' if ok else 'FAIL'} {t:.3f}s " + json.dumps(info), flush=True)
    if not ok:
        raise Failure(phase)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_kernels(dev):
    """Phase 3: every kernel against its plain version at the path's shapes.
    Returns {kernel: (max_abs_err, ms, plain_ms)} with the times at the main
    path's own shape (the float32 separator)."""
    import numpy as np
    import torch

    from slampp_tpu_torch.ops import dense_kernels as dk

    rng = np.random.default_rng(0)

    def spd(K, M, zero_rows=()):
        G = rng.normal(size=(K, M, M))
        G[:, list(zero_rows), :] = 0.0
        A = G @ np.swapaxes(G, 1, 2)
        keep = np.setdiff1d(np.arange(M), zero_rows)
        A[:, keep, keep] += M
        return A

    cases = [  # (kernel, K, M, S, frozen pivots)
        ("chol_batched", 55, 192, None, ()),
        ("chol_batched", 1, 488, None, ()),
        ("chol_batched", 1, 488, None, (5, 200, 487)),
        ("trsm_lower_batched", 55, 192, 48, ()),
        ("trsm_lower_batched", 1, 488, 8, ()),
        ("trsm_lower_t_batched", 55, 192, 8, ()),
        ("trsm_lower_t_batched", 1, 488, 8, ()),
    ]
    main_shape = {"chol_batched": (1, 488), "trsm_lower_batched": (1, 488),
                  "trsm_lower_t_batched": (1, 488)}
    plain = {"chol_batched": dk.chol_batched_plain,
             "trsm_lower_batched": dk.trsm_lower_batched_plain,
             "trsm_lower_t_batched": dk.trsm_lower_t_batched_plain}
    summary = {k: [0.0, None, None] for k in plain}
    for name, K, M, S, zero_rows in cases:
        A64 = spd(K, M, zero_rows)
        B64 = rng.normal(size=(K, M, S)) if S else None
        for dtype in (torch.float32, torch.float64):
            t0 = time.perf_counter()
            A = torch.from_numpy(A64).to(dev, dtype)
            if name == "chol_batched":
                args = (A,)
            else:
                args = (dk.chol_batched_plain(A), torch.from_numpy(B64).to(dev, dtype))
            kern = getattr(dk, name)
            out = kern(*args)
            ref = plain[name](*args)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(out).all())
            err = float((out - ref).abs().max())
            keep = [i for i in range(M) if i not in zero_rows]
            # scale of the entries without frozen pivots (those are 1e10)
            scale = float((ref[:, keep][:, :, keep] if S is None else ref).abs().max())
            if dtype == torch.float64:
                rel, tol = err / scale, TOL_F64
            elif name == "chol_batched":
                LLt = (out @ out.transpose(1, 2))[:, keep][:, :, keep]
                Ak = A[:, keep][:, :, keep]
                rel, tol = float((LLt - Ak).abs().max() / Ak.abs().max()), TOL_F32
            else:
                L, B = args
                Lop = L if name == "trsm_lower_batched" else L.transpose(1, 2)
                rel, tol = float((Lop @ out - B).abs().max() / B.abs().max()), TOL_F32
            info = {"kernel": name, "shape": [K, M, S] if S else [K, M, M],
                    "dtype": str(dtype).split(".")[1], "frozen": list(zero_rows),
                    "max_abs_err": err, "rel_err": rel, "tol": tol}
            if dtype == torch.float32 and not zero_rows:
                info["ms"] = _time_ms(lambda: kern(*args))
                info["plain_ms"] = _time_ms(lambda: plain[name](*args))
                if (K, M) == main_shape[name]:
                    summary[name][1:] = [info["ms"], info["plain_ms"]]
            if not zero_rows:
                summary[name][0] = max(summary[name][0], err)
            _line("kernels", finite and rel <= tol, time.perf_counter() - t0, **info)
    return summary


def _run_path(phase, run, dev, n_poses, expected, tol, **kw):
    import torch

    t0 = time.perf_counter()
    res = run(n_poses, dev, **kw)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    finite = all(bool(torch.isfinite(s).all()) for s in states.values())
    shape_ok = states["pose2d"].shape == (n_poses, 3)
    _line(phase, rel < tol and finite and shape_ok, time.perf_counter() - t0,
          expected=expected, rel_err=rel, tol=tol, **res)
    return res


def main() -> int:
    if not (ROOT / SOURCE).exists():
        print("FAIL: chip_smoke.py must run from a checkout of the repository", flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    dev = torch.device("cuda")
    smi = _smi()
    _line("device", True, time.perf_counter() - t0, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build
    from slampp_tpu_torch.ops import _cuda, dense_kernels as dk

    t0 = time.perf_counter()
    _cuda.load()
    regs = [ln.strip() for ln in _cuda.build_info["log"].splitlines() if "registers" in ln]
    _line("build", True, time.perf_counter() - t0, nvcc_s=_cuda.build_info["seconds"],
          library=_cuda.build_info["path"], ptxas=regs)

    # 3. kernels against their plain versions
    summary = _check_kernels(dev)

    from slampp_tpu_torch.apps import manhattan

    # 4. main path: launch counts read from this run only
    dk.reset_launches()
    main = _run_path("main", manhattan.run, dev, 3500, CHI2_3500, TOL_3500)
    launches = dict(dk.launches)
    _line("launches", all(v > 0 for v in launches.values()), 0.0, **launches)

    # 5. dense frames on the same graph: (55, 192, 192) part frames + separator
    dense = _run_path("dense", manhattan.run, dev, 3500, CHI2_3500, TOL_3500, dense_frames=True,
                      n_rep=2)
    calls = dense["n_iters"] * (1 + dense["n_rep"])
    _line("dense-launches",
          dense["plan"]["K"] == 55 and dense["launches"]["chol_batched"] == 2 * calls, 0.0,
          plan=dense["plan"], launches=dense["launches"])

    # 6. exact float64 mode
    _run_path("exact", manhattan.run, dev, 500, CHI2_500, TOL_500, mixed_precision=False, n_rep=2)

    print(json.dumps({"main_path": {
        "metric": "manhattan3500_gn_iters_per_sec", "value": main["iters_per_sec"],
        "chi2_final": main["chi2_final"], "chi2_ok": True, "card": smi}}))
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": v[0], "ms": v[1], "plain_ms": v[2]}
        for k, v in summary.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: phase {exc} failed", file=sys.stderr)
        sys.exit(1)
