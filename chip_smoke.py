#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (slampp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its result and time; any failure ends
the run with a non-zero exit code and no result line:

  1. device   a CUDA card must be present (no CPU continuation);
  2. build    the hand-written kernels from slampp_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in float32 and float64, with frozen
              pivots; the Cholesky also at the exact mode's f64 shapes and
              the first M on each side of its resident / streaming
              boundary, the TRSMs at an M beyond the resident slab size
              and one at which each x_p is pulled, not pushed; timed
              against the plain version and the library call
              (torch.linalg.cholesky_ex for the Cholesky; the TRSMs' plain
              version is torch.linalg.solve_triangular) with CUDA events
              around 20 calls (ms, host launch path included) and as device
              time per launch from torch.profiler (device_ms), beside the
              bound (bound_ms: the card's least time for the call's bytes
              or FLOPs at its peak rates);
  4. main     manhattan3500, mixed precision, chain mode, target 64,
              refine 0, 5 fused GN iterations; chi2 within 5e-3 of the f64
              oracle 404.504, every kernel launched by that run;
  5. dense    the same graph through the dense-frame branch (ch_ok=0);
  6. exact    manhattan500 in float64 end to end; chi2 within 1e-6 of 26.095453;
  7-11.       the batch solvers on manhattan3500 as the JAX package's CLI
              builds them, one optimize with its defaults (5 iterations, min
              |dx| 0.01; apps/manhattan.run_solver): gn (GaussNewtonSolver,
              native v1 engine, f64), lm and dl (LevenbergMarquardtSolver /
              DoglegSolver, dense f64, H 10500 x 10500), lm-v3 and dl-v3 (the
              partitioned engine, mixed, refine_iters=2).  chi2 against the
              JAX package's (JAX_REF): f64 within 1e-6 with the same
              iterations applied, mixed within 5e-3.  The v3 phases must
              launch all three kernels, the native and dense ones none;
  12. prior   one PartitionedSolver.gn_step_prior (mixed, refine 2, 14
              scattered vertices forced into the separator, a seeded SPD
              prior) against the dense f64 solve of (H + P) dx = -(g + p) on
              the card (apps/manhattan.run_prior): relative residual within
              1e-5, |dx| within 1e-4; all three kernels launched.
Each phase's launches are counted from zero over that phase alone.  The
whole script takes about two and a half minutes on an H100, the kernels'
build included.

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
# (chi2 after optimize, iterations applied) of the JAX package's batch
# solvers on the seed-0 manhattan3500 graph, run on the CPU with the port's
# chain-mode configuration (SLAMPP_CHAIN_SEP_XLA=0) by
#   python tests/_torch_jax_util.py 3500
JAX_REF = {
    "gn": (404.5038446353009, 5),
    "lm": (6933.51111952435, 5),
    "lm-v3": (6933.505879193458, 5),
    "dl": (377994.0042546363, 5),
    "dl-v3": (24395.493175597476, 5),
}
SOLVER_PHASES = (("gn", "lambda", None), ("lm", "lambda-lm", None), ("lm-v3", "lambda-lm", "v3"),
                 ("dl", "lambda-dl", None), ("dl-v3", "lambda-dl", "v3"))
TOL_SOLVER_F64 = 1e-6
# prior step against its dense f64 oracle: the relative residual of its dx in
# (H + P) dx = -(g + p), the mixed-mode bound of tests/test_torch_partitioned.py
# (raw dx is not compared: the mixed solve leaves the near-null gauge
# direction inexact), and |dx| relative
TOL_PRIOR_RES, TOL_PRIOR_DX = 1e-5, 1e-4
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


def _device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the summed duration of the device
    events (kernels, copies) that ``reps`` calls leave in a torch.profiler
    trace, over ``reps``.  Unlike CUDA events around the calls, it leaves out
    the host's time between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without its device events: take another
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1000.0 / reps
    raise RuntimeError("the profiler recorded no device time")


# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM
# bytes/s, and the card's FLOP/s for each dtype: float32 outside the tensor
# cores, float64 on its tensor cores (FP64 Tensor Core, 67 TFLOP/s; 34
# outside them), whether or not the kernel uses them
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def _bound(name, K, M, S, dtype):
    """Least time (ms) the card could take for one call, and what bounds it:
    the larger of the bytes (the lower triangle read once, B read once, the
    output written once) over the memory rate and the FLOPs (Cholesky M^3/3,
    triangular solve M^2 S per matrix) over the peak rate of the dtype."""
    size = 4 if dtype == "float32" else 8
    tri = M * (M + 1) // 2
    if name == "chol_batched":
        flops, nbytes = K * M ** 3 / 3, K * (tri + M * M) * size
    else:
        flops, nbytes = K * M * M * S, K * (tri + 2 * M * S) * size
    t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def _check_kernels(dev):
    """Phase 3: every kernel against its plain version at the path's shapes.
    Returns {kernel: {...}}: the largest |kernel - plain| over the unfrozen
    cases, and the times and bound at the main path's own shape (the float32
    separator)."""
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

    f32, f64 = torch.float32, torch.float64
    both, timed32, timed64 = (f32, f64), {f32}, {f64}
    res32, res64 = dk.chol_resident_max_m(f32), dk.chol_resident_max_m(f64)
    cases = [  # (kernel, K, M, S, frozen pivots, dtypes, timed dtypes).
        # Cholesky: the dense frames' part blocks (resident in shared
        # memory), the separator (streamed), the exact mode's f64 shapes and
        # the first M on each side of the resident / streaming boundary.
        # TRSMs: M = 1096 is beyond their resident slab size in both
        # precisions, and at M = 3104 the f64 solve pulls each x_p
        ("chol_batched", 55, 192, None, (), both, timed32),
        ("chol_batched", 55, 192, None, (5, 100, 191), both, ()),
        ("chol_batched", 1, 488, None, (), both, both),
        ("chol_batched", 1, 488, None, (5, 200, 487), both, ()),
        ("chol_batched", 8, 192, None, (), (f64,), timed64),
        ("chol_batched", 1, 48, None, (), (f64,), timed64),
        ("chol_batched", 2, res32, None, (), (f32,), ()),
        ("chol_batched", 2, res32 + 8, None, (), (f32,), ()),
        ("chol_batched", 2, res64, None, (), (f64,), ()),
        ("chol_batched", 2, res64 + 8, None, (), (f64,), ()),
        ("trsm_lower_batched", 55, 192, 48, (), both, timed32),
        ("trsm_lower_batched", 55, 192, 8, (), both, timed32),
        ("trsm_lower_batched", 1, 488, 8, (), both, timed32),
        ("trsm_lower_batched", 1, 488, 8, (5, 200, 487), both, ()),
        ("trsm_lower_batched", 1, 1096, 8, (), both, ()),
        ("trsm_lower_batched", 1, 3104, 8, (), both, ()),
        ("trsm_lower_t_batched", 55, 192, 8, (), both, timed32),
        ("trsm_lower_t_batched", 1, 488, 8, (), both, timed32),
        ("trsm_lower_t_batched", 1, 488, 8, (5, 200, 487), both, ()),
        ("trsm_lower_t_batched", 1, 1096, 8, (), both, ()),
        ("trsm_lower_t_batched", 1, 3104, 8, (), both, ()),
        # the exact f64 mode's TRSMs (manhattan500: K=8, M=192, S+1 padded
        # to 24; separator Ms=48)
        ("trsm_lower_batched", 8, 192, 24, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 48, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 8, 192, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 48, 8, (), (f64,), timed64),
    ]
    main_shape = (1, 488, f32)
    plain = {"chol_batched": dk.chol_batched_plain,
             "trsm_lower_batched": dk.trsm_lower_batched_plain,
             "trsm_lower_t_batched": dk.trsm_lower_t_batched_plain}
    summary = {k: {"max_abs_err": 0.0} for k in plain}
    for name, K, M, S, zero_rows, dtypes, timed in cases:
        A64 = spd(K, M, zero_rows)
        B64 = rng.normal(size=(K, M, S)) if S else None
        for dtype in dtypes:
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
            dt = str(dtype).split(".")[1]
            info = {"kernel": name, "shape": [K, M, S] if S else [K, M, M], "dtype": dt,
                    "frozen": list(zero_rows), "max_abs_err": err, "rel_err": rel, "tol": tol}
            if name == "chol_batched":
                info["resident"] = M <= (res32 if dtype == f32 else res64)
            if dtype in timed:
                info["ms"] = _time_ms(lambda: kern(*args))
                info["plain_ms"] = _time_ms(lambda: plain[name](*args))
                info["device_ms"] = _device_ms(lambda: kern(*args))
                # the plain Cholesky is thousands of small launches a call
                info["plain_device_ms"] = _device_ms(
                    lambda: plain[name](*args), reps=2 if name == "chol_batched" else 20,
                    warmup=1)
                if name == "chol_batched":  # cuSOLVER's: a yardstick, never called by the port
                    info["library_ms"] = _time_ms(lambda: torch.linalg.cholesky_ex(A))
                    info["library_device_ms"] = _device_ms(lambda: torch.linalg.cholesky_ex(A))
                else:  # the plain TRSM is the library call, torch.linalg.solve_triangular
                    info["library_ms"] = info["plain_ms"]
                    info["library_device_ms"] = info["plain_device_ms"]
                info["bound_ms"], info["bound_by"] = _bound(name, K, M, S, dt)
                if (K, M, dtype) == main_shape:
                    summary[name].update({k: info[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                        "plain_device_ms", "library_device_ms")})
            if not zero_rows:
                summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
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


def _solver_phase(phase, nls, engine, dev):
    """One batch solver on manhattan3500 against the JAX package's result;
    its kernel launches counted from zero."""
    import torch

    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    expected, applied_ref = JAX_REF[phase]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_solver(3500, dev, nls, engine)
    launches = dict(dk.launches)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    exact = engine is None
    tol = TOL_SOLVER_F64 if exact else TOL_3500
    finite = all(bool(torch.isfinite(s).all()) for s in states.values())
    ok = rel <= tol and finite and states["pose2d"].shape == (3500, 3)
    if exact:
        ok = ok and res["applied"] == applied_ref and not any(launches.values())
    else:
        ok = ok and all(v > 0 for v in launches.values())
    iters = res["iterations"]
    _line(phase, ok, time.perf_counter() - t0, expected=expected, applied_ref=applied_ref,
          rel_err=rel, tol=tol, launches_per_iter={k: v / iters for k, v in launches.items()},
          **res)
    return {k: v / iters for k, v in launches.items()}


def _prior_phase(dev):
    import torch

    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_prior(3500, dev)
    launches = dict(dk.launches)
    states = res.pop("states")
    dx_rel = abs(res["dx_norm"] - res["dx_norm_ref"]) / res["dx_norm_ref"]
    ok = (res["residual"] <= TOL_PRIOR_RES and dx_rel <= TOL_PRIOR_DX
          and abs(res["chi2"] - res["chi2_ref"]) <= 1e-9 * res["chi2_ref"]
          and all(bool(torch.isfinite(s).all()) for s in states.values())
          and all(v > 0 for v in launches.values()))
    _line("prior", ok, time.perf_counter() - t0, dx_rel_err=dx_rel,
          tol_residual=TOL_PRIOR_RES, tol_dx=TOL_PRIOR_DX, **res)
    return launches


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

    # 7-12. the batch solvers and the prior step, launches per iteration
    iters = main["n_iters"] * (1 + main["n_rep"])  # GN iterations in the main phase
    per_iter = {"main": {k: v / iters for k, v in launches.items()}}
    for phase, nls, engine in SOLVER_PHASES:
        per_iter[phase] = _solver_phase(phase, nls, engine, dev)
    per_iter["prior"] = _prior_phase(dev)

    print(json.dumps({"main_path": {
        "metric": "manhattan3500_gn_iters_per_sec", "value": main["iters_per_sec"],
        "chi2_final": main["chi2_final"], "chi2_ok": True, "card": smi}}))
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "launches_per_iter": launches[k] / iters,
         "launches_per_iter_by_phase": {ph: d[k] for ph, d in per_iter.items()}, **v}
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
