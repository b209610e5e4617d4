"""The triangular-solve kernels' three forms side by side on one CUDA card.

    python scripts/trsm_forms_ab.py [--quick] [--before PATH] [--out PATH]

Builds, beside this tree's kernels, one variant of
``slampp_tpu_torch/csrc/dense_kernels.cu`` per TRSM form whose plan_trsm
always takes that form ("cluster", "separator", "columns"), and with
``--before PATH`` another revision's source (e.g. ``git show
<rev>:slampp_tpu_torch/csrc/dense_kernels.cu`` written under ``_chip/``
beforehand, as the card's machine has no git; a revision whose TRSM entry
points take no workspace), all nvcc runs in parallel into ``_chip/``.  Then,
on seeded Cholesky factors made on the card (float64, then cast):

  1. every form that has a plan at a shape against the plain version, both
     directions, both dtypes, frozen pivots and partial last panels
     included: f64 max |kernel - plain| / max |plain| within 1e-10, f32
     relative residual max |L X - B| / max |B| within 1e-4;
  2. (unless ``--quick``) device ms (torch.profiler, as chip_smoke.py) of
     every form that fits, beside ``torch.linalg.solve_triangular``'s, over
     the paths' shapes and the grid around them: where plan_trsm's
     crossovers (``separator_from``, ``columns_first``) come from;
  3. with ``--before``: both TRSMs of that revision and of this tree at the
     paths' shapes, in turns (before, this tree, this tree, before), with
     this tree's form on each line.

Prints one JSON object per line (and writes them to ``--out``, default
``chiprun_out/trsm_forms_ab.jsonl``), then the card's name and power limit.
Exits non-zero if a check fails.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from slampp_tpu_torch.ops import _cuda, dense_kernels as dk  # noqa: E402

F32, F64 = torch.float32, torch.float64
OUT = ROOT / "_chip"
PLAN_OPENING = ("int plan_trsm(int K, int M, int S, TrsmLaunch* out) {\n  int optin = 0;\n"
                "  if (int err = optin_smem(&optin)) return err;\n")
NO_PLAN = 1  # cudaErrorInvalidValue: the form has no plan at the shape

# (K, M, S, frozen rows): partial last panels (M % 32 != 0), S not a
# multiple of 8 or of 32, frozen pivots in a small and a large M
CHECKS = [(1, 488, 8, ()), (3, 40, 13, ()), (2, 200, 43, ()), (1, 1096, 8, ()),
          (2, 1000, 8, ()), (1, 488, 8, (5, 200, 487)), (1, 3952, 8, (7, 2000, 3951)),
          (40, 320, 176, ()), (11, 200, 960, ()), (1, 5344, 8, ()), (2, 5344, 8, ()),
          (1, 12296, 8, ()), (55, 192, 48, ()), (157, 192, 8, ())]

# (K, M, S, directions) timed in both dtypes
GRID = ([(1, M, 8, (False, True)) for M in (384, 488, 584, 768, 928, 1096, 1472, 2048, 3104,
                                              3952, 4968, 5344)]
        + [(2, M, 8, (False, True)) for M in (488, 1096, 3952)]
        + [(K, M, 8, (False, True)) for K, M in ((6, 96), (8, 192), (13, 192), (55, 192),
                                                 (157, 192), (11, 200), (12, 232), (17, 320),
                                                 (40, 320))]
        + [(K, M, S, (False,)) for K, M, S in ((6, 96, 24), (8, 192, 24), (13, 192, 32),
                                               (55, 192, 16), (55, 192, 48), (1, 488, 48),
                                               (17, 320, 152), (40, 320, 176), (157, 192, 408),
                                               (11, 200, 960), (12, 232, 832))]
        + [(40, 320, 176, (True,))])

# (K, M, S, dtypes, directions) of the paths (PERF.md's kernel table)
PATH_SHAPES = [(1, 488, 8, "both", (False, True)), (55, 192, 8, "both", (False, True)),
               (55, 192, 48, "both", (False,)), (1, 48, 8, "f64", (False, True)),
               (1, 80, 8, "f64", (False, True)), (8, 192, 24, "f64", (False,)),
               (8, 192, 8, "f64", (True,)), (6, 96, 24, "f64", (False,)),
               (6, 96, 8, "f64", (True,)), (13, 192, 32, "f64", (False,)),
               (13, 192, 8, "f64", (True,)), (40, 320, 8, "both", (False, True)),
               (40, 320, 176, "both", (False,)), (17, 320, 152, "f64", (False,)),
               (17, 320, 8, "f64", (False, True)), (1, 1472, 8, "f64", (False, True)),
               (1, 3952, 8, "both", (False, True)), (157, 192, 408, "f32", (False,)),
               (157, 192, 8, "f32", (False, True)), (11, 200, 960, "both", (False,)),
               (11, 200, 8, "both", (False, True)), (1, 5344, 8, "both", (False, True)),
               (12, 232, 832, "f32", (False,)), (12, 232, 8, "f32", (False, True)),
               (1, 4968, 8, "f32", (False, True)), (1, 384, 8, "both", (False, True)),
               (1, 8, 8, "both", (False, True))]


def variants(before):
    """{name: source}: one per form, plan_trsm returning that form's plan."""
    src = _cuda._SOURCE.read_text()
    if src.count(PLAN_OPENING) != 1:
        raise RuntimeError("the source no longer has the lines the variants edit")
    plan = {"cluster": "plan_cluster", "separator": "plan_separator", "columns": "plan_columns"}
    out = {form: src.replace(PLAN_OPENING,
                             PLAN_OPENING + f"  return {fn}<T, kBwd>(K, M, S, optin, out);\n")
           for form, fn in plan.items()}
    if before:
        out["before"] = Path(before).read_text()
    return out


def build(srcs):
    """{name: ctypes library} of the variants, built in parallel."""
    OUT.mkdir(exist_ok=True)
    errs = {}

    def one(name, text):
        cu, so = OUT / f"trsm_{name}.cu", OUT / f"trsm_{name}.so"
        cu.write_text(text)
        p = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if p.returncode:
            errs[name] = p.stderr[-2000:]

    threads = [threading.Thread(target=one, args=kv) for kv in srcs.items()]
    for t in threads:
        t.start()
    _cuda.load()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"variant builds failed: {errs}")
    libs = {}
    for name in srcs:
        lib = ctypes.CDLL(str(OUT / f"trsm_{name}.so"))
        for kind in ("fwd", "bwd"):
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"slampp_trsm_{kind}_{dt}")
                ws = [] if name == "before" else [ctypes.c_void_p]
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + ws + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


class NoPlan(Exception):
    pass


def solve(lib, name, bwd, L, B):
    """X of one variant's TRSM; NoPlan where its form has no plan."""
    K, M, _ = L.shape
    S = B.shape[2]
    X = torch.empty_like(B)
    ws = torch.empty(1 + K * -(-S // 8) * -(-M // 32), dtype=torch.int32, device=B.device)
    fn = getattr(lib, f"slampp_trsm_{'bwd' if bwd else 'fwd'}_{'f64' if L.dtype == F64 else 'f32'}")
    err = fn(L.data_ptr(), B.data_ptr(), X.data_ptr(), K, M, S,
             *([] if name == "before" else [ws.data_ptr()]),
             torch.cuda.current_stream().cuda_stream)
    if err == NO_PLAN:
        raise NoPlan(name)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed ({err})")
    return X


def factor(dev, gen, K, M, zero=()):
    """K Cholesky factors (float64) of seeded SPD matrices; rows and columns
    ``zero`` of A exactly zero, factored by the plain version (pivots
    frozen at L_jj = 1e10), else by the library."""
    G = torch.randn(K, M, M, device=dev, dtype=F64, generator=gen)
    G[:, list(zero), :] = 0
    A = G @ G.transpose(1, 2)
    keep = [i for i in range(M) if i not in zero]
    A[:, keep, keep] += M
    return dk.chol_batched_plain(A) if zero else torch.linalg.cholesky(A)


def plain(bwd, L, B):
    return (dk.trsm_lower_t_batched_plain if bwd else dk.trsm_lower_batched_plain)(L, B)


def dev_ms(fn):
    return cs._device_ms(fn, cs._reps(fn, 0.25), 1)[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("trsm_forms_ab: no CUDA device", file=sys.stderr)
        return 1
    before = sys.argv[sys.argv.index("--before") + 1] if "--before" in sys.argv else None
    out_path = Path(sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
                    else ROOT / "chiprun_out" / "trsm_forms_ab.jsonl")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = out_path.open("w")
    libs = build(variants(before))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0

    def emit(rec):
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")

    def fits(name, bwd, L, B) -> bool:
        try:
            solve(libs[name], name, bwd, L, B)
            torch.cuda.synchronize()
            return True
        except NoPlan:
            return False

    # 1. every form against the plain version
    for K, M, S, zero in CHECKS:
        L64 = factor(dev, gen, K, M, zero)
        B64 = torch.randn(K, M, S, device=dev, dtype=F64, generator=gen)
        for dt in (F32, F64):
            L, B = L64.to(dt).contiguous(), B64.to(dt)
            for bwd in (False, True):
                ref = plain(bwd, L, B)
                Lop = L.transpose(1, 2) if bwd else L
                rec = {"check": [K, M, S], "dtype": str(dt)[6:], "bwd": bwd, "frozen": list(zero),
                       "plan": dk.trsm_form(dt, K, M, S, bwd)}
                for form in dk.TRSM_FORMS:
                    if not fits(form, bwd, L, B):
                        rec[form] = "no plan"
                        continue
                    X = solve(libs[form], form, bwd, L, B)
                    torch.cuda.synchronize()
                    fin = bool(torch.isfinite(X).all())
                    if dt == F64:
                        err, tol = float((X - ref).abs().max() / ref.abs().max()), 1e-10
                    else:
                        err, tol = float((Lop @ X - B).abs().max() / B.abs().max()), 1e-4
                    ok = fin and err < tol
                    failed += not ok
                    rec[form] = {"err": err, "ok": ok}
                emit(rec)

    # 2. device ms of each form beside the library's
    for K, M, S, dirs in ([] if "--quick" in sys.argv else GRID):
        L64 = factor(dev, gen, K, M)
        B64 = torch.randn(K, M, S, device=dev, dtype=F64, generator=gen)
        for dt in (F32, F64):
            L, B = L64.to(dt).contiguous(), B64.to(dt)
            for bwd in dirs:
                rec = {"shape": [K, M, S], "dtype": str(dt)[6:], "bwd": bwd,
                       "plan": dk.trsm_form(dt, K, M, S, bwd),
                       "bound_ms": cs._bound("trsm_lower_t_batched" if bwd else
                                             "trsm_lower_batched", K, M, S, str(dt)[6:])[0]}
                for form in dk.TRSM_FORMS:
                    rec[form] = (dev_ms(lambda: solve(libs[form], form, bwd, L, B))
                                 if fits(form, bwd, L, B) else None)
                rec["library"] = cs._device_ms(lambda: plain(bwd, L, B),
                                               cs._reps(lambda: plain(bwd, L, B), 0.25), 1)[0]
                emit(rec)

    # 3. the revision before beside this tree, in turns
    for K, M, S, dts, dirs in (PATH_SHAPES if before else []):
        L64 = factor(dev, gen, K, M)
        B64 = torch.randn(K, M, S, device=dev, dtype=F64, generator=gen)
        for dt in {"both": (F32, F64), "f32": (F32,), "f64": (F64,)}[dts]:
            L, B = L64.to(dt).contiguous(), B64.to(dt)
            for bwd in dirs:
                tree = dk.trsm_lower_t_batched if bwd else dk.trsm_lower_batched
                old = None
                if fits("before", bwd, L, B):
                    old = lambda: solve(libs["before"], "before", bwd, L, B)  # noqa: E731
                b1 = dev_ms(old) if old else None
                n1, n2 = dev_ms(lambda: tree(L, B)), dev_ms(lambda: tree(L, B))
                b2 = dev_ms(old) if old else None
                emit({"ab": [K, M, S], "dtype": str(dt)[6:], "bwd": bwd,
                      "form": dk.trsm_form(dt, K, M, S, bwd), "before_ms": [b1, b2],
                      "after_ms": [n1, n2]})
    out.close()
    print(cs._smi())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
