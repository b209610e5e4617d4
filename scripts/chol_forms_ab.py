"""The Cholesky kernel's forms side by side on one CUDA card.

    python scripts/chol_forms_ab.py [--before PATH]

Builds, beside this tree's kernels, three variants of
``slampp_tpu_torch/csrc/dense_kernels.cu`` into ``_chip/`` (all nvcc runs in
parallel): the large form for every M above the resident size
(``large_all``), the streaming form wherever it fits (``stream_all``), and
this tree with the pivot of the kernels before (``rsqrt_pivot``: L_jj = d *
rsqrt(d), MUFU.RSQ); with ``--before PATH`` also another revision's source
(``before``; e.g. ``git show <rev>:slampp_tpu_torch/csrc/dense_kernels.cu``
written there beforehand, as the card's machine has no git).  Then, on
seeded SPD matrices made on the card:

  1. every form against the plain version (f64 within 1e-10, f32 within
     1e-3 of the plain factor's scale, frozen pivots included) and each
     one's residual max |L L^T - A| / max |A| beside the plain version's;
  2. device ms (torch.profiler, as chip_smoke.py) of the streaming and the
     large form in turns over K in {1, 2, 8, 17, 40} and M from 296 to 640:
     where plan_chol's crossover (chol_large_from) comes from;
  3. device ms at the paths' shapes: before, this tree, rsqrt_pivot, this
     tree, before, and cholesky_ex, beside the bound.

Prints one JSON object per line, then the card's name and power limit.
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

OUT = ROOT / "_chip"


def variants(before):
    src = _cuda._SOURCE.read_text()
    pivot = "  const T ljj = sqrt_t(d);\n  *inv = T(1) / ljj;\n  return ljj;"
    cross = "  if (sizeof(T) == 4) return K >= 8 ? 488 : 392;\n  return K >= 8 ? 392 : 296;"
    if pivot not in src or cross not in src:
        raise RuntimeError("the source no longer has the lines the variants edit")
    out = {"large_all": src.replace(cross, "  return 0;"),
           "stream_all": src.replace(cross, "  return 1 << 20;"),
           "rsqrt_pivot": src.replace(pivot, "  *inv = rsqrt(d);\n  return d * *inv;")}
    if before:
        out["before"] = Path(before).read_text()
    return out


def build(srcs):
    """{name: ctypes library} of the variants, built in parallel."""
    OUT.mkdir(exist_ok=True)
    errs = {}

    def one(name, text):
        cu, so = OUT / f"v_{name}.cu", OUT / f"v_{name}.so"
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
        lib = ctypes.CDLL(str(OUT / f"v_{name}.so"))
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"slampp_chol_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double,
                                                                        ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chol_forms_ab: no CUDA device", file=sys.stderr)
        return 1
    before = sys.argv[sys.argv.index("--before") + 1] if "--before" in sys.argv else None
    libs = build(variants(before))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def spd(K, M, zero=()):
        G = torch.randn(K, M, M, device=dev, dtype=torch.float64, generator=gen)
        G[:, list(zero), :] = 0
        A = G @ G.transpose(1, 2) / M
        keep = [i for i in range(M) if i not in zero]
        A[:, keep, keep] += 1.0
        return A

    def run(name, A):
        if name == "tree":
            return dk.chol_batched(A)
        out = torch.empty_like(A)
        fn = getattr(libs[name], "slampp_chol_" + ("f32" if A.dtype == torch.float32 else "f64"))
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[1], 1e-8,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed ({err})")
        return out

    def resid(L, A64):
        L = L.double()
        return float((L @ L.transpose(1, 2) - A64).abs().max() / A64.abs().max())

    def dev_ms(fn):
        r = cs._reps(fn, 0.25)
        return cs._device_ms(fn, r, 1, one_launch=True)[0]

    # 1. every form against the plain version
    for K, M, zero in ((2, 296, ()), (3, 320, (5, 200, 319)), (2, 488, ()), (1, 1000, (7, 999)),
                       (4, 200, ())):
        A64 = spd(K, M, zero)
        keep = [i for i in range(M) if i not in zero]
        for dt in (torch.float32, torch.float64):
            A = A64.to(dt)
            ref = dk.chol_batched_plain(A)
            rec = {"K": K, "M": M, "dtype": str(dt)[6:], "frozen": list(zero)}
            if not zero:
                rec["plain_resid"] = resid(ref, A64)
            for name in ("tree", "large_all", "stream_all"):
                L = run(name, A)
                torch.cuda.synchronize()
                e = float((L - ref).abs().max()) / float(ref[:, keep][:, :, keep].abs().max())
                ok = (bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
                      and e < (1e-10 if dt == torch.float64 else 1e-3))
                rec[name] = {"rel_vs_plain": e, "ok": ok, **({} if zero else {
                    "resid": resid(L, A64)})}
            print(json.dumps(rec), flush=True)

    # 2. the crossover grid, in turns
    for dt in (torch.float32, torch.float64):
        for K in (1, 2, 8, 17, 40):
            for M in (296, 320, 392, 440, 488, 560, 640):
                A = spd(K, M).to(dt)
                rec = {"K": K, "M": M, "dtype": str(dt)[6:]}
                for name in ("stream_all", "large_all", "large_all", "stream_all"):
                    rec.setdefault(name, []).append(dev_ms(lambda: run(name, A)))
                print(json.dumps(rec), flush=True)

    # 3. the paths' shapes
    for K, M, dt in ((55, 192, torch.float32), (55, 192, torch.float64), (157, 192, torch.float32),
                     (40, 320, torch.float32), (40, 320, torch.float64),
                     (17, 320, torch.float64), (1, 488, torch.float32), (1, 488, torch.float64),
                     (1, 1472, torch.float64), (1, 3952, torch.float32),
                     (1, 3952, torch.float64), (1, 6400, torch.float64)):
        A = spd(K, M).to(dt)
        rec = {"K": K, "M": M, "dtype": str(dt)[6:], "form": dk.chol_form(dt, K, M)}
        # the kernel before took f64 up to M = 3104 and f32 up to 6336
        fits = M <= (3104 if dt == torch.float64 else 6336)
        for name in ("before", "tree", "rsqrt_pivot", "tree", "before"):
            if name in libs or name == "tree":
                if name != "before" or fits:
                    rec.setdefault(name, []).append(dev_ms(lambda: run(name, A)))
        rec["cholesky_ex"] = cs._device_ms(lambda: torch.linalg.cholesky_ex(A),
                                           cs._reps(lambda: torch.linalg.cholesky_ex(A), 0.25),
                                           1)[0]
        rec["bound_ms"], rec["bound_by"] = cs._bound("chol_batched", K, M, None, str(dt)[6:])
        print(json.dumps(rec), flush=True)
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
