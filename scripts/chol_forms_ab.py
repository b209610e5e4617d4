"""The Cholesky kernel's forms side by side on one CUDA card.

    python scripts/chol_forms_ab.py [--before PATH] [--quick]

Builds, beside this tree's kernels, variants of
``slampp_tpu_torch/csrc/dense_kernels.cu`` into ``_chip/`` (all nvcc runs in
parallel): the large form for every M above the resident size
(``large_all``), the streaming form wherever it fits (``stream_all``), the
large form on 128-wide tiles (``tile128``) and with f64's diagonal factor
unrolled as f32's (``f64_unrolled``), a copy with %globaltimer reads
in the large form's phases (``phases``; the repo's source has none) and a
copy with a kernel that runs the large form's 32-column diagonal factor
alone (``diag``); with ``--before PATH`` also another revision's source
(``before``; e.g. ``git show <rev>:slampp_tpu_torch/csrc/dense_kernels.cu``
written there beforehand, as the card's machine has no git).  Then, on
seeded SPD matrices made on the card:

  1. every form against the plain version (f64 within 1e-10, f32 within
     1e-3 of the plain factor's scale, frozen pivots included) and each
     one's residual max |L L^T - A| / max |A| beside the plain version's;
  2. device ms (torch.profiler, as chip_smoke.py) of the streaming and the
     large form in turns over K in {1, 2, 8, 17, 40} and M from 296 to 640:
     where plan_chol's crossover (chol_large_from) comes from;
  3. device ms at the paths' shapes: before, this tree, tile128 (and
     f64_unrolled in f64), then the same in reverse order, and cholesky_ex,
     beside the bound;
  4. the large form's phases (per task kind, mean us: the chain's step,
     the panel tasks, the update tasks; inside the tile's factor) at the
     separators;
  5. the diagonal factor alone, unrolled (chol_diag) and rolled
     (chol_diag_rolled), one warp with no register cap and 256 threads
     under the large form's launch bounds: the first call and the mean of
     the next 100, us.

``--quick`` skips step 2.  Prints one JSON object per line, then the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from slampp_tpu_torch.ops import _cuda, dense_kernels as dk  # noqa: E402

OUT = ROOT / "_chip"

CROSS = "  if (sizeof(T) == 4) return K >= 40 ? 440 : 392;\n  return K >= 40 ? 392 : 296;"
TILE = "constexpr int kTile = 64;"
ROLLED = "      if constexpr (sizeof(T) == 8) chol_diag_rolled"

# %globaltimer reads for step 4: (text in the source, text that replaces it)
PHASES = [
    (TILE, TILE + "\n"
     "__device__ unsigned long long dbg_sum[3][8];\n__device__ unsigned long long dbg_cnt[3];\n"
     "__device__ unsigned long long dbg_prev[2048];\n__device__ unsigned long long dbg_f[16];\n"
     "__device__ __forceinline__ unsigned long long gt() { unsigned long long t; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n"
     "#define TSS() if (threadIdx.x == 0) dbg_prev[blockIdx.x] = gt();\n"
     "#define TS(q) if (threadIdx.x == 0) { unsigned long long _t = gt(); "
     "atomicAdd(&dbg_f[q], _t - dbg_prev[blockIdx.x]); dbg_prev[blockIdx.x] = _t; }\n"
     "#define TK(kind, q) if (threadIdx.x == 0) { unsigned long long _t = gt(); "
     "atomicAdd(&dbg_sum[kind][q], _t - tprev); tprev = _t; }\n"),
    ("      else chol_diag<T, false>(s, s, nullptr, ld, j0, w, clamp);\n    }\n"
     "    __syncthreads();\n",
     "      else chol_diag<T, false>(s, s, nullptr, ld, j0, w, clamp);\n    }\n"
     "    __syncthreads();\n    TS(1)\n"),
    ("    invert_diag<T, false, kLdv<T>>(s + j0 * ld + j0, ld, imin(kNB, n - j0), di);\n"
     "    __syncthreads();\n",
     "    invert_diag<T, false, kLdv<T>>(s + j0 * ld + j0, ld, imin(kNB, n - j0), di);\n"
     "    __syncthreads();\n    TS(2)\n"),
    ("      __syncthreads();\n      // the lower triangle of rows and columns [j1, P kNB) less W W^T: the\n",
     "      __syncthreads();\n      TS(3)\n      // the lower triangle of rows and columns [j1, P kNB) less W W^T: the\n"),
    ("        s[(j1 + r) * ld + j1 + col] -= x;\n      }\n      __syncthreads();\n",
     "        s[(j1 + r) * ld + j1 + col] -= x;\n      }\n      __syncthreads();\n      TS(4)\n"),
    ("    if (tk >= total) break;\n", "    if (tk >= total) break;\n    unsigned long long tprev = gt();\n"),
    ("        if (tid < 2) wait_at_least(tid == 0 ? ctr(g, g) : ctr(g, g - 1), tid == 0 ? g - 1 : g);\n",
     "        if (tid < 2) wait_at_least(tid == 0 ? ctr(g, g) : ctr(g, g - 1), tid == 0 ? g - 1 : g);\n"
     "        TK(0, 0)\n"),
    ("      factor_tile<T, kT>(sd, n, clamp, sdi, swt, scol);\n",
     "      TK(0, 1)\n      TSS()\n      factor_tile<T, kT>(sd, n, clamp, sdi, swt, scol);\n      TK(0, 2)\n"),
    ("      publish(ctr(g, g), g + 1);\n", "      TK(0, 3)\n      publish(ctr(g, g), g + 1);\n"),
    ("        wait_cta(ctr(g + 1, g), g);\n", "        wait_cta(ctr(g + 1, g), g);\n        TK(0, 4)\n"),
    ("        publish(ctr(g + 1, g), g + 1);\n      }\n      continue;\n",
     "        publish(ctr(g + 1, g), g + 1);\n        TK(0, 5)\n      }\n"
     "      if (threadIdx.x == 0) atomicAdd(&dbg_cnt[0], 1ull);\n      continue;\n"),
    ("        wait_at_least(tid == 0 ? ctr(i, j) : ctr(tid == 1 ? i : j, st), tid == 0 ? st : st + 1);\n"
     "      update(i, j, st, out);\n",
     "        wait_at_least(tid == 0 ? ctr(i, j) : ctr(tid == 1 ? i : j, st), tid == 0 ? st : st + 1);\n"
     "      if (!is_p) { TK(2, 0) }\n      update(i, j, st, out);\n"),
    ("      __threadfence();  // the update, before it is read back past the L1\n"
     "      wait_cta(ctr(g, g), g + 1);\n      panel(i, g);\n      publish(ctr(i, j), g + 1);\n"
     "    } else {\n      publish(ctr(i, j), st + 1);\n    }\n",
     "      TK(1, 0)\n      __threadfence();  // the update, before it is read back past the L1\n"
     "      wait_cta(ctr(g, g), g + 1);\n      TK(1, 1)\n      panel(i, g);\n"
     "      publish(ctr(i, j), g + 1);\n      TK(1, 2)\n"
     "      if (threadIdx.x == 0) atomicAdd(&dbg_cnt[1], 1ull);\n    } else {\n"
     "      publish(ctr(i, j), st + 1);\n      TK(2, 1)\n"
     "      if (threadIdx.x == 0) atomicAdd(&dbg_cnt[2], 1ull);\n    }\n"),
    ("extern \"C\" {\n", "extern \"C\" {\n"
     "int dbg_read(void* s, void* c, void* f) { cudaMemcpyFromSymbol(s, dbg_sum, sizeof(dbg_sum)); "
     "cudaMemcpyFromSymbol(f, dbg_f, sizeof(dbg_f)); "
     "return cudaMemcpyFromSymbol(c, dbg_cnt, sizeof(dbg_cnt)); }\n"
     "int dbg_zero() { unsigned long long z[64] = {}; cudaMemcpyToSymbol(dbg_sum, z, sizeof(dbg_sum)); "
     "cudaMemcpyToSymbol(dbg_f, z, sizeof(dbg_f)); return cudaMemcpyToSymbol(dbg_cnt, z, sizeof(dbg_cnt)); }\n"),
]

# step 5: the 32-column diagonal factor alone in one CTA: one warp with no
# register cap, and 256 threads under the large form's __launch_bounds__
# (two CTAs per SM: at most 128 registers a thread); the first call (cold)
# and the mean of the next `reps` (warm)
DIAG = r"""
namespace {
__device__ __forceinline__ unsigned long long gt2() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;
}
template <typename T, bool kRolled>
__device__ __forceinline__ void diag_body(T* s, T* col, unsigned long long* ns, int reps) {
  constexpr int ld = kLdt<T, kTile>;
  unsigned long long t0 = 0, t1 = 0;
  for (int it = 0; it <= reps; ++it) {
    if (threadIdx.x < 32)
      for (int c = 0; c < kNB; ++c)
        s[threadIdx.x * ld + c] = threadIdx.x == c ? T(40) : (c < threadIdx.x ? T(0.01) * T(c + 1) : T(0));
    __syncthreads();
    if (it == 0) t0 = gt2();
    if (it == 1) t1 = gt2();
    if (threadIdx.x < 32) {
      if (kRolled) chol_diag_rolled<T>(s, ld, 0, kNB, T(1e-8), col);
      else chol_diag<T, false>(s, s, nullptr, ld, 0, kNB, T(1e-8));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ns[0] = gt2() - t1, ns[1] = t1 - t0;
}
template <typename T, bool kRolled>
__global__ void diag_free(T* out, unsigned long long* ns, int reps) {
  __shared__ __align__(16) T s[kTile * kLdt<T, kTile>];
  __shared__ __align__(16) T col[2 * kNB];
  diag_body<T, kRolled>(s, col, ns, reps);
  if (threadIdx.x < 32) out[threadIdx.x] = s[threadIdx.x * kLdt<T, kTile> + 3];
}
template <typename T, bool kRolled>
__global__ void __launch_bounds__(kTiledThreads, 2) diag_capped(T* out, unsigned long long* ns, int reps) {
  __shared__ __align__(16) T s[kTile * kLdt<T, kTile>];
  __shared__ __align__(16) T col[2 * kNB];
  diag_body<T, kRolled>(s, col, ns, reps);
  if (threadIdx.x < 32) out[threadIdx.x] = s[threadIdx.x * kLdt<T, kTile> + 3];
}
template <typename T, bool kRolled>
void diag_launch(int capped, void* out, void* ns, int reps) {
  if (capped) diag_capped<T, kRolled><<<1, kTiledThreads>>>((T*)out, (unsigned long long*)ns, reps);
  else diag_free<T, kRolled><<<1, 32>>>((T*)out, (unsigned long long*)ns, reps);
}
}  // namespace
extern "C" int diag_alone_run(int f64, int rolled, int capped, void* out, void* ns, int reps) {
  if (f64) rolled ? diag_launch<double, true>(capped, out, ns, reps) : diag_launch<double, false>(capped, out, ns, reps);
  else rolled ? diag_launch<float, true>(capped, out, ns, reps) : diag_launch<float, false>(capped, out, ns, reps);
  return (int)cudaDeviceSynchronize();
}
"""


def variants(before):
    src = _cuda._SOURCE.read_text()
    for text in [CROSS, TILE, ROLLED] + [a for a, _ in PHASES]:
        if src.count(text) != 1:
            raise RuntimeError(f"the source no longer has the lines the variants edit: {text[:60]!r}")
    phases = src
    for a, b in PHASES:
        phases = phases.replace(a, b)
    out = {"large_all": src.replace(CROSS, "  return 0;"),
           "stream_all": src.replace(CROSS, "  return 1 << 20;"),
           "tile128": src.replace(TILE, "constexpr int kTile = 128;"),
           "f64_unrolled": src.replace(ROLLED, "      if constexpr (false) chol_diag_rolled"),
           "phases": phases,
           "diag": src + DIAG}
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
        ws = name != "before"  # the parent's entry point takes no workspace
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"slampp_chol_{dt}")
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_double]
                           + [ctypes.c_void_p] * (2 if ws else 1))
            fn.restype = ctypes.c_int
        if ws:
            lib.slampp_chol_workspace.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        libs[name] = lib
    libs["phases"].dbg_read.argtypes = [ctypes.c_void_p] * 3
    libs["diag"].diag_alone_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chol_forms_ab: no CUDA device", file=sys.stderr)
        return 1
    before = sys.argv[sys.argv.index("--before") + 1] if "--before" in sys.argv else None
    libs = build(variants(before))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, f64 = torch.float32, torch.float64

    def spd(K, M, zero=()):
        G = torch.randn(K, M, M, device=dev, dtype=f64, generator=gen)
        G[:, list(zero), :] = 0
        A = G @ G.transpose(1, 2) / M
        keep = [i for i in range(M) if i not in zero]
        A[:, keep, keep] += 1.0
        return A

    def run(name, A):
        if name == "tree":
            return dk.chol_batched(A)
        lib, K, M = libs[name], A.shape[0], A.shape[1]
        out = torch.empty_like(A)
        fn = getattr(lib, "slampp_chol_" + ("f32" if A.dtype == f32 else "f64"))
        stream = torch.cuda.current_stream().cuda_stream
        if name == "before":
            err = fn(A.data_ptr(), out.data_ptr(), K, M, 1e-8, stream)
        else:
            n = ctypes.c_longlong(0)
            err = lib.slampp_chol_workspace(int(A.dtype == f64), K, M, ctypes.byref(n))
            ws = torch.empty(max(n.value, 16), dtype=torch.uint8, device=dev)
            err = err or fn(A.data_ptr(), out.data_ptr(), K, M, 1e-8, ws.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed ({err})")
        return out

    def resid(L, A64):
        L = L.double()
        return float((L @ L.transpose(1, 2) - A64).abs().max() / A64.abs().max())

    def dev_ms(fn):
        r = cs._reps(fn, 0.25)
        return cs._device_ms(fn, r, 1)[0]

    # 1. every form against the plain version
    for K, M, zero in ((2, 296, ()), (3, 320, (5, 200, 319)), (2, 488, ()), (1, 1000, (7, 999)),
                       (4, 200, ()), (2, 1480, ())):
        A64 = spd(K, M, zero)
        keep = [i for i in range(M) if i not in zero]
        for dt in (f32, f64):
            A = A64.to(dt)
            ref = dk.chol_batched_plain(A)
            rec = {"K": K, "M": M, "dtype": str(dt)[6:], "frozen": list(zero)}
            if not zero:
                rec["plain_resid"] = resid(ref, A64)
            for name in ("tree", "large_all", "stream_all", "tile128"):
                L = run(name, A)
                torch.cuda.synchronize()
                e = float((L - ref).abs().max()) / float(ref[:, keep][:, :, keep].abs().max())
                ok = (bool(torch.isfinite(L).all()) and not bool(torch.triu(L, 1).any())
                      and e < (1e-10 if dt == f64 else 1e-3))
                rec[name] = {"rel_vs_plain": e, "ok": ok, **({} if zero else {
                    "resid": resid(L, A64)})}
            print(json.dumps(rec), flush=True)

    # 2. the crossover grid, in turns
    if "--quick" not in sys.argv:
        for dt in (f32, f64):
            for K in (1, 2, 8, 17, 40):
                for M in (296, 320, 392, 440, 488, 560, 640):
                    A = spd(K, M).to(dt)
                    rec = {"K": K, "M": M, "dtype": str(dt)[6:]}
                    for name in ("stream_all", "large_all", "large_all", "stream_all"):
                        rec.setdefault(name, []).append(dev_ms(lambda: run(name, A)))
                    print(json.dumps(rec), flush=True)

    # 3. the paths' shapes: every large-form shape and the one-CTA forms'
    for K, M, dt in ((55, 192, f32), (55, 192, f64), (157, 192, f32), (40, 320, f32), (40, 320, f64),
                     (17, 320, f64), (1, 384, f32), (1, 384, f64), (1, 488, f32), (1, 488, f64),
                     (1, 1472, f64), (1, 3952, f32), (1, 3952, f64), (1, 4968, f32), (1, 5344, f32),
                     (1, 5344, f64), (1, 6400, f64)):
        A = spd(K, M).to(dt)
        rec = {"K": K, "M": M, "dtype": str(dt)[6:], "form": dk.chol_form(dt, K, M)}
        names = ("before", "tree", "tile128") + (("f64_unrolled",) if dt == f64 else ())
        for name in names + names[::-1]:
            if name in libs or name == "tree":
                rec.setdefault(name, []).append(dev_ms(lambda: run(name, A)))
        rec["cholesky_ex"] = dev_ms(lambda: torch.linalg.cholesky_ex(A))
        rec["bound_ms"], rec["bound_by"] = cs._bound("chol_batched", K, M, None, str(dt)[6:])
        print(json.dumps(rec), flush=True)

    # 4. the large form's phases at the separators (one launch, after one warm-up)
    lib = libs["phases"]
    for K, M, dt in ((1, 488, f32), (1, 3952, f32), (1, 5344, f32), (1, 1472, f64), (1, 3952, f64),
                     (1, 5344, f64)):
        A = spd(K, M).to(dt)
        run("phases", A)
        torch.cuda.synchronize()
        lib.dbg_zero()
        t0 = time.perf_counter()
        run("phases", A)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = np.zeros((3, 8), np.uint64)
        c = np.zeros(3, np.uint64)
        f = np.zeros(16, np.uint64)
        lib.dbg_read(s.ctypes.data, c.ctypes.data, f.ctypes.data)
        n = c.astype(float)
        us = lambda x, m: round(float(x) / max(m, 1.0) / 1e3, 2)  # noqa: E731
        print(json.dumps({
            "K": K, "M": M, "dtype": str(dt)[6:], "wall_ms": round(wall * 1e3, 3), "tasks": n.tolist(),
            "chain_us[wait,update,factor,inverse,wait_below,below]": [us(s[0, q], n[0]) for q in range(6)],
            "panel_us[update,wait_diag,product]": [us(s[1, q], n[1]) for q in range(3)],
            "update_us[wait,product]": [us(s[2, q], n[2]) for q in range(2)],
            "cta_ms": {k: round(float(s[i].sum()) / 1e6, 2) for i, k in enumerate(("chain", "panel", "update"))},
            "factor_us[diag,inverse32,panel,trailing]": [us(f[q], n[0]) for q in (1, 2, 3, 4)]}),
            flush=True)

    # 5. the diagonal factor alone
    for dt in (f32, f64):
        for rolled in (0, 1):
            for capped in (0, 1):
                out = torch.zeros(32, dtype=dt, device=dev)
                ns = torch.zeros(2, dtype=torch.int64, device=dev)
                err = libs["diag"].diag_alone_run(int(dt == f64), rolled, capped, out.data_ptr(),
                                                  ns.data_ptr(), 100)
                if err:
                    raise RuntimeError(f"diag_alone: CUDA error {err}")
                print(json.dumps({"diag_alone": str(dt)[6:], "rolled": bool(rolled),
                                  "capped_256_2": bool(capped), "warm_us": int(ns[0]) / 100 / 1e3,
                                  "first_us": int(ns[1]) / 1e3}), flush=True)
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
