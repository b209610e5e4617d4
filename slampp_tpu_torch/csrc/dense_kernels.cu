// Batched dense Cholesky and triangular solves for NVIDIA Hopper (sm_90a).
//
// These replace the three Pallas TPU kernels of
// slampp_tpu/ops/dense_kernels.py, all of which ran through _batched_call
// (pl.pallas_call at dense_kernels.py:286):
//
//   chol_kernel             <- _chol_kernel      (dense_kernels.py:184), chol_batched
//   trsm_kernel<T, false>   <- _trsm_fwd_kernel  (dense_kernels.py:215), trsm_lower_batched
//   trsm_kernel<T, true>    <- _trsm_bwd_kernel  (dense_kernels.py:236), trsm_lower_t_batched
//
// Each computes what its TPU kernel computes, not a block-by-block copy: the
// TPU kernels walk 8-wide column panels through one-hot selection matmuls
// (a Mosaic workaround for dynamic lane slices); here the kernels walk
// panels of kNB = 32 rows with plain indexing.
//
// Cholesky: three forms, chosen on the host per (device, K, M, dtype) and
// kept (plan_chol).  The two one-CTA forms run a matrix per CTA of 512
// threads; the large form spreads each matrix over every SM.
//
// One CTA per matrix, register-tiled.  At the part frames' shapes the bound
// is tiny ((55, 192, 192): 12.2 MB, 3.6 us at 3.35 TB/s); what holds one CTA
// back is the serial chain of 32-wide panels and the rate at which one SM
// feeds its FMAs from shared memory.  The first design took 1.48 ms at
// (1, 488, 488) on an H100: 60% in a trailing update that issued two shared
// loads per FMA and a read-modify-write of every element through L2, 23% in
// one warp's shared read-modify-write loops for each diagonal block, 11% in
// a one-thread-per-row panel solve with strided global reads, 6% in an
// element-by-element copy of A (%globaltimer phase timestamps, PERF.md).
// This design, per panel p:
//
//  * Diagonal block: warp 0 holds its rows in registers and factors it one
//    column per step, the column broadcast by shuffles; the next pivot is
//    taken as soon as its entry is updated, so it overlaps the rest of the
//    step.  The pivot is the correctly rounded sqrt and its correctly
//    rounded reciprocal, as in the plain version (pivot()).  Warps 0-7 then
//    invert the block (invert_diag, shared with the TRSMs).  Pivot freezing
//    as _chol_value (dense_kernels.py:69-112): the test is on the fully
//    updated diagonal entry d; d <= clamp (or NaN) gives d = 1e20, and the
//    column's multipliers are scaled by 1 / L_jj, so a failed pivot freezes
//    its column at about 0 (L_jj = 1e10) instead of amplifying it.
//  * Panel: W = A_p L_d^-T, one row per thread in registers, the rows of
//    L_d^-1 read as broadcast 16-byte vectors; W also goes, transposed, to
//    shared memory for the update.
//  * Trailing update: each warp takes 32 x 32 tiles of the lower trailing
//    triangle in turn, each lane a 4 x 8 register tile, 32 FMAs per three
//    16-byte shared loads of W^T; the products of an entry are summed from
//    zero and subtracted once (chol_trailing).  More FMAs per load (an 8 x 8
//    register tile in f32) and loading the next tile during the current one
//    both ran into the 128-register cap of 512 threads (spills) and were
//    slower.
//  * Resident form, where the packed lower triangle fits the 227 KB opt-in
//    beside the rest (f32 M <= 288, f64 M <= 192 on an H100: the dense
//    frames' part blocks in both dtypes): it is loaded once by one
//    cp.async.bulk per row on an mbarrier, factored in shared memory and
//    written back once with the upper triangle zeroed.  Streaming form
//    (below chol_large_from(K): sphere's (40, 320) part frames): the factor
//    is formed in the output (L2-resident): the first panel reads A, the
//    part right of each diagonal block is zeroed once, and each panel's rows
//    are staged in shared memory by coalesced 16-byte copies.
//
// Large form (chol_big_kernel: the separators, (1, 488) to (1, 3952) and
// beyond): one cooperative launch of as many 256-thread CTAs as the card
// holds at once (2 per SM), the factor formed in place in the output, the
// three steps of each 32-wide panel separated by grid-wide barriers.  The
// one-CTA design took 404 ms at (1, 3952, 3952) f32 (M^3 / 3 = 2.06e10
// FLOP on one SM, 1300x the 0.31 ms bound) and could not take f64 beyond
// M = 3104 (its W^T and staged rows no longer fit one SM's shared memory).
// Per panel:
//  * every CTA with panel rows loads the factored 32 x 32 diagonal block
//    and solves its rows by substitution, one row per thread (W[c] =
//    (a[c] - sum_{t < c} W[t] L[c][t]) / L[c][c], as the plain version);
//  * the trailing update of the lower triangle in 64 x 64 tiles spread over
//    the grid, each thread a 4 x 4 register tile fed by two 16-byte shared
//    loads of W^T per depth step, the 32 products summed from zero and
//    subtracted once;
//  * the CTA of tile (0, 0), which holds the next diagonal block, factors it
//    (warp 0, as above) right after its own update, so the next panel's
//    rows find it factored after the barrier: two grid barriers per panel.
// Any M that memory holds, in both dtypes; K matrices share the grid as
// (matrix, rows) and (matrix, tile) items.  What bounds it is the panel
// chain: about 25-40 us per panel on an H100 (two barriers, the diagonal
// block's serial factorization, a substitution of 32 dependent steps), so
// 5.0 ms at (1, 3952, 3952) f32 against cholesky_ex's 1.74 (PERF.md).
//
// Accuracy: subtracting each of a panel's products from an entry in turn
// (the one-CTA design before) rounds at the entry's magnitude once per
// column; at the sphere2500 separator (condition ~6.6e5) that made the f32
// factor's residual 4x the plain version's and a solve through it 8x less
// accurate.  Summing the products first, as the plain version's A -= W W^T
// does, and taking exact pivots gives a residual below the plain version's
// (PERF.md).
//
// No tensor cores (TF32 would miss the f32 tolerance; f64 DMMA is queued
// work).

// Triangular solves: a cluster-resident wavefront.  The first design (one
// CTA per matrix and 8-column group of B, 32-row panels in order) was bound
// by latency, not by FLOPs or bytes: at the separator shape (1, 488, 8) it
// ran one CTA on one of 132 SMs through 16 panels, each a global load of the
// diagonal block, a 32-step shuffle-and-divide substitution, and a trailing
// update that read L from L2 once per FMA (a loop of runtime length, 8
// warps to hide it) with x making a round trip through global memory; about
// 1.9 MFLOP in ~0.2 ms, slower than torch.linalg.solve_triangular.  This
// design spreads the solve over a thread-block cluster and keeps everything
// the serial chain touches on chip:
//
//  * One cluster per matrix and G 8-column groups of B, of C = min(ceil(M /
//    32), 16) CTAs (16 is a non-portable cluster size).  CTA r owns the
//    panels p = r, r + C, ... (one panel each for M <= 512).  C = 1 (the
//    same code with no remote traffic) was slower on an H100 at every shape
//    of the path, the batched ones included, so C is not lowered for them.
//    G is 1 unless the grid would take more waves of clusters than the card
//    holds at once (the dense frames' (55, 192, 48)): then a cluster takes
//    several groups (G = 3 or 6), so that one slab load and one
//    wavefront serve them all (plan_trsm; the plan of each shape is made
//    once and kept).
//  * Each CTA holds its panels' slab of L in shared memory: the forward
//    solve needs the row slab (rows of panel p, columns [0, end of p)); the
//    transposed solve needs the column slab (columns of panel p, rows
//    [start of p, M)), i.e. the rows of L^T, which it reads transposed in
//    place.  Warp 0 loads the slabs with cp.async.bulk (one copy per row
//    segment, no tensor map) on mbarriers, in the order the wavefront
//    consumes them, so the load overlaps the solve: the diagonal block
//    first, then (fwd) the rest of each row in one copy, or (bwd) one
//    32-row chunk per panel.  The CTA arrives on the cluster barrier before
//    the load and waits on it only before the wavefront, so the barrier's
//    ~1 us overlaps the load and the inversion.
//  * Off the critical path, every CTA inverts its own 32 x 32 diagonal
//    blocks in shared memory (the warp substitution applied to the identity,
//    multiplying by the pivots' reciprocals, four columns per warp at once;
//    frozen pivots stay frozen: L_jj = 1e10 gives a 1e-10 entry).  The
//    panel's critical step is then x_p = D_p^-1 r_p (fwd) or D_p^-T r_p
//    (bwd), a 32 x 32 by 32 x 8G product from shared memory, in place of 32
//    dependent shuffle-and-divide steps.  The explicit inverse meets the f64
//    tolerance (1e-10 relative against the plain version, rehearsed on the
//    CPU in tests/test_torch_dense_kernels.py), so it is kept.
//  * The wavefront (fwd runs down, bwd up): the owner of panel p forms x_p
//    from its accumulated rhs into its own slot p and pushes the slot
//    through distributed shared memory into slot p of every other CTA of
//    the cluster, with one bulk copy per CTA (cp.async.bulk shared::cta ->
//    shared::cluster, issued by C - 1 threads at once) that completes on
//    that CTA's per-panel mbarrier.  (Per-thread st.async stores in place of
//    the copies, C - 1 per thread and column group, were ~10% slower at
//    (1, 488, 8) on an H100.)  Each CTA waits on its own barrier and
//    subtracts L_ip x_p from the rhs of each panel it owns, in parallel with
//    the others.  With one panel per CTA the owner of p + 1 applies x_p to
//    its own rows only, so the chain waits on that one update (look-ahead).
//    x never goes back to global memory before the end; a final
//    cluster.sync() keeps every CTA's shared memory alive while copies from
//    it may be in flight.
//  * Beyond the resident size a CTA whose slabs do not all fit in shared
//    memory (227 KB opt-in) reads the panels it lacks from global memory at
//    the point of use, in the same wavefront.  With one panel per CTA every
//    slab fits; with G = 1 the branch starts at M = 608 (fwd) / 584 (bwd) in
//    f64 and M = 1000 (fwd) / 928 (bwd) in f32 (the least multiple of 8 at
//    which a CTA of a 16-CTA cluster leaves a panel in global memory).
//  * Where the x tiles of all P panels no longer fit in every CTA (G = 1:
//    M > 2560 in f64, M > 5120 in f32), each CTA keeps only the x of its own
//    panels, and x_p is pulled instead: a cluster.sync() after the owner
//    forms it, then every other CTA copies it into a staging tile through
//    distributed shared memory.  Shared memory then grows with the panels
//    per CTA only, and the solve takes M up to 7680 (f64) / 12288 (f32) on a
//    227 KB opt-in; beyond that no plan fits and the launch returns
//    cudaErrorInvalidValue.
//  * No tensor cores: the products are 32 x 32 by 32 x 8 and latency-bound,
//    and TF32 would miss the f32 residual tolerance.
//
// Plain C interface for ctypes (slampp_tpu_torch/ops/_cuda.py): every entry
// point launches on the given stream, allocates nothing, does not
// synchronise, and returns a CUDA error code (cudaGetLastError() after the
// launch) so that a refused launch is reported to the caller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;  // panel width: one warp's lanes
constexpr int kCholThreads = 512;
constexpr int kTrsmCols = 8;                         // rhs columns in one column group
constexpr int kMaxCluster = 16;                      // CTAs per cluster (non-portable size)
constexpr int kTrsmThreads = kNB * kTrsmCols;        // one (row, column) of a group each
constexpr int kLdd = kNB + 1;                        // inverted diagonal blocks, padded
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// ---------------------------------------------------------------------------
// triangular solves: cluster-resident wavefront
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}
__host__ __device__ __forceinline__ int panel_width(int M, int p) { return imin(kNB, M - p * kNB); }

// Leading dimension of panel p's slab in shared memory: the row slab
// (columns [0, end of p)) for fwd, the column slab (w_p wide) for bwd, each
// padded by 16 bytes, which keeps the rows 16-byte aligned for the bulk
// copies and spreads the diagonal block's columns over 8 banks (a multiple
// of 32 words would put a whole column in one bank).
template <typename T, bool kBwd>
__host__ __device__ __forceinline__ int slab_ld(int M, int p) {
  return (kBwd ? 0 : p * kNB) + panel_width(M, p) + static_cast<int>(16 / sizeof(T));
}

template <typename T, bool kBwd>
__host__ __device__ __forceinline__ size_t slab_bytes(int M, int p) {
  const size_t rows = kBwd ? M - p * kNB : panel_width(M, p);
  return rows * slab_ld<T, kBwd>(M, p) * sizeof(T);
}

// Shared-memory plan of one CTA of a C-CTA cluster over P panels.  The
// fixed part is laid out alike in every CTA, so a CTA finds another's
// published panel at the same offset.  Byte offsets.
struct TrsmPlan {
  int P, C, nown, G;  // panels, CTAs per cluster, panels per CTA at most, column groups
  int push;           // 1: x_p pushed into slot p of every CTA; 0: pulled (trsm_kernel step 5)
  int chunk_bars, ready_bars, slab_off, acc, xr, dop, slab;
  unsigned slab_cap;  // bytes of shared memory left for slabs
};

// The plan with every x_p pushed into every CTA (P x tiles) where that fixed
// part fits in smem_limit, else the one in which each CTA keeps the x of its
// own panels and pulls the others' (nown + 1 x tiles).
template <typename T>
TrsmPlan make_plan(int M, int C, int G, size_t smem_limit, bool push = true) {
  TrsmPlan q;
  q.P = (M + kNB - 1) / kNB;
  q.C = C;
  q.nown = (q.P + C - 1) / C;
  q.G = G;
  q.push = push;
  const size_t tile = static_cast<size_t>(kNB) * G * kTrsmCols * sizeof(T);
  size_t off = 0;
  q.chunk_bars = static_cast<int>(off);  // [nown][P]: slab chunk arrived
  off += static_cast<size_t>(q.nown) * q.P * 8;
  q.ready_bars = static_cast<int>(off);  // [P] if push: x_p has arrived in xr
  off += push ? static_cast<size_t>(q.P) * 8 : 0;
  q.slab_off = static_cast<int>(off);  // [nown]: byte offset of each slab, -1 = global
  off = align_up(off + static_cast<size_t>(q.nown) * 4, 16);
  q.acc = static_cast<int>(off);  // [nown][kNB][8G]: rhs, then residual
  off += q.nown * tile;
  q.xr = static_cast<int>(off);  // x tiles [kNB][8G]: [P] if push, else [nown + 1]
  off += (push ? q.P : q.nown + 1) * tile;
  q.dop = static_cast<int>(off);  // [nown][kNB][kLdd]: D_p^-1 (fwd) or D_p^-T (bwd)
  off += static_cast<size_t>(q.nown) * kNB * kLdd * sizeof(T);
  q.slab = static_cast<int>(align_up(off, 128));
  if (push && static_cast<size_t>(q.slab) > smem_limit) return make_plan<T>(M, C, G, smem_limit, false);
  q.slab_cap = smem_limit > static_cast<size_t>(q.slab)
                   ? static_cast<unsigned>(smem_limit - q.slab) : 0u;
  return q;
}

// Places CTA `rank`'s slabs greedily, in panel order, in the slab area;
// writes each offset (or -1: stays in global memory) when `off` is given.
// Returns the bytes used.
template <typename T, bool kBwd>
__host__ __device__ size_t place_slabs(const TrsmPlan& q, int M, int rank, int* off) {
  size_t used = 0;
  for (int li = 0; li < q.nown; ++li) {
    const int p = rank + li * q.C;
    const size_t b = p < q.P ? slab_bytes<T, kBwd>(M, p) : 0;
    const bool fits = p < q.P && used + b <= q.slab_cap;
    if (off) off[li] = fits ? static_cast<int>(used) : -1;
    if (fits) used += b;
  }
  return used;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for phase 0 of a barrier that bulk copies complete.  A wait that
// never ends would hang the card: after ~2^26 polls the kernel traps, and
// the launch reports an error instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  for (unsigned tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(0u)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(cta));
  return remote;
}

// Asynchronous bulk copy of `bytes` from this CTA's shared memory at `p` to
// the same offset in CTA `cta` of the cluster, completing on that CTA's
// barrier at the offset of `bar`.  The writers of `p` must have issued
// fence.proxy.async.shared::cta and passed a CTA barrier.
__device__ __forceinline__ void bulk_s2cluster(const void* p, unsigned bytes, uint64_t* bar,
                                               unsigned cta) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          cluster_addr(p, cta)),
      "r"(smem_u32(p)), "r"(bytes), "r"(cluster_addr(bar, cta))
      : "memory");
}

// Asynchronous bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Inverse of the lower triangular wp x wp diagonal block d (leading
// dimension ldd) into o ([kNB][kLdo]): D^-1 (fwd) or D^-T (bwd), zero outside
// the block's triangle, identity beyond wp.  Column j of D^-1 is the
// substitution on e_j (lane = row), with the pivots' reciprocals; warp w
// advances the four columns w, w + 8, w + 16, w + 24 together from step w
// on (the steps before a column's own index leave it unchanged, so no
// branch guards the shuffles).  d is shared or global memory: the helpers
// below are inlined where the kernel knows which, so that a resident slab is
// read with shared-memory loads and not generic ones.
template <typename T, bool kBwd, int kLdo = kLdd>
__device__ __forceinline__ void invert_diag(const T* d, int ldd, int wp, T* o) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T rcp = lane < wp ? T(1) / d[lane * ldd + lane] : T(0);
  T v[kNB / 8];
#pragma unroll
  for (int u = 0; u < kNB / 8; ++u) v[u] = (lane == warp + 8 * u) ? T(1) : T(0);
#pragma unroll 4
  for (int r = warp; r < wp; ++r) {
    const T dr = __shfl_sync(kFull, rcp, r);
    const T lr = (lane > r && lane < wp) ? d[lane * ldd + r] : T(0);
#pragma unroll
    for (int u = 0; u < kNB / 8; ++u) {
      const T xv = __shfl_sync(kFull, v[u], r) * dr;
      v[u] = (lane == r) ? xv : v[u] - lr * xv;
    }
  }
#pragma unroll
  for (int u = 0; u < kNB / 8; ++u) {
    const int j = warp + 8 * u;
    if (kBwd) o[j * kLdo + lane] = v[u];
    else o[lane * kLdo + j] = v[u];
  }
}

// r[8g] -= sum_c A(ti, c) x[c][8g] over the wp columns of the operator's
// block A, with A(i, c) = a[i * lda + c] (fwd) or a[c * lda + i] (bwd); r and
// x point at this thread's entries of its residual tile and of x_p.
template <typename T, bool kBwd, int kG>
__device__ __forceinline__ void apply_block(const T* a, int lda, int wp, int ti, const T* x,
                                            T* r) {
  constexpr int cols = kG * kTrsmCols;
  T v[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) v[g] = r[g * kTrsmCols];
#pragma unroll 8
  for (int c = 0; c < wp; ++c) {
    const T ac = kBwd ? a[c * lda + ti] : a[ti * lda + c];
#pragma unroll
    for (int g = 0; g < kG; ++g) v[g] -= ac * x[c * cols + g * kTrsmCols];
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) r[g * kTrsmCols] = v[g];
}

// X = L^-1 B (kBwd false) or X = L^-T B (kBwd true) for one matrix and the
// kG column groups of B (8 columns each) of one cluster; see the note at the
// top of the file.  Thread tid owns row ti = tid / kTrsmCols and columns
// ts + 8g (ts = tid % kTrsmCols, g < kG) of every rhs tile ([kNB][8 kG]).
// kG is a template parameter so that the loops over it unroll without
// predicates (with a runtime G the steps were 2.5x longer at (1, 488, 8));
// kPush (the plan's push) too, since the pull branch's code in the same
// kernel made the push steps ~10% longer.
template <typename T, bool kBwd, int kG, bool kPush>
__global__ void __launch_bounds__(kTrsmThreads)
    trsm_kernel(const T* __restrict__ L, const T* __restrict__ B, T* __restrict__ X, int M,
                int S, TrsmPlan q) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int cols = kG * kTrsmCols;  // rhs columns of this cluster's tiles
  constexpr int tile = kNB * cols;
  const int ncl = (S + cols - 1) / cols;  // clusters per matrix
  const int cid = blockIdx.x / q.C;
  const size_t k = cid / ncl;
  const int c0 = (cid % ncl) * cols;
  const int nc = imin(cols, S - c0);
  const T* l = L + k * M * M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ti = tid / kTrsmCols;
  const int ts = tid % kTrsmCols;
  const int own = ti * cols + ts;  // this thread's first entry of a tile

  uint64_t* chunk_bars = reinterpret_cast<uint64_t*>(smem + q.chunk_bars);
  uint64_t* ready = reinterpret_cast<uint64_t*>(smem + q.ready_bars);
  int* slab_off = reinterpret_cast<int*>(smem + q.slab_off);
  T* acc = reinterpret_cast<T*>(smem + q.acc);
  T* xr = reinterpret_cast<T*>(smem + q.xr);
  T* dop = reinterpret_cast<T*>(smem + q.dop);
  unsigned char* slab = smem + q.slab;

  // 1. barriers and slab placement; ready[p] expects one tile of bytes (x_p,
  //    copied in by p's owner).  The CTA's arrival on the cluster barrier
  //    here, and the wait before the wavefront (step 5), keep any copy from
  //    landing on a barrier that is not initialised yet, while steps 2-4 run.
  if (tid == 0) {
    place_slabs<T, kBwd>(q, M, rank, slab_off);
    for (int i = 0; i < q.nown * q.P; ++i) mbar_init(&chunk_bars[i], 1);
    for (int i = 0; kPush && i < q.P; ++i) {
      mbar_init(&ready[i], 1);
      mbar_expect_tx(&ready[i], tile * sizeof(T));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // 2. warp 0 issues the slab copies, one per row segment, chunk by chunk
  //    in the order the wavefront consumes them, the diagonal block first.
  //    fwd: then the rows' segments left of it (columns [0, start of p)),
  //    on barrier 0; bwd: then panel pq's rows, on barrier pq, for the
  //    panels the wavefront reaches before this one.  (One copy per row and
  //    32-wide chunk made the fwd issue take ~0.9 us a chunk.)
  if (warp == 0) {
    for (int li = 0; li < q.nown; ++li) {
      const int p = rank + li * q.C;
      if (p >= q.P || slab_off[li] < 0) continue;
      T* s = reinterpret_cast<T*>(slab + slab_off[li]);
      const int wp = panel_width(M, p);
      const int ld = slab_ld<T, kBwd>(M, p);
      const int nq = kBwd ? q.P - p : (p > 0 ? 2 : 1);
      for (int j = 0; j < nq; ++j) {
        const int pq = j == 0 ? p : (kBwd ? q.P - j : 0);
        const int wq = kBwd || j == 0 ? panel_width(M, pq) : p * kNB;
        uint64_t* bar = &chunk_bars[li * q.P + pq];
        // fwd: wp row segments of wq entries (rows of p, columns from pq);
        // bwd: wq row segments of wp entries (rows of pq, columns of p)
        const int nseg = kBwd ? wq : wp;
        const unsigned bytes = static_cast<unsigned>((kBwd ? wp : wq) * sizeof(T));
        if (lane == 0) mbar_expect_tx(bar, nseg * bytes);
        __syncwarp();
        for (int r = lane; r < nseg; r += 32) {
          if (kBwd)
            bulk_g2s(s + static_cast<size_t>((pq - p) * kNB + r) * ld,
                     l + static_cast<size_t>(pq * kNB + r) * M + p * kNB, bytes, bar);
          else
            bulk_g2s(s + static_cast<size_t>(r) * ld + pq * kNB,
                     l + static_cast<size_t>(p * kNB + r) * M + pq * kNB, bytes, bar);
        }
      }
    }
  }

  // 3. the CTA's rows of B into the residual tiles
  for (int li = 0; li < q.nown; ++li) {
    const int p = rank + li * q.C;
    const bool row = p < q.P && ti < panel_width(M, p);
    for (int j = ts; j < cols; j += kTrsmCols)
      acc[li * tile + own - ts + j] =
          (row && j < nc) ? B[(k * M + p * kNB + ti) * S + c0 + j] : T(0);
  }

  // 4. invert the diagonal blocks of the CTA's panels into dop
  for (int li = 0; li < q.nown; ++li) {
    const int p = rank + li * q.C;
    if (p >= q.P) break;
    T* o = dop + li * kNB * kLdd;
    if (slab_off[li] >= 0) {
      mbar_wait(&chunk_bars[li * q.P + p]);
      const T* s = reinterpret_cast<const T*>(slab + slab_off[li]);
      invert_diag<T, kBwd>(kBwd ? s : s + p * kNB, slab_ld<T, kBwd>(M, p), panel_width(M, p), o);
    } else {
      invert_diag<T, kBwd>(l + static_cast<size_t>(p * kNB) * M + p * kNB, M, panel_width(M, p),
                           o);
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // 5. the wavefront.  The owner of p forms x_p = dop_p r_p in its own slot
  //    for p.  push: it copies the slot into slot p of every other CTA, one
  //    bulk copy each, completing on that CTA's ready[p].  pull (x of every
  //    panel does not fit in each CTA): after a cluster barrier, every other
  //    CTA copies the owner's slot into its own staging tile through
  //    distributed shared memory.  Each CTA then subtracts the block (pi, p)
  //    times x_p from the residual of every panel pi it owns that the
  //    wavefront has not reached.
  T* stage = xr + q.nown * tile;  // pull: the x_p of another CTA
  for (int step = 0; step < q.P; ++step) {
    const int p = kBwd ? q.P - 1 - step : step;
    const int lp = p / q.C;  // p's slot in its owner's tiles
    const int owner = p % q.C;
    T* slot = xr + (kPush ? p : lp) * tile;
    if (rank == owner) {
      const T* o = dop + lp * kNB * kLdd + ti * kLdd;
      const T* r = acc + lp * tile + ts;
      T x[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) x[g] = T(0);
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        const T oc = o[c];
#pragma unroll
        for (int g = 0; g < kG; ++g) x[g] += oc * r[c * cols + g * kTrsmCols];
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) slot[own + g * kTrsmCols] = x[g];
      if (kPush) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        // the copies leave one after another (~30 ns each): the owner of the
        // next panel in wavefront order gets the first
        if (tid < q.C - 1)
          bulk_s2cluster(slot, tile * sizeof(T), &ready[p],
                         (rank + (kBwd ? q.C - 1 - tid : 1 + tid)) % q.C);
      }
    } else if (kPush) {
      mbar_wait(&ready[p]);
    }
    if constexpr (!kPush) {
      // the barrier also ends this CTA's reads of stage in the step before
      cluster.sync();
      if (rank != owner) {
        const T* src = cluster.map_shared_rank(slot, owner);
        for (int i = tid; i < tile; i += kTrsmThreads) stage[i] = src[i];
        __syncthreads();
        slot = stage;
      }
    }
    const T* x = slot + ts;
    const int wp = panel_width(M, p);
    for (int li = 0; li < q.nown; ++li) {
      const int pi = rank + li * q.C;
      if (pi >= q.P) break;
      if (kBwd ? pi >= p : pi <= p) continue;  // solved already, or p itself
      // the block of the operator at (pi, p): fwd L[pi*32+i][p*32+c], from
      // the row slab; bwd L^T[pi*32+i][p*32+c] = L[p*32+c][pi*32+i], from
      // the column slab
      T* r = acc + li * tile + own;
      if (slab_off[li] >= 0) {
        mbar_wait(&chunk_bars[li * q.P + (kBwd ? p : 0)]);
        const T* s = reinterpret_cast<const T*>(slab + slab_off[li]);
        const int lda = slab_ld<T, kBwd>(M, pi);
        if (ti < panel_width(M, pi))
          apply_block<T, kBwd, kG>(kBwd ? s + static_cast<size_t>((p - pi) * kNB) * lda
                                        : s + p * kNB,
                                   lda, wp, ti, x, r);
      } else if (ti < panel_width(M, pi)) {
        apply_block<T, kBwd, kG>(kBwd ? l + static_cast<size_t>(p * kNB) * M + pi * kNB
                                      : l + static_cast<size_t>(pi * kNB) * M + p * kNB,
                                 M, wp, ti, x, r);
      }
    }
    // only the next panel's owner reads other threads' residual entries
    if (step + 1 < q.P && rank == (kBwd ? p - 1 : p + 1) % q.C) __syncthreads();
  }

  // 6. the owned panels' x to global memory; no CTA leaves while a copy out
  //    of its shared memory may still be in flight
  for (int li = 0; li < q.nown; ++li) {
    const int p = rank + li * q.C;
    if (p < q.P && ti < panel_width(M, p))
      for (int j = ts; j < nc; j += kTrsmCols)
        X[(k * M + p * kNB + ti) * S + c0 + j] = xr[(kPush ? p : li) * tile + own - ts + j];
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Cholesky, one CTA per matrix: resident and streaming forms
// ---------------------------------------------------------------------------

// Row stride of 32-wide blocks whose rows are read as 16-byte vectors by
// one thread per row: 32 + 16 bytes, so that a warp's vector loads of 32
// consecutive rows spread over all banks.
template <typename T>
constexpr int kLdv = kNB + static_cast<int>(16 / sizeof(T));

template <typename T>
struct Vec16;  // 16 bytes of T: the width of one vector load
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// Packed lower triangle of the resident form: block row I (rows 32I ..
// 32I + 31) keeps columns [0, 32(I + 1)) of each row, with a row stride of
// 32(I + 1) + 16 bytes (rows stay 16-byte aligned for the bulk copies, and
// the pad spreads a tile's rows over the banks).  Offset of row i, in T.
template <typename T>
__host__ __device__ __forceinline__ size_t packed_row(int i) {
  const size_t I = i >> 5, r = i & 31, pad = 16 / sizeof(T);
  return 32 * (16 * I * (I + 1) + pad * I) + r * (32 * (I + 1) + pad);
}

template <typename T>
__host__ __device__ __forceinline__ int packed_ld(int I) {
  return 32 * (I + 1) + static_cast<int>(16 / sizeof(T));
}

// Shared memory of one CTA: an mbarrier (16 bytes), the inverted diagonal
// block ([kNB][kLdv]), the diagonal block itself ([kNB][kLdd], streaming
// form only), kc rows of W^T (the panel below the diagonal, transposed:
// [kc][32(P - 1)]), rs staged panel rows ([rs][kLdv], streaming form only)
// and the packed triangle (resident form only).  Bytes.
template <typename T>
size_t chol_smem(int M, bool resident, int kc, int rs) {
  const size_t P = (M + kNB - 1) / kNB;
  size_t b = 16 + sizeof(T) * (kNB * kLdv<T> + (resident ? 0 : kNB * kLdd) +
                               static_cast<size_t>(kc) * (P - 1) * kNB +
                               static_cast<size_t>(rs) * kLdv<T>);
  if (resident) b += sizeof(T) * packed_row<T>(M);
  return b;
}

// Row i of the factor being formed: the packed triangle in shared memory
// (resident) or a row-major (M, M) matrix in global memory (streaming, and
// the large form).
template <typename T, bool kRes>
__device__ __forceinline__ T* chol_row(T* base, int M, int i) {
  return kRes ? base + packed_row<T>(i) : base + static_cast<size_t>(i) * M;
}

__device__ __forceinline__ void unpack(const float4& q, float* v) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void unpack(const double2& q, double* v) { v[0] = q.x, v[1] = q.y; }
__device__ __forceinline__ float4 pack(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ double2 pack(const double* v) { return make_double2(v[0], v[1]); }

// n consecutive T (n a multiple of the vector width, p 16-byte aligned)
// through 16-byte vectors, to and from registers
template <typename T, int n>
__device__ __forceinline__ void load_vec(const T* p, T* v) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < n / kV; ++u) unpack(reinterpret_cast<const V*>(p)[u], v + u * kV);
}

template <typename T, int n>
__device__ __forceinline__ void store_vec(T* p, const T* v) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < n / kV; ++u) reinterpret_cast<V*>(p)[u] = pack(v + u * kV);
}

// The pivot of a column: d <= clamp (or NaN) is frozen at 1e20, as
// _chol_value (dense_kernels.py:69-112) does.  Returns L_jj = sqrt(d),
// correctly rounded; *inv = 1 / L_jj, correctly rounded, so that the
// column's multipliers are d_i * (1 / L_jj) as in the plain version.  (The
// kernels before took L_jj = d * rsqrt(d) with MUFU.RSQ's 2-ulp rsqrt and
// scaled by that rsqrt; a CPU rehearsal on a sphere2500 separator puts a
// pivot 1-2 ulp off at 3x the solve error of an exact one, PERF.md.)
template <typename T>
__device__ __forceinline__ T pivot(T d, T clamp, T* inv) {
  d = (d > clamp) ? d : T(1e20);
  const T ljj = sqrt_t(d);
  *inv = T(1) / ljj;
  return ljj;
}

// Factors the w x w diagonal block at rows/columns [j0, j0 + w) of src into
// dst (warp 0; lane r holds row r in registers, rows beyond w are identity;
// zeros right of the diagonal) and into dcopy ([kNB][kLdd]) when given.
// Right-looking, one column per step, its multipliers scaled by 1 / L_jj;
// the column is broadcast by shuffles.  The next column's pivot is taken as
// soon as its diagonal entry is updated, so that its square root overlaps
// the rest of the step.  src may be dst.
template <typename T, bool kRes>
__device__ __forceinline__ void chol_diag(const T* src, T* dst, T* dcopy, int M, int j0, int w,
                                          T clamp) {
  const int lane = threadIdx.x & 31;
  T d[kNB];
  if (lane < w) {
    const T* row = chol_row<T, kRes>(const_cast<T*>(src), M, j0 + lane) + j0;
#pragma unroll
    for (int c = 0; c < kNB; c += 8)
      if (c < w) load_vec<T, 8>(row + c, d + c);
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    if (lane >= w) d[c] = (c == lane) ? T(1) : T(0);
    else if (c > lane) d[c] = T(0);
  }
  T inv;
  T ljj = pivot(__shfl_sync(kFull, d[0], 0), clamp, &inv);
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const T lrj = lane == j ? ljj : (lane > j ? d[j] * inv : T(0));
    d[j] = lrj;
    if (j + 1 < kNB) {
      d[j + 1] -= lrj * __shfl_sync(kFull, lrj, j + 1);
      ljj = pivot(__shfl_sync(kFull, d[j + 1], j + 1), clamp, &inv);
    }
#pragma unroll
    for (int k = j + 2; k < kNB; ++k) d[k] -= lrj * __shfl_sync(kFull, lrj, k);
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (c > lane) d[c] = T(0);
  if (lane < w) {
    T* row = chol_row<T, kRes>(dst, M, j0 + lane) + j0;
#pragma unroll
    for (int c = 0; c < kNB; c += 8)
      if (c < w) store_vec<T, 8>(row + c, d + c);
  }
  if (dcopy) {
#pragma unroll
    for (int c = 0; c < kNB; ++c) dcopy[lane * kLdd + c] = d[c];
  }
}

// One row of the panel, W = a L_d^-T (a: the row's 32 entries of the
// block column, in place; null for a padding row, whose W is 0): held in
// registers and overwritten from the last column down (W[c] needs a[t],
// t <= c), with the rows of dinv ([kNB][kLdv], L_d^-1) read as broadcast
// 16-byte vectors.  Also into wt[t * ldw] (W^T) when wt is given.
template <typename T>
__device__ __forceinline__ void panel_row(T* a, const T* dinv, T* wt, int ldw) {
  constexpr int kV = 16 / sizeof(T);
  T x[kNB];
  if (a) {
    load_vec<T, kNB>(a, x);
#pragma unroll
    for (int c = kNB - 1; c >= 0; --c) {
      T y = T(0);
#pragma unroll
      for (int t0 = 0; t0 <= c; t0 += kV) {
        T q[kV];
        load_vec<T, kV>(dinv + c * kLdv<T> + t0, q);
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if (t0 + e <= c) y += x[t0 + e] * q[e];
      }
      x[c] = y;
    }
    store_vec<T, kNB>(a, x);
  } else {
#pragma unroll
    for (int c = 0; c < kNB; ++c) x[c] = T(0);
  }
  if (wt) {
#pragma unroll
    for (int t = 0; t < kNB; ++t) wt[t * ldw] = x[t];
  }
}

// The panel below the diagonal block, rows [j1, Mp) (rows from M on are
// padding, 0 in W^T).  Resident: one thread per row, in place in the packed
// triangle.  Streaming: rs rows at a time are staged in S ([rs][kLdv]) with
// coalesced 16-byte copies from and back to global memory, so that the
// thread of a row reads it from shared memory.
template <typename T, bool kRes>
__device__ __forceinline__ void chol_panel(const T* src, T* dst, T* S, int rs, const T* dinv,
                                           T* wt, int ldw, int M, int Mp, int j0) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kPerRow = kNB / kV;  // vectors in a row's 32 entries
  const int tid = threadIdx.x;
  const int j1 = j0 + kNB;
  if constexpr (kRes) {
    for (int i = j1 + tid; i < Mp; i += kCholThreads)
      panel_row<T>(i < M ? dst + packed_row<T>(i) + j0 : nullptr, dinv, wt ? wt + i - j1 : nullptr,
                   ldw);
    return;
  }
  for (int r0 = j1; r0 < Mp; r0 += rs) {
    const int n = imin(rs, Mp - r0);
    if (r0 > j1) __syncthreads();  // the copy-out of the chunk before has read S
    for (int idx = tid; idx < n * kPerRow; idx += kCholThreads) {
      const int r = idx / kPerRow, q = idx - r * kPerRow;
      reinterpret_cast<V*>(S + r * kLdv<T>)[q] =
          r0 + r < M ? reinterpret_cast<const V*>(src + static_cast<size_t>(r0 + r) * M + j0)[q]
                     : V{};
    }
    __syncthreads();
    if (tid < n) panel_row<T>(S + tid * kLdv<T>, dinv, wt ? wt + r0 + tid - j1 : nullptr, ldw);
    __syncthreads();
    for (int idx = tid; idx < n * kPerRow; idx += kCholThreads) {
      const int r = idx / kPerRow, q = idx - r * kPerRow;
      if (r0 + r < M)
        reinterpret_cast<V*>(dst + static_cast<size_t>(r0 + r) * M + j0)[q] =
            reinterpret_cast<const V*>(S + r * kLdv<T>)[q];
    }
  }
}

// Trailing update of the lower triangle right of panel p, depth `depth`
// (the kc columns of W^T in wt): each warp takes the 32 x 32 tiles (I, J),
// p < J <= I, in turn; lane (ry, cx) keeps rows 4ry .. 4ry + 3 and columns
// 8cx .. 8cx + 7 of the tile in registers and at each depth step loads its
// 4 + 8 entries of W^T as 16-byte vectors for 32 FMAs.  The depth's
// products of an entry are summed from zero and subtracted from it once,
// as the plain version's A -= W W^T does: subtracting each product from the
// entry in turn rounds at the entry's magnitude once per column, which
// made the f32 factor 4-5x less accurate than the plain version at the
// sphere2500 separator (PERF.md).  The depth loop is unrolled by 2 only: a
// deeper unroll hoists the W^T loads of many steps into registers and
// spills.
template <typename T, bool kRes>
__device__ __forceinline__ void chol_trailing(const T* src, T* dst, const T* wt, int ldw, int depth,
                                              int M, int P, int p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ry = lane & 7, cx = lane >> 3;
  const int j1 = (p + 1) * kNB;
  int I = p + 1, J = p + 1 + warp;  // tile `warp` of the row-major order
  while (J > I && I < P) J -= I - p, ++I;
  for (; I < P;) {
    const int r0 = I * kNB + 4 * ry;
    const int c0 = J * kNB + 8 * cx;
    T acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = T(0);
    const T* wr = wt + r0 - j1;
    const T* wc = wt + c0 - j1;
#pragma unroll 2
    for (int t = 0; t < depth; ++t) {
      T x[4], y[8];
      load_vec<T, 4>(wr + t * ldw, x);
      load_vec<T, 8>(wc + t * ldw, y);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] += x[a] * y[b];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (r0 + a >= M || c0 >= M) continue;
      T v[8];
      load_vec<T, 8>(chol_row<T, kRes>(const_cast<T*>(src), M, r0 + a) + c0, v);
#pragma unroll
      for (int b = 0; b < 8; ++b) v[b] -= acc[a][b];
      T* row = chol_row<T, kRes>(dst, M, r0 + a) + c0;
      if (I != J || c0 + 7 <= r0 + a) {
        store_vec<T, 8>(row, v);
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (c0 + b <= r0 + a) row[b] = v[b];
      }
    }
    J += kCholThreads / 32;
    while (J > I && I < P) J -= I - p, ++I;
  }
}

// Right-looking blocked Cholesky of one (M, M) matrix per CTA in 32-wide
// panels; see the note at the top of the file.  A and L are not
// __restrict__: with it the compiler read the factor, which the kernel
// writes, through the non-coherent read-only path.  kRes: the packed lower
// triangle is resident in shared memory (loaded once by bulk copies,
// written back once); else the factor is formed in place in the output
// (L2-resident).  kc: the depth of W^T staged at once (32, or 16 / 8 where
// 32 rows of W^T do not fit beside the rest); rs: the panel rows staged at
// once (streaming only).
template <typename T, bool kRes>
__global__ void __launch_bounds__(kCholThreads)
    chol_kernel(const T* A, T* L, int M, int kc, int rs, T clamp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = (M + kNB - 1) / kNB;
  const int Mp = P * kNB;
  const int ldw = Mp - kNB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* sDi = reinterpret_cast<T*>(smem + 16);     // [kNB][kLdv]: L_d^-1
  T* sD = sDi + kNB * kLdv<T>;                  // [kNB][kLdd]: L_d (streaming)
  T* sWt = sD + (kRes ? 0 : kNB * kLdd);        // [kc][ldw]: W^T
  T* sS = sWt + static_cast<size_t>(kc) * ldw;  // [rs][kLdv]: staged panel rows (streaming)
  T* sL = sS + static_cast<size_t>(rs) * kLdv<T>;  // packed triangle (resident)
  const size_t base = static_cast<size_t>(blockIdx.x) * M * M;
  const T* a = A + base;
  T* l = L + base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kCholThreads / 32;
  constexpr int kV = 16 / sizeof(T);

  if constexpr (kRes) {
    // the lower triangle (each row up to the end of its diagonal block) in
    // one bulk copy per row, on one barrier
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {
      if (lane == 0) {
        const unsigned full = M / kNB;  // block rows of 32 rows
        mbar_expect_tx(bar, static_cast<unsigned>(
            (512u * full * (full + 1) + (M - full * kNB) * static_cast<unsigned>(M)) * sizeof(T)));
      }
      __syncwarp();
      for (int i = lane; i < M; i += 32)
        bulk_g2s(sL + packed_row<T>(i), a + static_cast<size_t>(i) * M,
                 static_cast<unsigned>(imin(kNB * ((i >> 5) + 1), M) * sizeof(T)), bar);
    }
    mbar_wait(bar);
  } else {
    // zeros right of each row's diagonal block; everything else is written
    // by the panel steps (panel 0 reads A, later panels the output)
    for (int i = warp; i < M; i += kWarps) {
      T* row = l + static_cast<size_t>(i) * M;
      for (int c = kNB * ((i >> 5) + 1) + lane * kV; c < M; c += 32 * kV)
        *reinterpret_cast<typename Vec16<T>::type*>(row + c) = typename Vec16<T>::type{};
    }
  }

  T* fac = kRes ? sL : l;
  for (int p = 0; p < P; ++p) {
    const int j0 = p * kNB;
    const int w = imin(kNB, M - j0);
    const T* src = kRes ? sL : (p == 0 ? a : l);
    // 1. the diagonal block (warp 0), then its inverse (warps 0-7)
    if (warp == 0) chol_diag<T, kRes>(src, fac, kRes ? nullptr : sD, M, j0, w, clamp);
    __syncthreads();
    if (warp < 8) {
      if constexpr (kRes)
        invert_diag<T, false, kLdv<T>>(sL + packed_row<T>(j0) + j0, packed_ld<T>(p), w, sDi);
      else
        invert_diag<T, false, kLdv<T>>(sD, kLdd, w, sDi);
    }
    __syncthreads();
    // 2. the panel below it
    chol_panel<T, kRes>(src, fac, sS, rs, sDi, kc == kNB ? sWt : nullptr, ldw, M, Mp, j0);
    __syncthreads();
    // 3. the trailing update, kc columns of W^T at a time
    if (p + 1 < P) {
      const int j1 = j0 + kNB;
      for (int t0 = 0; t0 < kNB; t0 += kc) {
        if (kc < kNB) {
          if (t0 > 0) __syncthreads();
          const int nrows = Mp - j1;
          for (int idx = tid; idx < kc * nrows; idx += kCholThreads) {
            const int r = idx / kc, t = idx - r * kc;
            sWt[t * ldw + r] = j1 + r < M ? l[static_cast<size_t>(j1 + r) * M + j0 + t0 + t] : T(0);
          }
          __syncthreads();
        }
        chol_trailing<T, kRes>(t0 == 0 ? src : fac, fac, sWt, ldw, kc, M, P, p);
      }
    }
    __syncthreads();
  }

  if constexpr (kRes) {
    // L once: the packed rows, zeros above the diagonal
    for (int i = warp; i < M; i += kWarps) {
      const T* s = sL + packed_row<T>(i);
      T* row = l + static_cast<size_t>(i) * M;
      for (int c = lane * kV; c < M; c += 32 * kV) {
        T v[kV];
#pragma unroll
        for (int e = 0; e < kV; ++e) v[e] = c + e <= i ? s[c + e] : T(0);
        store_vec<T, kV>(row + c, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cholesky, large form: the whole card, one cooperative launch
// ---------------------------------------------------------------------------

constexpr int kBigThreads = 256;
constexpr int kTile = 64;  // trailing-update tiles: 64 x 64, 4 x 4 per thread

// Row stride of a transposed 64-row block of W in shared memory: rows stay
// 16-byte aligned for the vector loads of the update.
template <typename T>
constexpr int kLdt = kTile + static_cast<int>(16 / sizeof(T));

// One row of the panel in place: W = a L_d^-T by substitution, column by
// column, each W[c] = (a[c] - sum_{t < c} W[t] L_d[c][t]) / L_d[c][c] as
// the plain version's _trsm_right_T_value (dense_kernels.py) forms it, with
// the rows of L_d ([kNB][kLdv] in shared memory) read as broadcast 16-byte
// vectors.
template <typename T>
__device__ __forceinline__ void panel_solve_row(T* a, const T* sD) {
  constexpr int kV = 16 / sizeof(T);
  T x[kNB];
  load_vec<T, kNB>(a, x);
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    T y = x[c];
#pragma unroll
    for (int t0 = 0; t0 <= c; t0 += kV) {
      T q[kV];
      load_vec<T, kV>(sD + c * kLdv<T> + t0, q);
#pragma unroll
      for (int e = 0; e < kV; ++e)
        if (t0 + e < c) y -= x[t0 + e] * q[e];
      if (t0 + kV > c) x[c] = y / q[c - t0];
    }
  }
  store_vec<T, kNB>(a, x);
}

// 64 rows of W (columns [j0, j0 + 32) of rows [r0, r0 + 64) of l; zeros
// from row M on), transposed into w ([kNB][kLdt]).
template <typename T>
__device__ __forceinline__ void load_wt(const T* l, int M, int j0, int r0, T* w) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kPerRow = kNB / kV;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kBigThreads) {
    const int r = idx / kPerRow, q = idx - r * kPerRow;
    T v[kV];
    if (r0 + r < M) {
      load_vec<T, kV>(l + static_cast<size_t>(r0 + r) * M + j0 + q * kV, v);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) v[e] = T(0);
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) w[(q * kV + e) * kLdt<T> + r] = v[e];
  }
}

// The tile of rows [r0, r0 + 64) and columns [c0, c0 + 64) of l minus W_r
// W_c^T, the 32 columns of the panel at j0 (diag: r0 == c0, the lower
// triangle only).  Thread (ty, tx) of a 16 x 16 grid keeps rows r0 + 4ty ..
// + 3 and columns c0 + 4tx .. + 3 in registers: per depth step two 16-byte
// (f32) shared loads of W^T for 16 FMAs.  The 32 products of an entry are
// summed from zero and subtracted once.
template <typename T>
__device__ __forceinline__ void trailing_tile(T* l, int M, int j0, int r0, int c0, T* sWr,
                                              T* sWc) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const bool diag = r0 == c0;
  __syncthreads();  // the tile before has read sWr / sWc
  load_wt<T>(l, M, j0, r0, sWr);
  if (!diag) load_wt<T>(l, M, j0, c0, sWc);
  __syncthreads();
  const T* wc = diag ? sWr : sWc;
  T s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = T(0);
#pragma unroll 8
  for (int t = 0; t < kNB; ++t) {
    T x[4], y[4];
    load_vec<T, 4>(sWr + t * kLdt<T> + 4 * ty, x);
    load_vec<T, 4>(wc + t * kLdt<T> + 4 * tx, y);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] += x[a] * y[b];
  }
  const int c = c0 + 4 * tx;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 4 * ty + a;
    if (r >= M || c >= M || (diag && c > r)) continue;
    T* p = l + static_cast<size_t>(r) * M + c;
    T v[4];
    load_vec<T, 4>(p, v);
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b] -= s[a][b];
    if (!diag || c + 3 <= r) {
      store_vec<T, 4>(p, v);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b <= r) p[b] = v[b];
    }
  }
}

// Right-looking blocked Cholesky of K (M, M) matrices on every SM: the
// factor is formed in place in L (global memory, L2-resident as far as it
// fits), in 32-wide panels; see the note at the top of the file.  Work is
// spread over the grid as items, (matrix, 256 panel rows) and (matrix,
// trailing tile), and the phases are separated by grid-wide barriers of the
// cooperative launch:
//   0. L = the lower triangle of A, zeros above; each matrix's first
//      diagonal block is factored from A by warp 0 of one CTA;
//   per panel p with rows below it:
//   1. each CTA with panel rows loads the factored diagonal block L_d and
//      solves its rows (one per thread) in place;            -- grid sync
//   2. the trailing update of the lower triangle right of the panel in
//      64 x 64 tiles; the CTA of tile (0, 0), which holds the next diagonal
//      block, factors that block right after its update, so phase 1 of the
//      next panel finds it ready.                            -- grid sync
template <typename T>
__global__ void __launch_bounds__(kBigThreads, 2)
    chol_big_kernel(const T* A, T* L, int K, int M, T clamp) {
  __shared__ __align__(16) T sD[kNB * kLdv<T>];
  __shared__ __align__(16) T sWr[kNB * kLdt<T>];
  __shared__ __align__(16) T sWc[kNB * kLdt<T>];
  cg::grid_group grid = cg::this_grid();
  constexpr int kV = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  const size_t MM = static_cast<size_t>(M) * M;
  const int P = (M + kNB - 1) / kNB;

  // 0. the lower triangle of A into L (16-byte vectors; M is a multiple of
  //    8, so a vector never crosses a row), but the first diagonal blocks
  const size_t nvec = static_cast<size_t>(K) * MM / kV;
  for (size_t v = static_cast<size_t>(b) * kBigThreads + tid; v < nvec;
       v += static_cast<size_t>(nb) * kBigThreads) {
    const size_t off = (v * kV) % MM;
    const int i = static_cast<int>(off / M), c = static_cast<int>(off % M);
    if (i < kNB && c < kNB) continue;
    T x[kV];
    if (c <= i) {
      load_vec<T, kV>(A + v * kV, x);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) x[e] = T(0);
    }
#pragma unroll
    for (int e = 0; e < kV; ++e)
      if (c + e > i) x[e] = T(0);
    store_vec<T, kV>(L + v * kV, x);
  }
  if (warp == 0)
    for (int k = b; k < K; k += nb)
      chol_diag<T, false>(A + k * MM, L + k * MM, nullptr, M, 0, imin(kNB, M), clamp);
  grid.sync();

  for (int p = 0; p + 1 < P; ++p) {
    const int j0 = p * kNB, j1 = j0 + kNB;
    // 1. the panel rows [j1, M) of each matrix, kBigThreads rows per item
    const int chunks = (M - j1 + kBigThreads - 1) / kBigThreads;
    int loaded = -1;
    for (int it = b; it < K * chunks; it += nb) {
      const int k = it / chunks;
      T* l = L + k * MM;
      if (k != loaded) {
        __syncthreads();  // the rows of the matrix before have read sD
        for (int idx = tid; idx < kNB * (kNB / kV); idx += kBigThreads) {
          const int r = idx / (kNB / kV), q = idx - r * (kNB / kV);
          T x[kV];
          load_vec<T, kV>(l + static_cast<size_t>(j0 + r) * M + j0 + q * kV, x);
          store_vec<T, kV>(sD + r * kLdv<T> + q * kV, x);
        }
        __syncthreads();
        loaded = k;
      }
      const int r = j1 + (it - k * chunks) * kBigThreads + tid;
      if (r < M) panel_solve_row<T>(l + static_cast<size_t>(r) * M + j0, sD);
    }
    grid.sync();
    // 2. the trailing update, tile (I, J), J <= I, of nt x nt per matrix
    const int nt = (M - j1 + kTile - 1) / kTile;
    const int per = nt * (nt + 1) / 2;
    for (int it = b; it < K * per; it += nb) {
      const int k = it / per, t = it - k * per;
      int I = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (I * (I + 1) / 2 > t) --I;
      while ((I + 1) * (I + 2) / 2 <= t) ++I;
      const int J = t - I * (I + 1) / 2;
      T* l = L + k * MM;
      trailing_tile<T>(l, M, j0, j1 + I * kTile, j1 + J * kTile, sWr, sWc);
      if (t == 0) {
        __syncthreads();  // the tile's stores are visible to warp 0
        if (warp == 0) chol_diag<T, false>(l, l, nullptr, M, j1, imin(kNB, M - j1), clamp);
      }
    }
    grid.sync();
  }
}

int optin_smem(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// The least M that takes the large form, for K matrices: below it one CTA
// per matrix (streaming) is faster, from it on the large form is.  Both
// forms side by side on an H100 (device ms, K in {1, 2, 8, 17, 40}, M from
// 296 to 640; scripts/chol_forms_ab.py, PERF.md): f32 streaming wins up to
// M = 392 at K <= 2 and up to 440 at K = 8 ((40, 320): 0.176 against
// 0.328), the large form from 440 (K <= 2) and 488 (K = 8; (1, 488): 0.381
// against 0.466); in f64 the large form wins from 296-320 at K <= 2 and
// from 392 at K >= 8 ((17, 320): 0.338 streaming against 0.408).  More
// matrices favour one CTA each: at K = 40 streaming wins up to 640 (f32)
// and 560 (f64).
template <typename T>
int chol_large_from(int K) {
  if (sizeof(T) == 4) return K >= 8 ? 488 : 392;
  return K >= 8 ? 392 : 296;
}

// The form of one (K, M, dtype) on a device: resident where the packed
// triangle fits beside the rest in the 227 KB opt-in (f32 M <= 288, f64 M
// <= 192 on an H100); below chol_large_from(K) streaming, with the deepest
// W^T that fits beside at least 32 staged panel rows and as many staged
// rows (multiples of 32, up to one per thread) as then fit; else the large
// form on a grid of `grid` CTAs, as many as the card holds at once (a
// cooperative launch needs them all resident).
enum class CholForm { kResident, kStreaming, kLarge };

struct CholLaunch {
  CholForm form;
  int kc, rs;
  size_t smem;
  int grid;
};

template <typename T>
using CholKernel = void (*)(const T*, T*, int, int, int, T);

template <typename T>
int plan_chol(int K, int M, CholLaunch* out) {
  int optin = 0;
  if (int err = optin_smem(&optin)) return err;
  const size_t cap = static_cast<size_t>(optin);
  for (CholKernel<T> kernel : {chol_kernel<T, true>, chol_kernel<T, false>})
    if (cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
      return static_cast<int>(err);
  if (chol_smem<T>(M, true, kNB, 0) <= cap) {
    *out = {CholForm::kResident, kNB, 0, chol_smem<T>(M, true, kNB, 0), 0};
    return 0;
  }
  if (M < chol_large_from<T>(K)) {
    const int rows = (M + kNB - 1) / kNB * kNB - kNB;  // panel rows below the first block
    for (int kc = kNB; kc >= 8; kc /= 2) {
      int rs = imin(kCholThreads, rows);
      while (rs > kNB && chol_smem<T>(M, false, kc, rs) > cap) rs -= kNB;
      if (chol_smem<T>(M, false, kc, rs) <= cap) {
        *out = {CholForm::kStreaming, kc, rs, chol_smem<T>(M, false, kc, rs), 0};
        return 0;
      }
    }
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_big_kernel<T>,
                                                        kBigThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = {CholForm::kLarge, 0, 0, 0, sms * per_sm};
  return 0;
}

template <typename T>
int launch_chol(const void* A, void* L, int K, int M, double clamp, void* stream) {
  static std::mutex mu;
  static std::map<std::array<int, 3>, CholLaunch> plans;
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  CholLaunch c;
  {
    std::lock_guard<std::mutex> lock(mu);
    const std::array<int, 3> key = {dev, K, M};
    auto it = plans.find(key);
    if (it == plans.end()) {
      if (int err = plan_chol<T>(K, M, &c)) return err;
      it = plans.emplace(key, c).first;
    }
    c = it->second;
  }
  const T* a = static_cast<const T*>(A);
  T* l = static_cast<T*>(L);
  T cl = static_cast<T>(clamp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c.form == CholForm::kLarge) {
    void* args[] = {&a, &l, &K, &M, &cl};
    if (cudaError_t err = cudaLaunchCooperativeKernel(
            reinterpret_cast<void*>(chol_big_kernel<T>), dim3(c.grid), dim3(kBigThreads), args, 0, s))
      return static_cast<int>(err);
  } else if (c.form == CholForm::kResident) {
    chol_kernel<T, true><<<K, kCholThreads, c.smem, s>>>(a, l, M, c.kc, c.rs, cl);
  } else {
    chol_kernel<T, false><<<K, kCholThreads, c.smem, s>>>(a, l, M, c.kc, c.rs, cl);
  }
  return static_cast<int>(cudaGetLastError());
}

// The form plan_chol takes for (K, M) on the current device: 0 resident,
// 1 streaming, 2 large.
template <typename T>
int chol_form(int K, int M, int* out) {
  CholLaunch c;
  if (int err = plan_chol<T>(K, M, &c)) return err;
  *out = static_cast<int>(c.form);
  return 0;
}

// The largest M of the resident form on the current device (0 if none).
template <typename T>
int resident_max_m(int* out) {
  int optin = 0;
  if (int err = optin_smem(&optin)) return err;
  *out = 0;
  for (int M = 8; chol_smem<T>(M, true, kNB, 0) <= static_cast<size_t>(optin); M += 8) *out = M;
  return 0;
}

// The kernel of a plan.  A launch chooses G from kGroupChoices, and pulls
// x_p only with G = 1 (at large M): each choice is one more kernel to build.
// The port's right-hand sides have one group (S <= 8) or six (the dense
// frames' S = 48), where G = 6 (f32) and G = 3 (f64) take the fewest waves;
// G = 2 was never chosen there.
template <typename T>
using TrsmKernel = void (*)(const T*, const T*, T*, int, int, TrsmPlan);

constexpr int kGroupChoices[] = {1, 3, 6};

template <typename T, bool kBwd>
TrsmKernel<T> trsm_kernel_for(int G, bool push) {
  if (!push) return trsm_kernel<T, kBwd, 1, false>;
  switch (G) {
    case 1: return trsm_kernel<T, kBwd, 1, true>;
    case 3: return trsm_kernel<T, kBwd, 3, true>;
    default: return trsm_kernel<T, kBwd, 6, true>;
  }
}

// A launch: the plan, its grid of CTAs and its dynamic shared memory.
struct TrsmLaunch {
  TrsmPlan q;
  unsigned ctas;
  size_t smem;
};

template <typename T, bool kBwd>
bool make_launch(const TrsmPlan& q, int K, int M, int S, TrsmLaunch* out) {
  const int ncg = (S + kTrsmCols - 1) / kTrsmCols;
  const long long ctas = static_cast<long long>(K) * ((ncg + q.G - 1) / q.G) * q.C;
  if (ctas > 0x7fffffffLL) return false;
  size_t used = 0;
  for (int r = 0; r < q.C; ++r) {
    const size_t u = place_slabs<T, kBwd>(q, M, r, nullptr);
    used = u > used ? u : used;
  }
  *out = {q, static_cast<unsigned>(ctas), q.slab + used};
  return true;
}

void set_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, const TrsmLaunch& l,
                void* stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.q.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(kTrsmThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Launch plan on the current device, setting the kernels' attributes there.
// For G column groups per cluster, the cluster size is C = min(ceil(M / 32),
// 16), lowered while the card reports that no cluster of that size fits.  G
// is the choice whose K x ceil(groups / G) clusters take the fewest waves of
// the clusters the card holds at once (the least G among equals): more
// groups per cluster share one slab load and wavefront where the grid would
// not fit on the card at once, and cost shared memory (the x tiles grow with
// G) and longer steps.  A plan that pulls x_p takes G = 1 only.
// cudaErrorInvalidValue where no plan fits.
template <typename T, bool kBwd>
int plan_trsm(int K, int M, int S, TrsmLaunch* out) {
  int optin = 0;
  if (int err = optin_smem(&optin)) return err;
  const int ncg = (S + kTrsmCols - 1) / kTrsmCols;
  long long best = -1;  // waves of the plan in *out
  int prev = 0;         // clusters per matrix of the choice before
  for (int G : kGroupChoices) {
    const int per = (ncg + G - 1) / G;  // clusters per matrix
    if (per == prev) continue;          // a larger G for as many clusters
    prev = per;
    int active = 0;
    TrsmLaunch t;
    for (int C = imin((M + kNB - 1) / kNB, kMaxCluster); C >= 1 && !active; --C) {
      if (!make_launch<T, kBwd>(make_plan<T>(M, C, G, static_cast<size_t>(optin)), K, M, S, &t))
        return static_cast<int>(cudaErrorInvalidConfiguration);
      if (t.smem > static_cast<size_t>(optin) || (!t.q.push && G > 1)) continue;
      auto kernel = trsm_kernel_for<T, kBwd>(G, t.q.push);
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      set_config(cfg, attr, t, nullptr);
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (!active) break;  // a larger G needs more shared memory still
    const long long clusters = static_cast<long long>(K) * per;
    const long long waves = (clusters + active - 1) / active;
    if (best < 0 || waves < best) {
      best = waves;
      *out = t;
    }
  }
  return best < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Launches with the plan of (device, K, M, S), made on its first use and
// kept: the occupancy queries and attribute calls cost microseconds of host
// time, more than the launch itself.
template <typename T, bool kBwd>
int launch_trsm(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, TrsmLaunch> plans;
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  TrsmLaunch l;
  {
    std::lock_guard<std::mutex> lock(mu);
    const std::array<int, 4> key = {dev, K, M, S};
    auto it = plans.find(key);
    if (it == plans.end()) {
      if (int err = plan_trsm<T, kBwd>(K, M, S, &l)) return err;
      it = plans.emplace(key, l).first;
    }
    l = it->second;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  set_config(cfg, attr, l, stream);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, trsm_kernel_for<T, kBwd>(l.q.G, l.q.push), static_cast<const T*>(L),
                         static_cast<const T*>(B), static_cast<T*>(X), M, S, l.q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slampp_chol_f32(const void* A, void* L, int K, int M, double clamp, void* stream) {
  return launch_chol<float>(A, L, K, M, clamp, stream);
}
int slampp_chol_f64(const void* A, void* L, int K, int M, double clamp, void* stream) {
  return launch_chol<double>(A, L, K, M, clamp, stream);
}
int slampp_trsm_fwd_f32(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  return launch_trsm<float, false>(L, B, X, K, M, S, stream);
}
int slampp_trsm_fwd_f64(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  return launch_trsm<double, false>(L, B, X, K, M, S, stream);
}
int slampp_trsm_bwd_f32(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  return launch_trsm<float, true>(L, B, X, K, M, S, stream);
}
int slampp_trsm_bwd_f64(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  return launch_trsm<double, true>(L, B, X, K, M, S, stream);
}
int slampp_chol_resident_max(int f64, int* out) {
  return f64 ? resident_max_m<double>(out) : resident_max_m<float>(out);
}
int slampp_chol_form(int f64, int K, int M, int* out) {
  return f64 ? chol_form<double>(K, M, out) : chol_form<float>(K, M, out);
}
const char* slampp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
