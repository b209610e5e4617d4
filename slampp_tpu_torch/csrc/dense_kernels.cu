// Batched dense Cholesky and triangular solves for NVIDIA Hopper (sm_90a).
//
// These replace the three Pallas TPU kernels of
// slampp_tpu/ops/dense_kernels.py, all of which ran through _batched_call
// (pl.pallas_call at dense_kernels.py:286):
//
//   chol_kernel, chol_tiled_kernel     <- _chol_kernel      (dense_kernels.py:184), chol_batched
//   trsm_kernel, trsm_sep_kernel,
//     trsm_cols_kernel <T, false, ...> <- _trsm_fwd_kernel  (dense_kernels.py:215), trsm_lower_batched
//   the same <T, true, ...>            <- _trsm_bwd_kernel  (dense_kernels.py:236), trsm_lower_t_batched
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
// Large form (chol_tiled_kernel: the separators, (1, 384) to (1, 6400) and
// beyond): a right-looking Cholesky in 64 x 64 tiles, its tasks taken from a
// ticket counter by a persistent grid (two 256-thread CTAs per SM); no grid
// barrier and no cooperative launch, so a CUDA graph can capture it
// (chip_smoke.py replays one).  The form it replaces (32-wide panels, one
// cooperative launch, two grid barriers a panel) lost 2.3-4.6x to
// cholesky_ex; see tiled_tasks for the order of the tasks.
//  * Tiles 64 wide: the trailing update reads and writes each tile once per
//    64 columns, not 32, and a tile's update (a 64 x 64 x 64 product) takes
//    its two panels through a ring of cp.async chunks.  f64 on the tensor
//    cores (mma.sync m16n8k4, DMMA), f32 on FFMA (TF32 would miss the f32
//    tolerance).  128-wide tiles were slower at every measured shape, by
//    3-9% at the f64 separators from M = 5344 and more elsewhere (kTile).
//  * The panel as a product: the diagonal tile is factored (32-wide blocks,
//    exact pivots frozen at 1e20 where d <= clamp or NaN, as chol_diag) and
//    inverted in one CTA, and every tile of the panel is W = A L_gg^-T, one
//    64 x 64 product; no substitution is left on the chain.
//  * Ticketed tasks with look-ahead: each step of the chain (the diagonal
//    tile's update, factor and inverse, then the tile below it) is one
//    task, taken before the bulk of the step before; every task waits only
//    on tasks with earlier tickets, so the launch needs no co-residency.
//    Each tile keeps a counter of the steps applied to it, published with
//    release after a CTA barrier and a fence, polled with acquire (every
//    poll traps after kPollLimit), its data read past the L1.  The
//    counters live in a workspace that the entry point zeroes on the stream.
//  * Each tile takes its steps in order and every sum has a fixed order, so
//    two launches on the same input give the same bits.
//  * Products are one non-inlined function (one copy of the code serves
//    every task), their results staged in shared memory and written
//    (C - sum) in coalesced 16-byte vectors, C itself prefetched with the
//    first chunk.
// What bounds it on an H100 (scripts/chol_forms_ab.py, PERF.md): the chain.
// A step is ~49 us in f32 ((1, 3952): 62 steps in 3.05 ms) and ~85 us in
// f64 ((1, 5344): 84 in 7.17), of which the tile's factor takes 29 and 54:
// its two warp-level 32-column factors (chol_diag) 21 and 38 us there,
// against 4.3 and 6.5 us alone in one warp, as the kernel's two CTAs per
// SM cap registers at 128 and the update tasks share the SM; the pivots
// stay correctly rounded.  The bulk (~15 us of latency around each tile
// product of ~3 us) keeps pace.  So the form is 1.2-2.3x faster than the
// cooperative one and 1.4-2.3x slower than cholesky_ex (PERF.md).
// Crossover with the streaming form: chol_large_from.
//
// Accuracy: subtracting each of a panel's products from an entry in turn
// (an earlier one-CTA design) rounds at the entry's magnitude once per
// column; at the sphere2500 separator (condition ~6.6e5) that made the f32
// factor's residual 4x the plain version's.  Summing the products first, as
// the plain version's A -= W W^T does, and taking exact pivots gives a
// residual below the plain version's.  The tiled form sums a step's 64
// products from zero and subtracts once (in f32 each 32-deep chunk's sum
// first, then the chunk sums: one sum over the whole depth let the CPU
// rehearsal's f32 residual at condition ~1e6 pass twice the plain
// version's; two levels stay within it), and forms the panel with the
// explicit inverse of the diagonal tile; both are backward stable orders
// of the same blocked algorithm, so f64 stays within a few ulps times the
// condition of the plain version (9.2e-16 on the card) and the f32
// residual near it (3.4e-7 to 5.0e-7 against the plain version's 2.6e-7
// to 8.7e-7; scripts/chol_forms_ab.py step 1; tests/test_torch_dense_kernels.py
// rehearses the order on the CPU against the JAX package).

// Triangular solves: three forms, chosen on the host per (device, K, M, S,
// dtype, direction) and kept (plan_trsm; dk.trsm_form names the choice).
// X = L^-1 B walks L's 32-row blocks down (fwd), X = L^-T B up (bwd): block
// i needs x of every block before it in that wavefront order, so each form
// is bound by that chain of P = ceil(M / 32) dependent steps unless there
// are enough independent chains (matrices, column groups) to fill the card.
// Each form's critical step avoids the 32 dependent shuffle-and-divide steps
// of a substitution where it can: x_i = D_i^-1 r_i from the diagonal block
// inverted off the chain (invert_diag: the warp substitution applied to the
// identity, multiplying by the pivots' reciprocals; a frozen pivot, L_jj =
// 1e10, gives 1e-10 entries and no NaN).
//
// Cluster form (trsm_kernel): one thread-block cluster of C = min(
// ceil(M / 32), 16) CTAs per matrix and G 8-column groups of B, L's slabs
// resident in the CTAs' shared memory, x_p pushed to every CTA through
// distributed shared memory.  Bound by the chain's ~1.5 us a step on at
// most 16 SMs: it wins where the chain is short and every slab is resident,
// (1, 488, 8) in 0.025 ms against solve_triangular's 0.18, and the part
// frames (K, 192-320, 8).  Details:
//
//  * CTA r owns the panels p = r, r + C, ... (one panel each for M <= 512).
//    C = 1 was slower at every shape of the path.  G is 1 unless the grid
//    would take more waves of clusters than the card holds at once: then a
//    cluster takes several groups (G = 3 or 6), one slab load and wavefront
//    serving them all.
//  * Each CTA holds its panels' slab of L in shared memory: fwd the row slab
//    (rows of panel p, columns [0, end of p)), bwd the column slab (columns
//    of panel p, rows [start of p, M)), read transposed in place.  Warp 0
//    loads the slabs with cp.async.bulk (one copy per row segment) on
//    mbarriers, in the order the wavefront consumes them, so the load
//    overlaps the solve.  The CTA arrives on the cluster barrier before the
//    load and waits on it only before the wavefront.
//  * The wavefront: the owner of panel p forms x_p into its slot p and
//    copies the slot into slot p of every other CTA (cp.async.bulk
//    shared::cta -> shared::cluster, completing on that CTA's per-panel
//    mbarrier); each CTA subtracts L_ip x_p from the rhs of each panel it
//    owns.  With one panel per CTA the owner of p + 1 applies x_p to its own
//    rows only, so the chain waits on that one update.  A final
//    cluster.sync() keeps every CTA's shared memory alive while copies from
//    it may be in flight.
//  * A CTA whose slabs do not all fit in shared memory (227 KB opt-in) reads
//    the panels it lacks from global memory at the point of use (with G = 1
//    from M = 1000 fwd in f32, 608 in f64).  Every CTA must hold all P x
//    tiles: where they do not fit (f32 M > 5120, f64 M > 2560) the form has
//    no plan: the separator form takes those shapes, and is faster there
//    (pulling each x_p after a cluster barrier took 10.6 ms at (1, 5344, 8)
//    f32 bwd, 5.7x solve_triangular).
//
// Separator form (trsm_sep_kernel): the separators, one or two
// matrices of M ~500 to 12,000 and more, S <= 8.  Bound by the chain: the
// bytes (the lower triangle once, 57 MB at (1, 5344) f32: 0.017 ms at 3.35
// TB/s) are read by every SM in parallel, ahead of the chain, so what is
// left is P steps of a flag's round trip through L2 and two 32 x 32 by 32 x
// 8 products: 2.2 us a step, (1, 5344, 8) f32 in 0.375 ms against
// solve_triangular's 1.7-2.2 (the cluster form: 2.3 fwd, 10.6 bwd).  A
// persistent grid (as many CTAs as the card holds at once) takes the 32-row
// blocks of all chains (matrix, 8-column group) from a ticket counter in
// wavefront order; see trsm_sep_kernel.  x_p goes to X in global memory
// followed by a flag (release); consumers poll with acquire and read x_p
// past the L1.  No cooperative launch and no co-residency needed: a CTA
// waits only on blocks whose tickets came before its own, held by CTAs that
// run already, so the launch is legal inside a CUDA graph (chip_smoke.py
// replays one).  Every poll traps after kPollLimit polls, so a hang becomes
// a launch error.  No cap on M.  The workspace (ticket and flags) comes from
// the wrapper and is zeroed on the stream by the entry point.
//
// Column-tiled form (trsm_cols_kernel): the dense frames' wide
// right-hand sides, W = L^-1 [U | g] at (11-157, 192-320, 150-960).  Bound
// by FLOPs (M^2 S / 2 per matrix; (157, 192, 408) f32: 0.035 ms at 67
// TFLOP/s) or bytes; what held the cluster form back there was a design for
// latency, K ceil(S / 8G) clusters each running the whole chain with
// cross-CTA barriers for 8G columns, and one FMA per shared load.  Here one
// CTA per (matrix, 32 columns), no cluster: 240 CTAs at (40, 320, 176).  It
// keeps its 32 columns of x for all M rows in shared memory, so the chain
// stays inside the CTA, left-looking: r_i = B_i - sum_p L_ip x_p over the
// solved blocks, accumulated in registers, then x_i = D_i^-1 r_i by
// substitution.  Each 32 x 32 block of L is read once through a ring of
// cp.async tiles.  f64 products on the tensor cores (mma.sync m8n8k4 f64,
// 67 TFLOP/s against 34 outside them); f32 products as FFMA, a thread's row
// times four columns, 4 FMAs per 16-byte shared load of x (TF32 would miss
// the f32 residual tolerance).  (40, 320, 176) f64 0.105 ms (the cluster
// form 1.26, solve_triangular 0.27); (157, 192, 408) f32 0.28 (0.64, 0.54).
//
// The plan (plan_trsm): the column-tiled form where it fits (f64 M <= 800,
// f32 M <= 1472) and has K ceil(S / 32) >= 32 CTAs with S > 8, or one CTA
// per SM with S <= 8; else, for S <= 8, the separator form from M =
// separator_from(K); else the cluster form where it has a plan; else the
// separator form.  Crossovers, all forms side by side on an H100
// (scripts/trsm_forms_ab.py, device ms, PERF.md):
//  * fwd f32 from M = 1152: (1, 1096, 8) cluster 0.077 / separator 0.081,
//    (1, 1472, 8) 0.133 / 0.105;
//  * fwd f64 from 672: (1, 584, 8) 0.041 / 0.049, (1, 768, 8) 0.071 / 0.062;
//    from 320 at K >= 40: (40, 320, 8) 0.049 / 0.039, (17, 320, 8) 0.025 /
//    0.033;
//  * bwd from 544 in both dtypes: (1, 488, 8) f32 0.031 / 0.038, (1, 584, 8)
//    0.050 / 0.044; from 320 at K >= 40 (f32) and K >= 17 (f64): (40, 320,
//    8) f32 0.048 / 0.033, (17, 320, 8) f32 0.024 / 0.030, f64 0.070 /
//    0.034;
//  * column-tiled: (55, 192, 16) f32 0.024 cluster / 0.023 columns, (13,
//    192, 32) 0.017 / 0.024, (1, 488, 48) 0.025 / 0.124; at S = 8 (157, 192,
//    8) f64 0.057 / 0.049, (55, 192, 8) f32 0.017 / 0.023.
//
// Accuracy (the bounds: f64 max |kernel - plain| / max |plain| < 1e-10, f32
// relative residual < 1e-4, frozen pivots included).  The separator form
// sums in the cluster form's order (each entry of r_i over the blocks in
// wavefront order, each block's 32 products in order; x_i = D_i^-1 r_i from
// zero): where both run, the card gives the same bits.  The column-tiled
// form sums the same products per block (in f64 in DMMA depth steps of 4)
// and solves the diagonal by substitution with the pivots' reciprocals:
// both are backward stable blocked substitutions, each entry's error a
// small multiple of M u |L| |x|, as for the plain version, so the two stay
// within the condition number times a few ulps of each other.  On the card
// f64 agrees to 1.1e-14 and f32 residuals stay below 6e-6 at every checked
// shape up to M = 12,296 (tests/test_torch_dense_kernels.py rehearses each
// form's order on the CPU against the JAX package at 1e-10).
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
  int chunk_bars, ready_bars, slab_off, acc, xr, dop, slab;
  unsigned slab_cap;  // bytes of shared memory left for slabs
};

// The fixed part holds every x_p in every CTA (P x tiles); where it does not
// fit in smem_limit (slab > smem_limit) the cluster form has no plan.
template <typename T>
TrsmPlan make_plan(int M, int C, int G, size_t smem_limit) {
  TrsmPlan q;
  q.P = (M + kNB - 1) / kNB;
  q.C = C;
  q.nown = (q.P + C - 1) / C;
  q.G = G;
  const size_t tile = static_cast<size_t>(kNB) * G * kTrsmCols * sizeof(T);
  size_t off = 0;
  q.chunk_bars = static_cast<int>(off);  // [nown][P]: slab chunk arrived
  off += static_cast<size_t>(q.nown) * q.P * 8;
  q.ready_bars = static_cast<int>(off);  // [P]: x_p has arrived in xr
  off += static_cast<size_t>(q.P) * 8;
  q.slab_off = static_cast<int>(off);  // [nown]: byte offset of each slab, -1 = global
  off = align_up(off + static_cast<size_t>(q.nown) * 4, 16);
  q.acc = static_cast<int>(off);  // [nown][kNB][8G]: rhs, then residual
  off += q.nown * tile;
  q.xr = static_cast<int>(off);  // x tiles [P][kNB][8G]
  off += q.P * tile;
  q.dop = static_cast<int>(off);  // [nown][kNB][kLdd]: D_p^-1 (fwd) or D_p^-T (bwd)
  off += static_cast<size_t>(q.nown) * kNB * kLdd * sizeof(T);
  q.slab = static_cast<int>(align_up(off, 128));
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
// predicates (with a runtime G the steps were 2.5x longer at (1, 488, 8)).
template <typename T, bool kBwd, int kG>
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
    for (int i = 0; i < q.P; ++i) {
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

  // 5. the wavefront.  The owner of p forms x_p = dop_p r_p in slot p and
  //    copies the slot into slot p of every other CTA, one bulk copy each,
  //    completing on that CTA's ready[p].  Each CTA then subtracts the block
  //    (pi, p) times x_p from the residual of every panel pi it owns that
  //    the wavefront has not reached.
  for (int step = 0; step < q.P; ++step) {
    const int p = kBwd ? q.P - 1 - step : step;
    const int lp = p / q.C;  // p's slot in its owner's tiles
    const int owner = p % q.C;
    const T* slot = xr + p * tile;
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
      for (int g = 0; g < kG; ++g) xr[p * tile + own + g * kTrsmCols] = x[g];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // the copies leave one after another (~30 ns each): the owner of the
      // next panel in wavefront order gets the first
      if (tid < q.C - 1)
        bulk_s2cluster(slot, tile * sizeof(T), &ready[p],
                       (rank + (kBwd ? q.C - 1 - tid : 1 + tid)) % q.C);
    } else {
      mbar_wait(&ready[p]);
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
        X[(k * M + p * kNB + ti) * S + c0 + j] = xr[p * tile + own - ts + j];
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

// 1 / x correctly rounded: the bits of T(1) / x, in fewer instructions
// than a division (the pivot chain of the Cholesky waits on it).
__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

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
  *inv = rcp_rn(ljj);
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
// asynchronous copies and flags between CTAs (the large Cholesky form and
// the separator-form TRSM)
// ---------------------------------------------------------------------------

constexpr unsigned kPollLimit = 1u << 26;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Spins until *p >= v (acquire); traps after kPollLimit polls, so that a
// hang becomes a launch error.
__device__ __forceinline__ void wait_at_least(const unsigned* p, unsigned v) {
  for (unsigned tries = 0; ld_acquire(p) < v; ++tries)
    if (tries > kPollLimit) __trap();
}

// ---------------------------------------------------------------------------
// Cholesky, large form: kT-wide tiles on a ticketed task graph
// ---------------------------------------------------------------------------

constexpr int kTiledThreads = 256;  // 8 warps
// The tile width: 64 (128 was slower at every measured shape in both
// dtypes: H100, PERF.md; the kernel takes either).
constexpr int kTile = 64;

// Depth of one staged chunk of a tile product and the ring's depth (f64:
// chunks of 16 columns, 3 in flight at kT = 64, so that two CTAs hold the
// ring and the prefetched C tile, 4 at 128; f32: 32 columns, 3), and the
// chunk's
// row stride: a pad of 4 entries keeps the rows 16-byte aligned for cp.async
// and puts the 8 rows a DMMA fragment (or the 16 rows of the f32 thread
// grid) reads on distinct banks within each 128-byte wavefront.
template <typename T>
constexpr int kChunk = sizeof(T) == 8 ? 16 : 32;
template <typename T, int kT>
constexpr int kRing = sizeof(T) == 8 ? (kT == 64 ? 3 : 4) : 3;
template <typename T>
constexpr int kLdc = kChunk<T> + 4;
// Row strides of the diagonal tile and of W^T in its factor (16 bytes of
// pad: rows stay 16-byte aligned, columns spread over the banks).
template <typename T, int kT>
constexpr int kLdt = kT + static_cast<int>(16 / sizeof(T));
template <typename T, int kT>
constexpr int kLdw = kT - kNB + static_cast<int>(16 / sizeof(T));

// One mma.sync m16n8k4 f64 (DMMA): c (16 x 8) += a (16 x 4) b (4 x 8).
// Lane (g, t) = (lane / 4, lane % 4) holds a0 = A[g][t], a1 = A[g + 8][t],
// b = B[t][g], and c[0..1] = C[g][2t .. 2t + 1], c[2..3] = C[g + 8][...]: the
// m8n8k4 layout of trsm_cols_kernel, twice over.
__device__ __forceinline__ void dmma16(double* c, double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The accumulator of one kT x kT tile product C = A B^T (A, B: kT rows of
// the depth, row-major chunks [kT][kLdc] in shared memory), spread over the
// CTA's 256 threads; every entry's products are summed from zero in depth
// order.  f64: DMMA, warp w the rows (w / 4) kT / 2 .. + kT / 2 and the
// columns (w % 4) kT / 4 .. + kT / 4, in m16 x n8 fragments, one sum over
// the whole depth.  f32: FFMA, thread (ty, tx) of a 16 x 16 grid the rows
// ty + 16a and columns tx + 16b, a, b < kT / 16, fed by 16- or 8-byte loads
// along the depth (TF32 would miss the f32 tolerance); each 32-deep chunk's
// products are summed from zero and the chunk sums added in turn (one sum
// of 64 or 128 products put the factor's f32 residual at 2-4x the plain
// version's in a CPU rehearsal; two levels at 1.3-1.5x, PERF.md).
template <typename T, int kT>
struct TileAcc;

template <int kT>
struct TileAcc<double, kT> {
  static constexpr int kMB = kT / 32, kNB8 = kT / 32;
  double c[kMB][kNB8][4];

  __device__ __forceinline__ static int row0() {
    return (threadIdx.x >> 7) * (kT / 2) + ((threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ static int col0() {
    return ((threadIdx.x >> 5) & 3) * (kT / 4) + ((threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < kMB; ++m)
#pragma unroll
      for (int n = 0; n < kNB8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.0;
  }
  __device__ __forceinline__ void mma(const double* as, const double* bs) {
    const int t = threadIdx.x & 3;
    const double* ap = as + row0() * kLdc<double> + t;
    const double* bp = bs + col0() * kLdc<double> + t;
#pragma unroll
    for (int k = 0; k < kChunk<double>; k += 4) {
      double a[kMB][2], b[kNB8];
#pragma unroll
      for (int m = 0; m < kMB; ++m) {
        a[m][0] = ap[(16 * m) * kLdc<double> + k];
        a[m][1] = ap[(16 * m + 8) * kLdc<double> + k];
      }
#pragma unroll
      for (int n = 0; n < kNB8; ++n) b[n] = bp[(8 * n) * kLdc<double> + k];
#pragma unroll
      for (int m = 0; m < kMB; ++m)
#pragma unroll
        for (int n = 0; n < kNB8; ++n) dmma16(c[m][n], a[m][0], a[m][1], b[n]);
    }
  }
  // f(row, col, value) over this thread's entries
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int r0 = row0();
    const int c0 = ((threadIdx.x >> 5) & 3) * (kT / 4) + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int m = 0; m < kMB; ++m)
#pragma unroll
      for (int n = 0; n < kNB8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f(r0 + 16 * m + 8 * (e >> 1), c0 + 8 * n + (e & 1), c[m][n][e]);
  }
};

template <int kT>
struct TileAcc<float, kT> {
  static constexpr int kR = kT / 16;
  static constexpr int kDv = kT >= 128 ? 2 : 4;  // depth of one shared load (registers)
  float c[kR][kR];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kR; ++b) c[a][b] = 0.0f;
  }
  __device__ __forceinline__ static void load(const float* p, float* v) {
    if constexpr (kDv == 4) {
      unpack(*reinterpret_cast<const float4*>(p), v);
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x, v[1] = q.y;
    }
  }
  // the chunk's products summed from zero, then added to the total
  __device__ __forceinline__ void mma(const float* as, const float* bs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float p[kR][kR];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kR; ++b) p[a][b] = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunk<float>; k += kDv) {
      float x[kR][kDv], y[kR][kDv];
#pragma unroll
      for (int a = 0; a < kR; ++a) load(as + (ty + 16 * a) * kLdc<float> + k, x[a]);
#pragma unroll
      for (int b = 0; b < kR; ++b) load(bs + (tx + 16 * b) * kLdc<float> + k, y[b]);
#pragma unroll
      for (int e = 0; e < kDv; ++e)
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int b = 0; b < kR; ++b) p[a][b] += x[a][e] * y[b][e];
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kR; ++b) c[a][b] += p[a][b];
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int b = 0; b < kR; ++b) f(ty + 16 * a, tx + 16 * b, c[a][b]);
  }
};

// Columns [col0, col0 + kChunk) of the first `rows` rows of the row-major
// tile g (row stride ld) into s ([kT][kLdc]) by 16-byte cp.async copies;
// rows from `rows` on are zero-filled.  The caller commits.
template <typename T, int kT>
__device__ __forceinline__ void copy_chunk(T* s, const T* g, int ld, int rows, int col0) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kPerRow = kChunk<T> / kV;
#pragma unroll
  for (int q = threadIdx.x; q < kT * kPerRow; q += kTiledThreads) {
    const int r = q / kPerRow, c = (q % kPerRow) * kV;
    const bool ok = r < rows;
    cp_async16(s + r * kLdc<T> + c, ok ? g + static_cast<size_t>(r) * ld + col0 + c : g, ok);
  }
}

// acc += A B^T over the depth kT: A the first arows rows of the tile a, B
// the first brows rows of b (B = A where same), both row-major in global
// memory (L2), streamed through a ring of kRing chunks (cp.async.cg: past
// the L1, which is not coherent with the other CTAs' writes); where cbuf is
// given, the first crows x ccols of the tile c (row stride lda) arrive in
// it too, with the first chunk.  Starts and ends with a CTA barrier, so
// that the ring may overlay other shared data.
template <typename T, int kT>
__device__ __forceinline__ void tile_product(const T* a, int lda, int arows, const T* b, int ldb,
                                             int brows, bool same, T* ring, TileAcc<T, kT>& acc,
                                             const T* csrc = nullptr, int crows = 0, int ccols = 0,
                                             T* cbuf = nullptr) {
  constexpr int kSlot = 2 * kT * kLdc<T>;
  constexpr int kChunks = kT / kChunk<T>;
  auto issue = [&](int c) {
    if (c < kChunks) {
      T* s = ring + (c % kRing<T, kT>) * kSlot;
      copy_chunk<T, kT>(s, a, lda, arows, c * kChunk<T>);
      if (!same) copy_chunk<T, kT>(s + kT * kLdc<T>, b, ldb, brows, c * kChunk<T>);
    }
    cp_async_commit();
  };
  __syncthreads();
  if (cbuf) {  // the C tile (crows x ccols of c, row stride lda), with the first chunk
    constexpr int kV = 16 / sizeof(T);
    const int per = ccols / kV;
    for (int q = threadIdx.x; q < crows * per; q += kTiledThreads) {
      const int r = q / per, col = (q % per) * kV;
      cp_async16(cbuf + r * kLdt<T, kT> + col, csrc + static_cast<size_t>(r) * lda + col, true);
    }
  }
#pragma unroll
  for (int c = 0; c < kRing<T, kT> - 1; ++c) issue(c);
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait<kRing<T, kT> - 2>();
    __syncthreads();  // chunk c in place; every thread is past chunk c - 1
    issue(c + kRing<T, kT> - 1);
    const T* s = ring + (c % kRing<T, kT>) * kSlot;
    acc.mma(s, same ? s : s + kT * kLdc<T>);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The w x w diagonal block at (j0, j0) of the tile s (row stride ld)
// factored in place by warp 0 with chol_diag's operations in chol_diag's
// order, but in a rolled loop: for f64, where the unrolled block (~3,000
// instructions, two shuffles a double) ran slower in the kernel at the
// large separators, beside the bulk's traffic and under the register cap
// of two CTAs per SM (f32 stays unrolled; scripts/chol_forms_ab.py, steps
// 3 and 5, PERF.md).  Lane r keeps row r in registers,
// rotated by 4 after every 4 columns so that d[u] is column j + u; each
// column is broadcast through colbuf ([2][kNB] in shared memory) and
// written to s as it is final.
template <typename T>
__device__ __forceinline__ void chol_diag_rolled(T* s, int ld, int j0, int w, T clamp, T* colbuf) {
  const int lane = threadIdx.x & 31;
  T d[kNB];
  if (lane < w) {
    const T* row = s + (j0 + lane) * ld + j0;
#pragma unroll
    for (int c = 0; c < kNB; c += 8)
      if (c < w) load_vec<T, 8>(row + c, d + c);
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    if (lane >= w) d[c] = (c == lane) ? T(1) : T(0);
    else if (c > lane) d[c] = T(0);
  }
  T* out = s + (j0 + lane) * ld + j0;
  T inv;
  T ljj = pivot(__shfl_sync(kFull, d[0], 0), clamp, &inv);
#pragma unroll 1
  for (int jb = 0; jb < kNB; jb += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + u;
      const T lrj = lane == j ? ljj : (lane > j ? d[u] * inv : T(0));
      if (lane < w) out[j] = lrj;
      colbuf[(j & 1) * kNB + lane] = lrj;
      if (j + 1 < kNB) {
        d[u + 1] -= lrj * __shfl_sync(kFull, lrj, j + 1);
        ljj = pivot(__shfl_sync(kFull, d[u + 1], j + 1), clamp, &inv);
      }
      __syncwarp();
      const T* col = colbuf + (j & 1) * kNB;
#pragma unroll
      for (int c = u + 2; c < kNB; ++c)
        if (j + c - u < kNB) d[c] -= lrj * col[j + c - u];
    }
#pragma unroll
    for (int c = 0; c + 4 < kNB; ++c) d[c] = d[c + 4];
  }
}

// Factors the n x n lower tile s (row stride kLdt, n a multiple of 8, zeros
// above the diagonal and beyond n) in place, in 32-wide panels as the
// one-CTA forms do: warp 0 factors the diagonal block (chol_diag_rolled:
// exact pivots, frozen at 1e20 where d <= clamp or NaN), all warps invert
// it (invert_diag, into block p of dinv [kT / kNB][kNB][kLdv], kept for
// invert_tile), form W = a L_d^-T for the rows below (each entry summed from
// zero in column order, as panel_row sums it; W^T also into wt [kNB][ldw])
// and subtract W W^T from the lower triangle below, each entry's 32
// products summed from zero first (as chol_trailing, over every thread).
template <typename T, int kT>
__device__ __forceinline__ void factor_tile(T* s, int n, T clamp, T* dinv, T* wt, T* colbuf) {
  constexpr int ld = kLdt<T, kT>;
  constexpr int ldw = kLdw<T, kT>;
  constexpr int kMaxQ = (kT - kNB) * kNB / kTiledThreads;  // entries of W a thread
  const int P = (n + kNB - 1) / kNB;
  const int tid = threadIdx.x, c = tid & 31;
  for (int p = 0; p < P; ++p) {
    const int j0 = p * kNB;
    T* di = dinv + p * kNB * kLdv<T>;
    if (tid < 32) {  // the same bits either way
      const int w = imin(kNB, n - j0);
      if constexpr (sizeof(T) == 8) chol_diag_rolled<T>(s, ld, j0, w, clamp, colbuf);
      else chol_diag<T, false>(s, s, nullptr, ld, j0, w, clamp);
    }
    __syncthreads();
    invert_diag<T, false, kLdv<T>>(s + j0 * ld + j0, ld, imin(kNB, n - j0), di);
    __syncthreads();
    if (p + 1 < P) {
      const int j1 = j0 + kNB;
      const int nq = (P * kNB - j1) * kNB / kTiledThreads;
      T v[kMaxQ > 0 ? kMaxQ : 1];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int r = j1 + (tid >> 5) + 8 * q;
        T x = T(0);
        if (q < nq && r < n) {
          const T* a = s + r * ld + j0;
#pragma unroll 8
          for (int t = 0; t < kNB; ++t) x += a[t] * di[c * kLdv<T> + t];
        }
        v[q] = x;
      }
      __syncthreads();  // every row of the panel read
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int r = j1 + (tid >> 5) + 8 * q;
        if (q < nq) {
          if (r < n) s[r * ld + j0 + c] = v[q];
          wt[c * ldw + r - j1] = v[q];
        }
      }
      __syncthreads();
      // the lower triangle of rows and columns [j1, P kNB) less W W^T: the
      // 32 products of an entry summed from zero in order, as chol_trailing
      // sums them, spread over every thread (lanes along a row)
      const int nr = P * kNB - j1;
      for (int e = tid; e < nr * nr; e += kTiledThreads) {
        const int r = e / nr, col = e - r * nr;
        if (col > r || j1 + r >= n) continue;
        T x = T(0);
#pragma unroll 8
        for (int t = 0; t < kNB; ++t) x += wt[t * ldw + r] * wt[t * ldw + col];
        s[(j1 + r) * ld + j1 + col] -= x;
      }
      __syncthreads();
    }
  }
}

// The full kT x kT lower factor s (row stride kLdt) in place into its
// inverse X = L^-1, block column by block column from the last (32-wide
// blocks J): X_JJ = L_JJ^-1 (block J of dinv, from factor_tile), then below
// it X_RJ = -(X_RR L_RJ) X_JJ, where R = the rows after J, whose X_RR is
// inverted already.  Each entry's products are summed from zero.
template <typename T, int kT>
__device__ __forceinline__ void invert_tile(T* s, const T* dinv_all) {
  constexpr int ld = kLdt<T, kT>;
  constexpr int kMaxQ = (kT - kNB) * kNB / kTiledThreads;  // entries of X_RJ a thread
  const int tid = threadIdx.x;
  const int c = tid & 31;
  for (int J = kT / kNB - 1; J >= 0; --J) {
    const int j0 = J * kNB, j1 = j0 + kNB;
    const int nq = (kT - j1) * kNB / kTiledThreads;  // this J's entries a thread
    const T* dinv = dinv_all + J * kNB * kLdv<T>;
    // thread entries (r, c), r = tid / 32 + 8q: X_RR L_RJ over the whole
    // of R (X_RR is zero above its diagonal)
    T v[kMaxQ > 0 ? kMaxQ : 1];
#pragma unroll
    for (int q = 0; q < (kMaxQ > 0 ? kMaxQ : 1); ++q) v[q] = T(0);
    for (int m = 0; m < kT - j1; ++m) {
      const T l = s[(j1 + m) * ld + j0 + c];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < nq) v[q] += s[(j1 + (tid >> 5) + 8 * q) * ld + j1 + m] * l;
    }
    __syncthreads();  // every thread has read L_RJ
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      if (q < nq) s[(j1 + (tid >> 5) + 8 * q) * ld + j0 + c] = v[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      if (q >= nq) continue;
      const T* row = s + (j1 + (tid >> 5) + 8 * q) * ld + j0;
      T x = T(0);
#pragma unroll 8
      for (int t = 0; t < kNB; ++t) x += row[t] * dinv[t * kLdv<T> + c];
      v[q] = -x;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      if (q < nq) s[(j1 + (tid >> 5) + 8 * q) * ld + j0 + c] = v[q];
    for (int e = tid; e < kNB * kNB; e += kTiledThreads)
      s[(j0 + e / kNB) * ld + j0 + e % kNB] = dinv[(e / kNB) * kLdv<T> + e % kNB];
    __syncthreads();
  }
}

// rows x cols (cols a multiple of 8) from s (row stride ls; zeros if s is
// null) to g (row stride lg) as 16-byte vectors.
template <typename T>
__device__ __forceinline__ void store_rows(T* g, int lg, const T* s, int ls, int rows, int cols) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const int per = cols / kV;
  for (int q = threadIdx.x; q < rows * per; q += kTiledThreads) {
    const int r = q / per, c = (q % per) * kV;
    *reinterpret_cast<V*>(g + static_cast<size_t>(r) * lg + c) =
        s ? *reinterpret_cast<const V*>(s + r * ls + c) : V{};
  }
}

// The tasks of one matrix of nt x nt tiles, in ticket order: group g holds
//   C(g)                    the chain's step: D(g), the diagonal tile updated
//                           by step g - 1 (its earlier steps from U tasks),
//                           factored, L_gg written, inverted into dinv; then
//                           the tile below it (updated to step g - 1 by a U
//                           task) times L_gg^-T: L_g+1,g, which C(g + 1) needs;
//   P(i, g), i = g + 2 ..   the panel: step g - 1, then times L_gg^-T;
//   U(i, j, g - 1), j > g,  step g - 1 on the rest of the trailing triangle;
//     i >= j, by columns
//   U(g + 2, g + 1, g)      the tile below the next diagonal by step g, for
//                           C(g + 1).
// Every task's inputs come from tasks with earlier tickets: a CTA waits only
// on work that CTAs already running hold (no co-residency needed).  A step
// of the chain is one task, so the chain waits on another CTA once a step,
// and the next column's work comes before the bulk of step g - 1
// (look-ahead).
__host__ __device__ __forceinline__ long long tiled_group(int nt, int g) {
  const int panel = nt - g - 2 > 0 ? nt - g - 2 : 0;
  const long long bulk = g >= 1 ? static_cast<long long>(nt - 1 - g) * (nt - g) / 2 : 0;
  return 1 + panel + bulk + (g + 2 < nt ? 1 : 0);
}
__host__ __device__ inline long long tiled_tasks(int nt) {
  long long n = 0;
  for (int g = 0; g < nt; ++g) n += tiled_group(nt, g);
  return n;
}

// Bytes of shared memory: the ring, overlaid by the diagonal tile (or a
// product's result on its way out), the inverses of its 32 x 32 diagonal
// blocks, W^T of the tile factor and the column buffer of
// chol_diag_rolled; then the ticket.
template <typename T, int kT>
__host__ __device__ constexpr size_t tiled_body() {
  const size_t ring = sizeof(T) * kRing<T, kT> * 2 * kT * kLdc<T>;
  const size_t diag = sizeof(T) * (kT * kLdt<T, kT> + kT * kLdv<T> + kNB * kLdw<T, kT> + 2 * kNB);
  return ring > diag ? ring : diag;
}
// A product's result into the tile s in shared memory (row stride kLdt),
// between two CTA barriers, so that it leaves in coalesced 16-byte vectors.
template <typename T, int kT>
__device__ __forceinline__ void stage(const TileAcc<T, kT>& acc, T* s) {
  acc.each([&](int r, int c, T v) { s[r * kLdt<T, kT> + c] = v; });
  __syncthreads();
}

// The C tile prefetched for an update's epilogue ([kT][kLdt], after the
// body), where it fits beside the body: not for f64 at kT = 128, whose
// diagonal tile and its factor's workspace take 190 KB.
template <typename T, int kT>
__host__ __device__ constexpr size_t tiled_cbuf() {
  return sizeof(T) == 8 && kT == 128 ? 0 : sizeof(T) * kT * kLdt<T, kT>;
}
template <typename T, int kT>
__host__ __device__ constexpr size_t tiled_smem() {
  return tiled_body<T, kT>() + tiled_cbuf<T, kT>() + 16;
}

// acc = A B^T (tile_product), staged in the ring's first kT x kLdt (between
// two CTA barriers); the C tile csrc into the C buffer where there is one.
// Not inlined: one copy
// of the product's code serves every task, so that the kernel's code stays
// small (the chain's factor ran slower beside four inlined copies).
template <typename T, int kT>
__device__ __noinline__ void product(const T* a, int lda, int arows, const T* b, int ldb, int brows,
                                     bool same, const T* csrc, int crows, int ccols) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* cbuf =
      csrc && tiled_cbuf<T, kT>() ? reinterpret_cast<T*>(smem + tiled_body<T, kT>()) : nullptr;
  TileAcc<T, kT> acc;
  acc.zero();
  tile_product<T, kT>(a, lda, arows, b, ldb, brows, same, ring, acc, csrc, crows, ccols, cbuf);
  stage<T, kT>(acc, ring);
}

// f(r, c, x) for each 16-byte vector x of the first rows x cols (cols a
// multiple of 8) of the tile s = the ring (row stride kLdt); ends with a CTA
// barrier.
template <typename T, int kT, class F>
__device__ __forceinline__ void for_vectors(int rows, int cols, F f) {
  extern __shared__ __align__(128) unsigned char smem[];
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const int per = cols / kV;
  T* s = reinterpret_cast<T*>(smem);
  for (int q = threadIdx.x; q < rows * per; q += kTiledThreads) {
    const int r = q / per, c = (q % per) * kV;
    f(r, c, reinterpret_cast<V*>(s + r * kLdt<T, kT> + c));
  }
  __syncthreads();
}

__device__ __forceinline__ float4 sub(const float4& a, const float4& b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ double2 sub(const double2& a, const double2& b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
// The vector at (r, c) with the entries right of the diagonal, and every
// entry of rows from n on, zero.
__device__ __forceinline__ float4 lower(float4 v, int r, int c, int n) {
  if (r >= n) return float4{};
  return make_float4(c <= r ? v.x : 0.f, c + 1 <= r ? v.y : 0.f, c + 2 <= r ? v.z : 0.f,
                     c + 3 <= r ? v.w : 0.f);
}
__device__ __forceinline__ double2 lower(double2 v, int r, int c, int n) {
  if (r >= n) return double2{};
  return make_double2(c <= r ? v.x : 0.0, c + 1 <= r ? v.y : 0.0);
}

// Spins until *p >= v (thread 0 of the CTA), then a CTA barrier.
__device__ __forceinline__ void wait_cta(const unsigned* p, unsigned v) {
  if (threadIdx.x == 0) wait_at_least(p, v);
  __syncthreads();
}
// Publishes *p = v once every thread's stores are done: CTA barrier, fence,
// release.
__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(p, v);
  }
}

// Right-looking tiled Cholesky of K (M, M) matrices on a persistent grid;
// see the note at the top of the file.  A CTA takes tickets from ws[0] in
// task order (matrix fastest), waits on the counters of the tiles its task
// reads (ws[1 + k ntri + i (i + 1) / 2 + j]: the steps applied to tile
// (i, j), j + 1 once it is final; acquire, bounded), runs it and publishes
// the counters of the tiles it wrote.  The factor is formed in L; the
// tiles' inverses L_gg^-1 go to dinv ([K][nt - 1][kT][kT]).
template <typename T, int kT>
__global__ void __launch_bounds__(kTiledThreads, kT == 64 ? 2 : 1)
    chol_tiled_kernel(const T* A, T* L, int K, int M, T clamp, unsigned* ws, T* dinv) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* sd = ring;  // the diagonal tile, or a product's result, over the ring
  T* sdi = sd + kT * kLdt<T, kT>;  // [kT / kNB][kNB][kLdv]
  T* swt = sdi + kT * kLdv<T>;     // [kNB][kLdw]
  T* scol = swt + kNB * kLdw<T, kT>;
  T* cbuf = tiled_cbuf<T, kT>() ? reinterpret_cast<T*>(smem + tiled_body<T, kT>()) : nullptr;
  unsigned* ticket =
      reinterpret_cast<unsigned*>(smem + tiled_body<T, kT>() + tiled_cbuf<T, kT>());
  constexpr int ldt = kLdt<T, kT>;
  using V = typename Vec16<T>::type;
  const int tid = threadIdx.x;
  const int nt = (M + kT - 1) / kT;
  const int ntri = nt * (nt + 1) / 2;
  const size_t MM = static_cast<size_t>(M) * M;
  const long long total = K * tiled_tasks(nt);
  int g = 0;
  long long g0 = 0;  // this CTA's cursor: group g starts at task g0
  for (;;) {
    if (tid == 0) *ticket = atomicAdd(ws, 1u);
    __syncthreads();
    const long long tk = *ticket;
    if (tk >= total) break;
    const int k = static_cast<int>(tk % K);
    const long long s = tk / K;
    unsigned* cnt = ws + 1 + static_cast<size_t>(k) * ntri;
    auto ctr = [&](int a, int b) { return cnt + a * (a + 1) / 2 + b; };
    auto tile = [&](const T* base, int a, int b) {
      return base + k * MM + static_cast<size_t>(a) * kT * M + b * kT;
    };
    auto rows = [&](int a) { return imin(kT, M - a * kT); };
    auto inv_tile = [&](int a) { return dinv + (static_cast<size_t>(k) * (nt - 1) + a) * kT * kT; };
    // C's vector at (r, c): prefetched into cbuf, or from src past the L1
    auto cvec = [&](const T* src, int r, int c) {
      return cbuf ? *reinterpret_cast<const V*>(cbuf + r * ldt + c)
                  : __ldcg(reinterpret_cast<const V*>(src + static_cast<size_t>(r) * M + c));
    };

    // out = C - L_i,st L_j,st^T (C: A's tile at step 0, else out), the
    // products summed from zero; every row of a diagonal tile
    auto update = [&](int i, int j, int st, T* out) {
      const T* src = st == 0 ? tile(A, i, j) : out;
      product<T, kT>(tile(L, i, st), M, rows(i), tile(L, j, st), M, rows(j), i == j, src, rows(i),
                     rows(j));
      for_vectors<T, kT>(rows(i), rows(j), [&](int r, int c, V* x) {
        *reinterpret_cast<V*>(out + static_cast<size_t>(r) * M + c) = sub(cvec(src, r, c), *x);
      });
    };
    // L_ic = C L_cc^-T (C: A's tile at c = 0, else tile (i, c) of L), and
    // zeros in the mirror tile (c, i) of the upper triangle
    auto panel = [&](int i, int c) {
      T* out = const_cast<T*>(tile(L, i, c));
      product<T, kT>(c >= 1 ? out : tile(A, i, c), M, rows(i), inv_tile(c), kT, kT, false,
                     nullptr, 0, 0);
      store_rows<T>(out, M, sd, ldt, rows(i), kT);
      store_rows<T>(const_cast<T*>(tile(L, c, i)), M, nullptr, 0, kT, rows(i));
    };

    // the task of group g: the chain's step C(g), P (i, g) or U (i, j, st)
    while (s >= g0 + tiled_group(nt, g)) g0 += tiled_group(nt, g++);
    long long o = s - g0;
    const int np = nt - g - 2 > 0 ? nt - g - 2 : 0;
    const long long nbulk = tiled_group(nt, g) - 1 - np - (g + 2 < nt ? 1 : 0);
    if (o == 0) {
      // C(g), D: step g - 2 from a U task, step g - 1 here, into the
      // diagonal tile
      T* dg = const_cast<T*>(tile(L, g, g));
      const int n = rows(g);
      if (g >= 1) {
        if (tid < 2) wait_at_least(tid == 0 ? ctr(g, g) : ctr(g, g - 1), tid == 0 ? g - 1 : g);
        const T* src = g == 1 ? tile(A, g, g) : dg;
        product<T, kT>(tile(L, g, g - 1), M, n, tile(L, g, g - 1), M, n, true, src, n, n);
        for_vectors<T, kT>(kT, kT, [&](int r, int c, V* x) {
          V v = *x;
          if (r < n && c <= r) v = sub(cvec(src, r, c), v);  // (n is a multiple of the vector)
          *x = lower(v, r, c, n);
        });
      } else {
        for_vectors<T, kT>(kT, kT, [&](int r, int c, V* x) {
          const T* a = tile(A, 0, 0) + static_cast<size_t>(r) * M + c;
          const V v = r < n && c <= r ? *reinterpret_cast<const V*>(a) : V{};
          *x = lower(v, r, c, n);
        });
      }
      factor_tile<T, kT>(sd, n, clamp, sdi, swt, scol);
      store_rows<T>(dg, M, sd, ldt, n, n);
      if (g + 1 < nt) {
        invert_tile<T, kT>(sd, sdi);
        store_rows<T>(inv_tile(g), kT, sd, ldt, kT, kT);
      }
      publish(ctr(g, g), g + 1);
      if (g + 1 < nt) {
        // C(g), the tile below, at step g - 1, times L_gg^-T
        wait_cta(ctr(g + 1, g), g);
        __threadfence();  // L_gg^-1, before it is read back past the L1
        panel(g + 1, g);
        publish(ctr(g + 1, g), g + 1);
      }
      continue;
    }
    int i, j, st;
    bool is_p = false;
    if (o <= np) {
      i = g + 1 + static_cast<int>(o), j = g, st = g - 1, is_p = true;
    } else if (o <= np + nbulk) {
      o -= np + 1;
      st = g - 1;
      j = g + 1;
      while (o >= nt - j) o -= nt - j++;
      i = j + static_cast<int>(o);
    } else {
      i = g + 2, j = g + 1, st = g;
    }
    T* out = const_cast<T*>(tile(L, i, j));
    if (st >= 0) {
      // step st: tile (i, j) has steps 0 .. st - 1, L_i,st and L_j,st are
      // final (lanes 0-2 of warp 0 poll one counter each)
      if (tid < 3)
        wait_at_least(tid == 0 ? ctr(i, j) : ctr(tid == 1 ? i : j, st), tid == 0 ? st : st + 1);
      update(i, j, st, out);
    }
    if (is_p) {
      __threadfence();  // the update, before it is read back past the L1
      wait_cta(ctr(g, g), g + 1);
      panel(i, g);
      publish(ctr(i, j), g + 1);
    } else {
      publish(ctr(i, j), st + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// triangular solves: the separator form and the column-tiled form
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;  // both forms: 8 warps
constexpr int kSepStages = 8;      // separator form: tiles of L in flight per CTA
constexpr int kColTile = 32;       // column-tiled form: rhs columns per CTA

// Column-tiled form: tiles of L in flight per CTA, and the layout of its x
// rows.  f32: rows of 32 + 4 (16-byte aligned rows for float4 loads).  f64:
// rows of 32 with no pad and the two halves of a row swapped in odd rows,
// so that the four rows a DMMA B fragment reads fall on both bank halves,
// and a ring of 3 tiles: the x rows of M = 320 and the ring (108 KB) leave
// room for two CTAs per SM (f64 (40, 320, 176): 0.130 ms with 4 tiles, one
// CTA per SM and 8 more bytes a row; 0.109 with two CTAs; H100, PERF.md).
// The ring's depth is a constant: chosen per shape at run time (the
// deepest that keeps the occupancy) it made every shape 5-25% slower.
template <typename T>
constexpr int kColStages = sizeof(T) == 8 ? 3 : 4;
template <typename T>
constexpr int kLdx = kColTile + (sizeof(T) == 8 ? 0 : 4);
template <typename T>
__device__ __forceinline__ int xoff(int r, int c) {
  return r * kLdx<T> + (sizeof(T) == 8 ? c ^ ((r & 1) << 3) : c);
}

// The 32 x 32 block of the row-major (M, M) matrix l at (row0, col0) into
// s ([kNB][kLdv]) by 16-byte asynchronous copies (cp.async, one or two per
// thread of 256); rows and columns at or past M are zero-filled (M is a
// multiple of 8, so a copy never straddles M).  The caller commits.
template <typename T>
__device__ __forceinline__ void copy_tile(T* s, const T* l, int M, int row0, int col0) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kPerRow = kNB / kV;
#pragma unroll
  for (int q = threadIdx.x; q < kNB * kPerRow; q += kTileThreads) {
    const int r = q / kPerRow, c = (q % kPerRow) * kV;
    const bool ok = row0 + r < M && col0 + c < M;
    cp_async16(s + r * kLdv<T> + c, ok ? l + static_cast<size_t>(row0 + r) * M + col0 + c : l, ok);
  }
}

// Separator form (trsm_sep_kernel): X = L^-1 B or L^-T B for K matrices of
// any M, in chains of one matrix and one 8-column group of B, all chains'
// 32-row blocks spread over every SM.  A CTA takes a block from the ticket
// counter ws[0] in wavefront order (fwd: ascending, bwd: descending), so
// the blocks it then waits on are held by CTAs that run already, and the
// launch needs no co-residency.  For its block i it
//  * streams the blocks of L it needs through a ring of kSepStages tiles in
//    shared memory, in the order the wavefront publishes x: fwd the row
//    blocks L_ip (p < i), bwd the column blocks L_pi (p > i), each row
//    segment 128 or 256 contiguous bytes;
//  * inverts D_i (invert_diag) while the first tiles arrive;
//  * for each tile: warp 0 makes sure x_p is published (the flag of (chain,
//    p) at ws[1 + chain * P + p], read with acquire; 32 flags per poll
//    while catching up, then one lane spinning on the next, trapping after
//    kPollLimit polls) and reads x_p from X past the L1 (ld.global.cg) into
//    a double-buffered tile; all threads then subtract L_ip x_p (or
//    L_pi^T x_p) from their entry of r_i, thread (ti, ts) summing over the
//    tile's 32 columns in order;
//  * forms x_i = D_i^-1 r_i (D_i^-T r_i), writes it to X and publishes it:
//    CTA barrier, __threadfence, flag stored with release.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kTileThreads)
    trsm_sep_kernel(const T* __restrict__ L, const T* __restrict__ B, T* X, int K, int M, int S,
                    unsigned* ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);          // [kSepStages][kNB][kLdv]
  T* dinv = ring + kSepStages * kNB * kLdv<T>;   // [kNB][kLdd]
  T* xs = dinv + kNB * kLdd;                     // [2][kNB][kTrsmCols]: x_p
  T* rs = xs + 2 * kNB * kTrsmCols;              // [kNB][kTrsmCols]: r_i
  int* ticket = reinterpret_cast<int*>(rs + kNB * kTrsmCols);  // the block taken
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid / kTrsmCols, ts = tid % kTrsmCols;
  const int P = (M + kNB - 1) / kNB;
  const int G = (S + kTrsmCols - 1) / kTrsmCols;
  const int chains = K * G;
  int seq = 0;  // tiles this CTA has taken through the ring
  for (;;) {
    if (tid == 0) *ticket = static_cast<int>(atomicAdd(ws, 1u));
    __syncthreads();
    const int t = *ticket;
    if (t >= chains * P) break;
    const int chain = t % chains, step = t / chains;
    const int k = chain / G, c0 = (chain % G) * kTrsmCols, nc = imin(kTrsmCols, S - c0);
    const int i = kBwd ? P - 1 - step : step;
    const int wi = panel_width(M, i);
    const int ntiles = kBwd ? P - 1 - i : i;
    const T* l = L + static_cast<size_t>(k) * M * M;
    T* xk = X + static_cast<size_t>(k) * M * S + c0;
    unsigned* flag = ws + 1 + static_cast<size_t>(chain) * P;
    // tile j: fwd the block (i, j), bwd the block (P - 1 - j, i)
    auto issue = [&](int j) {
      if (j < ntiles) {
        const int p = kBwd ? P - 1 - j : j;
        copy_tile<T>(ring + ((seq + j) % kSepStages) * kNB * kLdv<T>, l, M,
                     (kBwd ? p : i) * kNB, (kBwd ? i : p) * kNB);
      }
      cp_async_commit();
    };
    for (int j = 0; j < kSepStages - 1; ++j) issue(j);
    T acc = (ti < wi && ts < nc)
                ? B[(static_cast<size_t>(k) * M + i * kNB + ti) * S + c0 + ts] : T(0);
    invert_diag<T, kBwd>(l + static_cast<size_t>(i * kNB) * M + i * kNB, M, wi, dinv);
    int ready = kBwd ? P : 0;  // warp 0: x published for p < ready (fwd), p >= ready (bwd)
    for (int j = 0; j < ntiles; ++j) {
      const int p = kBwd ? P - 1 - j : j;
      T* xb = xs + (j & 1) * kNB * kTrsmCols;
      if (warp == 0) {
        if (kBwd ? p < ready : p >= ready) {
          const int q = kBwd ? p - lane : p + lane;
          const bool mine = kBwd ? q > i : q < i;
          const unsigned set = __ballot_sync(kFull, mine && ld_acquire(flag + q) != 0u);
          int n = set == kFull ? 32 : __ffs(~set) - 1;  // published in a row from p
          if (n == 0) {
            if (lane == 0)
              for (unsigned tries = 0; ld_acquire(flag + p) == 0u; ++tries)
                if (tries > kPollLimit) __trap();
            n = 1;
          }
          __syncwarp();
          ready = kBwd ? p - n + 1 : p + n;
        }
        const int wp = panel_width(M, p);
#pragma unroll
        for (int e = lane; e < kNB * kTrsmCols; e += 32) {
          const int r = e / kTrsmCols, c = e % kTrsmCols;
          xb[e] = (r < wp && c < nc) ? __ldcg(xk + static_cast<size_t>(p * kNB + r) * S + c) : T(0);
        }
      }
      cp_async_wait<kSepStages - 2>();
      __syncthreads();  // tile j and x_p in place; every thread is past tile j - 1
      issue(j + kSepStages - 1);
      const T* a = ring + ((seq + j) % kSepStages) * kNB * kLdv<T>;
#pragma unroll 8
      for (int c = 0; c < kNB; ++c)
        acc -= (kBwd ? a[c * kLdv<T> + ti] : a[ti * kLdv<T> + c]) * xb[c * kTrsmCols + ts];
    }
    seq += ntiles;
    rs[tid] = acc;
    __syncthreads();
    T x = T(0);
    const T* o = dinv + ti * kLdd;
#pragma unroll 8
    for (int c = 0; c < kNB; ++c) x += o[c] * rs[c * kTrsmCols + ts];
    if (ti < wi && ts < nc) xk[static_cast<size_t>(i * kNB + ti) * S + ts] = x;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(flag + i, 1u);
    }
  }
}

// r -= A x_p over one tile for this thread's four entries of the r block:
// row `row`, columns col[0..3] (fwd A = the tile, bwd A = its transpose).
// f32: FFMA, a row of the tile read as 16-byte vectors (fwd) and x_p's four
// columns as one; f64: DMMA (mma.sync m8n8k4), warp w the rows 8(w % 4) ..
// + 7 and the columns 16(w / 4) .. + 15 of the block, as two 8 x 8 C
// fragments: lane (g, t) = (lane / 4, lane % 4) holds rows g, columns 2t and
// 2t + 1 of each.
template <bool kBwd>
__device__ __forceinline__ void tile_update(const float* a, const float* x, float* acc) {
  const int row = threadIdx.x >> 3, cb = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int c4 = 0; c4 < kNB; c4 += 4) {
    float av[4];
    if (kBwd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) av[e] = a[(c4 + e) * kLdv<float> + row];
    } else {
      unpack(*reinterpret_cast<const float4*>(a + row * kLdv<float> + c4), av);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float xv[4];
      unpack(*reinterpret_cast<const float4*>(x + (c4 + e) * kLdx<float> + cb), xv);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] -= av[e] * xv[u];
    }
  }
}

__device__ __forceinline__ void dmma(double* c, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

template <bool kBwd>
__device__ __forceinline__ void tile_update(const double* a, const double* x, double* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = 8 * (warp & 3) + g, n = 16 * (warp >> 2) + g;
#pragma unroll
  for (int k4 = 0; k4 < kNB; k4 += 4) {
    const int kk = k4 + t;
    const double av = kBwd ? a[kk * kLdv<double> + m] : a[m * kLdv<double> + kk];
    dmma(acc, -av, x[xoff<double>(kk, n)]);
    dmma(acc + 2, -av, x[xoff<double>(kk, n + 8)]);
  }
}

// This thread's four entries of a 32 x 32 block in tile_update's layout:
// their row and column.
template <typename T>
__device__ __forceinline__ int frag_row() {
  if (sizeof(T) == 4) return threadIdx.x >> 3;
  return 8 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
template <typename T>
__device__ __forceinline__ int frag_col(int u) {
  if (sizeof(T) == 4) return (threadIdx.x & 7) * 4 + u;
  return 16 * (threadIdx.x >> 7) + 8 * (u >> 1) + 2 * (threadIdx.x & 3) + (u & 1);
}

// x <- D^-1 x (fwd) or D^-T x (bwd) for the wp x wp lower block d ([kNB]
// [kLdv]) and the 32 columns of x (32 rows at xoff) in place, by substitution:
// warp w takes columns 4w .. 4w + 3, lane = row, one step per pivot (fwd
// from the first, bwd from the last), each multiplying by the pivot's
// reciprocal (a frozen pivot, L_jj = 1e10, gives entries of ~1e-10 x).
template <typename T, bool kBwd>
__device__ __forceinline__ void diag_solve(const T* d, int wp, T* x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T rcp = lane < wp ? T(1) / d[lane * kLdv<T> + lane] : T(0);
  T v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = x[xoff<T>(lane, 4 * warp + u)];
#pragma unroll 4
  for (int s = 0; s < wp; ++s) {
    const int c = kBwd ? wp - 1 - s : s;
    const T dr = __shfl_sync(kFull, rcp, c);
    const T lr = kBwd ? (lane < c ? d[c * kLdv<T> + lane] : T(0))
                      : (lane > c && lane < wp ? d[lane * kLdv<T> + c] : T(0));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T xv = __shfl_sync(kFull, v[u], c) * dr;
      v[u] = (lane == c) ? xv : v[u] - lr * xv;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) x[xoff<T>(lane, 4 * warp + u)] = v[u];
}

// Column-tiled form (trsm_cols_kernel): one CTA per matrix and 32 columns
// of B, no cluster, no communication between CTAs.  The CTA keeps its 32
// columns of x for all M rows in shared memory and walks the row blocks in
// wavefront order, left-looking: for block i, r_i = B_i - sum_p L_ip x_p
// (bwd: L_pi^T x_p) over the solved blocks p in wavefront order, in
// registers, then x_i = D_i^-1 r_i by substitution on the diagonal block.
// Every block of the lower triangle is read once, in that order, through a
// ring of kColStages tiles (cp.async).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kTileThreads)
    trsm_cols_kernel(const T* __restrict__ L, const T* __restrict__ B, T* __restrict__ X, int M,
                     int S) {
  constexpr int kStages = kColStages<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);       // [kStages][kNB][kLdv]
  T* xs = ring + kStages * kNB * kLdv<T>;     // [P * kNB] rows at xoff: r_i, then x_i
  const int P = (M + kNB - 1) / kNB;
  const int nct = (S + kColTile - 1) / kColTile;
  const size_t k = blockIdx.x / nct;
  const int c0 = (blockIdx.x % nct) * kColTile, nc = imin(kColTile, S - c0);
  const T* l = L + k * M * M;
  const int row = frag_row<T>();
  // the tile stream: step s of the wavefront (block i), its solved blocks
  // q < s in wavefront order, then the diagonal (q = s)
  int is = 0, iq = 0;
  auto issue = [&](int j) {
    if (is < P) {
      const int i = kBwd ? P - 1 - is : is, p = kBwd ? P - 1 - iq : iq;
      copy_tile<T>(ring + (j % kStages) * kNB * kLdv<T>, l, M, (kBwd ? p : i) * kNB,
                   (kBwd ? i : p) * kNB);
      if (++iq > is) ++is, iq = 0;
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  int j = 0;
  for (int s = 0; s < P; ++s) {
    const int i = kBwd ? P - 1 - s : s;
    const int ri = i * kNB + row;
    T acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc[u] = (ri < M && frag_col<T>(u) < nc) ? B[(k * M + ri) * S + c0 + frag_col<T>(u)] : T(0);
    for (int q = 0; q <= s; ++q, ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile j in place; every thread is past tile j - 1
      issue(j + kStages - 1);
      const T* a = ring + (j % kStages) * kNB * kLdv<T>;
      if (q < s) {
        const int p = kBwd ? P - 1 - q : q;
        tile_update<kBwd>(a, xs + p * kNB * kLdx<T>, acc);
      } else {
        T* xi = xs + i * kNB * kLdx<T>;
#pragma unroll
        for (int u = 0; u < 4; ++u) xi[xoff<T>(row, frag_col<T>(u))] = acc[u];
        __syncthreads();
        diag_solve<T, kBwd>(a, panel_width(M, i), xi);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M * nc; e += kTileThreads) {
    const int r = e / nc, c = e - r * nc;
    X[(k * M + r) * S + c0 + c] = xs[xoff<T>(r, c)];
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
// M = 320 at K <= 17 ((1, 320): 0.174 against 0.199) and up to 392 at
// K = 40 (0.300 against 0.305), the large form from 392 ((1, 392): 0.266
// against 0.292) and 440 at K = 40 (0.326 against 0.367); f64 the large
// form wins from 296 at K <= 17 ((17, 320): 0.320 against 0.339), and
// from 392 at K = 40 ((40, 320): 0.343 against 0.340 streaming).
template <typename T>
int chol_large_from(int K) {
  if (sizeof(T) == 4) return K >= 40 ? 440 : 392;
  return K >= 40 ? 392 : 296;
}

// The form of one (K, M, dtype) on a device: resident where the packed
// triangle fits beside the rest in the 227 KB opt-in (f32 M <= 288, f64 M
// <= 192 on an H100); below chol_large_from(K) streaming, with the deepest
// W^T that fits beside at least 32 staged panel rows and as many staged
// rows (multiples of 32, up to one per thread) as then fit; else the large
// form on kTile-wide tiles, on a grid of as many CTAs as the card
// holds at once, at most one per task.
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
  constexpr size_t smem = tiled_smem<T, kTile>();
  if (smem > cap) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (M + kTile - 1) / kTile;
  const long long tasks = static_cast<long long>(K) * tiled_tasks(nt);
  if (tasks >= 0xffffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chol_tiled_kernel<T, kTile>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_tiled_kernel<T, kTile>,
                                                        kTiledThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = tasks < static_cast<long long>(sms) * per_sm ? tasks : sms * per_sm;
  *out = {CholForm::kLarge, 0, 0, smem, static_cast<int>(grid)};
  return 0;
}

// The large form's workspace: the ticket and the tiles' counters (zeroed
// on the stream by each launch), then the inverted diagonal tiles.  Bytes.
size_t tiled_counter_bytes(int K, int M) {
  const size_t nt = (M + kTile - 1) / kTile;
  return align_up(sizeof(unsigned) * (1 + K * nt * (nt + 1) / 2), 256);
}
template <typename T>
size_t chol_workspace_bytes(const CholLaunch& c, int K, int M) {
  if (c.form != CholForm::kLarge) return 0;
  const size_t nt = (M + kTile - 1) / kTile;
  return tiled_counter_bytes(K, M) + sizeof(T) * static_cast<size_t>(K) * (nt - 1) * kTile * kTile;
}

// The plan of (device, K, M), made on its first use and kept.
template <typename T>
int chol_launch_of(int K, int M, CholLaunch* c) {
  static std::mutex mu;
  static std::map<std::array<int, 3>, CholLaunch> plans;
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  const std::array<int, 3> key = {dev, K, M};
  auto it = plans.find(key);
  if (it == plans.end()) {
    if (int err = plan_chol<T>(K, M, c)) return err;
    it = plans.emplace(key, *c).first;
  }
  *c = it->second;
  return 0;
}

// Launches the plan's form.  ws holds chol_workspace_bytes (the large form's
// counters, zeroed here on the stream first, and inverted tiles).
template <typename T>
int launch_chol(const void* A, void* L, int K, int M, double clamp, void* ws, void* stream) {
  CholLaunch c;
  if (int err = chol_launch_of<T>(K, M, &c)) return err;
  const T* a = static_cast<const T*>(A);
  T* l = static_cast<T*>(L);
  T cl = static_cast<T>(clamp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c.form == CholForm::kLarge) {
    if (!ws) return static_cast<int>(cudaErrorInvalidValue);
    const size_t cb = tiled_counter_bytes(K, M);
    if (cudaError_t err = cudaMemsetAsync(ws, 0, cb, s)) return static_cast<int>(err);
    chol_tiled_kernel<T, kTile><<<c.grid, kTiledThreads, c.smem, s>>>(
        a, l, K, M, cl, static_cast<unsigned*>(ws),
        reinterpret_cast<T*>(static_cast<unsigned char*>(ws) + cb));
  } else if (c.form == CholForm::kResident) {
    chol_kernel<T, true><<<K, kCholThreads, c.smem, s>>>(a, l, M, c.kc, c.rs, cl);
  } else {
    chol_kernel<T, false><<<K, kCholThreads, c.smem, s>>>(a, l, M, c.kc, c.rs, cl);
  }
  return static_cast<int>(cudaGetLastError());
}

// The workspace bytes a launch of (K, M) needs (0 for the one-CTA forms).
template <typename T>
int chol_workspace(int K, int M, long long* out) {
  CholLaunch c;
  if (int err = chol_launch_of<T>(K, M, &c)) return err;
  *out = static_cast<long long>(chol_workspace_bytes<T>(c, K, M));
  return 0;
}

// The form plan_chol takes for (K, M) on the current device: 0 resident,
// 1 streaming, 2 large.
template <typename T>
int chol_form(int K, int M, int* out) {
  CholLaunch c;
  if (int err = chol_launch_of<T>(K, M, &c)) return err;
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

// The cluster form's kernel for G column groups per cluster.  A launch
// chooses G from kGroupChoices: each choice is one more kernel to build.  The
// cluster form's right-hand sides have one group (S <= 8) or six (the dense
// frames' S = 48), where G = 6 (f32) and G = 3 (f64) take the fewest waves;
// G = 2 was never chosen there.
template <typename T>
using TrsmKernel = void (*)(const T*, const T*, T*, int, int, TrsmPlan);

constexpr int kGroupChoices[] = {1, 3, 6};

template <typename T, bool kBwd>
TrsmKernel<T> trsm_kernel_for(int G) {
  switch (G) {
    case 1: return trsm_kernel<T, kBwd, 1>;
    case 3: return trsm_kernel<T, kBwd, 3>;
    default: return trsm_kernel<T, kBwd, 6>;
  }
}

// The three forms; the numbers are those of dk.TRSM_FORMS.
enum class TrsmForm { kCluster = 0, kSeparator = 1, kColumns = 2 };

// A launch: the form, the cluster form's plan, the grid of CTAs and the
// dynamic shared memory.
struct TrsmLaunch {
  TrsmForm form;
  TrsmPlan q;
  unsigned ctas;
  size_t smem;
};

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

// The cluster form's plan on the current device, setting the kernels'
// attributes there.  For G column groups per cluster, the cluster size is C
// = min(ceil(M / 32), 16), lowered while the card reports that no cluster of
// that size fits.  G is the choice whose K x ceil(groups / G) clusters take
// the fewest waves of the clusters the card holds at once (the least G among
// equals): more groups per cluster share one slab load and wavefront where
// the grid would not fit on the card at once, and cost shared memory (the x
// tiles grow with G) and longer steps.  cudaErrorInvalidValue where no plan
// fits: every CTA must hold the x tiles of all P panels.
template <typename T, bool kBwd>
int plan_cluster(int K, int M, int S, int optin, TrsmLaunch* out) {
  const int ncg = (S + kTrsmCols - 1) / kTrsmCols;
  long long best = -1;  // waves of the plan in *out
  int prev = 0;         // clusters per matrix of the choice before
  for (int G : kGroupChoices) {
    const int per = (ncg + G - 1) / G;  // clusters per matrix
    if (per == prev) continue;          // a larger G for as many clusters
    prev = per;
    int active = 0;
    TrsmLaunch t{};
    for (int C = imin((M + kNB - 1) / kNB, kMaxCluster); C >= 1 && !active; --C) {
      t.form = TrsmForm::kCluster;
      t.q = make_plan<T>(M, C, G, static_cast<size_t>(optin));
      const long long ctas = static_cast<long long>(K) * per * C;
      if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
      t.ctas = static_cast<unsigned>(ctas);
      size_t used = 0;
      for (int r = 0; r < C; ++r) {
        const size_t u = place_slabs<T, kBwd>(t.q, M, r, nullptr);
        used = u > used ? u : used;
      }
      t.smem = t.q.slab + used;
      if (t.smem > static_cast<size_t>(optin)) continue;
      auto kernel = trsm_kernel_for<T, kBwd>(G);
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

// Separator form: as many CTAs as the card holds at once, at most one per
// (chain, block).
template <typename T, bool kBwd>
int plan_separator(int K, int M, int S, int optin, TrsmLaunch* out) {
  // no static shared memory: the opt-in bounds dynamic and static together
  const size_t smem = sizeof(T) * (static_cast<size_t>(kSepStages) * kNB * kLdv<T> + kNB * kLdd +
                                   3 * kNB * kTrsmCols) + 16;
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(K) * ((S + kTrsmCols - 1) / kTrsmCols) *
                           ((M + kNB - 1) / kNB);
  if (blocks >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trsm_sep_kernel<T, kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trsm_sep_kernel<T, kBwd>,
                                                        kTileThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ctas = imin(static_cast<int>(blocks), sms * per_sm);
  *out = {TrsmForm::kSeparator, {}, static_cast<unsigned>(ctas), smem};
  return 0;
}

// Column-tiled form: one CTA per matrix and 32 columns; its x rows (M of
// them) must fit in shared memory beside the ring (f64 M <= 800, f32 M <=
// 1472 on a 227 KB opt-in).
template <typename T, bool kBwd>
int plan_columns(int K, int M, int S, int optin, TrsmLaunch* out) {
  const int P = (M + kNB - 1) / kNB;
  const size_t smem = sizeof(T) * (static_cast<size_t>(kColStages<T>) * kNB * kLdv<T> +
                                   static_cast<size_t>(P) * kNB * kLdx<T>);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = static_cast<long long>(K) * ((S + kColTile - 1) / kColTile);
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (cudaError_t err = cudaFuncSetAttribute(trsm_cols_kernel<T, kBwd>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
    return static_cast<int>(err);
  *out = {TrsmForm::kColumns, {}, static_cast<unsigned>(ctas), smem};
  return 0;
}

// The least M from which one column group (S <= 8) takes the separator
// form, for K matrices; below it the cluster form.
template <typename T, bool kBwd>
int separator_from(int K) {
  if (kBwd) return K >= (sizeof(T) == 4 ? 40 : 17) ? 320 : 544;
  return sizeof(T) == 4 ? 1152 : (K >= 40 ? 320 : 672);
}

// Whether the column-tiled form is taken where it fits: K ceil(S / 32)
// CTAs, at least 32 of them for more than one column group, at least one
// per SM for one.
bool columns_first(int K, int S, int sms) {
  const long long ctas = static_cast<long long>(K) * ((S + kColTile - 1) / kColTile);
  return ctas >= (S > kTrsmCols ? 32 : sms);
}

// The plan of (K, M, S) on the current device: the column-tiled form where
// columns_first and its x rows fit; else, for one column group, the
// separator form from separator_from(K); else the cluster form where every
// CTA holds all x tiles; else the separator form, which takes any M that
// memory holds.
template <typename T, bool kBwd>
int plan_trsm(int K, int M, int S, TrsmLaunch* out) {
  int optin = 0;
  if (int err = optin_smem(&optin)) return err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (columns_first(K, S, sms) && plan_columns<T, kBwd>(K, M, S, optin, out) == 0) return 0;
  if (S <= kTrsmCols && M >= separator_from<T, kBwd>(K))
    return plan_separator<T, kBwd>(K, M, S, optin, out);
  const int cl = plan_cluster<T, kBwd>(K, M, S, optin, out);
  if (cl != static_cast<int>(cudaErrorInvalidValue)) return cl;
  return plan_separator<T, kBwd>(K, M, S, optin, out);
}

// The plan of (device, K, M, S), made on its first use and kept: the
// occupancy queries and attribute calls cost microseconds of host time, more
// than the launch itself.
template <typename T, bool kBwd>
int trsm_launch_of(int K, int M, int S, TrsmLaunch* l) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, TrsmLaunch> plans;
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  const std::array<int, 4> key = {dev, K, M, S};
  auto it = plans.find(key);
  if (it == plans.end()) {
    if (int err = plan_trsm<T, kBwd>(K, M, S, l)) return err;
    it = plans.emplace(key, *l).first;
  }
  *l = it->second;
  return 0;
}

// Launches the plan's form.  ws holds 1 + K ceil(S / 8) ceil(M / 32)
// unsigned ints (the separator form's ticket counter and flags); the
// separator form zeroes them on the stream first.
template <typename T, bool kBwd>
int launch_trsm(const void* L, const void* B, void* X, int K, int M, int S, void* ws,
                void* stream) {
  TrsmLaunch l;
  if (int err = trsm_launch_of<T, kBwd>(K, M, S, &l)) return err;
  const T* a = static_cast<const T*>(L);
  const T* b = static_cast<const T*>(B);
  T* x = static_cast<T*>(X);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.form == TrsmForm::kSeparator) {
    const size_t n = 1 + static_cast<size_t>(K) * ((S + kTrsmCols - 1) / kTrsmCols) *
                             ((M + kNB - 1) / kNB);
    if (cudaError_t err = cudaMemsetAsync(ws, 0, n * sizeof(unsigned), s))
      return static_cast<int>(err);
    trsm_sep_kernel<T, kBwd><<<l.ctas, kTileThreads, l.smem, s>>>(a, b, x, K, M, S,
                                                                  static_cast<unsigned*>(ws));
  } else if (l.form == TrsmForm::kColumns) {
    trsm_cols_kernel<T, kBwd><<<l.ctas, kTileThreads, l.smem, s>>>(a, b, x, M, S);
  } else {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    set_config(cfg, attr, l, stream);
    if (cudaError_t err = cudaLaunchKernelEx(&cfg, trsm_kernel_for<T, kBwd>(l.q.G), a, b, x, M, S, l.q))
      return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd>
int trsm_form(int K, int M, int S, int* out) {
  TrsmLaunch l;
  if (int err = trsm_launch_of<T, kBwd>(K, M, S, &l)) return err;
  *out = static_cast<int>(l.form);
  return 0;
}

}  // namespace

extern "C" {

int slampp_chol_f32(const void* A, void* L, int K, int M, double clamp, void* ws,
                    void* stream) {
  return launch_chol<float>(A, L, K, M, clamp, ws, stream);
}
int slampp_chol_f64(const void* A, void* L, int K, int M, double clamp, void* ws,
                    void* stream) {
  return launch_chol<double>(A, L, K, M, clamp, ws, stream);
}
int slampp_chol_workspace(int f64, int K, int M, long long* out) {
  return f64 ? chol_workspace<double>(K, M, out) : chol_workspace<float>(K, M, out);
}
int slampp_trsm_fwd_f32(const void* L, const void* B, void* X, int K, int M, int S,
                         void* ws, void* stream) {
  return launch_trsm<float, false>(L, B, X, K, M, S, ws, stream);
}
int slampp_trsm_fwd_f64(const void* L, const void* B, void* X, int K, int M, int S,
                         void* ws, void* stream) {
  return launch_trsm<double, false>(L, B, X, K, M, S, ws, stream);
}
int slampp_trsm_bwd_f32(const void* L, const void* B, void* X, int K, int M, int S,
                         void* ws, void* stream) {
  return launch_trsm<float, true>(L, B, X, K, M, S, ws, stream);
}
int slampp_trsm_bwd_f64(const void* L, const void* B, void* X, int K, int M, int S,
                         void* ws, void* stream) {
  return launch_trsm<double, true>(L, B, X, K, M, S, ws, stream);
}
int slampp_trsm_form(int f64, int bwd, int K, int M, int S, int* out) {
  if (f64) return bwd ? trsm_form<double, true>(K, M, S, out) : trsm_form<double, false>(K, M, S, out);
  return bwd ? trsm_form<float, true>(K, M, S, out) : trsm_form<float, false>(K, M, S, out);
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
