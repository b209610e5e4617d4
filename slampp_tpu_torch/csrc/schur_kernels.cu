// The fine-slot sums of the sparse Schur engine's reduced pose system
// (linear/schur_sparse.py, under ss.pairs), float64, for NVIDIA Hopper
// (sm_90a): every Hessian contribution of a hit slot of the v3 fine-block
// layout, the head blocks (pose-pose Hii, Hjj, Hij and pose-landmark Hpp)
// and the pair corrections -BD[e] B[f]^T of the observation pairs that
// share a landmark, summed into that slot.
//
// It replaces no Pallas kernel: the JAX package's pair corrections and slot
// sums (slampp_tpu/linear/schur_sparse.py) were an XLA einsum over gathered
// rows and a segment sum.  The port's plain version, which CPU operands keep
// (ops/schur_kernels.slot_sums_plain), forms every pair correction as a 7 x 7
// (bs x bs) block in device memory, concatenates them after the head blocks
// and sums the concatenation in grouped segments.  At venice871_sim3
// (2,792,206 observations, 13.9M ordered pairs) that wrote ~5.4 GB of pair
// blocks, copied them again into the concatenation and gathered them into
// padded groups: ~90 ms of device time an LM iteration on an H100 (PERF.md).
//
// slot_sum_kernel<BS, DL>: table slot s (one CTA of one warp) writes the block
// out[out_slot[s]] (BS x BS), the sum of
//   its head blocks heads[hptr[s] .. hptr[s + 1]): code h indexes the
//     concatenation [Hii | Hjj | Hij | Hpp] (n_pp rows each of the first
//     three), ~h the same block transposed;
//   its pair corrections pptr[s] .. pptr[s + 1]: -BD[pair_e[i]] B[pair_f[i]]^T,
//     BD and B (n_pl, BS, DL).
// The engine orders the table's slots (the diagonal slots, which hold the
// most terms, first; then the rest by their larger and smaller pose index,
// so that the CTAs working at once share the row camera's BD rows in L2);
// within a slot the terms keep the routing order.
//
// Bound: bytes.  Each head block (BS^2 doubles) and each pair's two rows
// (2 BS DL doubles) read once, and each slot block written once.  At
// venice871_sim3 (PERF.md gives the counts) that is the Hpp blocks (2.79M x
// 392 B), the BD and B rows of each kept pair (168 B each) where L2 does not
// hold them, and the slot blocks; the reads of each row once, ~2.0 GB, are
// ~0.6 ms at 3.35 TB/s.  The arithmetic (BS^2 DL multiply-adds a pair, 147 at
// (7, 3)) is ~0.1 ms of the card's float64 rate.
// Design:
//  * One warp a slot, the lanes over the slot's terms: lane l takes terms
//    l, l + 32, ... in table order and keeps its own BS x BS partial sum in
//    registers, so a pair's 147 multiply-adds run on the 42 doubles it
//    loads, from registers.  (Lanes over the block's entries would need a
//    shared-memory load for every multiply-add.)  A slot's terms never
//    reach device memory: no pair block, no concatenation, no padded group.
//  * The terms' rows are staged 32 terms at a time through shared memory
//    with cp.async: the lanes copy consecutive doubles of the rows, so a
//    warp's copy covers one or two rows' sectors, not 32 scattered rows, and
//    every copy of a chunk is in flight at once with no register on the way
//    (a slot is a chain of chunks, each one memory latency: few in flight
//    would make it several).  Each lane reads its table entry of the next
//    chunk before the current one is staged.  Staged rows have an odd stride
//    in doubles, so the lanes' reads of their own rows fall in distinct
//    banks.
//  * The lanes' partial sums meet in shared memory and lane k sums entry k
//    over the 32 lanes in lane order, then writes it: a fixed order
//    throughout and no float atomics, so the same operands give the same
//    bits run after run (the LM gain test compares chi2).
//  * Templated on (BS, DL) and built for the pose dims 3, 5, 6, 7 and the
//    landmark dims 1, 2, 3 of the registered vertex types (the engine
//    requires uniform dims), so the block lives in registers at every size.
//  * float64 throughout, as the engine's edge terms are.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // one warp a CTA, one CTA a table slot

template <int BS, int DL>
struct SlotDims {
  static constexpr int kNB = BS * BS;  // a block's doubles
  static constexpr int kNR = BS * DL;  // a BD or B row's doubles
  static constexpr int kSB = kNB | 1;  // staged strides, odd
  static constexpr int kSR = kNR | 1;
  static constexpr int kStage =
      kLanes * kSB > 2 * kLanes * kSR ? kLanes * kSB : 2 * kLanes * kSR;
};

// One double from device to shared memory without a register on the way
// (cp.async: the copies of a chunk are all in flight at once).
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Stages n rows of W doubles (row r at rows[r]) to dst + r * S: the lanes
// copy consecutive doubles, every copy of the chunk in flight at once.
template <int W, int S>
__device__ __forceinline__ void stage_rows(double* dst, const double* const* rows, int n) {
  const int cnt = n * W;
  for (int g = threadIdx.x; g < cnt; g += kLanes) {
    const int r = g / W;
    copy_async(dst + r * S + (g - r * W), rows[r] + (g - r * W));
  }
  copy_async_wait();
}

template <int BS, int DL>
__global__ void __launch_bounds__(kLanes)
    slot_sum_kernel(const double* __restrict__ hii, const double* __restrict__ hjj,
                    const double* __restrict__ hij, const double* __restrict__ hpp,
                    const double* __restrict__ bd, const double* __restrict__ b,
                    const int* __restrict__ out_slot, const int* __restrict__ hptr,
                    const int* __restrict__ heads, const int* __restrict__ pptr,
                    const int* __restrict__ pair_e, const int* __restrict__ pair_f, int n_pp,
                    double* __restrict__ out) {
  using D = SlotDims<BS, DL>;
  constexpr int NB = D::kNB, NR = D::kNR, SB = D::kSB, SR = D::kSR;
  __shared__ __align__(16) double stage[D::kStage];
  __shared__ const double* rows[2 * kLanes];
  const int lane = threadIdx.x;
  const int s = blockIdx.x;

  double acc[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) acc[k] = 0.0;

  // the head blocks, 32 at a time; each lane reads its table entry of the
  // next chunk while the current one is staged and summed
  const int h0 = __ldg(hptr + s), h1 = __ldg(hptr + s + 1);
  const int p0 = __ldg(pptr + s), p1 = __ldg(pptr + s + 1);
  int h_next = lane < h1 - h0 ? __ldg(heads + h0 + lane) : 0;
  int e_next = lane < p1 - p0 ? __ldg(pair_e + p0 + lane) : 0;
  int f_next = lane < p1 - p0 ? __ldg(pair_f + p0 + lane) : 0;
  for (int c0 = h0; c0 < h1; c0 += kLanes) {
    const int n = h1 - c0 < kLanes ? h1 - c0 : kLanes;
    const bool flip = h_next < 0;
    if (lane < n) {
      const int h = flip ? ~h_next : h_next;
      rows[lane] = h < n_pp       ? hii + static_cast<long long>(h) * NB
                   : h < 2 * n_pp ? hjj + static_cast<long long>(h - n_pp) * NB
                   : h < 3 * n_pp ? hij + static_cast<long long>(h - 2 * n_pp) * NB
                                  : hpp + static_cast<long long>(h - 3 * n_pp) * NB;
    }
    h_next = c0 + kLanes + lane < h1 ? __ldg(heads + c0 + kLanes + lane) : 0;
    __syncthreads();
    stage_rows<NB, SB>(stage, rows, n);
    __syncthreads();
    if (lane < n) {
      const double* blk = stage + lane * SB;
#pragma unroll
      for (int a = 0; a < BS; ++a)
#pragma unroll
        for (int c = 0; c < BS; ++c) acc[a * BS + c] += flip ? blk[c * BS + a] : blk[a * BS + c];
    }
    __syncthreads();  // the stage and the rows are free again
  }

  // the pair corrections, 32 at a time: BD rows staged first, then B rows
  for (int c0 = p0; c0 < p1; c0 += kLanes) {
    const int n = p1 - c0 < kLanes ? p1 - c0 : kLanes;
    if (lane < n) {
      rows[lane] = bd + static_cast<long long>(e_next) * NR;
      rows[n + lane] = b + static_cast<long long>(f_next) * NR;
    }
    const bool more = c0 + kLanes + lane < p1;
    e_next = more ? __ldg(pair_e + c0 + kLanes + lane) : 0;
    f_next = more ? __ldg(pair_f + c0 + kLanes + lane) : 0;
    __syncthreads();
    stage_rows<NR, SR>(stage, rows, 2 * n);
    __syncthreads();
    if (lane < n) {
      const double* x = stage + lane * SR;        // BD[e] (BS x DL)
      const double* y = stage + (n + lane) * SR;  // B[f]
      double yv[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) yv[k] = y[k];
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        double xa[DL];
#pragma unroll
        for (int k = 0; k < DL; ++k) xa[k] = x[a * DL + k];
#pragma unroll
        for (int c = 0; c < BS; ++c) {
          double p = xa[0] * yv[c * DL];
#pragma unroll
          for (int k = 1; k < DL; ++k) p = fma(xa[k], yv[c * DL + k], p);
          acc[a * BS + c] -= p;
        }
      }
    }
    __syncthreads();
  }

  // the lanes' partial sums, each entry summed over the lanes in lane order
#pragma unroll
  for (int k = 0; k < NB; ++k) stage[lane * SB + k] = acc[k];
  __syncthreads();
  double* o = out + static_cast<long long>(__ldg(out_slot + s)) * NB;
  for (int k = lane; k < NB; k += kLanes) {
    double v = stage[k];
    for (int j = 1; j < kLanes; ++j) v += stage[j * SB + k];
    o[k] = v;
  }
}

template <int BS, int DL>
int launch_slot_sums(const void* hii, const void* hjj, const void* hij, const void* hpp,
                     const void* bd, const void* b, const void* out_slot, const void* hptr,
                     const void* heads, const void* pptr, const void* pair_e, const void* pair_f,
                     int n_pp, int n_slots, void* out, cudaStream_t s) {
  slot_sum_kernel<BS, DL><<<static_cast<unsigned>(n_slots), kLanes, 0, s>>>(
      static_cast<const double*>(hii), static_cast<const double*>(hjj),
      static_cast<const double*>(hij), static_cast<const double*>(hpp),
      static_cast<const double*>(bd), static_cast<const double*>(b),
      static_cast<const int*>(out_slot), static_cast<const int*>(hptr),
      static_cast<const int*>(heads), static_cast<const int*>(pptr),
      static_cast<const int*>(pair_e), static_cast<const int*>(pair_f), n_pp,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int BS>
int launch_bs(int dl, const void* hii, const void* hjj, const void* hij, const void* hpp,
              const void* bd, const void* b, const void* out_slot, const void* hptr,
              const void* heads, const void* pptr, const void* pair_e, const void* pair_f,
              int n_pp, int n_slots, void* out, cudaStream_t s) {
  switch (dl) {
    case 1:
      return launch_slot_sums<BS, 1>(hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr,
                                     pair_e, pair_f, n_pp, n_slots, out, s);
    case 2:
      return launch_slot_sums<BS, 2>(hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr,
                                     pair_e, pair_f, n_pp, n_slots, out, s);
    case 3:
      return launch_slot_sums<BS, 3>(hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr,
                                     pair_e, pair_f, n_pp, n_slots, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out (n_slots, bs, bs): see slot_sum_kernel; bs in {3, 5, 6, 7}, dl in
// {1, 2, 3}, else cudaErrorInvalidValue and nothing is launched.
int slampp_slot_sums_f64(int bs, int dl, const void* hii, const void* hjj, const void* hij,
                         const void* hpp, const void* bd, const void* b, const void* out_slot,
                         const void* hptr, const void* heads, const void* pptr,
                         const void* pair_e, const void* pair_f, int n_pp, int n_slots,
                         void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slots <= 0) return 0;
  switch (bs) {
    case 3:
      return launch_bs<3>(dl, hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr, pair_e,
                          pair_f, n_pp, n_slots, out, s);
    case 5:
      return launch_bs<5>(dl, hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr, pair_e,
                          pair_f, n_pp, n_slots, out, s);
    case 6:
      return launch_bs<6>(dl, hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr, pair_e,
                          pair_f, n_pp, n_slots, out, s);
    case 7:
      return launch_bs<7>(dl, hii, hjj, hij, hpp, bd, b, out_slot, hptr, heads, pptr, pair_e,
                          pair_f, n_pp, n_slots, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
