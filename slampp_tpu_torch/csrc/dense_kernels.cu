// Batched dense Cholesky and triangular solves for NVIDIA Hopper (sm_90a).
//
// These replace the three Pallas TPU kernels of
// slampp_tpu/ops/dense_kernels.py, all of which ran through _batched_call
// (pl.pallas_call at dense_kernels.py:286):
//
//   chol_kernel      <- _chol_kernel      (dense_kernels.py:184), chol_batched
//   trsm_fwd_kernel  <- _trsm_fwd_kernel  (dense_kernels.py:215), trsm_lower_batched
//   trsm_bwd_kernel  <- _trsm_bwd_kernel  (dense_kernels.py:236), trsm_lower_t_batched
//
// Each computes what its TPU kernel computes, not a block-by-block copy: the
// TPU kernels walk 8-wide column panels through one-hot selection matmuls
// (a Mosaic workaround for dynamic lane slices); here a CTA walks panels of
// up to kNB = 32 columns with plain indexing.
//
// What bounds them on the H100: at the partitioned solver's shapes
// ((55, 192, 192) part frames, one (488, 488) separator on manhattan3500)
// the work is 0.1-20 MFLOP per call, far below what the card can do in a
// millisecond.  Launch latency and the serial dependence between panels set
// the time, not FLOPs or bytes.
//
// What the design does about it: one CTA owns one matrix (and, for the
// triangular solves, one group of kTrsmCols right-hand-side columns), so a
// call is a single launch with no inter-CTA synchronisation.  Blocking the
// serial loop by 32-wide panels cuts the CTA-wide barriers from ~3 per column
// to ~3 per panel; inside a panel the dependent steps run within one warp
// (shuffles and __syncwarp).  The factor is updated in place in the output
// buffer ((55, 192, 192) f32 is 8 MB, (488, 488) f64 1.9 MB: both stay in
// the 50 MB L2); the current panel is staged in shared memory, so the
// trailing update reads one operand from global memory instead of two.
//
// Pivot freezing (_chol_value, dense_kernels.py:69-112): the pivot test is
// taken on the fully updated diagonal entry d; d <= clamp (or NaN) gives
// d = 1e20, L_jj = sqrt(d), and the column multipliers divide by L_jj, so a
// failed pivot freezes its column at about 0 instead of amplifying it.
//
// Plain C interface for ctypes (slampp_tpu_torch/ops/_cuda.py): every entry
// point launches on the given stream, allocates nothing, does not
// synchronise, and returns a CUDA error code (cudaGetLastError() after the
// launch) so that a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;  // panel width: one warp's lanes
constexpr int kCholThreads = 512;
constexpr int kTrsmThreads = 256;
constexpr int kTrsmCols = 8;  // rhs columns per CTA: one warp each in the panel solve
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Right-looking blocked Cholesky of one (M, M) matrix per CTA, panel width
// nb (32, or 16 / 8 when a 32-wide panel of a large M does not fit in shared
// memory).  Dynamic shared memory: the diagonal block (kNB x (kNB+1)) and
// the panel below it ((M - nb) x (nb+1)); the +1 pads away bank conflicts.
template <typename T>
__global__ void chol_kernel(const T* __restrict__ A, T* __restrict__ L, int M,
                            int nb, T clamp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sD = reinterpret_cast<T*>(smem_raw);  // [kNB][kNB + 1]
  T* sP = sD + kNB * (kNB + 1);            // [M - nb][nb + 1]
  const int ldd = kNB + 1;
  const int ldp = nb + 1;
  const size_t base = static_cast<size_t>(blockIdx.x) * M * M;
  const T* a = A + base;
  T* l = L + base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // lower triangle of A into the output, upper triangle zeroed
  for (int idx = tid; idx < M * M; idx += blockDim.x) {
    const int i = idx / M;
    const int k = idx - i * M;
    l[idx] = (k <= i) ? a[idx] : T(0);
  }
  __syncthreads();

  for (int j0 = 0; j0 < M; j0 += nb) {
    const int w = min(nb, M - j0);  // this panel's width
    const int j1 = j0 + w;
    // 1. the fully updated diagonal block, factored by warp 0
    for (int idx = tid; idx < w * w; idx += blockDim.x) {
      const int r = idx / w;
      const int c = idx - r * w;
      sD[r * ldd + c] = l[static_cast<size_t>(j0 + r) * M + j0 + c];
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < w; ++j) {
        T d = sD[j * ldd + j];
        d = (d > clamp) ? d : T(1e20);
        const T ljj = sqrt_t(d);
        __syncwarp();
        if (lane == j) sD[j * ldd + j] = ljj;
        if (lane > j && lane < w) sD[lane * ldd + j] /= ljj;
        __syncwarp();
        if (lane > j && lane < w) {
          const T lij = sD[lane * ldd + j];
          for (int k = j + 1; k <= lane; ++k) sD[lane * ldd + k] -= lij * sD[k * ldd + j];
        }
        __syncwarp();
      }
      for (int r = lane; r < w; r += 32)
        for (int c = 0; c <= r; ++c) l[static_cast<size_t>(j0 + r) * M + j0 + c] = sD[r * ldd + c];
    }
    __syncthreads();
    // 2. the panel below: row i solves x Ld^T = a (one thread per row),
    //    into the output and into shared memory for the trailing update
    for (int i = j1 + tid; i < M; i += blockDim.x) {
      T* row = l + static_cast<size_t>(i) * M + j0;
      T x[kNB];
#pragma unroll
      for (int t = 0; t < kNB; ++t) {
        if (t < w) {
          T v = row[t];
#pragma unroll
          for (int k = 0; k < t; ++k) v -= x[k] * sD[t * ldd + k];
          x[t] = v / sD[t * ldd + t];
        }
      }
      T* p = sP + (i - j1) * ldp;
#pragma unroll
      for (int t = 0; t < kNB; ++t) {
        if (t < w) {
          row[t] = x[t];
          p[t] = x[t];
        }
      }
    }
    __syncthreads();
    // 3. trailing update of the lower triangle: one warp per row, lanes
    //    along the row (coalesced read-modify-write)
    for (int i = j1 + warp; i < M; i += nwarps) {
      const T* pi = sP + (i - j1) * ldp;
      T* row = l + static_cast<size_t>(i) * M;
      for (int k = j1 + lane; k <= i; k += 32) {
        const T* pk = sP + (k - j1) * ldp;
        T acc = row[k];
        for (int t = 0; t < w; ++t) acc -= pi[t] * pk[t];
        row[k] = acc;
      }
    }
    __syncthreads();
  }
}

// Loads the lower (w, w) diagonal block at j0 of l into sL and the rows
// [j0, j0 + w) of the nc columns of x into sX.
template <typename T>
__device__ __forceinline__ void load_panel(const T* l, const T* x, T* sL, T* sX, int M, int S,
                                           int j0, int w, int nc) {
  for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
    const int r = idx / w;
    const int c = idx - r * w;
    sL[r * (kNB + 1) + c] = l[static_cast<size_t>(j0 + r) * M + j0 + c];
  }
  for (int idx = threadIdx.x; idx < w * nc; idx += blockDim.x) {
    const int r = idx / nc;
    const int c = idx - r * nc;
    sX[r * kTrsmCols + c] = x[static_cast<size_t>(j0 + r) * S + c];
  }
}

template <typename T>
__device__ __forceinline__ void copy_rhs(const T* b, T* x, int M, int S, int nc) {
  for (int idx = threadIdx.x; idx < M * nc; idx += blockDim.x) {
    const int r = idx / nc;
    const int c = idx - r * nc;
    x[static_cast<size_t>(r) * S + c] = b[static_cast<size_t>(r) * S + c];
  }
}

// X = L^-1 B for one matrix and up to kTrsmCols columns of B, by 32-row
// panels: the panel's diagonal solve runs in one warp per column (lane r
// holds row r), then the rows below take the panel's contribution.
template <typename T>
__global__ void trsm_fwd_kernel(const T* __restrict__ L, const T* __restrict__ B,
                                T* __restrict__ X, int M, int S) {
  __shared__ T sL[kNB * (kNB + 1)];
  __shared__ T sX[kNB * kTrsmCols];
  const size_t k = blockIdx.x;
  const int c0 = blockIdx.y * kTrsmCols;
  const int nc = min(kTrsmCols, S - c0);
  const T* l = L + k * M * M;
  T* x = X + k * M * S + c0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  copy_rhs(B + k * M * S + c0, x, M, S, nc);
  __syncthreads();
  for (int j0 = 0; j0 < M; j0 += kNB) {
    const int w = min(kNB, M - j0);
    load_panel(l, x, sL, sX, M, S, j0, w, nc);
    __syncthreads();
    if (warp < nc) {
      T v = (lane < w) ? sX[lane * kTrsmCols + warp] : T(0);
      for (int r = 0; r < w; ++r) {
        const T xr = __shfl_sync(kFull, v, r) / sL[r * (kNB + 1) + r];
        if (lane == r) v = xr;
        else if (lane > r && lane < w) v -= sL[lane * (kNB + 1) + r] * xr;
      }
      if (lane < w) {
        sX[lane * kTrsmCols + warp] = v;
        x[static_cast<size_t>(j0 + lane) * S + warp] = v;
      }
    }
    __syncthreads();
    const int below = M - j0 - w;
    for (int idx = threadIdx.x; idx < below * nc; idx += blockDim.x) {
      const int r = j0 + w + idx / nc;
      const int c = idx % nc;
      const T* lr = l + static_cast<size_t>(r) * M + j0;
      T acc = x[static_cast<size_t>(r) * S + c];
      for (int t = 0; t < w; ++t) acc -= lr[t] * sX[t * kTrsmCols + c];
      x[static_cast<size_t>(r) * S + c] = acc;
    }
    __syncthreads();
  }
}

// X = L^-T B, same layout: panels from the bottom; the diagonal solve is a
// back substitution on Ld^T, and the rows above take the panel's
// contribution through columns of L (row i of L^T is column i of L).
template <typename T>
__global__ void trsm_bwd_kernel(const T* __restrict__ L, const T* __restrict__ B,
                                T* __restrict__ X, int M, int S) {
  __shared__ T sL[kNB * (kNB + 1)];
  __shared__ T sX[kNB * kTrsmCols];
  const size_t k = blockIdx.x;
  const int c0 = blockIdx.y * kTrsmCols;
  const int nc = min(kTrsmCols, S - c0);
  const T* l = L + k * M * M;
  T* x = X + k * M * S + c0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  copy_rhs(B + k * M * S + c0, x, M, S, nc);
  __syncthreads();
  for (int j0 = ((M - 1) / kNB) * kNB; j0 >= 0; j0 -= kNB) {
    const int w = min(kNB, M - j0);
    load_panel(l, x, sL, sX, M, S, j0, w, nc);
    __syncthreads();
    if (warp < nc) {
      T v = (lane < w) ? sX[lane * kTrsmCols + warp] : T(0);
      for (int r = w - 1; r >= 0; --r) {
        const T xr = __shfl_sync(kFull, v, r) / sL[r * (kNB + 1) + r];
        if (lane == r) v = xr;
        else if (lane < r) v -= sL[r * (kNB + 1) + lane] * xr;
      }
      if (lane < w) {
        sX[lane * kTrsmCols + warp] = v;
        x[static_cast<size_t>(j0 + lane) * S + warp] = v;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < j0 * nc; idx += blockDim.x) {
      const int r = idx / nc;
      const int c = idx - r * nc;
      T acc = x[static_cast<size_t>(r) * S + c];
      for (int t = 0; t < w; ++t)
        acc -= l[static_cast<size_t>(j0 + t) * M + r] * sX[t * kTrsmCols + c];
      x[static_cast<size_t>(r) * S + c] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
size_t chol_smem(int M, int nb) {
  return (static_cast<size_t>(kNB) * (kNB + 1) + static_cast<size_t>(M) * (nb + 1)) * sizeof(T);
}

template <typename T>
int launch_chol(const void* A, void* L, int K, int M, double clamp, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = kNB;
  while (nb > 8 && chol_smem<T>(M, nb) > static_cast<size_t>(optin)) nb /= 2;
  const size_t smem = chol_smem<T>(M, nb);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_kernel<T><<<K, kCholThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), M, nb, static_cast<T>(clamp));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTransposed>
int launch_trsm(const void* L, const void* B, void* X, int K, int M, int S, void* stream) {
  const dim3 grid(K, (S + kTrsmCols - 1) / kTrsmCols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kTransposed) {
    trsm_bwd_kernel<T><<<grid, kTrsmThreads, 0, s>>>(
        static_cast<const T*>(L), static_cast<const T*>(B), static_cast<T*>(X), M, S);
  } else {
    trsm_fwd_kernel<T><<<grid, kTrsmThreads, 0, s>>>(
        static_cast<const T*>(L), static_cast<const T*>(B), static_cast<T*>(X), M, S);
  }
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
const char* slampp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
