// Monocular reprojection (p2c) linearization and chi2 of the BA Schur
// engine (linear/ba_schur.py), float64, for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's _p2c_jacs_analytic and
// _p2c_residual_batch (slampp_tpu/linear/ba_schur.py:304, :580) were
// elementwise code that XLA fused.  The port's plain version
// (ops/ba_kernels.p2c_linearize_plain: models/ba._edge_p2c_jacobians and the
// information products) is about ten batched float64 products and einsums
// over the observations, each writing an (m, 3, 3) or (m, 2, k) intermediate
// to device memory, every 3 x 3 product a library GEMM launch that pays for a
// 32 x 64 tile.  At venice871 (2,792,206 observations) that took 112 ms of
// device time an LM iteration for the Jacobians and 24 ms a chi2 on an H100
// (PERF.md).
//
// p2c_kernel<true> (p2c_linearize): for each observation e, camera c =
// obs_cam[e] (11 wide: t, axis-angle, fx fy cx cy k) and point X =
// pts[obs_lm[e]]:
//   R by Rodrigues in geometry/se3.axis_angle_to_rot's form, with its Taylor
//   guard below |aa|^2 = 1e-16; x = R X + t; the radial pinhole projection
//   (k = k_s / (0.5 (fx + fy))) as geometry/camera.project_p2c; r = z - h;
//   Jh = dh / dx as models/ba._p2c_projection_jacobian; Jp = -Jh R,
//   Jc = [-Jh R, Jh R [X]x]; WJp = W Jp, WJc = W Jc with the 2 x 2
//   information W; and r^T W r into chi2.
// p2c_kernel<false> (p2c_chi2): the same residual and r^T W r, no Jacobians.
//
// Bound: bytes.  An observation reads its two int64 indices, uv and W (64 B)
// and writes r, Jp, Jc, WJp, WJc (304 B); the points (24 B each) and cameras
// (88 B each) are read once.  At venice871: 0.849 GB written, 0.179 GB of
// observation rows and 12.7 MB of points read, 1.040 GB in all: 0.311 ms at
// 3.35 TB/s (counting the point at every observation, 392 B an
// observation: 0.327 ms).  The chi2 form reads 64 B an observation and the
// points: 0.191 GB, 0.057 ms.  The arithmetic (a sincos, a sqrt, four
// divisions, ~300 other float64 operations an observation) is ~0.03 ms of
// the card's float64 rate.  On an H100 (700 W) at venice871 the linearize
// form takes 0.4225 ms of device time (73% of its bound; the plain version
// 112.3 ms) and the chi2 form 0.157 ms (36%; the plain version 24.5 ms):
// chip_smoke.py's ba-kernels lines, PERF.md.  Design:
//  * One thread per observation; nothing but the outputs reaches device
//    memory.  Cameras (77 KB at venice871) and points through the read-only
//    cache: observations are sorted by landmark, so a warp reads a few
//    points, each once.
//  * Each output's rows of the CTA are staged in shared memory (a row
//    stride of w + 1 doubles, odd, so that the threads' 8-byte writes fall
//    in distinct banks) and stored by the CTA as contiguous 16-byte vectors:
//    a thread's own rows are 16 to 96 bytes at a 16- to 96-byte stride.
//  * chi2 is deterministic: each CTA sums its observations in a fixed tree
//    into a partial in the workspace; the last CTA to finish (a ticket taken
//    after a fence, the counter zeroed on the stream by the entry point)
//    sums the partials in a fixed order.  No floating-point atomics, so the
//    same states give the same chi2 bit for bit, run after run: the LM gain
//    test compares two of them.
//  * float64 throughout, as the states and the information are.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kP2cThreads = 128;
// the padded row strides of the staged outputs, in doubles (w + 1)
constexpr int kSr = 3, kSp = 7, kSc = 13;
constexpr int kOffP = kP2cThreads * kSr, kOffC = kOffP + kP2cThreads * kSp,
              kOffWp = kOffC + kP2cThreads * kSc, kOffWc = kOffWp + kP2cThreads * kSp;
constexpr int kStageDoubles = kOffWc + kP2cThreads * kSc;  // 44,032 bytes

struct P2cOut {
  double* r;    // (m, 2)
  double* jp;   // (m, 2, 3)
  double* jc;   // (m, 2, 6)
  double* wjp;  // (m, 2, 3)
  double* wjc;  // (m, 2, 6)
};

// The CTA's fixed-order sum of one value per thread (every thread calls
// it); the result is valid in thread 0.
__device__ __forceinline__ double cta_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kP2cThreads / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Stores the CTA's n staged rows of width W (stride W + 1) to out + e0 W as
// 16-byte vectors (W is even, out 16-byte aligned).
template <int W>
__device__ __forceinline__ void store_rows(const double* stage, double* out, long long e0,
                                           int n) {
  double2* dst = reinterpret_cast<double2*>(out + e0 * W);
  const int nv = n * W / 2;
  for (int i = threadIdx.x; i < nv; i += kP2cThreads) {
    const int row = (2 * i) / W, col = (2 * i) % W;
    const double* s = stage + row * (W + 1) + col;
    dst[i] = make_double2(s[0], s[1]);
  }
}

template <bool kJac>
__global__ void __launch_bounds__(kP2cThreads, 4)
    p2c_kernel(const double* __restrict__ cams, const double* __restrict__ pts,
               const long long* __restrict__ obs_cam, const long long* __restrict__ obs_lm,
               const double* __restrict__ uv, const double* __restrict__ info, long long m,
               P2cOut out, double* __restrict__ chi2, double* __restrict__ partials,
               unsigned* __restrict__ counter) {
  __shared__ __align__(16) double stage[kJac ? kStageDoubles : 2];
  __shared__ double red[kP2cThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kP2cThreads;
  const long long e = e0 + tid;
  const int n = static_cast<int>(m - e0 < kP2cThreads ? m - e0 : kP2cThreads);

  double q = 0.0;
  if (e < m) {
    const double* cam = cams + __ldg(obs_cam + e) * 11;
    const double* pt = pts + __ldg(obs_lm + e) * 3;
    const double t0 = __ldg(cam + 0), t1 = __ldg(cam + 1), t2 = __ldg(cam + 2);
    const double ax = __ldg(cam + 3), ay = __ldg(cam + 4), az = __ldg(cam + 5);
    const double fx = __ldg(cam + 6), fy = __ldg(cam + 7), cx = __ldg(cam + 8),
                 cy = __ldg(cam + 9), ks = __ldg(cam + 10);
    const double X0 = __ldg(pt + 0), X1 = __ldg(pt + 1), X2 = __ldg(pt + 2);
    const double2 z = __ldg(reinterpret_cast<const double2*>(uv) + e);
    const double2 w0 = __ldg(reinterpret_cast<const double2*>(info) + 2 * e);
    const double2 w1 = __ldg(reinterpret_cast<const double2*>(info) + 2 * e + 1);

    // Rodrigues: R = I + sinc K + cosc K^2, K = [aa]x (se3.axis_angle_to_rot)
    const double sq = ax * ax + ay * ay + az * az;
    double sinc, cosc;
    if (sq < 1e-16) {
      sinc = 1.0 - sq / 6.0;
      cosc = 0.5 - sq / 24.0;
    } else {
      const double a = sqrt(sq);
      double s, c;
      sincos(a, &s, &c);
      sinc = s / a;
      cosc = (1.0 - c) / sq;
    }
    const double R00 = 1.0 + cosc * (-az * az - ay * ay);
    const double R01 = sinc * -az + cosc * (ax * ay);
    const double R02 = sinc * ay + cosc * (ax * az);
    const double R10 = sinc * az + cosc * (ax * ay);
    const double R11 = 1.0 + cosc * (-az * az - ax * ax);
    const double R12 = sinc * -ax + cosc * (ay * az);
    const double R20 = sinc * -ay + cosc * (ax * az);
    const double R21 = sinc * ax + cosc * (ay * az);
    const double R22 = 1.0 + cosc * (-ay * ay - ax * ax);
    const double x0 = R00 * X0 + R01 * X1 + R02 * X2 + t0;
    const double x1 = R10 * X0 + R11 * X1 + R12 * X2 + t1;
    const double x2 = R20 * X0 + R21 * X1 + R22 * X2 + t2;

    // the residual as geometry/camera.p2c_error: u, v, then u - cx, v - cy
    const double k = ks / (0.5 * (fx + fy));
    const double iz = 1.0 / x2;
    const double du = (fx * x0 * iz + cx) - cx;
    const double dv = (fy * x1 * iz + cy) - cy;
    const double dh = 1.0 + (du * du + dv * dv) * k;
    const double r0 = z.x - (cx + dh * du);
    const double r1 = z.y - (cy + dh * dv);
    q = r0 * (w0.x * r0 + w0.y * r1) + r1 * (w1.x * r0 + w1.y * r1);

    if constexpr (kJac) {
      double* sr = stage + tid * kSr;  // this thread's staged rows
      double* sp = stage + kOffP + tid * kSp;
      double* sc = stage + kOffC + tid * kSc;
      double* swp = stage + kOffWp + tid * kSp;
      double* swc = stage + kOffWc + tid * kSc;
      sr[0] = r0;
      sr[1] = r1;
      // Jh = dh / dx (models/ba._p2c_projection_jacobian)
      const double a = fx * x0 * iz, b = fy * x1 * iz;
      const double d = 1.0 + k * (a * a + b * b);
      const double m11 = d + 2.0 * k * a * a, m12 = 2.0 * k * a * b,
                   m22 = d + 2.0 * k * b * b;
      const double da0 = fx * iz, da2 = -a * iz, db1 = fy * iz, db2 = -b * iz;
      const double J00 = m11 * da0, J01 = m12 * db1, J02 = m11 * da2 + m12 * db2;
      const double J10 = m12 * da0, J11 = m22 * db1, J12 = m12 * da2 + m22 * db2;
      // JhR = Jh R; Jp = -JhR; Jc = [-JhR, JhR [X]x]
      const double A0[3] = {J00 * R00 + J01 * R10 + J02 * R20,
                            J00 * R01 + J01 * R11 + J02 * R21,
                            J00 * R02 + J01 * R12 + J02 * R22};
      const double A1[3] = {J10 * R00 + J11 * R10 + J12 * R20,
                            J10 * R01 + J11 * R11 + J12 * R21,
                            J10 * R02 + J11 * R12 + J12 * R22};
      const double S0[3] = {A0[1] * X2 - A0[2] * X1, A0[2] * X0 - A0[0] * X2,
                            A0[0] * X1 - A0[1] * X0};
      const double S1[3] = {A1[1] * X2 - A1[2] * X1, A1[2] * X0 - A1[0] * X2,
                            A1[0] * X1 - A1[1] * X0};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double p0 = -A0[j], p1 = -A1[j];
        const double wp0 = w0.x * p0 + w0.y * p1, wp1 = w1.x * p0 + w1.y * p1;
        sp[j] = p0;
        sp[3 + j] = p1;
        sc[j] = p0;
        sc[6 + j] = p1;
        swp[j] = wp0;
        swp[3 + j] = wp1;
        swc[j] = wp0;
        swc[6 + j] = wp1;
        const double c0 = S0[j], c1 = S1[j];
        sc[3 + j] = c0;
        sc[9 + j] = c1;
        swc[3 + j] = w0.x * c0 + w0.y * c1;
        swc[9 + j] = w1.x * c0 + w1.y * c1;
      }
    }
  }
  if constexpr (kJac) {
    __syncthreads();
    store_rows<2>(stage, out.r, e0, n);
    store_rows<6>(stage + kOffP, out.jp, e0, n);
    store_rows<12>(stage + kOffC, out.jc, e0, n);
    store_rows<6>(stage + kOffWp, out.wjp, e0, n);
    store_rows<12>(stage + kOffWc, out.wjc, e0, n);
  }

  // chi2: the CTA's partial, then the last CTA sums the partials in order
  const double s = cta_sum(q, red);
  if (tid == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    double acc = 0.0;
    for (unsigned i = tid; i < gridDim.x; i += kP2cThreads) acc += __ldcg(partials + i);
    const double total = cta_sum(acc, red);
    if (tid == 0) *chi2 = total;
  }
}

long long p2c_blocks(long long m) { return (m + kP2cThreads - 1) / kP2cThreads; }

// The workspace: one partial a CTA, then the ticket counter.
long long p2c_workspace_bytes(long long m) {
  return p2c_blocks(m) * static_cast<long long>(sizeof(double)) + 16;
}

template <bool kJac>
int launch_p2c(const void* cams, const void* pts, const void* obs_cam, const void* obs_lm,
               const void* uv, const void* info, long long m, P2cOut out, void* chi2,
               void* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaMemsetAsync(chi2, 0, sizeof(double), s));
  const long long blocks = p2c_blocks(m);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  double* partials = static_cast<double*>(ws);
  unsigned* counter = reinterpret_cast<unsigned*>(partials + blocks);
  if (cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s))
    return static_cast<int>(err);
  p2c_kernel<kJac><<<static_cast<unsigned>(blocks), kP2cThreads, 0, s>>>(
      static_cast<const double*>(cams), static_cast<const double*>(pts),
      static_cast<const long long*>(obs_cam), static_cast<const long long*>(obs_lm),
      static_cast<const double*>(uv), static_cast<const double*>(info), m, out,
      static_cast<double*>(chi2), partials, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slampp_p2c_workspace(long long m, long long* out) {
  *out = p2c_workspace_bytes(m);
  return 0;
}
int slampp_p2c_linearize_f64(const void* cams, const void* pts, const void* obs_cam,
                             const void* obs_lm, const void* uv, const void* info, long long m,
                             void* r, void* jp, void* jc, void* wjp, void* wjc, void* chi2,
                             void* ws, void* stream) {
  const P2cOut out = {static_cast<double*>(r), static_cast<double*>(jp),
                      static_cast<double*>(jc), static_cast<double*>(wjp),
                      static_cast<double*>(wjc)};
  return launch_p2c<true>(cams, pts, obs_cam, obs_lm, uv, info, m, out, chi2, ws, stream);
}
int slampp_p2c_chi2_f64(const void* cams, const void* pts, const void* obs_cam,
                        const void* obs_lm, const void* uv, const void* info, long long m,
                        void* chi2, void* ws, void* stream) {
  const P2cOut out = {nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_p2c<false>(cams, pts, obs_cam, obs_lm, uv, info, m, out, chi2, ws, stream);
}

}  // extern "C"
