// The Sim(3) global reprojection edge (edge_p2c_xyz_sim3_g: a world XYZ
// point seen by a camsim3 camera) of the sparse Schur engine
// (linear/schur_sparse.py) and the LM loop's chi2 (core/assembly.py),
// float64, for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's _g_jacobians and
// edge_chi2 (slampp_tpu/models/sim3.py, slampp_tpu/core/assembly.py) were
// elementwise code that XLA fused.  The port's generic path, which CPU
// operands keep (models/sim3._g_jacobians and the einsum chain of
// linear/schur_sparse.pl_terms), is about twenty batched
// float64 products and einsums over the edges, each writing an (E, a, b)
// intermediate to device memory, every small product a library GEMM launch
// that pays for a 32 x 64 tile, and then a gather of the five landmark-row
// outputs into the landmark order.  At venice871_sim3 (2,792,206 edges) that
// took 153 ms of device time an LM iteration for the terms and ~30 ms a
// chi2 (36 ms an LM iteration) on an H100 (PERF.md).
//
// sim3_g_kernel<true> (sim3_g_terms): output row i is edge e = order[i]
// (the identity without order), point X = pts[idx[e, 0]], camera
// c = cams[idx[e, 1]] (12 wide: u, omega, sigma, then fx fy cx cy k):
//   tRs = sim3_exp(c[0:7]) as geometry/sim3.sim3_exp, with _W_matrix's
//   four-way select (|omega|^2 < 1e-16, |sigma| < 1e-8); x = R^T (X - t) / s
//   through the quaternion as inv_transform_tRs; R by Rodrigues as
//   se3.axis_angle_to_rot (its Taylor guard at the same 1e-16); the radial
//   projection with k = k_s / (0.5 fx fy) as sim3._distort; r = z - h;
//   Jh = dh / dx; J_point = -(Jh R^T) / s; J_cam = Jh [I, -[x]x, x]; with the
//   2 x 2 information W: Hpp = Jc^T W Jc (7 x 7), gp = (W Jc)^T r,
//   Dl = Jp^T W Jp (3 x 3), gl = (W Jp)^T r, B = Jc^T W Jp (7 x 3); and
//   chi2 = sum of r^T W r over the valid edges (the terms are not masked).
// sim3_g_kernel<false> (sim3_g_chi2): the same residual and chi2 in edge
// order, no Jacobians.
//
// Bound: bytes.  An edge reads its two int64 indices, z, W, valid and the
// order index (73 B) and writes Hpp, gp, Dl, gl, B (89 doubles, 712 B); the
// points (24 B each) and cameras (96 B each) are read once.  At
// venice871_sim3: 1.988 GB written, 0.204 GB of edge rows and 12.7 MB of
// points read, 2.205 GB in all: 0.658 ms at 3.35 TB/s.  The chi2 form reads
// 65 B an edge and the points: 0.194 GB, 0.058 ms.  The arithmetic (an exp,
// two sincos, a sqrt, about ten divisions and ~600 other float64
// operations an edge for the terms) is ~0.1 ms of the card's float64 rate.
// Design:
//  * One thread per output row; nothing but the outputs reaches device
//    memory.  Cameras (84 KB at venice871) and points through the read-only
//    cache: the engine passes the landmark order, so a warp reads a few
//    points, each once.
//  * sim3_exp and the rotation are computed per edge, not once per camera
//    in a prologue: they are a few hundred float64 operations an edge, a
//    small part of the time the bytes take, and a per-camera table of R, t
//    and s (18 doubles) would read more bytes an edge than the camera's 12
//    and cost a second launch.
//  * The rows are written in the landmark order the engine's segment sums
//    read them in, so the five gathers of 2 GB that followed the einsums
//    are gone.
//  * Each output's rows of the CTA are staged in shared memory back to back
//    as they lie in device memory (every width is odd, so the 8-byte writes
//    of a warp's threads at a stride of w doubles fall in distinct banks)
//    and stored by the CTA as contiguous 16-byte vectors.  89 doubles a
//    thread is 712 B: 64 threads a CTA keep the stage at 45.6 KB, under the
//    48 KB of static shared memory, four CTAs an SM.
//  * chi2 is deterministic: each CTA sums its rows in a fixed tree into a
//    partial in the workspace; the last CTA to finish (a ticket taken after
//    a fence, the counter zeroed on the stream by the entry point) sums the
//    partials in a fixed order, eight loads in flight a thread.  No
//    floating-point atomics, so the same states give the same chi2 bit for
//    bit, run after run: the LM gain test compares two of them.
//  * float64 throughout, as the states and the information are.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTermThreads = 64;
constexpr int kChi2Threads = 256;
// the widths of an edge's outputs, in doubles, and their staged blocks
constexpr int kWH = 49, kWG = 7, kWD = 9, kWL = 3, kWB = 21;
constexpr int kOffG = kTermThreads * kWH, kOffD = kOffG + kTermThreads * kWG,
              kOffL = kOffD + kTermThreads * kWD, kOffB = kOffL + kTermThreads * kWL;
constexpr int kStageDoubles = kOffB + kTermThreads * kWB;  // 45,568 bytes

struct TermsOut {
  double* hpp;  // (m, 7, 7)
  double* gp;   // (m, 7)
  double* dl;   // (m, 3, 3)
  double* gl;   // (m, 3)
  double* b;    // (m, 7, 3)
};

// The CTA's fixed-order sum of one value per thread (every thread calls
// it); the result is valid in thread 0.
template <int T>
__device__ __forceinline__ double cta_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < T / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Stores the CTA's n staged rows of width W, staged back to back, to
// out + i0 W as 16-byte vectors (the stage and out + i0 W are 16-byte
// aligned: i0 is a multiple of the CTA's 64 rows), an odd last double alone.
template <int W>
__device__ __forceinline__ void store_rows(const double* stage, double* out, long long i0,
                                           int n) {
  const int cnt = n * W;
  const double2* src = reinterpret_cast<const double2*>(stage);
  double2* dst = reinterpret_cast<double2*>(out + i0 * W);
  for (int i = threadIdx.x; i < cnt / 2; i += kTermThreads) dst[i] = src[i];
  if ((cnt & 1) && threadIdx.x == 0) out[i0 * W + cnt - 1] = stage[cnt - 1];
}

template <bool kJac>
__global__ void __launch_bounds__(kJac ? kTermThreads : kChi2Threads, kJac ? 4 : 2)
    sim3_g_kernel(const double* __restrict__ pts, const double* __restrict__ cams,
                  const long long* __restrict__ idx, const double* __restrict__ meas,
                  const double* __restrict__ info, const unsigned char* __restrict__ valid,
                  const long long* __restrict__ order, long long m, TermsOut out,
                  double* __restrict__ chi2, double* __restrict__ partials,
                  unsigned* __restrict__ counter) {
  constexpr int T = kJac ? kTermThreads : kChi2Threads;
  __shared__ __align__(16) double stage[kJac ? kStageDoubles : 2];
  __shared__ double red[T / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * T;
  const long long i = i0 + tid;
  const int n = static_cast<int>(m - i0 < T ? m - i0 : T);

  double q = 0.0;
  if (i < m) {
    const long long e = order != nullptr ? __ldg(order + i) : i;
    const double* pt = pts + __ldg(idx + 2 * e) * 3;
    const double* cam = cams + __ldg(idx + 2 * e + 1) * 12;
    const double2 z = __ldg(reinterpret_cast<const double2*>(meas) + e);
    const double2 w0 = __ldg(reinterpret_cast<const double2*>(info) + 2 * e);
    const double2 w1 = __ldg(reinterpret_cast<const double2*>(info) + 2 * e + 1);
    const bool ok = __ldg(valid + e) != 0;
    const double u0 = __ldg(cam + 0), u1 = __ldg(cam + 1), u2 = __ldg(cam + 2);
    const double o0 = __ldg(cam + 3), o1 = __ldg(cam + 4), o2 = __ldg(cam + 5);
    const double sg = __ldg(cam + 6);
    const double fx = __ldg(cam + 7), fy = __ldg(cam + 8), cx = __ldg(cam + 9),
                 cy = __ldg(cam + 10), ks = __ldg(cam + 11);
    const double X0 = __ldg(pt + 0), X1 = __ldg(pt + 1), X2 = __ldg(pt + 2);

    // sim3_exp: t = W u, W = C I + A K + B K^2, K = [omega]x (_W_matrix)
    const double sq = o0 * o0 + o1 * o1 + o2 * o2;
    const bool small_th = sq < 1e-16;
    const double th = sqrt(small_th ? 1.0 : sq);
    const double s = exp(sg);
    const bool small_sig = fabs(sg) < 1e-8;
    const double ss = small_sig ? 1.0 : sg;
    const double C = small_sig ? 1.0 + sg / 2.0 + sg * sg / 6.0 : (s - 1.0) / ss;
    double sin_th, cos_th;
    sincos(th, &sin_th, &cos_th);
    const double sq_safe = small_th ? 1.0 : sq;
    const double denom = ss * ss + (small_th ? 0.0 : sq);
    double A, B;
    if (small_th) {
      A = small_sig ? 0.5 : (ss * s + 1.0 - s) / (ss * ss);
      B = small_sig ? 1.0 / 6.0 : (2.0 * (s - 1.0) - ss * s * (2.0 - ss)) / (2.0 * ss * ss * ss);
    } else if (small_sig) {
      A = (1.0 - cos_th) / sq_safe;
      B = (th - sin_th) / (sq_safe * th);
    } else {
      A = (ss * s * sin_th + (1.0 - s * cos_th) * th) / (th * denom);
      B = (C - ((s * cos_th - 1.0) * ss + s * th * sin_th) / denom) / sq_safe;
    }
    const double ku0 = o1 * u2 - o2 * u1, ku1 = o2 * u0 - o0 * u2, ku2 = o0 * u1 - o1 * u0;
    const double kku0 = o1 * ku2 - o2 * ku1, kku1 = o2 * ku0 - o0 * ku2,
                 kku2 = o0 * ku1 - o1 * ku0;
    const double t0 = C * u0 + A * ku0 + B * kku0;
    const double t1 = C * u1 + A * ku1 + B * kku1;
    const double t2 = C * u2 + A * ku2 + B * kku2;

    // x = R^T (X - t) / s through the unit quaternion of omega
    // (se3.axis_angle_to_quat, conjugated, then se3.quat_rotate)
    double qc, qf;
    if (small_th) {
      qc = 1.0 - sq / 8.0;
      qf = 0.5 - sq / 48.0;
    } else {
      double sh, ch;
      sincos(th * 0.5, &sh, &ch);
      qc = ch;
      qf = sh / th;
    }
    if (qc < 0.0) qf = -qf;
    const double qw0 = fabs(qc), qx0 = o0 * qf, qy0 = o1 * qf, qz0 = o2 * qf;
    const double qn = sqrt(qw0 * qw0 + qx0 * qx0 + qy0 * qy0 + qz0 * qz0);
    const double qw = qw0 / qn, qx = -(qx0 / qn), qy = -(qy0 / qn), qz = -(qz0 / qn);
    const double v0 = X0 - t0, v1 = X1 - t1, v2 = X2 - t2;
    const double c0 = 2.0 * (qy * v2 - qz * v1), c1 = 2.0 * (qz * v0 - qx * v2),
                 c2 = 2.0 * (qx * v1 - qy * v0);
    const double x0 = (v0 + qw * c0 + (qy * c2 - qz * c1)) / s;
    const double x1 = (v1 + qw * c1 + (qz * c0 - qx * c2)) / s;
    const double x2 = (v2 + qw * c2 + (qx * c1 - qy * c0)) / s;

    // the residual as sim3._distort: u, v, then u - cx, v - cy
    const double k = ks / (0.5 * (fx * fy));
    const double iz = 1.0 / x2;
    const double du = (fx * x0 * iz + cx) - cx;
    const double dv = (fy * x1 * iz + cy) - cy;
    const double dh = 1.0 + (du * du + dv * dv) * k;
    const double r0 = z.x - (cx + dh * du);
    const double r1 = z.y - (cy + dh * dv);
    if (ok) q = r0 * (w0.x * r0 + w0.y * r1) + r1 * (w1.x * r0 + w1.y * r1);

    if constexpr (kJac) {
      // Jh = dh / dx (models/sim3._g_jacobians)
      const double a = fx * x0 * iz, b = fy * x1 * iz;
      const double d = 1.0 + k * (a * a + b * b);
      const double m11 = d + 2.0 * k * a * a, m12 = 2.0 * k * a * b,
                   m22 = d + 2.0 * k * b * b;
      const double da0 = fx * iz, da2 = -a * iz, db1 = fy * iz, db2 = -b * iz;
      const double J[2][3] = {{m11 * da0, m12 * db1, m11 * da2 + m12 * db2},
                              {m12 * da0, m22 * db1, m12 * da2 + m22 * db2}};
      // R by Rodrigues: R = I + sinc K + cosc K^2 (se3.axis_angle_to_rot)
      const double sinc = small_th ? 1.0 - sq / 6.0 : sin_th / th;
      const double cosc = small_th ? 0.5 - sq / 24.0 : (1.0 - cos_th) / sq_safe;
      const double R[3][3] = {
          {1.0 + cosc * (-o2 * o2 - o1 * o1), sinc * -o2 + cosc * (o0 * o1),
           sinc * o1 + cosc * (o0 * o2)},
          {sinc * o2 + cosc * (o0 * o1), 1.0 + cosc * (-o2 * o2 - o0 * o0),
           sinc * -o0 + cosc * (o1 * o2)},
          {sinc * -o1 + cosc * (o0 * o2), sinc * o0 + cosc * (o1 * o2),
           1.0 + cosc * (-o1 * o1 - o0 * o0)}};
      // Jp = -(Jh R^T) / s; Jc = [Jh, x x Jh_r (= -Jh [x]x), Jh x]
      double Jp[2][3], Jc[2][7];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Jp[r][j] = -(J[r][0] * R[j][0] + J[r][1] * R[j][1] + J[r][2] * R[j][2]) / s;
        Jc[r][0] = J[r][0];
        Jc[r][1] = J[r][1];
        Jc[r][2] = J[r][2];
        Jc[r][3] = x1 * J[r][2] - x2 * J[r][1];
        Jc[r][4] = x2 * J[r][0] - x0 * J[r][2];
        Jc[r][5] = x0 * J[r][1] - x1 * J[r][0];
        Jc[r][6] = J[r][0] * x0 + J[r][1] * x1 + J[r][2] * x2;
      }
      double WJp[2][3], WJc[2][7];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        WJp[0][j] = w0.x * Jp[0][j] + w0.y * Jp[1][j];
        WJp[1][j] = w1.x * Jp[0][j] + w1.y * Jp[1][j];
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        WJc[0][j] = w0.x * Jc[0][j] + w0.y * Jc[1][j];
        WJc[1][j] = w1.x * Jc[0][j] + w1.y * Jc[1][j];
      }
      double* sh = stage + tid * kWH;  // this thread's staged rows
      double* sgp = stage + kOffG + tid * kWG;
      double* sd = stage + kOffD + tid * kWD;
      double* sgl = stage + kOffL + tid * kWL;
      double* sb = stage + kOffB + tid * kWB;
#pragma unroll
      for (int a2 = 0; a2 < 7; ++a2) {
#pragma unroll
        for (int b2 = 0; b2 < 7; ++b2)
          sh[a2 * 7 + b2] = Jc[0][a2] * WJc[0][b2] + Jc[1][a2] * WJc[1][b2];
        sgp[a2] = WJc[0][a2] * r0 + WJc[1][a2] * r1;
#pragma unroll
        for (int b2 = 0; b2 < 3; ++b2)
          sb[a2 * 3 + b2] = Jc[0][a2] * WJp[0][b2] + Jc[1][a2] * WJp[1][b2];
      }
#pragma unroll
      for (int a2 = 0; a2 < 3; ++a2) {
#pragma unroll
        for (int b2 = 0; b2 < 3; ++b2)
          sd[a2 * 3 + b2] = Jp[0][a2] * WJp[0][b2] + Jp[1][a2] * WJp[1][b2];
        sgl[a2] = WJp[0][a2] * r0 + WJp[1][a2] * r1;
      }
    }
  }
  if constexpr (kJac) {
    __syncthreads();
    store_rows<kWH>(stage, out.hpp, i0, n);
    store_rows<kWG>(stage + kOffG, out.gp, i0, n);
    store_rows<kWD>(stage + kOffD, out.dl, i0, n);
    store_rows<kWL>(stage + kOffL, out.gl, i0, n);
    store_rows<kWB>(stage + kOffB, out.b, i0, n);
  }

  // chi2: the CTA's partial, then the last CTA sums the partials in order
  const double part = cta_sum<T>(q, red);
  if (tid == 0) {
    partials[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    // partials tid, tid + T, ... in that order, eight loads in flight
    double acc = 0.0;
    unsigned p = tid;
    for (; p + 7u * T < gridDim.x; p += 8u * T) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(partials + p + u * T);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; p < gridDim.x; p += T) acc += __ldcg(partials + p);
    const double total = cta_sum<T>(acc, red);
    if (tid == 0) *chi2 = total;
  }
}

template <bool kJac>
long long sim3_g_blocks(long long m) {
  constexpr int T = kJac ? kTermThreads : kChi2Threads;
  return (m + T - 1) / T;
}

template <bool kJac>
int launch_sim3_g(const void* pts, const void* cams, const void* idx, const void* meas,
                  const void* info, const void* valid, const void* order, long long m,
                  TermsOut out, void* chi2, void* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaMemsetAsync(chi2, 0, sizeof(double), s));
  const long long blocks = sim3_g_blocks<kJac>(m);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  double* partials = static_cast<double*>(ws);
  unsigned* counter = reinterpret_cast<unsigned*>(partials + blocks);
  if (cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s))
    return static_cast<int>(err);
  sim3_g_kernel<kJac><<<static_cast<unsigned>(blocks), kJac ? kTermThreads : kChi2Threads, 0, s>>>(
      static_cast<const double*>(pts), static_cast<const double*>(cams),
      static_cast<const long long*>(idx), static_cast<const double*>(meas),
      static_cast<const double*>(info), static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(order), m, out, static_cast<double*>(chi2), partials,
      counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The workspace of either form: one partial a CTA (the terms form has the
// more CTAs), then the ticket counter.
int slampp_sim3_g_workspace(long long m, long long* out) {
  *out = sim3_g_blocks<true>(m) * static_cast<long long>(sizeof(double)) + 16;
  return 0;
}
int slampp_sim3_g_terms_f64(const void* pts, const void* cams, const void* idx, const void* meas,
                            const void* info, const void* valid, const void* order, long long m,
                            void* hpp, void* gp, void* dl, void* gl, void* b, void* chi2, void* ws,
                            void* stream) {
  const TermsOut out = {static_cast<double*>(hpp), static_cast<double*>(gp),
                        static_cast<double*>(dl), static_cast<double*>(gl),
                        static_cast<double*>(b)};
  return launch_sim3_g<true>(pts, cams, idx, meas, info, valid, order, m, out, chi2, ws, stream);
}
int slampp_sim3_g_chi2_f64(const void* pts, const void* cams, const void* idx, const void* meas,
                           const void* info, const void* valid, long long m, void* chi2, void* ws,
                           void* stream) {
  const TermsOut out = {nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch_sim3_g<false>(pts, cams, idx, meas, info, valid, nullptr, m, out, chi2, ws,
                              stream);
}

}  // extern "C"
