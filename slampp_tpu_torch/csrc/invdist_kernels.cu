// The Sim(3) inverse-distance reprojection edges (models/sim3.py: the
// ternary edge_p2c_invdist_sim3_lo, a landmark local to its owner camera
// seen by another camera, and the unary edge_p2c_invdist_sim3_ls, seen by
// its owner) of the sparse Schur engine (linear/schur_sparse.py) and the LM
// loop's chi2 (core/assembly.py), float64, for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package differentiated these edges
// with jax.jacfwd and XLA fused the result.  The port's generic path, which
// CPU operands keep (models/sim3._p2c_invdist_lo_jacobians /
// _p2c_invdist_ls_jacobians and the einsums of the "ter" / "u_lm" branches
// of SparseSchurSolver._edge_terms), is some forty batched float64 products,
// einsums and elementwise passes over the edges, each writing an (E, a, b)
// intermediate to device memory, the small products library GEMMs that pay
// for a 32 x 64 tile.  At venice871_sim3_invdist (2,264,792 LO and 527,414
// LS edges) that took 192 ms of device time an LM iteration for the terms,
// 54 ms for the chi2 and ~30 ms a solve for the damping scale on an H100
// (PERF.md).
//
// invdist_kernel<true, true> (LO terms): row i is edge i; the landmark
// v = lm[idx[i, 0]] = (q, ray), the owner camera o = cams[idx[i, 1]] and
// the observer c = cams[idx[i, 2]] (12 wide: u, omega, sigma, then fx fy
// cx cy k):
//   x_o = ray / q, the point in the owner's frame;
//   for each camera, once: t = W u and s = e^sigma as geometry/sim3.sim3_exp,
//   with _W_matrix's four-way select (|omega|^2 < 1e-16, |sigma| < 1e-8);
//   R by Rodrigues as se3.axis_angle_to_rot (its Taylor guard at 1e-16);
//   M = (s_o / s_c) R_c^T R_o and x = M x_o + R_c^T (t_o - t_c) / s_c, the
//   point in the observer's frame; the radial projection with
//   k = k_s / (0.5 fx fy) as sim3._distort; r = z - h; Jh = dh / dx;
//   J_q = Jh M x_o / q; J_o = -Jh M [I, -[x_o]x, x_o];
//   J_c = Jh [I, -[x]x, x]; with the 2 x 2 information W (symmetric):
//   H_oo = J_o^T W J_o, H_cc = J_c^T W J_c, H_oc = J_o^T W J_c (7 x 7),
//   g_o = J_o^T W r, g_c = J_c^T W r (7), D = J_q^T W J_q (1 x 1),
//   g_l = J_q^T W r (1), B_o = J_o^T W J_q, B_c = J_c^T W J_q (7 x 1), and
//   chi2 = sum of r^T W r over the valid edges (the terms are not masked).
//   B_o goes to rows [0, m) of one (2m, 7, 1) buffer, B_c to [m, 2m): the
//   engine's coupling order (first pose slot, then second).
// invdist_kernel<false, true> (LS terms): v = lm[idx[i]], x = ray / q, the
//   intrinsics z[2:7] of the 7-wide measurement; r = z[0:2] - h(x);
//   J_q = Jh x / q; D, g_l and chi2 as above.
// invdist_kernel<*, false>: the same residual and chi2, no Jacobians.
//
// Bound: bytes.  An LO edge reads its three int64 indices, z, W and valid
// (73 B) and writes 177 doubles (1,416 B); an LS edge reads 121 B and
// writes 16 B; the landmarks (32 B) and cameras (96 B) are read once.  At
// venice871_sim3_invdist: 3.207 GB written and 0.165 GB of LO edge rows
// read, ~0.09 GB for the LS edges and the landmarks, ~3.47 GB in all:
// ~1.03 ms at 3.35 TB/s.  The chi2 forms read ~0.25 GB: ~0.08 ms.  The
// arithmetic (two exp / sincos pairs and ~1,500 other float64 operations
// an LO edge) is ~0.1 ms of the card's float64 rate.
// Design:
//  * One thread per edge; nothing but the outputs reaches device memory.
//    Cameras (84 KB at venice871) and landmarks through the read-only cache.
//  * Each camera's similarity is computed once an edge: one sincos gives
//    sim3_exp's coefficients and Rodrigues' rotation, which also carries the
//    point (the generic path rotates it through a quaternion and forms the
//    rotation a second time for M).
//  * The Jacobians (2 x 1, 2 x 7, 2 x 7) and W r stay in registers.  The
//    outputs are staged in shared memory in four turns (H_oo; H_cc; H_oc;
//    then g_o, g_c, B_o, B_c, D and g_l together), each output's rows of
//    the CTA back to back as they lie in device memory, and stored by the
//    CTA as contiguous 16-byte vectors (8-byte stores where the rows start
//    off 16 bytes: B_c's at an odd m).  Every width is odd or 1, so the
//    8-byte writes of a warp's threads at a stride of w doubles fall in
//    distinct banks.  177 doubles a thread would take 90.6 KB for 64
//    threads; a turn's 49 take 25 KB of static shared memory.
//  * H_oo and H_cc are formed on and above the diagonal and mirrored; the
//    stored blocks are full, as the slot sums read them.
//  * The LS edge's z is 7 doubles a row (56 B), read a double at a time;
//    its two outputs are one double each, stored by the threads directly.
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
constexpr int kTurn = 49;  // doubles a thread in one turn of the stage
// the fourth turn's outputs, back to back
constexpr int kOffGc = kTermThreads * 7, kOffBo = 2 * kTermThreads * 7,
              kOffBc = 3 * kTermThreads * 7, kOffD = 4 * kTermThreads * 7,
              kOffGl = kOffD + kTermThreads;

struct Operands {
  const double* lm;           // (n_l, 4): q, ray
  const double* cams;         // (n_c, 12); unused by LS
  const long long* idx;       // (m, 3) LO, (m, 1) LS
  const double* meas;         // (m, 2) LO, (m, 7) LS
  const double* info;         // (m, 2, 2)
  const unsigned char* valid; // (m,)
};

struct TermsOut {
  double* hoo;  // (m, 7, 7)
  double* hcc;  // (m, 7, 7)
  double* hoc;  // (m, 7, 7)
  double* go;   // (m, 7)
  double* gc;   // (m, 7)
  double* dl;   // (m, 1, 1)
  double* gl;   // (m, 1)
  double* b;    // (2m, 7, 1): B_o, then B_c
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

// Stores the CTA's n staged rows of width W, staged back to back, to dst
// (the CTA's first row): as 16-byte vectors where dst is 16-byte aligned
// (the stage is), an odd last double alone; else a double at a time.
template <int W>
__device__ __forceinline__ void store_rows(const double* stage, double* dst, int n) {
  const int cnt = n * W;
  if ((reinterpret_cast<std::uintptr_t>(dst) & 15) == 0) {
    const double2* src = reinterpret_cast<const double2*>(stage);
    double2* d2 = reinterpret_cast<double2*>(dst);
    for (int k = threadIdx.x; k < cnt / 2; k += kTermThreads) d2[k] = src[k];
    if ((cnt & 1) && threadIdx.x == 0) dst[cnt - 1] = stage[cnt - 1];
  } else {
    for (int k = threadIdx.x; k < cnt; k += kTermThreads) dst[k] = stage[k];
  }
}

// A camera's similarity: t = W u, R by Rodrigues, s = e^sigma
// (geometry/sim3.sim3_exp, se3.axis_angle_to_rot).
struct Sim3 {
  double t[3], R[3][3], s;
};

__device__ __forceinline__ Sim3 camera_sim3(const double* cam) {
  const double u0 = __ldg(cam + 0), u1 = __ldg(cam + 1), u2 = __ldg(cam + 2);
  const double o0 = __ldg(cam + 3), o1 = __ldg(cam + 4), o2 = __ldg(cam + 5);
  const double sg = __ldg(cam + 6);
  Sim3 out;
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
  const double kku0 = o1 * ku2 - o2 * ku1, kku1 = o2 * ku0 - o0 * ku2, kku2 = o0 * ku1 - o1 * ku0;
  out.t[0] = C * u0 + A * ku0 + B * kku0;
  out.t[1] = C * u1 + A * ku1 + B * kku1;
  out.t[2] = C * u2 + A * ku2 + B * kku2;
  // R = I + sinc K + cosc K^2
  const double sinc = small_th ? 1.0 - sq / 6.0 : sin_th / th;
  const double cosc = small_th ? 0.5 - sq / 24.0 : (1.0 - cos_th) / sq_safe;
  out.R[0][0] = 1.0 + cosc * (-o2 * o2 - o1 * o1);
  out.R[0][1] = sinc * -o2 + cosc * (o0 * o1);
  out.R[0][2] = sinc * o1 + cosc * (o0 * o2);
  out.R[1][0] = sinc * o2 + cosc * (o0 * o1);
  out.R[1][1] = 1.0 + cosc * (-o2 * o2 - o0 * o0);
  out.R[1][2] = sinc * -o0 + cosc * (o1 * o2);
  out.R[2][0] = sinc * -o1 + cosc * (o0 * o2);
  out.R[2][1] = sinc * o0 + cosc * (o1 * o2);
  out.R[2][2] = 1.0 + cosc * (-o1 * o1 - o0 * o0);
  out.s = s;
  return out;
}

// The residual r = z - h(x) of sim3._distort with intrinsics fx fy cx cy
// k_s, and (when J is given) Jh = dh / dx (models/sim3._distort_jacobian).
__device__ __forceinline__ void project(const double x[3], double fx, double fy, double cx,
                                        double cy, double ks, double z0, double z1, double r[2],
                                        double (*J)[3]) {
  const double k = ks / (0.5 * (fx * fy));
  const double iz = 1.0 / x[2];
  const double du = (fx * x[0] * iz + cx) - cx;
  const double dv = (fy * x[1] * iz + cy) - cy;
  const double dh = 1.0 + (du * du + dv * dv) * k;
  r[0] = z0 - (cx + dh * du);
  r[1] = z1 - (cy + dh * dv);
  if (J != nullptr) {
    const double a = fx * x[0] * iz, b = fy * x[1] * iz;
    const double d = 1.0 + k * (a * a + b * b);
    const double m11 = d + 2.0 * k * a * a, m12 = 2.0 * k * a * b, m22 = d + 2.0 * k * b * b;
    const double da0 = fx * iz, da2 = -a * iz, db1 = fy * iz, db2 = -b * iz;
    J[0][0] = m11 * da0;
    J[0][1] = m12 * db1;
    J[0][2] = m11 * da2 + m12 * db2;
    J[1][0] = m12 * da0;
    J[1][1] = m22 * db1;
    J[1][2] = m12 * da2 + m22 * db2;
  }
}

// Jx = J [I, -[x]x, x] (2 x 7) of a 2 x 3 J, times sign
__device__ __forceinline__ void post_delta(const double (*J)[3], const double x[3], double sign,
                                           double (*Jx)[7]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    Jx[r][0] = sign * J[r][0];
    Jx[r][1] = sign * J[r][1];
    Jx[r][2] = sign * J[r][2];
    Jx[r][3] = sign * (x[1] * J[r][2] - x[2] * J[r][1]);
    Jx[r][4] = sign * (x[2] * J[r][0] - x[0] * J[r][2]);
    Jx[r][5] = sign * (x[0] * J[r][1] - x[1] * J[r][0]);
    Jx[r][6] = sign * (J[r][0] * x[0] + J[r][1] * x[1] + J[r][2] * x[2]);
  }
}

// one thread's H = Ja^T W Jb (7 x 7) into its staged row; sym: Ja == Jb,
// formed on and above the diagonal and mirrored
template <bool kSym>
__device__ __forceinline__ void stage_block(const double (*Ja)[7], const double (*Jb)[7],
                                            double w00, double w01, double w10, double w11,
                                            double* row) {
  double WJ[2][7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    WJ[0][j] = w00 * Jb[0][j] + w01 * Jb[1][j];
    WJ[1][j] = w10 * Jb[0][j] + w11 * Jb[1][j];
  }
#pragma unroll
  for (int a = 0; a < 7; ++a) {
#pragma unroll
    for (int b = kSym ? a : 0; b < 7; ++b) {
      const double h = Ja[0][a] * WJ[0][b] + Ja[1][a] * WJ[1][b];
      row[a * 7 + b] = h;
      if (kSym) row[b * 7 + a] = h;
    }
  }
}

template <bool kLO, bool kJac>
__global__ void __launch_bounds__(kJac ? kTermThreads : kChi2Threads, kJac ? 4 : 2)
    invdist_kernel(Operands in, long long m, TermsOut out, double* __restrict__ chi2,
                   double* __restrict__ partials, unsigned* __restrict__ counter) {
  constexpr int T = kJac ? kTermThreads : kChi2Threads;
  __shared__ __align__(16) double stage[kJac && kLO ? kTermThreads * kTurn : 2];
  __shared__ double red[T / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * T;
  const long long i = i0 + tid;
  const int n = static_cast<int>(m - i0 < T ? m - i0 : T);
  // a thread past the last edge computes the last edge's terms, which no
  // store reads, and adds nothing to chi2
  const long long e = i < m ? i : m - 1;

  const double2 w0 = __ldg(reinterpret_cast<const double2*>(in.info) + 2 * e);
  const double2 w1 = __ldg(reinterpret_cast<const double2*>(in.info) + 2 * e + 1);
  const bool ok = i < m && __ldg(in.valid + e) != 0;
  const double* v = in.lm + __ldg(in.idx + (kLO ? 3 : 1) * e) * 4;
  const double q = __ldg(v + 0);
  const double xo[3] = {__ldg(v + 1) / q, __ldg(v + 2) / q, __ldg(v + 3) / q};

  double r[2], Jh[2][3];
  double x[3], M[3][3];  // M: LO only
  double z0, z1, fx, fy, cx, cy, ks;
  if constexpr (kLO) {
    const double2 z = __ldg(reinterpret_cast<const double2*>(in.meas) + e);
    z0 = z.x;
    z1 = z.y;
    const Sim3 so = camera_sim3(in.cams + __ldg(in.idx + 3 * e + 1) * 12);
    const double* cam = in.cams + __ldg(in.idx + 3 * e + 2) * 12;
    const Sim3 sc = camera_sim3(cam);
    fx = __ldg(cam + 7), fy = __ldg(cam + 8), cx = __ldg(cam + 9), cy = __ldg(cam + 10);
    ks = __ldg(cam + 11);
    // M = (s_o / s_c) R_c^T R_o; x = M x_o + R_c^T (t_o - t_c) / s_c
    const double scale = so.s / sc.s;
    const double dt[3] = {so.t[0] - sc.t[0], so.t[1] - sc.t[1], so.t[2] - sc.t[2]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        M[a][b] = (sc.R[0][a] * so.R[0][b] + sc.R[1][a] * so.R[1][b] + sc.R[2][a] * so.R[2][b]) *
                  scale;
      x[a] = M[a][0] * xo[0] + M[a][1] * xo[1] + M[a][2] * xo[2] +
             (sc.R[0][a] * dt[0] + sc.R[1][a] * dt[1] + sc.R[2][a] * dt[2]) / sc.s;
    }
  } else {
    const double* z = in.meas + 7 * e;
    z0 = __ldg(z + 0), z1 = __ldg(z + 1), fx = __ldg(z + 2), fy = __ldg(z + 3);
    cx = __ldg(z + 4), cy = __ldg(z + 5), ks = __ldg(z + 6);
    x[0] = xo[0], x[1] = xo[1], x[2] = xo[2];
  }
  project(x, fx, fy, cx, cy, ks, z0, z1, r, kJac ? Jh : nullptr);
  // W r, and r^T W r
  const double Wr0 = w0.x * r[0] + w0.y * r[1], Wr1 = w1.x * r[0] + w1.y * r[1];
  const double chi = ok ? r[0] * Wr0 + r[1] * Wr1 : 0.0;

  if constexpr (kJac) {
    // J_q = Jh M x_o / q (LS: M = I); W J_q
    double JhM[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if constexpr (kLO)
          JhM[a][b] = Jh[a][0] * M[0][b] + Jh[a][1] * M[1][b] + Jh[a][2] * M[2][b];
        else
          JhM[a][b] = Jh[a][b];
      }
    const double Jq0 = (JhM[0][0] * xo[0] + JhM[0][1] * xo[1] + JhM[0][2] * xo[2]) / q;
    const double Jq1 = (JhM[1][0] * xo[0] + JhM[1][1] * xo[1] + JhM[1][2] * xo[2]) / q;
    const double WJq0 = w0.x * Jq0 + w0.y * Jq1, WJq1 = w1.x * Jq0 + w1.y * Jq1;
    const double D = Jq0 * WJq0 + Jq1 * WJq1;
    const double gl = Jq0 * Wr0 + Jq1 * Wr1;
    if constexpr (kLO) {
      double Jo[2][7], Jc[2][7];
      post_delta(JhM, xo, -1.0, Jo);
      post_delta(Jh, x, 1.0, Jc);
      double* row = stage + tid * kTurn;
      stage_block<true>(Jo, Jo, w0.x, w0.y, w1.x, w1.y, row);
      __syncthreads();
      store_rows<49>(stage, out.hoo + i0 * 49, n);
      __syncthreads();
      stage_block<true>(Jc, Jc, w0.x, w0.y, w1.x, w1.y, row);
      __syncthreads();
      store_rows<49>(stage, out.hcc + i0 * 49, n);
      __syncthreads();
      stage_block<false>(Jo, Jc, w0.x, w0.y, w1.x, w1.y, row);
      __syncthreads();
      store_rows<49>(stage, out.hoc + i0 * 49, n);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 7; ++a) {
        stage[tid * 7 + a] = Jo[0][a] * Wr0 + Jo[1][a] * Wr1;
        stage[kOffGc + tid * 7 + a] = Jc[0][a] * Wr0 + Jc[1][a] * Wr1;
        stage[kOffBo + tid * 7 + a] = Jo[0][a] * WJq0 + Jo[1][a] * WJq1;
        stage[kOffBc + tid * 7 + a] = Jc[0][a] * WJq0 + Jc[1][a] * WJq1;
      }
      stage[kOffD + tid] = D;
      stage[kOffGl + tid] = gl;
      __syncthreads();
      store_rows<7>(stage, out.go + i0 * 7, n);
      store_rows<7>(stage + kOffGc, out.gc + i0 * 7, n);
      store_rows<7>(stage + kOffBo, out.b + i0 * 7, n);
      store_rows<7>(stage + kOffBc, out.b + (m + i0) * 7, n);
      store_rows<1>(stage + kOffD, out.dl + i0, n);
      store_rows<1>(stage + kOffGl, out.gl + i0, n);
    } else if (i < m) {
      out.dl[i] = D;
      out.gl[i] = gl;
    }
  }

  // chi2: the CTA's partial, then the last CTA sums the partials in order
  const double part = cta_sum<T>(chi, red);
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
      double pv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) pv[u] = __ldcg(partials + p + u * T);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += pv[u];
    }
    for (; p < gridDim.x; p += T) acc += __ldcg(partials + p);
    const double total = cta_sum<T>(acc, red);
    if (tid == 0) *chi2 = total;
  }
}

template <bool kJac>
long long invdist_blocks(long long m) {
  constexpr int T = kJac ? kTermThreads : kChi2Threads;
  return (m + T - 1) / T;
}

template <bool kLO, bool kJac>
int launch_invdist(const Operands& in, long long m, const TermsOut& out, void* chi2, void* ws,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return static_cast<int>(cudaMemsetAsync(chi2, 0, sizeof(double), s));
  const long long blocks = invdist_blocks<kJac>(m);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  double* partials = static_cast<double*>(ws);
  unsigned* counter = reinterpret_cast<unsigned*>(partials + blocks);
  if (cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s))
    return static_cast<int>(err);
  invdist_kernel<kLO, kJac><<<static_cast<unsigned>(blocks), kJac ? kTermThreads : kChi2Threads, 0, s>>>(
      in, m, out, static_cast<double*>(chi2), partials, counter);
  return static_cast<int>(cudaGetLastError());
}

Operands operands(const void* lm, const void* cams, const void* idx, const void* meas,
                  const void* info, const void* valid) {
  return {static_cast<const double*>(lm), static_cast<const double*>(cams),
          static_cast<const long long*>(idx), static_cast<const double*>(meas),
          static_cast<const double*>(info), static_cast<const unsigned char*>(valid)};
}

}  // namespace

extern "C" {

// The workspace of any form: one partial a CTA (the terms forms have the
// more CTAs), then the ticket counter.
int slampp_invdist_workspace(long long m, long long* out) {
  *out = invdist_blocks<true>(m) * static_cast<long long>(sizeof(double)) + 16;
  return 0;
}
int slampp_invdist_lo_terms_f64(const void* lm, const void* cams, const void* idx,
                                const void* meas, const void* info, const void* valid,
                                long long m, void* hoo, void* hcc, void* hoc, void* go, void* gc,
                                void* dl, void* gl, void* b, void* chi2, void* ws, void* stream) {
  const TermsOut out = {static_cast<double*>(hoo), static_cast<double*>(hcc),
                        static_cast<double*>(hoc), static_cast<double*>(go),
                        static_cast<double*>(gc),  static_cast<double*>(dl),
                        static_cast<double*>(gl),  static_cast<double*>(b)};
  return launch_invdist<true, true>(operands(lm, cams, idx, meas, info, valid), m, out, chi2, ws,
                                    stream);
}
int slampp_invdist_lo_chi2_f64(const void* lm, const void* cams, const void* idx,
                               const void* meas, const void* info, const void* valid, long long m,
                               void* chi2, void* ws, void* stream) {
  return launch_invdist<true, false>(operands(lm, cams, idx, meas, info, valid), m, TermsOut{},
                                     chi2, ws, stream);
}
int slampp_invdist_ls_terms_f64(const void* lm, const void* idx, const void* meas,
                                const void* info, const void* valid, long long m, void* dl,
                                void* gl, void* chi2, void* ws, void* stream) {
  TermsOut out{};
  out.dl = static_cast<double*>(dl);
  out.gl = static_cast<double*>(gl);
  return launch_invdist<false, true>(operands(lm, nullptr, idx, meas, info, valid), m, out, chi2,
                                     ws, stream);
}
int slampp_invdist_ls_chi2_f64(const void* lm, const void* idx, const void* meas,
                               const void* info, const void* valid, long long m, void* chi2,
                               void* ws, void* stream) {
  return launch_invdist<false, false>(operands(lm, nullptr, idx, meas, info, valid), m,
                                      TermsOut{}, chi2, ws, stream);
}

}  // extern "C"
