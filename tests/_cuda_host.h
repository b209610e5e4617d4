// Host stand-ins for the CUDA features that csrc/ba_kernels.cu uses, so that
// tests/test_torch_ba_kernels.py can build the kernel's own source with the
// host C++ compiler and run it on the CPU: a CTA's threads are std::threads
// meeting at one barrier (__syncthreads, and each warp shuffle as a
// write-barrier-read-barrier through a CTA-wide buffer), CTAs run one after
// another, __shared__ variables are function statics.  It runs the kernel's
// indexing, staging, reductions and ticket in order, not its timing.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
struct double2 {
  double x, y;
};
inline double2 make_double2(double a, double b) { return {a, b}; }
struct HostDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim threadIdx;
inline HostDim blockIdx, gridDim;
inline std::barrier<>* host_cta_barrier = nullptr;
inline double host_shuffle[1024];

template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
inline void __syncthreads() { host_cta_barrier->arrive_and_wait(); }
inline double __shfl_down_sync(unsigned, double v, int off) {
  host_shuffle[threadIdx.x] = v;
  __syncthreads();
  const double o = (threadIdx.x & 31) + off < 32 ? host_shuffle[threadIdx.x + off] : v;
  __syncthreads();
  return o;
}
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p += v;
  return old;
}
inline void sincos(double a, double* s, double* c) {
  *s = std::sin(a);
  *c = std::cos(a);
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  unsigned char* b = static_cast<unsigned char*>(p);
  for (size_t i = 0; i < n; ++i) b[i] = static_cast<unsigned char>(v);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

// kernel<<<grid, block, smem, stream>>>(args) becomes
// host_launch(grid, block, smem, stream, [&]() { kernel(args); })
inline void host_launch(unsigned grid, int block, int, cudaStream_t,
                        const std::function<void()>& body) {
  gridDim.x = grid;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(block);
    host_cta_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
