// Stand-in for <cuda_runtime.h> that runs a CUDA kernel on the CPU, for
// tests/test_torch_cuda_emulated.py: one std::thread per CUDA thread, one
// block at a time; __syncthreads() and the warp shuffles are
// std::barrier's.  __shared__ variables become statics, shared by the
// block's threads.  cp.async (cuda_pipeline_primitives.h beside this
// file) is a synchronous copy.  A barrier that not every thread reaches
// hangs, as on the card: the test runs the kernel in a child process with
// a timeout.
// Only the features the port's kernels use are provided.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

struct emu_dim3 {
  int x;
};
inline thread_local emu_dim3 emu_thread_idx;
inline emu_dim3 emu_block_idx;
#define threadIdx emu_thread_idx
#define blockIdx emu_block_idx

inline std::barrier<>* emu_block_barrier;
inline std::barrier<>* emu_warp_barrier[32];
inline double emu_warp_lanes[32][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

template <class T>
T __shfl_down_sync(unsigned, T v, int offset) {
  const int w = emu_thread_idx.x >> 5, lane = emu_thread_idx.x & 31;
  static_assert(sizeof(T) <= sizeof(double));
  std::memcpy(&emu_warp_lanes[w][lane], &v, sizeof(T));
  emu_warp_barrier[w]->arrive_and_wait();
  T r = v;
  if (lane + offset < 32) std::memcpy(&r, &emu_warp_lanes[w][lane + offset], sizeof(T));
  emu_warp_barrier[w]->arrive_and_wait();
  return r;
}

template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  const int w = emu_thread_idx.x >> 5, lane = emu_thread_idx.x & 31;
  static_assert(sizeof(T) <= sizeof(double));
  std::memcpy(&emu_warp_lanes[w][lane], &v, sizeof(T));
  emu_warp_barrier[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_warp_lanes[w][lane ^ mask], sizeof(T));
  emu_warp_barrier[w]->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = emu_thread_idx.x >> 5, lane = emu_thread_idx.x & 31;
  const double bit = pred ? 1.0 : 0.0;
  std::memcpy(&emu_warp_lanes[w][lane], &bit, sizeof(bit));
  emu_warp_barrier[w]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if (emu_warp_lanes[w][l] != 0.0) r |= 1u << l;
  emu_warp_barrier[w]->arrive_and_wait();
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
struct CUstream_st;
typedef CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, int, int) { return cudaSuccess; }
using std::max;
using std::min;

// kernel<<<grid, threads, shmem, stream>>>(args) becomes
// emu_launch(kernel, grid, threads, args)
template <class K, class A>
void emu_launch(K kernel, int grid, int threads, const A& args) {
  for (int b = 0; b < grid; ++b) {
    emu_block_idx.x = b;
    std::barrier<> block(threads);
    emu_block_barrier = &block;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < threads / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      emu_warp_barrier[w] = warps.back().get();
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        emu_thread_idx.x = t;
        kernel(args);
      });
    for (auto& th : pool) th.join();
  }
}
