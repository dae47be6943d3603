// Stand-in for <cuda_runtime.h> that runs a CUDA kernel on the CPU, for
// tests/test_torch_cuda_emulated.py: one std::thread per CUDA thread, one
// block at a time; __syncthreads() and the warp shuffles are
// std::barrier's.  __shared__ variables become statics, shared by the
// block's threads.  cp.async (cuda_pipeline_primitives.h beside this
// file, and the PTX wrappers below) is a synchronous copy; mma.sync is a
// warp-wide exchange through a per-warp array.  A barrier that not every
// thread reaches hangs, as on the card: the test runs the kernel in a
// child process with a timeout.
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
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))

struct float2 {
  float x, y;
};
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

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof(u));
  return u;
}

// The PTX instructions that csrc/block_sparse.cu wraps in functions of its
// own (it declares them for host compilers and defines them for the card).

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a * b for the
// warp: each lane deposits its fragments, the warp meets, and each lane
// computes its own four outputs.  Fragments as in the PTX ISA, with
// g = lane / 4 and tig = lane % 4: A (16 x 8) a0 = (g, tig), a1 = (g + 8,
// tig), a2 = (g, tig + 4), a3 = (g + 8, tig + 4); B (8 x 8) b0 = (tig, g),
// b1 = (tig + 4, g); D (16 x 8) d0, d1 = (g, 2 tig + {0, 1}), d2, d3 =
// (g + 8, 2 tig + {0, 1}).  The tensor core reads the top 19 bits of each
// operand; the eight products are summed exactly (double) and added to d
// with one rounding.  Two arrays a warp, used in turn, so that one
// barrier a call keeps a lane from overwriting what another still reads.
inline unsigned emu_mma_a[32][2][32][4];
inline unsigned emu_mma_b[32][2][32][2];
inline thread_local int emu_mma_turn;

inline double emu_tf32_value(unsigned bits) {
  bits &= 0xffffe000u;
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

inline void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                     const unsigned (&b)[2]) {
  const int w = emu_thread_idx.x >> 5, lane = emu_thread_idx.x & 31;
  const int turn = emu_mma_turn;
  emu_mma_turn ^= 1;
  for (int k = 0; k < 4; ++k) emu_mma_a[w][turn][lane][k] = a[k];
  for (int k = 0; k < 2; ++k) emu_mma_b[w][turn][lane][k] = b[k];
  emu_warp_barrier[w]->arrive_and_wait();
  const auto A = [&](int row, int col) {  // lane, then register
    return emu_tf32_value(emu_mma_a[w][turn][(row % 8) * 4 + col % 4]
                                    [row / 8 + 2 * (col / 4)]);
  };
  const auto B = [&](int k, int n) {
    return emu_tf32_value(emu_mma_b[w][turn][n * 4 + k % 4][k / 4]);
  };
  const int g = lane / 4, tig = lane % 4;
  for (int h = 0; h < 2; ++h)
    for (int e = 0; e < 2; ++e) {
      double sum = 0.0;
      for (int k = 0; k < 8; ++k) sum += A(g + 8 * h, k) * B(k, 2 * tig + e);
      d[2 * h + e] = static_cast<float>(d[2 * h + e] + sum);
    }
}

// cp.async.cg (16 bytes) and cp.async.ca (4 bytes) with a source size:
// the first src_bytes copied now, the rest of the destination zeroed
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);
}
inline void cp_async4(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, 4 - src_bytes);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

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
