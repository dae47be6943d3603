// Block-sparse (block-ELL) matrix times dense matrix for Hopper (sm_90a),
// with the operator's permutation folded in.
//
// Replaces covid19uk_tpu/ops/pallas/block_sparse.py:118 (_bsr_apply: the
// Pallas TPU kernels _strip_kernel and _matmul_kernel, two TPU-shaped
// variants of one function, ported here as one kernel) together with the
// gathers and the padding around it in BlockSparse.matmul.  Its plain
// PyTorch version is _plain in ../block_sparse.py.
//
//   y[s, perm[i*B + r], t] = sum_j sum_c values[i, j, r, c]
//                                  * x[s, perm[col_idx[i, j]*B + c], t]
//
// for r with i*B + r < M; a permuted row at or past M is a zero row of x
// and writes nothing.  values [R, K, B, B] (B = 128), col_idx [R, K],
// slots [R] (the slots of row i to visit: 1 + its last slot that holds a
// nonzero; the slots after it are zero blocks), order [R] (the rows,
// longest first), perm [M] int32; x and y [S, M, T] float32, unpadded.
//
// What bounds it on this card.  At the MSOA shape (R = 55, K = 9, 383 of
// 495 slots hold a block, M = 7000, T = 120, S = 1) one product needs 1.51
// GFLOP and 31.8 MB (the populated blocks, x read once, y written once).
// On the CUDA cores that is 0.0225 ms of float32 FMA; on the tensor cores
// 3 x 1.51 GFLOP of TF32 (below) take 0.0092 ms at 495 TFLOP/s, so the
// bound becomes the bytes: 0.0095 ms at 3.35 TB/s.  On an H100 this
// design is several times slower than that, and its products (fragment
// loads, splits, mma.sync), not its copies, set the time
// (profile_torch.py's part split; PERF.md has the numbers).
//
// What the design does about it:
// - Tensor cores through 3xTF32.  TF32 alone keeps a 10-bit mantissa,
//   past the port's 1e-5 of |A|@|x|.  Each operand v is split on the fly
//   into big = v rounded to TF32 and small = v - big, and mma.sync m16n8k8
//   accumulates big*big + big*small + small*big in float32 (small*small,
//   ~2^-22 of the product, is dropped).  The rounding is two integer
//   instructions (see split): cvt.rna.tf32.f32 compiles to a longer
//   sequence on this card, and with it the warps were issue-bound.  wgmma
//   is not used: for tf32 it takes both operands K-major from shared
//   memory, and x arrives [column][day] with days contiguous.
// - Work split.  A thread block owns 64 output rows (half a block row)
//   and 16, 32, 48 or 64 days (the wrapper picks the width that computes
//   the fewest padded days among those that give at least two blocks an
//   SM), and walks only its row's populated slots.  Four warps, each 32
//   rows x half the days, the number of 8-day tiles a warp takes fixed at
//   compile time (one kernel instance a width), so that no branch splits
//   its products.  The grid runs the longest rows first, so the 9-slot
//   rows do not set the tail.  No atomics and no split over slots: each y
//   element is summed by one thread in a fixed order, so two launches on
//   the same input give bitwise-equal y.
// - A 4-stage cp.async ring in dynamic shared memory, one stage per 32
//   columns of a value block: the 64 x 32 value tile (16-byte copies) and
//   the 32-column x tile, gathered through perm row by row (16-byte
//   copies, zero-filled past M and past T; 4-byte copies when T % 4 != 0
//   or x is not 16-byte aligned).  Every thread copies and computes; a
//   separate copy warp fed by mbarriers was slower, one warp issuing a
//   stage's 768 copies.  Rows of both tiles are padded, and the k index
//   of the fragments permuted, so that a warp's fragment loads hit 32
//   distinct banks and a row's two A values are one 64-bit load.  About
//   64 KB a block at the MSOA shape's 32-day tiles: three blocks an SM.
// - The permutation is read from the block's perm entries, staged once
//   per block by cp.async; y is written straight to its permuted rows.
// Each PTX instruction sits in its own small function below, so that the
// CPU emulation (tests/cuda_emulation/) can supply its own.
//
// Built with -DK2_COPIES_ONLY (no products) or -DK2_PRODUCTS_ONLY (the
// ring filled once, no copies after it), the kernel does one part of its
// work alone, for profile_torch.py's timing; its y is then wrong.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#if defined(__CUDA_ARCH__)
// d += a (16 x 8, row) * b (8 x 8, col): one warp, PTX fragment layout
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, the first src_bytes from src, the rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, zero when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
#else
// Declared only: nvcc's host pass compiles no device code, and the CPU
// emulation's cuda_runtime.h defines them.
__device__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                         const unsigned (&b)[2]);
__device__ void cp_async16(void* dst, const void* src, int src_bytes);
__device__ void cp_async4(void* dst, const void* src, int src_bytes);
__device__ void cp_async_commit();
template <int N>
__device__ void cp_async_wait();
#endif

namespace {

constexpr int kB = 128;        // block size (rows and columns)
constexpr int kRows = 64;      // output rows of a thread block
constexpr int kChunk = 32;     // columns of a value block in a ring stage
constexpr int kStages = 4;     // ring stages
constexpr int kThreads = 128;  // 4 warps: 2 (rows) x 2 (days)
// Inside each 8-column step the fragments' k index is permuted, for A and
// B alike (the product does not change): k = tig reads column 2 tig and
// k = tig + 4 column 2 tig + 1, so a thread's two A values of a row are
// one 64-bit load.  Staged value rows of 40 floats = 8 (mod 32) put each
// half warp's 64-bit A loads on 32 banks; rows stay 16-byte aligned.
constexpr int kAStride = kChunk + 8;
constexpr int kAFloats = kRows * kAStride;

// Staged x rows of days + 4 floats: for the 16 NN days of a block that
// is 4 (mod 16), which puts a warp's B fragment loads (rows 2 tig and
// 2 tig + 1, 8 days) on 32 banks.
constexpr int x_stride(int days) { return days + 4; }
constexpr int stage_floats(int days) {
  return kAFloats + kChunk * x_stride(days);
}

// A thread block of NN owns 16 NN days, each warp column NN 8-day tiles.
template <int NN>
struct Tile {
  static constexpr int kDays = 16 * NN;
  static constexpr int kXStride = x_stride(kDays);
  static constexpr int kStageFloats = stage_floats(kDays);
};

struct Args {
  const float* values;
  const int* col_idx;
  const int* slots;
  const int* order;
  const int* perm;
  const float* x;
  float* y;
  int R, K, M, S, T;
  int day_tiles;
  int vec;  // 16-byte copies of x (T % 4 == 0, x 16-byte aligned)
};

// The 3xTF32 split, as bits: big is v rounded to TF32 (to nearest, ties
// away from zero: half an ulp added, the low 13 bits cleared; for finite
// v what cvt.rna.tf32.f32 gives, in 2 integer instructions), small = v -
// big, exact in float32 and passed as it is: the tensor core reads the
// top 19 bits of an operand, so small keeps 11 bits of the remainder,
// ~2^-21 of v.
__device__ __forceinline__ void split(float v, unsigned& big,
                                      unsigned& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// Issues the copies of chunk q (slot q / 4, columns (q % 4) * 32 .. + 32
// of its value block) into the ring stage at ``stage``.
template <int NN>
__device__ __forceinline__ void issue_chunk(const Args& a, int i, int s,
                                            int r0, int t0, int q,
                                            float* stage, const int* cols,
                                            const int* cblk, int tid) {
  using Tl = Tile<NN>;
  const int j = q / (kB / kChunk);
  const int c0 = (q % (kB / kChunk)) * kChunk;
  const float* blk =
      a.values + ((static_cast<long long>(i) * a.K + j) * kB + r0) * kB + c0;
  for (int p = tid; p < kRows * kChunk / 4; p += kThreads) {
    const int rr = p / (kChunk / 4), sg = p % (kChunk / 4);
    cp_async16(stage + rr * kAStride + sg * 4, blk + rr * kB + sg * 4, 16);
  }
  float* xs = stage + kAFloats;
  const float* xb = a.x + static_cast<long long>(s) * a.M * a.T;
  const int rbase = cblk[j] * kB + c0;  // permuted row of column c0
  const int* src_row = cols + j * kB + c0;
  if (a.vec) {
    constexpr int segs = Tl::kDays / 4;
    for (int p = tid; p < kChunk * segs; p += kThreads) {
      const int cc = p / segs, t = t0 + (p % segs) * 4;
      const bool ok = rbase + cc < a.M && t < a.T;
      const float* src =
          ok ? xb + static_cast<long long>(src_row[cc]) * a.T + t : a.x;
      cp_async16(xs + cc * Tl::kXStride + (t - t0), src, ok ? 16 : 0);
    }
  } else {
    for (int p = tid; p < kChunk * Tl::kDays; p += kThreads) {
      const int cc = p / Tl::kDays, t = t0 + p % Tl::kDays;
      const bool ok = rbase + cc < a.M && t < a.T;
      const float* src =
          ok ? xb + static_cast<long long>(src_row[cc]) * a.T + t : a.x;
      cp_async4(xs + cc * Tl::kXStride + (t - t0), src, ok ? 4 : 0);
    }
  }
}

template <int NN>
__global__ void __launch_bounds__(kThreads, 3)
    bsr_matmul_kernel(const Args a) {
  using Tl = Tile<NN>;
  extern __shared__ __align__(16) float smem[];
  // after the ring: the x row each (slot, column) of this block row
  // reads (perm of its permuted row), then the slots' column blocks
  int* cols = reinterpret_cast<int*>(smem + kStages * Tl::kStageFloats);
  int* cblk = cols + a.K * kB;

  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int dt = b % a.day_tiles;
  b /= a.day_tiles;
  const int half = b % 2;
  b /= 2;
  const int s = b % a.S;
  const int i = a.order[b / a.S];
  const int n_slots = min(a.slots[i], a.K);
  const int chunks = n_slots * (kB / kChunk);
  const int r0 = half * kRows;
  const int t0 = dt * Tl::kDays;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wr = warp / 2, wc = warp % 2;

  // the y rows of this thread's accumulators (-1: past M)
  int yrow[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * kB + r0 + wr * 32 + m * 16 + h * 8 + g;
      yrow[m][h] = r < a.M ? a.perm[r] : -1;
    }

  for (int j = tid; j < n_slots; j += kThreads)
    cblk[j] = a.col_idx[i * a.K + j];
  __syncthreads();
  for (int e = tid; e < n_slots * kB; e += kThreads) {
    const int r = cblk[e / kB] * kB + e % kB;
    cp_async4(cols + e, a.perm + (r < a.M ? r : 0), r < a.M ? 4 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][NN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks)
      issue_chunk<NN>(a, i, s, r0, t0, q, smem + q * Tl::kStageFloats, cols,
                      cblk, tid);
    cp_async_commit();
  }
  for (int q = 0; q < chunks; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q landed; chunk q - 1's stage is free
#if !defined(K2_PRODUCTS_ONLY)
    const int qn = q + kStages - 1;
    if (qn < chunks)
      issue_chunk<NN>(a, i, s, r0, t0, qn,
                      smem + (qn % kStages) * Tl::kStageFloats, cols, cblk,
                      tid);
#endif
    cp_async_commit();
#if !defined(K2_COPIES_ONLY)
    const float* as_ = smem + (q % kStages) * Tl::kStageFloats;
    const float* xs = as_ + kAFloats + wc * 8 * NN;
#pragma unroll
    for (int k = 0; k < kChunk; k += 8) {
      unsigned abig[2][4], asmall[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* ap =
            as_ + (wr * 32 + m * 16 + g) * kAStride + k + 2 * tig;
        const float2 lo = *reinterpret_cast<const float2*>(ap);
        const float2 hi = *reinterpret_cast<const float2*>(ap + 8 * kAStride);
        split(lo.x, abig[m][0], asmall[m][0]);
        split(hi.x, abig[m][1], asmall[m][1]);
        split(lo.y, abig[m][2], asmall[m][2]);
        split(hi.y, abig[m][3], asmall[m][3]);
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const float* bp = xs + (k + 2 * tig) * Tl::kXStride + n * 8 + g;
        unsigned bbig[2], bsmall[2];
        split(bp[0], bbig[0], bsmall[0]);
        split(bp[Tl::kXStride], bbig[1], bsmall[1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(acc[m][n], asmall[m], bbig);
          mma_tf32(acc[m][n], abig[m], bsmall);
          mma_tf32(acc[m][n], abig[m], bbig);
        }
      }
    }
#endif
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (yrow[m][h] < 0) continue;
      float* yo = a.y + (static_cast<long long>(s) * a.M + yrow[m][h]) * a.T;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int t = t0 + wc * 8 * NN + n * 8 + 2 * tig;
        if (t < a.T) yo[t] = acc[m][n][2 * h];
        if (t + 1 < a.T) yo[t + 1] = acc[m][n][2 * h + 1];
      }
    }
}

// dynamic shared memory of a block: the ring, then the perm entries and
// column blocks of K slots
long long shared_bytes(int K, int tile_days) {
  return kStages * stage_floats(tile_days) * sizeof(float) +
         (static_cast<long long>(K) * kB + K) * sizeof(int);
}

template <int NN>
int launch(const Args& a, int grid, void* stream) {
  const long long shmem = shared_bytes(a.K, Tile<NN>::kDays);
  if (shmem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsr_matmul_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bsr_matmul_kernel<NN><<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_matmul_launch(const float* values, const int* col_idx,
                                 const int* slots, const int* order,
                                 const int* perm, const float* x, float* y,
                                 int R, int K, int M, int S, int T,
                                 int tile_days, void* stream) {
  if (R < 1 || K < 1 || S < 1 || T < 1 || M < 1 ||
      M > static_cast<long long>(R) * kB || tile_days < 16 ||
      tile_days > 64 || tile_days % 16 ||
      reinterpret_cast<std::uintptr_t>(values) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int day_tiles = (T + tile_days - 1) / tile_days;
  const long long blocks = static_cast<long long>(R) * S * 2 * day_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec =
      T % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const Args a{values, col_idx, slots, order, perm, x, y, R, K, M, S, T,
               day_tiles, vec};
  const int grid = static_cast<int>(blocks);
  switch (tile_days / 16) {
    case 1: return launch<1>(a, grid, stream);
    case 2: return launch<2>(a, grid, stream);
    case 3: return launch<3>(a, grid, stream);
    default: return launch<4>(a, grid, stream);
  }
}

extern "C" long long bsr_matmul_shared_bytes(int K, int tile_days) {
  return shared_bytes(K, tile_days);
}

extern "C" const char* block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
