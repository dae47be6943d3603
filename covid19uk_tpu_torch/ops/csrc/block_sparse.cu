// Block-sparse (block-ELL) matrix times dense matrix for Hopper (sm_90a).
//
// Replaces covid19uk_tpu/ops/pallas/block_sparse.py:_bsr_apply (the Pallas
// TPU kernels _strip_kernel and _matmul_kernel, two TPU-shaped variants of
// one function, ported here as one kernel).  Its plain PyTorch version is
// bsr_matmul_reference in ../block_sparse.py.
//
//   y[s, i*B + r, t] = sum_j sum_c values[i, j, r, c]
//                                 * x[s, col_idx[i, j]*B + c, t]
//
// values [R, K, B, B] (B = 128), col_idx [R, K] int32, x and y
// [S, R*B, Tp] float32 with Tp a multiple of 64, all contiguous.  Padded
// slots are zero blocks at column 0 and padded rows of x are zero, so
// they add exactly zero: no masks.
//
// What bounds it on this card: operations.  At the MSOA shape (R = 55,
// K = 9 slots of which 383 of 495 hold a block, T = 120, S = 1) one
// product needs 1.51 GFLOP of float32 FMA (2.08 GFLOP with the padded
// slots and days the kernel also runs) against 32 MB: 0.022 ms at the
// 67 TFLOP/s float32 rate outside the tensor cores, 0.010 ms at
// 3.35 TB/s.  TF32 tensor cores would round the inputs to 10-bit
// mantissas, past the port's 1e-5 tolerance, so the arithmetic stays on
// the CUDA cores.
// What the design does about it: one block of 256 threads per (64-column
// tile of t, block row i, batch s); each thread keeps an 8 x 4 register
// tile of y and writes it once.  The block walks the K slots and, inside
// each, the 128 columns of the block in chunks of 32: a 128 x 32 tile of
// values (stored transposed, [column][row]) and the matching 32 x 64 tile
// of x are staged in shared memory, and every thread does 8 x 4 x 32 FMAs
// from it, reading A and x as float4 (3 shared loads per 32 FMAs).  The
// next chunk's global loads are issued into registers before the current
// chunk is computed, so their latency hides behind the FMAs.  No TMA, no
// wgmma, no cluster multicast of x: those are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 128;        // block size (rows and columns)
constexpr int kTile = 64;      // columns of t per thread block
constexpr int kChunk = 32;     // columns of a value block staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 4 outputs each

struct Args {
  const float* values;
  const int* col_idx;
  const float* x;
  float* y;
  int R, K, S, Tp;
};

constexpr int kALoads = kB * kChunk / kThreads;     // 16 values a thread
constexpr int kXLoads = kChunk * kTile / kThreads;  // 8 of x a thread

// Global -> registers: chunk q is slot q / 4, columns (q % 4) * 32 ..
// + 32 of the value block; consecutive threads read consecutive columns
// (values) and consecutive days (x).
__device__ __forceinline__ void load_chunk(const Args& a, int i, int q,
                                           const float* xs, int tid,
                                           float (&ra)[kALoads],
                                           float (&rx)[kXLoads]) {
  const int j = q / (kB / kChunk);
  const int c0 = (q % (kB / kChunk)) * kChunk;
  const int cb = a.col_idx[i * a.K + j];
  const float* blk =
      a.values + (static_cast<long long>(i) * a.K + j) * kB * kB + c0;
  const float* xb = xs + (static_cast<long long>(cb) * kB + c0) * a.Tp;
  for (int n = 0; n < kALoads; ++n) {
    const int e = tid + n * kThreads;
    ra[n] = blk[(e / kChunk) * kB + e % kChunk];
  }
  for (int n = 0; n < kXLoads; ++n) {
    const int e = tid + n * kThreads;
    rx[n] = xb[static_cast<long long>(e / kTile) * a.Tp + e % kTile];
  }
}

__global__ void __launch_bounds__(kThreads) bsr_matmul_kernel(const Args a) {
  // values tile transposed, [column][row]; a row stride of 132 floats
  // keeps float4 reads aligned and spreads the transposing stores over 8
  // banks
  __shared__ __align__(16) float As[kChunk][kB + 4];
  __shared__ __align__(16) float Xs[kChunk][kTile];  // x tile

  const int tid = threadIdx.x;
  const int tiles = a.Tp / kTile;
  const int tile = blockIdx.x % tiles;
  const int i = (blockIdx.x / tiles) % a.R;
  const int s = blockIdx.x / (tiles * a.R);
  const int ty = tid / 16, tx = tid % 16;  // rows ty*8.., cols tx*4..
  const int t0 = tile * kTile;
  const long long rows = static_cast<long long>(a.R) * kB;
  const float* xs = a.x + static_cast<long long>(s) * rows * a.Tp + t0;
  const int chunks = a.K * (kB / kChunk);

  float acc[8][4];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  float ra[kALoads], rx[kXLoads];
  load_chunk(a, i, 0, xs, tid, ra, rx);
  for (int q = 0; q < chunks; ++q) {
    for (int n = 0; n < kALoads; ++n) {
      const int e = tid + n * kThreads;
      As[e % kChunk][e / kChunk] = ra[n];
    }
    for (int n = 0; n < kXLoads; ++n) {
      const int e = tid + n * kThreads;
      Xs[e / kTile][e % kTile] = rx[n];
    }
    __syncthreads();
    if (q + 1 < chunks) load_chunk(a, i, q + 1, xs, tid, ra, rx);
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Xs[k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xv[4] = {b.x, b.y, b.z, b.w};
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], xv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* yo = a.y + static_cast<long long>(s) * rows * a.Tp +
              static_cast<long long>(i * kB + ty * 8) * a.Tp + t0 + tx * 4;
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 4; ++c) yo[static_cast<long long>(r) * a.Tp + c] = acc[r][c];
}

}  // namespace

extern "C" int bsr_matmul_launch(const float* values, const int* col_idx,
                                 const float* x, float* y, int R, int K,
                                 int S, int Tp, void* stream) {
  if (R < 1 || K < 1 || S < 1 || Tp < kTile || Tp % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{values, col_idx, x, y, R, K, S, Tp};
  const int grid = (Tp / kTile) * R * S;
  bsr_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
