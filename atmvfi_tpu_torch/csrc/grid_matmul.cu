// Row P's gridded matmul: out[M, N] = a[M, K] @ b[K, N], f32 operands
// and f32 sums, one block per 64-row tile of the output, for sm_90a.
//
// Replaces the toy Pallas kernel of `tests/test_roofline.py:56`
// (`test_pallas_flops_counted_through_grid`): [128, 64] @ [64, 64] with
// grid (2,), a (64, 64) block of a per grid step against all of b. That
// kernel exists to check that the JAX roofline counter counts through a
// kernel's grid; this one is the port's counterpart for
// `utils/roofline.py::count_flops`, which counts the wrapper
// (`ops/probe_cuda.py::grid_matmul`) by its plain version, block by
// block: 2 * 2 * 64 * 64 * 64 FLOPs at that shape.
//
// The Pallas grid steps run in order on one TPU core; here the grid's
// blocks run in parallel, one per 64-row tile (blockIdx.x) and 64-column
// tile (blockIdx.y). A block stages 32-deep slices of its a rows and b
// columns in shared memory; each of its 256 threads keeps a 4 x 4 tile
// of f32 sums in registers and adds the k terms in order with fmaf.
//
// Bound: bytes at the probe's shape (0.05 MB moved against 1 MFLOP at
// the CUDA cores' f32 rate); launch latency in practice. Kept simple:
// no tensor cores (f32 parity) and no pipelining.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TM = 64;   // output rows a block (the Pallas block)
constexpr int TN = 64;   // output columns a block
constexpr int TK = 32;   // k depth of one shared-memory stage
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    grid_matmul_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int M, int N, int K) {
  __shared__ float as[TM][TK + 1];  // +1: no bank conflict on the column reads
  __shared__ float bs[TK][TN];
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += THREADS) {
      const int r = e / TK, c = e % TK;
      as[r][c] = (row0 + r < M && k0 + c < K)
                     ? a[(int64_t)(row0 + r) * K + k0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      bs[r][c] = (k0 + r < K && col0 + c < N)
                     ? b[(int64_t)(k0 + r) * N + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) out[(int64_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// a [M, K], b [K, N], out [M, N]: contiguous f32 on the device.
extern "C" int grid_matmul_f32(const void* a, const void* b, void* out,
                               int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  grid_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}
