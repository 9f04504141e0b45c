// Similarity scoring tiles of the vector search plane, for Hopper (sm_90a).
//
// Replaces two TPU kernels of dgraph_tpu/ops/pallas_kernels.py:
//   score_dot_pallas  (:123)  float32 queries . corpus^T, the exact and
//                             two-stage tiers of ops/knn.py;
//   score_int8_pallas (:158)  int8 residual codes converted to float32 in
//                             the tile, dotted with float32 queries, the
//                             approximate stage of the quantized IVF tier
//                             (ops/ivf.py).
// Both compute, for a corpus C[n, d] (float32 or int8) and queries Q[b, d]
// (float32),
//
//     out[i, j] = sum_{k < d} Q[i, k] * float(C[j, k])      out: float32[b, n]
//
// accumulated in float32 fused multiply-adds in order k = 0, 1, ..., d - 1.
// No tensor cores and no TF32: the reference computes float32 dots, and
// the plain PyTorch version (torch.matmul with TF32 off) differs from this
// kernel only in summation order.
//
// Bounds on this card. score_dot at the exact tier's shape (b = 256,
// n = 1M, d = 128) does 2bnd = 65.5 GFLOP for 1.5 GB of corpus and output:
// float32 operations bound it (about 1 ms at 67 TFLOP/s outside the tensor
// cores). score_int8 runs once per probed IVF list, over a few thousand
// code rows and the few queries that probe that list: microseconds of
// bytes and operations each, so launches, not the card, set its time.
//
// The design is the simple tiled product, one template for both element
// types:
//   * a block of 256 threads owns a 64 x 64 tile of the output (64 queries
//     by 64 corpus rows), each thread a 4 x 4 register tile;
//   * the depth axis is walked in steps of 16: each step stages a 64 x 16
//     slice of queries and of corpus rows in shared memory, converting int8
//     to float32 as it stores, so the product loop reads float32 only;
//   * every edge is masked (rows past n, queries past b, depth past d
//     load zeros and are not stored), so the caller pads nothing: any n,
//     b and d, where the TPU kernel needed n % 512 == 0.
// The TPU kernel's 512-row tile with the queries resident in VMEM has no
// counterpart: the grid runs over both output axes in parallel, and the
// corpus tile is re-read once per 64 queries (four times at b = 256).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // queries per block tile
constexpr int BN = 64;    // corpus rows per block tile
constexpr int BK = 16;    // depth per shared-memory stage
constexpr int TM = 4;     // queries per thread
constexpr int TN = 4;     // corpus rows per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_kernel(const T* __restrict__ corpus, const float* __restrict__ queries,
             float* __restrict__ out, int64_t n, int64_t b, int64_t d) {
  // +4 keeps rows 16-byte aligned and spreads the staging stores
  __shared__ float qs[BK][BM + 4];
  __shared__ float cs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // corpus-row lane of the register tile
  const int ty = tid / (BN / TN);   // query lane of the register tile
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * BM;
  // staging: each thread loads 4 consecutive depth elements of one row
  const int lr = tid / (BK / 4);
  const int lk = (tid % (BK / 4)) * 4;
  const int64_t qrow = b0 + lr;
  const int64_t crow = n0 + lr;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t k = k0 + lk + e;
      qs[lk + e][lr] = (qrow < b && k < d) ? queries[qrow * d + k] : 0.f;
      cs[lk + e][lr] = (crow < n && k < d)
                           ? static_cast<float>(corpus[crow * d + k])
                           : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = cs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = b0 + ty + i * (BM / TM);
    if (row >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = n0 + tx + j * (BN / TN);
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* corpus, const void* queries, void* out, int64_t n,
           int64_t b, int64_t d, void* stream) {
  if (n <= 0 || b <= 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t gx = (n + BN - 1) / BN;
  const int64_t gy = (b + BM - 1) / BM;
  if (gx > 0x7fffffffLL || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  score_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(corpus), static_cast<const float*>(queries),
      static_cast<float*>(out), n, b, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// corpus: float32 [n, d], queries: float32 [b, d], out: float32 [b, n]; all
// contiguous on the device. Launches on `stream` and returns the CUDA error
// code of the launch (0 on success).
extern "C" int score_dot_launch(const void* corpus, const void* queries,
                                void* out, int64_t n, int64_t b, int64_t d,
                                void* stream) {
  return launch<float>(corpus, queries, out, n, b, d, stream);
}

// codes: int8 [n, d], queries: float32 [b, d], out: float32 [b, n]; as
// score_dot_launch, with each code converted to float32 in the tile.
extern "C" int score_int8_launch(const void* codes, const void* queries,
                                 void* out, int64_t n, int64_t b, int64_t d,
                                 void* stream) {
  return launch<int8_t>(codes, queries, out, n, b, d, stream);
}
