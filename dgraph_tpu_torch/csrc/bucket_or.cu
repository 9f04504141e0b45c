// Gather-OR of one BFS level bucket, for Hopper (sm_90a).
//
// Replaces the TPU kernel bucket_or_pallas
// (dgraph_tpu/ops/pallas_kernels.py:38). For a frontier bitmap
// f uint32[N+1, W] (bit b of word w of row s: query 32*w+b has slot s in
// its frontier) and one in-degree bucket in_nb int32[M, D] of in-neighbour
// slots, it computes
//
//     out[m] = OR_{d < D} f[in_nb[m, d]]                 out: uint32[M, W]
//
// Row N of f is the always-empty dummy slot that padding indices point
// at. The kernel reads it like any other row, so it needs no
// precondition on the indices beyond 0 <= in_nb < rows(f).
//
// Bound: bytes. Each gathered row is W words read for W ORs, far below
// the card's operations-per-byte line, so the least time is the bytes of
// the distinct frontier rows referenced, the index table and the output
// over the memory rate. The design serves that as simply as it can:
//   * threads run along W, so a warp reads consecutive words of one
//     gathered row, 16 bytes a thread (uint4) when W % 4 == 0;
//   * each thread keeps four partial ORs in registers, so four row loads
//     are in flight per thread, and writes its words once;
//   * a block covers a few output rows (up to 256 threads along W and
//     rows), and a row whose degree is longer than `chunk` (a zipf hub
//     with up to millions of in-neighbours) is split across blocks along
//     its degree axis: each block ORs its chunk in registers, then
//     atomicOr's it into the output row, which the caller has zeroed.
// The TPU kernel's index chunking (SMEM_IDX_CAPACITY) and its 128-lane
// rule on W have no counterpart here: a block loads its own indices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned or_words(unsigned a, unsigned b) {
  return a | b;
}

__device__ __forceinline__ uint4 or_words(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

template <typename V>
__device__ __forceinline__ V zero_words();

template <>
__device__ __forceinline__ unsigned zero_words<unsigned>() {
  return 0u;
}

template <>
__device__ __forceinline__ uint4 zero_words<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// zero words are skipped: the output row was zeroed before the launch
__device__ __forceinline__ void atomic_or_words(unsigned* p, unsigned v) {
  if (v) atomicOr(p, v);
}

__device__ __forceinline__ void atomic_or_words(uint4* p, uint4 v) {
  unsigned* q = reinterpret_cast<unsigned*>(p);
  if (v.x) atomicOr(q, v.x);
  if (v.y) atomicOr(q + 1, v.y);
  if (v.z) atomicOr(q + 2, v.z);
  if (v.w) atomicOr(q + 3, v.w);
}

// grid: x over groups of blockDim.y output rows, y over chunks of the
// degree axis. Wv is the row width in units of V.
template <typename V>
__global__ void __launch_bounds__(256)
bucket_or_kernel(const V* __restrict__ f, const int32_t* __restrict__ in_nb,
                 V* __restrict__ out, int64_t M, int64_t D, int64_t Wv,
                 int64_t chunk, int atomic) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                    threadIdx.y;
  if (m >= M) return;
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t d1 = d0 + chunk < D ? d0 + chunk : D;
  const int32_t* __restrict__ idx = in_nb + m * D;
  for (int64_t w = threadIdx.x; w < Wv; w += blockDim.x) {
    V a0 = zero_words<V>(), a1 = zero_words<V>();
    V a2 = zero_words<V>(), a3 = zero_words<V>();
    int64_t d = d0;
    for (; d + 4 <= d1; d += 4) {
      const int64_t r0 = idx[d], r1 = idx[d + 1];
      const int64_t r2 = idx[d + 2], r3 = idx[d + 3];
      a0 = or_words(a0, f[r0 * Wv + w]);
      a1 = or_words(a1, f[r1 * Wv + w]);
      a2 = or_words(a2, f[r2 * Wv + w]);
      a3 = or_words(a3, f[r3 * Wv + w]);
    }
    for (; d < d1; ++d) {
      a0 = or_words(a0, f[static_cast<int64_t>(idx[d]) * Wv + w]);
    }
    const V acc = or_words(or_words(a0, a1), or_words(a2, a3));
    V* dst = out + m * Wv + w;
    if (atomic) {
      atomic_or_words(dst, acc);
    } else {
      *dst = acc;
    }
  }
}

template <typename V>
cudaError_t launch(const void* f, const void* in_nb, void* out, int64_t M,
                   int64_t D, int64_t Wv, int64_t chunk,
                   cudaStream_t stream) {
  const int64_t lanes = (Wv + 31) / 32 * 32;
  const int bx = static_cast<int>(lanes < 256 ? lanes : 256);
  const int by = 256 / bx > 0 ? 256 / bx : 1;
  const int64_t gx = (M + by - 1) / by;
  const int64_t gy = (D + chunk - 1) / chunk;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(bx, by);
  bucket_or_kernel<V><<<grid, block, 0, stream>>>(
      static_cast<const V*>(f), static_cast<const int32_t*>(in_nb),
      static_cast<V*>(out), M, D, Wv, chunk, gy > 1 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// f: [rows, W] words, in_nb: [M, D] int32 row indices into f, out: [M, W]
// words; all contiguous on the device. When D > chunk the output must be
// zeroed before the call. Launches on `stream` and returns the CUDA error
// code of the launch (0 on success).
extern "C" int bucket_or_launch(const void* f, const void* in_nb, void* out,
                                int64_t M, int64_t D, int64_t W,
                                int64_t chunk, void* stream) {
  if (M <= 0 || D <= 0 || W <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err =
      vec ? launch<uint4>(f, in_nb, out, M, D, W / 4, chunk, s)
          : launch<unsigned>(f, in_nb, out, M, D, W, chunk, s);
  return static_cast<int>(err);
}
