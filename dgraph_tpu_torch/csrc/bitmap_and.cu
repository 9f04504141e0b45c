// k-way AND of stacked bitmap word matrices, for Hopper (sm_90a).
//
// Replaces bitmap_and_pallas (dgraph_tpu/ops/pallas_kernels.py:217), the
// word-AND of the compressed intersection's all-bitmap blocks
// (ops/setops.intersect_packs -> bitmap_and_device). For k stacked word
// matrices in[k, n] (n = B blocks x 1024 uint64 words, viewed as int64 with
// the same bits),
//
//     out[w] = in[0, w] & in[1, w] & ... & in[k - 1, w]       out: [n]
//
// The TPU kernel ANDs two uint32[B, 2048] matrices (the uint64 words split
// into two 32-bit lanes), one (8, 2048) tile a grid step, and the reference
// folds k matrices with k - 1 such calls. Here one launch ANDs all k over
// 64-bit words: each input word is read once and each output word written
// once, where the fold reads and writes the running result k - 1 times.
//
// Bound on this card: bytes. A word costs k loads, k - 1 ANDs and one store:
// (k + 1) * 8 bytes of memory traffic against k - 1 integer operations, far
// below the card's operations-per-byte balance. At the main path's shape
// (k = 4, B = 1,024 blocks) that is 40 MiB, about 12.5 us at 3.35 TB/s.
//
// The design is the simple one: a grid-stride loop over the n words, each
// thread taking a 16-byte pair of words at a time (one 128-bit load per
// operand), ANDing down the k operands in registers. A word count that is
// odd, or a pointer not 16-byte aligned, takes the same loop one word at a
// time. The TPU's 8-row tile, its 128-lane rule and the padding of B to a
// multiple of 8 have no counterpart: the loop masks its own tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// enough blocks to fill the card several times over; larger inputs loop
constexpr int64_t MAX_BLOCKS = 132 * 64;

__global__ void __launch_bounds__(THREADS)
bitmap_and_pairs(const ulonglong2* __restrict__ in, ulonglong2* __restrict__ out,
                 int64_t k, int64_t pairs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < pairs; i += stride) {
    ulonglong2 acc = in[i];
    for (int64_t j = 1; j < k; ++j) {
      const ulonglong2 v = in[j * pairs + i];
      acc.x &= v.x;
      acc.y &= v.y;
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
bitmap_and_words(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                 int64_t k, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint64_t acc = in[i];
    for (int64_t j = 1; j < k; ++j) acc &= in[j * n + i];
    out[i] = acc;
  }
}

int64_t grid_for(int64_t items) {
  const int64_t blocks = (items + THREADS - 1) / THREADS;
  return blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS;
}

}  // namespace

// in: [k, n] 64-bit words, out: [n] words; both contiguous on the device.
// Launches on `stream` and returns the CUDA error code of the launch (0 on
// success).
extern "C" int bitmap_and_launch(const void* in, void* out, int64_t k,
                                 int64_t n, void* stream) {
  if (k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && n % 2 == 0) {
    const int64_t pairs = n / 2;
    bitmap_and_pairs<<<static_cast<unsigned>(grid_for(pairs)), THREADS, 0,
                       s>>>(static_cast<const ulonglong2*>(in),
                            static_cast<ulonglong2*>(out), k, pairs);
  } else {
    bitmap_and_words<<<static_cast<unsigned>(grid_for(n)), THREADS, 0, s>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
