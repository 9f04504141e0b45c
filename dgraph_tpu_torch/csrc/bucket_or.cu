// Gather-OR of one BFS level bucket, for Hopper (sm_90a), in two kernels:
// bucket_or_kernel (below) and the fused level step bucket_or_level_kernel
// (further down), which the BFS digest runs.
//
// bucket_or_kernel replaces the TPU kernel bucket_or_pallas
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


// ---------------------------------------------------------------------------
// bucket_or_level_kernel: one bucket of one BFS level, fused with the
// digest's epilogue. It also replaces bucket_or_pallas (the gather-OR), on
// the digest's path, together with the elementwise passes that followed it
// there. For each output row m of a bucket in_nb int32[M, D]:
//
//     reach      = OR_d f[in_nb[m, d]]
//     frontier   = reach & ~vis_in[m]
//     vis_out[m] = vis_in[m] | frontier
//     total     += popcount(frontier)
//     out_mask[m] bit s set iff segment s of frontier[m] is non-zero
//
// Occupancy masks. A row of W words is cut into segments of SEG = 32 * K
// words, K = ceil(W / 1024), so at most 32 segments and one int32 mask a
// row. Every frontier carries its masks (fmask), exact: a segment's bit is
// set iff the segment is non-zero. The dummy row's mask is 0.
//
// Bound: bytes. A BFS frontier is sparse (about 1.6% of the 128-byte
// segments of the 21M-edge graph's core rows are non-zero at any level),
// so the least bytes are the index table, the masks of the rows it
// references, the non-zero segments of those rows once each, the frontier
// written in full and the visited segments where the frontier is set. The
// gather's work is (in-neighbour, set segment) pairs, and it is skewed: a
// hub row's in-neighbours are sorted by row, and the last rows, the
// graph's own hubs, are in nearly every segment of a deep frontier, so a
// few hundred of a row's in-neighbours hold most of its pairs. The design:
//   * a warp gathers a chunk of kChunk in-neighbours of one output row, as
//     kBatches batches of 32: every lane loads its kBatches indices, then
//     their masks, at once (two round trips a chunk, not two a batch). A
//     row longer than kChunk is cut into nchunks chunks, chunk c taking
//     every nchunks-th group of 4 in-neighbours (16 bytes of indices)
//     from group c on, so a row's dense run spreads a group to a warp
//     over all its warps instead of landing on one (groups of 4 beat 1,
//     which reads a 32-byte sector an index, and 8, which leaves 192
//     pairs to a warp, on the 21M graph's three levels);
//   * the warp lists its (row, segment) pairs in shared memory (a warp
//     scan of the lanes' counts gives each lane its place) and walks the
//     list kInFlight 128-byte segment loads at a time, ORing each into the
//     warp's accumulator in shared memory (lane l owns the words
//     congruent to l mod 32, so no lane waits on another);
//   * the epilogue walks the row's segments eight words a lane at a time
//     (G segments), every load of a step issued before any is used: the
//     and-not, the visited update, __popc into a per-thread count and a
//     warp vote for the out mask. Visited is read, and written back, only
//     where the reach is non-zero; the frontier is written in full, zeros
//     included, so no later reader sees stale words; a row with no reach
//     (and at level 1 no seeds) writes zeros in 16-byte stores and reads
//     nothing;
//   * a bucket of degree 1, a level's largest (365K-483K rows at the 21M
//     graph), takes 32 rows a warp: their indices, masks and output rows
//     load at once, and each row's reach is its in-neighbour's row, read
//     on its set segments straight into the epilogue;
//   * level-1 mode (seeds != null): vis_in is the seed bitmap's own rows,
//     read only on its set segments (seeds_mask), and visited is written in
//     full; the outputs land in core row rows[m], which takes the boundary
//     permutation out of the digest;
//   * a row longer than kChunk is cut across warps (mode kSplit): each
//     chunk ORs into a zeroed scratch row with atomicOr reductions whose
//     old value is unused (so no warp waits on them), then takes a ticket
//     of the row after a __threadfence; the row's last chunk, ticket
//     nchunks - 1, runs the epilogue over the scratch row, so a split
//     bucket is one launch like any other;
//   * a block's counts meet in one 64-bit atomicAdd, and the grid is as
//     many blocks as the card holds at once, its warps striding over the
//     units (a row, or a chunk of one).
// Masks and the non-zero segments of a level (a few tens of MB at the 21M
// graph) stay in the 50 MB L2 while each is read about out-degree times.

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;           // warps a block
constexpr int kMaxK = 8;            // widest segment: 256 words (W <= 8192)
constexpr int kBatches = 8;         // 32-index batches of a warp's chunk
constexpr int64_t kChunk = 32 * kBatches;
constexpr int kListCap = 1024;      // >= 32 lanes x 32 segments: one batch
constexpr int kInFlight = 16;       // 128-byte loads a warp keeps in flight
constexpr int64_t kMaxRows = int64_t(1) << 27;  // a pair is row << 5 | seg
constexpr int64_t kSmemBytes = 200 * 1024;      // a block's shared memory

enum LevelMode { kFused = 0, kSplit = 1 };

struct LevelArgs {
  const unsigned* f;                // gather source rows [*, W]
  const unsigned* fmask;            // their masks, one word a row
  const int32_t* in_nb;             // [M, D]
  const unsigned* seeds;            // level-1 mode: vis_in rows [M, W]
  const unsigned* seeds_mask;       // and their masks [M]
  const int32_t* rows;              // output row of each m, or null
  unsigned* front;                  // frontier rows out
  unsigned* vis;                    // visited rows, in place or in full
  unsigned* omask;                  // frontier masks out
  unsigned* scratch;                // [M, W] reach of split rows
  unsigned* tickets;                // [M] chunks of a split row done
  unsigned long long* total;        // the level's popcount
  int64_t M, D, W, nchunks;
  int nseg, mode;
};

// exclusive prefix sum of x over the warp's lanes; *total gets the sum
__device__ __forceinline__ unsigned warp_exclusive_scan(unsigned x, int lane,
                                                        unsigned* total) {
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  *total = __shfl_sync(kFull, inc, 31);
  return inc - x;
}

// list row r's segments whose bits are set in rem, from list[pos] on
__device__ __forceinline__ void list_pairs(unsigned* list, unsigned pos,
                                           int r, unsigned rem) {
  while (rem) {
    list[pos++] = static_cast<unsigned>(r) << 5 | (__ffs(rem) - 1);
    rem &= rem - 1u;
  }
}

// OR the n listed segments of f into the warp's accumulator, kInFlight
// loads at a time: piece i is word column 32 * (i % K) + lane of pair
// i / K, so each load is one coalesced 128-byte line
template <int K>
__device__ __forceinline__ void gather_listed(const unsigned* __restrict__ f,
                                              const unsigned* list,
                                              unsigned n, int64_t W,
                                              unsigned* acc, int lane) {
  const unsigned pieces = n * K;
  for (unsigned i0 = 0; i0 < pieces; i0 += kInFlight) {
    unsigned v[kInFlight];
    int w[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const unsigned i = i0 + u;
      v[u] = 0u;
      w[u] = 0;
      if (i < pieces) {
        const unsigned code = list[i / K];
        w[u] = static_cast<int>((code & 31u) * 32 * K + 32 * (i % K)) + lane;
        if (w[u] < W)
          v[u] = __ldg(f + static_cast<int64_t>(code >> 5) * W + w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (v[u]) acc[w[u]] |= v[u];
    }
  }
}

// gather chunk c of output row m into acc; returns the OR of the masks of
// the chunk's in-neighbours (warp-uniform). The chunk is groups c,
// c + nchunks, ... of 4 in-neighbours (16 bytes of indices), eight groups
// a batch
template <int K>
__device__ __forceinline__ unsigned gather_chunk(const LevelArgs& a,
                                                 int64_t m, int64_t c,
                                                 unsigned* acc,
                                                 unsigned* list, int lane) {
  const int32_t* __restrict__ idx = a.in_nb + m * a.D;
  int r[kBatches];
  unsigned rem[kBatches];
#pragma unroll
  for (int t = 0; t < kBatches; ++t) {
    const int64_t d = ((t * 8 + (lane >> 2)) * a.nchunks + c) * 4 + (lane & 3);
    r[t] = d < a.D ? __ldg(idx + d) : -1;
  }
  unsigned any = 0, cnt = 0;
#pragma unroll
  for (int t = 0; t < kBatches; ++t) {
    rem[t] = r[t] >= 0 ? __ldg(a.fmask + r[t]) : 0u;
    any |= rem[t];
    cnt += __popc(rem[t]);
  }
  unsigned n;
  unsigned pos = warp_exclusive_scan(cnt, lane, &n);
  if (n <= kListCap) {              // the usual case: one list, one walk
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      list_pairs(list, pos, r[t], rem[t]);
      pos += __popc(rem[t]);
    }
    __syncwarp();
    gather_listed<K>(a.f, list, n, a.W, acc, lane);
    __syncwarp();
  } else {                          // a dense chunk: a list a batch
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      pos = warp_exclusive_scan(__popc(rem[t]), lane, &n);
      list_pairs(list, pos, r[t], rem[t]);
      __syncwarp();
      gather_listed<K>(a.f, list, n, a.W, acc, lane);
      __syncwarp();
    }
  }
  return __reduce_or_sync(kFull, any);
}

// a row of W zero words, in 16-byte stores where it is aligned
__device__ __forceinline__ void zero_row(unsigned* p, int64_t W, int lane) {
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
    for (int64_t i = lane; i < W / 4; i += 32) q[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (int64_t i = lane; i < W; i += 32) p[i] = 0u;
  }
}

// where a row's reach is read from in its epilogue
enum ReachFrom {
  kFromAcc = 0,      // the warp's accumulator (zeroed as it is read)
  kFromScratch = 1,  // a split row's scratch row, from L2
  kFromRow = 2,      // the one in-neighbour's row of f (degree 1)
};

// the epilogue of output row m (written at row orow): the and-not, the
// visited update, the popcount into count and the out mask. `any` holds
// the segments where the reach may be non-zero, smask the seed row's
// segments (level-1 mode)
template <int K>
__device__ __forceinline__ void finish_row(const LevelArgs& a, int64_t m,
                                           int64_t orow, unsigned any,
                                           unsigned smask, int from,
                                           const unsigned* rrow,
                                           unsigned* acc,
                                           unsigned long long& count,
                                           int lane) {
  constexpr int64_t SEG = 32 * K;
  constexpr int G = K >= 8 ? 1 : 8 / K;   // segments a step
  const int64_t W = a.W;
  unsigned* const frow = a.front + orow * W;
  unsigned* const vrow = a.vis + orow * W;
  if (any == 0u && (!a.seeds || smask == 0u)) {
    // no reach: no new bits; visited kept in place, or all zero at level 1
    zero_row(frow, W, lane);
    if (a.seeds) zero_row(vrow, W, lane);
    if (lane == 0) a.omask[orow] = 0u;
    return;
  }
  const unsigned* const srow = a.seeds ? a.seeds + m * W : nullptr;
  unsigned om = 0;
  // G segments at a time, each step's loads all issued before any is
  // used, so a row costs a few round trips to memory, not one a segment
#pragma unroll 1
  for (int s0 = 0; s0 < a.nseg; s0 += G) {
    unsigned r[G][K], v[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = s0 + g;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t w = s * SEG + 32 * k + lane;
        r[g][k] = 0u;
        if (s >= a.nseg || w >= W) continue;
        if (from == kFromScratch) {
          r[g][k] = __ldcg(rrow + w);     // from L2, where the atomics are
        } else if ((any >> s) & 1u) {
          if (from == kFromAcc) {
            r[g][k] = acc[w];
            acc[w] = 0u;
          } else {
            r[g][k] = __ldg(rrow + w);
          }
        }
      }
    }
    // the row before the level: the seeds where their mask is set, or
    // visited where the reach is non-zero
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = s0 + g;
      bool need;
      if (a.seeds) {
        need = s < a.nseg && ((smask >> s) & 1u);
      } else {
        bool rnz = false;
#pragma unroll
        for (int k = 0; k < K; ++k) rnz |= r[g][k] != 0u;
        need = __any_sync(kFull, rnz);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t w = s * SEG + 32 * k + lane;
        v[g][k] = need && w < W ? (a.seeds ? srow[w] : vrow[w]) : 0u;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = s0 + g;
      if (s >= a.nseg) break;
      bool fnz = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t w = s * SEG + 32 * k + lane;
        if (w >= W) continue;
        const unsigned fr = r[g][k] & ~v[g][k];
        frow[w] = fr;
        // level 1 writes visited in full; deeper, only new bits
        if (a.seeds || fr) vrow[w] = v[g][k] | fr;
        count += __popc(fr);
        fnz |= fr != 0u;
      }
      if (__any_sync(kFull, fnz)) om |= 1u << s;
    }
  }
  if (lane == 0) a.omask[orow] = om;
}

// at most 80 registers a thread, so three blocks of 8 warps fit an SM
template <int K>
__global__ void __launch_bounds__(kWarps * 32, 3)
bucket_or_level_kernel(const LevelArgs a) {
  constexpr int64_t SEG = 32 * K;
  // each warp's reach accumulator (nseg * SEG words, zero between units)
  // and its pair list (kListCap words)
  extern __shared__ unsigned smem[];
  const int64_t span = static_cast<int64_t>(a.nseg) * SEG;
  unsigned* const acc = smem + (threadIdx.x >> 5) * (span + kListCap);
  unsigned* const list = acc + span;
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t W = a.W;
  unsigned long long count = 0;
  for (int64_t w = lane; w < span; w += 32) acc[w] = 0u;
  if (a.mode == kFused && a.D == 1) {
    // degree 1 (a level's largest bucket): 32 rows a warp, their indices,
    // masks and output rows loaded at once, each row's reach read straight
    // from its one in-neighbour's row
    const int64_t groups = (a.M + 31) / 32;
    for (int64_t gi = first; gi < groups; gi += stride) {
      const int64_t m = gi * 32 + lane;
      int r = 0;
      unsigned rm = 0u, sm = 0u;
      long long o = m;
      if (m < a.M) {
        r = __ldg(a.in_nb + m);
        rm = __ldg(a.fmask + r);
        if (a.seeds) sm = a.seeds_mask[m];
        if (a.rows) o = a.rows[m];
      }
      const int n = a.M - gi * 32 < 32 ? static_cast<int>(a.M - gi * 32) : 32;
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const int64_t rj = __shfl_sync(kFull, r, j);
        finish_row<K>(a, gi * 32 + j, __shfl_sync(kFull, o, j),
                      __shfl_sync(kFull, rm, j), __shfl_sync(kFull, sm, j),
                      kFromRow, a.f + rj * W, acc, count, lane);
      }
    }
  } else {
    const int64_t units = a.M * a.nchunks;
    for (int64_t u = first; u < units; u += stride) {
      const int64_t m = u / a.nchunks;
      // the reach's segments, at most
      const unsigned any =
          gather_chunk<K>(a, m, u - m * a.nchunks, acc, list, lane);
      if (a.mode == kSplit) {
        // OR the chunk into the row's scratch: bits only ever get set, and
        // an atomic whose old value is unused is a fire-and-forget
        // reduction
        unsigned* dst = a.scratch + m * W;
        for (int s = 0; s < a.nseg; ++s) {
          if (!((any >> s) & 1u)) continue;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int64_t w = s * SEG + 32 * k + lane;
            if (w >= W) continue;
            const unsigned v = acc[w];
            acc[w] = 0u;
            if (v) atomicOr(dst + w, v);
          }
        }
        // the row's last chunk to finish runs its epilogue: each lane's
        // reductions are ordered before the ticket, and the other chunks'
        // before the last one's reads of the scratch
        __threadfence();
        __syncwarp();
        unsigned ticket = 0;
        if (lane == 0) ticket = atomicAdd(a.tickets + m, 1u);
        ticket = __shfl_sync(kFull, ticket, 0);
        if (ticket != a.nchunks - 1) continue;
        __threadfence();
      }
      const int64_t orow = a.rows ? static_cast<int64_t>(a.rows[m]) : m;
      const unsigned smask = a.seeds ? a.seeds_mask[m] : 0u;
      if (a.mode == kSplit) {
        finish_row<K>(a, m, orow, kFull, smask, kFromScratch,
                      a.scratch + m * W, acc, count, lane);
      } else {
        finish_row<K>(a, m, orow, any, smask, kFromAcc, nullptr, acc, count,
                      lane);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(kFull, count, o);
  __shared__ unsigned long long part[kWarps];
  if (lane == 0) part[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += part[w];
    if (t) atomicAdd(a.total, t);
  }
}

template <int K>
cudaError_t launch_level(const LevelArgs& a, cudaStream_t stream) {
  // a warp's accumulator and pair list take (nseg * 32K + kListCap) words
  // of shared memory: fewer warps a block when the rows are wide
  const int64_t warp_bytes =
      (static_cast<int64_t>(a.nseg) * 32 * K + kListCap) * 4;
  int warps = static_cast<int>(kSmemBytes / warp_bytes);
  if (warps > kWarps) warps = kWarps;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(warps * warp_bytes);
  // the card's resident blocks of this kernel at this shared memory, asked
  // once per (device, shared memory): the digest launches it ~190 times a
  // batch with the same width
  static int seen_dev = -1, seen_smem = -1, seen_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != seen_dev || smem != seen_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(bucket_or_level_kernel<K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bucket_or_level_kernel<K>, warps * 32,
          static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    seen_dev = dev;
    seen_smem = smem;
    seen_blocks = sms * per_sm;
  }
  const int64_t units = a.M * a.nchunks;
  int64_t blocks = (units + warps - 1) / warps;
  if (blocks > seen_blocks) blocks = seen_blocks;  // warps stride the units
  bucket_or_level_kernel<K><<<static_cast<unsigned>(blocks), warps * 32,
                              static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One bucket of a BFS level, fused with its epilogue (see above). f: [R, W]
// words, R <= 2^27, and fmask their masks; in_nb: [M, D] int32 row indices
// into f; seeds/seeds_mask: level-1 mode's visited rows [M, W] and masks
// [M], or both null (visited then updated in place); rows: [M] output
// rows, or null (row m); front, vis: output rows [*, W]; omask: [*]
// output masks; total: one uint64; scratch: M * W + M zero words (the
// split rows' reach, then their tickets), for mode 1 only. chunk must be
// kChunk (256). mode: 0 a warp a row (D <= chunk), 1 rows split into
// chunks of `chunk` in-neighbours (D > 0). All contiguous on the device.
// Launches on `stream` and returns the CUDA error code of the launch.
extern "C" int bucket_or_level_launch(
    const void* f, const void* fmask, const void* in_nb, const void* seeds,
    const void* seeds_mask, const void* rows, void* front, void* vis,
    void* omask, void* scratch, void* total, int64_t R, int64_t M,
    int64_t D, int64_t W, int64_t chunk, int mode, void* stream) {
  const int64_t K = (W + 1023) / 1024;
  if (M <= 0 || D < 0 || W <= 0 || K > kMaxK || R <= 0 || R > kMaxRows ||
      chunk != kChunk || (mode != kFused && mode != kSplit) ||
      (mode == kFused && D > kChunk) ||
      (mode == kSplit && (D <= 0 || !scratch)) ||
      (!seeds) != (!seeds_mask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelArgs a;
  a.f = static_cast<const unsigned*>(f);
  a.fmask = static_cast<const unsigned*>(fmask);
  a.in_nb = static_cast<const int32_t*>(in_nb);
  a.seeds = static_cast<const unsigned*>(seeds);
  a.seeds_mask = static_cast<const unsigned*>(seeds_mask);
  a.rows = static_cast<const int32_t*>(rows);
  a.front = static_cast<unsigned*>(front);
  a.vis = static_cast<unsigned*>(vis);
  a.omask = static_cast<unsigned*>(omask);
  a.scratch = static_cast<unsigned*>(scratch);
  a.tickets = scratch ? a.scratch + M * W : nullptr;
  a.total = static_cast<unsigned long long*>(total);
  a.M = M;
  a.D = D;
  a.W = W;
  a.nchunks = mode == kSplit ? (D + chunk - 1) / chunk : 1;
  a.nseg = static_cast<int>((W + 32 * K - 1) / (32 * K));
  a.mode = mode;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K) {
    case 1: err = launch_level<1>(a, s); break;
    case 2: err = launch_level<2>(a, s); break;
    case 3: err = launch_level<3>(a, s); break;
    case 4: err = launch_level<4>(a, s); break;
    case 5: err = launch_level<5>(a, s); break;
    case 6: err = launch_level<6>(a, s); break;
    case 7: err = launch_level<7>(a, s); break;
    default: err = launch_level<8>(a, s); break;
  }
  return static_cast<int>(err);
}
