// Gather-OR of one BFS level bucket, for Hopper (sm_90a), in two kernels:
// bucket_or_kernel (below), which the per-level reach path runs, and the
// fused level step bucket_or_level_kernel (further down), which the BFS
// digest runs.
//
// bucket_or_kernel replaces the TPU kernel bucket_or_pallas
// (dgraph_tpu/ops/pallas_kernels.py:38). For a frontier bitmap
// f uint32[rows, W] (bit b of word w of row s: query 32*w+b has slot s in
// its frontier) and one in-degree bucket in_nb int32[M, D] of in-neighbour
// rows, it computes
//
//     out[m] = OR_{d < D} f[in_nb[m, d]]                 out: uint32[M, W]
//
// Padding indices point at an always-empty dummy row, which the kernel
// reads like any other, so it needs no precondition on the indices beyond
// 0 <= in_nb < rows.
//
// Bound: bytes. A gathered row is W words read for W ORs, far below the
// card's operations-per-byte line, so the least time is the distinct rows
// the call references, its index table and its output over the memory
// rate: the whole-row bound. On the 21M-edge zipf graph a bucket's
// gathers are 93% distinct rows (sources are uniform, and a row's
// in-neighbours are distinct), so one call's bound is nearly its
// gathered bytes: summed over a level's calls at W = 768, 14.03 ms at
// level 1 and 4.11 deeper, against 2.35 and 0.99 for the level's own
// bound, which counts a row once over all of its ~40 buckets, a reuse
// that one launch a bucket cannot reach. The first design (a block a row,
// 32 lanes along W, an atomic OR into a zeroed row for a split one) moved
// the gathered bytes at 2.9 TB/s at W = 768 and left 30 of 32 lanes idle
// at W = 2 (1.21 ms a level of the reach path, a 0.03 ms bound). The
// design:
//   * the bucket is cut into units, walked by a persistent grid (as many
//     blocks as the card holds at once, their warps striding over the
//     units), so no launch shape limits a hub row's split;
//   * a unit stages its in-neighbour indices, one contiguous run of at
//     most kSpan, in shared memory with one coalesced load a lane, marked
//     evict-first (__ldcs): no lane reloads them from memory;
//   * a group of L lanes (a power of two up to 32) covers a tile of L
//     vectors of a row, 16 bytes a lane (uint4) where W % 4 == 0 and f
//     and out are 16-byte aligned, else 8 (uint2) or 4. A warp holds
//     32 / L groups, so a narrow row (W = 2 at 48 queries: one uint2)
//     puts 32 groups in a warp and no lane idles. A wider row is several
//     tiles, each its own unit, tile-minor, so a row's tiles are gathered
//     side by side by neighbouring warps;
//   * degree <= kRowMaxD (row units): a unit is up to 32 whole rows, each
//     group taking rows in turn, walking its (row, in-neighbour) pairs
//     kSlots loads at a time, so a degree-1 row copy keeps kSlots rows in
//     flight; a small bucket takes fewer rows a unit, so it still has
//     units for the whole card;
//   * larger degree (chunk units): a unit is up to kSpan in-neighbours of
//     one row, group g taking in-neighbours g, g + 32/L, ..., kSlots
//     loads in flight a lane; the groups then meet in an OR across lanes
//     (shuffles);
//   * a row past kSpan in-neighbours (a zipf hub, up to 2M) is cut into
//     chunks, each a unit: a chunk ORs its non-zero words into the row's
//     scratch with reductions whose old value is unused (no warp waits on
//     them), then takes a ticket of the row's tile; the tile's last chunk
//     copies the scratch into out and zeroes the scratch and the ticket.
//     So out is written once, with no atomics on it, a split bucket is
//     one launch, and the scratch, zeroed once a stream, needs no fill
//     before a launch;
//   * out is written with streaming stores (__stcs).
// L2 slabs (the word axis cut so that a slab of every source row stays in
// L2 while a bucket gathers it) were measured and dropped: they can buy
// only the 7% of reuse a bucket has, and at the core levels 32- and
// 64-byte slabs took 12.9 and 8.8 ms against 6.1 for whole rows (NVIDIA
// H100 80GB HBM3, 700.00 W). The plan (vector width, lanes, tiles, units)
// is made on the host (ops/kernels.py, bucket_or_plan), which the CPU
// tests hold to cover every (row, in-neighbour, word) once; the launcher
// checks it. The TPU kernel's index chunking (SMEM_IDX_CAPACITY) and its
// 128-lane rule on W have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kOrFull = 0xffffffffu;
constexpr int kOrWarps = 8;       // warps a block
constexpr int kSpan = 256;        // indices a unit stages
constexpr int kRowMaxD = 16;      // degrees taken as whole-row units
constexpr int kSlots = 12;        // vector loads a lane keeps in flight

__device__ __forceinline__ unsigned or_words(unsigned a, unsigned b) {
  return a | b;
}
__device__ __forceinline__ uint2 or_words(uint2 a, uint2 b) {
  return make_uint2(a.x | b.x, a.y | b.y);
}
__device__ __forceinline__ uint4 or_words(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

template <typename V>
__device__ __forceinline__ V zero_words();
template <>
__device__ __forceinline__ unsigned zero_words<unsigned>() { return 0u; }
template <>
__device__ __forceinline__ uint2 zero_words<uint2>() {
  return make_uint2(0u, 0u);
}
template <>
__device__ __forceinline__ uint4 zero_words<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ unsigned shfl_xor_words(unsigned v, int o) {
  return __shfl_xor_sync(kOrFull, v, o);
}
__device__ __forceinline__ uint2 shfl_xor_words(uint2 v, int o) {
  return make_uint2(__shfl_xor_sync(kOrFull, v.x, o),
                    __shfl_xor_sync(kOrFull, v.y, o));
}
__device__ __forceinline__ uint4 shfl_xor_words(uint4 v, int o) {
  return make_uint4(__shfl_xor_sync(kOrFull, v.x, o),
                    __shfl_xor_sync(kOrFull, v.y, o),
                    __shfl_xor_sync(kOrFull, v.z, o),
                    __shfl_xor_sync(kOrFull, v.w, o));
}

// OR v into *p with reductions whose old value is unused; zero words skip
__device__ __forceinline__ void red_or_words(unsigned* p, unsigned v) {
  if (v) atomicOr(p, v);
}
__device__ __forceinline__ void red_or_words(uint2* p, uint2 v) {
  unsigned* q = reinterpret_cast<unsigned*>(p);
  red_or_words(q, v.x);
  red_or_words(q + 1, v.y);
}
__device__ __forceinline__ void red_or_words(uint4* p, uint4 v) {
  unsigned* q = reinterpret_cast<unsigned*>(p);
  red_or_words(q, v.x);
  red_or_words(q + 1, v.y);
  red_or_words(q + 2, v.z);
  red_or_words(q + 3, v.w);
}

struct OrArgs {
  const void* f;               // [rows, Wv] vector words
  const int32_t* in_nb;        // [M, D]
  void* out;                   // [M, Wv]
  void* scratch;               // split rows: [M, Wv] zero, then tickets,
                               // left zero by the kernel
  unsigned* tickets;           // [M, ntiles] zero
  int64_t M, D, Wv;            // Wv: row width in vector words
  int lanes;                   // L: lanes a group, vectors a tile
  int64_t ntiles;              // tiles of L vectors a row
  int64_t rows_unit;           // row units: rows a unit; chunk units: 0
  int64_t chunk, nchunks;      // chunk units: in-neighbours a unit
  int64_t units;               // base units x ntiles
};

// OR the gathered rows sidx[p0 + i * step], i < count, on vector w of
// each into acc, kSlots loads in flight
template <typename V>
__device__ __forceinline__ V gather_or(const V* __restrict__ f,
                                       const int* sidx, int p0, int step,
                                       int count, int64_t Wv, int64_t w) {
  V acc = zero_words<V>();
  if (w >= Wv) return acc;
  for (int i = 0; i < count; i += kSlots) {
    V v[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      v[u] = i + u < count
                 ? __ldg(f + static_cast<int64_t>(sidx[p0 + (i + u) * step]) *
                                 Wv + w)
                 : zero_words<V>();
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) acc = or_words(acc, v[u]);
  }
  return acc;
}

// a unit of whole rows on vector w: group g takes rows g, g + G, ... and
// walks its (row, in-neighbour) pairs kSlots at a time, so a degree-1
// row copy keeps kSlots rows in flight; a row is written when its last
// in-neighbour is in
template <typename V>
__device__ __forceinline__ void rows_or(const OrArgs& a, const int* sidx,
                                        int64_t m0, int rows, int g,
                                        int64_t w) {
  const int G = 32 / a.lanes;
  if (w >= a.Wv || g >= rows) return;
  const V* __restrict__ f = static_cast<const V*>(a.f);
  V* const out = static_cast<V*>(a.out);
  const int D = static_cast<int>(a.D);
  const int64_t Wv = a.Wv;
  const int pairs = (rows - g + G - 1) / G * D;
  int q = g, d = 0;                    // the next pair to OR in
  V acc = zero_words<V>();
  for (int s = 0; s < pairs; s += kSlots) {
    V v[kSlots];
    int lq = q, ld = d;                // the loads' own cursor
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      v[u] = s + u < pairs
                 ? __ldg(f + static_cast<int64_t>(sidx[lq * D + ld]) * Wv + w)
                 : zero_words<V>();
      if (++ld == D) {
        ld = 0;
        lq += G;
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (s + u >= pairs) break;
      acc = or_words(acc, v[u]);
      if (++d == D) {
        __stcs(out + (m0 + q) * Wv + w, acc);
        acc = zero_words<V>();
        d = 0;
        q += G;
      }
    }
  }
}

// at most 85 registers a thread, so three blocks of 8 warps fit an SM
template <typename V>
__global__ void __launch_bounds__(kOrWarps * 32, 3)
bucket_or_kernel(const OrArgs a) {
  const int L = a.lanes, G = 32 / L;   // lanes a group, groups a warp
  __shared__ int staged[kOrWarps][kSpan];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* const sidx = staged[warp];
  const int g = lane / L, j = lane % L;
  const V* __restrict__ f = static_cast<const V*>(a.f);
  V* const out = static_cast<V*>(a.out);
  const int64_t Wv = a.Wv, D = a.D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kOrWarps;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kOrWarps + warp;
       u < a.units; u += stride) {
    // tile-minor: the warps of a row's tiles run side by side, sharing
    // the index run through L2 and reading each gathered row at once
    const int64_t base = u / a.ntiles, t = u - base * a.ntiles;
    const int64_t w = t * L + j;       // this lane's vector of each row
    int64_t m0, d0 = 0;
    int rows = 1, n;
    if (a.rows_unit) {
      m0 = base * a.rows_unit;
      rows = static_cast<int>(a.M - m0 < a.rows_unit ? a.M - m0
                                                     : a.rows_unit);
      n = rows * static_cast<int>(D);
    } else {
      m0 = base / a.nchunks;
      d0 = (base - m0 * a.nchunks) * a.chunk;
      n = static_cast<int>(D - d0 < a.chunk ? D - d0 : a.chunk);
    }
    // the unit's indices: one contiguous run of in_nb, every load issued
    // before a store
    const int32_t* src = a.in_nb + m0 * D + d0;
    int r[kSpan / 32];
#pragma unroll
    for (int k = 0; k < kSpan / 32; ++k)
      r[k] = lane + 32 * k < n ? __ldcs(src + lane + 32 * k) : 0;
    __syncwarp();                      // the last unit's reads are done
#pragma unroll
    for (int k = 0; k < kSpan / 32; ++k)
      if (lane + 32 * k < n) sidx[lane + 32 * k] = r[k];
    __syncwarp();
    if (a.rows_unit) {
      rows_or<V>(a, sidx, m0, rows, g, w);
      continue;
    }
    // a chunk of one row: group g ORs in-neighbours g, g + G, ..., and
    // the groups meet in an OR across lanes
    V acc = gather_or<V>(f, sidx, g, G, g < n ? (n - g + G - 1) / G : 0,
                         Wv, w);
    for (int o = L; o < 32; o <<= 1)
      acc = or_words(acc, shfl_xor_words(acc, o));
    if (a.nchunks == 1) {
      if (g == 0 && w < Wv) __stcs(out + m0 * Wv + w, acc);
      continue;
    }
    // a split row: OR into its scratch, then take a ticket of its tile;
    // the tile's last chunk copies the scratch into out and zeroes the
    // scratch and the ticket for the next call. Each lane's reductions
    // are ordered before its ticket, and the other chunks' before the
    // last one's reads of the scratch
    V* const srow = static_cast<V*>(a.scratch) + m0 * Wv;
    if (g == 0 && w < Wv) red_or_words(srow + w, acc);
    __threadfence();
    __syncwarp();
    unsigned* const tk = a.tickets + m0 * a.ntiles + t;
    unsigned ticket = 0;
    if (lane == 0) ticket = atomicAdd(tk, 1u);
    ticket = __shfl_sync(kOrFull, ticket, 0);
    if (ticket != a.nchunks - 1) continue;
    __threadfence();
    const int64_t end = (t + 1) * L < Wv ? (t + 1) * L : Wv;
    for (int64_t v = t * L + lane; v < end; v += 32) {
      __stcs(out + m0 * Wv + v, __ldcg(srow + v));
      srow[v] = zero_words<V>();
    }
    if (lane == 0) *tk = 0u;
  }
}

template <typename V>
cudaError_t launch_or(const OrArgs& a, cudaStream_t stream) {
  // the card's resident blocks of this kernel, asked once per device
  static int seen_dev = -1, seen_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != seen_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bucket_or_kernel<V>, kOrWarps * 32, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    seen_dev = dev;
    seen_blocks = sms * per_sm;
  }
  int64_t blocks = (a.units + kOrWarps - 1) / kOrWarps;
  if (blocks > seen_blocks) blocks = seen_blocks;  // warps stride the units
  bucket_or_kernel<V>
      <<<static_cast<unsigned>(blocks), kOrWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// f: [rows, W] words, in_nb: [M, D] int32 row indices into f, out: [M, W]
// words; all contiguous on the device. The plan (ops/kernels.py,
// bucket_or_plan): vectors of `vec` words, groups of `lanes` lanes over
// tiles of `lanes` vectors, `ntiles` tiles a row; row units of
// `rows_unit` rows (then chunk == D <= kRowMaxD, nchunks == 1), or chunk
// units (rows_unit 0) of `chunk` in-neighbours, nchunks = ceil(D / chunk)
// of them a row; `units` of each kind times ntiles. With nchunks > 1,
// scratch is M * W + M * ntiles zero words (the split rows' OR, then
// their tiles' tickets), which the launch leaves zero again. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
extern "C" int bucket_or_launch(const void* f, const void* in_nb, void* out,
                                void* scratch, int64_t M, int64_t D,
                                int64_t W, int64_t vec, int64_t lanes,
                                int64_t ntiles, int64_t rows_unit,
                                int64_t chunk, int64_t nchunks,
                                void* stream) {
  const int64_t vbytes = 4 * vec;
  const bool lanes_ok = lanes == 1 || lanes == 2 || lanes == 4 ||
                        lanes == 8 || lanes == 16 || lanes == 32;
  if (M <= 0 || D <= 0 || W <= 0 || !lanes_ok ||
      (vec != 1 && vec != 2 && vec != 4) || W % vec != 0 ||
      reinterpret_cast<uintptr_t>(f) % vbytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % vbytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t Wv = W / vec;
  if (ntiles < 1 || (ntiles - 1) * lanes >= Wv || ntiles * lanes < Wv ||
      (lanes < 32 && ntiles != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows_unit > 0) {
    if (rows_unit > 32 || D > kRowMaxD || rows_unit * D > kSpan ||
        chunk != D || nchunks != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (rows_unit < 0 || D <= kRowMaxD || chunk != kSpan ||
             nchunks != (D + chunk - 1) / chunk ||
             (nchunks > 1 &&
              (!scratch ||
               reinterpret_cast<uintptr_t>(scratch) % vbytes != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OrArgs a;
  a.f = f;
  a.in_nb = static_cast<const int32_t*>(in_nb);
  a.out = out;
  a.scratch = scratch;
  a.tickets = scratch ? static_cast<unsigned*>(scratch) + M * W : nullptr;
  a.M = M;
  a.D = D;
  a.Wv = Wv;
  a.lanes = static_cast<int>(lanes);
  a.ntiles = ntiles;
  a.rows_unit = rows_unit;
  a.chunk = chunk;
  a.nchunks = nchunks;
  a.units = ntiles *
            (rows_unit > 0 ? (M + rows_unit - 1) / rows_unit : M * nchunks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec) {
    case 4: err = launch_or<uint4>(a, s); break;
    case 2: err = launch_or<uint2>(a, s); break;
    default: err = launch_or<unsigned>(a, s); break;
  }
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
