// Similarity scoring kernels of the vector search plane, for Hopper (sm_90a).
//
// Three kernels, replacing two TPU kernels of
// dgraph_tpu/ops/pallas_kernels.py.
// None uses tensor cores or TF32: the plane's correctness gate rests on
// full float32 products, and each kernel differs from its plain PyTorch
// version only in the order in which it sums the same float32 products.
//
// score_dot replaces score_dot_pallas (:123):
//
//     out[i, j] = sum_{k < d} Q[i, k] * C[j, k]      C: f32[n, d], Q: f32[b, d]
//
// on one of two routes, which the caller picks by the batch b
// (score_dot_plan in ops/kernels.py) and passes in. On an H100 at
// (b, 262,144, 128) the row route won up to b = 41 and lost from 48, where
// the tile route's time, flat in b, is 0.46 ms: the plan takes the row
// route up to 44 queries (score_dot_sweep.py, chip_smoke.py's phase 9).
//
// The store (score_metric in ops/kernels.py). In place of the dot, the last
// depth segment of a launch may store the metric's score, each element
// written once from registers:
//
//     euclidean  -((q2 - 2 dot) + c2)
//     cosine     dot / (qn * cn) where qn * cn > 0, else 0
//
// with q2 = |Q[i]|^2, c2 = |C[j]|^2 and qn, cn their IEEE square roots, in
// PyTorch's float order: 2 dot is exact, and the difference, the sum, the
// product and the quotient are each rounded once (one __fmaf_rn for
// q2 - 2 dot, which rounds as the difference does; __fadd_rn, __fmul_rn,
// __fdiv_rn, which nothing contracts; the build has no fast math). Every
// column from n_live on, and every column a bool mask clears, holds -inf,
// the output's padding columns up to n_out too: a bitwise select by the
// column's bits, so a cleared column holds -inf whatever its score held
// (NaN or inf from a row's values too) and a kept one its score bit for
// bit; the tile route selects only in a tile that clears a column (with
// no mask, the last). The tile route has one build an epilogue, so its
// store has no branch on it; the row route picks the epilogue at run
// time. The norms come
// from values the kernel loads anyway: the row route sums c * c in the
// registers and shuffles of the dot; the tile route sums each corpus row of
// a chunk in shared memory (4 lanes a row) and each query row of its
// resident tile once a block. They are summed in the kernel's order, not
// torch.sum's, so a score may differ from the plain version's by a few ulp
// more than the dot alone. Where the depth is cut into segments, each launch
// passes its partial norms on through a scratch buffer, as the dots pass on
// through the output (two buffers taken in turn, so no launch overwrites
// what another of its blocks still reads), and only the last stores
// scores. Bound: the store adds no byte, and the column's select and the
// epilogue's few operations an output to 2d FMAs, so each route's bound
// stands.
//
// The tile route, score_dot_kernel, for large batches.
//   Bound: at the bench batch (b = 256, n = 1M, d = 128) it does
//   2bnd = 65.5 GFLOP for 0.5 GB of corpus and 1 GB of output, so float32
//   operations bound it (0.98 ms at 67 TFLOP/s) with the output's bytes
//   close behind (0.46 ms at 3.35 TB/s).
//   Design: the TPU kernel's dataflow (queries resident, corpus streamed)
//   rebuilt for Hopper.
//   * A block keeps a tile of BQ = 256 queries in shared memory for its
//     whole life, each row padded to a stride of 4 mod 32 floats, so the
//     float4 reads of the product loop are conflict-free.
//   * The grid is persistent, about one block per SM; each block walks over
//     corpus tiles of BN = 64 rows, so at b <= BQ the corpus is read once.
//     Query tiles beyond the first are the grid's y dimension.
//   * Corpus tiles arrive in depth chunks of 64 floats through a ring of 3
//     stages filled with 16-byte cp.async while earlier chunks are
//     multiplied: one __syncthreads a chunk, copies always in flight.
//   * Each thread keeps an 8 x 8 tile of outputs in registers and reads
//     float4 along the depth: 256 FMAs for 16 shared loads.
//   * Outputs go straight from registers: a warp writes whole 32-byte
//     sectors; offsets are 64-bit, since b * n can pass 2^31.
//   * Rows that do not start on 16 bytes (d % 4 != 0, or a slice's offset)
//     take 4-byte cp.async in the same kernel. Depth beyond what the query
//     tile can hold beside the ring (DSEG, 128 floats) is cut into
//     segments, one launch each, the later ones adding to the output.
//   Below the crossover it loses: a batch of one does a batch of 256's
//   arithmetic (1/256 of it useful) in one block of 8 warps an SM.
//
// The row route, score_dot_rows_kernel, for a few queries.
//   Bound: bytes. At one query (1, 262,144, 128) it reads 134 MB of corpus
//   for 67 MFLOP: 0.040 ms at 3.35 TB/s; operations pass bytes only from
//   about b = 40 (2b flops a 4-byte corpus float against 67 TFLOP/s over
//   3.35 TB/s).
//   Design: stream the corpus once, with loads always in flight.
//   * Up to QT queries of a pass (1, 2, 4, 8, 16 or 32; more take further
//     passes) sit in shared memory for a depth segment of at most
//     ROW_QFLOATS / QT floats; deeper rows take segments that add to the
//     output. Lanes of a row read neighbouring float4 of a query:
//     conflict-free with no padding.
//   * A group of `lanes` lanes (a power of two up to a warp, no wider than
//     a segment's float4) reads one corpus row, neighbouring lanes on
//     neighbouring 16-byte words; a warp's groups read neighbouring rows.
//     At one query 8 lanes a row were fastest, at 32 queries one.
//   * A lane scores R rows at once (RowTile: R * QT partial sums) and asks
//     for the next step's R loads before it multiplies this step's, so
//     each warp keeps loads in flight through its arithmetic; its first
//     loads go out before the block stages its queries.
//   * The loads are marked evict-first (ld.global.cs): the corpus is read
//     once, and leaving the L2 to the rest was faster than ld.global.nc.
//   * A shuffle over the group finishes each dot; lanes of the group share
//     the stores of the R x QT scores, a warp writing runs of rows of one
//     query, as floats, so any output offset works.
//   * Blocks of 8 warps and at most 32 KB of queries; a grid-stride loop
//     over units of rows, the grid as many blocks as the card holds at
//     once (occupancy asked once an instantiation) and no more than the
//     units need, so a small n leaves no block without rows.
//   * Rows that do not start on 16 bytes take 4-byte loads in the same
//     kernel.
//   On an H100 SXM at 700 W: 0.0578 ms at (1, 262,144, 128) against
//   torch.matmul's 0.0598 and the tile route's 0.4534 (chip_smoke.py's
//   phase 9); its arithmetic falls behind torch.matmul from 16 queries
//   (shuffles and shared loads a score).
//
// score_int8_lists_kernel replaces score_int8_pallas (:158), and does a whole
// quantized search's approximate stage in one launch. For every entry of a
// work table (a slice [s, s + len) of the clustered codes, and up to
// M_TILE = 8 of the queries that probe it, from slot a):
//
//     out[off + j * len + r] = (dot(Q[qidx[a + j]], float(codes[s + r]))
//                               * scales[s + r]) + cterm[a + j]
//
//   with the product and the sum rounded separately (__fmul_rn, __fadd_rn),
//   as the reference's `dots * scales + cent` and the plain mul_ / add_; a
//   contracted FMA would round once. Null scales, cterm or qidx stand for 1,
//   0 and a + j: the dense score_int8 is one entry per 8 queries over all
//   rows, and stays exact.
//   Bound: bytes. One calibrated batch at 1M x 128 reads about 111 MB of
//   codes (each probed list once) and writes about 9 MB: about 0.04 ms at
//   3.35 TB/s, against about 0.5 GFLOP.
//   Design:
//   * A block scores one row tile (64 rows) of one entry; a second table
//     gives each tile's entry, and the entry's prefix of tiles its row tile,
//     so a block finds its work in two dependent loads.
//   * The entry's queries sit in shared memory as float32, each 16-float
//     segment padded by 4, so the 8 lanes of a row read conflict-free.
//   * 8 lanes read a code row with 16-byte loads (a 128-byte row at
//     d = 128). Each lane asks for the first 16 bytes of both of its rows
//     before it waits for the queries, so their latencies overlap.
//   * Registers set the speed: 8 queries an entry and 2 rows a lane keep a
//     thread at 64 registers, 4 blocks an SM; more queries or rows a lane
//     cost occupancy and ran slower at a calibrated batch's shape.
//   * The caller sizes its table by score_int8_lists_limits, so these
//     constants live here alone.
//   * Each lane keeps one partial sum per query of the entry in registers,
//     so a code row loaded once serves all of them, and a shuffle over the
//     8 lanes finishes each dot.
//   * Rows that do not start on 16 bytes (d % 16 != 0, or a slice's offset)
//     take byte loads in the same kernel.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_MAX = 232448;   // the most shared memory a block may take
// dynamic shared memory of score_int8_lists: SMEM_MAX less room for its
// static part (the table entry)
constexpr int LIST_SMEM_MAX = SMEM_MAX - 1024;
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// -- score_dot ---------------------------------------------------------------

// What a launch's last depth segment stores (score_metric in ops/kernels.py):
// the dot, or the metric's score from the dot and the two rows' squared
// norms
constexpr int EPI_DOT = 0, EPI_EUCLIDEAN = 1, EPI_COSINE = 2;

// A launch's store into out [b, n_out], n_out >= n. With `epilogue` (the
// last depth segment) a column j < n_live that the mask keeps (a null mask
// keeps every one) gets the metric's score and every other column -inf;
// earlier segments store their partial dots, and `accumulate` adds the
// segment before. With norms, prev and next hold the partial squared norms
// of a cut depth, queries first, then corpus rows ([b + n] floats each):
// the segment before this one's (null in the first) and this one's (null
// in the last); two buffers taken in turn, so no launch writes what it
// reads.
struct Store {
  int64_t n_out, n_live;
  const unsigned char* mask;
  int epi;
  int accumulate, epilogue;
  const float* prev;
  float* next;
};

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// what the epilogue takes of a row's squared norm: the norm itself for
// cosine (IEEE square root), the square for euclidean
__device__ __forceinline__ float norm_value(int epi, float sq) {
  return epi == EPI_COSINE ? __fsqrt_rn(sq) : sq;
}

// the metric's score of a dot, from its rows' norm_value qv and cv, in
// PyTorch's float order: euclidean -((q2 - 2 dot) + c2), the difference
// and the sum each rounded once (2 dot is exact, so the fused
// q2 - 2 dot rounds as the two steps do; the sum is not fused); cosine
// dot / (qn * cn), product and quotient rounded, where the denominator is
// positive, else 0 (as torch.where(pos, dot / torch.where(pos, den, 1), 0))
template <int E>
__device__ __forceinline__ float metric_score(float dot, float qv, float cv) {
  if (E == EPI_EUCLIDEAN) return -__fadd_rn(__fmaf_rn(-2.f, dot, qv), cv);
  if (E == EPI_COSINE) {
    const float den = __fmul_rn(qv, cv);
    const float quo = __fdiv_rn(dot, den > 0.f ? den : 1.f);
    return den > 0.f ? quo : 0.f;
  }
  return dot;
}

// the same with the epilogue known only at run time (the row route)
__device__ __forceinline__ float metric_score(int epi, float dot, float qv,
                                              float cv) {
  switch (epi) {
    case EPI_EUCLIDEAN: return metric_score<EPI_EUCLIDEAN>(dot, qv, cv);
    case EPI_COSINE: return metric_score<EPI_COSINE>(dot, qv, cv);
    default: return dot;
  }
}

// a column's bits for the last segment's store: all ones where the column
// is live and the mask keeps it, none where not
__device__ __forceinline__ unsigned column_keep(const Store& s, int64_t col) {
  const bool keep =
      col < s.n_live && (s.mask == nullptr || __ldg(s.mask + col) != 0);
  return keep ? ~0u : 0u;
}

// the score where the column keeps it, else -inf, whatever the score
// holds (NaN and inf too): a bitwise select an element
__device__ __forceinline__ float kept(float score, unsigned keep) {
  return __uint_as_float((__float_as_uint(score) & keep) |
                         (__float_as_uint(neg_inf()) & ~keep));
}

// whether a tile's store clears some column (score_dot_kernel's store)
template <bool V>
struct Clears {
  static constexpr bool value = V;
};

// the tile of score_dot
struct DotTile {
  static constexpr int TQ = 8;                // queries a thread
  static constexpr int TN = 8;                // corpus rows a thread
  static constexpr int BQ = 256;              // queries a block
  static constexpr int QL = BQ / TQ;          // query lanes
  static constexpr int CL = THREADS / QL;     // corpus lanes
  static constexpr int BN = CL * TN;          // corpus rows a tile
  static constexpr int KC = 64;               // depth of a chunk
  static constexpr int CSTR = KC + 4;         // floats a row takes in a stage
  static constexpr int STAGES = 3;
  static constexpr int RING = STAGES * BN * CSTR;   // floats
  static constexpr int NORM_FLOATS = BQ + BN; // the tile's norms
  // the deepest segment whose query tile fits beside the ring and the
  // norms: a multiple of KC, its row stride (DSEG + 4) is 4 mod 32
  static constexpr int DSEG =
      ((SMEM_MAX / 4 - RING - NORM_FLOATS) / BQ - 4) / KC * KC;
  static_assert(QL * CL == THREADS, "lanes");
  static_assert(DSEG >= KC, "segment");
  // a thread a query row and 4 a corpus row of a chunk for the norms
  static_assert(BQ == THREADS && BN * 4 == THREADS && KC == 64, "norms");
};
using C = DotTile;
constexpr int BQ = C::BQ, TQ = C::TQ, TN = C::TN;
static_assert(C::DSEG == 128, "DOT_TILE_DSEG in ops/kernels.py");

// E is the launch's epilogue (EPI_*), one build each: the store has no
// branch on it, and the dot's build keeps no norms
template <bool VEC, int E>
__global__ void __launch_bounds__(THREADS, 1)
score_dot_kernel(const float* __restrict__ corpus,
                 const float* __restrict__ queries, float* __restrict__ out,
                 Store s, int64_t n, int64_t b, int64_t d, int64_t k0,
                 int ds) {
  constexpr bool NORMS = E != EPI_DOT;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int nch = (ds + C::KC - 1) / C::KC;   // chunks a tile
  const int qstr = nch * C::KC + 4;
  float* const qs = smem;                     // [BQ][qstr]
  float* const ring = smem + BQ * qstr;       // [STAGES][BN][CSTR]
  float* const qn = ring + C::RING;           // [BQ] the queries' norms
  float* const cn = qn + BQ;                  // [BN] the tile's rows'
  const int tid = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * BQ;

  // the query tile of this segment, zero past b and past the depth
  for (int idx = tid; idx < BQ * nch * C::KC; idx += THREADS) {
    const int r = idx / (nch * C::KC);
    const int k = idx - r * (nch * C::KC);
    const int64_t row = q0 + r;
    qs[r * qstr + k] = (row < b && k < ds) ? __ldg(queries + row * d + k0 + k)
                                           : 0.f;
  }
  if (NORMS) {
    // thread tid sums the squares of the tile's query row tid
    __syncthreads();
    const float4* const qr = reinterpret_cast<const float4*>(qs + tid * qstr);
    float q2 = 0.f;
    for (int k = 0; k < nch * (C::KC / 4); ++k) {
      const float4 v = qr[k];
      q2 = fmaf(v.x, v.x, q2);
      q2 = fmaf(v.y, v.y, q2);
      q2 = fmaf(v.z, v.z, q2);
      q2 = fmaf(v.w, v.w, q2);
    }
    const int64_t row = q0 + tid;
    if (row < b) {
      if (s.prev) q2 += s.prev[row];
      if (s.next && blockIdx.x == 0) s.next[row] = q2;
    }
    qn[tid] = s.epilogue ? norm_value(E, q2) : q2;
  }

  const int64_t ntiles = (s.n_out + C::BN - 1) / C::BN;
  const int64_t bx = blockIdx.x;
  const int64_t mine = bx < ntiles ? (ntiles - 1 - bx) / gridDim.x + 1 : 0;
  const int64_t total = mine * nch;           // chunks this block multiplies

  auto load_chunk = [&](int64_t g) {
    const int64_t row0 = (bx + (g / nch) * gridDim.x) * C::BN;
    const int kb = static_cast<int>(g % nch) * C::KC;
    float* const st =
        ring + static_cast<int>(g % C::STAGES) * (C::BN * C::CSTR);
    if (VEC) {
      for (int idx = tid; idx < C::BN * (C::KC / 4); idx += THREADS) {
        const int r = idx / (C::KC / 4);
        const int c = (idx - r * (C::KC / 4)) * 4;
        const int64_t row = row0 + r;
        const bool ok = row < n && kb + c < ds;
        cp_async16(st + r * C::CSTR + c,
                   ok ? corpus + row * d + k0 + kb + c : corpus, ok);
      }
    } else {
      for (int idx = tid; idx < C::BN * C::KC; idx += THREADS) {
        const int r = idx / C::KC;
        const int c = idx - r * C::KC;
        const int64_t row = row0 + r;
        const bool ok = row < n && kb + c < ds;
        cp_async4(st + r * C::CSTR + c,
                  ok ? corpus + row * d + k0 + kb + c : corpus, ok);
      }
    }
  };

  const int tx = tid % C::CL;   // corpus rows tx + j * CL
  const int ty = tid / C::CL;   // queries ty + i * QL
  float acc[TQ][TN];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  float c2 = 0.f;   // with norms: row tid / 4 of the tile, a quarter of it

#pragma unroll
  for (int p = 0; p < C::STAGES - 1; ++p) {
    if (p < total) load_chunk(p);
    cp_async_commit();
  }
  for (int64_t g = 0; g < total; ++g) {
    cp_async_wait<C::STAGES - 2>();   // chunk g has landed (this thread's)
    __syncthreads();                  // ... every thread's; slot g - 1 free
    if (g + C::STAGES - 1 < total) load_chunk(g + C::STAGES - 1);
    cp_async_commit();

    const float* const st =
        ring + static_cast<int>(g % C::STAGES) * (C::BN * C::CSTR);
    const int kc = static_cast<int>(g % nch);
    if (NORMS) {
      // 4 lanes a row of the chunk, 16 floats each
      const float4* const cr = reinterpret_cast<const float4*>(
          st + (tid / 4) * C::CSTR + (tid % 4) * 16);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = cr[u];
        c2 = fmaf(v.x, v.x, c2);
        c2 = fmaf(v.y, v.y, c2);
        c2 = fmaf(v.z, v.z, c2);
        c2 = fmaf(v.w, v.w, c2);
      }
      if (kc == nch - 1) {
        // the tile's norms are whole: into shared memory, behind a
        // barrier before the product loop, so the store after it reads
        // them with no barrier of its own. Every read of the tile
        // before's norms came before the barrier at the top of this chunk
        c2 += __shfl_xor_sync(0xffffffffu, c2, 1);
        c2 += __shfl_xor_sync(0xffffffffu, c2, 2);
        if (tid % 4 == 0) {
          const int64_t col =
              (bx + (g / nch) * gridDim.x) * C::BN + tid / 4;
          if (col < n) {
            if (s.prev) c2 += s.prev[b + col];
            if (s.next && blockIdx.y == 0) s.next[b + col] = c2;
          }
          cn[tid / 4] = s.epilogue ? norm_value(E, c2) : c2;
        }
        c2 = 0.f;
        __syncthreads();              // the tile's norms are in
      }
    }
    const float* const qk = qs + kc * C::KC;
#pragma unroll
    for (int kk = 0; kk < C::KC; kk += 4) {
      float4 a[TQ], c[TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qk + (ty + i * C::QL) * qstr +
                                                kk);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[j] = *reinterpret_cast<const float4*>(
            st + (tx + j * C::CL) * C::CSTR + kk);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, c[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, c[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, c[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, c[j].w, acc[i][j]);
        }
      }
    }

    if (kc == nch - 1) {              // the tile's last chunk: store it
      const int64_t col0 = (bx + (g / nch) * gridDim.x) * C::BN;
      // the store from registers: with CLEARS each score takes its
      // column's bits (kept), without, the score goes as it is
      auto store = [&](auto clears) {
        constexpr bool CLEARS = decltype(clears)::value;
        float cv[TN];
        unsigned keep[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          keep[j] = CLEARS ? column_keep(s, col0 + tx + j * C::CL) : ~0u;
          cv[j] = NORMS ? cn[tx + j * C::CL] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const int64_t row = q0 + ty + i * C::QL;
          const float qv = NORMS ? qn[ty + i * C::QL] : 0.f;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int64_t col = col0 + tx + j * C::CL;
            if (row < b && col < s.n_out) {
              float* const o = out + row * s.n_out + col;
              const float dot = s.accumulate ? acc[i][j] + *o : acc[i][j];
              const float score =
                  s.epilogue ? metric_score<E>(dot, qv, cv[j]) : dot;
              *o = CLEARS ? kept(score, keep[j]) : score;
            }
            acc[i][j] = 0.f;
          }
        }
      };
      // a tile clears a column only past n_live or under a mask: with no
      // mask every tile but the last keeps every column, so the select
      // costs a branch a tile, where a select an element made the dot's
      // build 7.5% slower at (256, 1M, 128) on an H100
      if (s.epilogue && (s.mask != nullptr || col0 + C::BN > s.n_live)) {
        store(Clears<true>{});
      } else {
        store(Clears<false>{});
      }
    }
  }
  cp_async_wait<0>();
}

int sm_count() {
  static const int count = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    return sms;
  }();
  return count;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// segment seg's store of a launch cut into segments of dseg floats of
// depth: it adds to the one before, the last writes the scores, and with
// norms the partial norms pass through `part` ([2][b + n] floats)
Store segment_store(Store s, int64_t k0, int64_t dseg, int64_t d,
                    float* part, int64_t b, int64_t n) {
  const int64_t seg = k0 / dseg;
  s.accumulate = k0 > 0;
  s.epilogue = k0 + dseg >= d;
  s.prev = part && k0 > 0 ? part + ((seg - 1) & 1) * (b + n) : nullptr;
  s.next = part && !s.epilogue ? part + (seg & 1) * (b + n) : nullptr;
  return s;
}

template <bool VEC, int E>
int launch_dot(const float* corpus, const float* queries, float* out,
               Store base, float* part, int64_t n, int64_t b, int64_t d,
               cudaStream_t stream) {
  constexpr bool NORMS = E != EPI_DOT;
  auto kernel = score_dot_kernel<VEC, E>;
  static const cudaError_t attr = allow_smem(kernel, SMEM_MAX);   // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // blocks an SM holds, by chunks a segment (its query tile's depth);
  // asked once each
  constexpr int NCH = C::DSEG / C::KC;
  static std::atomic<int> blocks_per_sm[NCH + 1];
  const int64_t ntiles = (base.n_out + C::BN - 1) / C::BN;
  const int64_t gy = (b + BQ - 1) / BQ;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t k0 = 0; k0 < d; k0 += C::DSEG) {
    const int ds = static_cast<int>(d - k0 < C::DSEG ? d - k0 : C::DSEG);
    const int nch = (ds + C::KC - 1) / C::KC;
    const int qstr = nch * C::KC + 4;
    const size_t floats = static_cast<size_t>(BQ) * qstr + C::RING +
                          (NORMS ? C::NORM_FLOATS : 0);
    const size_t smem = floats * 4;
    int per_sm = blocks_per_sm[nch].load(std::memory_order_relaxed);
    if (per_sm == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, THREADS, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) per_sm = 1;
      blocks_per_sm[nch].store(per_sm, std::memory_order_relaxed);
    }
    // one wave of blocks over the card, shared by the query tiles
    int64_t gx = (static_cast<int64_t>(sms) * per_sm + gy - 1) / gy;
    if (gx > ntiles) gx = ntiles;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    kernel<<<grid, THREADS, smem, stream>>>(
        corpus, queries, out,
        segment_store(base, k0, C::DSEG, d, part, b, n), n, b, d, k0, ds);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// -- score_dot, the row route -------------------------------------------------

// floats of queries a block of the row route holds (32 KB): a pass of QT
// queries takes depth segments of ROW_QFLOATS / QT floats
constexpr int ROW_QFLOATS = 8192;

// rows a lane scores at once, by queries a pass (1, 2, 4, 8, 16 or 32):
// R * QT partial sums and 2 * R float4 of corpus a lane in registers; the
// fastest of score_dot_sweep.py's builds at (b, 262,144, 128)
template <int QT>
struct RowTile {
  static_assert(QT >= 1 && QT <= 32 && (QT & (QT - 1)) == 0, "QT");
  static constexpr int R = QT <= 2 ? 4 : QT <= 8 ? 2 : 1;
};

template <int QT, bool VEC, bool NORMS>
__global__ void __launch_bounds__(THREADS)
score_dot_rows_kernel(const float* __restrict__ corpus,
                      const float* __restrict__ queries,
                      float* __restrict__ out, Store s, int64_t n, int64_t b,
                      int64_t d, int64_t q0, int bq, int64_t k0, int ds,
                      int lanes) {
  constexpr int R = RowTile<QT>::R;
  constexpr int W = VEC ? 4 : 1;              // floats a load
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;               // lane of its row
  const int groups = 32 / lanes;              // rows of a warp's step
  const int span = lanes * W;                 // floats of a row a step
  const int steps = (ds + span - 1) / span;   // steps a unit
  const int64_t unit = static_cast<int64_t>(groups) * R;   // rows a unit
  const int64_t units = (s.n_out + unit - 1) / unit;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (THREADS / 32);

  // this lane's loads of step t of unit u: rows u * unit + lane / lanes +
  // r * groups (a warp's groups read neighbouring rows at each r), floats
  // k = sub * W + t * span of each; zero past the corpus. The corpus is
  // read once, so its lines are marked to leave the L2 first
  auto load = [&](float4 (&c)[R], int64_t u, int t) {
    const int k = sub * W + t * span;
    const int64_t row0 = u * unit + lane / lanes;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r * groups;
      const bool ok = u < units && row < n && k < ds;
      const float* const p = corpus + row * d + k0 + k;
      if (VEC) {
        c[r] = ok ? __ldcs(reinterpret_cast<const float4*>(p))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        c[r] = make_float4(ok ? __ldcs(p) : 0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  float acc[R][QT];
  float c2[R];      // with norms: each row's squared norm, this lane's part
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c2[r] = 0.f;
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[r][j] = 0.f;
  }
  int64_t u = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) +
              threadIdx.x / 32;
  int t = 0;
  float4 c[R];
  load(c, u, t);   // before the queries arrive, so the two latencies overlap

  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);   // [bq][qstr]
  const int qstr = (ds + 3) & ~3;
  float* const qn = qs + bq * qstr;                    // [bq] their norms
  for (int idx = threadIdx.x; idx < bq * ds; idx += THREADS) {
    const int j = idx / ds;
    const int k = idx - j * ds;
    qs[j * qstr + k] = __ldg(queries + (q0 + j) * d + k0 + k);
  }
  __syncthreads();
  if (NORMS) {
    // warp w sums the squares of queries w, w + 8, ...; a shuffle ends each
    for (int j = threadIdx.x / 32; j < bq; j += THREADS / 32) {
      float q2 = 0.f;
      for (int k = lane; k < ds; k += 32) {
        q2 = fmaf(qs[j * qstr + k], qs[j * qstr + k], q2);
      }
      for (int o = 16; o > 0; o /= 2) {
        q2 += __shfl_xor_sync(0xffffffffu, q2, o);
      }
      if (s.prev) q2 += s.prev[q0 + j];
      if (lane == 0) {
        if (s.next && blockIdx.x == 0) s.next[q0 + j] = q2;
        qn[j] = s.epilogue ? norm_value(s.epi, q2) : q2;
      }
    }
    __syncthreads();
  }

  while (u < units) {
    // the next step's loads go out before this step's arithmetic
    const bool last = t == steps - 1;
    const int64_t un = last ? u + warps : u;
    const int tn = last ? 0 : t + 1;
    float4 cn[R];
    load(cn, un, tn);

    const int k = sub * W + t * span;
    if (k < ds) {
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j < bq) {
          const float* const qj = qs + j * qstr + k;
          if (VEC) {
            const float4 q = *reinterpret_cast<const float4*>(qj);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][j] = fmaf(q.x, c[r].x, acc[r][j]);
              acc[r][j] = fmaf(q.y, c[r].y, acc[r][j]);
              acc[r][j] = fmaf(q.z, c[r].z, acc[r][j]);
              acc[r][j] = fmaf(q.w, c[r].w, acc[r][j]);
            }
          } else {
            const float q = *qj;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][j] = fmaf(q, c[r].x, acc[r][j]);
            }
          }
        }
      }
      if (NORMS) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          c2[r] = fmaf(c[r].x, c[r].x, c2[r]);
          if (VEC) {
            c2[r] = fmaf(c[r].y, c[r].y, c2[r]);
            c2[r] = fmaf(c[r].z, c[r].z, c2[r]);
            c2[r] = fmaf(c[r].w, c[r].w, c2[r]);
          }
        }
      }
    }
    if (last) {
      // a shuffle over the row's lanes finishes each dot (and norm); bq is
      // the same for the whole block and u for the whole warp, so every
      // lane shuffles
      const int64_t row0 = u * unit + lane / lanes;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t row = row0 + r * groups;
        float cv = 0.f;
        if (NORMS) {
          for (int o = lanes / 2; o > 0; o /= 2) {
            c2[r] += __shfl_xor_sync(0xffffffffu, c2[r], o);
          }
          if (row < n) {
            if (s.prev) c2[r] += s.prev[b + row];
            if (s.next && sub == 0) s.next[b + row] = c2[r];
          }
          cv = norm_value(s.epi, c2[r]);
          c2[r] = 0.f;
        }
        const unsigned keep = column_keep(s, row);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          if (j < bq) {
            for (int o = lanes / 2; o > 0; o /= 2) {
              acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
            }
            // the group's lanes share the stores
            if ((r * QT + j) % lanes == sub && row < s.n_out) {
              float* const o = out + (q0 + j) * s.n_out + row;
              const float dot = s.accumulate ? acc[r][j] + *o : acc[r][j];
              *o = s.epilogue
                  ? kept(metric_score(s.epi, dot, NORMS ? qn[j] : 0.f, cv),
                         keep)
                  : dot;
            }
          }
          acc[r][j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = cn[r];
    u = un;
    t = tn;
  }
}

template <int QT, bool VEC, bool NORMS>
int launch_rows(const float* corpus, const float* queries, float* out,
                Store base, float* part, int64_t n, int64_t b, int64_t d,
                int lanes, cudaStream_t stream) {
  auto kernel = score_dot_rows_kernel<QT, VEC, NORMS>;
  constexpr int QN = NORMS ? QT * 4 : 0;      // bytes of the queries' norms
  // blocks an SM holds at the most queries' shared memory; asked once
  static const int per_sm = [kernel] {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kernel, THREADS, ROW_QFLOATS * 4 + QN) == cudaSuccess
               ? blocks : 0;
  }();
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const int64_t unit = static_cast<int64_t>(32 / lanes) * RowTile<QT>::R;
  const int64_t units = (base.n_out + unit - 1) / unit;
  int64_t grid = static_cast<int64_t>(sms) * per_sm;
  const int64_t wanted = (units + THREADS / 32 - 1) / (THREADS / 32);
  if (grid > wanted) grid = wanted;
  constexpr int DSEG = ROW_QFLOATS / QT;      // a multiple of 4
  for (int64_t q0 = 0; q0 < b; q0 += QT) {
    const int bq = static_cast<int>(b - q0 < QT ? b - q0 : QT);
    for (int64_t k0 = 0; k0 < d; k0 += DSEG) {
      const int ds = static_cast<int>(d - k0 < DSEG ? d - k0 : DSEG);
      const size_t smem = static_cast<size_t>(bq) * ((ds + 3) & ~3) * 4 + QN;
      kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
          corpus, queries, out, segment_store(base, k0, DSEG, d, part, b, n),
          n, b, d, q0, bq, k0, ds, lanes);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

template <bool VEC, bool NORMS>
int launch_rows_of(int q_tile, const float* corpus, const float* queries,
                   float* out, Store base, float* part, int64_t n, int64_t b,
                   int64_t d, int lanes, cudaStream_t stream) {
  switch (q_tile) {
    case 1: return launch_rows<1, VEC, NORMS>(corpus, queries, out, base,
                                              part, n, b, d, lanes, stream);
    case 2: return launch_rows<2, VEC, NORMS>(corpus, queries, out, base,
                                              part, n, b, d, lanes, stream);
    case 4: return launch_rows<4, VEC, NORMS>(corpus, queries, out, base,
                                              part, n, b, d, lanes, stream);
    case 8: return launch_rows<8, VEC, NORMS>(corpus, queries, out, base,
                                              part, n, b, d, lanes, stream);
    case 16: return launch_rows<16, VEC, NORMS>(corpus, queries, out, base,
                                                part, n, b, d, lanes, stream);
    case 32: return launch_rows<32, VEC, NORMS>(corpus, queries, out, base,
                                                part, n, b, d, lanes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the route's launches: the tile route's build of the epilogue, or the row
// route's build with or without norms
template <bool VEC>
int launch_route(int route, int q_tile, const float* corpus,
                 const float* queries, float* out, Store base, float* part,
                 int64_t n, int64_t b, int64_t d, int lanes,
                 cudaStream_t stream) {
  if (route == 0) {
    auto fn = base.epi == EPI_EUCLIDEAN ? launch_dot<VEC, EPI_EUCLIDEAN>
              : base.epi == EPI_COSINE  ? launch_dot<VEC, EPI_COSINE>
                                        : launch_dot<VEC, EPI_DOT>;
    return fn(corpus, queries, out, base, part, n, b, d, stream);
  }
  auto fn = base.epi == EPI_DOT ? launch_rows_of<VEC, false>
                                : launch_rows_of<VEC, true>;
  return fn(q_tile, corpus, queries, out, base, part, n, b, d, lanes, stream);
}

// -- score_int8_lists --------------------------------------------------------

constexpr int M_TILE = 8;                    // queries a table entry
constexpr int LPR = 8;                       // lanes a code row
constexpr int ROWS_PER_PASS = THREADS / LPR; // rows a block scores at once
constexpr int PASSES = 2;                    // passes a block
constexpr int LIST_TILE = PASSES * ROWS_PER_PASS;   // code rows a block
constexpr int TABLE_COLS = 6;   // start, rows, first slot, queries, offset,
                                // first row tile

// position of depth k in a query row in shared memory: 16-float segments
// padded to 20, so the 8 lanes of a row read disjoint banks
__device__ __forceinline__ int qcol(int k) { return k + (k >> 4) * 4; }

// floats a query row takes in shared memory at depth d
int64_t list_qrow(int64_t d) { return (d + 15) / 16 * 20; }

// the most queries an entry may hold at depth d (their rows must fit in a
// block's shared memory); 0 when d is out of range or one row does not fit
int64_t list_max_m(int64_t d) {
  if (d <= 0 || d > (1 << 20)) return 0;
  const int64_t fit = LIST_SMEM_MAX / (list_qrow(d) * 4);
  return fit < M_TILE ? fit : M_TILE;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
score_int8_lists_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ queries,
                        const float* __restrict__ scales,
                        const int64_t* __restrict__ table,
                        const int* __restrict__ tile_entry,
                        const int64_t* __restrict__ qidx,
                        const float* __restrict__ cterm,
                        float* __restrict__ out, int d, int qrow) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);   // [m][qrow]
  const int tid = threadIdx.x;
  const int64_t* const ent = table + static_cast<int64_t>(
      __ldg(tile_entry + blockIdx.x)) * TABLE_COLS;
  const int64_t s = __ldg(ent), ln = __ldg(ent + 1), a = __ldg(ent + 2);
  const int m = static_cast<int>(__ldg(ent + 3));
  const int64_t off = __ldg(ent + 4);
  const int64_t r0 = (blockIdx.x - __ldg(ent + 5)) * LIST_TILE;

  const int lane = tid % 32;
  const int sub = lane % LPR;                              // lane of its row
  const int slot = (tid / 32) * (32 / LPR) + lane / LPR;   // row of a pass
  // the first 16 bytes of every row this lane scores, asked for before
  // the queries arrive, so the two latencies overlap
  int4 head[PASSES];
  if (VEC) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int64_t r = r0 + p * ROWS_PER_PASS + slot;
      head[p] = (r < ln && sub * 16 < d)
          ? __ldg(reinterpret_cast<const int4*>(codes + (s + r) * d) + sub)
          : make_int4(0, 0, 0, 0);
    }
  }
  for (int idx = tid; idx < m * d; idx += THREADS) {
    const int j = idx / d;
    const int k = idx - j * d;
    const int64_t q = qidx ? __ldg(qidx + a + j) : a + j;
    qs[j * qrow + qcol(k)] = __ldg(queries + q * d + k);
  }
  __syncthreads();

#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int64_t r = r0 + p * ROWS_PER_PASS + slot;
    const bool live = r < ln;
    float acc[M_TILE];
#pragma unroll
    for (int j = 0; j < M_TILE; ++j) acc[j] = 0.f;
    if (live) {
      const int8_t* const row = codes + (s + r) * d;
      if (VEC) {
        for (int k = sub * 16; k < d; k += LPR * 16) {
          const int4 v = k == sub * 16
              ? head[p] : __ldg(reinterpret_cast<const int4*>(row + k));
          float c[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const int w = t < 4 ? v.x : t < 8 ? v.y : t < 12 ? v.z : v.w;
            c[t] = static_cast<float>(static_cast<int8_t>(w >> (8 * (t % 4))));
          }
#pragma unroll
          for (int j = 0; j < M_TILE; ++j) {
            if (j < m) {
              const float4* const qj =
                  reinterpret_cast<const float4*>(qs + j * qrow + qcol(k));
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const float4 q = qj[t];
                acc[j] = fmaf(q.x, c[4 * t], acc[j]);
                acc[j] = fmaf(q.y, c[4 * t + 1], acc[j]);
                acc[j] = fmaf(q.z, c[4 * t + 2], acc[j]);
                acc[j] = fmaf(q.w, c[4 * t + 3], acc[j]);
              }
            }
          }
        }
      } else {
        for (int k = sub; k < d; k += LPR) {
          const float c = static_cast<float>(row[k]);
#pragma unroll
          for (int j = 0; j < M_TILE; ++j) {
            if (j < m) acc[j] = fmaf(qs[j * qrow + qcol(k)], c, acc[j]);
          }
        }
      }
    }
    // m is the same for the whole block, so every lane shuffles
#pragma unroll
    for (int j = 0; j < M_TILE; ++j) {
      if (j < m) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o /= 2) {
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
        }
      }
    }
    if (live) {
      const float sc = scales ? __ldg(scales + s + r) : 1.f;
#pragma unroll
      for (int j = 0; j < M_TILE; ++j) {
        if (j < m && j % LPR == sub) {
          const float ct = cterm ? __ldg(cterm + a + j) : 0.f;
          out[off + j * ln + r] = __fadd_rn(__fmul_rn(acc[j], sc), ct);
        }
      }
    }
  }
}

template <bool VEC>
int launch_lists(const int8_t* codes, const float* queries,
                 const float* scales, const int64_t* table,
                 const int* tile_entry, const int64_t* qidx,
                 const float* cterm, float* out, int64_t n_tiles, int d,
                 int qrow, size_t smem, cudaStream_t stream) {
  auto kernel = score_int8_lists_kernel<VEC>;
  static const cudaError_t attr = allow_smem(kernel, LIST_SMEM_MAX);   // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(n_tiles), THREADS, smem, stream>>>(
      codes, queries, scales, table, tile_entry, qidx, cterm, out, d, qrow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// corpus: float32 [n, d], queries: float32 [b, d], out: float32 [b, n_out];
// all contiguous on the device; n, b, d >= 1, 0 <= n_live <= n <= n_out.
// `route` 0 is the tile route (q_tile 256, lanes 1): one launch a depth
// segment of DSEG (128) floats. `route` 1 is the row route (q_tile 1, 2, 4,
// 8, 16 or 32 queries a pass; `lanes` a row, a power of two up to 32): one
// launch a pass of q_tile queries and a depth segment of ROW_QFLOATS /
// q_tile floats. `vec` is 4 (16-byte corpus loads: d % 4 == 0 and the
// corpus on 16 bytes) or 1. `epi` is what the last segment stores:
// EPI_DOT (0) the dot, EPI_EUCLIDEAN (1) -||q - c||^2, EPI_COSINE (2) the
// cosine, from the rows' norms the kernel sums; -inf in every column
// >= n_live and every column j < n_live with mask[j] == 0 (mask: bool
// [n_live] on the device, or null). `part`: float32 [2 * (b + n)] on the
// device for the partial norms of a depth cut into more than one segment
// with an epilogue other than EPI_DOT, else ignored (may be null).
// Launches on `stream` and returns the CUDA error code of the launches (0
// on success); cudaErrorInvalidValue for a plan or arguments it cannot run.
extern "C" int score_dot_launch(const void* corpus, const void* queries,
                                void* out, int64_t n, int64_t b, int64_t d,
                                int route, int vec, int q_tile, int lanes,
                                int epi, int64_t n_live, int64_t n_out,
                                const void* mask, void* part, void* stream) {
  const bool aligned = d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  if (n <= 0 || b <= 0 || d <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && !aligned) || epi < EPI_DOT || epi > EPI_COSINE ||
      n_live < 0 || n_live > n || n_out < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 0 ? q_tile != BQ || lanes != 1
                 : route != 1 || lanes < 1 || lanes > 32 ||
                       (lanes & (lanes - 1)) != 0 || q_tile < 1 ||
                       q_tile > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool norms = epi != EPI_DOT;
  const int64_t dseg = route == 0 ? C::DSEG : ROW_QFLOATS / q_tile;
  if (norms && d > dseg && part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const float*>(corpus);
  const auto* q = static_cast<const float*>(queries);
  const Store base{n_out, n_live, static_cast<const unsigned char*>(mask),
                   epi, 0, 1, nullptr, nullptr};
  auto* p = norms && d > dseg ? static_cast<float*>(part) : nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  auto fn = vec == 4 ? launch_route<true> : launch_route<false>;
  return fn(route, q_tile, c, q, static_cast<float*>(out), base, p, n, b, d,
            lanes, s);
}

// What a caller of score_int8_lists_launch sizes its table by, at depth d:
// *max_m, the most queries an entry may hold (0: d is out of range, or one
// query row does not fit in shared memory), and *tile_rows, the code rows a
// block scores. Returns 0.
extern "C" int score_int8_lists_limits(int64_t d, int64_t* max_m,
                                       int64_t* tile_rows) {
  *max_m = list_max_m(d);
  *tile_rows = LIST_TILE;
  return 0;
}

// codes: int8 [n, d]; queries: float32 [b, d]; scales: float32 [n] or null
// (1); table: int64 [entries, 6] of (start, rows, first slot, queries m,
// output offset, first row tile), the last column the prefix of
// ceil(rows / rows_per_tile) over the entries before; tile_entry: int32
// [n_tiles], the entry of each row tile; qidx: int64 query of each slot,
// or null (slot a is query a); cterm: float32 term of each slot, or null
// (0); out: float32, written at off + j * rows + r. All on the device;
// 1 <= m <= max_m <= score_int8_lists_limits' max_m and every index in
// range (the caller checks); rows_per_tile must be its tile_rows. One
// launch on `stream`; returns its CUDA error code (0 on success).
extern "C" int score_int8_lists_launch(
    const void* codes, const void* queries, const void* scales,
    const void* table, const void* tile_entry, const void* qidx,
    const void* cterm, void* out, int64_t n_tiles, int64_t rows_per_tile,
    int64_t d, int64_t max_m, void* stream) {
  if (n_tiles <= 0 || n_tiles > 0x7fffffffLL || rows_per_tile != LIST_TILE ||
      max_m <= 0 || max_m > list_max_m(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int qrow = static_cast<int>(list_qrow(d));
  const size_t smem = static_cast<size_t>(max_m) * qrow * 4;
  const bool vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  auto fn = vec ? launch_lists<true> : launch_lists<false>;
  return fn(static_cast<const int8_t*>(codes),
            static_cast<const float*>(queries),
            static_cast<const float*>(scales),
            static_cast<const int64_t*>(table),
            static_cast<const int*>(tile_entry),
            static_cast<const int64_t*>(qidx),
            static_cast<const float*>(cterm), static_cast<float*>(out),
            n_tiles, static_cast<int>(d), qrow, smem,
            static_cast<cudaStream_t>(stream));
}
