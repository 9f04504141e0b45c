// Similarity scoring kernels of the vector search plane, for Hopper (sm_90a).
//
// Two kernels, each replacing one TPU kernel of
// dgraph_tpu/ops/pallas_kernels.py.
// Neither uses tensor cores or TF32: the plane's correctness gate rests on
// full float32 products, and each kernel differs from its plain PyTorch
// version only in the order in which it sums the same float32 products.
//
// score_dot_kernel replaces score_dot_pallas (:123):
//
//     out[i, j] = sum_{k < d} Q[i, k] * C[j, k]      C: f32[n, d], Q: f32[b, d]
//
//   Bound: at the exact tier's shape (b = 256, n = 1M, d = 128) it does
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
//     tile can hold in shared memory is cut into segments, one launch each,
//     the later ones adding to the output.
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
  // the deepest segment whose query tile fits beside the ring: a multiple
  // of KC, its row stride (DSEG + 4) is 4 mod 32
  static constexpr int DSEG =
      ((SMEM_MAX / 4 - RING) / BQ - 4) / KC * KC;
  static_assert(QL * CL == THREADS, "lanes");
  static_assert(DSEG >= KC, "segment");
};
using C = DotTile;
constexpr int BQ = C::BQ, TQ = C::TQ, TN = C::TN;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
score_dot_kernel(const float* __restrict__ corpus,
                 const float* __restrict__ queries, float* __restrict__ out,
                 int64_t n, int64_t b, int64_t d, int64_t k0, int ds,
                 int accumulate) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int nch = (ds + C::KC - 1) / C::KC;   // chunks a tile
  const int qstr = nch * C::KC + 4;
  float* const qs = smem;                     // [BQ][qstr]
  float* const ring = smem + BQ * qstr;       // [STAGES][BN][CSTR]
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

  const int64_t ntiles = (n + C::BN - 1) / C::BN;
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

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < total) load_chunk(s);
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
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int64_t row = q0 + ty + i * C::QL;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int64_t col = col0 + tx + j * C::CL;
          if (row < b && col < n) {
            float* const o = out + row * n + col;
            *o = accumulate ? acc[i][j] + *o : acc[i][j];
          }
          acc[i][j] = 0.f;
        }
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

template <bool VEC>
int launch_dot(const float* corpus, const float* queries, float* out,
               int64_t n, int64_t b, int64_t d, cudaStream_t stream) {
  auto kernel = score_dot_kernel<VEC>;
  static const cudaError_t attr = allow_smem(kernel, SMEM_MAX);   // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t ntiles = (n + C::BN - 1) / C::BN;
  const int64_t gy = (b + BQ - 1) / BQ;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t k0 = 0; k0 < d; k0 += C::DSEG) {
    const int ds = static_cast<int>(d - k0 < C::DSEG ? d - k0 : C::DSEG);
    const int qstr = (ds + C::KC - 1) / C::KC * C::KC + 4;
    const size_t smem = (static_cast<size_t>(BQ) * qstr + C::RING) * 4;
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
    // one wave of blocks over the card, shared by the query tiles
    int64_t gx = (static_cast<int64_t>(sms) * per_sm + gy - 1) / gy;
    if (gx > ntiles) gx = ntiles;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    kernel<<<grid, THREADS, smem, stream>>>(corpus, queries, out, n, b, d, k0,
                                            ds, k0 > 0 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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

// corpus: float32 [n, d], queries: float32 [b, d], out: float32 [b, n]; all
// contiguous on the device; n, b, d >= 1. Launches on `stream`, once a depth
// segment of 128 floats, and returns the CUDA error code of the launches (0
// on success).
extern "C" int score_dot_launch(const void* corpus, const void* queries,
                                void* out, int64_t n, int64_t b, int64_t d,
                                void* stream) {
  if (n <= 0 || b <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  auto fn = vec ? launch_dot<true> : launch_dot<false>;
  return fn(static_cast<const float*>(corpus),
            static_cast<const float*>(queries), static_cast<float*>(out), n,
            b, d, static_cast<cudaStream_t>(stream));
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
