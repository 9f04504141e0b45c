"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions.

Counterpart of `dgraph_tpu/ops/pallas_kernels.py`:

- `bucket_or` is the gather-OR of one BFS level bucket
  (`csrc/bucket_or.cu`, replacing `bucket_or_pallas`,
  `pallas_kernels.py:38`). Bitmap words are held as `torch.int32`,
  which has the bit pattern of the reference's `uint32` words.
- `score_dot` is the float32 similarity score of the exact vector tiers
  (`csrc/score.cu`, replacing `score_dot_pallas`,
  `pallas_kernels.py:123`).
- `score_int8_lists` is the approximate stage of the quantized IVF
  tier in one launch, the int8-code scores of every probed list over a
  work table (`csrc/score.cu`, replacing `score_int8_pallas`,
  `pallas_kernels.py:158`); `score_int8` is the same kernel over one
  dense block of codes. Both count their launches in
  `score_int8.launches`.
- `bitmap_and` is the k-way word-AND of the compressed intersection's
  all-bitmap blocks (`csrc/bitmap_and.cu`, replacing
  `bitmap_and_pallas`, `pallas_kernels.py:217`). Words are
  `torch.int64`, the bit pattern of the reference's uint64 words.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs its plain version (`*_reference`), which the tests hold
against the reference package. Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dgraph_tpu_torch.ops import _build

# degree-axis length one block ORs before the row is split across
# blocks (and merged with atomicOr); long enough that a bucket of
# moderate degree runs without atomics, short enough that a hub row of
# millions of in-neighbours spreads over thousands of blocks
CHUNK = 256
# in-neighbours one warp of bucket_or_level gathers: eight batches of 32,
# whose indices and masks it loads at once (kChunk in csrc/bucket_or.cu,
# which refuses another value); a longer row is split across warps
LEVEL_CHUNK = 256
# rows of a frontier bucket_or_level gathers from: its pair list packs a
# row and a segment into one 32-bit word
LEVEL_MAX_ROWS = 1 << 27
# the grid's y dimension (chunks of one row) is at most 65535
_MAX_CHUNKS = 65535


def load_library() -> ctypes.CDLL:
    """The gather-OR kernels' library (`csrc/bucket_or.cu`), built by nvcc
    at first use."""
    lib = _build.load("bucket_or")
    fn = lib.bucket_or_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.bucket_or_level_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 5 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _or_reduce_dim1(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 1 of [M, K, W] -> [M, W], by halving (torch
    has no OR reduction)."""
    while x.shape[1] > 1:
        k = x.shape[1]
        h = k // 2
        head = x[:, :h] | x[:, h:2 * h]
        if k % 2:
            head[:, 0] |= x[:, 2 * h]
        x = head
    return x[:, 0]


def _gather_or(f: torch.Tensor, in_nb: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """OR_d f[in_nb[m, d]] -> [M, W]; with `mask`, each gathered row's
    segments whose mask bit is clear count as zero.

    Direct counterpart of `_gather_or` (`dgraph_tpu/ops/bitgraph.py:325`):
    ORs the gathered rows in chunks of <= 8 along the degree axis so no
    [M, D, W] intermediate is made, then reduces the chunks."""
    m, degree = in_nb.shape
    width = f.shape[1]
    if degree == 0:
        return torch.zeros((m, width), dtype=f.dtype, device=f.device)

    def rows(i):
        r = f[i]
        if mask is not None:
            r &= _segment_fill(mask[i], width)
        return r

    dc = next(c for c in (8, 6, 4, 3, 2, 1) if degree % c == 0)
    nb = in_nb.reshape(m * (degree // dc), dc).long()
    acc = rows(nb[:, 0])
    for d in range(1, dc):
        acc |= rows(nb[:, d])
    if degree > dc:
        acc = _or_reduce_dim1(acc.reshape(m, degree // dc, width))
    return acc


def bucket_or_reference(f: torch.Tensor, in_nb: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: out[m] = OR_d f[in_nb[m, d]]."""
    return _into(_gather_or(f, in_nb), out)


def _check(f: torch.Tensor, in_nb: torch.Tensor,
           out: torch.Tensor | None) -> None:
    if f.dtype != torch.int32 or in_nb.dtype != torch.int32:
        raise TypeError(f"bucket_or takes int32 f and in_nb, got "
                        f"{f.dtype} and {in_nb.dtype}")
    if f.dim() != 2 or in_nb.dim() != 2:
        raise ValueError(f"bucket_or takes f [rows, W] and in_nb [M, D], "
                         f"got {tuple(f.shape)} and {tuple(in_nb.shape)}")
    if f.device != in_nb.device:
        raise ValueError(f"f on {f.device} but in_nb on {in_nb.device}")
    if not (f.is_contiguous() and in_nb.is_contiguous()):
        raise ValueError("bucket_or takes contiguous f and in_nb")
    if out is not None:
        want = (in_nb.shape[0], f.shape[1])
        if out.dtype != torch.int32 or tuple(out.shape) != want:
            raise ValueError(f"out must be int32 {want}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        if out.device != f.device or not out.is_contiguous():
            raise ValueError("out must be contiguous on f's device")


def bucket_or(f: torch.Tensor, in_nb: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """OR of gathered frontier rows: f int32[rows, W], in_nb int32[M, D]
    -> int32[M, W] with out[m] = OR_d f[in_nb[m, d]].

    Every index must lie in [0, rows); the adjacency builders guarantee
    it (padding points at the dummy row N, which is all zeros). `out`,
    if given, is written in place: a contiguous [M, W] slice of a
    level's preallocated result. On CUDA tensors the kernel runs and
    `bucket_or.launches` counts it; on CPU tensors the plain version
    runs."""
    _check(f, in_nb, out)
    if f.device.type == "cpu":
        return bucket_or_reference(f, in_nb, out)
    if f.device.type != "cuda":
        raise ValueError(f"bucket_or runs on cuda or cpu, not {f.device}")
    m, degree = in_nb.shape
    width = f.shape[1]
    if out is None:
        out = torch.empty((m, width), dtype=torch.int32, device=f.device)
    if m == 0 or width == 0:
        return out
    if degree == 0:
        return out.zero_()
    chunk = max(CHUNK, -(-degree // _MAX_CHUNKS))
    if degree > chunk:
        out.zero_()     # the split rows are merged with atomicOr
    err = load_library().bucket_or_launch(
        f.data_ptr(), in_nb.data_ptr(), out.data_ptr(), m, degree, width,
        chunk, torch.cuda.current_stream(f.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucket_or kernel launch failed: CUDA error "
                           f"{err} (M={m}, D={degree}, W={width})")
    bucket_or.launches += 1
    return out


bucket_or.launches = 0


# -- the fused BFS level step (csrc/bucket_or.cu, bucket_or_level_kernel) -----

# bit b of a word, as int32: the uint32 1 << b with its bit pattern kept
WORD_BITS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)) \
    .view(np.int32)


@functools.lru_cache(maxsize=None)
def word_bits(device: torch.device) -> torch.Tensor:
    """WORD_BITS as an int32 [32] tensor on `device`, copied there once:
    a copy from host memory makes the host wait for the card's queue."""
    return torch.from_numpy(WORD_BITS).to(device)


def segment_words(width: int) -> int:
    """Words in one occupancy segment of a W-word row: 32 (128 bytes, one
    L2 line), widened to 32 * ceil(W / 1024) so a row has at most 32
    segments and its mask fits one int32 word."""
    return 32 * max(1, -(-width // 1024))


def _segment_of_word(width: int, device) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int32, device=device) \
        // segment_words(width)


def _segment_fill(mask: torch.Tensor, width: int) -> torch.Tensor:
    """int32 [..., W]: all ones on the words whose segment's bit is set in
    `mask` [...], zero elsewhere (>> on int32 is arithmetic: mask it)."""
    seg = _segment_of_word(width, mask.device)
    return -((mask[..., None] >> seg) & 1)


def segment_masks(words: torch.Tensor) -> torch.Tensor:
    """Exact occupancy masks of bitmap rows: int32 [R, W] -> int32 [R],
    bit s set iff segment s (`segment_words(W)` words) of the row is
    non-zero. The bits are distinct, so an int32 sum is their OR."""
    r, width = words.shape
    nseg = -(-width // segment_words(width))
    seg = _segment_of_word(width, words.device)
    nz = torch.zeros((r, nseg), dtype=torch.int32, device=words.device)
    nz.index_add_(1, seg, (words != 0).to(torch.int32))
    bits = word_bits(words.device)[:nseg]
    return ((nz > 0).to(torch.int32) * bits).sum(dim=1, dtype=torch.int32)


def popcount_sum(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of an int32 word tensor [R, W], as an int64 scalar.

    SWAR popcount kept in non-negative int32: the sign bit is counted
    apart, so no step overflows. Rows are summed in int32 (at most
    32 * W each): a sum of the whole tensor into int64 would first copy
    it to int64."""
    low = words & 0x7FFFFFFF
    x = (low & 0x55555555) + ((low >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = ((x + (x >> 16)) & 0x3F) + ((words >> 31) & 1)
    return x.sum(dim=-1, dtype=torch.int32).sum(dtype=torch.int64)


def bucket_or_level_reference(f, mask, in_nb, frontier, visited, out_mask,
                              total, *, seeds=None, seeds_mask=None,
                              rows=None) -> None:
    """Plain version of `bucket_or_level`, with the kernel's reading of
    the masks: a gathered row's segment whose bit in `mask` is clear
    counts as zero, as does a seed segment whose bit in `seeds_mask` is
    clear. So a wrong mask gives the kernel's wrong answer here too."""
    reach = _gather_or(f, in_nb, mask)
    if seeds is None:
        vis = visited
    else:
        vis = seeds & _segment_fill(seeds_mask, f.shape[1])
    new = reach.bitwise_and_(~vis)
    res = (new, vis | new, segment_masks(new))
    for dst, src in zip((frontier, visited, out_mask), res):
        if rows is None:
            dst.copy_(src)
        else:
            dst[rows.long()] = src
    total += popcount_sum(new)


_LEVEL_ARGS = ("f", "mask", "in_nb", "frontier", "visited", "out_mask",
               "seeds", "seeds_mask", "rows")


def _check_level(f, mask, in_nb, frontier, visited, out_mask, total, seeds,
                 seeds_mask, rows) -> None:
    # the digest calls this ~190 times a batch: plain loops over a tuple
    args = (f, mask, in_nb, frontier, visited, out_mask, seeds, seeds_mask,
            rows)
    dev = f.device
    for k, v in zip(_LEVEL_ARGS, args):
        if v is None:
            continue
        if v.dtype != torch.int32:
            raise TypeError(f"bucket_or_level takes int32 {k}, got {v.dtype}")
        if v.device != dev:
            raise ValueError(f"{k} on {v.device} but f on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"bucket_or_level takes contiguous {k}")
    if total.dtype != torch.int64 or total.numel() != 1:
        raise TypeError(f"total must be an int64 tensor of one element, "
                        f"got {total.dtype} {tuple(total.shape)}")
    if total.device != dev or not total.is_contiguous():
        raise ValueError(f"total on {total.device}, contiguous "
                         f"{total.is_contiguous()}, but f on {dev}")
    if not (seeds is None) == (seeds_mask is None) == (rows is None):
        raise ValueError("seeds, seeds_mask and rows come together")
    if f.dim() != 2 or in_nb.dim() != 2:
        raise ValueError(f"bucket_or_level takes f [rows, W] and in_nb "
                         f"[M, D], got {tuple(f.shape)} and "
                         f"{tuple(in_nb.shape)}")
    if f.shape[0] > LEVEL_MAX_ROWS:
        raise ValueError(f"bucket_or_level gathers from at most "
                         f"{LEVEL_MAX_ROWS} rows, got {f.shape[0]}")
    m, width = in_nb.shape[0], f.shape[1]
    n_out = m if rows is None else frontier.shape[0]
    want = ((f.shape[0],), (n_out, width), (n_out, width), (n_out,),
            (m, width), (m,), (m,))
    for k, v, shape in zip(_LEVEL_ARGS[1:2] + _LEVEL_ARGS[3:], args[1:2] +
                           args[3:], want):
        if v is not None and v.shape != shape:
            raise ValueError(f"{k} must be {shape}, got {tuple(v.shape)}")


def bucket_or_level(f: torch.Tensor, mask: torch.Tensor,
                    in_nb: torch.Tensor, frontier: torch.Tensor,
                    visited: torch.Tensor, out_mask: torch.Tensor,
                    total: torch.Tensor, *,
                    seeds: torch.Tensor | None = None,
                    seeds_mask: torch.Tensor | None = None,
                    rows: torch.Tensor | None = None) -> None:
    """One bucket of a BFS level, fused with the digest's epilogue. For
    each row m of in_nb int32 [M, D], o = rows[m] (m without `rows`):

        reach          = OR_d f[in_nb[m, d]]
        frontier[o]    = reach & ~before[m]
        visited[o]     = before[m] | frontier[o]
        out_mask[o]    = segment_masks(frontier[o])
        total         += popcount(frontier[o])

    f int32 [R, W] is the level's frontier and mask int32 [R] its exact
    occupancy masks (`segment_masks`; row R-1 the dummy, mask 0). Two
    modes:
    - in place (deeper levels): before[m] is visited[m], updated in
      place; frontier, visited and out_mask are [M, W], [M, W], [M];
    - level 1, with `seeds` int32 [M, W] and `seeds_mask` [M] (the seed
      bitmap's rows of the bucket and their masks) and `rows` int32 [M]:
      before[m] = seeds[m], and the outputs [R', W], [R', W], [R'] are
      written at row o = rows[m], visited in full.
    total is one int64 element. Every index must lie in [0, R), and
    R <= LEVEL_MAX_ROWS.

    On CUDA tensors the kernel runs, one launch a call (a row of degree
    > LEVEL_CHUNK is split across warps, whose chunks OR into a zeroed
    scratch row; the row's last chunk runs its epilogue), and
    `bucket_or_level.launches` counts them; on CPU tensors the plain
    version runs."""
    _check_level(f, mask, in_nb, frontier, visited, out_mask, total, seeds,
                 seeds_mask, rows)
    kw = dict(seeds=seeds, seeds_mask=seeds_mask, rows=rows)
    if f.device.type == "cpu":
        bucket_or_level_reference(f, mask, in_nb, frontier, visited,
                                  out_mask, total, **kw)
        return
    if f.device.type != "cuda":
        raise ValueError(f"bucket_or_level runs on cuda or cpu, not "
                         f"{f.device}")
    m, degree = in_nb.shape
    width = f.shape[1]
    if m == 0 or width == 0:
        return
    lib = load_library()
    stream = torch.cuda.current_stream(f.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch(mode, scratch=None):
        err = lib.bucket_or_level_launch(
            f.data_ptr(), mask.data_ptr(), in_nb.data_ptr(), ptr(seeds),
            ptr(seeds_mask), ptr(rows), frontier.data_ptr(),
            visited.data_ptr(), out_mask.data_ptr(), ptr(scratch),
            total.data_ptr(), f.shape[0], m, degree, width, LEVEL_CHUNK,
            mode, stream)
        if err != 0:
            raise RuntimeError(f"bucket_or_level kernel launch failed: CUDA "
                               f"error {err} (M={m}, D={degree}, W={width}, "
                               f"mode={mode})")
        bucket_or_level.launches += 1

    if degree <= LEVEL_CHUNK:
        launch(0)
    else:                       # the split rows' reach, then their tickets
        launch(1, torch.zeros(m * width + m, dtype=torch.int32,
                              device=f.device))


bucket_or_level.launches = 0


def load_score_library() -> ctypes.CDLL:
    """The scoring kernels' library (`csrc/score.cu`), built by nvcc at
    first use."""
    lib = _build.load("score")
    fn = lib.score_dot_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.score_int8_lists_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.score_int8_lists_limits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
    return lib


def lists_limits(d: int) -> tuple[int, int]:
    """What the list kernel's library says a table is sized by at depth
    d: (the most queries an entry may hold, the code rows a block
    scores). An entry's queries sit in a block's shared memory, each
    lane keeping one partial sum per query in registers."""
    max_m, rows = ctypes.c_int64(), ctypes.c_int64()
    load_score_library().score_int8_lists_limits(
        d, ctypes.byref(max_m), ctypes.byref(rows))
    if max_m.value < 1:
        raise ValueError(f"score_int8_lists holds no query of depth {d} "
                         f"in a block's shared memory")
    return max_m.value, rows.value


def lists_m_tile(d: int, device) -> int | None:
    """Queries a table entry may hold at depth d on `device`: the
    kernel's limit on the card; None (no cut) on the CPU, where the
    plain version runs."""
    if torch.device(device).type == "cpu":
        return None
    return lists_limits(d)[0]


def int8_lists_table(slices, m_tile: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """The work table of `score_int8_lists` for a plan of probed lists.

    `slices` holds (start, end, query ids) for each list, in the order of
    the flat output. A list's scores fill `m * (end - start)` floats of
    it, query by query, each query's row of scores contiguous; its
    queries are cut into entries of at most `m_tile` (None: one entry a
    list). Lists with no rows or no queries are skipped. Returns (table
    int64 [E, 5] of (start, rows, first query slot, queries, output
    offset), qidx int64 [A]: the query of each slot, total floats of the
    flat output)."""
    rows, qidx = [], []
    off = a = 0
    for s, e, qis in slices:
        ln, m = int(e) - int(s), len(qis)
        if ln <= 0 or m == 0:
            continue
        step = m_tile or m
        for c in range(0, m, step):
            rows.append((int(s), ln, a + c, min(step, m - c), off + c * ln))
        qidx.append(np.asarray(qis, np.int64))
        off += m * ln
        a += m
    table = np.array(rows, np.int64).reshape(-1, 5)
    return table, (np.concatenate(qidx) if qidx else
                   np.empty(0, np.int64)), off


def score_dot_reference(corpus: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """Plain version of `score_dot`: float32 queries . corpus^T, the
    counterpart of the reference's `jnp.dot(queries, corpus.T)`. On the
    card it follows `torch.backends.cuda.matmul.allow_tf32`, which a
    caller comparing float32 results keeps False."""
    return torch.matmul(queries, corpus.T)


def score_int8_reference(codes: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """Plain version of `score_int8`: float32 queries . float(codes)^T,
    the counterpart of `score_int8_xla` (`pallas_kernels.py:198`)."""
    return torch.matmul(queries, codes.to(torch.float32).T)


def score_int8_lists_reference(codes: torch.Tensor, queries: torch.Tensor,
                               table: np.ndarray, out: torch.Tensor, *,
                               qidx: np.ndarray | None = None,
                               scales: torch.Tensor | None = None,
                               cterm: np.ndarray | None = None
                               ) -> torch.Tensor:
    """Plain version of `score_int8_lists`: walks the same table entry by
    entry, `torch.matmul` of the entry's queries and its slice of codes,
    then `mul` by the rows' scales and `add` of the queries' terms, as
    the reference's `dots * scales + cent`."""
    dev = codes.device
    qi = None if qidx is None else torch.from_numpy(qidx).to(dev)
    ct = None if cterm is None else torch.from_numpy(cterm).to(dev)
    for s, ln, a, m, off in np.asarray(table).tolist():
        q = queries[a:a + m] if qi is None else \
            queries.index_select(0, qi[a:a + m])
        res = torch.matmul(q, codes[s:s + ln].to(torch.float32).T)
        if scales is not None:
            res = res.mul_(scales[s:s + ln])
        if ct is not None:
            res = res.add_(ct[a:a + m, None])
        out[off:off + m * ln].view(m, ln).copy_(res)
    return out


def _check_score(name: str, corpus: torch.Tensor, queries: torch.Tensor,
                 dtype: torch.dtype, out: torch.Tensor | None) -> None:
    if corpus.dtype != dtype or queries.dtype != torch.float32:
        raise TypeError(f"{name} takes {dtype} rows and float32 queries, "
                        f"got {corpus.dtype} and {queries.dtype}")
    if corpus.dim() != 2 or queries.dim() != 2 or \
            corpus.shape[1] != queries.shape[1]:
        raise ValueError(f"{name} takes rows [n, d] and queries [b, d], "
                         f"got {tuple(corpus.shape)} and "
                         f"{tuple(queries.shape)}")
    if corpus.device != queries.device:
        raise ValueError(f"rows on {corpus.device} but queries on "
                         f"{queries.device}")
    if corpus.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {corpus.device}")
    if not (corpus.is_contiguous() and queries.is_contiguous()):
        raise ValueError(f"{name} takes contiguous rows and queries")
    if out is not None:
        want = (queries.shape[0], corpus.shape[0])
        if out.dtype != torch.float32 or tuple(out.shape) != want:
            raise ValueError(f"out must be float32 {want}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        if out.device != corpus.device or not out.is_contiguous():
            raise ValueError("out must be contiguous on the rows' device")


def _into(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return res
    out.copy_(res)
    return out


def score_dot(corpus: torch.Tensor, queries: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """float32 scores queries . corpus^T: corpus float32[n, d], queries
    float32[b, d] -> float32[b, n], accumulated in float32 (no TF32).
    `out`, if given, is a contiguous [b, n] float32 tensor written in
    place. On CUDA tensors the kernel runs and `score_dot.launches`
    counts it; on CPU tensors the plain version runs."""
    _check_score("score_dot", corpus, queries, torch.float32, out)
    if corpus.device.type == "cpu":
        return _into(score_dot_reference(corpus, queries), out)
    n, d = corpus.shape
    b = queries.shape[0]
    if out is None:
        out = torch.empty((b, n), dtype=torch.float32, device=corpus.device)
    if n == 0 or b == 0:
        return out
    if d == 0:
        return out.zero_()
    err = load_score_library().score_dot_launch(
        corpus.data_ptr(), queries.data_ptr(), out.data_ptr(), n, b, d,
        torch.cuda.current_stream(corpus.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_dot kernel launch failed: CUDA error "
                           f"{err} (n={n}, b={b}, d={d})")
    score_dot.launches += 1
    return out


def lists_meta(table: np.ndarray, qidx: np.ndarray | None,
               cterm: np.ndarray | None, tile_rows: int
               ) -> tuple[np.ndarray, int, tuple[int, int, int]]:
    """What `score_int8_lists` uploads, in one int64 buffer: the table
    with a sixth column, each entry's first row tile of `tile_rows` rows
    (a prefix over the entries before); each row tile's entry (int32
    pairs); the slots' queries; their terms (float32 pairs). Returns
    (buffer, row tiles, word offsets of the tile entries, the queries
    and the terms)."""
    tiles = -(-table[:, 1] // tile_rows)
    n_tiles = int(tiles.sum())
    e = len(table)
    a = 0 if qidx is None else len(qidx)
    at_tiles = e * 6
    at_qidx = at_tiles + -(-n_tiles // 2)
    at_cterm = at_qidx + a
    meta = np.zeros(at_cterm + (0 if cterm is None else -(-a // 2)),
                    np.int64)
    full = meta[:at_tiles].reshape(e, 6)
    full[:, :5] = table
    full[1:, 5] = np.cumsum(tiles[:-1])
    meta[at_tiles:at_qidx].view(np.int32)[:n_tiles] = np.repeat(
        np.arange(e, dtype=np.int32), tiles)
    if qidx is not None:
        meta[at_qidx:at_cterm] = qidx
    if cterm is not None:
        meta[at_cterm:].view(np.float32)[:a] = cterm
    return meta, n_tiles, (at_tiles, at_qidx, at_cterm)


def _launch_lists(codes: torch.Tensor, queries: torch.Tensor,
                  table: np.ndarray, out: torch.Tensor,
                  qidx: np.ndarray | None, scales: torch.Tensor | None,
                  cterm: np.ndarray | None) -> bool:
    """One launch of the list kernel over a checked table, its
    `lists_meta` copied up once from pinned memory; False when the table
    holds no row to score (nothing launched)."""
    tile_rows = lists_limits(codes.shape[1])[1]
    meta, n_tiles, (at_tiles, at_qidx, at_cterm) = lists_meta(
        table, qidx, cterm, tile_rows)
    if n_tiles == 0:
        return False
    dev = codes.device
    meta_dev = torch.from_numpy(meta).pin_memory().to(dev, non_blocking=True)
    base = meta_dev.data_ptr()
    err = load_score_library().score_int8_lists_launch(
        codes.data_ptr(), queries.data_ptr(),
        None if scales is None else scales.data_ptr(), base,
        base + 8 * at_tiles, None if qidx is None else base + 8 * at_qidx,
        None if cterm is None else base + 8 * at_cterm,
        out.data_ptr(), n_tiles, tile_rows, codes.shape[1],
        int(table[:, 3].max()), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_int8_lists kernel launch failed: CUDA "
                           f"error {err} (entries={len(table)}, tiles="
                           f"{n_tiles}, d={codes.shape[1]})")
    return True


def score_int8(codes: torch.Tensor, queries: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """float32 scores queries . float(codes)^T: codes int8[n, d], queries
    float32[b, d] -> float32[b, n], the int8 converted to float32 in the
    kernel. `out` as for `score_dot`. On CUDA tensors the list kernel
    runs over one entry per `lists_m_tile(d, device)` queries covering
    all rows, with scale 1 and term 0 (exact), and `score_int8.launches`
    counts it; on CPU tensors the plain version runs."""
    _check_score("score_int8", codes, queries, torch.int8, out)
    if codes.device.type == "cpu":
        return _into(score_int8_reference(codes, queries), out)
    n, d = codes.shape
    b = queries.shape[0]
    if out is None:
        out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    if n == 0 or b == 0:
        return out
    if d == 0:
        return out.zero_()
    mt = lists_m_tile(d, codes.device)
    table = np.array([(0, n, a, min(mt, b - a), a * n)
                      for a in range(0, b, mt)], np.int64)
    if _launch_lists(codes, queries, table, out.view(-1), None, None, None):
        score_int8.launches += 1
    return out


def _check_lists(codes: torch.Tensor, queries: torch.Tensor,
                 table: np.ndarray, out: torch.Tensor,
                 qidx: np.ndarray | None, scales: torch.Tensor | None,
                 cterm: np.ndarray | None) -> None:
    _check_score("score_int8_lists", codes, queries, torch.int8, None)
    n, d = codes.shape
    b = queries.shape[0]
    if out.dtype != torch.float32 or out.dim() != 1 or \
            not out.is_contiguous() or out.device != codes.device:
        raise ValueError("out must be a contiguous 1-d float32 tensor on "
                         "the codes' device")
    if scales is not None and (
            scales.dtype != torch.float32 or tuple(scales.shape) != (n,)
            or not scales.is_contiguous() or scales.device != codes.device):
        raise ValueError(f"scales must be contiguous float32 [{n}] on the "
                         f"codes' device")
    if not isinstance(table, np.ndarray) or table.dtype != np.int64 or \
            table.ndim != 2 or table.shape[1] != 5:
        raise ValueError("table must be a numpy int64 [E, 5] array")
    slots = b
    if qidx is not None:
        if not isinstance(qidx, np.ndarray) or qidx.dtype != np.int64 or \
                qidx.ndim != 1:
            raise ValueError("qidx must be a numpy int64 [A] array")
        if len(qidx) and (qidx.min() < 0 or qidx.max() >= b):
            raise ValueError(f"qidx holds a query outside [0, {b})")
        slots = len(qidx)
    if cterm is not None and (
            not isinstance(cterm, np.ndarray) or cterm.dtype != np.float32
            or cterm.shape != (slots,)):
        raise ValueError(f"cterm must be a numpy float32 [{slots}] array")
    if not len(table):
        return
    s, ln, a, m, off = table.T
    if (s < 0).any() or (ln < 0).any() or (s + ln > n).any():
        raise ValueError(f"a table entry's rows lie outside [0, {n})")
    if (m < 1).any():
        raise ValueError("a table entry holds no query")
    mt = lists_m_tile(d, codes.device)
    if mt is not None and (m > mt).any():
        raise ValueError(f"a table entry holds more than the kernel's {mt} "
                         f"queries at depth {d}")
    if (a < 0).any() or (a + m > slots).any():
        raise ValueError(f"a table entry's query slots lie outside "
                         f"[0, {slots})")
    if (off < 0).any() or (off + m * ln > out.numel()).any():
        raise ValueError("a table entry's scores lie outside out")


def score_int8_lists(codes: torch.Tensor, queries: torch.Tensor,
                     table: np.ndarray, out: torch.Tensor, *,
                     qidx: np.ndarray | None = None,
                     scales: torch.Tensor | None = None,
                     cterm: np.ndarray | None = None) -> torch.Tensor:
    """A quantized search's approximate stage in one launch: for every
    entry (s, rows, a, m, off) of `table` (`int8_lists_table`), query
    slot a + j and code row s + r,

        out[off + j * rows + r] =
            dot(queries[qidx[a + j]], float(codes[s + r]))
            * scales[s + r] + cterm[a + j]

    rounded after the product and after the sum, as the reference. codes
    int8 [n, d] and queries float32 [b, d] on one device, out a flat
    float32 tensor there; table, qidx (None: slot a is query a) and
    cterm (None: 0) numpy on the host; scales (None: 1) float32 [n] on
    the device. On CUDA tensors the kernel runs once, and
    `score_int8.launches` counts it, unless the table holds no row; on
    CPU tensors the plain version runs."""
    _check_lists(codes, queries, table, out, qidx, scales, cterm)
    if codes.device.type == "cpu":
        return score_int8_lists_reference(codes, queries, table, out,
                                          qidx=qidx, scales=scales,
                                          cterm=cterm)
    if _launch_lists(codes, queries, table, out, qidx, scales, cterm):
        score_int8.launches += 1
    return out


score_dot.launches = 0
score_int8.launches = 0


def load_bitmap_library() -> ctypes.CDLL:
    """The word-AND kernel's library (`csrc/bitmap_and.cu`), built by
    nvcc at first use."""
    lib = _build.load("bitmap_and")
    fn = lib.bitmap_and_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def bitmap_and_reference(mats: torch.Tensor) -> torch.Tensor:
    """Plain version of `bitmap_and`: mats[0] & mats[1] & ... &
    mats[k-1], the reference's pairwise fold (`bitmap_and_device`,
    `dgraph_tpu/ops/setops.py:573`)."""
    out = mats[0].clone()
    for m in mats[1:]:
        out &= m
    return out


def bitmap_and(mats: torch.Tensor) -> torch.Tensor:
    """k-way AND of stacked bitmap word matrices: mats int64[k, B, W]
    -> int64[B, W] (each int64 holds the bits of one uint64 word; W is
    1024 for a 2^16-uid block). On CUDA tensors the kernel runs and
    `bitmap_and.launches` counts it; on CPU tensors the plain version
    runs."""
    if mats.dtype != torch.int64:
        raise TypeError(f"bitmap_and takes int64 words, got {mats.dtype}")
    if mats.dim() != 3 or mats.shape[0] == 0:
        raise ValueError(f"bitmap_and takes mats [k >= 1, B, W], got "
                         f"{tuple(mats.shape)}")
    if not mats.is_contiguous():
        raise ValueError("bitmap_and takes contiguous mats")
    if mats.device.type == "cpu":
        return bitmap_and_reference(mats)
    if mats.device.type != "cuda":
        raise ValueError(f"bitmap_and runs on cuda or cpu, not {mats.device}")
    k, b, w = mats.shape
    out = torch.empty((b, w), dtype=torch.int64, device=mats.device)
    if b * w == 0:
        return out
    err = load_bitmap_library().bitmap_and_launch(
        mats.data_ptr(), out.data_ptr(), k, b * w,
        torch.cuda.current_stream(mats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitmap_and kernel launch failed: CUDA error "
                           f"{err} (k={k}, B={b}, W={w})")
    bitmap_and.launches += 1
    return out


bitmap_and.launches = 0


def launch_counts() -> dict:
    """Each wrapper's launches in this process so far, by its name
    (`score_int8` counts `score_int8_lists` too): what a cluster alpha
    reports in its `stats` op."""
    return {f.__name__: f.launches for f in (
        bucket_or, bucket_or_level, score_dot, score_int8, bitmap_and)}
