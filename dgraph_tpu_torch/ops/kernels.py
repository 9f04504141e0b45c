"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions.

Counterpart of `dgraph_tpu/ops/pallas_kernels.py`:

- `bucket_or` is the gather-OR of one BFS level bucket
  (`csrc/bucket_or.cu`, replacing `bucket_or_pallas`,
  `pallas_kernels.py:38`). Bitmap words are held as `torch.int32`,
  which has the bit pattern of the reference's `uint32` words.
- `score_dot` is the float32 similarity score of the exact vector tiers
  (`csrc/score.cu`, replacing `score_dot_pallas`,
  `pallas_kernels.py:123`), on one of two routes that
  `score_dot_plan` picks by the batch: a resident tile of 256 queries
  for large batches, a stream of corpus rows for a few queries.
  `score_metric` is the same kernel storing a metric's score (dot,
  euclidean or cosine, from the rows' norms it sums itself) with -inf in
  the padding and masked columns: the exact tiers' scores in one launch.
  `score_dot` is its "dot" with every column live. Both count their
  launches by metric in `score_metric.launches`.
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
against the reference package. Each wrapper but `score_dot` counts its
launches in `<wrapper>.launches`; `launch_counts()` gathers them.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from dgraph_tpu_torch.ops import _build

# requests served on concurrent threads launch kernels at once, and
# `+=` on an attribute reads and writes it apart: a count takes the lock
_COUNT_LOCK = threading.Lock()


def _count(wrapper, key: str | None = None) -> None:
    """One more launch of `wrapper`'s kernel (under `key`, for a wrapper
    that counts its launches by kind)."""
    with _COUNT_LOCK:
        if key is None:
            wrapper.launches += 1
        else:
            wrapper.launches[key] += 1

# bucket_or's plan (csrc/bucket_or.cu): a unit stages at most OR_SPAN
# in-neighbour indices (kSpan); degrees up to OR_ROW_MAX_D (kRowMaxD) take
# units of whole rows, larger ones units of OR_SPAN in-neighbours of one
# row
OR_SPAN = 256
OR_ROW_MAX_D = 16
# units a launch aims at when it can take fewer rows a unit: about three
# times the warps an H100 holds at once (132 SMs x 24)
OR_TARGET_UNITS = 8192
# in-neighbours one warp of bucket_or_level gathers: eight batches of 32,
# whose indices and masks it loads at once (kChunk in csrc/bucket_or.cu,
# which refuses another value); a longer row is split across warps
LEVEL_CHUNK = 256
# rows of a frontier bucket_or_level gathers from: its pair list packs a
# row and a segment into one 32-bit word
LEVEL_MAX_ROWS = 1 << 27


def load_library() -> ctypes.CDLL:
    """The gather-OR kernels' library (`csrc/bucket_or.cu`), built by nvcc
    at first use."""
    lib = _build.load("bucket_or")
    fn = lib.bucket_or_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 9 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.bucket_or_level_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 5 + \
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
               mask: torch.Tensor | None = None,
               skip: torch.Tensor | None = None) -> torch.Tensor:
    """OR_d f[in_nb[m, d]] -> [M, W]; with `mask`, each gathered row's
    segments whose mask bit is clear count as zero, and with `skip` [M]
    too those whose bit is set in skip[m].

    Direct counterpart of `_gather_or` (`dgraph_tpu/ops/bitgraph.py:325`):
    ORs the gathered rows in chunks of <= 8 along the degree axis so no
    [M, D, W] intermediate is made, then reduces the chunks."""
    m, degree = in_nb.shape
    width = f.shape[1]
    if degree == 0:
        return torch.zeros((m, width), dtype=f.dtype, device=f.device)

    dc = next(c for c in (8, 6, 4, 3, 2, 1) if degree % c == 0)
    nb = in_nb.reshape(m * (degree // dc), dc).long()
    if skip is not None:                # skip[m] for each row of nb
        skip = skip.repeat_interleave(degree // dc)

    def rows(i):
        r = f[i]
        if mask is not None:
            keep = mask[i] if skip is None else mask[i] & ~skip
            r &= _segment_fill(keep, width)
        return r

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


class OrPlan(NamedTuple):
    """How `bucket_or`'s kernel cuts one call (csrc/bucket_or.cu)."""
    vec: int            # words a vector load (4, 2 or 1)
    lanes: int          # lanes a group and vectors a tile, up to 32
    ntiles: int         # tiles a row (above 1 only with 32 lanes)
    rows_unit: int      # row units: rows a unit; 0 for chunk units
    chunk: int          # in-neighbours a chunk unit (D for row units)
    nchunks: int        # chunk units a row; > 1 splits every row
    units: int          # units of the launch, each on one tile
    scratch_words: int  # zeroed int32 words of the split rows, or 0


@functools.lru_cache(maxsize=4096)
def bucket_or_plan(m: int, degree: int, width: int, align: int) -> OrPlan:
    """The kernel's plan for in_nb [m, degree] over rows of `width`
    words (all >= 1), f and out aligned to `align` bytes: vectors of 16
    bytes where W and the pointers allow, else 8 or 4; groups as wide as
    a row's vectors, up to a warp, a wider row in tiles of 32 vectors."""
    if min(m, degree, width) < 1 or align not in (1, 2, 4, 8, 16):
        raise ValueError(f"bucket_or_plan takes positive m, degree and "
                         f"width and an alignment of 1 to 16 bytes, got "
                         f"{m}, {degree}, {width}, {align}")
    vec = next(v for v in (4, 2, 1)
               if width % v == 0 and align % (4 * v) == 0)
    wv = width // vec
    lanes = min(32, 1 << (wv - 1).bit_length())
    ntiles = -(-wv // lanes)
    if degree <= OR_ROW_MAX_D:
        # enough rows to give every group of a warp one, fewer where a
        # small bucket would leave the card short of units
        rows_unit = min(OR_SPAN // degree, 32,
                        max(32 // lanes, -(-m * ntiles // OR_TARGET_UNITS)))
        chunk, nchunks = degree, 1
        units = ntiles * -(-m // rows_unit)
    else:
        rows_unit, chunk = 0, OR_SPAN
        nchunks = -(-degree // chunk)
        units = ntiles * m * nchunks
    scratch = m * width + m * ntiles if nchunks > 1 else 0
    return OrPlan(vec, lanes, ntiles, rows_unit, chunk, nchunks, units,
                  scratch)


# bucket_or's split-row scratch, one a (device, stream), zeroed once: the
# kernel zeroes what it used, so calls on one stream, which run in order,
# find it zero with no fill before each launch
_OR_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}
_OR_SCRATCH_LOCK = threading.Lock()


def _or_scratch(words: int, device: torch.device,
                stream: torch.cuda.Stream) -> torch.Tensor:
    key = (stream.device_index, stream.cuda_stream)
    with _OR_SCRATCH_LOCK:
        buf = _OR_SCRATCH.get(key)
        if buf is None or buf.numel() < words:
            buf = _OR_SCRATCH[key] = torch.zeros(words, dtype=torch.int32,
                                                 device=device)
        return buf


def bucket_or(f: torch.Tensor, in_nb: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """OR of gathered frontier rows: f int32[rows, W], in_nb int32[M, D]
    -> int32[M, W] with out[m] = OR_d f[in_nb[m, d]].

    Every index must lie in [0, rows); the adjacency builders guarantee
    it (padding points at the dummy row N, which is all zeros). `out`,
    if given, is written in place: a contiguous [M, W] slice of a
    level's preallocated result. On CUDA tensors the kernel runs, one
    launch a call on `bucket_or_plan`'s cut (a row past OR_SPAN
    in-neighbours ORs its chunks into a scratch row that the launch
    leaves zero), and `bucket_or.launches` counts it; on CPU tensors the
    plain version runs."""
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
    plan = bucket_or_plan(m, degree, width,
                          math.gcd(f.data_ptr(), out.data_ptr(), 16))
    stream = torch.cuda.current_stream(f.device)
    scratch = None
    if plan.scratch_words:      # the split rows' OR, then their tickets
        scratch = _or_scratch(plan.scratch_words, f.device, stream)
    err = load_library().bucket_or_launch(
        f.data_ptr(), in_nb.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), m, degree, width,
        plan.vec, plan.lanes, plan.ntiles, plan.rows_unit, plan.chunk,
        plan.nchunks, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucket_or kernel launch failed: CUDA error "
                           f"{err} (M={m}, D={degree}, W={width}, {plan})")
    _count(bucket_or)
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


def _segment_bits(hits: torch.Tensor, saturated: bool) -> torch.Tensor:
    """bool [R, W] -> int32 [R], bit s set iff some word (or, saturated,
    every word inside W) of segment s is a hit. The bits are distinct, so
    an int32 sum is their OR."""
    r, width = hits.shape
    nseg = -(-width // segment_words(width))
    seg = _segment_of_word(width, hits.device)
    n = torch.zeros((r, nseg), dtype=torch.int32, device=hits.device)
    n.index_add_(1, seg, hits.to(torch.int32))
    if saturated:
        size = torch.bincount(seg, minlength=nseg).to(torch.int32)
        on = n == size
    else:
        on = n > 0
    bits = word_bits(hits.device)[:nseg]
    return (on.to(torch.int32) * bits).sum(dim=1, dtype=torch.int32)


def segment_masks(words: torch.Tensor) -> torch.Tensor:
    """Exact occupancy masks of bitmap rows: int32 [R, W] -> int32 [R],
    bit s set iff segment s (`segment_words(W)` words) of the row is
    non-zero."""
    return _segment_bits(words != 0, saturated=False)


def full_masks(words: torch.Tensor) -> torch.Tensor:
    """Exact saturation masks of bitmap rows: int32 [R, W] -> int32 [R],
    bit s set iff every word of segment s inside W is all ones (-1)."""
    return _segment_bits(words == -1, saturated=True)


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
                              rows=None, full=None, pairs=None) -> None:
    """Plain version of `bucket_or_level`, with the kernel's reading of
    the masks: a gathered row's segment whose bit in `mask` is clear
    counts as zero, as does a seed segment whose bit in `seeds_mask` is
    clear, and in place a segment whose bit in `full` is set. So a wrong
    mask gives the kernel's wrong answer here too; and as in the kernel,
    in place a full bit changes only where the new frontier is
    non-zero."""
    width = f.shape[1]
    skip = full if seeds is None else None
    reach = _gather_or(f, in_nb, mask, skip)
    if pairs is not None:
        listed = mask[in_nb.long()]
        sat = listed & skip[:, None] if skip is not None else \
            torch.zeros_like(listed)
        pairs += torch.stack([popcount_sum(listed), popcount_sum(sat)])
    if seeds is None:
        vis = visited
    else:
        vis = seeds & _segment_fill(seeds_mask, width)
    new = reach.bitwise_and_(~vis)
    res = [new, vis | new, segment_masks(new)]
    if full is not None:
        fl = full_masks(res[1])
        if skip is not None:            # only where visited changed
            changed = res[2]
            fl = (fl & changed) | (skip & ~changed)
        res.append(fl)
    for dst, src in zip((frontier, visited, out_mask, full), res):
        if rows is None:
            dst.copy_(src)
        else:
            dst[rows.long()] = src
    total += popcount_sum(new)


_LEVEL_ARGS = ("f", "mask", "in_nb", "frontier", "visited", "out_mask",
               "seeds", "seeds_mask", "rows", "full")


def _check_level(f, mask, in_nb, frontier, visited, out_mask, total, seeds,
                 seeds_mask, rows, full, pairs) -> None:
    # the digest calls this ~190 times a batch: plain loops over a tuple
    args = (f, mask, in_nb, frontier, visited, out_mask, seeds, seeds_mask,
            rows, full)
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
    for k, v, n in (("total", total, 1), ("pairs", pairs, 2)):
        if v is None:
            continue
        if v.dtype != torch.int64 or v.numel() != n:
            raise TypeError(f"{k} must be an int64 tensor of {n} "
                            f"element(s), got {v.dtype} {tuple(v.shape)}")
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"{k} on {v.device}, contiguous "
                             f"{v.is_contiguous()}, but f on {dev}")
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
            (m, width), (m,), (m,), (n_out,))
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
                    rows: torch.Tensor | None = None,
                    full: torch.Tensor | None = None,
                    pairs: torch.Tensor | None = None) -> None:
    """One bucket of a BFS level, fused with the digest's epilogue. For
    each row m of in_nb int32 [M, D], o = rows[m] (m without `rows`):

        reach          = OR_d f[in_nb[m, d]]
        frontier[o]    = reach & ~before[m]
        visited[o]     = before[m] | frontier[o]
        out_mask[o]    = segment_masks(frontier[o])
        total         += popcount(frontier[o])
        full[o]        = full_masks(visited[o])      (with `full`)

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

    `full` int32 [R'] ([M] in place) holds the output rows' exact
    saturation masks (`full_masks`). In place it is read first: a
    segment set in full[m] is not gathered for row m, which is exact,
    since every bit it could add is already in visited, and a row full in
    every segment gathers no row. Then it is updated where visited
    changed. At level 1 it is only written. `pairs` int64 [2], if
    given, gets the (in-neighbour, segment) pairs the occupancy masks
    list and those of them skipped as saturated.

    On CUDA tensors the kernel runs, one launch a call (a row of degree
    > LEVEL_CHUNK is split across warps, whose chunks OR into a zeroed
    scratch row; the row's last chunk runs its epilogue), and
    `bucket_or_level.launches` counts them; on CPU tensors the plain
    version runs."""
    _check_level(f, mask, in_nb, frontier, visited, out_mask, total, seeds,
                 seeds_mask, rows, full, pairs)
    kw = dict(seeds=seeds, seeds_mask=seeds_mask, rows=rows, full=full,
              pairs=pairs)
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
            total.data_ptr(), ptr(full), ptr(pairs), f.shape[0], m, degree,
            width, LEVEL_CHUNK, mode, stream)
        if err != 0:
            raise RuntimeError(f"bucket_or_level kernel launch failed: CUDA "
                               f"error {err} (M={m}, D={degree}, W={width}, "
                               f"mode={mode})")
        _count(bucket_or_level)

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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3
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


# score_dot's routes (csrc/score.cu): the tile route keeps a tile of
# DOT_TILE_Q queries in shared memory and suits large batches; the row
# route streams the corpus once for a few queries, a query tile of them a
# pass, each corpus row read by a group of lanes
DOT_TILE, DOT_ROWS = 0, 1
DOT_TILE_Q = 256
# floats of queries a row-route block holds (ROW_QFLOATS): a pass of q
# queries takes depth segments of DOT_ROW_QFLOATS // q floats
DOT_ROW_QFLOATS = 8192
# the row route's query tiles, each with the most lanes a row: the
# fastest of score_dot_sweep.py at (b, 262,144, 128); fewer lanes a row
# cost fewer shuffles a score as the queries grow
DOT_ROW_LANES = {1: 8, 2: 8, 4: 8, 8: 4, 16: 2, 32: 1}
# the largest batch the row route takes, above it the tile route: at
# (b, 262,144, 128) the row route won up to 41 queries and lost at 48
# (score_dot_sweep.py and chip_smoke.py's phase 9 on an H100); the tile
# route's time is flat in b up to 256
DOT_ROWS_MAX_B = 44
# the depth of a tile-route segment (DSEG): deeper rows take more launches
DOT_TILE_DSEG = 128
# what the last depth segment of a launch stores, by metric (EPI_* in
# csrc/score.cu): the dot, or the metric's score from the rows' norms
EPILOGUES = {"dot": 0, "euclidean": 1, "cosine": 2}


class DotPlan(NamedTuple):
    """How `score_dot`'s kernel runs one call (csrc/score.cu)."""
    route: int      # DOT_TILE or DOT_ROWS
    vec: int        # floats a corpus load: 4 (16 bytes) or 1
    q_tile: int     # queries a pass: DOT_TILE_Q, or a row-route tile
    lanes: int      # lanes reading one corpus row; 1 on the tile route


@functools.lru_cache(maxsize=4096)
def score_dot_plan(b: int, d: int, align: int) -> DotPlan:
    """The kernel's plan for b queries of depth d over a corpus aligned
    to `align` bytes: 16-byte loads where d and the corpus allow, else
    4-byte ones; the row route up to DOT_ROWS_MAX_B queries, in passes of
    the smallest query tile that holds them (of the largest above that),
    with lanes a row up to DOT_ROW_LANES and no wider than a depth
    segment's loads; the tile route above."""
    if min(b, d) < 1 or align not in (1, 2, 4, 8, 16):
        raise ValueError(f"score_dot_plan takes positive b and d and an "
                         f"alignment of 1 to 16 bytes, got {b}, {d}, "
                         f"{align}")
    vec = 4 if d % 4 == 0 and align == 16 else 1
    if b > DOT_ROWS_MAX_B:
        return DotPlan(DOT_TILE, vec, DOT_TILE_Q, 1)
    q_tile = next((t for t in DOT_ROW_LANES if t >= b), max(DOT_ROW_LANES))
    loads = -(-min(d, DOT_ROW_QFLOATS // q_tile) // vec)
    return DotPlan(DOT_ROWS, vec, q_tile,
                   min(1 << (loads - 1).bit_length(), DOT_ROW_LANES[q_tile]))


def dot_segment(plan: DotPlan) -> int:
    """Floats of depth one launch of `plan` takes: deeper rows are cut
    into segments, each a launch that adds to the one before."""
    if plan.route == DOT_TILE:
        return DOT_TILE_DSEG
    return DOT_ROW_QFLOATS // plan.q_tile


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
                 dtype: torch.dtype, out: torch.Tensor | None,
                 n_out: int | None = None) -> None:
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
        want = (queries.shape[0],
                corpus.shape[0] if n_out is None else n_out)
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


def score_metric_reference(corpus: torch.Tensor, queries: torch.Tensor,
                           metric: str, n_live: int, n_out: int,
                           mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version of `score_metric`: the plain dots, the metric's
    epilogue in the reference's operation order (`knn._epilogue`), the
    columns padded with -inf to n_out, then -inf in every column past
    n_live and where the mask is False."""
    # ops/knn imports this module, so its epilogue is looked up here
    from dgraph_tpu_torch.ops.knn import _epilogue
    n = corpus.shape[0]
    scores = _epilogue(score_dot_reference(corpus, queries), corpus,
                       queries, metric)
    if n_out != n:
        scores = torch.nn.functional.pad(scores, (0, n_out - n),
                                         value=-math.inf)
    invalid = torch.arange(n_out, device=corpus.device) >= n_live
    if mask is not None:
        invalid[:n_live] |= ~mask
    # in place: the scores are this call's own tensor
    return scores.masked_fill_(invalid[None, :], -math.inf)


def score_metric_bound(metric: str, corpus: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """float64 [b, n]: the most `score_metric`'s score of a live column
    may differ from its plain version's. Both sum the same float32
    products in another order: the dot within d * 2^-24 * sum_k |q_k c_k|
    (the reordering bound), each squared norm within 2 d 2^-24 of itself
    (positive terms, fused or not); then each version rounds each
    epilogue step once."""
    u = 2.0 ** -24
    q64, c64 = queries.double(), corpus.double()
    d = queries.shape[1]
    bound = d * u * (q64.abs() @ c64.abs().T)
    if metric == "dot":
        return bound
    dot = q64 @ c64.T
    q2, c2 = (q64 * q64).sum(1)[:, None], (c64 * c64).sum(1)[None, :]
    bq, bc = 2 * d * u * q2, 2 * d * u * c2
    if metric == "euclidean":
        return 2 * bound + bq + bc + 2 * u * (
            (q2 - 2 * dot).abs() + (q2 - 2 * dot + c2).abs())
    den = (q2 * c2).sqrt().clamp_min(1e-300)
    rel = 0.5 * (bq / q2.clamp_min(1e-300) + bc / c2.clamp_min(1e-300))
    return bound / den + (dot / den).abs() * (rel + 16 * u)


def _check_metric(corpus: torch.Tensor, queries: torch.Tensor, metric: str,
                  n_live: int, n_out: int, mask: torch.Tensor | None,
                  out: torch.Tensor | None) -> None:
    _check_score("score_metric", corpus, queries, torch.float32, out, n_out)
    if metric not in EPILOGUES:
        raise ValueError(f"score_metric takes a metric of "
                         f"{sorted(EPILOGUES)}, got {metric!r}")
    n = corpus.shape[0]
    if not 0 <= n_live <= n <= n_out:
        raise ValueError(f"score_metric takes 0 <= n_live <= rows <= "
                         f"n_out, got n_live {n_live}, {n} rows, n_out "
                         f"{n_out}")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (n_live,):
            raise ValueError(f"mask must be bool [{n_live}], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != corpus.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on the rows' device")


def score_metric(corpus: torch.Tensor, queries: torch.Tensor, metric: str,
                 n_live: int, n_out: int, mask: torch.Tensor | None = None,
                 *, out: torch.Tensor | None = None,
                 plan: DotPlan | None = None) -> torch.Tensor:
    """`metric`'s float32 scores, higher is better: corpus float32[n, d],
    queries float32[b, d] -> float32[b, n_out], n_out >= n, accumulated
    in float32 (no TF32). Column j < n holds the dot (metric "dot"), the
    cosine or the negated squared L2 distance of queries[i] and
    corpus[j], in the reference's float order (`knn._epilogue`), for each
    j < n_live that `mask` (bool [n_live], None: all) keeps; every other
    column is -inf. `out`, if given, is a contiguous [b, n_out] float32
    tensor written in place. On CUDA tensors the kernel runs once on
    `score_dot_plan`'s route (or on `plan`, to time one route against the
    other), summing the rows' norms from the values it loads and writing
    each score once, and `score_metric.launches[metric]` counts the call;
    on CPU tensors the plain version runs."""
    _check_metric(corpus, queries, metric, n_live, n_out, mask, out)
    if corpus.device.type == "cpu":
        return _into(score_metric_reference(corpus, queries, metric, n_live,
                                            n_out, mask), out)
    n, d = corpus.shape
    b = queries.shape[0]
    if out is None:
        out = torch.empty((b, n_out), dtype=torch.float32,
                          device=corpus.device)
    if b == 0 or n_out == 0:
        return out
    if n == 0 or d == 0:        # no product to sum: the plain version
        return out.copy_(score_metric_reference(corpus, queries, metric,
                                                n_live, n_out, mask))
    if plan is None:
        plan = score_dot_plan(b, d, math.gcd(corpus.data_ptr(), 16))
    epi = EPILOGUES[metric]
    part = None
    if epi != EPILOGUES["dot"] and d > dot_segment(plan):
        # the partial norms of a cut depth, two buffers taken in turn
        part = torch.empty(2 * (b + n), dtype=torch.float32,
                           device=corpus.device)
    err = load_score_library().score_dot_launch(
        corpus.data_ptr(), queries.data_ptr(), out.data_ptr(), n, b, d,
        *plan, epi, n_live, n_out, None if mask is None else mask.data_ptr(),
        None if part is None else part.data_ptr(),
        torch.cuda.current_stream(corpus.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_dot kernel launch failed: CUDA error "
                           f"{err} (n={n}, b={b}, d={d}, {plan}, {metric}, "
                           f"n_live={n_live}, n_out={n_out})")
    _count(score_metric, metric)
    return out


def score_dot(corpus: torch.Tensor, queries: torch.Tensor,
              out: torch.Tensor | None = None,
              plan: DotPlan | None = None) -> torch.Tensor:
    """float32 scores queries . corpus^T: corpus float32[n, d], queries
    float32[b, d] -> float32[b, n], `score_metric`'s "dot" with every
    column live (counted in `score_metric.launches["dot"]`)."""
    _check_score("score_dot", corpus, queries, torch.float32, out)
    n = corpus.shape[0]
    return score_metric(corpus, queries, "dot", n, n, out=out, plan=plan)


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
        _count(score_int8)
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
        _count(score_int8)
    return out


score_metric.launches = dict.fromkeys(EPILOGUES, 0)
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
    _count(bitmap_and)
    return out


bitmap_and.launches = 0


def launch_counts() -> dict:
    """Each wrapper's launches in this process so far, by its name, an int
    each (`score_int8` counts `score_int8_lists` too; `score_metric` one
    name a metric, `score_metric.cosine` and so on, `score_dot`'s calls
    under `score_metric.dot`): what a cluster alpha reports in its
    `stats` op."""
    counts = {f.__name__: f.launches for f in (
        bucket_or, bucket_or_level, score_int8, bitmap_and)}
    for metric, launches in score_metric.launches.items():
        counts[f"score_metric.{metric}"] = launches
    return counts
