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
- `score_int8` is the int8-code score of the quantized IVF tier
  (`csrc/score.cu`, replacing `score_int8_pallas`,
  `pallas_kernels.py:158`).
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

import torch

from dgraph_tpu_torch.ops import _build

# degree-axis length one block ORs before the row is split across
# blocks (and merged with atomicOr); long enough that a bucket of
# moderate degree runs without atomics, short enough that a hub row of
# millions of in-neighbours spreads over thousands of blocks
CHUNK = 256
# the grid's y dimension (chunks of one row) is at most 65535
_MAX_CHUNKS = 65535


def load_library() -> ctypes.CDLL:
    """The kernel's library, built by nvcc at first use."""
    lib = _build.load("bucket_or")
    fn = lib.bucket_or_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
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


def bucket_or_reference(f: torch.Tensor, in_nb: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: out[m] = OR_d f[in_nb[m, d]].

    Direct counterpart of `_gather_or` (`dgraph_tpu/ops/bitgraph.py:325`):
    ORs the gathered rows in chunks of <= 8 along the degree axis so no
    [M, D, W] intermediate is made, then reduces the chunks."""
    m, degree = in_nb.shape
    if degree == 0:
        res = torch.zeros((m, f.shape[1]), dtype=f.dtype, device=f.device)
    else:
        dc = next(c for c in (8, 6, 4, 3, 2, 1) if degree % c == 0)
        nb = in_nb.reshape(m * (degree // dc), dc).long()
        acc = f[nb[:, 0]]
        for d in range(1, dc):
            acc |= f[nb[:, d]]
        if degree > dc:
            acc = _or_reduce_dim1(acc.reshape(m, degree // dc, f.shape[1]))
        res = acc
    if out is None:
        return res
    out.copy_(res)
    return out


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


def load_score_library() -> ctypes.CDLL:
    """The scoring kernels' library (`csrc/score.cu`), built by nvcc at
    first use."""
    lib = _build.load("score")
    for fn in (lib.score_dot_launch, lib.score_int8_launch):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


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


def _score(name: str, corpus: torch.Tensor, queries: torch.Tensor,
           out: torch.Tensor | None) -> torch.Tensor:
    """Launch `<name>_launch` of the scoring library; the wrapper has
    checked its arguments."""
    n, d = corpus.shape
    b = queries.shape[0]
    if out is None:
        out = torch.empty((b, n), dtype=torch.float32, device=corpus.device)
    if n == 0 or b == 0:
        return out
    launch = getattr(load_score_library(), f"{name}_launch")
    err = launch(corpus.data_ptr(), queries.data_ptr(), out.data_ptr(),
                 n, b, d, torch.cuda.current_stream(corpus.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(n={n}, b={b}, d={d})")
    return out


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
    res = _score("score_dot", corpus, queries, out)
    if corpus.shape[0] and queries.shape[0]:
        score_dot.launches += 1
    return res


def score_int8(codes: torch.Tensor, queries: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """float32 scores queries . float(codes)^T: codes int8[n, d], queries
    float32[b, d] -> float32[b, n], the int8 converted to float32 in the
    kernel's tile. `out` as for `score_dot`. On CUDA tensors the kernel
    runs and `score_int8.launches` counts it; on CPU tensors the plain
    version runs."""
    _check_score("score_int8", codes, queries, torch.int8, out)
    if codes.device.type == "cpu":
        return _into(score_int8_reference(codes, queries), out)
    res = _score("score_int8", codes, queries, out)
    if codes.shape[0] and queries.shape[0]:
        score_int8.launches += 1
    return res


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
