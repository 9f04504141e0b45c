"""Hand-written CUDA kernels of the traversal plane, with their plain
PyTorch versions.

Counterpart of `dgraph_tpu/ops/pallas_kernels.py`. Bitmap words are
held as `torch.int32`, which has the bit pattern of the reference's
`uint32` words.

`bucket_or` is the gather-OR of one BFS level bucket
(`csrc/bucket_or.cu`, replacing `bucket_or_pallas`,
`pallas_kernels.py:38`). On a CUDA tensor it launches the kernel, or
raises; on a CPU tensor it runs `bucket_or_reference`, the plain
version, which the tests hold against the reference package.
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
