"""Sorted-UID vector operations: port of `dgraph_tpu/ops/uidvec.py`, the
counterpart of the reference's `algo/uidlist.go` (IntersectWith,
IntersectSorted, MergeSorted, Difference).

Representation
--------------
A UID set lives on the device as a tensor of static length in which the
valid UIDs are sorted ascending and every padding slot holds `SENTINEL`
(0xFFFFFFFF). The sentinel is the largest value, so the whole vector is
sorted, and every operation below relies on that: membership is a
binary search or a co-sort, compaction after masking is one sort, and a
k-way merge is concat + sort + adjacent-unique.

UIDs are uint32 values (a per-tablet 32-bit base, as in the reference),
held on the device as `torch.int64`: torch has no sort, searchsorted or
`<` on uint32, and int64 keeps every uint32 value, the sentinel
included, in its unsigned order, so each sort and comparison is exact.
(An int32 with the sign bit flipped would keep the order in half the
bytes, but every caller would then have to flip at each boundary.)
`from_numpy` and `to_numpy` convert at the numpy boundary, so the host
sees uint32 exactly as the reference returns it.

`intersect`, `difference` and `member_mask` take any number of leading
batch dimensions (the reference vmaps them): a [K, n] and a [K, m]
stack are K independent pairs. Sorts are `torch.sort(dim=-1,
stable=True)`, the counterpart of `jax.lax.sort`'s stable key sort; the
payloads of the reference's multi-operand sorts are gathered by the
sort's indices.

Membership and lookup have two arms, as in the reference: a binary
search (`torch.searchsorted`) and the co-sort (`sorted_lookup`,
`_member_mask_cosort`). The reference picks the co-sort on a TPU, where
its searchsorted lowers to a sequential scan. On the card
`torch.searchsorted` is one independent binary search per query thread,
so `member_mask` and `lookup_idx` take the binary search on every
device; both arms give the reference's values and stay callable.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.backend import resolve_device

SENTINEL = 0xFFFFFFFF
UID_DTYPE = torch.int64


def _ceil_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def pad_to(n: int, minimum: int = 8) -> int:
    """Bucketed padded length for a set of n UIDs: next power of two,
    floored at `minimum`."""
    return max(minimum, _ceil_pow2(n))


def from_numpy(uids: np.ndarray, size: int | None = None,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Host sorted uint32 UIDs -> padded int64 vector on `device` (the
    card unless told otherwise)."""
    uids = np.asarray(uids, dtype=np.uint32)
    if size is None:
        size = pad_to(len(uids))
    if len(uids) > size:
        raise ValueError(f"{len(uids)} uids exceed padded size {size}")
    out = np.full(size, SENTINEL, dtype=np.int64)
    out[: len(uids)] = uids
    return torch.from_numpy(out).to(resolve_device(device))


def to_numpy(vec: torch.Tensor) -> np.ndarray:
    """Padded vector -> compact host uint32 array (drops padding)."""
    arr = vec.cpu().numpy()
    return arr[arr != SENTINEL].astype(np.uint32)


def count(a: torch.Tensor) -> torch.Tensor:
    """Number of valid UIDs. Ref: codec.ExactLen (codec/codec.go:334)."""
    return (a != SENTINEL).sum(dtype=torch.int32)


def compact(a: torch.Tensor) -> torch.Tensor:
    """Re-establish the sorted/padded invariant after masking: one sort."""
    return torch.sort(a, dim=-1).values


def _shift_next(x: torch.Tensor, fill) -> torch.Tensor:
    """x[..., i + 1] with `fill` past the end."""
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _shift_prev(x: torch.Tensor, fill) -> torch.Tensor:
    """x[..., i - 1] with `fill` before the start."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def _member_mask_search(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The binary-search arm: a[i] valid and present in b."""
    if b.shape[-1] == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    idx = torch.searchsorted(b.contiguous(), a.contiguous())
    idx.clamp_(max=b.shape[-1] - 1)
    return (torch.gather(b, -1, idx) == a) & (a != SENTINEL)


def _cosort(a: torch.Tensor, b: torch.Tensor):
    """Stable key sort of concat(a, b) along the last axis: (sorted
    values, each row's original position, its origin flag: True for a
    rows)."""
    n = a.shape[-1]
    cs, ix = torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True)
    return cs, ix, ix < n


def _adjacent_hits(cs: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """a rows whose equal neighbour in the co-sort is a b row (valid
    because uid vectors are duplicate-free); sentinels excluded."""
    nxt, prv = _shift_next(cs, SENTINEL), _shift_prev(cs, SENTINEL)
    fnx, fpv = _shift_next(fs, True), _shift_prev(fs, True)
    return (((nxt == cs) & ~fnx) | ((prv == cs) & ~fpv)) \
        & fs & (cs != SENTINEL)


def _member_mask_cosort(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The co-sort arm (the reference's TPU path): one stable key sort of
    concat(a, b), the adjacency check, and a's order restored by
    scattering each a row's hit back to its original position."""
    n = a.shape[-1]
    cs, ix, fs = _cosort(a, b)
    hit = _adjacent_hits(cs, fs)
    # b rows scatter to slot n, one past every a row, and are cut off
    slot = torch.where(fs, ix, torch.full_like(ix, n))
    out = torch.zeros(a.shape[:-1] + (n + 1,), dtype=torch.bool,
                      device=a.device)
    out.scatter_(-1, slot, hit)
    return out[..., :n]


def member_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean mask over `a`: a[i] valid and present in `b` (both
    padded sorted vectors, with equal leading dimensions). Replaces the
    reference's per-pair lin/jump/bin switch (algo/uidlist.go:151-159)
    with the binary-search arm (see the module docstring)."""
    return _member_mask_search(a, b)


def sorted_lookup(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Left-insertion indices (int32) of SORTED queries `q` in sorted
    `table`, by the co-sort: in the stable key sort of concat(q, table),
    a q row's position minus its own q rank is the number of table
    elements strictly below it."""
    n = q.shape[-1]
    _, ix, fs = _cosort(q, table)
    pos = torch.arange(ix.shape[-1], device=ix.device).expand_as(ix)
    out = torch.zeros(q.shape[:-1] + (n + 1,), dtype=torch.int64,
                      device=q.device)
    out.scatter_(-1, torch.where(fs, ix, torch.full_like(ix, n)),
                 torch.where(fs, pos - ix, torch.zeros_like(ix)))
    return out[..., :n].to(torch.int32)


def lookup_idx(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """searchsorted(table, q) as int32, the reference's result type.

    PRECONDITION (as in the reference): `q` must be sorted ascending,
    the padded-sorted-uid-vector invariant, so that `sorted_lookup`
    gives the same indices. The binary search is taken on every device
    (module docstring)."""
    return torch.searchsorted(table.contiguous(), q.contiguous(),
                              out_int32=True)


def _cosort_hits(a: torch.Tensor, b: torch.Tensor):
    """One stable key sort of concat(a, b) with an origin flag, plus the
    adjacency hit mask for a rows (a[i] present in b): the building
    block of the fused set operations below. The co-sorted values are
    already ascending, so masking + one sort re-establishes the padded
    invariant."""
    cs, _, fs = _cosort(a, b)
    return cs, fs, _adjacent_hits(cs, fs)


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted-set intersection. Ref algo.IntersectWith
    (algo/uidlist.go:137). The result has a's static length; leading
    batch dimensions are independent pairs."""
    cs, _fs, hit = _cosort_hits(a, b)
    return compact(cs.masked_fill(~hit, SENTINEL))[..., : a.shape[-1]]


def difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a \\ b. Ref algo.Difference (algo/uidlist.go:322)."""
    cs, fs, hit = _cosort_hits(a, b)
    keep = fs & ~hit & (cs != SENTINEL)
    return compact(cs.masked_fill(~keep, SENTINEL))[..., : a.shape[-1]]


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted-set union with dedup. Ref algo.MergeSorted
    (algo/uidlist.go:354). Result length = |a| + |b| (static)."""
    return merge_many(torch.cat([a, b]).reshape(1, -1))


def merge_many(mat: torch.Tensor) -> torch.Tensor:
    """K-way merge + dedup of k padded rows -> one padded vector of
    length k*n: sort + adjacent-unique in place of the reference's
    uint64Heap loop (algo/uidlist.go:354, algo/heap.go:39)."""
    flat = torch.sort(mat.reshape(-1)).values
    first_occurrence = flat != _shift_prev(flat, SENTINEL)
    return compact(flat.masked_fill(~first_occurrence, SENTINEL))


def intersect_many(mat: torch.Tensor) -> torch.Tensor:
    """Intersection of the k padded rows of `mat`, folded pairwise. Ref
    algo.IntersectSorted (algo/uidlist.go:287)."""
    acc = mat[0]
    for i in range(1, mat.shape[0]):
        acc = intersect(acc, mat[i])
    return acc


def first_k(a: torch.Tensor, k: int, offset: int = 0) -> torch.Tensor:
    """Pagination: the k-wide window after `offset` of a compact-sorted
    vector, SENTINEL-padded when the window runs off the end, never
    clamped backwards. Ref algo.IndexOf-based windowing (query.go:2231)."""
    take = max(0, min(k, a.shape[0] - offset))
    pad = torch.full((k - take,), SENTINEL, dtype=a.dtype, device=a.device)
    if not take:
        return pad
    sl = a[offset: offset + take]
    return torch.cat([sl, pad]) if k > take else sl
