"""Device-resident adjacency, expansion and value-order ops: port of
`dgraph_tpu/ops/graph.py`, the uid-vector (sorted-uid) plane that the
executor's order, page, range and expansion tiers call.

A predicate's edges live on the device as degree-bucketed padded
neighbour matrices. One call expands a whole frontier level:

    rows    = searchsorted(bucket.src, frontier)        (vectorised lookup)
    cand    = bucket.neighbors[rows]                    (one batched gather)
    next    = sort + unique(concat over buckets)        (merge)

A source lands in the bucket whose width is the next power of two at or
above its degree, so padding stays under 2x and each bucket's gather is
a dense [F, D] tile.

Value postings (order-by and inequalities) live as int32 ranks into a
host table of sorted unique int64 keys, in two aligned views: by uid
(gather a candidate's rank) and by rank (range select).

Conventions of the port (`ops/uidvec.py`): uids are int64 tensors that
hold uint32 values, padding is SENTINEL (0xFFFFFFFF); ranks are int32.
The reference's `jax.jit` statics (`descs`, `window`, `shift`, the view
forms) are plain Python values here. Its multi-operand
`jax.lax.sort(..., num_keys=k)` becomes `_sort_uids_by`: the last rank
column and the uid packed into one int64 key, then one stable sort per
further column, last key first. Every operand is a key, so the order is
total and equals the reference's element for element. The fused page's
bucket arithmetic stays int32, so it wraps where the reference wraps.
Packed outputs (`[page..., start]` and the like) are int64 tensors
holding the reference's uint32 words.

`adjacency_from_arrays` and `values_from_arrays` build the port's tiles
from a reference `DeviceAdjacency` or `DeviceValues` read out as numpy,
so both implementations can run on the same state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch.backend import resolve_device
from dgraph_tpu_torch.ops.uidvec import (
    SENTINEL, compact, lookup_idx, member_mask, pad_to,
)

_U32 = 0xFFFFFFFF


@dataclass
class AdjBucket:
    """One degree class of a predicate's adjacency."""

    src: torch.Tensor        # [M] int64 uids, sorted, SENTINEL padded
    neighbors: torch.Tensor  # [M, D] int64 uids, SENTINEL padded
    degree: int              # D


@dataclass
class DeviceAdjacency:
    """A predicate's full edge set on the device. src_uids/degrees give
    the per-uid count lookup (`count_gather`)."""

    src_uids: torch.Tensor   # [N] int64 uids, sorted, SENTINEL padded
    degrees: torch.Tensor    # [N] int32 aligned to src_uids
    buckets: list[AdjBucket] = field(default_factory=list)
    n_edges: int = 0
    n_dst: int = 0           # distinct destination uids (bounds any union)
    n_src: int = 0           # real (unpadded) source count

    @property
    def shape_sig(self):
        return (self.src_uids.shape[0],
                tuple((b.src.shape[0], b.degree) for b in self.buckets))


def _count_distinct(values: np.ndarray) -> int:
    """len(np.unique(values)) by one sort and a neighbour compare."""
    if not len(values):
        return 0
    s = np.sort(values)
    return int(np.count_nonzero(s[1:] != s[:-1])) + 1


def _padded_uids(uids: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.full(n_pad, SENTINEL, np.int64)
    out[: len(uids)] = uids
    return out


def build_adjacency(edges: dict[int, np.ndarray],
                    min_degree_bucket: int = 8,
                    device: str | torch.device | None = None
                    ) -> DeviceAdjacency:
    """Host {src_uid -> sorted dst uint32 array} -> DeviceAdjacency on
    `device` (the card unless told otherwise).

    The reference fills each bucket row by row; here every edge lands in
    one numpy scatter into a flat buffer that holds all buckets back to
    back, copied to the device at once and cut into per-bucket views.
    The arrays equal the reference's."""
    dev = resolve_device(device)
    srcs = np.fromiter(edges.keys(), dtype=np.uint32, count=len(edges))
    srcs = srcs[np.argsort(srcs, kind="stable")]
    rows = [np.asarray(edges[int(s)]) for s in srcs]
    n = len(srcs)
    degs = np.fromiter((len(r) for r in rows), dtype=np.int32, count=n)

    n_pad = pad_to(n)
    deg_pad = np.zeros(n_pad, np.int32)
    deg_pad[:n] = degs
    n_edges = int(degs.sum())
    n_dst = 0
    buckets: list[AdjBucket] = []
    if n:
        allv = np.concatenate(rows)
        n_dst = _count_distinct(allv)
        caps = np.maximum(min_degree_bucket, 2 ** np.ceil(np.log2(
            np.maximum(degs, 1))).astype(np.int64))
        ucaps, bid = _unique_inverse(caps)
        # each source's row inside its bucket: its rank among the sources
        # of its bucket, in ascending uid order
        by_b = np.argsort(bid, kind="stable")
        counts = np.bincount(bid, minlength=len(ucaps))
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        row = np.empty(n, np.int64)
        row[by_b] = np.arange(n) - np.repeat(first, counts)
        m_pads = np.asarray([pad_to(int(c)) for c in counts], np.int64)
        sizes = m_pads * ucaps
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat = np.full(int(sizes.sum()), SENTINEL, np.int64)
        starts = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)[:-1]])
        esrc = np.repeat(np.arange(n), degs)
        col = np.arange(n_edges, dtype=np.int64) - starts[esrc]
        tgt = base[bid[esrc]] + row[esrc] * caps[esrc] + col
        flat[tgt] = allv.astype(np.uint32)
        flat_d = torch.from_numpy(flat).to(dev)
        for j, cap in enumerate(ucaps.tolist()):
            sel = srcs[by_b[first[j]: first[j] + counts[j]]]
            m = int(m_pads[j])
            nb = flat_d[int(base[j]): int(base[j]) + m * cap].view(m, cap)
            buckets.append(AdjBucket(
                torch.from_numpy(_padded_uids(sel, m)).to(dev), nb, cap))
    return DeviceAdjacency(torch.from_numpy(_padded_uids(srcs, n_pad)).to(dev),
                           torch.from_numpy(deg_pad).to(dev), buckets,
                           n_edges, n_dst, n)


def adjacency_from_arrays(d: dict[str, np.ndarray],
                          device: str | torch.device | None = None
                          ) -> DeviceAdjacency:
    """A DeviceAdjacency from the reference's arrays read out as numpy.

    Keys: `src_uids`, `degrees`, `n_edges`, `n_dst`, `n_src`, and for
    each bucket i `buckets.{i}.src`, `buckets.{i}.neighbors` and
    `buckets.{i}.degree`."""
    dev = resolve_device(device)

    def uids(a):
        return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)
                                ).to(dev)

    buckets = []
    i = 0
    while f"buckets.{i}.src" in d:
        buckets.append(AdjBucket(uids(d[f"buckets.{i}.src"]),
                                 uids(d[f"buckets.{i}.neighbors"]),
                                 int(d[f"buckets.{i}.degree"])))
        i += 1
    return DeviceAdjacency(
        uids(d["src_uids"]),
        torch.from_numpy(np.array(d["degrees"], np.int32)).to(dev),
        buckets, int(d["n_edges"]), int(d["n_dst"]), int(d["n_src"]))


def _rows(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int32 lookup indices clipped into [0, size - 1], as int64."""
    return idx.long().clamp_(0, size - 1)


def _bucket_candidates(frontier: torch.Tensor, b: AdjBucket) -> torch.Tensor:
    """Flat (unsorted, SENTINEL-masked) neighbour candidates of the
    `frontier` rows present in bucket `b`.

    Two duals of the same lookup, chosen by shape:
      frontier no larger than bucket -> gather a row per frontier uid
                                        ([F, D] work)
      bucket smaller than frontier   -> mask the bucket rows that appear
                                        in the frontier ([M, D] work)"""
    F = frontier.shape[0]
    M = b.src.shape[0]
    if F <= M:
        idx = _rows(lookup_idx(b.src, frontier), M)
        hit = (b.src[idx] == frontier) & (frontier != SENTINEL)
        cand = b.neighbors[idx].masked_fill_(~hit[:, None], SENTINEL)
    else:
        hit = member_mask(b.src, frontier)
        cand = b.neighbors.masked_fill(~hit[:, None], SENTINEL)
    return cand.reshape(-1)


def _pad_or_cut(v: torch.Tensor, size: int) -> torch.Tensor:
    if v.shape[0] >= size:
        return v[:size]
    return torch.cat([v, v.new_full((size - v.shape[0],), SENTINEL)])


def expand(adj: DeviceAdjacency, frontier: torch.Tensor,
           out_size: int) -> torch.Tensor:
    """One BFS level: the union of the neighbours of `frontier` (sorted,
    SENTINEL padded) as a padded sorted uid vector of length `out_size`,
    truncated when the union is larger (size it with `max_expansion`)."""
    parts = [_bucket_candidates(frontier, b) for b in adj.buckets]
    if not parts:
        return torch.full((out_size,), SENTINEL, dtype=torch.int64,
                          device=adj.src_uids.device)
    flat = torch.sort(torch.cat(parts)).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[1:] = flat[1:] == flat[:-1]
    return _pad_or_cut(compact(flat.masked_fill_(dup, SENTINEL)), out_size)


def max_expansion(adj: DeviceAdjacency, frontier_size: int) -> int:
    """Bound on expand()'s output size for a frontier of F uids: the
    union never exceeds the distinct-destination count, nor the
    per-bucket work bound."""
    total = sum(min(b.src.shape[0], frontier_size) * b.degree
                for b in adj.buckets)
    cap = pad_to(adj.n_dst or adj.n_edges)
    return max(8, min(total, cap))


def count_gather(adj: DeviceAdjacency, uids: torch.Tensor) -> torch.Tensor:
    """Per-uid out-degree (int32; 0 for uids without the predicate);
    `uids` must be sorted."""
    idx = _rows(lookup_idx(adj.src_uids, uids), adj.src_uids.shape[0])
    hit = (adj.src_uids[idx] == uids) & (uids != SENTINEL)
    return torch.where(hit, adj.degrees[idx], 0)


def has_uids(adj: DeviceAdjacency) -> torch.Tensor:
    """All uids carrying this predicate: the has() root function."""
    return adj.src_uids


# -- value postings ----------------------------------------------------------


# the device holds order-preserving int32 ranks into the host's sorted
# unique-key table; absent values hold RANK_MISSING
RANK_MISSING = np.int32(2**31 - 1)
_MISSING = int(RANK_MISSING)


@dataclass
class DeviceValues:
    """A scalar predicate's sortable view: aligned (uid -> key rank) plus
    the rank-sorted permutation for range scans."""

    uids: torch.Tensor           # [N] int64 uids, sorted, SENTINEL padded
    ranks: torch.Tensor          # [N] int32 aligned (pad = RANK_MISSING)
    ranks_sorted: torch.Tensor   # [N] int32 sorted
    uids_by_key: torch.Tensor    # [N] int64 uids aligned to ranks_sorted
    host_keys: np.ndarray        # [U] int64 sorted unique raw keys (host)
    n: int = 0                   # real (unpadded) uid count
    # dense uid -> rank table when the uid span is compact (span <=
    # max(2^20, 4n)): rank_lut[uid - lut_base] == rank, holes hold
    # RANK_MISSING; one indexed load per candidate instead of a search
    rank_lut: torch.Tensor | None = None   # int32
    lut_base: torch.Tensor | None = None   # 0-d int64 holding a uint32


# uid-span budget multiplier and floor for materialising rank_lut
_LUT_SPAN_FLOOR = 1 << 20
_LUT_SPAN_MULT = 4


def _unique_inverse(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(k, return_inverse=True) by one stable argsort."""
    order = np.argsort(k, kind="stable")
    sk = k[order]
    first = np.ones(len(k), bool)
    first[1:] = sk[1:] != sk[:-1]
    inv = np.empty(len(k), np.int64)
    inv[order] = np.cumsum(first) - 1
    return sk[first], inv


def build_values(pairs: dict[int, int],
                 device: str | torch.device | None = None) -> DeviceValues:
    """Host {uid -> int64 sort key} -> DeviceValues on `device` (the card
    unless told otherwise). Takes the LUT form exactly where the
    reference does."""
    dev = resolve_device(device)
    n = len(pairs)
    n_pad = pad_to(n)
    uids = np.full(n_pad, SENTINEL, np.uint32)
    ranks = np.full(n_pad, RANK_MISSING, np.int32)
    host_keys = np.empty(0, np.int64)
    lut = base = None
    if n:
        u = np.fromiter(pairs.keys(), dtype=np.uint32, count=n)
        k = np.fromiter(pairs.values(), dtype=np.int64, count=n)
        order = np.argsort(u, kind="stable")
        host_keys, inv = _unique_inverse(k)
        uids[:n] = u[order]
        ranks[:n] = inv[order].astype(np.int32)
        umin = int(u.min())
        span = int(u.max()) - umin + 1
        if span <= max(_LUT_SPAN_FLOOR, _LUT_SPAN_MULT * n):
            table = np.full(pad_to(span), RANK_MISSING, np.int32)
            table[u - np.uint32(umin)] = inv.astype(np.int32)
            lut = torch.from_numpy(table).to(dev)
            base = torch.tensor(umin, dtype=torch.int64, device=dev)
    by_key = np.lexsort((uids, ranks))
    return _values(uids, ranks, ranks[by_key], uids[by_key], host_keys, n,
                   lut, base, dev)


def _values(uids, ranks, ranks_sorted, uids_by_key, host_keys, n, lut, base,
            dev) -> DeviceValues:
    def u(a):
        return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)
                                ).to(dev)

    def r(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    return DeviceValues(u(uids), r(ranks), r(ranks_sorted), u(uids_by_key),
                        np.asarray(host_keys, np.int64), int(n), lut, base)


def values_from_arrays(d: dict[str, np.ndarray],
                       device: str | torch.device | None = None
                       ) -> DeviceValues:
    """A DeviceValues from the reference's arrays read out as numpy.

    Keys: `uids`, `ranks`, `ranks_sorted`, `uids_by_key`, `host_keys`,
    `n`, and `rank_lut` and `lut_base` where the reference has them."""
    dev = resolve_device(device)
    lut = base = None
    if d.get("rank_lut") is not None:
        lut = torch.from_numpy(np.array(d["rank_lut"], np.int32)).to(dev)
        base = torch.tensor(int(np.uint32(d["lut_base"])), dtype=torch.int64,
                            device=dev)
    return _values(d["uids"], d["ranks"], d["ranks_sorted"], d["uids_by_key"],
                   d["host_keys"], d["n"], lut, base, dev)


def dv_view(dv: DeviceValues) -> tuple[tuple[torch.Tensor, torch.Tensor],
                                       bool]:
    """(payload, is_lut) for view_ranks: the dense-LUT form when the
    table carries one, else the binary-search form. The bool is part of
    the caller's static key."""
    if dv.rank_lut is not None:
        return (dv.rank_lut, dv.lut_base), True
    return (dv.uids, dv.ranks), False


def view_ranks(cand: torch.Tensor, view: tuple[torch.Tensor, torch.Tensor],
               is_lut: bool, valid: torch.Tensor) -> torch.Tensor:
    """int32 ranks aligned to candidate uids from a dv_view payload;
    absent or invalid candidates get RANK_MISSING. The LUT form is one
    gather; the search form binary-searches the sorted uid plane (cand
    must be sorted)."""
    if is_lut:
        lut, lbase = view
        size = lut.shape[0]
        # the reference's uint32 offset: a candidate below the base wraps
        # to a huge value and falls out of range
        off = (cand - lbase) & _U32
        in_range = valid & (off < size)
        return torch.where(in_range, lut[off.clamp(0, size - 1)], _MISSING)
    du, dr = view
    idx = _rows(lookup_idx(du, cand), du.shape[0])
    hit = (du[idx] == cand) & valid
    return torch.where(hit, dr[idx], _MISSING)


def key_gather(dv: DeviceValues, uids: torch.Tensor,
               missing: int = _MISSING) -> torch.Tensor:
    """Sort-key ranks (int32) for candidate uids; `missing` for absent
    ones. `uids` must be sorted."""
    idx = _rows(lookup_idx(dv.uids, uids), dv.uids.shape[0])
    hit = (dv.uids[idx] == uids) & (uids != SENTINEL)
    return torch.where(hit, dv.ranks[idx], missing)


def range_select(dv: DeviceValues, lo, hi,
                 lo_open: bool = False, hi_open: bool = False
                 ) -> torch.Tensor:
    """UIDs whose raw key is in [lo, hi] (open per flags): the le/lt/ge/
    gt/between root functions as one mask and compact. Raw int64 bounds
    become rank bounds on the host."""
    lo_rank = int(np.searchsorted(dv.host_keys, np.int64(lo),
                                  side="right" if lo_open else "left"))
    hi_rank = int(np.searchsorted(dv.host_keys, np.int64(hi),
                                  side="left" if hi_open else "right"))
    rs = dv.ranks_sorted
    keep = (rs >= lo_rank) & (rs < hi_rank) & (dv.uids_by_key != SENTINEL)
    return compact(dv.uids_by_key.masked_fill(~keep, SENTINEL))


def _sort_uids_by(cols: list[torch.Tensor], uids: torch.Tensor
                  ) -> torch.Tensor:
    """`uids` reordered by the keys (cols..., uids) lexicographically:
    the reference's `jax.lax.sort(tuple(cols) + (uids,),
    num_keys=len(cols) + 1)[-1]`. The last int32 column and the uid
    (< 2^32) pack into one int64 key; each earlier column takes one
    stable sort, last key first."""
    key = uids if not cols else (cols[-1].long() << 32) | uids
    perm = torch.sort(key, stable=True).indices
    for c in reversed(cols[:-1]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return uids[perm]


def _rank_cols(cand: torch.Tensor, dv_uids: tuple, dv_ranks: tuple,
               descs: tuple) -> list[torch.Tensor]:
    """Per-order-attribute int32 rank columns aligned with `cand`
    (missing values keep RANK_MISSING, so they sink last under asc and
    desc)."""
    cols = []
    valid = cand != SENTINEL
    for du, dr, desc in zip(dv_uids, dv_ranks, descs):
        idx = _rows(lookup_idx(du, cand), du.shape[0])
        hit = (du[idx] == cand) & valid
        ranks = dr[idx]
        cols.append(torch.where(hit, -ranks if desc else ranks, _MISSING))
    return cols


def multisort(cand: torch.Tensor, dv_uids: tuple, dv_ranks: tuple,
              descs: tuple) -> torch.Tensor:
    """Stable multi-key order-by: each order attribute's rank column for
    the (sorted, SENTINEL-padded) candidates as leading keys and the uid
    as the final tiebreak. Missing values sink last under asc and desc;
    SENTINEL padding sinks below real uids."""
    return _sort_uids_by(_rank_cols(cand, dv_uids, dv_ranks, descs), cand)


def _i32(x, device) -> torch.Tensor:
    """A 0-d int32 tensor of `x` (a Python int or a tensor), wrapped as
    the reference's int32 casts wrap."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(np.int64(x).astype(np.int32), device=device)


def _window_at(v: torch.Tensor, start: torch.Tensor, window: int
               ) -> torch.Tensor:
    """`jax.lax.dynamic_slice` of v padded by `window` SENTINELs: the
    `window` slots from `start`, clamped into [0, len(v)]."""
    ext = torch.cat([v, v.new_full((window,), SENTINEL)])
    s = start.long().clamp(0, v.shape[0])
    return ext[s + torch.arange(window, device=v.device)]


def _page_slice(suids: torch.Tensor, after_uid, offset, window: int,
                limit=None):
    """The shared paging tail: after-cursor position -> start -> the
    `window` slice. A cursor found at or past `limit` counts as absent.
    Returns the page and the unclamped int32 start."""
    after = (torch.as_tensor(after_uid, device=suids.device).long() & _U32)
    hit_after = suids == after
    pos = torch.argmax(hit_after.to(torch.uint8)).to(torch.int32)
    found = hit_after.any()
    if limit is not None:
        found = found & (pos < limit)
    start = torch.where(found, pos + 1, 0).to(torch.int32) + \
        _i32(offset, suids.device)
    return _window_at(suids, start, window), start


def _words(*xs: torch.Tensor) -> torch.Tensor:
    """Scalars as the reference's trailing uint32 words of a packed
    output."""
    return torch.stack([x.long() & _U32 for x in xs])


def multisort_page(cand: torch.Tensor, dv_uids: tuple, dv_ranks: tuple,
                   descs: tuple, window: int, after_uid, offset
                   ) -> torch.Tensor:
    """multisort + after-cursor + offset + first in one call, returning
    only the `window`-sized page, packed as [page..., start]: `start` is
    the unclamped index the page begins at in the sorted stream (the
    host derives the valid length as clip(n_real - start, 0, window)).
    An absent after-cursor (uid 0) skips nothing."""
    suids = multisort(cand, dv_uids, dv_ranks, descs)
    page, start = _page_slice(suids, after_uid, offset, window)
    return torch.cat([page, _words(start)])


def count_filter_sort_page(cand: torch.Tensor, degrees: torch.Tensor,
                           lo, hi, dv_uids: tuple, dv_ranks: tuple,
                           descs: tuple, window: int, after_uid, offset
                           ) -> torch.Tensor:
    """has(A) root + count(A) band filter + order + page in one call over
    the predicate's resident adjacency (cand = adj.src_uids, degrees
    aligned). Filtered-out uids sink below even missing-value uids by a
    leading exclusion key; a cursor uid the filter excluded counts as
    absent. Packed as [page..., start, n_kept]."""
    dev = cand.device
    keep = (degrees >= _i32(lo, dev)) & (degrees <= _i32(hi, dev)) & \
        (cand != SENTINEL)
    excl = (~keep).to(torch.int32)
    cols = [excl] + _rank_cols(cand, dv_uids, dv_ranks, descs)
    suids = _sort_uids_by(cols, cand)
    n_kept = keep.sum(dtype=torch.int32)
    page, start = _page_slice(suids, after_uid, offset, window, limit=n_kept)
    return torch.cat([page, _words(start, n_kept)])


# The fused whole-block kernel's selection geometry: candidates bucket
# into FUSED_SEL_BUCKETS primary-rank buckets and at most FUSED_SEL_CAP
# survivors reach the exact multi-key sort. A page that cannot be proven
# inside the cap reports sel_count > cap and the caller re-runs the
# staged chain.
FUSED_SEL_BUCKETS = 4096
FUSED_SEL_CAP = 4096


def _leaf_op(m: torch.Tensor, neg: bool) -> torch.Tensor:
    return ~m if neg else m


def fused_rank_page(cand: torch.Tensor,
                    rank_views: tuple, rank_luts: tuple,
                    rank_los: tuple, rank_his: tuple, rank_negs: tuple,
                    fparts: tuple, set_negs: tuple, set_aligned: bool,
                    fop: str,
                    ord_views: tuple, ord_luts: tuple, descs: tuple,
                    base0, shift: int, window: int, offset
                    ) -> torch.Tensor:
    """Whole-block chain (filter algebra + multi-key order + offset/first
    page) in one call: the fused tier's program.

    Filter leaves fold under `fop` ("none" | "and" | "or") with per-leaf
    negation: rank leaves are dv_view payloads with [lo, hi) rank
    bounds; set leaves are bool masks aligned to cand (`set_aligned`) or
    sorted padded uid vectors tested for membership.

    Kept candidates bucket by the desc-adjusted primary rank (missing
    ranks just past the real ones); a 13-step binary search of masked
    int32 sums finds the bucket threshold covering offset + window rows;
    survivors compact by cumsum + searchsorted + gather; at most
    FUSED_SEL_CAP survivors take the exact multi-key sort. Packed as
    [page..., sel_count, n_kept]; sel_count > FUSED_SEL_CAP means the
    boundary tie mass overflowed the cap."""
    dev = cand.device
    valid = cand != SENTINEL
    masks = []
    for view, is_lut, lo, hi in zip(rank_views, rank_luts, rank_los,
                                    rank_his):
        r = view_ranks(cand, view, is_lut, valid)
        masks.append((r != _MISSING) & (r >= _i32(lo, dev)) &
                     (r < _i32(hi, dev)))
    for fp in fparts:
        masks.append((fp & valid) if set_aligned else member_mask(cand, fp))
    negs = tuple(rank_negs) + tuple(set_negs)
    if fop == "and":
        keep = valid
        for m, neg in zip(masks, negs):
            keep = keep & _leaf_op(m, neg)
    elif fop == "or":
        hit = torch.zeros(cand.shape[0], dtype=torch.bool, device=dev)
        for m, neg in zip(masks, negs):
            hit = hit | _leaf_op(m, neg)
        keep = valid & hit
    else:
        keep = valid
    keep = keep & valid  # a negated leaf must never resurrect padding
    n_kept = keep.sum(dtype=torch.int32)

    # int32 throughout, wrapping where the reference wraps
    nb = FUSED_SEL_BUCKETS
    base0 = _i32(base0, dev)
    c0 = view_ranks(cand, ord_views[0], ord_luts[0], valid)
    if descs[0]:
        c0 = torch.where(c0 == _MISSING, c0, -c0)
    miss0 = c0 == _MISSING
    b = ((torch.where(miss0, base0, c0) - base0) >> shift).clamp(0, nb - 1)
    b = torch.where(miss0, nb, b)
    b = torch.where(keep, b, nb + 1)
    # the smallest bucket threshold covering offset + window kept rows, by
    # an unrolled binary search of masked sums
    target = _i32(offset, dev) + window
    lo_t = torch.zeros((), dtype=torch.int32, device=dev)
    hi_t = torch.full((), nb, dtype=torch.int32, device=dev)
    for _ in range(FUSED_SEL_BUCKETS.bit_length()):
        open_ = lo_t < hi_t
        mid = (lo_t + hi_t) >> 1
        pred = (b <= mid).sum(dtype=torch.int32) >= target
        hi_t = torch.where(open_ & pred, mid, hi_t)
        lo_t = torch.where(open_ & ~pred, mid + 1, lo_t)
    sel = keep & (b <= lo_t)
    # scatter-free compaction: survivor o (1-based) sits at the first
    # index whose selection prefix sum reaches o
    pos = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32)
    sel_count = pos[-1]
    ords = torch.arange(1, FUSED_SEL_CAP + 1, dtype=torch.int32, device=dev)
    sidx = torch.searchsorted(pos, ords, side="left").clamp_(
        0, cand.shape[0] - 1)
    out_u = torch.where(ords <= sel_count, cand[sidx], SENTINEL)
    svalid = out_u != SENTINEL
    outs = []
    for view, is_lut, desc in zip(ord_views, ord_luts, descs):
        r = view_ranks(out_u, view, is_lut, svalid)
        outs.append(torch.where(r == _MISSING, r, -r) if desc else r)
    suids = _sort_uids_by(outs, out_u)
    page = _window_at(suids, _i32(offset, dev), window)
    return torch.cat([page, _words(sel_count, n_kept)])


def order_topk(dv_uids: torch.Tensor, dv_ranks: torch.Tensor,
               cand: torch.Tensor, k: int, desc: bool = False):
    """First k of `cand` (a sorted padded uid vector) by value rank with
    the uid as tiebreak: (uids [k], valid count as a 0-d int32)."""
    idx = _rows(lookup_idx(dv_uids, cand), dv_uids.shape[0])
    hit = (dv_uids[idx] == cand) & (cand != SENTINEL)
    ranks = dv_ranks[idx]
    ranks = torch.where(hit, -ranks if desc else ranks, _MISSING)
    suids = _sort_uids_by([ranks], cand)
    return suids[:k], torch.clamp(hit.sum(dtype=torch.int32), max=k)
