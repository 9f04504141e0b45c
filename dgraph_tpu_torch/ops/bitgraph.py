"""Edge-centric bitmap traversal: the batched BFS/SSSP data plane.

Port of `dgraph_tpu/ops/bitgraph.py`. Node slots are grouped by
in-degree class (the ~1.5x ladder {1,2,3} ∪ {4·2^k, 6·2^k}), and each
class keeps a dense padded [rows, cap] matrix of in-neighbour slots
(padding points at the dummy slot N). One BFS level is then a gather-OR
per bucket, and because a bucket's rows occupy a contiguous slot range
in concat order, the per-bucket results laid end to end ARE the next
frontier: no scatter.

The host half (building the adjacency, packing uids into bits and slot
matrices) is numpy, copied from the reference. The device half works on
torch tensors on the device the adjacency was built for: plain
functions closed over the adjacency, with the per-bucket gather-OR in
`ops.kernels.bucket_or` (a CUDA kernel on the card, its plain version on
the CPU).

Frontier bitmaps are int32[N+1, W] words (bit b of word w = query
32*w+b), the bit pattern of the reference's uint32 words. Row N is the
dummy slot and stays all zeros. `words_to_numpy` gives the uint32 view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from dgraph_tpu_torch.backend import resolve_device
from dgraph_tpu_torch.ops.kernels import bucket_or

INT32_INF = np.int32(2**31 - 1)

# bit b of a word, as int32: the uint32 1 << b with its bit pattern kept
_BITS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)) \
    .view(np.int32)


@dataclass
class RevBucket:
    """One in-degree class. Rows r of `in_nb` describe slots
    [offset, offset + rows): the slot's in-neighbor slots, padded with
    n_slots (a dummy always-unreachable slot)."""

    in_nb: torch.Tensor              # [M, D] int32, on the device
    weights: Optional[torch.Tensor]  # [M, D] int32 or None
    degree: int
    offset: int


@dataclass
class BitAdjacency:
    """A predicate's reverse adjacency in slot space.

    slot_uids[s] is the uid living in slot s. uids_sorted/slots_by_uid
    are the uid->slot lookup (host numpy; traversal entry points are
    host-driven like the reference's query planner).
    """

    slot_uids: np.ndarray            # [N] uint32, host
    uids_sorted: np.ndarray          # [N] uint32 sorted, host
    slots_by_uid: np.ndarray         # [N] int32 aligned to uids_sorted
    buckets: list[RevBucket]
    n_slots: int
    n_covered: int                   # slots with in-degree > 0 (prefix)
    n_edges: int
    device: torch.device             # where the bucket tensors live

    @property
    def shape_sig(self):
        return (self.n_slots,
                tuple((b.in_nb.shape[0], b.degree) for b in self.buckets))


def _bucket_ladder(max_cap: int = 2**31) -> np.ndarray:
    """Degree-class caps {1,2,3} ∪ {4·2^k, 6·2^k}: ~1.5x steps, so a
    row wastes <33% padding instead of <50% with pure pow-2 classes."""
    caps = [1, 2, 3]
    k = 4
    while k < max_cap:
        caps.append(k)
        if k + k // 2 < max_cap:
            caps.append(k + k // 2)
        k *= 2
    return np.asarray(caps, np.int64)


_LADDER = _bucket_ladder()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:         # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def words_to_device(packed: np.ndarray,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Host uint32 bitmap words -> int32 tensor (same bits) on device."""
    return _to_device(np.asarray(packed, np.uint32).view(np.int32),
                      resolve_device(device))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bitmap word tensor -> host uint32 array (same bits)."""
    return words.cpu().numpy().view(np.uint32)


def build_bitadjacency(edges: dict[int, np.ndarray],
                       weights: Optional[dict[int, np.ndarray]] = None,
                       min_degree_bucket: int = 1,
                       device: str | torch.device | None = None
                       ) -> BitAdjacency:
    """Host: {src_uid -> sorted dst uint32 array} -> BitAdjacency whose
    bucket tensors live on `device` (the card unless told otherwise).
    `weights`, if given, must mirror `edges`' shapes (per-edge int costs
    for SSSP)."""
    device = resolve_device(device)
    if not edges:
        return BitAdjacency(np.empty(0, np.uint32), np.empty(0, np.uint32),
                            np.empty(0, np.int32), [], 0, 0, 0, device)
    srcs = np.fromiter(edges.keys(), np.uint32, len(edges))
    degs = np.fromiter((len(edges[int(s)]) for s in srcs), np.int64,
                       len(srcs))
    src_rep = np.repeat(srcs, degs)
    dst_all = np.concatenate([np.asarray(edges[int(s)], dtype=np.uint32)
                              for s in srcs])
    w_all = None
    if weights is not None:
        w_all = np.concatenate([np.asarray(weights[int(s)], dtype=np.int32)
                                for s in srcs])

    uids = np.unique(np.concatenate([srcs, dst_all]))
    n = len(uids)
    dst_idx = np.searchsorted(uids, dst_all)
    indeg = np.bincount(dst_idx, minlength=n)
    floor = np.maximum(indeg, min_degree_bucket)
    cap = np.where(
        indeg > 0,
        _LADDER[np.searchsorted(_LADDER, floor)],
        np.int64(1) << 62)
    perm = np.lexsort((uids, cap))            # slot -> uid index
    slot_of = np.empty(n, np.int32)
    slot_of[perm] = np.arange(n, dtype=np.int32)
    slot_uids = uids[perm]
    n_covered = int(np.sum(indeg > 0))

    src_slot = slot_of[np.searchsorted(uids, src_rep)]
    dst_slot = slot_of[dst_idx]
    eorder = np.argsort(dst_slot, kind="stable")
    src_slot = src_slot[eorder]
    dst_slot = dst_slot[eorder]
    if w_all is not None:
        w_all = w_all[eorder]
    counts = np.bincount(dst_slot, minlength=n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(dst_slot), dtype=np.int64) - starts[dst_slot]

    cap_by_slot = cap[perm][:n_covered]
    buckets: list[RevBucket] = []
    offset = 0
    for c in np.unique(cap_by_slot):
        c = int(c)
        m = int(np.sum(cap_by_slot == c))
        nb = np.full((m, c), n, np.int32)
        sel = (dst_slot >= offset) & (dst_slot < offset + m)
        nb[dst_slot[sel] - offset, pos[sel]] = src_slot[sel]
        wb = None
        if w_all is not None:
            warr = np.zeros((m, c), np.int32)
            warr[dst_slot[sel] - offset, pos[sel]] = w_all[sel]
            wb = _to_device(warr, device)
        buckets.append(RevBucket(_to_device(nb, device), wb, c, offset))
        offset += m

    order = np.argsort(slot_uids, kind="stable")
    return BitAdjacency(slot_uids, slot_uids[order],
                        order.astype(np.int32), buckets, n, n_covered,
                        int(len(dst_all)), device)


def _buckets_from_arrays(d: dict[str, np.ndarray], n_rows: int,
                         dummy: int, device: torch.device
                         ) -> list[RevBucket]:
    """Buckets `buckets.{i}.*` of an exported adjacency, checked: rows
    contiguous from 0 in order, indices in [0, dummy]."""
    buckets: list[RevBucket] = []
    offset = 0
    i = 0
    while f"buckets.{i}.in_nb" in d:
        nb = np.ascontiguousarray(d[f"buckets.{i}.in_nb"], np.int32)
        degree = int(d[f"buckets.{i}.degree"])
        if int(d[f"buckets.{i}.offset"]) != offset or nb.ndim != 2 \
                or nb.shape[1] != degree:
            raise ValueError(f"bucket {i}: in_nb {nb.shape}, degree "
                             f"{degree}, offset "
                             f"{int(d[f'buckets.{i}.offset'])} do not "
                             f"follow the buckets before it")
        if nb.size and (nb.min() < 0 or nb.max() > dummy):
            raise ValueError(f"bucket {i}: in_nb outside [0, {dummy}]")
        w = d.get(f"buckets.{i}.weights")
        wb = None
        if w is not None:
            w = np.ascontiguousarray(w, np.int32)
            if w.shape != nb.shape:
                raise ValueError(f"bucket {i}: weights {w.shape} != in_nb "
                                 f"{nb.shape}")
            wb = _to_device(w, device)
        buckets.append(RevBucket(_to_device(nb, device), wb, degree, offset))
        offset += nb.shape[0]
        i += 1
    if offset != n_rows:
        raise ValueError(f"buckets cover {offset} rows, expected {n_rows}")
    return buckets


def bitadjacency_from_arrays(d: dict[str, np.ndarray],
                             device: str | torch.device | None = None
                             ) -> BitAdjacency:
    """A BitAdjacency from the reference's arrays exported as numpy, so
    both implementations can run on identical state.

    Keys: `slot_uids`, `uids_sorted`, `slots_by_uid`, `n_covered`, and
    for each bucket i in slot order `buckets.{i}.in_nb`,
    `buckets.{i}.degree`, `buckets.{i}.offset` and optionally
    `buckets.{i}.weights`."""
    device = resolve_device(device)
    slot_uids = np.asarray(d["slot_uids"], np.uint32)
    n = len(slot_uids)
    ncov = int(d["n_covered"])
    buckets = _buckets_from_arrays(d, ncov, n, device)
    n_edges = int(sum(int((b.in_nb < n).sum()) for b in buckets))
    return BitAdjacency(slot_uids, np.asarray(d["uids_sorted"], np.uint32),
                        np.asarray(d["slots_by_uid"], np.int32), buckets,
                        n, ncov, n_edges, device)


# -- host <-> bitmap ---------------------------------------------------------


def _uid_slots(badj: BitAdjacency,
               u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uid uint32 array -> (slot array, keep mask); unknown uids have
    keep=False. Shared by the single and batched packers."""
    idx = np.searchsorted(badj.uids_sorted, u)
    idx = np.clip(idx, 0, len(badj.uids_sorted) - 1)
    hit = badj.uids_sorted[idx] == u
    return badj.slots_by_uid[idx[hit]], hit


def uids_to_bits(badj: BitAdjacency, uids_np: np.ndarray) -> np.ndarray:
    """Seed uid array -> bool[N] bitmap (unknown uids dropped)."""
    bits = np.zeros(badj.n_slots, bool)
    if badj.n_slots == 0 or len(uids_np) == 0:
        return bits
    slots, _ = _uid_slots(badj, np.asarray(uids_np, np.uint32))
    bits[slots] = True
    return bits


def bits_to_uids(badj: BitAdjacency, bits) -> np.ndarray:
    """bool[N] bitmap (numpy or tensor) -> sorted uid uint32 array."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return np.sort(badj.slot_uids[np.asarray(bits, bool)])


# -- single-query kernels ----------------------------------------------------


def _level(badj: BitAdjacency, f: torch.Tensor) -> torch.Tensor:
    """One frontier expansion: bool[N] -> bool[N] (reachable-in-1)."""
    fe = torch.cat([f, torch.zeros(1, dtype=torch.bool, device=f.device)])
    parts = [fe[b.in_nb.long()].any(dim=1) for b in badj.buckets]
    tail = badj.n_slots - badj.n_covered
    if tail:
        parts.append(torch.zeros(tail, dtype=torch.bool, device=f.device))
    if not parts:
        return torch.zeros(badj.n_slots, dtype=torch.bool, device=f.device)
    return torch.cat(parts)


def make_bfs_bits(badj: BitAdjacency, depth: int,
                  dedup: bool = True) -> Callable:
    """BFS: seed bitmap bool[N] -> tuple of per-level frontier bitmaps
    (newly reached per level when dedup, raw reach otherwise). Matches
    @recurse semantics incl. loop:true via dedup=False."""

    def bfs(seed_bits: torch.Tensor):
        levels = []
        visited = seed_bits
        frontier = seed_bits
        for _ in range(depth):
            reach = _level(badj, frontier)
            if dedup:
                new = reach & ~visited
                visited = visited | new
            else:
                new = reach
            levels.append(new)
            frontier = new
        return tuple(levels)

    return bfs


def bfs_bits_reach(badj: BitAdjacency, seeds_np: np.ndarray, depth: int,
                   dedup: bool = True) -> list[np.ndarray]:
    """Host wrapper: per-level sorted frontier uid arrays. Building the
    BFS closure costs nothing, so unlike the reference there is no
    per-adjacency cache of compiled functions."""
    if badj.n_slots == 0:
        return [np.empty(0, np.uint32) for _ in range(depth)]
    seed = _to_device(uids_to_bits(badj, seeds_np), badj.device)
    levels = make_bfs_bits(badj, depth, dedup)(seed)
    return [bits_to_uids(badj, lv) for lv in levels]


# -- batched (multi-query) kernels -------------------------------------------
#
# frontier[n, w] is a 32-bit word whose bit b is query (w*32+b)'s
# membership, so one pass of the per-bucket gather-OR answers 32*W
# queries for the bytes of one row read.


def uids_to_bits_batched(badj: BitAdjacency,
                         seed_lists: list[np.ndarray]) -> np.ndarray:
    """[B seed uid arrays] -> packed uint32[N+1, ceil(B/32)] frontier.

    Row N is the dummy always-empty slot targeted by adjacency padding,
    so kernels need no separate mask concat."""
    B = len(seed_lists)
    W = (B + 31) // 32
    out = np.zeros((badj.n_slots + 1, W), np.uint32)
    if badj.n_slots == 0 or B == 0:
        return out
    q, slots = _flat_query_slots(badj, seed_lists)
    np.bitwise_or.at(out, (slots, q // 32),
                     (np.uint32(1) << (q % 32).astype(np.uint32)))
    return out


def _flat_query_slots(badj: BitAdjacency, seed_lists: list[np.ndarray]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """One vectorized pass over all (query, uid) pairs -> aligned
    (query index, slot) arrays with unknown uids dropped. Shared by the
    bitmap and seed-slot packers."""
    B = len(seed_lists)
    lens = np.fromiter((len(s) for s in seed_lists), np.int64, B)
    if lens.sum() == 0:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    u = np.concatenate([np.asarray(s, np.uint32) for s in seed_lists])
    q = np.repeat(np.arange(B, dtype=np.int64), lens)
    slots, hit = _uid_slots(badj, u)
    return q[hit], slots


def bits_to_uids_batched(badj: BitAdjacency, packed,
                         n_queries: int) -> list[np.ndarray]:
    """packed uint32[N+1, W] (numpy, or the int32 word tensor) ->
    per-query sorted uid arrays."""
    if isinstance(packed, torch.Tensor):
        packed = words_to_numpy(packed)
    packed = np.asarray(packed)[:badj.n_slots]
    out = []
    for q in range(n_queries):
        bits = (packed[:, q // 32] >> np.uint32(q % 32)) & np.uint32(1)
        out.append(np.sort(badj.slot_uids[bits.astype(bool)]))
    return out


def make_bfs_bits_batched(badj: BitAdjacency, depth: int,
                          dedup: bool = True) -> Callable:
    """Multi-query BFS: packed int32[N+1, W] seed frontier -> tuple of
    per-level packed frontiers (same shape). One call runs 32*W
    independent traversals, one `bucket_or` per bucket and level."""
    ncov = badj.n_covered
    n = badj.n_slots

    def level(f):
        W = f.shape[1]
        # rows [ncov, n] (uncovered slots and the dummy) are never reached
        reach = torch.empty((n + 1, W), dtype=torch.int32, device=f.device)
        reach[ncov:] = 0
        for b in badj.buckets:
            rows = b.in_nb.shape[0]
            bucket_or(f, b.in_nb, out=reach[b.offset:b.offset + rows])
        return reach

    def bfs(seed_packed: torch.Tensor):
        levels = []
        visited = seed_packed
        frontier = seed_packed
        for _ in range(depth):
            reach = level(frontier)
            if dedup:
                new = reach & ~visited
                visited = visited | new
            else:
                new = reach
            levels.append(new)
            frontier = new
        return tuple(levels)

    return bfs


def make_frontier_counts_batched(n_queries: int) -> Callable:
    """packed int32[N+1, W] -> int32[n_queries] per-query popcounts
    (set sizes), on the packed tensor's device."""

    def counts(packed: torch.Tensor) -> torch.Tensor:
        # per bit position: extract each of the 32 bit planes and reduce
        # over rows (the arithmetic >> of int32 is masked by & 1)
        per_word_bit = [((packed >> b) & 1).sum(dim=0, dtype=torch.int32)
                        for b in range(32)]
        stacked = torch.stack(per_word_bit, dim=1)   # [W, 32]
        return stacked.reshape(-1)[:n_queries]

    return counts


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


# -- core-space digest kernels -----------------------------------------------
#
# Only slots with in-degree > 0 can appear in levels >= 1, and those are
# a prefix of slot space (n_covered); only edges whose source is covered
# feed levels >= 2. So level 1 runs once over the full adjacency into
# core space [n_covered+1, W], and deeper levels run in core space over
# a re-bucketed core adjacency (27% of slots and 28% of gathers on the
# 21M-edge zipf graph).


@dataclass
class CoreAdjacency:
    """Reverse adjacency restricted to covered->covered edges, in its
    own ROW space.

    Every covered slot owns exactly one row (slots with no covered
    in-neighbor sit in the cap-1 bucket gathering only the dummy), rows
    grouped by core-degree class, so the per-bucket concat order IS
    the core frontier layout and deep levels need no permutation.
    in_nb entries are ROW POSITIONS of source slots (dummy = n_core);
    `row_slots[r]` is the covered slot living in row r, used once at
    the level-1 boundary to permute slot-ordered bitmaps into row
    order."""

    buckets: list[RevBucket]
    row_slots: torch.Tensor          # [n_core] int32
    n_core: int


def build_core_adjacency(badj: BitAdjacency) -> CoreAdjacency:
    """Derive the covered->covered re-bucketed adjacency on the host from
    the full buckets (copied off the device once), and place it on the
    adjacency's device."""
    ncov = badj.n_covered
    device = badj.device
    if ncov == 0 or not badj.buckets:
        return CoreAdjacency([], torch.zeros(0, dtype=torch.int32,
                                             device=device), ncov)
    dsts, srcs = [], []
    for b in badj.buckets:
        nb = b.in_nb.cpu().numpy()
        rr, cc = np.nonzero(nb < ncov)       # covered sources only
        dsts.append((rr + b.offset).astype(np.int64))
        srcs.append(nb[rr, cc])
    dst = np.concatenate(dsts)
    src = np.concatenate(srcs)
    indeg = np.bincount(dst, minlength=ncov)
    # every covered slot gets a row; 0-degree rows take cap 1 (one
    # dummy gather each, and it keeps row space == covered set)
    cap_all = _LADDER[np.searchsorted(_LADDER, np.maximum(indeg, 1))]
    order = np.lexsort((np.arange(ncov), cap_all))
    row_slots = order.astype(np.int32)       # row -> slot
    caps_o = cap_all[order]
    pos_of = np.empty(ncov, np.int64)        # slot -> row
    pos_of[order] = np.arange(ncov)
    rp = pos_of[dst]
    eorder = np.argsort(rp, kind="stable")
    rp, srco = rp[eorder], pos_of[src[eorder]]   # sources in ROW space
    starts = np.zeros(ncov + 1, np.int64)
    np.cumsum(np.bincount(rp, minlength=ncov), out=starts[1:])
    posin = np.arange(len(srco), dtype=np.int64) - starts[rp]
    buckets: list[RevBucket] = []
    offset = 0
    for c in np.unique(caps_o):
        c = int(c)
        m = int(np.sum(caps_o == c))
        nb = np.full((m, c), ncov, np.int32)
        sel = (rp >= offset) & (rp < offset + m)
        nb[rp[sel] - offset, posin[sel]] = srco[sel]
        buckets.append(RevBucket(_to_device(nb, device), None, c, offset))
        offset += m
    return CoreAdjacency(buckets, _to_device(row_slots, device), ncov)


def core_from_arrays(d: dict[str, np.ndarray],
                     device: str | torch.device | None = None
                     ) -> CoreAdjacency:
    """A CoreAdjacency from the reference's arrays exported as numpy.

    Keys: `row_slots`, `n_core`, and for each bucket i in row order
    `buckets.{i}.in_nb`, `buckets.{i}.degree`, `buckets.{i}.offset`."""
    device = resolve_device(device)
    ncore = int(d["n_core"])
    row_slots = np.asarray(d["row_slots"], np.int32)
    if row_slots.shape != (ncore,) or (ncore and (
            row_slots.min() < 0 or row_slots.max() >= ncore)):
        raise ValueError(f"row_slots must be {ncore} slots in "
                         f"[0, {ncore})")
    buckets = _buckets_from_arrays(d, ncore, ncore, device)
    return CoreAdjacency(buckets, _to_device(row_slots, device), ncore)


def uid_lists_to_seed_slots(badj: BitAdjacency,
                            seed_lists: list[np.ndarray],
                            n_seeds: int | None = None) -> np.ndarray:
    """[B seed uid arrays] -> int32[B, S] slot matrix for the digest
    kernel; unknown uids and padding map to the dummy slot n_slots.
    Deduplicates (query, slot) pairs so the kernel's scatter-ADD packing
    is an exact OR. A query with more than S distinct known seeds is an
    error: silent truncation would answer a different query."""
    B = len(seed_lists)
    S = n_seeds if n_seeds is not None else \
        max((len(s) for s in seed_lists), default=1)
    out = np.full((B, max(S, 1)), badj.n_slots, np.int32)
    if badj.n_slots == 0 or B == 0:
        return out
    q, slots = _flat_query_slots(badj, seed_lists)
    if not len(q):
        return out
    pairs = np.unique((q << 32) | slots.astype(np.int64))
    q, slots = pairs >> 32, pairs & 0xFFFFFFFF
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(np.bincount(q, minlength=B), out=starts[1:])
    pos = np.arange(len(q), dtype=np.int64) - starts[q]
    if pos.max(initial=-1) >= out.shape[1]:
        over = int(q[pos >= out.shape[1]][0])
        raise ValueError(
            f"query {over} has {int((q == over).sum())} distinct seeds "
            f"> n_seeds={out.shape[1]}")
    out[q, pos] = slots.astype(np.int32)
    return out


def make_bfs_digest_batched(badj: BitAdjacency, core: CoreAdjacency,
                            depth: int, n_queries: int,
                            n_seeds: int) -> Callable:
    """The serving-shape BFS: int32[B, S] seed slots (on the device) ->
    (int64[depth] per-level popcount checksums, taken mod 2^32 as the
    reference's uint32 sums wrap; int32[n_core+1, 1] final level's first
    word column).

    The packed frontier is built on the device (scatter-add of one bit
    per (query, seed)), so only the [B, S] slot matrix crosses the host
    link per batch. Level 1 gathers the full adjacency once; every
    deeper level runs in core slot space. The first-word column lets the
    caller check queries 0..31 via make_frontier_counts_batched without
    pulling a full bitmap."""
    N, ncov = badj.n_slots, badj.n_covered
    W = (n_queries + 31) // 32

    def level_into(f, buckets, reach):
        for b in buckets:
            rows = b.in_nb.shape[0]
            bucket_or(f, b.in_nb, out=reach[b.offset:b.offset + rows])

    def digest(seed_slots: torch.Tensor):
        if tuple(seed_slots.shape) != (n_queries, n_seeds):
            raise ValueError(f"seed_slots must be [{n_queries}, {n_seeds}]"
                             f", got {tuple(seed_slots.shape)}")
        dev = seed_slots.device
        q = torch.arange(n_queries, device=dev)
        bit = torch.from_numpy(_BITS).to(dev)[q % 32]
        word = q // 32
        f = torch.zeros((N + 1, W), dtype=torch.int32, device=dev)
        # ADD equals OR: uid_lists_to_seed_slots made (query, slot)
        # pairs unique, and int32 addition of 1 << 31 wraps to its bits
        f.index_put_((seed_slots.reshape(-1).long(),
                      word.repeat_interleave(n_seeds)),
                     bit.repeat_interleave(n_seeds), accumulate=True)
        f[N] = 0                          # dummy slot absorbs padding
        reach1 = torch.empty((ncov, W), dtype=torch.int32, device=dev)
        level_into(f, badj.buckets, reach1)
        seeds_core = f[:ncov]
        new = reach1.bitwise_and_(~seeds_core)
        sums = [popcount_sum(new)]
        # one boundary permutation into core ROW space; every deeper
        # level's bucket layout then IS the next frontier layout
        vis_s = seeds_core | new
        del f, seeds_core
        rows = core.row_slots.long()
        zrow = torch.zeros((1, W), dtype=torch.int32, device=dev)
        frontier = torch.cat([new[rows], zrow])
        visited = torch.cat([vis_s[rows], zrow])
        del new, vis_s
        for _ in range(depth - 1):
            reach = torch.empty((ncov + 1, W), dtype=torch.int32,
                                device=dev)
            reach[ncov] = 0
            level_into(frontier, core.buckets, reach)
            frontier = reach.bitwise_and_(~visited)
            visited |= frontier
            sums.append(popcount_sum(frontier))
        return torch.stack(sums) % (1 << 32), frontier[:, :1]

    return digest


def bfs_bits_reach_batched(badj: BitAdjacency,
                           seed_lists: list[np.ndarray], depth: int,
                           dedup: bool = True) -> list[list[np.ndarray]]:
    """Host wrapper: per-query, per-level sorted frontier uid arrays.
    Returns result[q][lvl]."""
    B = len(seed_lists)
    if badj.n_slots == 0 or B == 0:
        return [[np.empty(0, np.uint32) for _ in range(depth)]
                for _ in range(B)]
    packed = words_to_device(uids_to_bits_batched(badj, seed_lists),
                             badj.device)
    levels = make_bfs_bits_batched(badj, depth, dedup)(packed)
    per_level = [bits_to_uids_batched(badj, lv, B) for lv in levels]
    return [[per_level[lvl][q] for lvl in range(depth)]
            for q in range(B)]


def make_sssp_bits(badj: BitAdjacency, max_iters: int,
                   weighted: bool = False) -> Callable:
    """Bellman-Ford distances: seed bitmap bool[N] -> int32[N] dist
    (INT32_INF = unreachable). With weighted=True uses the per-edge
    weights captured at build time (ref query/shortest.go:451 route():
    the priority queue becomes dense relaxation rounds)."""
    ncov = badj.n_covered
    inf = int(INT32_INF)

    def sssp(seed_bits: torch.Tensor):
        dev = seed_bits.device
        dist = torch.full(seed_bits.shape, inf, dtype=torch.int32,
                          device=dev).masked_fill_(seed_bits, 0)
        for _ in range(max_iters):
            de = torch.cat([dist, torch.full((1,), inf, dtype=torch.int32,
                                             device=dev)])
            parts = []
            for b in badj.buckets:
                d = de[b.in_nb.long()]                   # [M, D]
                w_arr = b.weights if (weighted and b.weights is not None) \
                    else torch.ones_like(d)
                # d + w can exceed int32 (long weighted paths) and must
                # saturate at INT32_INF, not wrap to a negative distance:
                # safe iff w <= INT32_INF - d (both in range since
                # 0 <= d <= INT32_INF)
                safe = (d < inf) & (w_arr <= inf - d)
                cand = torch.where(safe, d + w_arr,
                                   torch.full_like(d, inf))
                parts.append(cand.amin(dim=1))
            if parts:
                cand = torch.cat(parts)
                dist = torch.cat([torch.minimum(dist[:ncov], cand),
                                  dist[ncov:]])
        return dist

    return sssp


def sssp_dist(badj: BitAdjacency, seeds_np: np.ndarray, max_iters: int,
              weighted: bool = False) -> dict[int, int]:
    """Host wrapper: {uid -> hop/weighted distance} for reachable uids."""
    if badj.n_slots == 0:
        return {}
    seed = _to_device(uids_to_bits(badj, seeds_np), badj.device)
    dist = make_sssp_bits(badj, max_iters, weighted)(seed).cpu().numpy()
    ok = dist < INT32_INF
    return {int(u): int(d) for u, d in zip(badj.slot_uids[ok], dist[ok])}
