"""UID-range-sharded adjacency + distributed BFS: the port of
`dgraph_tpu/parallel/dist_graph.py`.

The device-mesh version of ops/graph.py for one predicate whose edge
set exceeds a single device — the reference's multi-part posting list
(posting/list.go:1149 splitUpList). Source uids are range-partitioned
into `uid` shards, every shard holds the same bucket shapes (row counts
padded to the max across shards), and one expansion level is

    local:      frontier (replicated) ∧ local rows -> local candidates
    collective: all_gather(candidates) over the uid axis
    local:      sort + unique -> next frontier (replicated)

written in `parallel/compat.py`'s phases: a per-shard loop, a gather
onto the consumer's device, a local sort. Shards that share one card
run one after another on it.

Two exchange strategies, as in the reference:

  all_gather (make_sharded_bfs)  — frontier REPLICATED; each shard
      masks its local rows, one all_gather merges.
  ring (make_ring_bfs)           — frontier SHARDED by uid range; each
      step local candidates are routed to their dst-range home shard by
      rotating send blocks around the ring (ppermute), accumulating
      with local dedup. Per-shard vectors stay O(block).

Uids are int64 tensors holding uint32 values, SENTINEL (0xFFFFFFFF)
padding, as everywhere in the port. The build functions return the host form
(numpy uint32 arrays of the reference's shapes, [U, M] and [U, M, D]);
`put(mesh)` places shard i's rows as int64 tensors on shard i's device.
A shard keeps only the neighbor rows its frontier hits before the sort
(the reference masks the others to SENTINEL at static shape): the
sorted unique result, padded or cut to the same size, is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch.ops.uidvec import (
    SENTINEL, compact, count, member_mask, merge_many, pad_to, to_numpy,
)
from dgraph_tpu_torch.parallel.compat import (
    all_gather, axis_devices, ppermute, psum, shard_loop,
)
from dgraph_tpu_torch.parallel.mesh import Mesh

MAX_U32 = SENTINEL - 1  # largest real uid a 32-bit tile can hold


@dataclass
class ShardedBucket:
    """One degree bucket across the shards. Host form: src uint32
    [U, M] (per-shard sorted, SENTINEL pad), neighbors uint32
    [U, M, D]. Placed form (after `put`): one int64 [M] and one
    [M, D] tensor a shard, each on its shard's device."""

    src: np.ndarray | list
    neighbors: np.ndarray | list
    degree: int


def _put_buckets(buckets: list[ShardedBucket], n_shards: int, mesh: Mesh,
                 uid_axis: str) -> list[ShardedBucket]:
    devs = axis_devices(mesh, uid_axis)
    if len(devs) != n_shards:
        raise ValueError(f"{n_shards} shards on a {uid_axis} axis of "
                         f"{len(devs)}")
    out = []
    for b in buckets:
        if isinstance(b.src, list):
            raise ValueError("the adjacency is already placed")
        out.append(ShardedBucket(
            [torch.from_numpy(b.src[i].astype(np.int64)).to(dev)
             for i, dev in enumerate(devs)],
            [torch.from_numpy(b.neighbors[i].astype(np.int64)).to(dev)
             for i, dev in enumerate(devs)], b.degree))
    return out


def _shard_rows(adj) -> list[list[tuple]]:
    """Per shard, its (src, neighbors) tensors of every bucket."""
    if any(not isinstance(b.src, list) for b in adj.buckets):
        raise ValueError("place the adjacency on the mesh first (put)")
    return [[(b.src[i], b.neighbors[i]) for b in adj.buckets]
            for i in range(adj.n_shards)]


@dataclass
class ShardedAdjacency:
    n_shards: int
    buckets: list[ShardedBucket] = field(default_factory=list)
    n_edges: int = 0
    n_dst: int = 0

    def put(self, mesh: Mesh, uid_axis: str = "uid") -> ShardedAdjacency:
        """Place shards on the mesh: shard i on the i-th device of the
        uid axis."""
        return ShardedAdjacency(
            self.n_shards,
            _put_buckets(self.buckets, self.n_shards, mesh, uid_axis),
            self.n_edges, self.n_dst)


def _degree_caps(degs: np.ndarray, min_degree_bucket: int) -> np.ndarray:
    """The reference's `_degree_cap` of every row: the next power of two
    of the degree, at least `min_degree_bucket`."""
    caps = np.left_shift(1, np.ceil(np.log2(np.maximum(degs, 1)))
                         .astype(np.int64))
    return np.maximum(min_degree_bucket, caps)


def _count_distinct(values: np.ndarray) -> int:
    """len(np.unique(values)) by a sort and a neighbour compare."""
    if not len(values):
        return 0
    v = np.sort(values)
    return int(1 + np.count_nonzero(v[1:] != v[:-1]))


def _csr(edges: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(srcs sorted int64, degrees, dsts in srcs order as uint32)."""
    srcs = np.sort(np.fromiter(edges.keys(), dtype=np.int64,
                               count=len(edges)))
    rows = [np.asarray(edges[int(s)]) for s in srcs]
    degs = np.fromiter((len(r) for r in rows), dtype=np.int64,
                       count=len(rows))
    dsts = np.concatenate(rows).astype(np.uint32) if rows else \
        np.empty(0, np.uint32)
    return srcs, degs, dsts


def _bucketize(srcs: np.ndarray, degs: np.ndarray, dsts: np.ndarray,
               shard: np.ndarray, n_shards: int,
               min_degree_bucket: int) -> list[ShardedBucket]:
    """Shared degree-cap bucketization for both sharding layouts: row r
    (source srcs[r], in ascending order) goes to shard `shard[r]`; rows
    sorted by source within a shard; shapes equalized across shards per
    cap; neighbors in their stored order."""
    caps = _degree_caps(degs, min_degree_bucket)
    starts = np.concatenate([[0], np.cumsum(degs)])
    buckets = []
    for cap in np.unique(caps):
        rows = np.flatnonzero(caps == cap)
        by_shard = np.argsort(shard[rows], kind="stable")
        rows = rows[by_shard]
        sh = shard[rows]
        per = np.bincount(sh, minlength=n_shards)
        m = pad_to(int(per.max(initial=1)))
        slot = np.arange(len(rows)) - np.concatenate(
            [[0], np.cumsum(per)])[sh]
        src_arr = np.full((n_shards, m), SENTINEL, np.uint32)
        src_arr[sh, slot] = srcs[rows]
        nb_arr = np.full((n_shards, m, int(cap)), SENTINEL, np.uint32)
        d = degs[rows]
        row_of = np.repeat(np.arange(len(rows)), d)
        col = np.arange(int(d.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(d)[:-1]]), d)
        flat = np.repeat(starts[rows], d) + col
        nb_arr[sh[row_of], slot[row_of], col] = dsts[flat]
        buckets.append(ShardedBucket(src_arr, nb_arr, int(cap)))
    return buckets


def build_sharded_adjacency(edges: dict[int, np.ndarray],
                            n_shards: int,
                            min_degree_bucket: int = 8) -> ShardedAdjacency:
    """Host: range-partition srcs into n_shards balanced by edge count,
    then bucket by degree with shapes equalized across shards."""
    srcs, degs, dsts = _csr(edges)
    cum = np.cumsum(degs)
    total = int(cum[-1]) if len(cum) else 0
    # contiguous ranges with ~equal edge mass (ref tablet move picks
    # heaviest->lightest, zero/tablet.go:180 — here we just balance)
    bounds = np.searchsorted(cum, np.linspace(0, total, n_shards + 1)[1:-1])
    shard = np.zeros(len(srcs), np.int64)
    for i, ss in enumerate(np.split(srcs, bounds)):
        if len(ss):
            shard[srcs >= ss[0]] = i
    buckets = _bucketize(srcs, degs, dsts, shard, n_shards,
                         min_degree_bucket)
    return ShardedAdjacency(n_shards, buckets, total,
                            _count_distinct(dsts))


def _frontier_fit(vec: torch.Tensor, size: int) -> torch.Tensor:
    """A sorted vector cut or SENTINEL-padded to `size`."""
    if vec.shape[0] >= size:
        return vec[:size]
    return torch.cat([vec, torch.full((size - vec.shape[0],), SENTINEL,
                                      dtype=vec.dtype, device=vec.device)])


def _local_candidates(frontier: torch.Tensor, src_l: torch.Tensor,
                      nb_l: torch.Tensor) -> torch.Tensor:
    """One shard's candidates for a frontier on its device: the
    neighbor rows of its sources the frontier holds, flattened
    (SENTINEL pads included)."""
    return nb_l[member_mask(src_l, frontier)].reshape(-1)


def _shard_candidates(frontier: torch.Tensor, rows: list[tuple]
                      ) -> torch.Tensor:
    f = frontier.to(rows[0][0].device) if rows else frontier
    parts = [_local_candidates(f, s, nb) for s, nb in rows]
    return torch.cat(parts) if parts else \
        torch.empty(0, dtype=torch.int64, device=frontier.device)


def _gather_unique(locals_: list[torch.Tensor], device: torch.device,
                   out_size: int) -> torch.Tensor:
    """The collective and the local merge: every shard's candidates on
    `device`, sorted unique, padded or cut to out_size (the valid count
    is bounded by n_dst, so out_size >= pad_to(n_dst) never drops
    uids)."""
    gathered = all_gather(locals_, device)
    return _frontier_fit(merge_many(gathered.reshape(1, -1)), out_size)


def _expand_level_body(mesh: Mesh, shard_rows: list[list[tuple]],
                       frontier: torch.Tensor, uid_axis: str,
                       out_size: int) -> torch.Tensor:
    """One expansion level (shared by the single-level expander and the
    multi-level BFS): local candidates per shard -> all_gather over the
    uid axis onto the frontier's device -> sorted unique."""
    local = shard_loop(mesh, uid_axis,
                       lambda _, rows: _shard_candidates(frontier, rows),
                       shard_rows)
    return _gather_unique(local, frontier.device, out_size)


def make_sharded_expand(mesh: Mesh, sadj: ShardedAdjacency,
                        out_size: int, uid_axis: str = "uid"):
    """ONE expansion level over the uid-sharded adjacency — the
    executor's per-level device call when a predicate is too big for a
    single device.

    fn(frontier int64 sorted, SENTINEL padded) -> [out_size] int64
    (sorted unique destinations, SENTINEL padded) on the frontier's
    device."""
    rows = _shard_rows(sadj)

    def fn(frontier: torch.Tensor) -> torch.Tensor:
        return _expand_level_body(mesh, rows, frontier, uid_axis,
                                  out_size)

    return fn


def expand_sharded_np(mesh: Mesh, sadj: ShardedAdjacency,
                      src_u64: np.ndarray) -> np.ndarray:
    """Host frontier -> sharded device expand -> host result; expanders
    cached per frontier bucket size on the adjacency (the expand_np
    contract, mesh tier instead of single device)."""
    src_u64 = np.sort(src_u64[src_u64 <= MAX_U32])
    f_pad = pad_to(len(src_u64))
    out_size = pad_to(max(sadj.n_dst, 1))
    cache = getattr(sadj, "_expander_cache", None)
    if cache is None:
        cache = sadj._expander_cache = {}
    fn = cache.get(f_pad)
    if fn is None:
        fn = cache[f_pad] = make_sharded_expand(mesh, sadj, out_size)
    fr = np.full(f_pad, SENTINEL, np.int64)
    fr[: len(src_u64)] = src_u64.astype(np.int64)
    dev = axis_devices(mesh, "uid")[0]
    return to_numpy(fn(torch.from_numpy(fr).to(dev))).astype(np.uint64)


@dataclass
class RingAdjacency:
    """Uniform-uid-range sharding for the ring exchange: shard i holds
    the adjacency rows whose SRC uid falls in range i, and owns frontier
    uids in the same range — src and dst use ONE partition of the uid
    space so a candidate's home shard is computable on the device
    (dst * n_shards // space)."""
    n_shards: int
    space: int                     # uid space size (ranges = space/n)
    buckets: list[ShardedBucket] = field(default_factory=list)
    n_edges: int = 0
    n_dst: int = 0

    def put(self, mesh: Mesh, uid_axis: str = "uid") -> RingAdjacency:
        return RingAdjacency(
            self.n_shards, self.space,
            _put_buckets(self.buckets, self.n_shards, mesh, uid_axis),
            self.n_edges, self.n_dst)


def build_ring_adjacency(edges: dict[int, np.ndarray],
                         n_shards: int,
                         min_degree_bucket: int = 8) -> RingAdjacency:
    """Host: partition srcs into UNIFORM uid ranges (value-based, not
    mass-balanced — the ring needs dst->shard computable on device)."""
    srcs, degs, dsts = _csr(edges)
    # the largest uid named anywhere (an empty row's counts as 0)
    space = max(int(srcs.max(initial=0)), int(dsts.max(initial=0))) + 1
    per = -(-space // n_shards)  # ceil
    shard = np.minimum(srcs // per, n_shards - 1)
    buckets = _bucketize(srcs, degs, dsts, shard, n_shards,
                         min_degree_bucket)
    return RingAdjacency(n_shards, space, buckets, int(degs.sum()),
                         _count_distinct(dsts))


def _merge_into(acc: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """Sorted dedup of acc ∪ blk, cut to acc's length."""
    return merge_many(torch.cat([acc, blk]).reshape(1, -1))[
        : acc.shape[0]]


def make_ring_bfs(mesh: Mesh, radj: RingAdjacency, seed_size: int,
                  depth: int, block_size: int,
                  uid_axis: str = "uid", check_block: bool = True):
    """A depth-`depth` ring-exchange BFS.

    fn(seeds int64 [n_shards, seed_size], row i the seeds in shard i's
    range) -> (levels tuple of [n_shards, block_size], total int32),
    on the first shard's device.

    Per level, per ring step k: every shard masks its local candidates
    for target shard (self+k) mod n, compacts them into one send block,
    and `ppermute`s it k hops — after n steps every candidate reached
    its dst-range home, where it merged (sorted dedup) into the local
    next-frontier block.

    `block_size` caps each shard's frontier/visited vectors; merges
    truncate at it, so it must bound the per-shard reachable set or
    uids would silently drop. n_dst (distinct destinations anywhere)
    + the seed block is always safe and is enforced here — callers
    with a tighter per-shard bound can pass check_block=False."""
    if check_block and block_size < pad_to(radj.n_dst + seed_size):
        raise ValueError(
            f"block_size {block_size} can overflow: a shard's "
            f"reachable set is only bounded by n_dst + seeds = "
            f"{radj.n_dst + seed_size} (pad to "
            f"{pad_to(radj.n_dst + seed_size)})")
    n = mesh.shape[uid_axis]
    per = -(-radj.space // n)
    devs = axis_devices(mesh, uid_axis)
    rows = _shard_rows(radj)

    def local_candidates(shard, frontier, shard_rows):
        cand = compact(_shard_candidates(frontier, shard_rows))
        home = torch.clamp(cand // per, max=n - 1)
        return cand, home

    def fn(seeds: torch.Tensor):
        frontier = [seeds[i].to(devs[i]) for i in range(n)]
        visited = [_frontier_fit(f, block_size) for f in frontier]
        levels = []
        for _ in range(depth):
            cands = shard_loop(mesh, uid_axis, local_candidates,
                               frontier, rows)
            acc = [torch.full((block_size,), SENTINEL, dtype=torch.int64,
                              device=dev) for dev in devs]
            for k in range(n):
                blks = [compact(cand.masked_fill(
                    (home != (i + k) % n) | (cand == SENTINEL), SENTINEL))
                    for i, (cand, home) in enumerate(cands)]
                if k:
                    # rotate k hops so each block lands on its target
                    blks = ppermute(blks, devs, k)
                acc = [_merge_into(a, b) for a, b in zip(acc, blks)]
            new = [compact(a.masked_fill(member_mask(a, v), SENTINEL))
                   for a, v in zip(acc, visited)]
            visited = [_merge_into(v, nw) for v, nw in zip(visited, new)]
            levels.append(all_gather(new, devs[0], tiled=False))
            frontier = new
        total = psum([count(f) for f in frontier], devs[0])
        return tuple(levels), total

    return fn


def make_sharded_bfs(mesh: Mesh, sadj: ShardedAdjacency, seed_size: int,
                     depth: int, level_size: int,
                     uid_axis: str = "uid"):
    """A depth-`depth` distributed BFS.

    Returns fn(seeds int64 [seed_size] replicated) ->
      (levels tuple of [level_size], reached_count int32).
    The frontier stays replicated; per level each uid shard computes
    local candidates, they gather over the uid axis, and dedup."""
    rows = _shard_rows(sadj)

    def fn(seeds: torch.Tensor):
        levels = []
        frontier = visited = seeds
        for _ in range(depth):
            nxt = _expand_level_body(mesh, rows, frontier, uid_axis,
                                     level_size)
            nxt = compact(nxt.masked_fill(member_mask(nxt, visited),
                                          SENTINEL))
            visited = compact(torch.cat([visited, nxt]))
            levels.append(nxt)
            frontier = nxt
        return tuple(levels), count(frontier)

    return fn


def sharded_adjacency_from_arrays(d: dict) -> ShardedAdjacency:
    """The host form of a ShardedAdjacency from the reference's fields
    as numpy (`dataclasses.asdict` of one, arrays through np.asarray)."""
    return ShardedAdjacency(int(d["n_shards"]), _buckets_from(d),
                            int(d["n_edges"]), int(d["n_dst"]))


def ring_adjacency_from_arrays(d: dict) -> RingAdjacency:
    """The host form of a RingAdjacency from the reference's fields."""
    return RingAdjacency(int(d["n_shards"]), int(d["space"]),
                         _buckets_from(d), int(d["n_edges"]),
                         int(d["n_dst"]))


def _buckets_from(d: dict) -> list[ShardedBucket]:
    return [ShardedBucket(np.asarray(b["src"], np.uint32),
                          np.asarray(b["neighbors"], np.uint32),
                          int(b["degree"])) for b in d["buckets"]]
