"""Multi-hop traversal over the uid-vector adjacency: port of
`dgraph_tpu/ops/traverse.py`.

BFS is `depth` rounds of `graph.expand` and a difference against the
visited set; SSSP is Bellman-Ford-style relaxation: per round, every
bucket gathers its sources' distances, adds one, and scatter-mins them
onto its neighbours' slots. Level sizes come from `max_expansion`, so the
output shapes equal the reference's. The reference's `jax.jit` of each
traversal is a plain function on tensors here, run on the adjacency's
device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dgraph_tpu_torch.ops.graph import DeviceAdjacency, expand, max_expansion
from dgraph_tpu_torch.ops.uidvec import (
    SENTINEL, compact, from_numpy, member_mask, pad_to, to_numpy,
)

INT32_INF = np.int32(2**31 - 1)
_INF = int(INT32_INF)


def make_bfs(adj: DeviceAdjacency, seed_size: int, depth: int,
             dedup: bool = True) -> Callable:
    """A BFS: seeds [seed_size] (sorted, SENTINEL padded) -> tuple of
    per-level frontiers, level d + 1 of length max_expansion of level d.
    With dedup=False it is @recurse's loop:true mode."""
    sizes = [seed_size]
    for _ in range(depth):
        sizes.append(max_expansion(adj, sizes[-1]))

    def bfs(seeds: torch.Tensor):
        levels = []
        frontier = seeds
        visited = seeds
        for d in range(depth):
            nxt = expand(adj, frontier, sizes[d + 1])
            if dedup:
                nxt = compact(nxt.masked_fill(member_mask(nxt, visited),
                                              SENTINEL))
                visited = compact(torch.cat([visited, nxt]))
            levels.append(nxt)
            frontier = nxt
        return tuple(levels)

    return bfs


def bfs_reach(adj: DeviceAdjacency, seeds_np: np.ndarray, depth: int,
              dedup: bool = True) -> list[np.ndarray]:
    """Host wrapper: run the BFS on the adjacency's device and return the
    per-level frontier uid arrays (uint32)."""
    seeds_np = np.sort(np.asarray(seeds_np, dtype=np.uint32))
    seed_size = pad_to(len(seeds_np))
    fn = make_bfs(adj, seed_size, depth, dedup)
    levels = fn(from_numpy(seeds_np, seed_size,
                           device=adj.src_uids.device))
    return [to_numpy(lv) for lv in levels]


# ---------------------------------------------------------------------------
# SSSP: hop-count distances via frontier relaxation
# ---------------------------------------------------------------------------


def make_sssp(adj: DeviceAdjacency, max_iters: int) -> Callable:
    """Single- or multi-source shortest hop counts over the adjacency's
    source slots: fn(seeds [S], sorted) -> (node_uids [N], dist [N]
    int32, INT32_INF where unreached).

    Per round, for each bucket in order: gather dist of its rows, add 1,
    and scatter-min into the slots of its neighbour uids. Neighbours that
    are not sources are leaves; invalid targets go to slot n - 1 with
    INT32_INF. The row and target slots do not depend on the distances,
    so they are found once, outside the rounds."""
    src = adj.src_uids
    n = src.shape[0]
    plan = []
    for b in adj.buckets:
        rows = torch.searchsorted(src, b.src).clamp_(0, n - 1)
        ok = (src[rows] == b.src) & (b.src != SENTINEL)
        flat = b.neighbors.reshape(-1)
        tgt = torch.searchsorted(src, flat).clamp_(0, n - 1)
        tgt_ok = src[tgt] == flat
        plan.append((rows, ok, b.neighbors != SENTINEL,
                     torch.where(tgt_ok, tgt, n - 1), tgt_ok))

    def sssp(seeds: torch.Tensor):
        dist = torch.where(member_mask(src, seeds), 0, _INF).to(torch.int32)
        for _ in range(max_iters):
            for rows, ok, real, tgt, tgt_ok in plan:
                d_here = torch.where(ok, dist[rows], _INF)
                cand = torch.where((d_here < _INF)[:, None] & real,
                                   d_here[:, None] + 1, _INF)
                upd = torch.where(tgt_ok, cand.reshape(-1), _INF)
                dist = dist.scatter_reduce(0, tgt, upd, "amin",
                                           include_self=True)
        return src, dist

    return sssp
