"""3-hop batched BFS over a synthetic scale-free graph at the reference's
systest/21million scale: the port's counterpart of `bench.py`.

The graph is 2M nodes and 21M generated edges with zipf(1.3) in-degree
(about 15.8M after dedup); each query is 8 seed uids, and one digest
call answers B = 24,576 bit-packed queries at depth 3. `numpy_bfs` is
the single-query CPU oracle.

    graph = make_graph(2_000_000, 21_000_000, seed=0)
    badj = build_bitadjacency(csr_to_dict(*graph), device=dev)
    core = build_core_adjacency(badj)
    mats = seed_matrices(graph[0], n_mats, batch)
    slots = pack_seed_slots(badj, mats, batch, dev)
    digest = make_bfs_digest_batched(badj, core, DEPTH, batch, SEEDS)
    times, sums = run(digest, slots[1:], pipe)
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from dgraph_tpu_torch.ops.bitgraph import (
    BitAdjacency, CoreAdjacency, uid_lists_to_seed_slots,
)
from dgraph_tpu_torch.ops.kernels import LEVEL_CHUNK

N_NODES = 2_000_000
N_EDGES = 21_000_000
BATCH = 24_576
SEEDS = 8
DEPTH = 3
PIPE = 3


def make_graph(n_nodes: int, n_edges: int, seed: int = 0):
    """Scale-free-ish: Zipf-weighted destinations, uniform sources.
    Returns CSR (uniq_src, indptr, dst), sorted by (src, dst)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n_nodes + 1, n_edges, dtype=np.uint64)
    # zipf over node ids truncated to range (heavy head like a movie graph)
    dst = (rng.zipf(1.3, n_edges) % n_nodes + 1).astype(np.uint64)
    mask = src != dst
    src, dst = src[mask], dst[mask]
    # dedup (src, dst) pairs; one sorted 64-bit key gives the same pairs
    # in the same (src, dst) order as a row-wise unique, much faster
    key = np.unique((src << np.uint64(32)) | dst)
    src, dst = key >> np.uint64(32), key & np.uint64(0xFFFFFFFF)
    uniq_src, starts = np.unique(src, return_index=True)
    indptr = np.append(starts, len(src))
    return uniq_src, indptr, dst


def csr_to_dict(uniq_src, indptr, dst):
    return {int(u): dst[indptr[i]: indptr[i + 1]].astype(np.uint32)
            for i, u in enumerate(uniq_src)}


def numpy_bfs_levels(uniq_src, indptr, dst, seeds,
                     depth) -> list[np.ndarray]:
    """Single-core CPU oracle: vectorized CSR frontier expansion with
    dedup. Returns each level's sorted frontier uids."""
    visited = seeds.copy()
    frontier = seeds
    levels = []
    for _ in range(depth):
        idx = np.searchsorted(uniq_src, frontier)
        idx = np.clip(idx, 0, len(uniq_src) - 1)
        hit = uniq_src[idx] == frontier
        rows = idx[hit]
        if not len(rows):
            frontier = np.empty(0, np.uint64)
        else:
            parts = [dst[indptr[r]: indptr[r + 1]] for r in rows]
            nxt = np.unique(np.concatenate(parts))
            nxt = np.setdiff1d(nxt, visited, assume_unique=True)
            visited = np.union1d(visited, nxt)
            frontier = nxt
        levels.append(frontier)
    return levels


def numpy_bfs(uniq_src, indptr, dst, seeds, depth) -> int:
    """Size of the last level's frontier (`bench.py`'s baseline answer)."""
    return len(numpy_bfs_levels(uniq_src, indptr, dst, seeds, depth)[-1])


def seed_matrices(uniq_src: np.ndarray, n_mats: int, batch: int,
                  n_seeds: int = SEEDS, seed: int = 1) -> np.ndarray:
    """[n_mats * batch, n_seeds] sorted seed uids drawn from the source
    uids, as `bench.py` draws them. Rows [0, batch) are the same for any
    n_mats, so matrix 0 is the known-answer batch."""
    rng = np.random.default_rng(seed)
    return np.sort(uniq_src[rng.integers(
        0, len(uniq_src), (n_mats * batch, n_seeds))], axis=1)


def pack_seed_slots(badj: BitAdjacency, seed_mat: np.ndarray, batch: int,
                    device: torch.device,
                    n_seeds: int = SEEDS) -> list[torch.Tensor]:
    """One int32[batch, n_seeds] slot matrix on `device` per batch of
    rows of `seed_mat`."""
    return [torch.from_numpy(uid_lists_to_seed_slots(
        badj, list(seed_mat[i:i + batch]), n_seeds)).to(device)
        for i in range(0, len(seed_mat) - batch + 1, batch)]


def digest_bytes(badj: BitAdjacency, core: CoreAdjacency,
                 batch: int) -> int:
    """Device bytes one digest call holds at its peak, counted high: the
    seed bitmap [N+1, W] and its masks, three core-space [n_core+1, W]
    arrays (frontier, the next frontier, visited) and two of masks, the
    scratch (reach and tickets) of the largest bucket split along its
    degree, and the adjacency. The fused level step keeps no reach array
    and no popcount temporaries."""
    W = (batch + 31) // 32
    buckets = badj.buckets + core.buckets
    core_arr = (core.n_core + 1) * W * 4
    split = max([b.in_nb.shape[0] for b in buckets if b.degree > LEVEL_CHUNK],
                default=0)
    adj = sum(b.in_nb.numel() * 4 for b in buckets)
    return (badj.n_slots + 1) * (W + 1) * 4 + 3 * core_arr + \
        2 * (core.n_core + 1) * 4 + split * (W + 1) * 4 + adj


def fit_batch(badj: BitAdjacency, core: CoreAdjacency, batch: int,
              device: torch.device) -> int:
    """Halve the batch (down to 1024) until one digest call fits the
    card's free memory. On the CPU the batch stands."""
    if device.type != "cuda":
        return batch
    free, _total = torch.cuda.mem_get_info(device)
    while batch > 1024 and digest_bytes(badj, core, batch) > free:
        batch //= 2
    return batch


def run(digest: Callable, slot_mats: list[torch.Tensor],
        pipe: int = PIPE) -> tuple[list[float], list[np.ndarray]]:
    """Dispatch the batches `pipe` at a time and wait once per group on
    their level sums, like a server with `pipe` requests in flight.
    Returns each group's wall seconds (host clock around work that ends
    with the results on the host) and each batch's level sums."""
    times, sums = [], []
    for g in range(0, len(slot_mats) - pipe + 1, pipe):
        t0 = time.perf_counter()
        handles = [digest(m)[0] for m in slot_mats[g:g + pipe]]
        got = [h.cpu().numpy() for h in handles]
        times.append(time.perf_counter() - t0)
        sums.extend(got)
    return times, sums
