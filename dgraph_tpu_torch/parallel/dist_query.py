"""Distributed query step over the full (data, tablet, uid) mesh: the
port of `dgraph_tpu/parallel/dist_query.py`.

One step = one level-batched query plan fragment, the mesh version of
query.ProcessGraph's scatter-gather (query/query.go:2017):

  data axis   : a batch of root frontiers (independent queries)
  tablet axis : predicates — each tablet shard expands through ITS
                predicates, then the candidates gather so every shard
                of the data row holds every predicate's result
  uid axis    : uid-range shards within each predicate (multi-part
                posting lists, posting/list.go:1149)

The canonical step: 2-hop expansion through every predicate intersected
with the 1-hop expansion, per batched seed set — the shape of
"friends-of-friends who are also X" queries.

In `parallel/compat.py`'s phases: data row d's queries run one after
another (the reference vmaps them); each expansion loops over the row's
(tablet, uid) shards, gathers their candidates onto the row's first
device and dedups there. Tablet shards are placed per data row on the
row's devices; where a device repeats, the tensor is placed once.
Shards that share one card run one after another on its stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.ops.uidvec import (
    SENTINEL, compact, count, first_k, member_mask, pad_to,
)
from dgraph_tpu_torch.parallel.compat import (
    all_gather, axis_devices, shard_loop,
)
from dgraph_tpu_torch.parallel.dist_graph import (
    _count_distinct, _csr, _gather_unique, _shard_candidates,
    build_sharded_adjacency,
)
from dgraph_tpu_torch.parallel.mesh import Mesh


@dataclass
class TabletStack:
    """T predicates with identical bucket shapes, stacked on a leading
    tablet dim (host numpy uint32): srcs[i] [T, U, M], neighbors[i]
    [T, U, M, D]."""

    srcs: list[np.ndarray]
    neighbors: list[np.ndarray]
    degrees: list[int]
    n_tablets: int
    n_uid_shards: int
    level_cap: int


def stack_tablets(edge_maps: list[dict[int, np.ndarray]],
                  n_uid_shards: int) -> TabletStack:
    """Build per-predicate sharded adjacencies and pad them onto common
    bucket shapes so they stack on the tablet axis."""
    sadjs = [build_sharded_adjacency(e, n_uid_shards) for e in edge_maps]
    caps = sorted({b.degree for s in sadjs for b in s.buckets})
    srcs, neighbors, degrees = [], [], []
    for cap in caps:
        m = 8
        for s in sadjs:
            for b in s.buckets:
                if b.degree == cap:
                    m = max(m, b.src.shape[1])
        src_stack = np.full((len(sadjs), n_uid_shards, m), SENTINEL,
                            np.uint32)
        nb_stack = np.full((len(sadjs), n_uid_shards, m, cap), SENTINEL,
                           np.uint32)
        for ti, s in enumerate(sadjs):
            for b in s.buckets:
                if b.degree != cap:
                    continue
                src_stack[ti, :, : b.src.shape[1]] = b.src
                nb_stack[ti, :, : b.neighbors.shape[1], :] = b.neighbors
        srcs.append(src_stack)
        neighbors.append(nb_stack)
        degrees.append(cap)
    uids = []
    for e in edge_maps:
        srcs_e, _, dsts_e = _csr(e)
        uids += [srcs_e, dsts_e.astype(np.int64)]
    n_nodes = _count_distinct(np.concatenate(uids)) if uids else 0
    return TabletStack(srcs, neighbors, degrees, len(sadjs), n_uid_shards,
                       pad_to(n_nodes + 8))


def tablet_stack_from_arrays(d: dict) -> TabletStack:
    """A TabletStack from the reference's fields as numpy
    (`dataclasses.asdict` of one, arrays through np.asarray)."""
    return TabletStack([np.asarray(a, np.uint32) for a in d["srcs"]],
                       [np.asarray(a, np.uint32) for a in d["neighbors"]],
                       [int(x) for x in d["degrees"]], int(d["n_tablets"]),
                       int(d["n_uid_shards"]), int(d["level_cap"]))


def _expand_local(mesh: Mesh, row: int, frontier: torch.Tensor,
                  shard_rows: list[list[tuple]], level_cap: int
                  ) -> torch.Tensor:
    """Expand one frontier through every (tablet, uid) shard of data row
    `row` — each through its local predicates' buckets — then gather
    over the uid AND tablet axes onto the frontier's device, so the
    union covers the whole predicate set of this expansion step."""
    local = shard_loop(mesh, ("tablet", "uid"),
                       lambda _, rows: _shard_candidates(frontier, rows),
                       shard_rows, at={"data": row})
    return _gather_unique(local, frontier.device, level_cap)


def _place(stack: TabletStack, mesh: Mesh, t_size: int, row: int,
           cache: dict) -> list[list[tuple]]:
    """Data row `row`'s (tablet, uid) shards, row-major: each holds its
    local tablets' (src, neighbors) of every bucket, as int64 tensors
    on its device (placed once a device)."""
    devs = axis_devices(mesh, ("tablet", "uid"), at={"data": row})
    nt_local = max(1, stack.n_tablets // t_size)
    u_size = mesh.shape["uid"]

    def put(arr, key, dev):
        k = (key, str(dev))
        if k not in cache:
            cache[k] = torch.from_numpy(arr.astype(np.int64)).to(dev)
        return cache[k]

    out = []
    for g, dev in enumerate(devs):
        t, u = divmod(g, u_size)
        rows = []
        for i in range(len(stack.srcs)):
            for j in range(nt_local):
                ti = t * nt_local + j
                if ti >= stack.n_tablets:
                    continue
                rows.append((put(stack.srcs[i][ti, u], ("s", i, ti, u), dev),
                             put(stack.neighbors[i][ti, u],
                                 ("n", i, ti, u), dev)))
        out.append(rows)
    return out


def make_dist_query_step(mesh: Mesh, stack: TabletStack, batch: int,
                         seed_size: int, page: tuple[int, int] | None = None):
    """The canonical distributed query step.

    fn(seeds int64 [batch, seed_size]) -> counts [batch] int32 where
    counts[b] = |2-hop reach of seeds[b] ∩ 1-hop reach| through the
    full predicate set ("friends-of-friends who are also direct
    friends"). With tablet axis size t, each shard expands through its
    local predicates and the gather unions them.

    With page=(offset, k) the step ALSO returns the paginated uid page
    [batch, k] of each query's result (uidvec.first_k on the device —
    the reference's applyOrderAndPagination window,
    query/query.go:2231), so a "first: k, offset: o" query transfers k
    uids per query instead of the whole compact result vector.

    Results land on the mesh's first device."""
    t_size = mesh.shape["tablet"]
    d_size = mesh.shape["data"]
    if not (stack.n_tablets % t_size == 0 or stack.n_tablets <= t_size):
        raise ValueError("tablet count must tile the tablet axis")
    if batch % d_size:
        raise ValueError(f"batch {batch} must tile the data axis "
                         f"({d_size})")
    cache: dict = {}
    placed = [_place(stack, mesh, t_size, r, cache) for r in range(d_size)]
    level_cap = stack.level_cap
    b_local = batch // d_size
    first = mesh.devices.flat[0]

    def one_query(row: int, seed_row: torch.Tensor):
        hop1 = _expand_local(mesh, row, seed_row, placed[row], level_cap)
        hop2 = _expand_local(mesh, row, hop1, placed[row], level_cap)
        # the reference expands the seeds a second time for `direct`;
        # the step is deterministic, so hop1 is that vector
        direct = hop1
        both = compact(hop2.masked_fill(~member_mask(hop2, direct),
                                        SENTINEL))
        n = count(both)
        if page is None:
            return n, None
        return n, first_k(both, page[1], page[0])

    def fn(seeds: torch.Tensor):
        if tuple(seeds.shape) != (batch, seed_size):
            raise ValueError(f"seeds must be [{batch}, {seed_size}], got "
                             f"{tuple(seeds.shape)}")
        counts, pages = [], []
        for row in range(d_size):
            dev = axis_devices(mesh, ("tablet", "uid"), at={"data": row})[0]
            block = seeds[row * b_local:(row + 1) * b_local].to(dev)
            for b in range(b_local):
                n, pg = one_query(row, block[b])
                counts.append(n)
                pages.append(pg)
        out = all_gather(counts, first, tiled=False)
        if page is None:
            return out
        return out, all_gather(pages, first, tiled=False)

    return fn
