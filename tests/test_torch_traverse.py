"""The port's uid-vector traversals (dgraph_tpu_torch.ops.traverse)
against the reference (dgraph_tpu.ops.traverse, JAX on the CPU) level by
level and distance by distance on seeded graphs, and against the numpy
oracles of the reference's own traversal tests (BFS, no-dedup, SSSP).
"""

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import graph as jg
from dgraph_tpu.ops import traverse as jt
from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.ops import graph as tg
from dgraph_tpu_torch.ops import traverse as tt
from dgraph_tpu_torch.ops import uidvec as tuv

CPU = "cpu"


def random_graph(n=60, avg_deg=3, seed=0):
    """The reference test's graph: n nodes, 1..2*avg_deg-1 out-edges."""
    rng = np.random.default_rng(seed)
    edges = {}
    for u in range(1, n + 1):
        k = rng.integers(1, avg_deg * 2)
        dst = np.unique(rng.integers(1, n + 1, k)).astype(np.uint32)
        dst = dst[dst != u]
        if len(dst):
            edges[u] = dst
    return edges


def skewed_graph(seed, n=300, n_edges=1500):
    """Uniform sources, zipf destinations: a hub bucket and many small
    ones, as bench/bfs.make_graph draws at scale."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, n_edges)
    dst = rng.zipf(1.3, n_edges) % n + 1
    keep = src != dst
    edges = {}
    for s, d in zip(src[keep], dst[keep]):
        edges.setdefault(int(s), set()).add(int(d))
    return {s: np.asarray(sorted(d), np.uint32) for s, d in edges.items()}


def np_bfs(edges, seeds, depth, dedup=True):
    levels = []
    visited = set(seeds)
    frontier = list(seeds)
    for _ in range(depth):
        nxt = set()
        for u in frontier:
            for d in edges.get(u, []):
                nxt.add(int(d))
        if dedup:
            nxt -= visited
            visited |= nxt
        levels.append(np.asarray(sorted(nxt), dtype=np.uint64))
        frontier = sorted(nxt)
    return levels


def hop_distances(edges, seeds, max_d):
    want = {s: 0 for s in seeds}
    frontier = list(seeds)
    for d in range(1, max_d + 1):
        nxt = []
        for u in frontier:
            for t in edges.get(u, []):
                if int(t) not in want:
                    want[int(t)] = d
                    nxt.append(int(t))
        frontier = nxt
    return want


def both_adj(edges):
    return jg.build_adjacency(edges), tg.build_adjacency(edges, device=CPU)


def test_bfs_oracle():
    edges = random_graph()
    _, adj = both_adj(edges)
    got = tt.bfs_reach(adj, np.asarray([1, 2, 3], np.uint32), 3)
    want = np_bfs(edges, [1, 2, 3], 3)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g.astype(np.uint64), w)


def test_bfs_no_dedup():
    edges = {1: np.array([2], np.uint32), 2: np.array([1], np.uint32)}
    adj = tg.build_adjacency(edges, device=CPU)
    got = tt.bfs_reach(adj, np.asarray([1], np.uint32), 3, dedup=False)
    assert [g.tolist() for g in got] == [[2], [1], [2]]


def test_sssp_oracle():
    edges = random_graph(40, seed=7)
    adj = tg.build_adjacency(edges, device=CPU)
    src, dist = tt.make_sssp(adj, max_iters=6)(
        tuv.from_numpy(np.asarray([1], np.uint32), 8, device=CPU))
    assert dist.dtype == torch.int32
    want = hop_distances(edges, [1], 6)
    for u, d in zip(src.tolist(), dist.tolist()):
        if u == tuv.SENTINEL:
            continue
        assert d == want.get(u, int(tt.INT32_INF)), f"uid {u}"


GRAPHS = [("random", dict(seed=0)), ("random7", dict(n=40, seed=7)),
          ("skewed1", dict(seed=1)), ("skewed2", dict(seed=2))]


def graph_of(name, kw):
    return random_graph(**kw) if name.startswith("random") else \
        skewed_graph(**kw)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("n_seeds", [1, 3, 9])
@pytest.mark.parametrize("name,kw", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_make_bfs_matches_reference(name, kw, n_seeds, depth, dedup):
    edges = graph_of(name, kw)
    ja, ta = both_adj(edges)
    rng = np.random.default_rng(n_seeds)
    seeds = np.sort(rng.choice(np.asarray(sorted(edges), np.uint32),
                               n_seeds, replace=False))
    size = juv.pad_to(len(seeds))
    want = jt.make_bfs(ja, size, depth, dedup)(juv.from_numpy(seeds, size))
    got = tt.make_bfs(ta, size, depth, dedup)(
        tuv.from_numpy(seeds, size, device=CPU))
    assert len(got) == len(want) == depth
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))
    # bfs_reach sorts its seeds and gives the same uid arrays
    reach = tt.bfs_reach(ta, seeds[::-1], depth, dedup)
    for r, w in zip(reach, jt.bfs_reach(ja, seeds, depth, dedup)):
        np.testing.assert_array_equal(r, w)
    if dedup:
        for r, w in zip(reach, np_bfs(edges, seeds.tolist(), depth)):
            np.testing.assert_array_equal(r.astype(np.uint64), w)


@pytest.mark.parametrize("max_iters", [1, 2, None])
@pytest.mark.parametrize("n_seeds", [1, 4])
@pytest.mark.parametrize("name,kw", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_make_sssp_matches_reference(name, kw, n_seeds, max_iters):
    """max_iters None: the largest hop distance, where Bellman-Ford has
    converged, so the distances also equal the numpy oracle's."""
    edges = graph_of(name, kw)
    ja, ta = both_adj(edges)
    rng = np.random.default_rng(10 + n_seeds)
    seeds = np.sort(rng.choice(np.asarray(sorted(edges), np.uint32),
                               n_seeds, replace=False))
    want = hop_distances(edges, seeds.tolist(), len(edges))
    iters = max_iters or max(want.values())
    jsrc, jdist = jt.make_sssp(ja, iters)(juv.from_numpy(seeds, 8))
    tsrc, tdist = tt.make_sssp(ta, iters)(
        tuv.from_numpy(seeds, 8, device=CPU))
    np.testing.assert_array_equal(tsrc.numpy(),
                                  np.asarray(jsrc).astype(np.int64))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    if max_iters is None:
        for u, d in zip(tsrc.tolist(), tdist.tolist()):
            if u != tuv.SENTINEL:
                assert d == want.get(u, int(tt.INT32_INF)), f"uid {u}"


def test_unsorted_seeds_and_a_larger_frontier():
    """bfs_reach sorts caller-provided seeds; a frontier larger than a
    bucket takes the member-mask dual."""
    edges = {5: np.arange(100, 140, dtype=np.uint32),
             9: np.arange(200, 240, dtype=np.uint32)}
    ja, ta = both_adj(edges)
    seeds = np.asarray([9, 1, 5, 7, 3, 8, 2, 6, 4, 11, 12, 13, 14, 15, 16,
                        17, 18], np.uint32)
    got = tt.bfs_reach(ta, seeds, 1)[0]
    np.testing.assert_array_equal(got, np.union1d(edges[5], edges[9]))
    np.testing.assert_array_equal(got, jt.bfs_reach(ja, seeds, 1)[0])
