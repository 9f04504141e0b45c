"""The port's multi-device plane (dgraph_tpu_torch.parallel) against the
JAX reference (dgraph_tpu.parallel) on the CPU.

The reference runs on its 8 virtual CPU devices (tests/conftest.py);
the port on a mesh of 8 CPU entries, which the same factoring lays out
as the same (data, tablet, uid) grid. The inputs are those of the
reference's tests/test_parallel.py (seeded random graphs). The build
functions must give the reference's bucket arrays byte for byte; the
step functions run on the reference's arrays carried across with the
`*_from_arrays` constructors, so their parity does not rest on the
build functions'; every level, count and page must equal the reference's as
int64 arrays (uint32 values, SENTINEL padding, the same static sizes).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu.ops.uidvec import from_numpy as jfrom_numpy
from dgraph_tpu.parallel import dist_graph as jdg
from dgraph_tpu.parallel import dist_query as jdq
from dgraph_tpu.parallel import mesh as jmesh
from dgraph_tpu.query.fusion import FUSION_RULES as JRULES
from dgraph_tpu_torch.parallel import compat
from dgraph_tpu_torch.parallel import dist_graph as tdg
from dgraph_tpu_torch.parallel import dist_query as tdq
from dgraph_tpu_torch.parallel import mesh as tmesh
from dgraph_tpu_torch.query.fusion import FUSION_RULES as TRULES
from tests.test_parallel import random_graph

SENT = 0xFFFFFFFF
CPU = torch.device("cpu")


def meshes(n=8, axes=("data", "tablet", "uid")):
    return (jmesh.make_mesh(n, axes=axes),
            tmesh.make_mesh(n, axes=axes, devices=[CPU] * 8))


def as_i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def same(want, got: torch.Tensor, label=""):
    w = as_i64(want)
    g = got.cpu().numpy()
    assert g.dtype == np.int64 and g.shape == w.shape, (label, g.shape,
                                                        w.shape)
    assert g.tobytes() == w.tobytes(), label


def same_buckets(want, got):
    assert len(want.buckets) == len(got.buckets)
    for a, b in zip(want.buckets, got.buckets):
        assert a.degree == b.degree
        for f in ("src", "neighbors"):
            w, g = np.asarray(getattr(a, f)), getattr(b, f)
            assert g.dtype == np.uint32 and g.shape == w.shape, f
            assert g.tobytes() == w.tobytes(), f
    assert (want.n_shards, want.n_edges, want.n_dst) == \
        (got.n_shards, got.n_edges, got.n_dst)


def carried(adj, from_arrays):
    """The reference's adjacency as the port's host form."""
    return from_arrays(dataclasses.asdict(adj))


# -- meshes and partition rules ---------------------------------------------


def test_mesh_axes():
    jm, tm = meshes()
    assert tm.devices.size == jm.devices.size == 8
    assert tm.axis_names == jm.axis_names == ("data", "tablet", "uid")
    assert tm.size == 8 and tm == meshes()[1]
    assert hash(tm) == hash(meshes()[1])


@pytest.mark.parametrize("axes", [("data", "tablet", "uid"), ("uid",),
                                  ("tablet", "uid")])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_factoring(n, axes):
    jm, tm = meshes(n, axes)
    assert dict(tm.shape) == dict(jm.shape)
    assert list(tm.shape) == list(jm.shape)
    assert tm.devices.shape == jm.devices.shape


def test_make_mesh_defaults_to_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


NAMES = ("cand", "fpart0", "fpart12", "rk_uids0", "rk_ranks3", "dv_uids1",
         "dv_ranks0", "rk_lut0", "rk_base0", "dv_lut2", "xcand", "other")


def test_match_partition_rules_on_fusion_rules():
    for name in NAMES:
        want = jmesh.match_partition_rules(JRULES, name)
        got = tmesh.match_partition_rules(TRULES, name)
        assert tuple(got) == tuple(want), name
        assert isinstance(got, tmesh.PartitionSpec)


@pytest.mark.parametrize("axes", [("data", "tablet", "uid"), ("uid",),
                                  ("data", "tablet")])
def test_shard_by_rules_resolves_like_the_reference(axes):
    """Each operand's resolved spec is the reference's sharding spec
    (axes the mesh lacks degrade to replication); values are unchanged
    and land on the mesh's first device; None is the identity."""
    jm, tm = meshes(8, axes)
    vals = {n: np.arange(16, dtype=np.int64) * (i + 1)
            for i, n in enumerate(NAMES)}
    want = jmesh.shard_by_rules(jm, JRULES,
                                {n: jnp.asarray(v) for n, v in vals.items()})
    named = {n: torch.from_numpy(v) for n, v in vals.items()}
    got = tmesh.shard_by_rules(tm, TRULES, named)
    for n in NAMES:
        assert tuple(tmesh.resolve_spec(tm, TRULES, n)) == \
            tuple(want[n].sharding.spec), n
        assert torch.equal(got[n], named[n])
        assert got[n].device == tm.devices.flat[0]
    assert tmesh.shard_by_rules(None, TRULES, named) is named
    with pytest.raises(ValueError, match="more dims"):
        tmesh.shard_by_rules(tm if "uid" in axes else meshes()[1], TRULES,
                             {"cand": torch.tensor(3)})


# -- the collectives --------------------------------------------------------


def test_compat_collectives():
    _, tm = meshes()
    devs = compat.axis_devices(tm, ("tablet", "uid"), at={"data": 1})
    assert devs == [CPU] * 4
    parts = [torch.full((2,), i, dtype=torch.int32) for i in range(4)]
    assert compat.all_gather(parts, CPU).tolist() == [0, 0, 1, 1, 2, 2,
                                                      3, 3]
    assert compat.all_gather(parts, CPU, tiled=False).shape == (4, 2)
    rot = compat.ppermute(parts, devs, 1)
    assert [int(r[0]) for r in rot] == [3, 0, 1, 2]
    total = compat.psum(parts, CPU)
    assert total.dtype == torch.int32 and total.tolist() == [6, 6]
    seen = compat.shard_loop(tm, "uid", lambda s, x: (compat.axis_index(s),
                                                      s.device, x), [7, 9])
    assert seen == [(0, CPU, 7), (1, CPU, 9)]
    with pytest.raises(ValueError, match="shards for an axis"):
        compat.shard_loop(tm, "uid", lambda s, x: x, [1, 2, 3])


# -- the distributed query step ---------------------------------------------


def _dist_query_inputs(seed_a, seed_b, rng_seed, batch_mult):
    e1 = random_graph(80, seed=seed_a)
    e2 = random_graph(80, seed=seed_b)
    jm, tm = meshes()
    B, S = jm.shape["data"] * batch_mult, 8
    rng = np.random.default_rng(rng_seed)
    seeds = np.full((B, S), SENT, np.uint32)
    for b in range(B):
        seeds[b, :2] = np.sort(rng.integers(1, 80, 2).astype(np.uint32))
    return (e1, e2), jm, tm, B, S, seeds


def test_stack_tablets_byte_equal():
    (e1, e2), jm, tm, *_ = _dist_query_inputs(1, 2, 0, 2)
    want = jdq.stack_tablets([e1, e2], jm.shape["uid"])
    got = tdq.stack_tablets([e1, e2], tm.shape["uid"])
    for w, g in zip(want.srcs + want.neighbors, got.srcs + got.neighbors):
        assert g.dtype == np.uint32 and g.tobytes() == \
            np.asarray(w).tobytes()
    assert (got.degrees, got.n_tablets, got.n_uid_shards, got.level_cap) \
        == (want.degrees, want.n_tablets, want.n_uid_shards,
            want.level_cap)


@pytest.mark.parametrize("page", [None, (2, 4), (0, 10)])
def test_dist_query_step(page):
    """tests/test_parallel.py's step and its paged form: counts (int32)
    and pages equal the reference's on its own stacked tablets."""
    (e1, e2), jm, tm, B, S, seeds = _dist_query_inputs(
        *((1, 2, 0, 2) if page is None else (3, 4, 7, 1)))
    jstack = jdq.stack_tablets([e1, e2], jm.shape["uid"])
    want = jdq.make_dist_query_step(jm, jstack, B, S, page=page)(
        jnp.asarray(seeds))
    tstack = tdq.tablet_stack_from_arrays(dataclasses.asdict(jstack))
    got = tdq.make_dist_query_step(tm, tstack, B, S, page=page)(
        torch.from_numpy(seeds.astype(np.int64)))
    if page is None:
        want, got = (want,), (got,)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if page is not None:
        same(want[1], got[1], "page")


def test_dist_query_step_refuses_a_batch_off_the_data_axis():
    (e1, e2), _, tm, *_ = _dist_query_inputs(1, 2, 0, 2)
    stack = tdq.stack_tablets([e1, e2], tm.shape["uid"])
    with pytest.raises(ValueError, match="tile the data axis"):
        tdq.make_dist_query_step(tm, stack, 3, 8)


# -- sharded expand and BFS -------------------------------------------------


def test_build_sharded_adjacency_byte_equal():
    edges = random_graph()
    for shards in (1, 2, 3, 8):
        same_buckets(jdg.build_sharded_adjacency(edges, shards),
                     tdg.build_sharded_adjacency(edges, shards))


def test_sharded_bfs_matches_single_device():
    edges = random_graph()
    jm, tm = meshes()
    u = jm.shape["uid"]
    jadj = jdg.build_sharded_adjacency(edges, n_shards=u)
    seeds_np = np.asarray([1, 2], dtype=np.uint32)
    level_size = 128
    want, wc = jdg.make_sharded_bfs(jm, jadj.put(jm), 8, 3, level_size)(
        jfrom_numpy(seeds_np, 8))
    tadj = carried(jadj, tdg.sharded_adjacency_from_arrays).put(tm)
    seeds = np.full(8, SENT, np.int64)
    seeds[:2] = seeds_np
    got, gc = tdg.make_sharded_bfs(tm, tadj, 8, 3, level_size)(
        torch.from_numpy(seeds))
    for i, (w, g) in enumerate(zip(want, got)):
        same(w, g, f"level {i}")
    assert gc.dtype == torch.int32 and int(gc) == int(wc)


@pytest.mark.parametrize("frontier", [[1, 2, 3], list(range(1, 121, 3)),
                                      [], [0xFFFFFFFF + 5, 7]])
def test_expand_sharded_np(frontier):
    edges = random_graph()
    jm, tm = meshes(8, ("uid",))
    jadj = jdg.build_sharded_adjacency(edges, 8)
    tadj = carried(jadj, tdg.sharded_adjacency_from_arrays).put(tm)
    fr = np.asarray(frontier, np.uint64)
    want = jdg.expand_sharded_np(jm, jadj.put(jm), fr)
    got = tdg.expand_sharded_np(tm, tadj, fr)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(tadj._expander_cache) == 1


def test_placed_adjacency_is_per_shard_tensors():
    _, tm = meshes(8, ("uid",))
    host = tdg.build_sharded_adjacency(random_graph(), 8)
    placed = host.put(tm)
    b = placed.buckets[0]
    assert len(b.src) == 8 and b.src[0].dtype == torch.int64
    assert b.neighbors[3].shape == host.buckets[0].neighbors[3].shape
    with pytest.raises(ValueError, match="put"):
        tdg.make_sharded_expand(tm, host, 64)
    with pytest.raises(ValueError, match="already placed"):
        placed.put(tm)
    with pytest.raises(ValueError, match="4 shards"):
        tdg.build_sharded_adjacency(random_graph(), 4).put(tm)


# -- ring BFS ---------------------------------------------------------------


def _ring_seeds(seeds_np, space, u, seed_size=8):
    per = -(-space // u)
    seeds = np.full((u, seed_size), SENT, np.uint32)
    for s in seeds_np:
        row = min(int(s) // per, u - 1)
        slot = int(np.sum(seeds[row] != SENT))
        seeds[row, slot] = s
    return np.sort(seeds, axis=1)


def _ring_run(edges, seeds_np, depth, block, n=8):
    jm, tm = meshes(n)
    u = jm.shape["uid"]
    jradj = jdg.build_ring_adjacency(edges, n_shards=u)
    same_buckets(jradj, tdg.build_ring_adjacency(edges, n_shards=u))
    assert tdg.build_ring_adjacency(edges, u).space == jradj.space
    seeds = _ring_seeds(seeds_np, jradj.space, u)
    want, wt = jdg.make_ring_bfs(jm, jradj.put(jm), 8, depth, block)(
        jnp.asarray(seeds))
    tradj = carried(jradj, tdg.ring_adjacency_from_arrays).put(tm)
    got, gt = tdg.make_ring_bfs(tm, tradj, 8, depth, block)(
        torch.from_numpy(seeds.astype(np.int64)))
    assert len(got) == depth
    for i, (w, g) in enumerate(zip(want, got)):
        same(w, g, f"level {i}")
    assert gt.dtype == torch.int32 and int(gt) == int(wt)
    return got


def test_ring_bfs_matches_single_device():
    edges = random_graph(n=150, avg_deg=5, seed=23)
    _ring_run(edges, np.asarray([1, 2, 77], np.uint32), 3, 256)


def test_ring_bfs_empty_and_cross_shard():
    # a path graph spanning the whole uid space: every hop crosses
    # shard boundaries, exercising the ppermute routing
    edges = {i: np.asarray([i + 40], dtype=np.uint32)
             for i in range(1, 280, 40)}
    got = _ring_run(edges, np.asarray([1], np.uint32), 4, 64)
    assert int((got[-1] != SENT).sum()) == 1


@pytest.mark.parametrize("block", [8, 16, 64, 128, 255, 256, 512])
def test_ring_check_block_refuses_where_the_reference_does(block):
    edges = random_graph(n=150, avg_deg=5, seed=23)
    jm, tm = meshes()
    u = jm.shape["uid"]
    jradj = jdg.build_ring_adjacency(edges, u).put(jm)
    tradj = tdg.build_ring_adjacency(edges, u).put(tm)
    errs = []
    for make, m, r in ((jdg.make_ring_bfs, jm, jradj),
                       (tdg.make_ring_bfs, tm, tradj)):
        try:
            make(m, r, 8, 3, block)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    tdg.make_ring_bfs(tm, tradj, 8, 3, block, check_block=False)
