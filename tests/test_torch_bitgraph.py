"""The port's traversal plane (dgraph_tpu_torch.ops.bitgraph) against the
JAX reference (dgraph_tpu.ops.bitgraph) on the CPU.

Inputs are made with numpy from fixed seeds and handed to both; every
comparison is bit-exact, since all of it is integer work.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
from dgraph_tpu.ops import bitgraph as jbg
from dgraph_tpu_torch.bench import bfs as tbench
from dgraph_tpu_torch.ops import bitgraph as tbg

CPU = "cpu"


def zipf_edges(n_nodes=500, n_edges=4000, seed=0, hub=True):
    """zipf(1.4) destinations; with `hub`, uid 1 is also pointed at by
    every source (a hub row of several hundred in-neighbours)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n_nodes + 1, n_edges, dtype=np.uint32)
    dst = (rng.zipf(1.4, n_edges) % n_nodes + 1).astype(np.uint32)
    if hub:
        srcs = np.unique(src)
        src = np.concatenate([src, srcs])
        dst = np.concatenate([dst, np.ones(len(srcs), np.uint32)])
    mask = src != dst
    pairs = np.unique(np.stack([src[mask], dst[mask]], 1), axis=0)
    uniq, starts = np.unique(pairs[:, 0], return_index=True)
    ends = np.append(starts[1:], len(pairs))
    return {int(s): pairs[a:b, 1] for s, a, b in zip(uniq, starts, ends)}


def weighted_graph(seed=5):
    edges = zipf_edges(200, 1500, seed=seed, hub=False)
    rng = np.random.default_rng(seed)
    weights = {s: rng.integers(1, 100, len(d)).astype(np.int32)
               for s, d in edges.items()}
    return edges, weights


GRAPHS = {
    "zipf_hub": lambda: (zipf_edges(), None),
    "empty": lambda: ({}, None),
    "weighted": weighted_graph,
}


def both(name, **kw):
    edges, weights = GRAPHS[name]()
    jb = jbg.build_bitadjacency(edges, weights=weights, **kw)
    tb = tbg.build_bitadjacency(edges, weights=weights, device=CPU, **kw)
    return edges, jb, tb


def assert_same_buckets(jbuckets, tbuckets):
    assert len(jbuckets) == len(tbuckets)
    for jb, tb in zip(jbuckets, tbuckets):
        assert (jb.degree, jb.offset) == (tb.degree, tb.offset)
        assert tb.in_nb.dtype == torch.int32
        np.testing.assert_array_equal(tb.in_nb.numpy(), np.asarray(jb.in_nb))
        if jb.weights is None:
            assert tb.weights is None
        else:
            np.testing.assert_array_equal(tb.weights.numpy(),
                                          np.asarray(jb.weights))


def assert_same_badj(jb, tb):
    for field in ("slot_uids", "uids_sorted", "slots_by_uid"):
        got, want = getattr(tb, field), getattr(jb, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert (tb.n_slots, tb.n_covered, tb.n_edges) == \
        (jb.n_slots, jb.n_covered, jb.n_edges)
    assert tb.shape_sig == jb.shape_sig
    assert_same_buckets(jb.buckets, tb.buckets)


def assert_same_core(jc, tc):
    assert tc.n_core == jc.n_core
    np.testing.assert_array_equal(tc.row_slots.numpy(),
                                  np.asarray(jc.row_slots))
    assert_same_buckets(jc.buckets, tc.buckets)


def export_badj(jb):
    """The reference adjacency's arrays as numpy, in the layout
    bitadjacency_from_arrays reads."""
    d = {"slot_uids": jb.slot_uids, "uids_sorted": jb.uids_sorted,
         "slots_by_uid": jb.slots_by_uid,
         "n_covered": np.asarray(jb.n_covered)}
    for i, b in enumerate(jb.buckets):
        d[f"buckets.{i}.in_nb"] = np.asarray(b.in_nb)
        d[f"buckets.{i}.degree"] = np.asarray(b.degree)
        d[f"buckets.{i}.offset"] = np.asarray(b.offset)
        if b.weights is not None:
            d[f"buckets.{i}.weights"] = np.asarray(b.weights)
    return d


def export_core(jc):
    d = {"row_slots": np.asarray(jc.row_slots),
         "n_core": np.asarray(jc.n_core)}
    for i, b in enumerate(jc.buckets):
        d[f"buckets.{i}.in_nb"] = np.asarray(b.in_nb)
        d[f"buckets.{i}.degree"] = np.asarray(b.degree)
        d[f"buckets.{i}.offset"] = np.asarray(b.offset)
    return d


def seed_lists(edges, n_queries, n_seeds, seed):
    rng = np.random.default_rng(seed)
    uids = np.asarray(sorted(set(edges) | {int(v) for d in edges.values()
                                           for v in d}), np.uint32)
    return [np.sort(rng.choice(uids, n_seeds, replace=False))
            for _ in range(n_queries)]


# -- host half ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_bitadjacency_parity(name):
    _, jb, tb = both(name)
    assert_same_badj(jb, tb)


def test_build_bitadjacency_min_degree_bucket_parity():
    _, jb, tb = both("zipf_hub", min_degree_bucket=4)
    assert_same_badj(jb, tb)
    assert min(b.degree for b in tb.buckets) >= 4


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_core_adjacency_parity(name):
    _, jb, tb = both(name)
    assert_same_core(jbg.build_core_adjacency(jb),
                     tbg.build_core_adjacency(tb))


def test_bucket_ladder_parity():
    np.testing.assert_array_equal(tbg._LADDER, jbg._LADDER)
    np.testing.assert_array_equal(tbg._bucket_ladder(100),
                                  jbg._bucket_ladder(100))


def test_uid_lists_to_seed_slots_parity():
    edges, jb, tb = both("zipf_hub")
    seeds = seed_lists(edges, 20, 3, seed=1)
    seeds[2] = np.asarray([seeds[2][0]] * 3, np.uint32)    # duplicates
    seeds[3] = np.asarray([4_000_000_000], np.uint32)      # unknown uid
    seeds[4] = np.empty(0, np.uint32)                      # empty set
    for n_seeds in (3, 5, None):
        got = tbg.uid_lists_to_seed_slots(tb, seeds, n_seeds)
        want = jbg.uid_lists_to_seed_slots(jb, seeds, n_seeds)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _, ejb, etb = both("empty")
    np.testing.assert_array_equal(
        tbg.uid_lists_to_seed_slots(etb, seeds, 3),
        jbg.uid_lists_to_seed_slots(ejb, seeds, 3))


def test_uid_lists_to_seed_slots_raises_on_too_many_seeds():
    edges, jb, tb = both("zipf_hub")
    seeds = seed_lists(edges, 4, 5, seed=2)
    with pytest.raises(ValueError, match="distinct seeds") as want:
        jbg.uid_lists_to_seed_slots(jb, seeds, 4)
    with pytest.raises(ValueError, match="distinct seeds") as got:
        tbg.uid_lists_to_seed_slots(tb, seeds, 4)
    assert str(got.value) == str(want.value)


def test_bit_packers_parity():
    edges, jb, tb = both("zipf_hub")
    uids = np.asarray(sorted(edges)[:37] + [4_000_000_000], np.uint32)
    bits = tbg.uids_to_bits(tb, uids)
    np.testing.assert_array_equal(bits, jbg.uids_to_bits(jb, uids))
    np.testing.assert_array_equal(tbg.bits_to_uids(tb, bits),
                                  jbg.bits_to_uids(jb, bits))
    np.testing.assert_array_equal(
        tbg.bits_to_uids(tb, torch.from_numpy(bits)),
        jbg.bits_to_uids(jb, bits))

    seeds = seed_lists(edges, 70, 4, seed=3)
    seeds[5] = np.asarray([4_000_000_000], np.uint32)
    packed = tbg.uids_to_bits_batched(tb, seeds)
    want = jbg.uids_to_bits_batched(jb, seeds)
    assert packed.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(packed, want)
    words = tbg.words_to_device(packed, CPU)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(tbg.words_to_numpy(words), packed)
    for g, w in zip(tbg.bits_to_uids_batched(tb, words, 70),
                    jbg.bits_to_uids_batched(jb, want, 70)):
        np.testing.assert_array_equal(g, w)


def test_make_graph_and_numpy_bfs_match_bench():
    got = tbench.make_graph(3000, 20000, seed=4)
    want = jax_bench.make_graph(3000, 20000, seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    mats = tbench.seed_matrices(got[0], 2, 16)
    for row in mats:
        seeds = np.unique(row)
        assert tbench.numpy_bfs(*got, seeds, 3) == \
            jax_bench.numpy_bfs(*want, seeds, 3)


# -- device half --------------------------------------------------------------


@pytest.mark.parametrize("dedup", [True, False])
def test_make_bfs_bits_parity(dedup):
    edges, jb, tb = both("zipf_hub")
    bits = tbg.uids_to_bits(tb, np.asarray([2, 3, 5], np.uint32))
    want = jbg.make_bfs_bits(jb, 3, dedup)(jnp.asarray(bits))
    got = tbg.make_bfs_bits(tb, 3, dedup)(torch.from_numpy(bits))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dedup", [True, False])
def test_make_bfs_bits_batched_parity(dedup):
    edges, jb, tb = both("zipf_hub")
    packed = jbg.uids_to_bits_batched(jb, seed_lists(edges, 45, 3, seed=6))
    want = jbg.make_bfs_bits_batched(jb, 3, dedup)(jnp.asarray(packed))
    got = tbg.make_bfs_bits_batched(tb, 3, dedup)(
        tbg.words_to_device(packed, CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tbg.words_to_numpy(g), np.asarray(w))


def test_frontier_counts_parity():
    rng = np.random.default_rng(8)
    packed = rng.integers(0, 2**32, (37, 3), dtype=np.uint32)
    packed[:, 1] |= np.uint32(1 << 31)          # the sign bit of int32
    want = jbg.make_frontier_counts_batched(70)(jnp.asarray(packed))
    got = tbg.make_frontier_counts_batched(70)(
        tbg.words_to_device(packed, CPU))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_popcount_sum():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, (50, 7), dtype=np.uint32)
    words[0] = [0, 1, 2**31, 2**32 - 1, 2**31 - 1, 0x80000001, 0x55555555]
    want = int(np.unpackbits(words.view(np.uint8)).sum())
    assert int(tbg.popcount_sum(tbg.words_to_device(words, CPU))) == want


def _digest_both(jb, tb, jc, tc, seeds, depth, n_seeds):
    B = len(seeds)
    slots = jbg.uid_lists_to_seed_slots(jb, seeds, n_seeds)
    np.testing.assert_array_equal(
        tbg.uid_lists_to_seed_slots(tb, seeds, n_seeds), slots)
    jsums, jcol = jbg.make_bfs_digest_batched(jb, jc, depth, B, n_seeds)(
        jnp.asarray(slots))
    tsums, tcol = tbg.make_bfs_digest_batched(tb, tc, depth, B, n_seeds)(
        torch.from_numpy(slots))
    return (np.asarray(jsums).astype(np.int64), np.asarray(jcol),
            tsums.numpy(), tbg.words_to_numpy(tcol))


@pytest.mark.parametrize("depth", [1, 3])
def test_digest_parity(depth):
    edges, jb, tb = both("zipf_hub")
    seeds = seed_lists(edges, 50, 4, seed=11)
    seeds[7] = np.asarray([9999], np.uint32)       # unknown uid -> empty
    seeds[8] = np.empty(0, np.uint32)              # empty seed set
    jc, tc = jbg.build_core_adjacency(jb), tbg.build_core_adjacency(tb)
    jsums, jcol, tsums, tcol = _digest_both(jb, tb, jc, tc, seeds, depth, 4)
    assert tsums.shape == (depth,) and tcol.shape == (tc.n_core + 1, 1)
    np.testing.assert_array_equal(tsums, jsums)
    np.testing.assert_array_equal(tcol, jcol)
    # the first-word column answers queries 0..31 through the counts fn
    want = tbg.bfs_bits_reach_batched(tb, seeds, depth)
    counts = tbg.make_frontier_counts_batched(32)(
        tbg.words_to_device(tcol, CPU))
    assert counts.tolist() == [len(want[q][-1]) for q in range(32)]


def test_digest_parity_empty_graph():
    _, jb, tb = both("empty")
    jc, tc = jbg.build_core_adjacency(jb), tbg.build_core_adjacency(tb)
    seeds = [np.asarray([1], np.uint32)]
    jsums, jcol, tsums, tcol = _digest_both(jb, tb, jc, tc, seeds, 2, 1)
    np.testing.assert_array_equal(tsums, jsums)
    np.testing.assert_array_equal(tcol, jcol)
    assert tsums.tolist() == [0, 0]


def test_digest_rejects_wrong_slot_shape():
    _, _, tb = both("zipf_hub")
    fn = tbg.make_bfs_digest_batched(tb, tbg.build_core_adjacency(tb),
                                     2, 4, 2)
    with pytest.raises(ValueError, match="seed_slots"):
        fn(torch.zeros((4, 3), dtype=torch.int32))


@pytest.mark.parametrize("dedup", [True, False])
def test_bfs_bits_reach_parity(dedup):
    edges, jb, tb = both("zipf_hub")
    seeds = np.asarray([3, 4, 4_000_000_000], np.uint32)
    for g, w in zip(tbg.bfs_bits_reach(tb, seeds, 3, dedup),
                    jbg.bfs_bits_reach(jb, seeds, 3, dedup)):
        np.testing.assert_array_equal(g, w)
    _, ejb, etb = both("empty")
    assert [len(x) for x in tbg.bfs_bits_reach(etb, seeds, 2)] == \
        [len(x) for x in jbg.bfs_bits_reach(ejb, seeds, 2)] == [0, 0]


def test_bfs_bits_reach_batched_parity():
    edges, jb, tb = both("zipf_hub")
    seeds = seed_lists(edges, 40, 3, seed=12)
    seeds[3] = np.empty(0, np.uint32)
    got = tbg.bfs_bits_reach_batched(tb, seeds, 3)
    want = jbg.bfs_bits_reach_batched(jb, seeds, 3)
    for q in range(40):
        for lvl in range(3):
            np.testing.assert_array_equal(got[q][lvl], want[q][lvl])
    assert tbg.bfs_bits_reach_batched(tb, [], 2) == []


def _overflow_graph():
    big = 1_000_000_000
    edges = {1: np.asarray([2], np.uint32), 2: np.asarray([3], np.uint32),
             3: np.asarray([4], np.uint32)}
    weights = {u: np.asarray([big], np.int32) for u in (1, 2, 3)}
    return edges, weights


@pytest.mark.parametrize("case", ["hops", "weighted", "int32_overflow"])
def test_sssp_parity(case):
    if case == "hops":
        edges, weights = zipf_edges(seed=1), None
    elif case == "weighted":
        edges, weights = weighted_graph()
    else:
        edges, weights = _overflow_graph()
    weighted = weights is not None
    jb = jbg.build_bitadjacency(edges, weights=weights)
    tb = tbg.build_bitadjacency(edges, weights=weights, device=CPU)
    seeds = np.asarray([1], np.uint32)
    got = tbg.sssp_dist(tb, seeds, 6, weighted=weighted)
    assert got == jbg.sssp_dist(jb, seeds, 6, weighted=weighted)
    bits = tbg.uids_to_bits(tb, seeds)
    np.testing.assert_array_equal(
        tbg.make_sssp_bits(tb, 6, weighted)(torch.from_numpy(bits)).numpy(),
        np.asarray(jbg.make_sssp_bits(jb, 6, weighted)(jnp.asarray(bits))))
    if case == "int32_overflow":
        assert 4 not in got and got[3] == 2_000_000_000


def test_sssp_empty_graph():
    _, _, tb = both("empty")
    assert tbg.sssp_dist(tb, np.asarray([1], np.uint32), 2) == {}


# -- state carried across ------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_state_carried_across(name):
    _, jb, tb = both(name)
    jc = jbg.build_core_adjacency(jb)
    cb = tbg.bitadjacency_from_arrays(export_badj(jb), CPU)
    assert_same_badj(jb, cb)
    assert_same_core(jc, tbg.core_from_arrays(export_core(jc), CPU))
    # the carried adjacency keeps its host copy, so the core derives
    assert_same_core(jc, tbg.build_core_adjacency(cb))


@pytest.mark.parametrize("fault", ["offset", "index", "rows", "row_slots"])
def test_from_arrays_rejects_malformed_state(fault):
    _, jb, _ = both("zipf_hub")
    d = export_badj(jb)
    c = export_core(jbg.build_core_adjacency(jb))
    if fault == "offset":
        d["buckets.1.offset"] = np.asarray(int(d["buckets.1.offset"]) + 1)
    elif fault == "index":
        d["buckets.0.in_nb"] = d["buckets.0.in_nb"] + jb.n_slots
    elif fault == "rows":
        d["n_covered"] = np.asarray(jb.n_covered + 1)
    else:
        c["row_slots"] = c["row_slots"][:-1]
    with pytest.raises(ValueError):
        if fault == "row_slots":
            tbg.core_from_arrays(c, CPU)
        else:
            tbg.bitadjacency_from_arrays(d, CPU)


# -- the slice as a whole ------------------------------------------------------


def test_slice_end_to_end():
    """bench.py's pipeline at small size: the JAX digest, the port's
    digest over state carried across from the JAX adjacency, the port's
    digest over its own adjacency, and numpy_bfs all agree."""
    B, S, depth = 4096, 8, 3
    graph = tbench.make_graph(2000, 10000, seed=0)
    edges = tbench.csr_to_dict(*graph)
    mats = tbench.seed_matrices(graph[0], 1, B, S)
    seeds = list(mats)

    jb = jbg.build_bitadjacency(edges)
    jc = jbg.build_core_adjacency(jb)
    slots = jbg.uid_lists_to_seed_slots(jb, seeds, S)
    jsums, jcol = jbg.make_bfs_digest_batched(jb, jc, depth, B, S)(
        jnp.asarray(slots))
    jsums = np.asarray(jsums).astype(np.int64)

    carried = tbg.bitadjacency_from_arrays(export_badj(jb), CPU)
    ccore = tbg.core_from_arrays(export_core(jc), CPU)
    own = tbg.build_bitadjacency(edges, device=CPU)
    own_core = tbg.build_core_adjacency(own)
    for badj, core in ((carried, ccore), (own, own_core)):
        slot_t = tbench.pack_seed_slots(badj, mats, B, torch.device(CPU))
        assert len(slot_t) == 1
        np.testing.assert_array_equal(slot_t[0].numpy(), slots)
        digest = tbg.make_bfs_digest_batched(badj, core, depth, B, S)
        sums, col = digest(slot_t[0])
        np.testing.assert_array_equal(sums.numpy(), jsums)
        np.testing.assert_array_equal(tbg.words_to_numpy(col),
                                      np.asarray(jcol))
        times, run_sums = tbench.run(digest, slot_t, pipe=1)
        assert len(times) == 1
        np.testing.assert_array_equal(run_sums[0], jsums)

    counts = tbg.make_frontier_counts_batched(32)(col).tolist()
    levels = [tbench.numpy_bfs_levels(*graph, np.unique(s), depth)
              for s in seeds]
    assert counts == [len(lv[-1]) for lv in levels[:32]]
    assert jsums.tolist() == [sum(len(lv[i]) for lv in levels)
                              for i in range(depth)]
    assert tbench.fit_batch(own, own_core, B, torch.device(CPU)) == B
