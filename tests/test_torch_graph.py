"""The port's uid-vector graph ops (dgraph_tpu_torch.ops.graph) against
the reference (dgraph_tpu.ops.graph, JAX on the CPU), byte for byte on
seeded graphs and value tables: every padded output, SENTINEL slots and
packed trailing words included, equal as values (the port holds uint32
uids in int64). Also the editdist copy against the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu.ops import editdist as jed
from dgraph_tpu.ops import graph as jg
from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.ops import editdist as ted
from dgraph_tpu_torch.ops import graph as tg
from dgraph_tpu_torch.ops import uidvec as tuv

CPU = "cpu"
SENT = 0xFFFFFFFF


def same(want, got):
    """A reference array and a port tensor hold the same values."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                  want.astype(np.int64))


def rand_edges(seed, n_src=120, n_nodes=400, hub=0, empty=False):
    """{src: sorted unique uint32 dst}: degrees 1..40 with a few of 0..2,
    optionally one hub row of `hub` destinations and an empty row."""
    rng = np.random.default_rng(seed)
    srcs = rng.choice(np.arange(1, n_nodes + 1), n_src, replace=False)
    edges = {}
    for i, s in enumerate(srcs.tolist()):
        deg = int(rng.integers(0, 3)) if i % 5 == 0 else \
            int(rng.integers(1, 41))
        dst = np.unique(rng.integers(1, n_nodes + 1, deg)).astype(np.uint32)
        if len(dst) or empty:
            edges[s] = dst
    if hub:
        edges[int(srcs[0])] = np.sort(rng.choice(
            np.arange(1, 4 * hub), hub, replace=False)).astype(np.uint32)
    return edges


def adj_arrays(a):
    d = {"src_uids": np.asarray(a.src_uids), "degrees": np.asarray(a.degrees),
         "n_edges": a.n_edges, "n_dst": a.n_dst, "n_src": a.n_src}
    for i, b in enumerate(a.buckets):
        d[f"buckets.{i}.src"] = np.asarray(b.src)
        d[f"buckets.{i}.neighbors"] = np.asarray(b.neighbors)
        d[f"buckets.{i}.degree"] = b.degree
    return d


def same_adj(ja, ta):
    assert ta.shape_sig == ja.shape_sig
    assert (ta.n_edges, ta.n_dst, ta.n_src) == (ja.n_edges, ja.n_dst,
                                                ja.n_src)
    same(ja.src_uids, ta.src_uids)
    same(ja.degrees, ta.degrees)
    assert ta.degrees.dtype == torch.int32
    assert len(ta.buckets) == len(ja.buckets)
    for jb, tb in zip(ja.buckets, ta.buckets):
        assert tb.degree == jb.degree
        same(jb.src, tb.src)
        same(jb.neighbors, tb.neighbors)
        assert tb.src.dtype == tb.neighbors.dtype == torch.int64


GRAPHS = {
    "small": dict(seed=0),
    "hub": dict(seed=1, hub=700),
    "empty_row": dict(seed=2, empty=True),
    "tiny": dict(seed=3, n_src=3, n_nodes=10),
}


@pytest.mark.parametrize("min_bucket", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_adjacency_matches_reference(name, min_bucket):
    edges = rand_edges(**GRAPHS[name])
    same_adj(jg.build_adjacency(edges, min_bucket),
             tg.build_adjacency(edges, min_bucket, device=CPU))


def test_build_adjacency_of_nothing():
    same_adj(jg.build_adjacency({}), tg.build_adjacency({}, device=CPU))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_adjacency_from_arrays_round_trip(name):
    edges = rand_edges(**GRAPHS[name])
    ja = jg.build_adjacency(edges)
    ta = tg.adjacency_from_arrays(adj_arrays(ja), device=CPU)
    same_adj(ja, ta)
    same_adj(ja, tg.build_adjacency(edges, device=CPU))


def frontier_of(edges, n, seed, size=None):
    rng = np.random.default_rng(seed)
    keys = np.asarray(sorted(edges), np.uint32)
    # mostly sources, some uids that are not sources
    pick = rng.choice(keys, min(n, len(keys)), replace=False)
    extra = rng.integers(1, 2000, max(0, n - len(pick))).astype(np.uint32)
    f = np.unique(np.concatenate([pick, extra]))
    size = size or juv.pad_to(len(f))
    return juv.from_numpy(f, size), tuv.from_numpy(f, size, device=CPU)


@pytest.mark.parametrize("n,duals_want", [(1, {True}), (5, {True}),
                                          (30, {True, False}),
                                          (100, {False})])
def test_bucket_candidates_both_duals(n, duals_want):
    edges = rand_edges(seed=1, hub=700)
    ja, ta = jg.build_adjacency(edges), tg.build_adjacency(edges, device=CPU)
    jf, tf = frontier_of(edges, n, seed=n)
    duals = set()
    for jb, tb in zip(ja.buckets, ta.buckets):
        duals.add(jf.shape[0] <= jb.src.shape[0])
        same(jg._bucket_candidates(jf, jb), tg._bucket_candidates(tf, tb))
    # frontiers past a bucket's rows (the hub's 8) take the member-mask
    # dual (False), the others the gather dual (True)
    assert duals == duals_want


@pytest.mark.parametrize("n,out", [(1, None), (5, None), (30, None),
                                   (100, None), (30, 16), (100, 64)])
def test_expand_matches_reference(n, out):
    edges = rand_edges(seed=1, hub=700)
    ja, ta = jg.build_adjacency(edges), tg.build_adjacency(edges, device=CPU)
    jf, tf = frontier_of(edges, n, seed=10 + n)
    size = out or jg.max_expansion(ja, jf.shape[0])
    assert tg.max_expansion(ta, tf.shape[0]) == \
        jg.max_expansion(ja, jf.shape[0])
    want = jg.expand(ja, jf, size)
    got = tg.expand(ta, tf, size)
    same(want, got)
    if out:
        # truncation keeps the smallest `out` uids of the union
        full = tg.expand(ta, tf, tg.max_expansion(ta, tf.shape[0]))
        same(np.asarray(full)[:out], got)


def test_expand_without_buckets():
    ja, ta = jg.build_adjacency({}), tg.build_adjacency({}, device=CPU)
    jf, tf = juv.from_numpy(np.asarray([3], np.uint32)), \
        tuv.from_numpy(np.asarray([3], np.uint32), device=CPU)
    same(jg.expand(ja, jf, 8), tg.expand(ta, tf, 8))
    assert tg.max_expansion(ta, 8) == jg.max_expansion(ja, 8)


@pytest.mark.parametrize("n", [1, 30, 100])
def test_count_gather_and_has_uids(n):
    edges = rand_edges(seed=2, empty=True)
    ja, ta = jg.build_adjacency(edges), tg.build_adjacency(edges, device=CPU)
    jf, tf = frontier_of(edges, n, seed=n)
    got = tg.count_gather(ta, tf)
    same(jg.count_gather(ja, jf), got)
    assert got.dtype == torch.int32
    same(jg.has_uids(ja), tg.has_uids(ta))


# -- value postings ----------------------------------------------------------


def pairs_of(seed, n, span, n_keys=None, lo=1):
    """{uid -> int64 key}: n uids in [lo, lo + span), keys from n_keys
    distinct values (or wide ones, rarely tied)."""
    rng = np.random.default_rng(seed)
    uids = rng.choice(np.arange(lo, lo + span, dtype=np.int64), n,
                      replace=False)
    if n_keys:
        keys = rng.integers(-n_keys // 2, n_keys - n_keys // 2, n)
    else:
        keys = rng.integers(-(1 << 40), 1 << 40, n)
    return dict(zip(uids.tolist(), keys.tolist()))


def values_arrays(v):
    return {"uids": np.asarray(v.uids), "ranks": np.asarray(v.ranks),
            "ranks_sorted": np.asarray(v.ranks_sorted),
            "uids_by_key": np.asarray(v.uids_by_key),
            "host_keys": v.host_keys, "n": v.n,
            "rank_lut": None if v.rank_lut is None else
            np.asarray(v.rank_lut),
            "lut_base": None if v.lut_base is None else
            np.asarray(v.lut_base)}


def same_values(jv, tv):
    for k in ("uids", "ranks", "ranks_sorted", "uids_by_key"):
        same(getattr(jv, k), getattr(tv, k))
    assert tv.ranks.dtype == tv.ranks_sorted.dtype == torch.int32
    np.testing.assert_array_equal(tv.host_keys, jv.host_keys)
    assert tv.host_keys.dtype == np.int64 and tv.n == jv.n
    assert (tv.rank_lut is None) == (jv.rank_lut is None)
    if jv.rank_lut is not None:
        same(jv.rank_lut, tv.rank_lut)
        assert int(tv.lut_base) == int(jv.lut_base)
    assert tg.dv_view(tv)[1] == jg.dv_view(jv)[1]


# (n, span, n_keys, lo): dense tables take the LUT form, a span past
# max(2^20, 4n) the search form
TABLES = {
    "lut_wide": (600, 2000, None, 1000),
    "lut_k16": (600, 2000, 16, 1000),
    "lut_at_floor": (50, 1 << 20, 5, 1000),
    "search_wide": (600, 1 << 22, None, 5),
    "search_k4": (300, 1 << 21, 4, 1 << 20),
    "empty": (0, 10, None, 1),
}


def both_values(name, seed=0):
    n, span, n_keys, lo = TABLES[name]
    pairs = pairs_of(seed, n, span, n_keys, lo)
    return jg.build_values(pairs), tg.build_values(pairs, device=CPU)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_build_values_matches_reference(name):
    jv, tv = both_values(name)
    same_values(jv, tv)
    assert (tv.rank_lut is not None) == name.startswith("lut")
    same_values(jv, tg.values_from_arrays(values_arrays(jv), device=CPU))


def cand_for(name, seed, extra_below=True, frac=0.7):
    """Sorted candidates: a share of the table's uids, uids absent from
    it, and (for LUT tables) uids below lut_base."""
    n, span, _, lo = TABLES[name]
    rng = np.random.default_rng(seed)
    pairs = pairs_of(0, n, span, TABLES[name][2], lo)
    have = np.asarray(sorted(pairs), np.int64)
    pick = rng.choice(have, int(len(have) * frac), replace=False) \
        if len(have) else have
    absent = rng.integers(lo, lo + span, 40)
    below = rng.integers(0, lo, 20) if extra_below and lo > 1 else []
    c = np.unique(np.concatenate([pick, absent, below]).astype(np.uint32))
    size = juv.pad_to(len(c) + 3)
    return juv.from_numpy(c, size), tuv.from_numpy(c, size, device=CPU)


@pytest.mark.parametrize("name", ["lut_wide", "lut_k16", "lut_at_floor",
                                  "search_wide", "search_k4"])
def test_view_ranks_both_forms(name):
    jv, tv = both_values(name)
    jc, tc = cand_for(name, 1)
    (jview, jlut), (tview, tlut) = jg.dv_view(jv), tg.dv_view(tv)
    assert jlut == tlut
    rng = np.random.default_rng(5)
    valid = rng.random(jc.shape[0]) < 0.9
    jvalid = (jc != juv.SENTINEL) & jnp.asarray(valid)
    tvalid = (tc != tuv.SENTINEL) & torch.from_numpy(valid)
    got = tg.view_ranks(tc, tview, tlut, tvalid)
    same(jg.view_ranks(jc, jview, jlut, jvalid), got)
    assert got.dtype == torch.int32
    if jlut:
        # candidates below lut_base fall out of range, not onto the table
        below = tc < int(tv.lut_base)
        assert bool(below.any())
        assert bool((got[below] == int(tg.RANK_MISSING)).all())


@pytest.mark.parametrize("missing", [int(jg.RANK_MISSING), -1])
@pytest.mark.parametrize("name", ["lut_wide", "search_k4"])
def test_key_gather(name, missing):
    jv, tv = both_values(name)
    jc, tc = cand_for(name, 2)
    same(jg.key_gather(jv, jc, missing), tg.key_gather(tv, tc, missing))


@pytest.mark.parametrize("lo_open,hi_open", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("name", ["lut_k16", "search_wide", "empty"])
def test_range_select(name, lo_open, hi_open):
    jv, tv = both_values(name)
    keys = tv.host_keys
    bounds = [(-5, 3), (0, 0), (-(1 << 50), 1 << 50)]
    if len(keys) > 4:
        bounds += [(int(keys[1]), int(keys[-2])), (int(keys[2]), int(keys[2]))]
    for lo, hi in bounds:
        same(jg.range_select(jv, lo, hi, lo_open, hi_open),
             tg.range_select(tv, lo, hi, lo_open, hi_open))


ORDERS = [("lut_k16",), ("search_wide",), ("lut_k16", "lut_wide"),
          ("search_k4", "lut_k16")]
DESCS = [(False,), (True,), (False, True), (True, False), (True, True)]


def order_views(names):
    pairs = [both_values(nm, seed=i) for i, nm in enumerate(names)]
    return ([p[0] for p in pairs], [p[1] for p in pairs])


def order_cases():
    for names in ORDERS:
        for descs in DESCS:
            if len(descs) == len(names):
                yield names, descs


@pytest.mark.parametrize("names,descs", list(order_cases()))
def test_multisort(names, descs):
    jvs, tvs = order_views(names)
    jc, tc = cand_for(names[0], 3)
    same(jg.multisort(jc, tuple(v.uids for v in jvs),
                      tuple(v.ranks for v in jvs), descs),
         tg.multisort(tc, tuple(v.uids for v in tvs),
                      tuple(v.ranks for v in tvs), descs))


def page_args(names, descs, seed):
    jvs, tvs = order_views(names)
    jc, tc = cand_for(names[0], seed)
    ja = (jc, tuple(v.uids for v in jvs), tuple(v.ranks for v in jvs), descs)
    ta = (tc, tuple(v.uids for v in tvs), tuple(v.ranks for v in tvs), descs)
    return ja, ta, tc


def cursors(sorted_uids):
    """(after_uid, offset): absent (0), present near the start and the
    end, a uid not in the candidates, offsets inside and past the end."""
    real = sorted_uids[sorted_uids != SENT]
    return [(0, 0), (0, 7), (int(real[3]), 0), (int(real[-2]), 2),
            (int(real[len(real) // 2]), 5), (123456789, 0),
            (0, len(real) + 40), (int(real[0]), len(real))]


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("names,descs", [(("lut_k16",), (False,)),
                                         (("search_wide",), (True,)),
                                         (("lut_k16", "lut_wide"),
                                          (True, False))])
def test_multisort_page(names, descs, window):
    ja, ta, tc = page_args(names, descs, 4)
    order = tg.multisort(*ta).numpy()
    for after, offset in cursors(order):
        want = jg.multisort_page(*ja, window, jnp.uint32(after),
                                 jnp.int32(offset))
        same(want, tg.multisort_page(*ta, window, after, offset))
        # the cursor and offset also arrive as tensors
        same(want, tg.multisort_page(*ta, window, torch.tensor(after),
                                     torch.tensor(offset, dtype=torch.int32)))


@pytest.mark.parametrize("band", [(0, 2**31 - 1), (3, 20), (8, 8), (50, 60)])
@pytest.mark.parametrize("names,descs", [(("lut_k16",), (False,)),
                                         (("search_wide", "lut_k16"),
                                          (True, True))])
def test_count_filter_sort_page(names, descs, band):
    edges = rand_edges(seed=4, n_src=300, n_nodes=2000)
    # order the sources by values over the same uid range
    jadj = jg.build_adjacency(edges)
    tadj = tg.build_adjacency(edges, device=CPU)
    jvs, tvs = order_views(names)
    srcs = np.asarray(sorted(edges), np.uint32)
    rng = np.random.default_rng(6)
    vals = dict(zip(srcs[rng.random(len(srcs)) < 0.8].tolist(),
                    rng.integers(0, 9, len(srcs)).tolist()))
    jvs[0], tvs[0] = jg.build_values(vals), tg.build_values(vals, device=CPU)
    degs = tadj.degrees.numpy()
    real = srcs
    kept = real[(degs[: len(real)] >= band[0]) & (degs[: len(real)] <= band[1])]
    excluded = np.setdiff1d(real, kept)
    cur = [(0, 0), (0, 3), (0, len(real) + 5)]
    if len(kept) > 4:
        cur += [(int(kept[2]), 0), (int(kept[-1]), 1)]
    if len(excluded):
        cur += [(int(excluded[0]), 0), (int(excluded[-1]), 2)]
    lo, hi = band
    for after, offset in cur:
        for window in (8, 32):
            want = jg.count_filter_sort_page(
                jadj.src_uids, jadj.degrees, jnp.int32(lo), jnp.int32(hi),
                tuple(v.uids for v in jvs), tuple(v.ranks for v in jvs),
                descs, window, jnp.uint32(after), jnp.int32(offset))
            got = tg.count_filter_sort_page(
                tadj.src_uids, tadj.degrees, lo, hi,
                tuple(v.uids for v in tvs), tuple(v.ranks for v in tvs),
                descs, window, after, offset)
            same(want, got)


@pytest.mark.parametrize("k", [1, 5, 64, 2000])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("name", ["lut_k16", "search_wide"])
def test_order_topk(name, desc, k):
    jv, tv = both_values(name)
    jc, tc = cand_for(name, 7)
    ju, jn = jg.order_topk(jv.uids, jv.ranks, jc, k, desc)
    tu, tn = tg.order_topk(tv.uids, tv.ranks, tc, k, desc)
    same(ju, tu)
    assert int(tn) == int(jn)


# -- the fused whole-block page ----------------------------------------------


def fused_table(n_keys, n, seed, lo=1, span=None):
    pairs = pairs_of(seed, n, span or 2 * n, n_keys, lo)
    return pairs, jg.build_values(pairs), tg.build_values(pairs, device=CPU)


def fused_case(n_cand, key_vals, desc, fop, negs, set_aligned, search_leaf,
               offset, window, seed=0):
    """One fused_rank_page call through both packages: a rank leaf and a
    set leaf (negated per `negs`) over candidates drawn from the order
    table's uids."""
    rng = np.random.default_rng(seed)
    pairs, jo, to = fused_table(key_vals, n_cand, seed)
    uids = np.asarray(sorted(pairs), np.uint32)
    cand = np.sort(rng.choice(uids, int(0.9 * len(uids)), replace=False))
    size = juv.pad_to(len(cand) + 1)
    jc, tc = juv.from_numpy(cand, size), tuv.from_numpy(cand, size,
                                                        device=CPU)
    # rank leaf: a wide-key table (LUT or search form) with [lo, hi)
    lpairs, jl, tl = fused_table(None, n_cand, seed + 1, lo=1,
                                 span=(1 << 23) if search_leaf else None)
    jlv, jlut = jg.dv_view(jl)
    tlv, tlut = tg.dv_view(tl)
    assert jlut == tlut == (not search_leaf)
    nk = len(jl.host_keys)
    r_lo, r_hi = nk // 5, nk - nk // 4
    # set leaf: every other candidate, aligned mask or uid vector
    part = cand[rng.random(len(cand)) < 0.6]
    if set_aligned:
        mask = np.zeros(size, bool)
        mask[: len(cand)] = np.isin(cand, part)
        jfp, tfp = jnp.asarray(mask), torch.from_numpy(mask)
    else:
        psize = juv.pad_to(len(part))
        jfp, tfp = juv.from_numpy(part, psize), tuv.from_numpy(
            part, psize, device=CPU)
    domain = max(1, len(jo.host_keys))
    shift = max(0, (domain - 1).bit_length() - 12)
    base0 = -(domain - 1) if desc else 0
    jov, jol = jg.dv_view(jo)
    tov, tol = tg.dv_view(to)
    want = jg.fused_rank_page(
        jc, (jlv,), (jlut,), (jnp.int32(r_lo),), (jnp.int32(r_hi),),
        (negs[0],), (jfp,), (negs[1],), set_aligned, fop, (jov,), (jol,),
        (desc,), jnp.int32(base0), shift, window, jnp.int32(offset))
    got = tg.fused_rank_page(
        tc, (tlv,), (tlut,), (r_lo,), (r_hi,), (negs[0],), (tfp,),
        (negs[1],), set_aligned, fop, (tov,), (tol,), (desc,), base0, shift,
        window, offset)
    same(want, got)
    return got.numpy()


@pytest.mark.parametrize("fop", ["none", "and", "or"])
@pytest.mark.parametrize("negs", [(False, False), (True, False),
                                  (False, True)])
@pytest.mark.parametrize("set_aligned", [True, False])
def test_fused_rank_page_filters(fop, negs, set_aligned):
    out = fused_case(3000, None, False, fop, negs, set_aligned,
                     search_leaf=False, offset=3, window=16)
    assert out[-2] <= tg.FUSED_SEL_CAP


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("search_leaf", [False, True])
@pytest.mark.parametrize("offset", [0, 40, 5000])
def test_fused_rank_page_orders(desc, search_leaf, offset):
    fused_case(3000, None, desc, "and", (False, False), True, search_leaf,
               offset=offset, window=32, seed=1)


@pytest.mark.parametrize("offset,over", [(0, False), (3000, False),
                                         (4000, True), (6000, True)])
@pytest.mark.parametrize("desc", [False, True])
def test_fused_rank_page_sel_cap(offset, over, desc):
    """A 16-value primary key over 9,000 candidates: the boundary bucket's
    tie mass fits the cap near the front and overflows it further on."""
    out = fused_case(10000, 16, desc, "none", (False, False), True, False,
                     offset=offset, window=64, seed=2)
    assert (int(out[-2]) > tg.FUSED_SEL_CAP) == over


def test_fused_rank_page_two_order_keys_search_form():
    """Two order keys, the second in the search form, under "or"."""
    rng = np.random.default_rng(9)
    pairs, jo, to = fused_table(8, 4000, 3)
    p2, j2, t2 = fused_table(None, 4000, 4, span=1 << 23)
    uids = np.asarray(sorted(pairs), np.uint32)
    cand = np.sort(rng.choice(uids, 3000, replace=False))
    size = juv.pad_to(len(cand))
    jc, tc = juv.from_numpy(cand, size), tuv.from_numpy(cand, size,
                                                        device=CPU)
    mask = np.zeros(size, bool)
    mask[: len(cand)] = rng.random(len(cand)) < 0.3
    (jov, jol), (j2v, j2l) = jg.dv_view(jo), jg.dv_view(j2)
    (tov, tol), (t2v, t2l) = tg.dv_view(to), tg.dv_view(t2)
    assert not j2l and not t2l
    for offset in (0, 100):
        want = jg.fused_rank_page(
            jc, (), (), (), (), (), (jnp.asarray(mask),), (True,), True, "or",
            (jov, j2v), (jol, j2l), (True, False), jnp.int32(-7), 0, 24,
            jnp.int32(offset))
        got = tg.fused_rank_page(
            tc, (), (), (), (), (), (torch.from_numpy(mask),), (True,), True,
            "or", (tov, t2v), (tol, t2l), (True, False), -7, 0, 24, offset)
        same(want, got)


# -- editdist ----------------------------------------------------------------


def byte_rows(words):
    enc = [w.encode("utf-8") for w in words]
    width = max([len(e) for e in enc] + [1])
    mat = np.zeros((len(enc), width), np.uint8)
    for i, e in enumerate(enc):
        mat[i, : len(e)] = np.frombuffer(e, np.uint8)
    return mat, np.asarray([len(e) for e in enc], np.int64)


ROWS = ["", "a", "kitten", "sitting", "flaw", "lawn", "x" * 63, "y" * 64,
        "café", "naïve text", "intention", "execution", "a" * 80]


@pytest.mark.parametrize("want", ["", "k", "kitten", "x" * 63, "x" * 64,
                                  "naïve", "ab" * 20 + "c"])
def test_levenshtein_scores_matches_reference(want):
    mat, lens = byte_rows(ROWS)
    got = ted.levenshtein_scores(want, mat, lens)
    ref = jed.levenshtein_scores(want, mat, lens)
    if ref is None:
        assert got is None
        return
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    # non-ASCII rows come back -1
    assert (got[[8, 9]] == -1).all()
    assert ted.levenshtein_scores(want, mat[:0], lens[:0]).shape == (0,)


# -- devices -------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["build_adjacency", "build_values",
                                  "adjacency_from_arrays",
                                  "values_from_arrays"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without device="cpu" the tiles go to cuda:0, and without a card
    that raises instead of falling back to the CPU."""
    edges = rand_edges(seed=3, n_src=3, n_nodes=10)
    pairs = pairs_of(0, 20, 100)
    args = {"build_adjacency": (edges,), "build_values": (pairs,),
            "adjacency_from_arrays": (adj_arrays(jg.build_adjacency(edges)),),
            "values_from_arrays": (values_arrays(jg.build_values(pairs)),)}
    fn = getattr(tg, entry)
    out = fn(*args[entry], device=CPU)
    assert out.src_uids.device.type == "cpu" if hasattr(out, "src_uids") \
        else out.uids.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args[entry])
