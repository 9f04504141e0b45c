"""The port's mesh-sharded similar_to (dgraph_tpu_torch.parallel.dist_knn)
and the slot range of its quantized stage (ops/ivf `lo`/`hi`) against
the JAX reference on the CPU.

Inputs are tests/test_knn.py's (`test_sharded_mesh_merge_parity`, 155,
and `test_ivf_sharded_mesh_merge_parity`, 324): seeded corpora, the
latter with a run of duplicate vectors that tie at the re-rank cut,
and a keep mask. The reference runs on its 8 virtual CPU devices, the
port on a mesh of 8 CPU entries.

- Exact tier: ids equal the reference's sharded ids and the port's own
  single-device exact top-k; a pair of neighbours may swap only where
  their float64 scores lie within (d + 4) * 2^-24 of their magnitude
  (PERF.md's flip bound: both sides sum float32 products of depth d in
  other orders). Scores agree within 1e-5 relative, as the port's knn
  tests state.
- Quantized tier: ids equal; the sharded scores equal the single-device
  `ivf.search`'s within each package at rtol 1e-12 (the reference's
  assertion), and the port's equal the reference's exactly (the port's
  IVF tests' tolerance: both re-rank the same rows with the same numpy).
- `_approx_scores_host(lo, hi)` equals the reference's byte for byte
  over several ranges, and the device route's range (one
  score_int8_lists call, on CPU tensors) equals it within the IVF
  tests' reordering bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import ivf as jivf
from dgraph_tpu.ops import knn as jknn
from dgraph_tpu.parallel import dist_knn as jdk
from dgraph_tpu.parallel import make_mesh as jmake_mesh
from dgraph_tpu_torch.ops import ivf as tivf
from dgraph_tpu_torch.ops import kernels
from dgraph_tpu_torch.ops import knn as tknn
from dgraph_tpu_torch.parallel import dist_knn as tdk
from dgraph_tpu_torch.parallel import make_mesh as tmake_mesh
from tests.test_knn import _clustered, _corpus
from tests.test_torch_ivf import _approx_bound

CPU = torch.device("cpu")


AXES = {"default": ("data", "tablet", "uid"), "uid8": ("uid",)}


def meshes(axes=AXES["default"]):
    """The reference's mesh over its 8 virtual devices and the port's
    over 8 CPU entries: (2, 2, 2) by default, or 8 uid shards."""
    return (jmake_mesh(8, axes=axes),
            tmake_mesh(8, axes=axes, devices=[CPU] * 8))


def knn_inputs():
    """test_knn.py:155's corpus and queries, plus a duplicate run."""
    corpus = _corpus(4096, 32, seed=8)
    corpus[300:310] = corpus[299]
    q = _corpus(3, 32, seed=9)
    return corpus, np.concatenate([q, corpus[299][None]])


def assert_flips_within_bound(got_i, want_i, corpus, q, metric):
    """Equal ids, or a swap of neighbours whose float64 scores lie
    within the (d + 4) * 2^-24 flip bound."""
    d = corpus.shape[1]
    for qi in range(len(q)):
        if np.array_equal(got_i[qi], want_i[qi]):
            continue
        ids = np.union1d(got_i[qi], want_i[qi])
        _, sc = jknn.topk_host(corpus[ids], q[qi][None], len(ids), metric)
        scale = max(1.0, float(np.abs(sc).max()))
        bad = [j for j in range(len(got_i[qi]))
               if got_i[qi][j] != want_i[qi][j]]
        assert bad, qi
        gap = abs(float(sc[0][bad[0]]) - float(sc[0][bad[-1]]))
        assert gap <= (d + 4) * 2.0 ** -24 * scale, (qi, gap)


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sharded_topk_matches_reference(metric, with_mask, axes):
    corpus, q = knn_inputs()
    jm, tm = meshes(AXES[axes])
    mask = None
    if with_mask:
        mask = np.random.default_rng(3).random(len(corpus)) > 0.3
    jb, jn = jdk.shard_corpus(jm, corpus)
    wi, ws = jdk.sharded_topk(jm, jb, q, 6, metric, mask=mask, n_real=jn)
    tb, tn = tdk.shard_corpus(tm, corpus)
    assert tn == jn and len(tb) == tm.shape["uid"]
    assert sum(b.shape[0] for b in tb) == jb.shape[0]
    gi, gs = tdk.sharded_topk(tm, tb, q, 6, metric, mask=mask, n_real=tn)
    assert gi.dtype == np.int64 and gi.shape == wi.shape
    assert_flips_within_bound(gi, wi, corpus, q, metric)
    scale = max(1.0, float(np.abs(ws).max()))
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5 * scale)
    # against the port's single-device exact tier
    si, ss = tknn.topk_device(corpus, q, 6, metric, mask=mask,
                              two_stage=False, device="cpu")
    assert_flips_within_bound(gi, si, corpus, q, metric)
    np.testing.assert_allclose(gs, ss, rtol=1e-5, atol=1e-5 * scale)


def test_sharded_topk_matches_host_oracle():
    """The reference's own assertion (test_knn.py:155): the sharded
    top-6 equals the float64 host top-6."""
    corpus = _corpus(4096, 32, seed=8)
    q = _corpus(3, 32, seed=9)
    _, tm = meshes()
    block, n_real = tdk.shard_corpus(tm, corpus)
    si, ss = tdk.sharded_topk(tm, block, q, 6, "cosine", n_real=n_real)
    hi, hs = jknn.topk_host(corpus, q, 6, "cosine")
    assert np.array_equal(si, hi)
    np.testing.assert_allclose(ss, hs, rtol=2e-4, atol=2e-3)


def test_sharded_topk_k_past_a_shard_and_padding():
    """k above a shard's rows: k_eff = per, padding rows score -inf."""
    corpus = _corpus(300, 8, seed=4)
    q = _corpus(2, 8, seed=5)
    jm, tm = meshes()
    jb, jn = jdk.shard_corpus(jm, corpus)
    tb, tn = tdk.shard_corpus(tm, corpus)
    wi, ws = jdk.sharded_topk(jm, jb, q, 200, "dot", n_real=jn)
    gi, gs = tdk.sharded_topk(tm, tb, q, 200, "dot", n_real=tn)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=1e-5, atol=1e-5)


def test_sharded_topk_launches_score_dot_once_a_shard(monkeypatch):
    corpus, q = knn_inputs()
    _, tm = meshes(AXES["uid8"])
    calls = []

    def counted(c, qq, metric, n_live, n_out, mask=None):
        calls.append(tuple(c.shape))
        return kernels.score_metric(c, qq, metric, n_live, n_out, mask)

    monkeypatch.setattr(tknn, "score_metric", counted)
    block, n_real = tdk.shard_corpus(tm, corpus)
    tdk.sharded_topk(tm, block, q, 6, "cosine", n_real=n_real)
    assert calls == [(512, 32)] * 8


@pytest.fixture(scope="module")
def ivf_inputs():
    """test_knn.py:324's corpus (duplicates at 100-120) and index."""
    corpus = _clustered(6_000, 16, centers=64, seed=35)
    corpus[100:120] = corpus[99]
    ix = jivf.build(corpus, seed=0)
    return corpus, ix, tivf.ivf_index_from_arrays(dataclasses.asdict(ix),
                                                  "cpu")


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("nprobe", [None, 1, 8])
def test_sharded_ivf_topk_matches_reference(ivf_inputs, metric, nprobe,
                                            axes):
    corpus, jix, tix = ivf_inputs
    jm, tm = meshes(AXES[axes])
    q = corpus[:4] + 0.01
    wi, ws = jdk.sharded_ivf_topk(jm, jix, corpus, q, 6, metric,
                                  nprobe=nprobe)
    gi, gs = tdk.sharded_ivf_topk(tm, tix, corpus, q, 6, metric,
                                  nprobe=nprobe)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)
    di, ds = tivf.search(tix, corpus, q, 6, metric, nprobe=nprobe)
    assert np.array_equal(gi, di)
    np.testing.assert_allclose(gs, ds, rtol=1e-12)
    # keep-mask flows through the sharded path too
    keep = np.ones(len(corpus), bool)
    keep[di[0][0]] = False
    keep[100:110] = False
    wi2, ws2 = jdk.sharded_ivf_topk(jm, jix, corpus, q, 6, metric,
                                    keep=keep, nprobe=nprobe)
    gi2, gs2 = tdk.sharded_ivf_topk(tm, tix, corpus, q, 6, metric,
                                    keep=keep, nprobe=nprobe)
    di2, _ = tivf.search(tix, corpus, q, 6, metric, keep=keep,
                         nprobe=nprobe)
    np.testing.assert_array_equal(gi2, wi2)
    np.testing.assert_array_equal(gs2, ws2)
    np.testing.assert_array_equal(gi2, di2)


def test_ivf_merge_candidates_equal(ivf_inputs):
    rng = np.random.default_rng(11)
    parts = [(rng.permutation(300)[:50].astype(np.int64) + 300 * i,
              np.round(rng.standard_normal(50), 1)) for i in range(4)]
    for r in (1, 10, 64, 500):
        w = jdk._ivf_merge_candidates(parts, r)
        g = tdk._ivf_merge_candidates(parts, r)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert len(tdk._ivf_merge_candidates([], 5)[0]) == 0


RANGES = [(0, None), (0, 1), (0, 1500), (1500, 3000), (2999, 3001),
          (4500, 6000), (5999, 6000), (3000, 3000), (6000, 9000)]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_approx_scores_slot_range(ivf_inputs, lo, hi, monkeypatch):
    """The repaired slot range: the host engine equals the reference's
    `_approx_scores_host(lo, hi)` (dgraph_tpu/ops/ivf.py:357) byte for
    byte, and the device route over the same range makes one
    score_int8_lists call (none for a range no probed list meets) with
    the same slots and dots within the reordering bound."""
    corpus, jix, tix = ivf_inputs
    q = corpus[:5] + np.float32(0.01)
    q_t = torch.from_numpy(q)
    cs_t, lists_t = tivf._probe(q_t, tix.centroids_dev, 8, "cosine")
    cs, lists = cs_t.numpy(), lists_t.numpy()
    ws, wd = jivf._approx_scores_host(jix, lists, cs, q, lo=lo, hi=hi)
    hs, hd = tivf._approx_scores_host(tix, lists, cs, q, lo=lo, hi=hi)
    tables = []

    def counted(codes, queries, table, out, **kw):
        tables.append(table)
        return kernels.score_int8_lists(codes, queries, table, out, **kw)

    monkeypatch.setattr(tivf, "score_int8_lists", counted)
    ds, dd = tivf._approx_scores_device(tix, lists, cs, q_t, lo=lo, hi=hi)
    top = tix.n_rows if hi is None else hi
    met = any(max(lo, tix.starts[li]) < min(top, tix.starts[li + 1])
              for li in np.unique(lists))
    assert len(tables) == int(met)
    for qi in range(len(q)):
        assert hs[qi].tobytes() == ws[qi].tobytes()
        assert hd[qi].dtype == wd[qi].dtype
        assert hd[qi].tobytes() == wd[qi].tobytes()
        assert ((hs[qi] >= lo) & (hs[qi] < top)).all()
        np.testing.assert_array_equal(ds[qi], hs[qi])
        assert (np.abs(dd[qi].astype(np.float64) - hd[qi])
                <= _approx_bound(tix, ds[qi], q[qi])).all()


def test_slot_ranges_partition_the_full_stage(ivf_inputs):
    """Four shard ranges together give the full range's candidates."""
    corpus, _, tix = ivf_inputs
    q = corpus[10:13] + np.float32(0.02)
    cs_t, lists_t = tivf._probe(torch.from_numpy(q), tix.centroids_dev, 16,
                                "dot")
    cs, lists = cs_t.numpy(), lists_t.numpy()
    full_s, full_d = tivf._approx_scores_host(tix, lists, cs, q)
    per = -(-tix.n_rows // 4)
    parts = [tivf._approx_scores_host(tix, lists, cs, q, lo=i * per,
                                      hi=min(tix.n_rows, (i + 1) * per))
             for i in range(4)]
    for qi in range(len(q)):
        s = np.concatenate([p[0][qi] for p in parts])
        d = np.concatenate([p[1][qi] for p in parts])
        order = np.argsort(s, kind="stable")
        full_order = np.argsort(full_s[qi], kind="stable")
        np.testing.assert_array_equal(s[order], full_s[qi][full_order])
        np.testing.assert_array_equal(d[order], full_d[qi][full_order])


def test_sharded_ivf_stage_one_call_a_shard(ivf_inputs, monkeypatch):
    """Routed through the device route (on CPU tensors), the sharded
    quantized tier makes one score_int8_lists call a shard whose range
    meets a probed list, and answers as the host route."""
    corpus, _, tix = ivf_inputs
    _, tm = meshes(AXES["uid8"])
    q = corpus[:4] + 0.01
    want = tdk.sharded_ivf_topk(tm, tix, corpus, q, 6, "cosine")
    tables = []

    def counted(codes, queries, table, out, **kw):
        tables.append(table)
        return kernels.score_int8_lists(codes, queries, table, out, **kw)

    monkeypatch.setattr(tivf, "score_int8_lists", counted)
    monkeypatch.setattr(
        tivf, "_approx_scores_host",
        lambda ix, lists, cs, qq, lo=0, hi=None: tivf._approx_scores_device(
            ix, lists, cs, torch.from_numpy(np.ascontiguousarray(qq)),
            lo=lo, hi=hi))
    got = tdk.sharded_ivf_topk(tm, tix, corpus, q, 6, "cosine")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # one call a shard whose slot range meets a probed list (a shard
    # with none launches nothing)
    _, lists = tivf._probe(torch.from_numpy(q), tix.centroids_dev,
                           tix.nprobe, "cosine")
    li = np.unique(lists.numpy())
    per = -(-tix.n_rows // 8)
    busy = [i for i in range(8)
            if (np.maximum(i * per, tix.starts[li])
                < np.minimum((i + 1) * per, tix.starts[li + 1])).any()]
    assert 1 < len(busy) and len(tables) == len(busy)
    for i, t in zip(busy, tables):
        assert (t[:, 0] >= i * per).all()
        assert (t[:, 0] + t[:, 1] <= (i + 1) * per).all()
