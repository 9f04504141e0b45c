"""The port's quantized IVF tier (dgraph_tpu_torch.ops.ivf) against the
JAX reference (dgraph_tpu.ops.ivf) on the CPU.

Inputs are seeded numpy, handed to both. The build must be byte-equal
(the reference's determinism contract, and the proof that k-means took
the same assignments). The search tests carry the reference's index
across with `ivf_index_from_arrays`, so search parity does not rest on
build parity: indices equal, and the float64 re-rank scores equal,
since both re-rank the same rows with the same numpy code. The
approximate dots themselves are float32 sums of depth d in another
order, held within d * 2^-24 * sum_k |q_k c_k| scaled by the row's
dequant scale, plus the centroid term's rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import ivf as jivf
from dgraph_tpu.ops import knn as jknn
from dgraph_tpu_torch.ops import ivf as tivf
from dgraph_tpu_torch.ops import kernels
from dgraph_tpu_torch.utils import metrics

CPU = "cpu"

INDEX_FIELDS = ("centroids", "order", "starts", "codes", "scales", "norms2")


def clustered(n, d, centers=64, sigma=0.3, seed=0):
    """tests/test_knn.py's seeded mixture-of-Gaussians corpus."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    return c[rng.integers(0, centers, n)] + np.float32(sigma) \
        * rng.standard_normal((n, d)).astype(np.float32)


# tests/test_knn.py:292 (Pallas parity corpus) and :315 (determinism)
CORPORA = {"knn292": (4_096, 64, 32, 33, False),
           "knn315": (10_000, 16, 64, 34, True)}


@pytest.fixture(scope="module")
def reference_index():
    """The reference's index over the 4,096 x 64 corpus, built once."""
    n, d, centers, seed, _ = CORPORA["knn292"]
    corpus = clustered(n, d, centers, seed=seed)
    return corpus, jivf.build(corpus, seed=0, calibrate=False)


@pytest.mark.parametrize("name", list(CORPORA))
def test_build_byte_equal(name):
    n, d, centers, seed, calibrate = CORPORA[name]
    corpus = clustered(n, d, centers, seed=seed)
    want = jivf.build(corpus, seed=0, calibrate=calibrate)
    got = tivf.build(corpus, seed=0, calibrate=calibrate, device=CPU)
    for f in INDEX_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f
    assert (got.nlist, got.nprobe, got.sample_recall) == \
        (want.nlist, want.nprobe, want.sample_recall)
    assert got.describe() == want.describe()
    assert torch.equal(got.codes_dev, torch.from_numpy(want.codes))
    assert torch.equal(got.centroids_dev, torch.from_numpy(want.centroids))


def test_index_from_arrays_carries_every_field(reference_index):
    _, want = reference_index
    got = tivf.ivf_index_from_arrays(dataclasses.asdict(want), CPU)
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.device == torch.device(CPU)
    assert torch.equal(got.scales_dev, torch.from_numpy(want.scales))
    assert got.scanned_rows(8) == want.scanned_rows(8)
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("with_keep", [False, True])
def test_search_matches_reference(reference_index, metric, with_keep):
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    q = corpus[:3] + np.float32(0.01)
    keep = None
    if with_keep:
        keep = np.random.default_rng(5).random(len(corpus)) > 0.2
    want = jivf.search(jix, corpus, q, 6, metric, keep=keep, nprobe=8)
    want_p = jivf.search(jix, corpus, q, 6, metric, keep=keep, nprobe=8,
                         use_pallas=True, pallas_interpret=True)
    got = tivf.search(tix, corpus, q, 6, metric, keep=keep, nprobe=8)
    for w in (want, want_p):
        np.testing.assert_array_equal(got[0], w[0])
        np.testing.assert_array_equal(got[1], w[1])


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_full_probe_equals_exact(reference_index, metric):
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    q = corpus[123][None] + np.float32(0.01)
    got = tivf.search(tix, corpus, q, 5, metric, nprobe=tix.nlist)
    want = jivf.search(jix, corpus, q, 5, metric, nprobe=jix.nlist)
    hi, hs = jknn.topk_host(corpus, q, 5, metric)
    np.testing.assert_array_equal(got[0], hi)
    np.testing.assert_array_equal(got[1], hs)
    np.testing.assert_array_equal(got[0], want[0])


def _approx_bound(ix, slots, q1):
    """Float32 reordering bound of the approximate dots at `slots`."""
    codes = np.abs(ix.codes[slots].astype(np.float64))
    dot_b = ix.dim * 2.0 ** -24 * (codes @ np.abs(q1.astype(np.float64)))
    return dot_b * ix.scales[slots] + 1e-6


def test_device_route_equals_host_engine(reference_index, monkeypatch):
    """The kernel's caller, run on CPU tensors: one score_int8_lists call
    per search, over a table of every distinct probed list, the same
    (slots, approx dots) per query in the host engine's order, and the
    same slots as the reference's Pallas caller (which orders by probe
    rank)."""
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    calls = []

    def counted(codes, queries, table, out, **kw):
        calls.append(table)
        return kernels.score_int8_lists(codes, queries, table, out, **kw)

    monkeypatch.setattr(tivf, "score_int8_lists", counted)
    q = corpus[:5] + np.float32(0.01)
    q_t = torch.from_numpy(q)
    cs_t, lists_t = tivf._probe(q_t, tix.centroids_dev, 8, "euclidean")
    cs, lists = cs_t.numpy(), lists_t.numpy()
    hs, hd = tivf._approx_scores_host(tix, lists, cs, q)
    ds, dd = tivf._approx_scores_device(tix, lists, cs, q_t)
    ps, pd = jivf._approx_scores_pallas(jix, lists, cs, q, True)
    assert len(calls) == 1
    li = np.unique(lists)
    assert len(np.unique(calls[0][:, 0])) == \
        int(np.sum(tix.starts[li + 1] > tix.starts[li]))
    for qi in range(len(q)):
        np.testing.assert_array_equal(ds[qi], hs[qi])
        assert dd[qi].dtype == np.float32
        assert (np.abs(dd[qi].astype(np.float64) - hd[qi])
                <= _approx_bound(tix, ds[qi], q[qi])).all()
        order = np.argsort(ps[qi], kind="stable")
        np.testing.assert_array_equal(ds[qi], ps[qi][order])
        assert (np.abs(dd[qi].astype(np.float64) - pd[qi][order])
                <= _approx_bound(tix, ds[qi], q[qi])).all()


@pytest.mark.parametrize("nprobe", [1, 2, 8, 64])
@pytest.mark.parametrize("m_tile", [1, 2, 8])
def test_list_table_covers_the_probe(reference_index, nprobe, m_tile):
    """The table built from a probe: every (list, query) pair of the
    probe exactly once, in chunks of at most m_tile, empty lists
    skipped, each query's scores at the offset of the flat layout (list
    by list id, m * rows floats each, query after query)."""
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    # 40 queries around 3 points: lists probed by many queries
    q = corpus[np.arange(40) % 3] + np.float32(0.01) * np.random.default_rng(
        nprobe).standard_normal((40, corpus.shape[1])).astype(np.float32)
    _, lists_t = tivf._probe(torch.from_numpy(q), tix.centroids_dev, nprobe,
                             "cosine")
    lists = lists_t.numpy()
    plan = tivf._list_plan(tix, lists)
    table, qidx, total = kernels.int8_lists_table(
        [(s, e, qis) for _, s, e, qis in plan], m_tile)
    assert (table[:, 3] >= 1).all() and (table[:, 3] <= m_tile).all()
    # a list probed by more than m_tile queries takes several entries
    assert len(table) == sum(-(-len(qis) // m_tile) for *_, qis in plan)
    assert len(plan) == len(np.unique(table[:, 0]))
    want = {(int(tix.starts[li]), qi) for qi in range(len(q))
            for li in lists[qi] if tix.starts[li + 1] > tix.starts[li]}
    slot_off = {}
    for s, ln, a, m, off in table.tolist():
        li = int(np.searchsorted(tix.starts, s, "right")) - 1
        assert ln == tix.starts[li + 1] - s > 0
        for j in range(m):
            slot_off[a + j] = (s, int(qidx[a + j]), off + j * ln)
    got = [slot_off[i][:2] for i in range(len(qidx))]
    assert len(got) == len(set(got)) and set(got) == want
    off, exp = 0, []
    for _, s, e, qis in plan:
        exp += [off + j * (e - s) for j in range(len(qis))]
        off += len(qis) * (e - s)
    assert [slot_off[i][2] for i in range(len(qidx))] == exp
    assert total == off


def test_probe_matches_reference(reference_index):
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    q = corpus[:7] + np.float32(0.01)
    for metric in ("cosine", "euclidean"):
        wcs, wl = jivf._probe_jit(q, jix.centroids, 8, metric)
        gcs, gl = tivf._probe(torch.from_numpy(q), tix.centroids_dev, 8,
                              metric)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_allclose(gcs.numpy(), np.asarray(wcs),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_search_through_the_device_route_matches_pallas_route(
        reference_index, metric, monkeypatch):
    """`search` with the device route's assembly (on CPU tensors)
    against the reference's use_pallas=True search."""
    corpus, jix = reference_index
    tix = tivf.ivf_index_from_arrays(dataclasses.asdict(jix), CPU)
    monkeypatch.setattr(
        tivf, "_approx_scores_host",
        lambda ix, lists, cs, q: tivf._approx_scores_device(
            ix, lists, cs, torch.from_numpy(np.ascontiguousarray(q))))
    q = corpus[:3] + np.float32(0.01)
    want = jivf.search(jix, corpus, q, 6, metric, nprobe=8,
                       use_pallas=True, pallas_interpret=True)
    got = tivf.search(tix, corpus, q, 6, metric, nprobe=8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_host_helpers_equal():
    rng = np.random.default_rng(7)
    for n in (0, 10, 255, 1000, 100_000, 1_000_000, 10_000_000):
        assert tivf.default_nlist(n) == jivf.default_nlist(n)
    for k in (1, 10, 16, 100):
        assert tivf.rerank_depth(k) == jivf.rerank_depth(k)
    slots = rng.permutation(500).astype(np.int64)
    approx = np.round(rng.standard_normal(500), 1)       # many ties
    for r in (1, 17, 64, 499, 600):
        w = jivf._cut_top_r(slots, approx, r)
        g = tivf._cut_top_r(slots, approx, r)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    vecs = clustered(3000, 16, seed=8)
    q = vecs[:9] + np.float32(0.02)
    for metric in ("dot", "cosine"):
        np.testing.assert_array_equal(
            tivf.exact_topk_blocked(vecs, q, 11, metric, block=1024),
            jivf.exact_topk_blocked(vecs, q, 11, metric, block=1024))


def test_counters_count_builds_and_served_searches():
    corpus = clustered(2_000, 8, 16, seed=9)
    builds = metrics.counter("vector_index_builds_total")
    searches = metrics.counter("vector_quantized_searches_total")
    ix = tivf.build(corpus, seed=0, device=CPU)    # calibration searches
    assert metrics.counter("vector_index_builds_total") == builds + 1
    assert metrics.counter("vector_quantized_searches_total") == searches
    tivf.search(ix, corpus, corpus[:2], 3)
    tivf.search(ix, corpus, corpus[:2], 3, count=False)
    assert metrics.counter("vector_quantized_searches_total") == \
        searches + 1


def test_build_rejects_empty_and_defaults_to_card(monkeypatch):
    with pytest.raises(ValueError, match="empty block"):
        tivf.build(np.zeros((0, 4), np.float32), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tivf.build(clustered(100, 4, 8), calibrate=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tivf.ivf_index_from_arrays({})
