"""The port's brute-force top-k (dgraph_tpu_torch.ops.knn) against the JAX
reference (dgraph_tpu.ops.knn) on the CPU.

Inputs are made with numpy from fixed seeds and handed to both. The
device tier is held to the reference's default route (XLA scoring, rows
padded to BUCKET_SIZE): indices equal, the -inf entries of masked and
padding rows included. Scores agree within 1e-5 relative to the row's
score scale: both sum the same float32 products of depth 32 in other
orders, which moves a dot by at most 32 * 2^-24 (about 1.9e-6) of
sum |q_k c_k|. The host pieces are numpy copies and must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.ops import knn as jknn
from dgraph_tpu_torch.ops import knn as tknn

CPU = "cpu"
N, D = 5000, 32


def corpus_and_queries():
    """5,000 x 32 rows with a zero row and a run of duplicates, and six
    queries, one of them zero."""
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((N, D), dtype=np.float32)
    corpus[10] = 0
    corpus[20:25] = corpus[19]
    q = rng.standard_normal((6, D), dtype=np.float32)
    q[2] = 0
    q[3] = corpus[19]
    return corpus, q


def assert_same(want, got):
    wi, ws = want
    gi, gs = got
    assert gi.dtype == np.int64 and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gs[~fin], ws[~fin])
    scale = max(1.0, float(np.abs(ws[fin]).max(initial=0.0)))
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=1e-5,
                               atol=1e-5 * scale)


# (two_stage, l_per_bucket, k): k = 1 plans L = 1, k = 3 plans L = 2 on
# 5,000 rows; k = 300 cannot hold the recall target and falls back
TIERS = {"exact": (False, None, 3), "two_stage_l2": (True, None, 3),
         "two_stage_l1": (True, 1, 3), "two_stage_k1": (None, None, 1),
         "fallback_k300": (True, None, 300)}


@pytest.mark.parametrize("metric", list(tknn.METRICS))
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("variant", ["plain", "mask", "n_real"])
def test_topk_device_matches_reference(metric, tier, variant):
    corpus, q = corpus_and_queries()
    two_stage, l_per_bucket, k = TIERS[tier]
    kw = {}
    if variant == "mask":
        kw["mask"] = np.random.default_rng(2).random(N) > 0.3
    elif variant == "n_real":
        kw["n_real"] = N - 10
    want = jknn.topk_device(corpus, q, k, metric, two_stage=two_stage,
                            l_per_bucket=l_per_bucket, **kw)
    got = tknn.topk_device(corpus, q, k, metric, two_stage=two_stage,
                           l_per_bucket=l_per_bucket, device=CPU, **kw)
    assert_same(want, got)


@pytest.mark.parametrize("metric", list(tknn.METRICS))
def test_topk_device_k_above_rows_returns_padding(metric):
    """k above the live rows: the padding rows come back as -inf at the
    reference's padded indices."""
    corpus, q = corpus_and_queries()
    corpus = corpus[:50]
    mask = np.ones(50, bool)
    mask[::7] = False
    want = jknn.topk_device(corpus, q, 200, metric, mask=mask)
    got = tknn.topk_device(corpus, q, 200, metric, mask=mask, device=CPU)
    assert got[0].shape == (6, 128)
    assert np.isinf(got[1][:, -80:]).all()
    assert_same(want, got)


def test_topk_device_takes_a_resident_tensor_and_pre_padded_rows():
    corpus, q = corpus_and_queries()
    padded = tknn.pad_rows(corpus)
    np.testing.assert_array_equal(padded, jknn.pad_rows(corpus))
    want = jknn.topk_device(jknn.pad_rows(corpus), q, 3, "cosine",
                            n_real=N)
    got = tknn.topk_device(torch.from_numpy(padded), q, 3, "cosine",
                           n_real=N)
    assert_same(want, got)


def test_topk_device_agrees_with_float64_host():
    corpus, q = corpus_and_queries()
    hi, _ = tknn.topk_host(corpus, q[[0, 1, 4, 5]], 5, "dot")
    di, _ = tknn.topk_device(corpus, q[[0, 1, 4, 5]], 5, "dot",
                             two_stage=False, device=CPU)
    np.testing.assert_array_equal(di, hi)


def test_topk_ordered_matches_lax_top_k_on_ties():
    """Ties of equal values, -0.0 beside +0.0, and -inf keep
    lax.top_k's order (value descending, total order on zeros, lower
    index first)."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        x = rng.integers(-3, 4, (3, 50)).astype(np.float32)
        x *= rng.choice(np.asarray([1, -1], np.float32), (3, 50))  # -0.0
        u = rng.random((3, 50))
        x[u < 0.1] = -np.inf
        x[u > 0.95] = np.inf
        wv, wi = jax.lax.top_k(jnp.asarray(x), 17)
        gv, gi = tknn._topk_ordered(torch.from_numpy(x), 17)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                      np.asarray(wv).view(np.int32))


@pytest.mark.parametrize("n_pad", [128, 256, 4096, 5120, 1_000_064])
def test_dispersal_perm_equal(n_pad):
    np.testing.assert_array_equal(tknn._dispersal_perm(n_pad),
                                  jknn._dispersal_perm(n_pad))


def test_plan_two_stage_equal():
    for n in (100, 4095, 4096, 5000, 20_000, 100_000, 1_000_000):
        for k in (1, 2, 3, 10, 50, 300):
            assert tknn.plan_two_stage(n, k) == jknn.plan_two_stage(n, k)
            assert tknn.can_two_stage(n, k) == jknn.can_two_stage(n, k)
    for nb, k, lpb in ((39, 10, 1), (1000, 10, 2), (7, 2, 2)):
        assert tknn.expected_loss(nb, k, lpb) == \
            jknn.expected_loss(nb, k, lpb)


@pytest.mark.parametrize("metric", list(tknn.METRICS))
def test_topk_host_equal(metric):
    corpus, q = corpus_and_queries()
    mask = np.random.default_rng(3).random(N) > 0.5
    for kw in ({}, {"mask": mask}):
        want = jknn.topk_host(corpus, q, 7, metric, **kw)
        got = tknn.topk_host(corpus, q, 7, metric, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_merge_topk_equal():
    rng = np.random.default_rng(4)
    parts = [(rng.choice(50, 6, replace=False).astype(np.uint64),
              np.round(rng.standard_normal(6), 1)) for _ in range(4)]
    parts.append((np.asarray([3], np.uint64), np.asarray([-np.inf])))
    for k in (1, 5, 30):
        want = jknn.merge_topk(parts, k)
        got = tknn.merge_topk(parts, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_unknown_metric_raises():
    corpus, q = corpus_and_queries()
    with pytest.raises(ValueError, match="unknown metric"):
        tknn.topk_device(corpus, q, 3, "manhattan", device=CPU)


def test_topk_device_defaults_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus, q = corpus_and_queries()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tknn.topk_device(corpus, q, 3)


@pytest.mark.parametrize("tier", [True, False])
def test_topk_device_stages(tier):
    """Each call records `knn` and its five stages in order, on the
    two-stage route and on the exact one, and answers alike with them
    on."""
    from dgraph_tpu_torch.utils import tracing
    corpus, q = corpus_and_queries()
    mask = np.ones(N, bool)
    mask[::7] = False

    k = 2                       # small enough for two buckets' winners
    assert tknn.plan_two_stage(N, k) > 0

    def call():
        return tknn.topk_device(corpus, q, k, "euclidean", mask=mask,
                                two_stage=tier, device=CPU)

    plain = call()
    tracing.record_stages(True)
    try:
        staged = call()
    finally:
        tracing.record_stages(False)
    recs = tracing.take_stages()
    for a, b in zip(plain, staged):
        np.testing.assert_array_equal(a, b)
    assert [r["name"] for r in recs] == [
        "knn.upload", "knn.score", "knn.epilogue", "knn.select",
        "knn.fetch", "knn"]
    assert all(r["parent_id"] == recs[-1]["span_id"] for r in recs[:-1])
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(recs, recs[1:-1]))
