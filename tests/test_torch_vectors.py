"""The vector search plane as a whole: the port's benchmark
(dgraph_tpu_torch.bench.vectors) against the JAX functions that
bench_vectors.py drives, on the same seeded corpus at 20,000 x 32,
batch 16, k 10, cosine, on the CPU.

Every tier must return the reference's indices, so the recalls are
equal too. Exact and two-stage scores are float32 sums in another
order (see tests/test_torch_knn.py); no top-10 boundary of this corpus
lies within that rounding.
"""

import numpy as np
import pytest

import bench_vectors
from dgraph_tpu.ops import ivf as jivf
from dgraph_tpu.ops import knn as jknn
from dgraph_tpu_torch.bench import vectors as tvec

N, D, BATCH, K, METRIC = 20_000, 32, 16, 10, "cosine"
BUDGETS = [(8, 64), (16, 256)]


@pytest.fixture(scope="module")
def regimes():
    port = tvec.run_regime(N, D, BATCH, K, METRIC, device="cpu",
                           budgets=BUDGETS, runs=1)
    corpus = bench_vectors.gen_corpus(N, D, seed=0)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, N, BATCH)
    queries = corpus[rows] + np.float32(0.05) * rng.standard_normal(
        (BATCH, D), dtype=np.float32)
    ref = {"exact": jknn.topk_device(corpus, queries, K, METRIC,
                                     two_stage=False)[0],
           "two_stage": jknn.topk_device(corpus, queries, K, METRIC,
                                         two_stage=True)[0]}
    ix = jivf.build(corpus, seed=0)
    ref["index"] = ix.describe()
    ref["calibrated"] = jivf.search(ix, corpus, queries, K, METRIC)[0]
    ref["frontier"] = {(p, r): jivf.search(ix, corpus, queries, K, METRIC,
                                           nprobe=p, rerank=r)[0]
                       for p, r in BUDGETS}
    return port, ref, corpus, queries


def test_corpus_and_queries_equal_the_reference_draw():
    corpus = tvec.gen_corpus(3_000, 16, seed=0)
    np.testing.assert_array_equal(corpus,
                                  bench_vectors.gen_corpus(3_000, 16, seed=0))
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 3_000, 8)
    want = corpus[rows] + np.float32(0.05) * rng.standard_normal(
        (8, 16), dtype=np.float32)
    np.testing.assert_array_equal(tvec.draw_queries(corpus, 8), want)


@pytest.mark.parametrize("tier", ["exact", "two_stage", "calibrated"])
def test_tier_answers_equal_reference(regimes, tier):
    port, ref, _, _ = regimes
    np.testing.assert_array_equal(port["answers"][tier], ref[tier])


@pytest.mark.parametrize("budget", BUDGETS)
def test_frontier_answers_equal_reference(regimes, budget):
    port, ref, _, _ = regimes
    np.testing.assert_array_equal(port["answers"]["frontier"][budget],
                                  ref["frontier"][budget])


def test_recalls_and_index_equal_reference(regimes):
    port, ref, _, _ = regimes
    rec = bench_vectors._recall
    assert port["two_stage_recall_at_k"] == rec(ref["exact"],
                                                ref["two_stage"])
    assert port["quantized_calibrated"]["recall_at_k"] == \
        rec(ref["exact"], ref["calibrated"])
    for ent in port["frontier"]:
        key = (ent["nprobe"], ent["rerank"])
        assert ent["recall_at_k"] == rec(ref["exact"], ref["frontier"][key])
    got = dict(port["quantized_index"])
    got.pop("build_s")
    assert got == ref["index"]
    assert port["device"] == "cpu"
    assert port["quantized_recall_at_k"] >= tvec.RECALL_FLOOR


def test_frontier_budgets_match_bench_vectors():
    assert tvec.FRONTIER_NPROBE == bench_vectors.FRONTIER_NPROBE
    assert tvec.FRONTIER_RERANK == bench_vectors.FRONTIER_RERANK
    assert tvec.RECALL_FLOOR == bench_vectors.RECALL_FLOOR
    assert tvec.frontier_budgets(64, 10) == [
        (8, 64), (8, 256), (16, 64), (16, 256), (32, 64), (32, 256),
        (64, 64), (64, 256)]
