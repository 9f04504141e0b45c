"""The similar_to() data plane across its tiers: the port's counterpart of
`bench_vectors.py`.

One regime is a seeded (n, d) float32 corpus (a mixture of Gaussians,
~n/200 centers, sigma 0.25), a batch of queries drawn near corpus rows,
and, at that size: the exact and two-stage device tiers
(`ops/knn.topk_device` over a device-resident block), then the
quantized IVF tier (`ops/ivf`) built once and searched at its
calibrated nprobe and at (nprobe, rerank) budgets of the recall/QPS
frontier. Recall@k is measured against the exact tier on the
unperturbed batch.

    out = run_regime(1_000_000, 128, 256, 10, "cosine", device=None)

QPS is sustained: all timed batches over all the timed wall time, each
batch ending with its answers on the host and the device synchronised.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from dgraph_tpu_torch import backend
from dgraph_tpu_torch.ops import ivf, knn

RECALL_FLOOR = 0.95
RUNS = 3
# frontier probe budgets (intersected with the index's nlist)
FRONTIER_NPROBE = (8, 16, 32, 64, 128)
FRONTIER_RERANK = (64, 256)


def gen_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Seeded blockwise mixture-of-Gaussians corpus: ~n/200 centers,
    sigma 0.25 — allocation stays one (n, d) block + one 1M scratch."""
    rng = np.random.default_rng(seed)
    n_centers = max(64, min(1 << 16, n // 200))
    centers = rng.standard_normal((n_centers, d), dtype=np.float32)
    out = np.empty((n, d), np.float32)
    block = 1 << 20
    for s in range(0, n, block):
        e = min(n, s + block)
        a = rng.integers(0, n_centers, e - s)
        out[s:e] = centers[a]
        out[s:e] += np.float32(0.25) * rng.standard_normal(
            (e - s, d), dtype=np.float32)
    return out


def draw_queries(corpus: np.ndarray, batch: int, seed: int = 1
                 ) -> np.ndarray:
    """`batch` queries near seeded corpus rows (noise sigma 0.05)."""
    n, d = corpus.shape
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, batch)
    return corpus[rows] + np.float32(0.05) * rng.standard_normal(
        (batch, d), dtype=np.float32)


def recall(exact_idx: np.ndarray, got_idx: np.ndarray) -> float:
    hits = sum(len(set(exact_idx[b].tolist()) & set(got_idx[b].tolist()))
               for b in range(len(exact_idx)))
    return hits / float(exact_idx.shape[0] * exact_idx.shape[1])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_batches(fn: Callable[[np.ndarray], object], queries: np.ndarray,
                 runs: int, device: torch.device) -> list[float]:
    """Wall seconds of `runs` calls of `fn`, each on the batch perturbed
    by 1e-6 * (run + 1) so no call repeats the last one's input; the
    clock stops after the device is synchronised."""
    times = []
    for r in range(runs):
        qs = queries + np.float32(1e-6 * (r + 1))
        t0 = time.perf_counter()
        fn(qs)
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def qps(batch: int, times: list[float]) -> float:
    """Sustained queries per second: all batches over all the time."""
    return batch * len(times) / sum(times)


def frontier_budgets(nlist: int, k: int) -> list[tuple[int, int]]:
    """(nprobe, rerank) budgets of the frontier, nprobe capped at
    nlist, rerank at least k."""
    return [(p, r) for p in sorted({min(p, nlist) for p in FRONTIER_NPROBE})
            for r in FRONTIER_RERANK if r >= k]


def run_regime(n: int, d: int, batch: int, k: int, metric: str = "cosine",
               device: str | torch.device | None = None,
               budgets: list[tuple[int, int]] | None = None,
               runs: int = RUNS) -> dict:
    """All tiers at one corpus size -> one regime entry, as
    `bench_vectors.bench_regime` gives, plus `answers`: the index
    arrays each tier returned on the unperturbed batch. `budgets`
    defaults to the whole frontier."""
    dev = backend.resolve_device(device)
    t0 = time.perf_counter()
    corpus = gen_corpus(n, d, seed=0)
    queries = draw_queries(corpus, batch)
    out: dict = {"n": n, "dim": d, "k": k, "batch": batch,
                 "metric_fn": metric, "device": str(dev),
                 "corpus_s": time.perf_counter() - t0}
    answers: dict = {}

    corpus_dev = torch.from_numpy(corpus).to(dev)

    def exact_tier(two_stage):
        def fn(qs):
            return knn.topk_device(corpus_dev, qs, k, metric,
                                   two_stage=two_stage)
        fn(queries)                                    # warm
        return qps(batch, time_batches(fn, queries, runs, dev))

    out["device_exact_qps"] = exact_tier(False)
    ei, _ = knn.topk_device(corpus_dev, queries, k, metric,
                            two_stage=False)
    answers["exact"] = ei
    if knn.can_two_stage(n, k):
        out["device_two_stage_qps"] = exact_tier(True)
        ai, _ = knn.topk_device(corpus_dev, queries, k, metric,
                                two_stage=True)
        answers["two_stage"] = ai
        out["two_stage_recall_at_k"] = recall(ei, ai)
    else:
        out["device_two_stage_qps"] = None
        out["two_stage_recall_at_k"] = None
    del corpus_dev

    # quantized tier: build once, then the calibrated budget and the
    # frontier
    t0 = time.perf_counter()
    ix = ivf.build(corpus, seed=0, device=dev)
    out["quantized_index"] = dict(ix.describe(),
                                  build_s=time.perf_counter() - t0)

    def quantized(p, r):
        def fn(qs):
            return ivf.search(ix, corpus, qs, k, metric, nprobe=p,
                              rerank=r)
        fn(queries[:8])                                # warm
        ent = {"nprobe": p, "rerank": r or ivf.rerank_depth(k),
               "qps": qps(batch, time_batches(fn, queries, runs, dev))}
        gi, _ = fn(queries)
        ent["recall_at_k"] = recall(ei, gi)
        return ent, gi

    out["quantized_calibrated"], answers["calibrated"] = \
        quantized(ix.nprobe, None)
    frontier = []
    answers["frontier"] = {}
    best = None
    if budgets is None:
        budgets = frontier_budgets(ix.nlist, k=k)
    for p, r in budgets:
        ent, gi = quantized(p, r)
        frontier.append(ent)
        answers["frontier"][(p, r)] = gi
        if ent["recall_at_k"] >= RECALL_FLOOR and (
                best is None or ent["qps"] > best["qps"]):
            best = ent
    out["frontier"] = frontier
    out["quantized_qps"] = best["qps"] if best else None
    out["quantized_recall_at_k"] = best["recall_at_k"] if best else None
    out["quantized_best"] = ({"nprobe": best["nprobe"],
                              "rerank": best["rerank"]} if best else None)
    out["answers"] = answers
    return out
