"""Entry: similar_to's device search, `ops.knn.topk_device`, called as the
query executor calls it for a served similar_to: over the padded device
block of the corpus (`knn.pad_rows`' layout, built here on the card),
with `n_real` the live rows, no mask, and the tier the engine picks for
the corpus size (`two_stage` left to the program).

Set-up makes the corpus on the card from the seed and a pool of
distinct query batches drawn from the corpus's own mixture, kept on the
host as the executor
holds a query. A request is one call of B queries; it returns when the
indices and scores are on the host. Requests cycle through the pool.

The check, once the window has closed, takes calls drawn from the seed
among those that completed and holds their indices and scores against
the float64 search over the same corpus (`reference/knn.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import gen
from benchmark.reference import knn as ref
from benchmark.work import knn as work
from dgraph_tpu_torch.ops import knn


class Entry:
    def __init__(self, ctx):
        sizes, tr = ctx.config["sizes"], ctx.traffic
        self.dev = ctx.device
        self.seed = ctx.seed
        self.n, self.dim, self.k = sizes["n_rows"], sizes["dim"], sizes["k"]
        self.metric = sizes["metric"]
        self.batch = self.queries = tr["batch"]
        self.in_flight = tr["in_flight"]
        self.n_check = ctx.check["calls"]
        unit = knn.BUCKET_SIZE
        n_pad = max(unit, -(-self.n // unit) * unit)
        mix = sizes["mixture"]
        centers = gen.n_centers(self.n, mix["rows_per_center"],
                                mix["min_centers"], mix["max_centers"])
        self.block = gen.corpus(ctx.seed, self.n, n_pad, self.dim, centers,
                                mix["sigma"], self.dev)
        pool = tr["distinct_batches"]
        self.pool = gen.queries(ctx.seed, pool * self.batch, self.dim,
                                centers, mix["sigma"], self.dev
                                ).cpu().numpy()
        self.pool = self.pool.reshape(pool, self.batch, self.dim)
        self.answers: list[tuple[int, np.ndarray, np.ndarray]] = []

    def dispatch(self, i: int):
        j = i % len(self.pool)
        idx, sc = knn.topk_device(self.block, self.pool[j], self.k,
                                  self.metric, n_real=self.n)
        return j, idx, sc

    def wait(self, handle) -> None:
        self.answers.append(handle)

    def free(self) -> None:
        """The program holds no state of its own between calls."""

    def _sample(self) -> list:
        done = self.answers
        return [done[i] for i in gen.sample(self.seed, len(done),
                                            self.n_check)]

    def check(self) -> dict:
        picked = self._sample()
        if not picked:
            return {"recall_at_k": 0.0, "score_gap": float("inf")}
        q = torch.from_numpy(np.concatenate([self.pool[j]
                                             for j, _, _ in picked]))
        idx = torch.from_numpy(np.concatenate([i for _, i, _ in picked]))
        sc = torch.from_numpy(np.concatenate([s for _, _, s in picked]))
        return ref.judge(self.block, self.n, q.to(self.dev), idx, sc, self.k)

    def work(self, peaks: dict) -> dict:
        s, _ = work.least_seconds(self.batch, self.n, self.dim, self.k,
                                  peaks)
        return {"knn_least_s": s}


def setup(ctx) -> Entry:
    return Entry(ctx)


def control(ctx) -> dict:
    """The numbers compared when the reference in TF32 products
    (`reference/knn.control`) stands in the program's place, over as many
    query batches of the pool as a run checks; no program runs."""
    e = Entry(ctx)
    picked = gen.sample(ctx.seed, len(e.pool), e.n_check)
    q = torch.from_numpy(np.concatenate([e.pool[j] for j in picked])
                         ).to(e.dev)
    idx, sc = ref.control(e.block, e.n, q, e.k)
    return ref.judge(e.block, e.n, q, idx, sc, e.k)
