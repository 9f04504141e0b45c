"""Plain reference of similar_to's nearest-neighbour search, in plain
PyTorch, with nothing of the program.

`exact` is the float64 search: for each query the k corpus rows of
least squared Euclidean distance, and each row's score, the negated
distance (higher is closer), worked out from the corpus rows
themselves. `control` is the same search put in the program's place one
precision lower than the configuration states: the products in TF32
(operands rounded to 10 mantissa bits, float32 sums), the epilogue in
float32, as a later change that let the card's TF32 path score the
corpus would compute it.

`judge` holds an answer (indices and scores) against the float64
search: the mean share of the true k nearest rows it returns (the
recall the configuration states), and the widest gap between a returned
score and the float64 score of the row it names.
"""

from __future__ import annotations

import torch


def _blocks(n: int, rows: int):
    for a in range(0, n, rows):
        yield a, min(n, a + rows)


def scores_of(corpus: torch.Tensor, queries: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """float64 negated squared distance of each query to each row it
    names, from the differences themselves. idx [q, k] int64."""
    c = corpus[idx.clamp(0, corpus.shape[0] - 1)].to(torch.float64)
    d = c - queries.to(torch.float64)[:, None, :]
    return -(d * d).sum(-1)


def exact(corpus: torch.Tensor, n_rows: int, queries: torch.Tensor,
          k: int, rows: int = 1 << 17) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 top-k over the first n_rows rows of `corpus`, in blocks of
    rows: (int64 idx [q, k], float64 scores [q, k]), best first."""
    q = queries.to(torch.float64)
    q2 = (q * q).sum(1)
    best_s = torch.full((q.shape[0], 0), -torch.inf, dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                         device=q.device)
    for a, b in _blocks(n_rows, rows):
        c = corpus[a:b].to(torch.float64)
        s = -(q2[:, None] - 2.0 * (q @ c.T) + (c * c).sum(1)[None, :])
        v, i = torch.topk(s, min(k, b - a), dim=1)
        best_s, at = torch.topk(torch.cat([best_s, v], 1),
                                min(k, best_s.shape[1] + v.shape[1]), dim=1)
        best_i = torch.cat([best_i, i + a], 1).gather(1, at)
    return best_i, scores_of(corpus, queries, best_i)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def control(corpus: torch.Tensor, n_rows: int, queries: torch.Tensor,
            k: int, rows: int = 1 << 17
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search in TF32 products and float32 sums: (int64 idx, float32
    scores), best first."""
    q = queries.to(torch.float32)
    q2 = (q * q).sum(1)
    qt = tf32(q)
    best_s = torch.full((q.shape[0], 0), -torch.inf, dtype=torch.float32,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                         device=q.device)
    for a, b in _blocks(n_rows, rows):
        c = corpus[a:b].to(torch.float32)
        dots = _tf32_mm(qt, tf32(c))
        s = -(q2[:, None] - 2.0 * dots + (c * c).sum(1)[None, :])
        v, i = torch.topk(s, min(k, b - a), dim=1)
        best_s, at = torch.topk(torch.cat([best_s, v], 1),
                                min(k, best_s.shape[1] + v.shape[1]), dim=1)
        best_i = torch.cat([best_i, i + a], 1).gather(1, at)
    return best_i, best_s


def _tf32_mm(qt: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """float32 products of TF32-rounded operands with TF32 off, so the
    card rounds nothing further (the CPU has no TF32 path)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return qt @ ct.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def judge(corpus: torch.Tensor, n_rows: int, queries: torch.Tensor,
          idx: torch.Tensor, scores: torch.Tensor, k: int
          ) -> dict[str, float]:
    """An answer (idx [q, k'], scores [q, k']) against the float64
    search: `recall_at_k`, the mean share of each query's true k nearest
    rows among its returned rows, and `score_gap`, the widest distance
    between a returned score and the float64 score of the row it names.
    A row outside [0, n_rows), a score that is not finite, or fewer than
    k rows make the gap infinite."""
    true_i, _ = exact(corpus, n_rows, queries, k)
    idx = idx.to(true_i.device, torch.int64)
    scores = scores.to(true_i.device, torch.float64)
    hits = (idx[:, :, None] == true_i[:, None, :]).any(2).sum()
    recall = float(hits) / float(true_i.numel())
    bad = (idx < 0) | (idx >= n_rows) | ~torch.isfinite(scores)
    if idx.shape[1] < k or bool(bad.any()):
        return {"recall_at_k": recall, "score_gap": float("inf")}
    gap = (scores - scores_of(corpus, queries, idx)).abs().max()
    return {"recall_at_k": recall, "score_gap": float(gap)}
