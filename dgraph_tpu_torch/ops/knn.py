"""Brute-force top-k for similar_to(): the port of `dgraph_tpu/ops/knn.py`.

Two tiers, as in the reference:

- host: numpy exact top-k with float64 accumulation (`score_host`,
  `topk_host`), copied from the reference. It is the float64 oracle and
  the quantized tier's re-rank engine (`ops/ivf.py`).
- device: the scores `queries . corpus^T` come from the hand-written
  kernel `ops/kernels.score_dot` (`csrc/score.cu`); the cosine and
  euclidean epilogues, the masking and the top-k are PyTorch, in the
  reference's operation order. `topk_device` reduces either exactly or
  with the two-stage bucketed approximate top-k (TPU-KNN's partial
  reduce, then an exact top-k over the bucket winners).

Scores are "higher is better" for every metric: dot is the raw inner
product, cosine normalises both sides, euclidean is the negated squared
L2 distance.

Tie order. The reference's `lax.top_k` keeps the lower index first
among equal values, and the host tier sorts by (-score, idx).
`torch.topk` promises no order among ties, so `_topk_ordered` takes the
top-k of an int64 key: the order-preserving bits of the float32 score
above the complemented index. Ties then resolve to the lower index,
and -0.0 orders below +0.0, as in `lax.top_k`'s total order on the
CPU. `torch.argmax` returns the first maximum, as `jnp.argmax` does
(which, like it, treats -0.0 and +0.0 as equal).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from dgraph_tpu_torch import backend
from dgraph_tpu_torch.ops.kernels import score_dot

METRICS = ("cosine", "dot", "euclidean")

# two-stage engages only above this corpus size — below it the exact
# top_k is already cheap and the bucket shuffle pure overhead
TWO_STAGE_MIN_ROWS = 4096
BUCKET_SIZE = 128          # n-axis bucket width, and the row-padding unit
RECALL_TARGET = 0.99

_LOW32 = (1 << 32) - 1


def expected_loss(nb: int, k: int, l_per_bucket: int) -> float:
    """Expected fraction of the true top-k the two-stage reduce loses,
    for a random corpus order over nb buckets keeping L candidates per
    bucket (2506.04165 §3 collision analysis): item ranked i is lost
    iff its bucket already holds >= L higher-ranked items, so the
    per-item loss is ~ C(i, L)/nb^L and the mean over i < k is
    C(k, L+1) / (k * nb^L)."""
    if k <= l_per_bucket:
        return 0.0
    return math.comb(k, l_per_bucket + 1) / (k * float(nb) ** l_per_bucket)


def plan_two_stage(n: int, k: int,
                   recall: float = RECALL_TARGET) -> int:
    """Candidates-per-bucket L for the two-stage path, or 0 for exact
    fallback. Picks the smallest L in {1, 2} whose expected loss is
    under a quarter of the recall budget; corpora too small to bucket,
    or k too large for the budget, fall back to exact."""
    if n < TWO_STAGE_MIN_ROWS:
        return 0
    nb = n // BUCKET_SIZE
    budget = (1.0 - recall) / 4.0
    for l_per_bucket in (1, 2):
        if expected_loss(nb, k, l_per_bucket) <= budget:
            return l_per_bucket
    return 0


def can_two_stage(n: int, k: int, recall: float = RECALL_TARGET) -> bool:
    return plan_two_stage(n, k, recall) > 0


# ---------------------------------------------------------------------------
# host tier (exact, float64 accumulation)
# ---------------------------------------------------------------------------


def score_host(corpus: np.ndarray, queries: np.ndarray,
               metric: str) -> np.ndarray:
    """(n, d) x (q, d) -> (q, n) float64 scores, higher = closer."""
    c = np.asarray(corpus, np.float64)
    q = np.atleast_2d(np.asarray(queries, np.float64))
    if metric == "cosine":
        cn = np.linalg.norm(c, axis=1)
        qn = np.linalg.norm(q, axis=1)
        dots = q @ c.T
        denom = np.outer(qn, cn)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.where(denom > 0, dots / np.where(denom > 0, denom, 1),
                           0.0)
        return out
    if metric == "dot":
        return q @ c.T
    if metric == "euclidean":
        c2 = np.sum(c * c, axis=1)
        q2 = np.sum(q * q, axis=1)
        return -(q2[:, None] - 2.0 * (q @ c.T) + c2[None, :])
    raise ValueError(f"unknown metric {metric!r}")


def _topk_rows(scores: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row exact top-k with (-score, idx) order over a (q, n)
    float matrix that may contain -inf for masked rows."""
    q, n = scores.shape
    k_eff = min(k, n)
    if k_eff == 0:
        return (np.empty((q, 0), np.int64), np.empty((q, 0), scores.dtype))
    if k_eff < n:
        part = np.argpartition(-scores, k_eff - 1, axis=1)[:, :k_eff]
    else:
        part = np.tile(np.arange(n), (q, 1))
    psc = np.take_along_axis(scores, part, axis=1)
    order = np.lexsort((part, -psc), axis=1)
    idx = np.take_along_axis(part, order, axis=1)
    sc = np.take_along_axis(psc, order, axis=1)
    return idx.astype(np.int64), sc


def topk_host(corpus: np.ndarray, queries: np.ndarray, k: int,
              metric: str = "cosine",
              mask: np.ndarray | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k: (idx (q, k'), scores (q, k')) sorted by
    (-score, idx) — the deterministic tiebreak every tier shares."""
    scores = score_host(corpus, queries, metric)
    if mask is not None:
        scores = np.where(np.asarray(mask, bool)[None, :], scores, -np.inf)
    idx, sc = _topk_rows(scores, k)
    # rows are score-descending so -inf entries (masked/absent rows)
    # form a suffix per row; keep the widest per-query valid width and
    # let callers trim per query on -inf
    finite = np.isfinite(sc)
    if not finite.all():
        keep = int(finite.sum(axis=1).max(initial=0))
        idx, sc = idx[:, :keep], sc[:, :keep]
    return idx, sc


# ---------------------------------------------------------------------------
# device tier
# ---------------------------------------------------------------------------


def _topk_ordered(x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of a float32 tensor in `lax.top_k`'s
    order: value descending, ties by lower index. Returns (values,
    int64 indices)."""
    n = x.shape[-1]
    # order-preserving int32 image of the float: negative floats get
    # their magnitude bits flipped
    key = x.contiguous().view(torch.int32).to(torch.int64)
    key ^= (key >> 63) & 0x7FFFFFFF
    key <<= 32
    key += _LOW32 - torch.arange(n, dtype=torch.int64, device=x.device)
    top = torch.topk(key, k, dim=-1, largest=True, sorted=True).values
    idx = _LOW32 - (top & _LOW32)
    return x.gather(-1, idx), idx


def _score_device(corpus: torch.Tensor, queries: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """(b, n) float32 scores of `metric`: the dots from the kernel, then
    the reference's epilogue in the same operation order."""
    dots = score_dot(corpus, queries)
    if metric == "dot":
        return dots
    if metric == "cosine":
        cn = torch.sqrt(torch.sum(corpus * corpus, dim=1))
        qn = torch.sqrt(torch.sum(queries * queries, dim=1))
        denom = qn[:, None] * cn[None, :]
        pos = denom > 0
        return torch.where(pos, dots / torch.where(pos, denom, 1.0), 0.0)
    if metric == "euclidean":
        c2 = torch.sum(corpus * corpus, dim=1)
        q2 = torch.sum(queries * queries, dim=1)
        return -(q2[:, None] - 2.0 * dots + c2[None, :])
    raise ValueError(f"unknown metric {metric!r}")


@lru_cache(maxsize=64)
def _dispersal_perm(n_pad: int) -> np.ndarray:
    """Deterministic row-dispersal permutation for the two-stage
    bucketing. The recall bound assumes rows land in buckets at
    random, but the scored block is packed uid-ascending — near-
    duplicate embeddings ingested under consecutive uids would share
    one bucket and break the bound. A multiplicative stride coprime
    with n_pad (golden-ratio start) sends any run of consecutive rows
    to positions `stride` apart, i.e. distinct buckets, without an RNG
    (stable across processes)."""
    stride = (int(0.6180339887 * n_pad) | 1) or 1
    while math.gcd(stride, n_pad) != 1:
        stride += 2
    # original row j lands at permuted slot (j * stride) % n_pad. As a
    # gather (slot i reads original perm[i]) that is the modular
    # inverse; perm doubles as the slot -> original index map.
    inv = pow(stride, -1, n_pad)
    return ((np.arange(n_pad, dtype=np.int64) * inv) % n_pad
            ).astype(np.int32)


@lru_cache(maxsize=8)
def _dispersal_perm_on(n_pad: int, device: torch.device) -> torch.Tensor:
    """`_dispersal_perm(n_pad)` as an int64 tensor on `device`, uploaded
    once per (n_pad, device)."""
    return torch.from_numpy(_dispersal_perm(n_pad).astype(np.int64)) \
        .to(device)


def _two_stage_topk_dev(scores: torch.Tensor, k: int, l_per_bucket: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed approximate-then-exact top-k. scores is (q, n_pad) with
    -inf in padded/masked columns; returns (vals, idx) over the padded
    axis."""
    qn, n_pad = scores.shape
    nb = n_pad // BUCKET_SIZE
    # disperse uid-contiguous rows across buckets (see _dispersal_perm)
    perm = _dispersal_perm_on(n_pad, scores.device)
    bucketed = scores[:, perm].view(qn, nb, BUCKET_SIZE)
    base = torch.arange(nb, dtype=torch.int64,
                        device=scores.device) * BUCKET_SIZE
    # stage 1: partial reduce — top-L inside each bucket (L=1 is a
    # plain max + argmax, the TPU-KNN PartialReduce)
    if l_per_bucket == 1:
        cand_vals = torch.amax(bucketed, dim=2)                # (q, nb)
        cand_idx = torch.argmax(bucketed, dim=2) + base[None, :]
    else:
        bvals, barg = _topk_ordered(bucketed, l_per_bucket)    # (q, nb, L)
        cand_vals = bvals.reshape(qn, nb * l_per_bucket)
        cand_idx = (barg + base[None, :, None]).reshape(qn,
                                                        nb * l_per_bucket)
    # stage 2: exact top-k over the nb*L candidates, mapped back to the
    # unpermuted row axis
    vals, pos = _topk_ordered(cand_vals, min(k, cand_vals.shape[1]))
    idx = cand_idx.gather(1, pos)
    return vals, perm[idx]


def pad_rows(corpus: np.ndarray, unit: int = BUCKET_SIZE) -> np.ndarray:
    """Zero-pad the row axis to a `unit` multiple (host-side, once per
    block build)."""
    n, d = corpus.shape
    n_pad = max(unit, ((n + unit - 1) // unit) * unit)
    if n_pad == n:
        return corpus
    out = np.zeros((n_pad, d), np.float32)
    out[:n] = corpus
    return out


def topk_device(corpus_dev, queries: np.ndarray, k: int,
                metric: str = "cosine",
                mask: np.ndarray | None = None,
                two_stage: bool | None = None,
                l_per_bucket: int | None = None,
                n_real: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Device top-k over an (n, d) corpus. Returns host (idx int64
    (q, k'), scores float32 (q, k')) with idx into the corpus row axis;
    masked-out and padding rows score -inf.

    `corpus_dev` is a float32 tensor, which is used where it lies, or a
    numpy block, which is copied to `device` (None: the card). `n_real`
    marks a corpus whose trailing rows are zero padding (`pad_rows`):
    only the first n_real rows are live. The score axis is padded with
    -inf to a multiple of BUCKET_SIZE, as the reference pads its corpus,
    so the two-stage buckets and the returned padding indices are the
    reference's.

    two_stage=None selects the bucketed approximate path when the
    corpus can hold the RECALL_TARGET bound and exact top-k otherwise;
    two_stage=True falls back to exact where it cannot."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if isinstance(corpus_dev, torch.Tensor):
        dev = corpus_dev.device if device is None else \
            backend.resolve_device(device)
        corpus_t = corpus_dev.to(dev, torch.float32).contiguous()
    else:
        dev = backend.resolve_device(device)
        corpus_t = torch.from_numpy(
            np.ascontiguousarray(corpus_dev, np.float32)).to(dev)
    n_rows = corpus_t.shape[0]
    n = n_rows if n_real is None else int(n_real)
    q = torch.from_numpy(np.ascontiguousarray(
        np.atleast_2d(np.asarray(queries, np.float32)))).to(dev)
    n_pad = max(BUCKET_SIZE,
                ((n_rows + BUCKET_SIZE - 1) // BUCKET_SIZE) * BUCKET_SIZE)
    plan = plan_two_stage(n, k)
    if two_stage is None:
        two_stage = plan > 0
    elif two_stage and plan == 0:
        two_stage = False  # the bucket count can't hold the recall target
    if l_per_bucket is None:
        l_per_bucket = max(plan, 1)

    scores = _score_device(corpus_t, q, metric)
    if n_pad != n_rows:
        scores = torch.nn.functional.pad(scores, (0, n_pad - n_rows),
                                         value=-math.inf)
    invalid = torch.arange(n_pad, device=dev) >= n
    if mask is not None:
        m = np.zeros(n_pad, bool)
        m[:n] = np.asarray(mask, bool)
        invalid |= ~torch.from_numpy(m).to(dev)
    # in place: the scores are this call's own tensor
    scores.masked_fill_(invalid[None, :], -math.inf)
    if two_stage:
        vals, idx = _two_stage_topk_dev(scores, int(k), int(l_per_bucket))
    else:
        vals, idx = _topk_ordered(scores, min(int(k), n_pad))
    return idx.cpu().numpy(), vals.cpu().numpy()


# ---------------------------------------------------------------------------
# k-way merge (per-shard / base+overlay partial results)
# ---------------------------------------------------------------------------


def merge_topk(parts: list[tuple[np.ndarray, np.ndarray]], k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Merge [(uids, scores), ...] partial top-k lists into the global
    top-k, ordered by (-score, uid)."""
    parts = [(np.asarray(u, np.uint64), np.asarray(s, np.float64))
             for u, s in parts if len(np.atleast_1d(u))]
    if not parts:
        return np.empty(0, np.uint64), np.empty(0, np.float64)
    uids = np.concatenate([u for u, _ in parts])
    scores = np.concatenate([s for _, s in parts])
    ok = np.isfinite(scores)
    uids, scores = uids[ok], scores[ok]
    # a uid may appear in several parts: keep its best score
    order = np.lexsort((uids, -scores))
    uids, scores = uids[order], scores[order]
    seen = set()
    out_u, out_s = [], []
    for u, s in zip(uids.tolist(), scores.tolist()):
        if u in seen:
            continue
        seen.add(u)
        out_u.append(u)
        out_s.append(s)
        if len(out_u) == k:
            break
    return np.asarray(out_u, np.uint64), np.asarray(out_s, np.float64)
