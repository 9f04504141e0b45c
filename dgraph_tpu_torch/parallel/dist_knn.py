"""Mesh-sharded top-k (similar_to at multi-device scale): the port of
`dgraph_tpu/parallel/dist_knn.py`.

A predicate's (n, d) embedding block is row-sharded over the mesh's
`uid` axis (the axis that shards one predicate's adjacency). One step
is, in `parallel/compat.py`'s phases:

    local:      scores = q . local_rows^T (the hand-written `score_dot`
                kernel through `knn._score_device`, one launch a shard)
                -> a top-k per shard in `lax.top_k`'s order
    collective: all_gather the per-shard (vals, global row idx)
                candidates onto the first shard's device
    local:      an exact top-k over the S*k candidates

which is the TPU-KNN multi-chip layout (PAPERS.md 2206.14286 §4: shard
the database, per-shard partial top-k, merge). Ties keep the lower
local index, then the lower gathered position (shard order). The final
merge with MVCC overlay rows happens on the host via ops/knn.merge_topk.

The quantized tier (`sharded_ivf_topk`) splits the index's clustered
slot axis into one contiguous range a shard; each shard's approximate
stage is one `score_int8_lists` launch over its range, on the index's
device. Shards run one after another (see `parallel/compat.py`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dgraph_tpu_torch.ops import ivf as _ivf
from dgraph_tpu_torch.ops import knn
from dgraph_tpu_torch.parallel.compat import (
    all_gather, axis_devices, axis_index, shard_loop,
)
from dgraph_tpu_torch.parallel.mesh import Mesh


def shard_corpus(mesh: Mesh, corpus: np.ndarray, axis: str = "uid"
                 ) -> tuple[list[torch.Tensor], int]:
    """Pad the row axis to the shard count and place one row block on
    each shard's device. Returns (per-shard float32 [per, d] tensors,
    n_real)."""
    devs = axis_devices(mesh, axis)
    s = len(devs)
    n, d = corpus.shape
    per = max(knn.BUCKET_SIZE, -(-n // s))
    padded = np.zeros((per * s, d), np.float32)
    padded[:n] = corpus
    return [torch.from_numpy(padded[i * per:(i + 1) * per]).to(dev)
            for i, dev in enumerate(devs)], n


def sharded_topk(mesh: Mesh, corpus_dev: list[torch.Tensor],
                 queries: np.ndarray, k: int,
                 metric: str = "cosine",
                 mask: np.ndarray | None = None,
                 n_real: int | None = None,
                 axis: str = "uid") -> tuple[np.ndarray, np.ndarray]:
    """Per-shard top-k + merge. corpus_dev is shard_corpus's block;
    returns host (idx (q, k'), scores (q, k')) with idx into the
    UNPADDED row axis (entries whose score is -inf are padding and must
    be dropped by the caller)."""
    if metric not in knn.METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    per = corpus_dev[0].shape[0]
    n_pad = per * len(corpus_dev)
    if n_real is None:
        n_real = n_pad
    q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries,
                                                      np.float32)))
    m = np.zeros(n_pad, bool)
    m[:n_real] = True if mask is None else np.asarray(mask, bool)
    k_eff = min(k, per)
    fn = _sharded_step(mesh, axis, per, k, k_eff, metric)
    vals, idx = fn(corpus_dev, q, m)
    return idx.cpu().numpy(), vals.cpu().numpy()


@functools.lru_cache(maxsize=64)
def _sharded_step(mesh: Mesh, axis: str, per: int, k: int, k_eff: int,
                  metric: str):
    """The step for one (mesh, layout, k, metric), cached as the
    reference caches its jitted shard_map step: fn(corpus shards, host
    queries, host row mask) -> (vals, global idx) on the first shard's
    device."""
    first = axis_devices(mesh, axis)[0]

    def step(corpus_dev, q, m):
        def local(shard, rows):
            lo = axis_index(shard) * per
            qd = torch.from_numpy(q).to(shard.device)
            keep = torch.from_numpy(m[lo:lo + per]).to(shard.device)
            scores = knn._score_device(rows, qd, metric)
            scores = scores.masked_fill(~keep[None, :], -math.inf)
            vals, idx = knn._topk_ordered(scores, k_eff)
            return vals, idx + lo

        parts = shard_loop(mesh, axis, local, corpus_dev)
        av = all_gather([v for v, _ in parts], first, dim=1)
        ai = all_gather([i for _, i in parts], first, dim=1)
        fvals, fpos = knn._topk_ordered(av, min(k, av.shape[1]))
        return fvals, ai.gather(1, fpos)

    return step


# ---------------------------------------------------------------------------
# sharded quantized tier (ops/ivf.py index over a row-sharded corpus)
# ---------------------------------------------------------------------------


def sharded_ivf_topk(mesh: Mesh, ivf, vecs: np.ndarray,
                     queries: np.ndarray, k: int,
                     metric: str = "cosine",
                     keep: np.ndarray | None = None,
                     nprobe: int | None = None,
                     rerank: int | None = None,
                     axis: str = "uid") -> tuple[np.ndarray, np.ndarray]:
    """Quantized top-k over a sharded corpus: the clustered slot axis
    splits into one contiguous range per mesh shard (the row partition
    shard_corpus uses), each shard scores ONLY its slice of every probed
    list and keeps its local top-R approximate survivors, and the
    per-shard candidate lists merge (the (-approx, slot) cut) into the
    global top-R before ONE exact re-rank.

    Parity by construction: the shard ranges PARTITION the clustered
    slots, each shard's top-R is a superset of its contribution to the
    global top-R, and the merge cuts by the same (-approx, slot) order
    the single-device path uses — so the re-ranked result is identical
    to ops/ivf.search."""
    if metric not in knn.METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    q = np.atleast_2d(np.asarray(queries, np.float32))
    nq = len(q)
    p = min(ivf.nlist, int(nprobe or ivf.nprobe))
    r_depth = int(rerank or _ivf.rerank_depth(k))
    q_t = torch.from_numpy(np.ascontiguousarray(q)).to(ivf.device)
    cs_t, lists_t = _ivf._probe(q_t, ivf.centroids_dev, p, str(metric))
    cs = cs_t.cpu().numpy()
    lists = lists_t.cpu().numpy()
    keep_b = np.asarray(keep, bool) if keep is not None else None
    qn2 = (q.astype(np.float64) ** 2).sum(axis=1)
    n = ivf.n_rows
    s = mesh.shape[axis]
    per = -(-n // s)

    def local(shard):
        lo = axis_index(shard) * per
        hi = min(n, lo + per)
        if lo >= hi:
            return None
        return _shard_ivf_candidates(ivf, lists, cs, q, q_t, lo, hi,
                                     keep_b, qn2, metric, r_depth)

    shard_parts = [sp for sp in shard_loop(mesh, axis, local)
                   if sp is not None]
    out_i = np.full((nq, k), -1, np.int64)
    out_s = np.full((nq, k), -np.inf, np.float64)
    width = 0
    for qi in range(nq):
        # merge of the per-shard survivor lists, cut to the global top-R
        # by the single-device (-approx, slot) order
        merged_slots, _ = _ivf_merge_candidates(
            [(sp[0][qi], sp[1][qi]) for sp in shard_parts], r_depth)
        if not len(merged_slots):
            continue
        rws, sc = _ivf._rerank_one(ivf, vecs, merged_slots, q[qi], k,
                                   metric)
        w = len(rws)
        out_i[qi, :w] = rws
        out_s[qi, :w] = sc
        width = max(width, w)
    return out_i[:, :width], out_s[:, :width]


def _shard_ivf_candidates(ivf, lists, cs, q, q_t, lo, hi, keep_b, qn2,
                          metric, r_depth):
    """One shard's local top-R approximate survivors: the single-device
    approximate stage restricted to the shard's contiguous slot range
    [lo, hi) (one `score_int8_lists` launch on the card, the host engine
    on the CPU), then the shared per-query filter + transform + cut
    (ops/ivf._filter_cut — one implementation, so the parity claim
    can't rot)."""
    if ivf.device.type == "cuda":
        slot_l, dot_l = _ivf._approx_scores_device(ivf, lists, cs, q_t,
                                                   lo=lo, hi=hi)
    else:
        slot_l, dot_l = _ivf._approx_scores_host(ivf, lists, cs, q,
                                                 lo=lo, hi=hi)
    slot_out: list[np.ndarray] = []
    approx_out: list[np.ndarray] = []
    for qi in range(len(lists)):
        slots, approx = _ivf._filter_cut(
            ivf, slot_l[qi], dot_l[qi], keep_b, float(qn2[qi]),
            metric, r_depth)
        slot_out.append(slots)
        approx_out.append(np.asarray(approx, np.float64))
    return slot_out, approx_out


def _ivf_merge_candidates(parts, r_depth):
    """Merge per-shard (slots, approx) survivor lists and cut to the
    global top-R with the SAME deterministic (-approx, slot) rule as
    the single-device truncation (ops/ivf._cut_top_r) — including on
    boundary ties (duplicate vectors), so the candidate set entering
    the exact re-rank is identical by construction."""
    slots = np.concatenate([p[0] for p in parts]) \
        if parts else np.empty(0, np.int64)
    approx = np.concatenate([p[1] for p in parts]) \
        if parts else np.empty(0, np.float64)
    return _ivf._cut_top_r(slots, approx, r_depth)
