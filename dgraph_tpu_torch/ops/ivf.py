"""Quantized IVF: the approximate tier of similar_to(), the port of
`dgraph_tpu/ops/ivf.py`.

Coarse-then-rerank, as in the reference: k-means lists over the base
block, an IVF probe of `nprobe` lists per query, int8 residual codes
scored approximately, and an exact float64 re-rank of the top `rerank`
survivors, so the only recall loss is candidate-set truncation.

On the card the index lives on the device: `codes` (int8), `scales` and
`centroids` are tensors there beside the numpy fields the host tails
read. The probe is a `torch.matmul` against the centroids. The
approximate stage (`_approx_scores_device`) groups the batch by probed
list, as the reference's host engine does, builds a work table of
(list slice, chunk of the queries that probe it) with numpy, and makes
one launch of the hand-written kernel `ops/kernels.score_int8_lists`
(`csrc/score.cu`) for the whole batch: each probed list's contiguous
slice of the codes is read once, nothing is gathered, and the scales
and the centroid term are applied in the kernel. The filter, the
(-approx, slot) cut and the float64 re-rank
stay numpy on the host, as in the reference. On the CPU, `search` runs
the reference's host engine (`_approx_scores_host`).

Index layout (built once per clean base block):

  centroids  (nc, d) f32   k-means centers, trained on a seeded sample
  order      (n,)   i32    base-block row of clustered slot i — rows
                           sorted by (assigned centroid, row), so one
                           probed list is one contiguous slice
  starts     (nc+1,) i64   list offsets into `order`
  codes      (n, d) i8     per-row scalar-quantized residual
                           (row - centroid), clustered order
  scales     (n,)   f32    per-row dequant scale (maxabs/127)
  norms2     (n,)   f32    exact squared L2 of the original rows,
                           clustered order

`build` calibrates nprobe: it measures recall@K_REF on a held-out sample
of base rows against a blocked exact scan and picks the smallest nprobe
on a doubling ladder that clears the target. Everything is seeded and
stable-sorted, so two builds over the same block byte-match.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch import backend
from dgraph_tpu_torch.ops import knn
from dgraph_tpu_torch.ops.kernels import (int8_lists_table, lists_m_tile,
                                          score_int8_lists)
from dgraph_tpu_torch.utils.metrics import inc_counter

# calibration reference k: nprobe is tuned for recall@K_REF
K_REF = 10
# recall target the build calibrates nprobe against (conservative:
# the acceptance floor is 0.95, the default budget aims past it)
TARGET_RECALL = 0.98
# re-rank depth: max(RERANK_MIN, RERANK_MULT * k) survivors get the
# exact float64 re-rank
RERANK_MULT = 4
RERANK_MIN = 64
# calibration sample size (held-out base rows scored exactly, blocked)
CALIB_QUERIES = 64
# nprobe doubling ladder the calibration walks
NPROBE_LADDER = (4, 8, 16, 32, 64, 128, 256)
# k-means: Lloyd iterations over a seeded sample
KMEANS_ITERS = 6
KMEANS_SAMPLE_PER_LIST = 128
# assignment matmul block (rows per step — bounds peak memory at
# nlist * BLOCK f32 scores)
ASSIGN_BLOCK = 1 << 18


def default_nlist(n: int) -> int:
    """Power-of-two near sqrt(n), floored so the mean list still holds
    enough rows for the coarse quantizer to pay (>= ~32/list), min 8."""
    if n <= 0:
        return 8
    target = int(math.sqrt(n))
    nlist = 1 << max(3, target.bit_length() - 1)
    while nlist * 32 > n and nlist > 8:
        nlist //= 2
    return nlist


def rerank_depth(k: int) -> int:
    return max(RERANK_MIN, RERANK_MULT * int(k))


@dataclass
class IVFIndex:
    """The trained quantized index over one base block. The numpy
    fields are the reference's; `centroids_dev`, `codes_dev` and
    `scales_dev` hold the same data on the index's device."""

    dim: int
    nlist: int
    centroids: np.ndarray   # (nc, d) f32
    order: np.ndarray       # (n,) i32
    starts: np.ndarray      # (nc+1,) i64
    codes: np.ndarray       # (n, d) i8
    scales: np.ndarray      # (n,) f32
    norms2: np.ndarray      # (n,) f32
    nprobe: int             # calibrated default
    sample_recall: float    # measured recall@K_REF at `nprobe`
    target_recall: float
    seed: int
    centroids_dev: torch.Tensor | None = field(default=None, repr=False)
    codes_dev: torch.Tensor | None = field(default=None, repr=False)
    scales_dev: torch.Tensor | None = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.codes_dev.device

    @property
    def n_rows(self) -> int:
        return len(self.order)

    @property
    def nbytes(self) -> int:
        return (self.centroids.nbytes + self.order.nbytes
                + self.starts.nbytes + self.codes.nbytes
                + self.scales.nbytes + self.norms2.nbytes)

    def scanned_rows(self, nprobe: int | None = None) -> int:
        """Expected rows the approximate stage scores per query."""
        p = min(self.nlist, nprobe or self.nprobe)
        return int(round(self.n_rows * p / max(1, self.nlist)))

    def describe(self) -> dict:
        return {"rows": self.n_rows, "dim": self.dim,
                "nlist": self.nlist, "nprobe": self.nprobe,
                "bytes": int(self.nbytes),
                "codeBytes": int(self.codes.nbytes),
                "sampleRecall": round(float(self.sample_recall), 4),
                "targetRecall": float(self.target_recall)}

    def to_device(self, device: torch.device) -> IVFIndex:
        """Place the device copies of centroids, codes and scales on
        `device`; returns self."""
        self.centroids_dev = torch.from_numpy(self.centroids).to(device)
        self.codes_dev = torch.from_numpy(self.codes).to(device)
        self.scales_dev = torch.from_numpy(self.scales).to(device)
        return self


def ivf_index_from_arrays(d: dict, device: str | torch.device | None = None
                          ) -> IVFIndex:
    """The port's index from the reference index's fields as numpy
    (`dataclasses.asdict` of a `dgraph_tpu.ops.ivf.IVFIndex`), placed
    on `device` (None: the card)."""
    dev = backend.resolve_device(device)
    return IVFIndex(
        dim=int(d["dim"]), nlist=int(d["nlist"]),
        centroids=np.ascontiguousarray(d["centroids"], np.float32),
        order=np.ascontiguousarray(d["order"], np.int32),
        starts=np.ascontiguousarray(d["starts"], np.int64),
        codes=np.ascontiguousarray(d["codes"], np.int8),
        scales=np.ascontiguousarray(d["scales"], np.float32),
        norms2=np.ascontiguousarray(d["norms2"], np.float32),
        nprobe=int(d["nprobe"]), sample_recall=float(d["sample_recall"]),
        target_recall=float(d["target_recall"]), seed=int(d["seed"]),
    ).to_device(dev)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _assign(vecs: np.ndarray, cents: np.ndarray,
            device: torch.device) -> np.ndarray:
    """Blocked nearest-centroid assignment on `device`: argmin of
    ||c||^2 - 2 x.c (the ||x||^2 term is constant per row), first index
    among equal distances."""
    cn2 = torch.from_numpy((cents.astype(np.float64) ** 2)
                           .sum(axis=1).astype(np.float32)).to(device)
    cd = torch.from_numpy(np.ascontiguousarray(cents)).to(device)
    out = np.empty(len(vecs), np.int32)
    for s in range(0, len(vecs), ASSIGN_BLOCK):
        blk = torch.from_numpy(
            np.ascontiguousarray(vecs[s:s + ASSIGN_BLOCK])).to(device)
        d = torch.matmul(blk, cd.T)
        out[s:s + ASSIGN_BLOCK] = torch.argmin(
            cn2[None, :] - 2.0 * d, dim=1).cpu().numpy()
    return out


def _kmeans(vecs: np.ndarray, nlist: int, seed: int,
            device: torch.device, iters: int = KMEANS_ITERS) -> np.ndarray:
    """Seeded Lloyd's over a deterministic sample; float64 mean
    accumulation (np.add.at) keeps the result order-independent."""
    n, d = vecs.shape
    rng = np.random.default_rng(seed)
    sample_n = min(n, KMEANS_SAMPLE_PER_LIST * nlist)
    sample = vecs if sample_n == n else \
        vecs[np.sort(rng.choice(n, sample_n, replace=False))]
    init = rng.choice(len(sample), nlist, replace=False)
    cents = sample[np.sort(init)].astype(np.float32).copy()
    for _ in range(iters):
        a = _assign(sample, cents, device)
        sums = np.zeros((nlist, d), np.float64)
        np.add.at(sums, a, sample.astype(np.float64))
        counts = np.bincount(a, minlength=nlist).astype(np.float64)
        nonempty = counts > 0
        cents[nonempty] = (sums[nonempty]
                           / counts[nonempty, None]).astype(np.float32)
        # empty clusters keep their previous center (deterministic)
    return cents


def exact_topk_blocked(vecs: np.ndarray, queries: np.ndarray, k: int,
                       metric: str = "dot",
                       block: int = 1 << 20) -> np.ndarray:
    """Exact top-k indices over an (n, d) block without materializing
    the full (q, n) score matrix — the calibration oracle (f32
    accumulate on the host; ties break low-index like every tier).
    Supports dot and cosine."""
    if metric not in ("dot", "cosine"):
        raise ValueError(f"unsupported blocked metric {metric!r}")
    q = np.atleast_2d(np.asarray(queries, np.float32))
    nq, n = len(q), len(vecs)
    k = min(k, n)
    qn = np.linalg.norm(q, axis=1).astype(np.float32) \
        if metric == "cosine" else None
    best_s = np.full((nq, k), -np.inf, np.float32)
    best_i = np.zeros((nq, k), np.int64)
    for s in range(0, n, block):
        sc = q @ vecs[s:s + block].T
        if metric == "cosine":
            bn = np.linalg.norm(vecs[s:s + block], axis=1) \
                .astype(np.float32)
            denom = np.outer(qn, bn)
            sc = np.divide(sc, denom, out=np.zeros_like(sc),
                           where=denom > 0)
        cat_s = np.concatenate([best_s, sc], axis=1)
        cat_i = np.concatenate(
            [best_i, np.arange(s, s + sc.shape[1], dtype=np.int64)
             [None, :].repeat(nq, 0)], axis=1)
        part = np.argpartition(-cat_s, k - 1, axis=1)[:, :k]
        ps = np.take_along_axis(cat_s, part, axis=1)
        pi = np.take_along_axis(cat_i, part, axis=1)
        ordr = np.lexsort((pi, -ps), axis=1)
        best_s = np.take_along_axis(ps, ordr, axis=1)
        best_i = np.take_along_axis(pi, ordr, axis=1)
    return best_i


def build(vecs: np.ndarray, *, nlist: int | None = None, seed: int = 0,
          target_recall: float = TARGET_RECALL,
          calibrate: bool = True,
          device: str | torch.device | None = None) -> IVFIndex:
    """Train the quantized index over one clean base block (float32
    (n, d) numpy), with the assignment on `device` (None: the card),
    and place it there."""
    dev = backend.resolve_device(device)
    vecs = np.ascontiguousarray(vecs, np.float32)
    n, d = vecs.shape
    if n == 0 or d == 0:
        raise ValueError("cannot build an IVF index over an empty block")
    nlist = int(nlist) if nlist else default_nlist(n)
    nlist = max(1, min(nlist, n))
    cents = _kmeans(vecs, nlist, seed, dev)
    assign = _assign(vecs, cents, dev)
    # cluster-order rows: stable sort by (centroid, row) so every list
    # is one contiguous slice and the layout is deterministic
    order = np.argsort(assign, kind="stable").astype(np.int32)
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # residual quantization runs blockwise, bounding the transient copy
    codes = np.empty((n, d), np.int8)
    scales = np.empty(n, np.float32)
    norms2 = np.empty(n, np.float32)
    for s in range(0, n, ASSIGN_BLOCK):
        e = min(n, s + ASSIGN_BLOCK)
        blk = vecs[order[s:e]]
        norms2[s:e] = np.einsum("ij,ij->i", blk, blk,
                                dtype=np.float64).astype(np.float32)
        resid = blk - cents[assign[order[s:e]]]
        sc = (np.abs(resid).max(axis=1) / 127.0).astype(np.float32)
        sc = np.where(sc > 0, sc, np.float32(1.0))
        scales[s:e] = sc
        codes[s:e] = np.rint(resid / sc[:, None]).astype(np.int8)
    ivf = IVFIndex(dim=d, nlist=nlist, centroids=cents, order=order,
                   starts=starts, codes=codes, scales=scales,
                   norms2=norms2, nprobe=min(nlist, NPROBE_LADDER[0]),
                   sample_recall=0.0, target_recall=float(target_recall),
                   seed=int(seed)).to_device(dev)
    if calibrate and n > K_REF:
        _calibrate(ivf, vecs, seed)
    inc_counter("vector_index_builds_total")
    return ivf


def _calibrate(ivf: IVFIndex, vecs: np.ndarray, seed: int) -> None:
    """Pick the smallest ladder nprobe whose measured recall@K_REF on
    a seeded sample of base rows clears the target, under the default
    serving metric (cosine). Each sample query's own row is excluded
    from both the oracle and the probe sets, so recall is not biased
    high by a guaranteed top-1 hit."""
    n = len(vecs)
    rng = np.random.default_rng(seed + 1)
    nq = min(CALIB_QUERIES, n)
    rows = np.sort(rng.choice(n, nq, replace=False))
    queries = vecs[rows]
    want = exact_topk_blocked(vecs, queries, K_REF + 1,
                              metric="cosine")
    # rank-ordered true neighbors, self excluded, at most K_REF each
    want_sets = [set([g for g in want[i].tolist()
                      if g != int(rows[i])][:K_REF])
                 for i in range(nq)]
    total = sum(len(s) for s in want_sets)
    best = (ivf.nprobe, 0.0)
    for p in NPROBE_LADDER:
        p = min(p, ivf.nlist)
        idx, _ = search(ivf, vecs, queries, K_REF + 1, "cosine",
                        nprobe=p, count=False)
        hits = 0
        for i in range(nq):
            got = [g for g in idx[i].tolist()
                   if g >= 0 and g != int(rows[i])][:len(want_sets[i])]
            hits += len(set(got) & want_sets[i])
        rec = hits / float(total) if total else 1.0
        if rec > best[1]:
            best = (p, rec)
        if rec >= ivf.target_recall or p >= ivf.nlist:
            best = (p, rec)
            break
    ivf.nprobe, ivf.sample_recall = int(best[0]), float(best[1])


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _probe(queries: torch.Tensor, cents: torch.Tensor, nprobe: int,
           metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse stage: (q, d) x (d, nc) -> the raw centroid dots and the
    top-nprobe list ids per query. The ranking is metric-shaped:
    euclidean/dot rank by 2 q.c - ||c||^2 (the geometry the k-means
    partition was built in), cosine by q.c / ||c||, which is
    scale-invariant in the query like the metric itself."""
    cs = torch.matmul(queries, cents.T)
    cn2 = torch.sum(cents * cents, dim=1)
    if metric == "cosine":
        rank = cs / torch.sqrt(torch.clamp_min(cn2, 1e-30))[None, :]
    else:
        rank = 2.0 * cs - cn2[None, :]
    _, lists = knn._topk_ordered(rank, nprobe)
    return cs, lists


def _by_list(lists: np.ndarray) -> dict[int, list[int]]:
    """Probed list id -> the queries (in order) that probe it."""
    by_list: dict[int, list[int]] = {}
    for qi in range(len(lists)):
        for li in lists[qi]:
            by_list.setdefault(int(li), []).append(qi)
    return by_list


def _approx_scores_host(ivf: IVFIndex, lists: np.ndarray,
                        cs: np.ndarray, q: np.ndarray,
                        lo: int = 0, hi: int | None = None
                        ) -> tuple[list, list]:
    """Approximate residual-dot scores of every probed candidate on the
    host, grouped by list: each list's int8 block dequantizes once and
    scores all m sharing queries in one (len, d) x (d, m) product.

    [lo, hi) restricts scoring to a clustered-slot range (the sharded
    tier's per-shard partition, parallel/dist_knn); the intersection
    with a list's slice is plain arithmetic.

    Returns per-query (slot-id arrays, approx-dot arrays), concat order
    = (list id, slot)."""
    nq = len(lists)
    by_list = _by_list(lists)
    slot_parts: list[list[np.ndarray]] = [[] for _ in range(nq)]
    dot_parts: list[list[np.ndarray]] = [[] for _ in range(nq)]
    for li, s, e in _list_slices(ivf, sorted(by_list), lo, hi):
        qis = by_list[li]
        block = ivf.codes[s:e].astype(np.float32)       # dequant once
        dots = block @ q[qis].T                         # (len, m)
        dots *= ivf.scales[s:e, None]
        slots = np.arange(s, e, dtype=np.int64)
        for col, qi in enumerate(qis):
            slot_parts[qi].append(slots)
            # + q . centroid term: approx q.x = q.c + q.residual
            dot_parts[qi].append(dots[:, col] + cs[qi, li])
    return ([np.concatenate(sp) if sp else np.empty(0, np.int64)
             for sp in slot_parts],
            [np.concatenate(dp) if dp else np.empty(0, np.float32)
             for dp in dot_parts])


def _list_slices(ivf: IVFIndex, list_ids, lo: int, hi: int | None):
    """(list id, start, end) of each list's slice cut to the slot range
    [lo, hi), in the given order; empty cuts left out."""
    hi = ivf.n_rows if hi is None else hi
    for li in list_ids:
        s = max(lo, int(ivf.starts[li]))
        e = min(hi, int(ivf.starts[li + 1]))
        if e > s:
            yield li, s, e


def _list_plan(ivf: IVFIndex, lists: np.ndarray, lo: int = 0,
               hi: int | None = None) -> list:
    """(list id, start, end, query ids) of every probed list with slots
    in [lo, hi), by list id: the order of the device route's flat
    output."""
    by_list = _by_list(lists)
    return [(li, s, e, by_list[li])
            for li, s, e in _list_slices(ivf, sorted(by_list), lo, hi)]


def _approx_scores_device(ivf: IVFIndex, lists: np.ndarray,
                          cs: np.ndarray, q: torch.Tensor,
                          lo: int = 0, hi: int | None = None
                          ) -> tuple[list, list]:
    """`_approx_scores_host`'s per-query (slots, approx dots), computed
    on the index's device in one `score_int8_lists` launch over a work
    table of every distinct probed list: the contiguous slice
    `codes[s:e]` cut to [lo, hi), the queries that probe it (in chunks
    of at most `lists_m_tile(d, device)`), `* scales[s:e] + cs[qi, li]`
    in the kernel. A range that meets no probed list launches nothing.
    The flat output, list after list and query after query, comes to the
    host in one copy. `q` is the float32 (nq, d) query tensor on the
    index's device."""
    nq = len(lists)
    plan = _list_plan(ivf, lists, lo, hi)
    slot_parts: list[list[np.ndarray]] = [[] for _ in range(nq)]
    dot_parts: list[list[np.ndarray]] = [[] for _ in range(nq)]
    if plan:
        table, qidx, total = int8_lists_table(
            [(s, e, qis) for _, s, e, qis in plan],
            lists_m_tile(ivf.dim, ivf.device))
        cterm = np.concatenate([cs[qis, li] for li, _, _, qis in plan]
                               ).astype(np.float32)
        flat = torch.empty(total, dtype=torch.float32, device=ivf.device)
        score_int8_lists(ivf.codes_dev, q, table, flat, qidx=qidx,
                         scales=ivf.scales_dev, cterm=cterm)
        host = flat.cpu().numpy()
        off = 0
        for li, s, e, qis in plan:
            ln = e - s
            slots = np.arange(s, e, dtype=np.int64)
            for qi in qis:
                slot_parts[qi].append(slots)
                dot_parts[qi].append(host[off:off + ln])
                off += ln
    return ([np.concatenate(sp) if sp else np.empty(0, np.int64)
             for sp in slot_parts],
            [np.concatenate(dp) if dp else np.empty(0, np.float32)
             for dp in dot_parts])


def _cut_top_r(slots: np.ndarray, approx: np.ndarray, r: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic top-r truncation by (-approx, slot): every slot
    strictly above the boundary value survives, boundary ties fill by
    lowest slot id."""
    if len(slots) <= r:
        return slots, approx
    part = np.argpartition(-approx, r - 1)[:r]
    v = approx[part].min()
    above = approx > v
    need = r - int(above.sum())
    at_v = approx == v
    tie_keep = at_v & np.isin(slots, np.sort(slots[at_v])[:need])
    keep = above | tie_keep
    return slots[keep], approx[keep]


def _filter_cut(ivf: IVFIndex, slots: np.ndarray, adot: np.ndarray,
                keep_b: np.ndarray | None, qn2: float, metric: str,
                r_depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-query tail of the approximate stage: keep-mask (the
    unpermuted base-row mask, gathered at the probed slots only),
    metric transform, deterministic (-approx, slot) cut."""
    if not len(slots):
        return slots, adot.astype(np.float64)
    if keep_b is not None:
        m = keep_b[ivf.order[slots]]
        slots, adot = slots[m], adot[m]
        if not len(slots):
            return slots, adot.astype(np.float64)
    approx = _metric_transform(ivf, slots, adot, qn2, metric)
    return _cut_top_r(slots, approx, r_depth)


def _rerank_one(ivf: IVFIndex, vecs: np.ndarray, slots: np.ndarray,
                q1: np.ndarray, k: int, metric: str
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exact float64 re-rank of one query's surviving slots ->
    (base rows, scores). The unique() sort makes subset order ==
    base-row order, so topk_host's (-score, subset idx) tiebreak is
    (-score, row)."""
    rows = np.unique(ivf.order[slots].astype(np.int64))
    idx, sc = knn.topk_host(vecs[rows], q1[None], k, metric)
    return rows[idx[0]], sc[0]


def _metric_transform(ivf: IVFIndex, slots: np.ndarray,
                      adot: np.ndarray, qn2: float,
                      metric: str) -> np.ndarray:
    """Approximate metric score from the approximate dot + the stored
    exact row norms (only the dot term carries quantization error)."""
    if metric == "dot":
        return adot
    n2 = ivf.norms2[slots]
    if metric == "cosine":
        denom = math.sqrt(qn2) * np.sqrt(n2)
        return np.where(denom > 0, adot / np.where(denom > 0, denom, 1),
                        0.0)
    return -(qn2 - 2.0 * adot + n2)  # euclidean, higher = closer


def search(ivf: IVFIndex, vecs: np.ndarray, queries: np.ndarray,
           k: int, metric: str = "cosine",
           keep: np.ndarray | None = None,
           nprobe: int | None = None, rerank: int | None = None,
           count: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Quantized top-k on the index's device: IVF probe -> int8
    approximate scores -> exact float64 re-rank of the top `rerank`
    survivors. Returns (idx (q, k'), scores (q, k')) with idx into the
    base block row axis, ordered by (-score, idx).

    `keep` masks base rows out; masked rows never reach the re-rank.
    count=False keeps build-time calibration out of the served-search
    counter."""
    if metric not in knn.METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    q = np.atleast_2d(np.asarray(queries, np.float32))
    nq = len(q)
    p = min(ivf.nlist, int(nprobe or ivf.nprobe))
    r_depth = int(rerank or rerank_depth(k))
    q_t = torch.from_numpy(np.ascontiguousarray(q)).to(ivf.device)
    cs_t, lists_t = _probe(q_t, ivf.centroids_dev, p, str(metric))
    cs = cs_t.cpu().numpy()
    lists = lists_t.cpu().numpy()
    if ivf.device.type == "cuda":
        slot_l, dot_l = _approx_scores_device(ivf, lists, cs, q_t)
    else:
        slot_l, dot_l = _approx_scores_host(ivf, lists, cs, q)
    keep_b = np.asarray(keep, bool) if keep is not None else None
    qn2 = (q.astype(np.float64) ** 2).sum(axis=1)
    out_i = np.full((nq, k), -1, np.int64)
    out_s = np.full((nq, k), -np.inf, np.float64)
    width = 0
    for qi in range(nq):
        slots, _ = _filter_cut(ivf, slot_l[qi], dot_l[qi], keep_b,
                               float(qn2[qi]), metric, r_depth)
        if not len(slots):
            continue
        rws, sc = _rerank_one(ivf, vecs, slots, q[qi], k, metric)
        w = len(rws)
        out_i[qi, :w] = rws
        out_s[qi, :w] = sc
        width = max(width, w)
    if count:
        inc_counter("vector_quantized_searches_total")
    return out_i[:, :width], out_s[:, :width]
