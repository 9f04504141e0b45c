"""Tiled merge-path intersect: port of `dgraph_tpu/ops/mergepath.py`
(ref algo/uidlist.go:137-287, the reference's hottest set-algebra loop).

`uidvec.intersect` pays one sort of the concatenated operands. The
merge-path decomposition partitions the MERGE DIAGONAL into T equal
slabs of K steps, binary-searches the slab boundaries (T log n scalar
work), then co-sorts each slab independently at width ~2K. Each slab
covers exactly K merge steps, so its a-window and b-window are each
<= K by construction: no data skew can overflow a window.

Compaction (per-slab hits back to one sorted padded vector) keeps
K // hit_frac hit slots per slab before one global sort; a per-slab
count check raises the overflow flag where a slab held more, and the
caller re-dispatches at hit_frac=1 (always exact).

Operands are the port's padded sorted vectors (`ops/uidvec`: int64
holding uint32 values, SENTINEL-padded). The output contract matches
uidvec.intersect: ascending, SENTINEL-padded, static length len(a).
Plain PyTorch; no serving path calls it (the reference's verdict on the
TPU), and it is measured beside uidvec.intersect on the card.
"""

from __future__ import annotations

import math

import torch

from dgraph_tpu_torch.ops.uidvec import SENTINEL


def _partition(a: torch.Tensor, b: torch.Tensor, diag: torch.Tensor
               ) -> torch.Tensor:
    """Stable-merge split points: for each diagonal d in `diag`, the
    smallest x with a[x] > b[d-x-1] (a-before-equal-b order), clamped
    to [max(0, d-m), min(d, n)]. Vectorized binary search, unrolled to
    ceil(log2(n+1)) + 1 rounds."""
    n, m = a.shape[0], b.shape[0]
    lo = torch.clamp(diag - m, min=0)
    hi = torch.clamp(diag, max=n)
    steps = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        av = a[mid.clamp(0, n - 1)]
        bi = diag - mid - 1
        bv = b[bi.clamp(0, m - 1)]
        # P(mid): a[mid] > b[d-mid-1], with out-of-range semantics
        # b[<0] = -inf (P true), a[>=n] = +inf
        p = ((av > bv) | (bi < 0)) & (bi < m) | (mid >= n)
        hi = torch.where(p, mid, hi)
        lo = torch.where(p, lo, mid + 1)
    return lo


def mergepath_hits(a: torch.Tensor, b: torch.Tensor, k: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Per-slab sorted hit values.

    Returns (hitmat (T, K) of hit values left-compacted ascending per
    slab with SENTINEL padding, per-slab hit counts (T,) int32, total
    real element count): the building block mergepath_intersect
    compacts."""
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    t = -(-(n + m) // k)  # ceil
    diag = torch.clamp(torch.arange(1, t + 1, device=dev) * k, max=n + m)
    a_end = _partition(a, b, diag)  # (t,) split at each slab END
    zero = torch.zeros(1, dtype=diag.dtype, device=dev)
    a_beg = torch.cat([zero, a_end[:-1]])
    b_end = diag - a_end
    b_beg = torch.cat([zero, b_end[:-1]])

    pos = torch.arange(k, device=dev)[None, :]  # (1, K)
    ai = a_beg[:, None] + pos
    aw = torch.where((pos < (a_end - a_beg)[:, None]) & (ai < n),
                     a[ai.clamp(0, n - 1)], SENTINEL)
    # +1 trailing b element per slab: a slab's LAST a value may equal
    # the FIRST b value of the next slab (the stable split allows
    # a[x-1] == b[d-x]); b values are unique so the extra slot cannot
    # double-count
    posb = torch.arange(k + 1, device=dev)[None, :]
    bi = b_beg[:, None] + posb
    bw = torch.where((posb < (b_end - b_beg)[:, None] + 1) & (bi < m),
                     b[bi.clamp(0, m - 1)], SENTINEL)

    # stable key sort of each slab; the a columns come first, so a
    # sorted column's origin flag is its original index < K
    cs, ix = torch.sort(torch.cat([aw, bw], dim=1), dim=1, stable=True)
    fs = ix < k
    pad = torch.full((t, 1), SENTINEL, dtype=cs.dtype, device=dev)
    one = torch.ones((t, 1), dtype=torch.bool, device=dev)
    nxt = torch.cat([cs[:, 1:], pad], dim=1)
    fnx = torch.cat([fs[:, 1:], one], dim=1)
    prv = torch.cat([pad, cs[:, :-1]], dim=1)
    fpv = torch.cat([one, fs[:, :-1]], dim=1)
    hit = (((nxt == cs) & ~fnx) | ((prv == cs) & ~fpv)) \
        & fs & (cs != SENTINEL)
    # left-compact each slab's hits (ascending; sentinels sort last)
    vals = torch.sort(cs.masked_fill(~hit, SENTINEL), dim=1).values[:, :k]
    counts = (vals != SENTINEL).sum(dim=1, dtype=torch.int32)
    return vals, counts, n


def mergepath_intersect(a: torch.Tensor, b: torch.Tensor, k: int = 1024,
                        hit_frac: int = 4
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted-set intersection via diagonal merge-path.

    Returns (result padded to len(a), hit_overflow flag as a 0-d bool
    tensor). The sparse compaction keeps K // hit_frac hit slots per
    slab (at least 8), so a slab with more hits than that OVERFLOWS:
    the flag turns True and the result DROPS the excess (invalid).
    Callers re-dispatch with hit_frac=1, where the flag is always
    False, or use uidvec.intersect."""
    n = a.shape[0]
    hitmat, counts, _ = mergepath_hits(a, b, k=k)
    h = max(8, k // max(1, hit_frac))
    overflow = (counts > h).any() if h < k \
        else torch.zeros((), dtype=torch.bool, device=a.device)
    flat = torch.sort(hitmat[:, :h].reshape(-1)).values
    take = min(n, flat.shape[0])
    out = flat[:take]
    if take < n:
        out = torch.cat([out, torch.full((n - take,), SENTINEL,
                                         dtype=a.dtype, device=a.device)])
    return out, overflow
