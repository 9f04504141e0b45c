"""Bit-parallel batched Levenshtein (Myers 1999 / Hyyrö 2001): a numpy
copy of `dgraph_tpu/ops/editdist.py` (the executor's match() verify).

The reference verifies match() candidates with a per-value DP loop
(worker/match.go:35 levenshteinDistance); our native C++ kernel does
the same in C. When the extension isn't built, the executor's fallback
was a per-uid *Python* DP — the whole q015 budget. This module runs
the verify for EVERY candidate at once as ~15 numpy uint64 bit-ops per
payload byte column: the pattern is encoded as per-character position
bitmasks and the DP column is carried as two bit-vectors (PV/MV) per
candidate row, so the work is O(max_len) vectorized passes instead of
O(n * |a| * |b|) interpreted steps.

Byte-level scores equal the codepoint-level distances only for ASCII
rows; non-ASCII rows come back as -1 and the caller re-verifies them
on the exact per-uid path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def levenshtein_scores(want: str, mat: np.ndarray,
                       lens: np.ndarray) -> Optional[np.ndarray]:
    """Edit distances of `want` against N byte rows.

    mat:  (N, W) uint8 payload matrix, rows NUL-padded past lens[i]
    lens: (N,) int payload byte lengths

    Returns int64 scores with -1 marking rows the byte-level pass
    cannot answer (non-ASCII payload bytes — '.'-width differs), or
    None when the PATTERN itself is outside the kernel's domain
    (empty, non-ASCII, or longer than 63 chars — one uint64 word)."""
    m = len(want)
    if m == 0 or m > 63 or not want.isascii():
        return None
    n, width = mat.shape
    if n == 0:
        return np.empty(0, np.int64)
    lens = np.asarray(lens, np.int64)
    peq = np.zeros(256, np.uint64)
    for i, ch in enumerate(want.encode("ascii")):
        peq[ch] |= np.uint64(1 << i)
    pv = np.full(n, (1 << m) - 1, np.uint64)
    mv = np.zeros(n, np.uint64)
    score = np.full(n, m, np.int64)
    out = np.where(lens == 0, np.int64(m), np.int64(-1))
    high = np.uint64(1 << (m - 1))
    one = np.uint64(1)
    full = ~np.uint64(0)
    for j in range(int(lens.max())):
        eq = peq[mat[:, j]]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ((xh | pv) ^ full)
        mh = pv & xh
        delta = ((ph & high) != 0).astype(np.int64) \
            - ((mh & high) != 0).astype(np.int64)
        ph = (ph << one) | one
        mh = mh << one
        npv = mh | ((xv | ph) ^ full)
        nmv = ph & xv
        active = j < lens
        score = np.where(active, score + delta, score)
        pv = np.where(active, npv, pv)
        mv = np.where(active, nmv, mv)
        out = np.where(lens == j + 1, score, out)
    # byte-level == codepoint-level only for pure-ASCII rows; padding
    # bytes are NUL (< 0x80), so a whole-row test is exact
    out[(mat >= 0x80).any(axis=1)] = -1
    return out
