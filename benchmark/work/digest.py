"""The least work of one batch of the reach digest.

A batch of B queries of S seed uids, taken D levels deep, needs at
least: its seed uids read once (4 bytes each); the out-edges that some
query follows read once, 4 bytes an edge: those of every uid that some
query's frontier holds at a level before the last, whatever the number
of levels that reach it; and its answer written once: D level sums of 8
bytes and the last level's first-word column, 4 bytes a row of the
n_covered + 1 rows. Which edges some query follows depends on the
batch, so the caller counts them (the reference does). Frontiers and
visited sets held between levels are the implementation's, not the
answer's, and are not counted; nor is any operation, since a level is
a gather and an OR."""

from __future__ import annotations


def least_bytes(batch: int, n_seeds: int, depth: int, edges_followed: int,
                n_covered: int) -> int:
    """Bytes one batch reads and writes at the least."""
    return 4 * batch * n_seeds + 4 * edges_followed + 8 * depth + \
        4 * (n_covered + 1)


def least_seconds(nbytes: int, peaks: dict) -> float:
    """The least time of those bytes at the card's memory rate."""
    return nbytes / peaks["hbm_bytes_per_s"]
