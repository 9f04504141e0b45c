"""The least work of one call of the nearest-neighbour search.

B queries of d float32 dimensions against N corpus rows, keeping k:
2 * B * N * d operations (a multiply and an add a dimension of each
pair), and the corpus and the queries read once and the k indices
(8 bytes) and scores (4 bytes) of each query written once. The least
time is the larger of the operations at the float32 rate outside the
tensor cores (the configuration's precision) and the bytes at the
memory rate."""

from __future__ import annotations


def least_ops(batch: int, n_rows: int, dim: int) -> int:
    return 2 * batch * n_rows * dim


def least_bytes(batch: int, n_rows: int, dim: int, k: int) -> int:
    return 4 * n_rows * dim + 4 * batch * dim + 12 * batch * k


def least_seconds(batch: int, n_rows: int, dim: int, k: int,
                  peaks: dict) -> tuple[float, str]:
    """(least seconds of one call, which bound sets it)."""
    ops = least_ops(batch, n_rows, dim) / peaks["fp32_flops_per_s"]
    mem = least_bytes(batch, n_rows, dim, k) / peaks["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= mem else (mem, "bytes")
