"""The least work counts equal hand-computed values on tiny shapes."""

import pytest

from benchmark.work import digest, knn
from benchmark.work.peaks import H100_SXM, peaks


def test_digest_bytes_by_hand():
    # 4 queries of 2 seeds (32 B), 10 edges followed (40 B), 3 level
    # sums (24 B), a column of 5 covered rows and the dummy (24 B)
    assert digest.least_bytes(4, 2, 3, 10, 5) == 32 + 40 + 24 + 24
    assert digest.least_seconds(3_350, H100_SXM) == pytest.approx(1e-9)


def test_knn_counts_by_hand():
    assert knn.least_ops(2, 3, 4) == 48
    # corpus 3 x 4 floats, queries 2 x 4, 2 x 5 (index, score) pairs
    assert knn.least_bytes(2, 3, 4, 5) == 48 + 32 + 120
    s, by = knn.least_seconds(1, 1_000_000, 128, 10, H100_SXM)
    assert by == "bytes"
    assert s == pytest.approx((512e6 + 512 + 120) / 3.35e12)
    s, by = knn.least_seconds(256, 1_000_000, 128, 10, H100_SXM)
    assert by == "operations"
    assert s == pytest.approx(2 * 256 * 128e6 / 67e12)


def test_peaks_by_card_name():
    assert peaks("NVIDIA H100 80GB HBM3") is H100_SXM
    with pytest.raises(ValueError):
        peaks("some other card")
