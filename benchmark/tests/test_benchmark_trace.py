"""The trace's reduction: busy time as the union of the device's
intervals inside the window, idle gaps named by the host's runtime
call, kernels counted without copies and fills."""

import pytest

from benchmark.harness import trace

MS = 1_000_000


def _events():
    return [
        ("cudaLaunchKernel", False, 1 * MS, 9 * MS),
        ("cudaEventSynchronize", False, 41 * MS, 99 * MS),
        ("kernel_a", True, 10 * MS, 30 * MS),
        ("kernel_a", True, 20 * MS, 35 * MS),      # overlaps the first
        ("Memcpy DtoH (Device -> Pinned)", True, 50 * MS, 60 * MS),
        ("kernel_b", True, 90 * MS, 120 * MS),     # runs past the window
        ("kernel_c", True, -20 * MS, -10 * MS),    # before the window
    ]


def test_reduce_by_hand():
    rec = trace.reduce(_events(), (0, 100 * MS))
    assert rec["window_s"] == pytest.approx(0.1)
    # [10, 35] + [50, 60] + [90, 100] inside [0, 100]
    assert rec["busy_s"] == pytest.approx(0.045)
    assert rec["kernels"] == 3
    assert rec["device_ops"][0] == ["kernel_a", pytest.approx(0.035)]
    gaps = rec["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([0.03, 0.015, 0.01])
    assert gaps[0][0] == "cudaEventSynchronize"
    assert gaps[1][0] == "host, in no CUDA call"
    assert gaps[2][0] == "host, in no CUDA call"   # the launch starts later


def test_user_annotations_are_dropped():
    rows = [("a_span", True, True, 0, 50), ("kernel", True, False, 1, 2),
            ("cudaLaunchKernel", False, False, 0, 1)]
    assert trace._kept(rows) == [("kernel", True, 1, 2),
                                 ("cudaLaunchKernel", False, 0, 1)]


def test_reduce_refuses_an_empty_window():
    with pytest.raises(RuntimeError):
        trace.reduce([("kernel", True, 0, 10)], (20, 30))
