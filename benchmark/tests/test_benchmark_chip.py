"""On a card: one short run of a cell through the command, whose last
line keeps to the result's shape and whose check holds."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sift1m.knn-q1",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert {"knn_roofline", "knn_kernels_per_call",
                "device_idle_share.knn"} <= set(res["metrics"])
        assert 0 < res["metrics"]["knn_roofline"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"queries_per_s.knn", "p95_ms.knn",
                                       "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
