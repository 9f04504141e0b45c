"""The port's load path (dgraph_tpu_torch: bench/openloop,
bench/workload, bench/spawn and the cluster) against the reference's, on
the CPU: `tools/dgbench.py --smoke` through both packages.

`_dgbench_smoke` runs the tool's smoke (a zero and two alpha groups of
`node` processes, the seeded 80-person workload graph, a closed-loop
capacity probe, one open-loop phase of 150 mixed ops at 12 QPS, and the
differential parity replay) once as it is and once with the tool's
`dgraph_tpu` names bound to the port's (`tests/torch_twins.run_twins`
with `helpers=("tools.dgbench",)`; the port's nodes as `python -m
dgraph_tpu_torch node --device cpu`). Its `--out` and `--report-dir`
lie in each pass's own directory: the tool's default `--out` is the
repo's `BENCH_CLUSTER.json`, which a test never writes. Both passes
must exit 0 with parity over their sampled reads, no deadline or error
outcome, and the sampled reads' data equal between the passes, op index
by op index. The records compare nothing else: which ops run
concurrently, the uids the writes take and every latency are timing.
"""

from __future__ import annotations

import importlib
import json
import os

from tests.torch_twins import run_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS: list = []


def _dgbench_smoke(tmp_path, monkeypatch):
    """One pass: `dgbench --smoke`, its phases and report kept in RUNS."""
    from tools import dgbench

    phases = []
    run_phase = dgbench.run_phase

    def recorded(*a, **kw):
        phases.append(run_phase(*a, **kw))
        return phases[-1]
    monkeypatch.setattr(dgbench, "run_phase", recorded)
    monkeypatch.setattr(dgbench.tracing, "_NODE", dgbench.tracing.node())
    out = tmp_path / "bench_cluster.json"
    rc = dgbench.main(["--smoke", "--out", str(out),
                       "--report-dir", str(tmp_path / "report")])
    RUNS.append({"rc": rc, "report": json.loads(out.read_text()),
                 "phases": phases})


def _sampled(run) -> dict:
    """op index -> the data of a sampled read, over the smoke's phase."""
    (phase,) = run["phases"]
    return {i: rec["data"] for i, rec in enumerate(phase["recs"])
            if rec and "data" in rec}


def test_dgbench_smoke_through_both(tmp_path):
    bench = os.path.join(REPO, "BENCH_CLUSTER.json")
    before = os.stat(bench).st_mtime_ns, open(bench, "rb").read()
    # the module run_twins loads the case from (pytest may have imported
    # this file under another name)
    runs = importlib.import_module("tests.test_torch_load").RUNS
    runs.clear()
    run_twins("test_torch_load", ["_dgbench_smoke"], tmp_path,
              compare=None, helpers=("tools.dgbench",))
    assert (os.stat(bench).st_mtime_ns, open(bench, "rb").read()) == before
    ref, port = runs
    for side, run in (("ref", ref), ("port", port)):
        s = run["report"]["summary"]
        assert run["rc"] == 0, side
        assert s["smoke"] and s["parity_ok"] and s["parity_checked"] > 0, s
        assert s["parity_mismatched"] == 0, s
        assert s["outcomes"]["deadline"] == s["outcomes"]["error"] == 0, s
        assert s["rdf"] == 1440 and s["phases_run"] == 1, s
    assert port["report"]["summary"]["parity_checked"] == \
        ref["report"]["summary"]["parity_checked"]
    assert _sampled(port) == _sampled(ref)
    assert len(_sampled(ref)) == ref["report"]["summary"]["parity_checked"]


def test_the_tools_bind_to_the_port_s_load_modules():
    """A port pass of a tool's twin (`helpers=`) binds the tool's load
    and witness names to the port's: dgchaos's and dgbench's module-level
    `run_open_loop`, `latency_summary` and workload names, and the
    modules they import inside functions (dgchaos's `Workload` and
    `racecheck`)."""
    import sys

    import pytest

    from dgraph_tpu_torch.bench import openloop, workload
    from dgraph_tpu_torch.utils import racecheck
    from tests.torch_twins import bind_port

    tools = [importlib.import_module(m)
             for m in ("tools.dgchaos", "tools.dgbench")]
    mp = pytest.MonkeyPatch()
    try:
        bind_port(importlib.import_module("tests.test_dgchaos"), mp, tools)
        for tool in tools:
            assert tool.run_open_loop is openloop.run_open_loop
            assert tool.latency_summary is openloop.latency_summary
        assert tools[1].Workload is workload.Workload
        assert tools[1].WorkloadConfig is workload.WorkloadConfig
        lazy = sys.modules["dgraph_tpu.bench.workload"]
        assert lazy.Workload is workload.Workload
        assert sys.modules["dgraph_tpu.utils.racecheck"].enable is \
            racecheck.enable
    finally:
        mp.undo()
    assert tools[0].run_open_loop.__module__ == "dgraph_tpu.bench.openloop"


def test_launch_counts_hold_under_threads():
    """The load plane's threads launch kernels at once: no launch count
    may be lost (`kernels._count` takes a lock around its `+=`)."""
    import sys
    import threading

    from dgraph_tpu_torch.ops import kernels

    before = kernels.score_int8.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launch():
            for _ in range(2000):
                kernels._count(kernels.score_int8)
        threads = [threading.Thread(target=launch) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        delta = kernels.score_int8.launches - before
        kernels.score_int8.launches = before
    assert delta == 32 * 2000
