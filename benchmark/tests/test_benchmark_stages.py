"""The program's stages read from a traced window: each device operation
to the innermost stage on its launching thread, each idle gap to the
stage the host was in when it began; the harness's own record kept key
for key; and, on a card, a real launch paired with its stage."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, stages, trace
from benchmark.tests.benchmark_small import small

MS = 1_000_000
MAIN, OTHER = 1234, -99


def _stage(name, t0, t1, tid=MAIN, sid="", parent="", **args):
    return {"name": name, "t0_ns": t0 * MS, "t1_ns": t1 * MS, "tid": tid,
            "span_id": sid or name, "parent_id": parent, "trace_id": "t",
            "args": args}


def _stages():
    # knn [0, 50] holds knn.score [5, 20] and knn.select [25, 40]
    return [_stage("knn.score", 5, 20, parent="knn"),
            _stage("knn.select", 25, 40, parent="knn"),
            _stage("knn", 0, 50),
            _stage("knn", 60, 70, tid=OTHER)]


def _events():
    """(name, on the device, start, end, correlation id, thread/stream)."""
    ns = lambda v: int(v * MS)  # noqa: E731
    return [
        ("cudaLaunchKernel", False, ns(6), ns(7), 1, MAIN),     # in score
        ("score_dot_kernel", True, ns(8), ns(18), 1, 7),
        ("cudaLaunchKernel", False, ns(22), ns(23), 2, MAIN),   # in knn
        ("add_kernel", True, ns(23), ns(24), 2, 7),
        ("cudaLaunchKernel", False, ns(30), ns(31), 3, MAIN),   # in select
        ("topk_kernel", True, ns(31), ns(45), 3, 7),            # idle after
        ("cudaLaunchKernel", False, ns(55), ns(56), 4, MAIN),   # no stage
        ("fill_kernel", True, ns(56), ns(58), 4, 7),
        ("cudaLaunchKernel", False, ns(62), ns(63), 5, 4321),   # a thread
        ("copy_kernel", True, ns(63), ns(65), 5, 7),            # w/o stages
        ("orphan_kernel", True, ns(80), ns(90), 99, 7),         # no launch
        ("cudaMemcpyAsync", False, ns(91), ns(92), 6, OTHER),   # after knn
        ("Memcpy DtoH", True, ns(92), ns(95), 6, 7),
        ("cudaLaunchKernel", False, ns(64), ns(64.5), 7, OTHER),  # in knn
        ("late_kernel", True, ns(66), ns(68), 7, 7),              # (OTHER)
    ]


def test_operations_go_to_the_innermost_stage_on_their_thread():
    rec = stages.reduce(_events(), _stages(), (0, 100 * MS))
    st = rec["stages"]
    assert st["knn.score"]["device_s"] == pytest.approx(0.010)
    assert st["knn.select"]["device_s"] == pytest.approx(0.014)
    # knn's own: the add between its children, and the other thread's
    assert st["knn"]["device_s"] == pytest.approx(0.001 + 0.002)
    assert st["knn"]["count"] == 2
    assert st["knn"]["host_s"] == pytest.approx(0.050 + 0.010)
    assert st["knn.score"]["count"] == 1
    # staged: [8, 18] + [23, 24] + [31, 45] + [66, 68]
    assert rec["staged_s"] == pytest.approx(0.010 + 0.001 + 0.014 + 0.002)


def test_operations_outside_stages_or_threads_go_to_none():
    evs = [e for e in _events() if e[0] in (
        "cudaLaunchKernel", "fill_kernel", "copy_kernel", "orphan_kernel",
        "cudaMemcpyAsync", "Memcpy DtoH")]
    # only the fill (no stage), the copy (a thread with no stage), the
    # orphan (no launch) and the copy launched after knn closed
    evs = [e for e in evs if not e[1] or e[4] in (4, 5, 99, 6)]
    rec = stages.reduce(evs, _stages(), (0, 100 * MS))
    assert all(s["device_s"] == 0 for s in rec["stages"].values())
    assert rec["staged_s"] == 0


def test_idle_gaps_go_to_the_stage_the_host_was_in():
    rec = stages.reduce(_events(), _stages(), (0, 100 * MS))
    # device busy [8, 18] [23, 24] [31, 45] [56, 58] [63, 65] [66, 68]
    # [80, 90] [92, 95] in [0, 100]: gaps [0, 8] [18, 23] [24, 31]
    # [45, 56] [58, 63] [65, 66] [68, 80] [90, 92] [95, 100]
    assert rec["idle_s"] == pytest.approx(0.056)
    st = rec["stages"]
    assert st["knn.score"]["idle_s"] == pytest.approx(0.005)    # at 18
    assert st["knn.select"]["idle_s"] == 0                      # 45 is out
    # [0, 8] knn, [18, 23] score, [24, 31] knn, [45, 56] knn, [65, 66]
    # knn (OTHER), [68, 80] knn (OTHER); [58, 63], [90, 92], [95, 100] none
    assert rec["idle_in_program_s"] == pytest.approx(
        0.008 + 0.005 + 0.007 + 0.011 + 0.001 + 0.012)
    assert st["knn"]["idle_s"] == pytest.approx(0.008 + 0.007 + 0.011
                                                + 0.001 + 0.012)


def test_stages_with_attributes_are_also_told_apart():
    recs = [_stage("digest.core", 5, 20, level=1),
            _stage("digest.core", 25, 40, level=2),
            _stage("digest", 0, 50)]
    rec = stages.reduce(_events(), recs, (0, 100 * MS))
    assert rec["stages"]["digest.core"]["device_s"] == pytest.approx(0.024)
    assert rec["stages"]["digest.core"]["count"] == 2
    lv = rec["stage_args"]
    assert set(lv) == {"digest.core level=1", "digest.core level=2"}
    assert lv["digest.core level=1"]["device_s"] == pytest.approx(0.010)
    assert lv["digest.core level=2"]["device_s"] == pytest.approx(0.014)
    assert lv["digest.core level=2"]["host_s"] == pytest.approx(0.015)


def test_runtime_calls_go_to_the_stage_they_ran_in():
    rec = stages.reduce(_events(), _stages(), (0, 100 * MS))
    assert rec["runtime_calls"] == {
        "knn": [("cudaLaunchKernel", pytest.approx(0.0015))],
        "knn.score": [("cudaLaunchKernel", pytest.approx(0.001))],
        "knn.select": [("cudaLaunchKernel", pytest.approx(0.001))]}


def test_the_window_clips_stages_and_operations():
    rec = stages.reduce(_events(), _stages(), (10 * MS, 30 * MS))
    st = rec["stages"]
    assert set(st) == {"knn", "knn.score", "knn.select"}
    assert st["knn.score"]["device_s"] == pytest.approx(0.008)   # [10, 18]
    assert st["knn"]["host_s"] == pytest.approx(0.020)
    assert st["knn.select"]["host_s"] == pytest.approx(0.005)


class _Event:
    def __init__(self, name, dev, a, b, corr, res, ann=False):
        self._v = (name, dev, a, b, corr, res, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[6]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


class _Prof:
    """Stands in for torch.profiler.profile: its raw record, no more."""

    def __init__(self, evs):
        class _K:
            def events(_self):
                return [_Event(*e) for e in evs] + [
                    _Event("an_annotation", True, 0, 100 * MS, 0, 0, True)]

        class _P:
            kineto_results = _K()

        self.profiler = _P()

    def __exit__(self, *exc):
        return False


class _FakeTracing:
    def __init__(self, recs):
        self.recs, self.on = recs, None

    def record_stages(self, on):
        self.on = on

    def take_stages(self):
        out, self.recs = self.recs, []
        return out


def _stopped(monkeypatch, tracing):
    monkeypatch.setattr(stages, "program_tracing", lambda: tracing)
    t = stages.StageTracer(True)
    t.prof = _Prof(_events())
    t.marks = (0, 100 * MS)
    return t.stop()


def test_the_harness_record_stays_as_it_is(monkeypatch):
    base = trace.reduce([e[:4] for e in _events()], (0, 100 * MS))
    fake = _FakeTracing(_stages())
    rec = _stopped(monkeypatch, fake)
    assert fake.on is False
    assert {k: rec[k] for k in base} == base
    assert set(rec) - set(base) == {"stages", "stage_args", "runtime_calls",
                                    "idle_s", "idle_in_program_s",
                                    "staged_s"}
    assert stages.StageTracer.last.recorded == 4


def test_a_program_without_stages_adds_nothing(monkeypatch):
    base = trace.reduce([e[:4] for e in _events()], (0, 100 * MS))
    assert _stopped(monkeypatch, None) == base
    assert _stopped(monkeypatch, _FakeTracing([])) == base


def test_readings_per_request():
    rec = stages.reduce(_events(), _stages(), (0, 100 * MS))
    rec["busy_s"] = 0.05
    got = stages.readings(rec, 2)
    assert got["knn_score_ms"] == {"value": pytest.approx(5.0),
                                   "unit": "ms/call"}
    assert got["knn_select_ms"]["value"] == pytest.approx(7.0)
    assert got["program_host_ms.knn"]["value"] == pytest.approx(30.0)
    assert got["idle_in_program.knn"]["value"] == pytest.approx(
        100 * 0.044 / 0.056)
    assert "knn_epilogue_ms" not in got        # no such stage recorded
    assert stages.readings({"stages": {}}, 2) == {}


@pytest.mark.parametrize("name", ["graph500-s20.reach3", "sift1m.knn-q1"])
def test_stages_recorded_over_a_window_on_the_cpu(monkeypatch, name):
    """The tool's path, untraced (the profiler records no device here):
    every request of the window records its entry point's stages."""
    monkeypatch.setattr(cell, "Tracer", stages.StageTracer)
    wl, cfg = small(name)
    out = stages.annotate(cell.run(
        name, 2**31 + 11, 0.3, False, torch.device("cpu"),
        time.perf_counter(), workload=wl, config=cfg))
    assert out["correct"], out["checks"]
    per = wl["traffic"]["depth"] + 2 if "reach" in name else 6
    assert out["stages_recorded"] == per * out["attempted"]
    assert "stages" not in out


@pytest.mark.chip
def test_a_stage_holds_its_kernels_launch_on_the_card(card):
    from torch.profiler import ProfilerActivity, profile

    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.utils import tracing

    g = torch.Generator(device=card).manual_seed(5)
    corpus = torch.randn(65536, 128, device=card, generator=g)
    q = torch.randn(1, 128, device=card, generator=g)
    kernels.score_dot(corpus, q)                  # build and warm
    torch.cuda.synchronize(card)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    kernels.score_dot(corpus, q)                  # a profiler misses its
    torch.cuda.synchronize(card)                  # first
    tracing.record_stages(True)
    t0 = time.time_ns()
    with tracing.stage("knn.score"):
        kernels.score_dot(corpus, q)
    torch.cuda.synchronize(card)
    t1 = time.time_ns()
    recs = tracing.take_stages()
    tracing.record_stages(False)
    prof.__exit__(None, None, None)
    evs = stages.events(prof)
    (s,) = recs
    launches = [e for e in evs if not e[1] and "Launch" in e[0]
                and s["t0_ns"] <= e[2] <= s["t1_ns"]]
    kern = [e for e in evs if e[1] and "score_dot" in e[0] and e[2] >= t0]
    assert len(kern) == 1, [e[0] for e in evs if e[1]]
    assert [e[4] for e in launches] == [kern[0][4]]
    assert launches[0][5] == stages.i32(s["tid"])
    rec = stages.reduce(evs, recs, (t0, t1))
    assert rec["stages"]["knn.score"]["device_s"] == pytest.approx(
        (min(kern[0][3], t1) - kern[0][2]) / 1e9)
    assert rec["staged_s"] > 0
    assert np.isclose(rec["stages"]["knn.score"]["host_s"],
                      (s["t1_ns"] - s["t0_ns"]) / 1e9)


def test_merge_is_the_harness_union():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1000, 400)
    iv = np.stack([a, a + rng.integers(0, 30, 400)], 1).astype(np.int64)
    want = trace._union(iv[np.argsort(iv[:, 0], kind="stable")])
    assert np.array_equal(stages._merge(iv), want)
    assert stages._merge(iv[:0]).shape == (0, 2)


def test_annotate_gives_the_stages_a_request(capsys):
    t = stages.StageTracer(True)
    t.rec = stages.reduce(_events(), _stages(), (0, 100 * MS))
    t.rec["busy_s"] = 0.054
    t.recorded = 4
    stages.StageTracer.last = t
    out = stages.annotate({"attempted": 2, "metrics": {}})
    assert out["stages"]["knn.score"] == {
        "count": 0.5, "host_ms": pytest.approx(7.5),
        "device_ms": pytest.approx(5.0), "idle_ms": pytest.approx(2.5)}
    assert out["stage_args"] == {}
    assert out["coverage"] == pytest.approx(0.027 / 0.054)
    assert out["metrics"]["knn_select_ms"]["value"] == pytest.approx(7.0)
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("stage knn count 1.000 ")
    assert err[-1].startswith("stages cover 50.00% of the busy time")
