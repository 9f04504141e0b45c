"""The port's stages (`dgraph_tpu_torch.utils.tracing.stage`): the no-op
while recording is off, the records while it is on, the span clock they
share, and the Chrome trace `profile_device` writes beside the
profiler's."""

import ast
import json
import threading
import time
import tracemalloc
from pathlib import Path

import pytest
import torch

import dgraph_tpu_torch
from dgraph_tpu_torch.utils import tracing

_PORT = Path(dgraph_tpu_torch.__file__).resolve().parent

@pytest.fixture
def recording():
    tracing.record_stages(True)
    try:
        yield
    finally:
        tracing.record_stages(False)
        tracing.take_stages()


class _NoClock:
    """Stands in for the `time` and `threading` modules: any read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name} while stages are off")


def test_off_is_the_shared_no_op(monkeypatch):
    assert tracing.take_stages() == []
    monkeypatch.setattr(tracing, "time", _NoClock())
    monkeypatch.setattr(tracing, "threading", _NoClock())
    a, b = tracing.stage("knn"), tracing.stage("knn.score", level=2)
    assert a is b is tracing._NO_STAGE
    with tracing.stage("knn") as got:
        assert got is None
        assert tracing.current() is None
    assert tracing.take_stages() == []


def _peak_bytes(fn) -> tuple[int, int]:
    """(bytes still held, peak bytes) that two calls of `fn` allocate,
    the least of five tries: tracemalloc also sees the process's other
    threads (a test worker's I/O thread)."""
    fn()
    tries = []
    for _ in range(5):
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            fn()
            fn()
            now, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        tries.append((now - before, peak - before))
    return min(tries)


def test_off_allocates_nothing():
    def calls():
        tracing.stage("knn")
        tracing.stage("knn.score")

    def bare_with():            # the interpreter's own cost of a `with`
        with tracing._NO_STAGE:
            pass

    def with_stage():
        with tracing.stage("knn"):
            pass

    assert _peak_bytes(calls) == (0, 0)
    assert _peak_bytes(with_stage) == _peak_bytes(bare_with)


def test_on_records_nest_and_join_the_request_trace(recording):
    t_before = time.time_ns()
    with tracing.bind("ab" * 16, "cd" * 8):
        with tracing.span("similar_to"):
            span_id = tracing.current()[1]
            with tracing.stage("knn", k=10):
                with tracing.stage("knn.score"):
                    pass
                with tracing.stage("knn.select"):
                    pass
    with tracing.stage("digest"):
        pass
    t_after = time.time_ns()
    recs = tracing.take_stages()
    assert tracing.take_stages() == []
    by = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["knn.score", "knn.select", "knn",
                                         "digest"]
    assert by["knn"]["parent_id"] == span_id
    assert by["knn"]["args"] == {"k": 10}
    for child in ("knn.score", "knn.select"):
        assert by[child]["parent_id"] == by["knn"]["span_id"]
        assert by["knn"]["t0_ns"] <= by[child]["t0_ns"] \
            <= by[child]["t1_ns"] <= by["knn"]["t1_ns"]
    for name in ("knn", "knn.score", "knn.select"):
        assert by[name]["trace_id"] == "ab" * 16
    # outside any trace a stage roots its own
    assert by["digest"]["parent_id"] == ""
    assert by["digest"]["trace_id"] == by["digest"]["span_id"]
    for r in recs:
        assert t_before <= r["t0_ns"] <= r["t1_ns"] <= t_after
        assert r["tid"] == threading.get_ident()
        assert r["name"] in tracing.SPAN_NAMES
    # stages stay out of the span ring and its observers
    assert not [s for s in tracing.recent_spans() if s["name"] == "knn"]


def test_record_stages_starts_afresh_and_take_keeps_later_records():
    tracing.record_stages(True)
    with tracing.stage("knn"):
        pass
    tracing.record_stages(True)            # on again: the old record goes
    with tracing.stage("digest"):
        pass
    tracing.record_stages(False)           # off: what was taken stays
    with tracing.stage("knn"):
        pass
    assert [r["name"] for r in tracing.take_stages()] == ["digest"]


def test_span_ends_share_the_profilers_clock():
    t_before = time.time_ns()
    with tracing.span("unit"):
        time.sleep(0.002)
    t_after = time.time_ns()
    (s,) = [s for s in tracing.recent_spans() if s["name"] == "unit"][-1:]
    assert t_before / 1e3 <= s["ts_us"]
    assert s["dur_us"] >= 2000
    assert s["ts_us"] + s["dur_us"] <= t_after / 1e3


def test_profile_device_writes_the_stages_beside_the_trace(tmp_path):
    with tracing.profile_device(str(tmp_path / "prof")):
        with tracing.stage("knn"):
            with tracing.stage("knn.score"):
                (torch.arange(100.0) * 2).sum()
    assert not tracing._stages_on
    assert tracing.take_stages() == []
    prof = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ev = json.loads((tmp_path / "prof" / "stages.json").read_text())
    xs = {e["name"]: e for e in ev["traceEvents"] if e["ph"] == "X"}
    assert set(xs) == {"knn", "knn.score"}
    # one base, so the stage holds the profiler's multiply
    assert ev["baseTimeNanoseconds"] == prof.get("baseTimeNanoseconds", 0)
    (mul,) = [e for e in prof["traceEvents"] if e.get("name") == "aten::mul"]
    assert xs["knn.score"]["ts"] <= mul["ts"]
    assert mul["ts"] + mul["dur"] <= \
        xs["knn.score"]["ts"] + xs["knn.score"]["dur"]
    assert xs["knn.score"]["args"]["parent_id"] == \
        xs["knn"]["args"]["span_id"]
    assert xs["knn"]["ts"] <= xs["knn.score"]["ts"]
    assert xs["knn"]["dur"] >= xs["knn.score"]["dur"] >= 0


def test_profile_device_leaves_an_outer_recording_alone(tmp_path,
                                                          recording):
    with tracing.stage("digest"):
        pass
    with tracing.profile_device(str(tmp_path / "prof")):
        with tracing.stage("knn"):
            pass
    assert tracing._stages_on
    assert [r["name"] for r in tracing.take_stages()] == ["digest", "knn"]
    ev = json.loads((tmp_path / "prof" / "stages.json").read_text())
    assert [e["name"] for e in ev["traceEvents"] if e["ph"] == "X"] == \
        ["knn"]


def _opened_names() -> list[tuple[str, int, str]]:
    """(file, line, name) of every literal name the port's tree passes to
    `span`, `_span` or `stage`, bare or through the tracing module."""
    out = []
    for path in sorted(_PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            if isinstance(fn, ast.Name):
                called = fn.id
            elif isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "tracing":
                called = fn.attr
            else:
                continue
            arg = node.args[0]
            if called in ("span", "_span", "stage") \
                    and isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str):
                out.append((str(path.relative_to(_PORT)), node.lineno,
                            arg.value))
    return out


def test_span_names_registered_once():
    assert len(tracing.SPAN_NAMES) == len(set(tracing.SPAN_NAMES))


def test_every_span_and_stage_name_in_the_port_is_registered():
    opened = _opened_names()
    names = {n for _, _, n in opened}
    # the scan sees the device layers' stages and the engine's spans
    assert {"digest.core", "knn.select", "query", "similar_to"} <= names
    unregistered = [o for o in opened if o[2] not in tracing.SPAN_NAMES]
    assert unregistered == []
