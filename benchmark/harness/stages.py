"""The program's stages in a traced window: each device operation paired
with the stage that launched it, each idle gap with the stage the host
was in when it began.

The port records a stage's host interval on `time.time_ns()`, the clock
of the profiler's events (`dgraph_tpu_torch.utils.tracing.stage`), with
its thread's `threading.get_ident()`. The profiler stamps a kernel, copy
or memset and the runtime call that launched it with one correlation id,
and the runtime call with the low 32 bits of its thread's pthread id, as
a signed int (`device_resource_id`; read on an H100 under torch 2.11 and
CUDA 12.8 with the CUDA activity alone). So an operation belongs to the
innermost stage on the launching thread whose interval holds the launch;
one launched outside every stage, or on a thread with none, to none.

`StageTracer` is the harness's `Tracer` with the program's stage
recording on from its start to its stop. Its record is `trace.reduce`'s,
key for key, plus the keys `reduce` below adds. Against a program that
records no stages it adds nothing; with the profiler off it records the
stages all the same (the cost of recording, alone) and keeps their count.
Only `benchmark/run_stages.py`, a temporary entry point, uses it until
`trace.Tracer` records the stages itself.
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from benchmark.harness import trace

# the root stage of each family's entry point, and the family's readings
ROOTS = {"digest": "reach", "knn": "knn"}


def program_tracing():
    """The program's tracing module where it records stages, else None."""
    try:
        from dgraph_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing if hasattr(tracing, "record_stages") else None


def i32(v: int) -> int:
    """`v`'s low 32 bits as a signed int: a thread id as CUPTI gives it."""
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def i32_array(v: np.ndarray) -> np.ndarray:
    """`i32` of each of an int64 array."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def events(prof) -> list[tuple[str, bool, int, int, int, int]]:
    """(name, ran on the device, start ns, end ns, correlation id, the
    thread of a host call or the stream of a device operation) of every
    event but user annotations, from the profiler's raw record."""
    return [(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns(),
             e.start_ns() + e.duration_ns(), e.correlation_id(),
             e.device_resource_id())
            for e in prof.profiler.kineto_results.events()
            if not e.is_user_annotation()]


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of [n, 2] intervals, as sorted disjoint intervals (those
    that touch merge, as `trace._union` merges them)."""
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    if not len(iv):
        return iv.reshape(0, 2)
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)


class _Timeline:
    """The innermost of one thread's stages at each instant: from `at[i]`
    on, stage `who[i]` (-1: none). A thread's stages nest, as its
    context managers do; an interval holds both its ends."""

    def __init__(self, recs: list[dict], idx: list[int]):
        at: list[int] = []
        who: list[int] = []
        open_: list[int] = []

        def close(before: int | None) -> None:
            while open_ and (before is None
                             or recs[open_[-1]]["t1_ns"] < before):
                end = recs[open_.pop()]["t1_ns"] + 1
                at.append(end)
                who.append(open_[-1] if open_ else -1)

        for i in sorted(idx, key=lambda i: (recs[i]["t0_ns"],
                                            -recs[i]["t1_ns"])):
            close(recs[i]["t0_ns"])
            open_.append(i)
            at.append(recs[i]["t0_ns"])
            who.append(i)
        close(None)
        self.at = np.asarray(at, np.int64)
        self.who = np.asarray(who, np.int64)

    def at_times(self, t: np.ndarray) -> np.ndarray:
        """The stage holding each instant of `t`, or -1."""
        pos = np.searchsorted(self.at, t, side="right") - 1
        return np.where(pos >= 0, self.who[np.maximum(pos, 0)], -1)


def reduce(evs: list[tuple[str, bool, int, int, int, int]],
           stages: list[dict], marks: tuple[int, int]) -> dict:
    """What the stages add to the record of the window [marks[0],
    marks[1]] (ns):

    - `stages`: for each stage name, `count` (records that overlap the
      window), `host_s` (their host intervals clipped to the window),
      `device_s` (the clipped device time of the operations it launched
      itself, its child stages' not) and `idle_s` (the idle gaps that
      began while it was the host's innermost stage);
    - `stage_args`: the same for each stage name with its attributes
      (`digest.core level=2`), where a stage has some;
    - `runtime_calls`: for each stage name, the host's seconds in the
      runtime calls made while it was the innermost stage, by call (the
      longest first): launches, copies, waits;
    - `idle_s`: the window's idle seconds (no device operation running);
    - `idle_in_program_s`: those of gaps that began inside a stage;
    - `staged_s`: the seconds in which an operation some stage launched
      ran (the union of their clipped intervals), to set beside
      `busy_s`."""
    w0, w1 = marks
    recs = [r for r in stages if r["t1_ns"] >= w0 and r["t0_ns"] <= w1]
    by_thread: dict = defaultdict(list)
    for i, r in enumerate(recs):
        by_thread[i32(r["tid"])].append(i)
    lines = {tid: _Timeline(recs, idx) for tid, idx in by_thread.items()}

    # device operations in the window, each to its launch's stage
    host = np.asarray([(c, a, tid) for _, d, a, _, c, tid in evs
                       if not d and c], np.int64).reshape(-1, 3)
    host = host[np.argsort(host[:, 0], kind="stable")]
    dev = np.asarray([(a, b, c) for _, d, a, b, c, _ in evs
                      if d and b > w0 and a < w1], np.int64).reshape(-1, 3)
    dev_iv = np.clip(dev[:, :2], w0, w1)
    launch_t = launch_tid = np.zeros(len(dev), np.int64)
    launched = np.zeros(len(dev), bool)
    if len(host):
        at = np.minimum(np.searchsorted(host[:, 0], dev[:, 2]), len(host) - 1)
        launched = host[at, 0] == dev[:, 2]
        launch_t, launch_tid = host[at, 1], i32_array(host[at, 2])
    owner = np.full(len(dev), -1, np.int64)
    for tid, line in lines.items():
        pick = launched & (launch_tid == tid)
        owner[pick] = line.at_times(launch_t[pick])
    iv = _merge(dev_iv[owner >= 0])

    # idle gaps, each to the innermost stage the host was in at its start
    edges = np.concatenate([[w0], _merge(dev_iv).ravel(), [w1]])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    # a start per stage, and -1 for none (index -1 reads the last entry)
    starts = np.asarray([r["t0_ns"] for r in recs] + [-1], np.int64)
    held = np.full(len(gaps), -1, np.int64)
    for line in lines.values():
        s = line.at_times(gaps[:, 0])
        inner = (s >= 0) & (starts[s] > starts[held])
        held[inner] = s[inner]
    gap_s = (gaps[:, 1] - gaps[:, 0]) / 1e9

    # the host's runtime calls in the window, each to the stage it ran in
    calls = [(n, a, min(b, w1) - max(a, w0), tid) for n, d, a, b, _, tid
             in evs if not d and b > w0 and a < w1]
    call_stage = np.full(len(calls), -1, np.int64)
    call_tid = i32_array(np.asarray([c[3] for c in calls], np.int64))
    call_t = np.asarray([c[1] for c in calls], np.int64)
    for tid, line in lines.items():
        pick = call_tid == tid
        call_stage[pick] = line.at_times(call_t[pick])
    in_calls: dict = defaultdict(lambda: defaultdict(float))
    for (n, _, ns, _), i in zip(calls, call_stage.tolist()):
        if i >= 0:
            in_calls[recs[i]["name"]][n[:trace.NAME_CHARS]] += ns / 1e9

    host_s = [(min(r["t1_ns"], w1) - max(r["t0_ns"], w0)) / 1e9 for r in recs]
    sums = (host_s, owner, (dev_iv[:, 1] - dev_iv[:, 0]) / 1e9, held, gap_s)
    labels = [f"{r['name']} " + " ".join(f"{k}={v}" for k, v in
                                         sorted(r["args"].items()))
              if r.get("args") else None for r in recs]
    return {"stages": _table([r["name"] for r in recs], *sums),
            "stage_args": _table(labels, *sums),
            "runtime_calls": {
                name: sorted(c.items(), key=lambda kv: -kv[1])[:trace.TOP]
                for name, c in sorted(in_calls.items())},
            "idle_s": float(gap_s.sum()),
            "idle_in_program_s": float(gap_s[held >= 0].sum()),
            "staged_s": int((iv[:, 1] - iv[:, 0]).sum()) / 1e9}


def _table(keys: list, host_s: list, owner: np.ndarray, op_s: np.ndarray,
           held: np.ndarray, gap_s: np.ndarray) -> dict:
    """For each key (one a stage record; None: left out), the count and
    the host, device and idle seconds of its records: `owner` and `held`
    index a record for each operation and idle gap (-1: none)."""
    names = sorted({k for k in keys if k is not None})
    col = {n: j for j, n in enumerate(names)}
    # a column a record, then one (the last) for none
    rec_col = np.asarray([col.get(k, len(names)) for k in keys]
                         + [len(names)], np.int64)

    def per(idx: np.ndarray, w) -> np.ndarray:
        return np.bincount(rec_col[idx], weights=w,
                           minlength=len(names) + 1)

    count = per(np.arange(len(keys)), None)
    host = per(np.arange(len(keys)), np.asarray(host_s, float))
    device = per(owner, op_s)
    idle = per(held, gap_s)
    return {n: {"count": int(count[j]), "host_s": float(host[j]),
                "device_s": float(device[j]), "idle_s": float(idle[j])}
            for n, j in col.items()}


class StageTracer(trace.Tracer):
    """The harness's tracer, the program's stages recorded from `start`
    to `stop`. The last one stopped is `StageTracer.last`."""

    last: StageTracer | None = None

    def __init__(self, on: bool):
        super().__init__(on)
        self.rec: dict | None = None
        self.recorded = 0

    def start(self) -> None:
        tr = program_tracing()
        if tr is not None:
            tr.record_stages(True)
        super().start()

    def stop(self) -> dict | None:
        tr = program_tracing()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        stages: list = []
        if tr is not None:
            stages = tr.take_stages()
            tr.record_stages(False)
        self.recorded = len(stages)
        StageTracer.last = self
        if self.prof is None:
            return None
        evs = events(self.prof)
        self.prof = None
        rec = trace.reduce([e[:4] for e in evs], self.marks)
        if stages:
            rec.update(reduce(evs, stages, self.marks))
        self.rec = rec
        return rec


def family(rec: dict) -> str | None:
    """The family whose entry's root stage the record holds."""
    for root, fam in ROOTS.items():
        if root in rec.get("stages", ()):
            return fam
    return None


def readings(rec: dict, requests: int) -> dict:
    """The per-layer readings of the stages, each with its unit, a
    request being a reach batch or a knn call; those with nothing to
    read are left out."""
    fam = family(rec)
    if fam is None or requests <= 0:
        return {}
    st = rec["stages"]

    def per(name: str, key: str):
        return 1e3 * st[name][key] / requests if name in st else None

    unit = "ms/batch" if fam == "reach" else "ms/call"
    if fam == "reach":
        vals = {"digest_seed_ms": per("digest.seed", "device_s"),
                "digest_level1_ms": per("digest.level1", "device_s"),
                "digest_core_ms": per("digest.core", "device_s"),
                "program_host_ms.reach": per("digest", "host_s")}
    else:
        vals = {"knn_score_ms": per("knn.score", "device_s"),
                "knn_epilogue_ms": per("knn.epilogue", "device_s"),
                "knn_select_ms": per("knn.select", "device_s"),
                "program_host_ms.knn": per("knn", "host_s")}
    out = {k: {"value": v, "unit": unit} for k, v in vals.items()
           if v is not None}
    if rec["idle_s"] > 0:
        out[f"idle_in_program.{fam}"] = {
            "value": 100.0 * rec["idle_in_program_s"] / rec["idle_s"],
            "unit": "%"}
    return out


def annotate(out: dict) -> dict:
    """Add the last tracer's stages to a run's result: with a trace, the
    stages a request, their coverage of the busy time and the readings
    (and one line a stage to standard error); without, the count of
    stages recorded."""
    t = StageTracer.last
    if t is None:
        return out
    out["stages_recorded"] = t.recorded
    rec = t.rec
    if rec is None or "stages" not in rec:
        return out
    n = max(1, out["attempted"])
    for key in ("stages", "stage_args"):
        out[key] = {
            name: {"count": s["count"] / n, "host_ms": 1e3 * s["host_s"] / n,
                   "device_ms": 1e3 * s["device_s"] / n,
                   "idle_ms": 1e3 * s["idle_s"] / n}
            for name, s in rec[key].items()}
    out["runtime_calls_ms"] = {
        name: [[call, 1e3 * sec / n] for call, sec in calls]
        for name, calls in rec["runtime_calls"].items()}
    out["coverage"] = rec["staged_s"] / rec["busy_s"]
    out["idle_s"] = rec["idle_s"]
    out["idle_in_program_s"] = rec["idle_in_program_s"]
    out["metrics"].update(readings(rec, out["attempted"]))
    for name, s in {**out["stages"], **out["stage_args"]}.items():
        print(f"stage {name} count {s['count']:.3f} host {s['host_ms']:.4f} "
              f"device {s['device_ms']:.4f} idle {s['idle_ms']:.4f} "
              f"ms a request", file=sys.stderr)
    print(f"stages cover {100 * out['coverage']:.2f}% of the busy time; "
          f"idle in the program {rec['idle_in_program_s']:.4f} of "
          f"{rec['idle_s']:.4f} s", file=sys.stderr)
    return out
