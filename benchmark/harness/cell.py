"""One run of one cell: set-up, window, check, metrics, result.

The order is fixed so that each reading means one thing:

1. the entry builds its inputs from the seed and the program's state,
   and warms every shape the cell uses (set-up, timed as `setup_s`);
2. the window: the closed loop for the run's seconds, under the
   profiler when traced;
3. the device's peak memory is read;
4. the program's state is freed and the reference checks what the
   window's requests returned, once the window has closed;
5. each metric's reader takes its number from the run's record.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import torch

from benchmark.harness import loop, spec
from benchmark.harness.trace import Tracer
from benchmark.work.peaks import peaks


@dataclass
class Context:
    """What an entry's set-up is given."""

    cell: str
    config: dict
    traffic: dict
    check: dict
    seed: int
    device: torch.device


@dataclass
class Run:
    """A run's record, which the metric readers read."""

    cell: str
    setup_s: float
    window_s: float
    latencies_s: list[float]
    queries: int
    trace: dict | None
    work: dict = field(default_factory=dict)


def judge(found: dict, limits: dict) -> dict:
    """Each number compared, with its limit and whether it holds. A
    limit is [rule, bound], the rule "<=" or ">="."""
    out = {}
    for name, (rule, bound) in limits.items():
        v = found[name]
        ok = v <= bound if rule == "<=" else v >= bound
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": bound, "rule": rule, "holds": bool(ok)}
    return out


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_begin: float, bench: dict | None = None,
        kind: str | None = None, workload: dict | None = None,
        config: dict | None = None) -> dict:
    """One run; returns the result object (the run's last line). `kind`
    names the card whose peaks the rooflines use (None: none).
    `workload` and `config` stand in for the cell's files (the tests run
    cells at small sizes on the CPU)."""
    bench = bench if bench is not None else spec.benchmark()
    wl = workload if workload is not None else spec.workload(cell)
    cfg = config if config is not None else spec.config(wl["config"])
    ctx = Context(cell, cfg, wl["traffic"], wl["check"], seed, device)
    entry = spec.module("entries", wl["entry"]).setup(ctx)
    tracer = Tracer(trace)
    warm = 2 * entry.in_flight
    loop.closed_loop(entry, count=warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tracer.start()
    if trace:   # one traced request before the window: a profiler
        loop.closed_loop(entry, count=1, start=warm)   # misses its first
    # the set-up's objects are no work of the window's collector
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_begin
    with tracer.window():
        lat, window_s = loop.closed_loop(entry, seconds=seconds,
                                         start=warm + 1)
    gc.unfreeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    rec = tracer.stop()
    entry.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = entry.check()
    checks = judge(found, wl["check"]["limits"])
    work = entry.work(peaks(kind)) if kind else {}
    record = Run(cell, setup_s, window_s, lat,
                 len(lat) * entry.queries, rec, work)
    metrics = {}
    for m in spec.metrics(bench, cell, trace):
        v = spec.module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": all(c["holds"] for c in checks.values()),
        "attempted": len(lat),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "memory_peak_bytes": int(peak)},
    }
    if rec is not None:
        out["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        out["breakdown"] = {"device_ops": rec["device_ops"],
                            "idle_gaps": rec["idle_gaps"]}
    out["checks"] = checks
    return out
