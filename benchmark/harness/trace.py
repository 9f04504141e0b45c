"""The traced run: the profiler's record of a window, reduced.

`Tracer` runs `torch.profiler` over the window with the device's
activity alone: its operations (kernels, copies, fills) and the host's
calls into the CUDA runtime. Recording every host operation as well
doubled the device's idle share in the traced window on the card
(reach3 41% against 21%, knn-q1 41% against 27%), so the host's side is
read from its runtime calls. The window is marked by the host's clock,
which the profiler's timestamps share.

`reduce` takes from the record what the per-layer metrics read: the
device's operations inside the window, the seconds in which one of them
ran (`busy_s`, the union of their intervals), the window's length, the
kernels counted (fills among them, copies and memsets not), the operations that took most time by name, and the
longest idle gaps, each named by the runtime call the host was in when
the gap began.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

TOP = 10
NAME_CHARS = 120


class Tracer:
    """The profiler over one window, or nothing when tracing is off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.marks = (0, 0)

    @contextmanager
    def window(self):
        """The window, marked by the host's clock."""
        t0 = time.time_ns()
        yield
        self.marks = (t0, time.time_ns())

    def start(self) -> None:
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self) -> dict | None:
        """End the profiler and reduce its record."""
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        rec = reduce(events(self.prof), self.marks)
        self.prof = None
        return rec


def _kept(rows) -> list[tuple[str, bool, int, int]]:
    """Drop user annotations: they lie on the device's timeline too,
    covering the operations they launched, and are no operation."""
    return [(n, dev, a, b) for n, dev, ann, a, b in rows if not ann]


def events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, ran on the device, start ns, end ns) of every event, read
    from the profiler's raw record: the reduction needs no event tree."""
    return _kept((e.name(), str(e.device_type()).endswith("CUDA"),
                  bool(e.is_user_annotation()), e.start_ns(),
                  e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events())


def is_kernel(name: str) -> bool:
    """A kernel launch: every device operation but the runtime's copies
    and memsets. PyTorch's fills (`FillFunctor`) are kernels the host
    launches, and count."""
    return not name.startswith(("Memcpy", "Memset"))


def idle_share(run):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [n, 2] sorted-by-start intervals."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, np.int64).reshape(-1, 2)


def _host_label(host: list, starts: np.ndarray, ends: np.ndarray,
                t: int) -> str:
    """The innermost host call running at t."""
    inside = np.flatnonzero((starts <= t) & (ends >= t))
    if not len(inside):
        return "host, in no CUDA call"
    return host[inside[np.argmax(starts[inside])]][0][:NAME_CHARS]


def reduce(evs: list[tuple[str, bool, int, int]],
           marks: tuple[int, int]) -> dict:
    """The record of the window [marks[0], marks[1]] (ns). Raises when no
    device operation ran in it."""
    w0, w1 = marks
    dev = sorted((max(a, w0), min(b, w1), n) for n, d, a, b in evs
                 if d and b > w0 and a < w1)
    if not dev:
        raise RuntimeError("the trace has no device operation in the window")
    merged = _union(np.asarray([(a, b) for a, b, _ in dev], np.int64))
    busy = int((merged[:, 1] - merged[:, 0]).sum())
    by_name: dict = defaultdict(int)
    kernels = 0
    for a, b, n in dev:
        by_name[n] += b - a
        kernels += is_kernel(n)
    edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
    gaps = [(int(a), int(b)) for a, b in edges if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, a, b) for n, d, a, b in evs if not d and b >= w0 and a <= w1]
    starts = np.asarray([a for _, a, _ in host], np.int64)
    ends = np.asarray([b for _, _, b in host], np.int64)
    idle = [[_host_label(host, starts, ends, a), (b - a) / 1e9]
            for a, b in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
        "idle_gaps": idle,
    }
