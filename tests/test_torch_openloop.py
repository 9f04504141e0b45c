"""The port's open-loop scheduler and latency summaries
(dgraph_tpu_torch.bench.openloop) against the reference's, on the CPU,
with no tolerance.

The summaries must be equal on numpy-seeded latency lists, empty and
one-element lists included. `run_open_loop` runs both packages on one
fake clock (a pass's `time` is a namespace whose `sleep` advances
`perf_counter`), one worker, so the schedule (its offsets from the first
arrival too), every latency and every result are equal to the bit;
then on the real clock with several workers, where every latency,
counted from the scheduled arrival, must be at least the submit's own
service time (the coordinated-omission correction).
"""

from __future__ import annotations

import threading
import time
import types
import warnings

import numpy as np
import pytest

from dgraph_tpu.bench import openloop as jol
from dgraph_tpu_torch.bench import openloop as tol

PKGS = {"ref": jol, "port": tol}


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the same error on both sides
        return "raised", type(e).__name__


def _lists():
    rng = np.random.default_rng(20260803)
    out = {"empty": [], "one": [0.0123], "zero": [0.0],
           "ties": [0.005] * 40 + [0.4] * 3}
    for n in (2, 3, 5, 7, 10, 99, 100, 101, 999, 1000, 1001):
        out[f"lognormal{n}"] = list(rng.lognormal(-4.0, 1.0, n))
    for n in (4, 100, 1000):
        out[f"uniform{n}"] = list(rng.uniform(0.0, 0.5, n))
        out[f"exponential{n}"] = list(rng.exponential(0.02, n))
    out["heavy_tail"] = list(rng.pareto(1.5, 500) * 1e-3)
    out["integers"] = [float(x) for x in rng.integers(1, 9, 64)]
    return out


@pytest.mark.parametrize("name", sorted(_lists()))
@pytest.mark.parametrize("fn", ("percentiles", "latency_summary"))
def test_summaries_equal(fn, name):
    lat = _lists()[name]
    with warnings.catch_warnings():
        # numpy warns on an empty list's mean, on both sides alike
        warnings.simplefilter("ignore")
        want = _outcome(getattr(jol, fn), lat)
        got = _outcome(getattr(tol, fn), lat)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("total,dispatches", [(0, 0), (1, 0), (16, 1),
                                              (480, 37), (7, 3.5),
                                              (100, 0.5), (3, 7), (2, 3),
                                              (1000, 3), (5, 2.0),
                                              (480, 0.25), (1, 1)])
def test_occupancy_equal(total, dispatches):
    assert tol.occupancy(total, dispatches) == \
        jol.occupancy(total, dispatches)


class FakeClock:
    """perf_counter and sleep of one shared fake time line."""

    def __init__(self, start: float):
        self.t = start
        self.lock = threading.Lock()

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        with self.lock:
            self.t += s


def _fake_run(mod, monkeypatch, burst_of, service_s):
    clock = FakeClock(5000.0)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter, sleep=clock.sleep))
    results, arrivals = [], []

    def submit(req):
        clock.sleep(service_s[req])
        return req * 3

    lat = mod.run_open_loop(submit, list(range(len(service_s))), 1, 40.0,
                            burst_of=burst_of, results=results,
                            arrivals_out=arrivals)
    return lat, results, arrivals


BURSTS = {"plain": None, "bursts": [0, 0, 0, 1, 2, 2, 3, 3, 3, 3, 4, 5],
          "one_slot": [0] * 12}


@pytest.mark.parametrize("schedule", sorted(BURSTS))
def test_run_open_loop_equal_on_a_fake_clock(schedule, monkeypatch):
    rng = np.random.default_rng(7)
    service = list(rng.uniform(0.001, 0.08, 12))
    want = _fake_run(jol, monkeypatch, BURSTS[schedule], service)
    got = _fake_run(tol, monkeypatch, BURSTS[schedule], service)
    assert got == want
    lat, results, arrivals = got
    assert [a - arrivals[0] for a in arrivals] == \
        [a - want[2][0] for a in want[2]]
    assert results == [(i, i * 3) for i in range(12)]
    assert all(a >= s for a, s in zip(lat, service))


@pytest.mark.parametrize("schedule", ("plain", "bursts"))
def test_run_open_loop_counts_from_the_scheduled_arrival(schedule):
    """Real clock, 4 workers, a service time past the arrival gap: the
    queue grows, and every latency holds its op's own service time and
    the queueing before it."""
    rates = 200.0
    for side, mod in PKGS.items():
        served = {}

        def submit(req, _served=served):
            t0 = time.perf_counter()
            time.sleep(0.012)
            _served[req] = time.perf_counter() - t0
            return req

        arrivals, results = [], []
        lat = mod.run_open_loop(submit, list(range(24)), 4, rates,
                                burst_of=[i // 3 for i in range(24)] if
                                schedule == "bursts" else None,
                                results=results, arrivals_out=arrivals)
        assert sorted(i for i, _ in results) == list(range(24))
        assert all(lat[i] >= served[i] for i in range(24)), side
        # 24 ops of 12 ms on 4 workers at 200/s: the last ones queue
        assert max(lat) > 0.012 * 24 / 4 - 24 / rates
        assert arrivals == sorted(arrivals) and len(arrivals) == 24
