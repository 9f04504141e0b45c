"""Readings of a run that the host's clock takes: the rate and the tail
of its requests, shared by the per-family metrics that report them."""

from __future__ import annotations

import math


def queries_per_s(run):
    """The queries answered in the window, their results on the host,
    over the window's seconds."""
    if not run.latencies_s or run.window_s <= 0:
        return None
    return run.queries / run.window_s


def p95_ms(run):
    """The 95th percentile, by nearest rank, of every completed
    request's time from its dispatch to its result on the host, in
    milliseconds."""
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
