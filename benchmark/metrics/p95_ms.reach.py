"""p95_ms.reach: the 95th percentile, by nearest rank, of the time from
dispatch to result on the host of every request (a batch of 24,576 queries) completed in
the window of a reach cell, in milliseconds (host clock)."""

from benchmark.harness.host_clock import p95_ms as read  # noqa: F401
