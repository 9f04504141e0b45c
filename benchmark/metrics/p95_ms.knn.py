"""p95_ms.knn: the 95th percentile, by nearest rank, of the time from
dispatch to result on the host of every request (a search call) completed in
the window of a knn cell, in milliseconds (host clock)."""

from benchmark.harness.host_clock import p95_ms as read  # noqa: F401
