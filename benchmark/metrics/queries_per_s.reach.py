"""queries_per_s.reach: the queries answered in the window of a reach cell,
their results on the host, over the window's seconds (host clock)."""

from benchmark.harness.host_clock import queries_per_s as read  # noqa: F401
