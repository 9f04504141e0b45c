"""Benchmarks of the port.

  bfs, vectors, setops  the BFS, vector and set-algebra planes' drivers
  spawn                 a multi-group, multi-process cluster of `node`
                        processes
  openloop              the open-loop arrival scheduler + latency/
                        percentile summarizers (latency = finish -
                        SCHEDULED arrival, so queueing counts)
  workload              the seeded LDBC-SNB-style social-graph generator
                        and deterministic mixed read/write op stream
"""
