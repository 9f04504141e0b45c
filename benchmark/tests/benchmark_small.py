"""Small versions of the cells, for runs on the CPU."""

from __future__ import annotations

import copy

from benchmark.harness import spec

CELLS = ("graph500-s20.reach3", "sift1m.knn-q1", "sift1m.knn-b256",
         "graph500-s20.reach1")


def small(cell: str) -> tuple[dict, dict]:
    """The cell's workload and configuration cut to a size the CPU runs
    in a fraction of a second: the same entry, traffic kind and limits."""
    wl = copy.deepcopy(spec.workload(cell))
    cfg = copy.deepcopy(spec.config(wl["config"]))
    if wl["entry"] == "bfs_digest":
        cfg["sizes"].update(scale=10)
        wl["traffic"].update(batch=96, distinct_batches=4)
    else:
        cfg["sizes"].update(n_rows=9000, dim=16)
        wl["traffic"].update(distinct_batches=8,
                             batch=min(wl["traffic"]["batch"], 8))
        wl["check"].update(calls=min(wl["check"]["calls"], 8))
    return wl, cfg
