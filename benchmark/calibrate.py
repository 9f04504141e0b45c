"""Readings of a cell's control at the cell's own size, for setting the
limits of its check.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13

runs, for each seed, the cell's control (its entry's `control`: the
plain reference one precision lower, or with one guarantee broken, in
the program's place) and prints each number the run's check compares
beside the limit it is held to, one JSON object a seed. A limit has to
fail the control, and pass the program's own runs (`run.py`), with room
on both sides. It needs a card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="seeds, separated by commas")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    wl = spec.workload(args.workload)
    mod = spec.module("entries", wl["entry"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = cell.Context(args.workload, spec.config(wl["config"]),
                           wl["traffic"], wl["check"], seed, dev)
        found = mod.control(ctx)
        checks = cell.judge(found, wl["check"]["limits"])
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "control_fails": not all(
                              c["holds"] for c in checks.values()),
                          "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
