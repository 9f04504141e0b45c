"""One run of one cell as `benchmark/run.py` makes it, with the program's
stages recorded over the window:

    python3 benchmark/run_stages.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

run from the root of a checkout. The cell, its set-up, window, check and
metrics are `run.py`'s, through the same harness files; only the tracer
is `harness/stages.StageTracer`. With `--trace 1` the result line adds
`stages` (each stage's count, host, device and idle milliseconds a
request), `coverage` (the share of the device's busy time in which an
operation some stage launched ran), the window's idle seconds and those
that began inside a stage, and the stage readings among `metrics`; one
line a stage goes to standard error before the check lines. With
`--trace 0` the stages are recorded without the profiler, so the
end-to-end metrics beside `run.py`'s give the cost of recording them.

This entry point is temporary. It swaps `harness/cell`'s tracer and run
at run time because `run.py` does not yet read stages. Once
`harness/trace.py`'s `Tracer` records them and the ten stage readings
have their own files under `benchmark/metrics/`, this file goes, and
`harness/stages.events` and `_merge` fold into `trace.events` and
`trace._union`.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402  (starts run's clock)


def main(argv: list[str] | None = None) -> int:
    from benchmark.harness import cell, stages

    plain_run = cell.run

    def run_with_stages(*args, **kwargs) -> dict:
        return stages.annotate(plain_run(*args, **kwargs))

    cell.Tracer = stages.StageTracer
    cell.run = run_with_stages
    return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
