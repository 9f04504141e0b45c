"""The benchmark of dgraph_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell's files are found by name
(`harness/spec.py`); the run makes its inputs from the seed, builds the
program's state, warms the cell's shapes, measures for the seconds
given, checks what the window's requests returned against the plain
reference, and prints one JSON object as the last line of its standard
output: the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics from the profiler's record. The numbers compared, each with its
limit, are the last lines of its standard error and the last key of
that object.

It exits with an error, and prints no result, where there is no CUDA
card or fewer than the cell asks for, and where JAX or the JAX package
has been loaded by the time the window has closed. Build and kernel
caches stay inside the checkout, under `build/`.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# fixed cache directories inside the checkout, set before any library
# reads them; libraries that would load JAX by themselves are told not to
CACHE = ROOT / "build" / "benchmark"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the checkout's root, not this folder, leads the import path
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, guard, spec

    # one process, few threads: the host's side of the window is serial
    torch.set_num_threads(1)

    bench = spec.benchmark()
    chips = spec.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   dev, T_BEGIN, bench=bench, kind=kind)
    bad = guard.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; the benchmark "
              f"runs without JAX and the JAX package", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"].update(kind=kind, count=chips, power=power_limit())
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'holds' if c['holds'] else 'FAILS'}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
