#!/usr/bin/env python3
"""Sweep the port's `score_dot` kernel over its two routes on one NVIDIA
H100, to place the crossover batch and the row route's lanes a row.

    python3 score_dot_sweep.py [--n 262144] [--d 128] [--out FILE]

It builds `csrc/score.cu` (printing ptxas' registers and spills), then:

- holds every route and lanes setting against the plain version within
  the reordering bound (`chip_smoke.check_score`: also through `out=`
  into a buffer off 16 bytes) at d 16/37/100/128/1024, n 1/777/65,536,
  b 1-33, and on a corpus off 16 bytes;
- times, from a flushed L2, at (b, n, d) for b 1-256: the tile route,
  the row route at each lanes setting, and the plain version
  (`torch.matmul`), beside the bound;
- times the plan's route at the exact tier's shapes, (1, 262,144, 128),
  (1, 131,072, 128), (1, 65,536, 128), (1, 16,384, 128) and
  (256, 1M, 128).

Prints every figure, and writes them to `--out` as JSON (default
build/score_dot_sweep.json). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = (1, 2, 4, 8, 16, 32)
BATCHES = (1, 2, 3, 4, 8, 16, 32, 40, 48, 64, 128, 256)
CHECK_BATCHES = (1, 2, 3, 4, 8, 16, 32, 33)
CHECK_SHAPES = [(d, n) for d in (16, 37, 100, 128, 1024)
                for n in (1, 777, 65_536)]
TABLE_SHAPES = ((1, 262_144, 128), (1, 131_072, 128), (1, 65_536, 128),
                (1, 16_384, 128), (256, 1_000_000, 128))
REPS = 20


def vec_of(d: int, corpus) -> int:
    return 4 if d % 4 == 0 and corpus.data_ptr() % 16 == 0 else 1


def row_plans(kernels, b: int, d: int, corpus):
    """(label, plan) of the row route at every lanes setting for b
    queries, in passes of the smallest query tile that holds them (of
    the largest above that)."""
    tiles = sorted(kernels.DOT_ROW_LANES)
    q_tile = next((t for t in tiles if t >= b), tiles[-1])
    return [(f"rows_lanes{lanes}", kernels.DotPlan(
        kernels.DOT_ROWS, vec_of(d, corpus), q_tile, lanes))
        for lanes in LANES]


def tile_plan(kernels, d: int, corpus):
    return kernels.DotPlan(kernels.DOT_TILE, vec_of(d, corpus),
                           kernels.DOT_TILE_Q, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "score_dot_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("score_dot_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dgraph_tpu_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(["score"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_logs.get("score", "").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": card, "checks": 0, "worst_ratio": 0.0}

    def check(plan, corpus, q, label):
        fn = functools.partial(kernels.score_dot, plan=plan)
        _, ratio = cs.check_score(fn, kernels.score_dot_reference, corpus,
                                  q, label)
        report["checks"] += 1
        report["worst_ratio"] = max(report["worst_ratio"], ratio)

    for d, n in CHECK_SHAPES:
        corpus = torch.randn((n, d), device=dev, generator=gen)
        for b in CHECK_BATCHES:
            q = torch.randn((b, d), device=dev, generator=gen)
            check(tile_plan(kernels, d, corpus), corpus, q,
                  f"tile b={b} n={n} d={d}")
            for label, plan in row_plans(kernels, b, d, corpus):
                check(plan, corpus, q, f"{label} b={b} n={n} d={d}")
    flat = torch.randn(65_536 * 128 + 1, device=dev, generator=gen)
    corpus = flat[1:].view(65_536, 128)
    for b in (1, 3, 33):
        q = torch.randn((b, 128), device=dev, generator=gen)
        for label, plan in row_plans(kernels, b, 128, corpus):
            check(plan, corpus, q, f"{label} b={b} off 16 bytes")
    del flat, corpus
    print(f"checks: {report['checks']} (route, shape) pairs within the "
          f"reordering bound, worst error/bound {report['worst_ratio']:.4g}"
          f" | {card}", flush=True)

    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    n, d = args.n, args.d
    corpus = torch.randn((n, d), device=dev, generator=gen)
    sweep = []
    for b in BATCHES:
        q = torch.randn((b, d), device=dev, generator=gen)
        row = {"b": b, "n": n, "d": d,
               "plan": kernels.score_dot_plan(b, d, 16)._asdict()}
        row["tile_ms"] = cs.device_ms_cold(lambda: kernels.score_dot(
            corpus, q, plan=tile_plan(kernels, d, corpus)), REPS, flush)
        for label, p in row_plans(kernels, b, d, corpus):
            row[f"{label}_ms"] = cs.device_ms_cold(
                lambda: kernels.score_dot(corpus, q, plan=p), REPS, flush)
        row["plain_ms"] = cs.device_ms_cold(
            lambda: kernels.score_dot_reference(corpus, q), REPS, flush)
        row["bound_ms"], row["bound_by"] = cs.score_bound_ms([(corpus, q)])
        sweep.append(row)
        print("sweep " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "plan") + f" | {card}",
            flush=True)
    report["sweep"] = sweep
    del corpus

    table = []
    for b, n, d in TABLE_SHAPES:
        corpus = torch.randn((n, d), device=dev, generator=gen)
        q = torch.randn((b, d), device=dev, generator=gen)
        row = {"b": b, "n": n, "d": d,
               "plan": kernels.score_dot_plan(b, d, 16)._asdict()}
        row["ms"] = cs.device_ms_cold(lambda: kernels.score_dot(corpus, q),
                                      REPS, flush)
        row["plain_ms"] = cs.device_ms_cold(
            lambda: kernels.score_dot_reference(corpus, q), REPS, flush)
        row["library_ms"] = cs.device_ms_cold(
            lambda: torch.matmul(q, corpus.T), REPS, flush)
        row["bound_ms"], row["bound_by"] = cs.score_bound_ms([(corpus, q)])
        table.append(row)
        print(f"shape ({b}, {n}, {d}) {row['plan']}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
              f"torch.matmul {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}) | {card}",
              flush=True)
        del corpus
    report["table"] = table
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
