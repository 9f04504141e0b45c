#!/usr/bin/env python3
"""Drive the port's batched BFS plane once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the port's
kernels from `dgraph_tpu_torch/csrc/` into `build/dgraph_tpu_torch/`.
Phases, each of which fails the run:

1. card: name and power limit (nvidia-smi);
2. build: nvcc of every kernel source, timed;
3. kernels against their plain PyTorch versions on the card, bit-exact,
   over W in {1, 5, 128, 768}, degrees {1, 2, 3, 4, 6}, a hub row of
   degree > 2^20 and padding indices at the dummy row N;
4. the main path at the reference regime (bench.py's shape: 2M nodes,
   21M generated zipf(1.3) edges, B = 24,576 queries of 8 seeds, depth
   3): the digest with the kernel, with the kernels' launch counts set
   to 0 just before and read just after; sustained ms per batch with
   PIPE batches in flight (all batches over all the timed wall time);
   then `bfs_bits_reach_batched`, counted on its own the same way;
5. answers: the digest's level sums and first-word column against the
   digest run with the plain version on the card; per-query counts of
   queries 0..31 and per-level uid sets of the first REACH_QUERIES
   queries against the numpy oracle;
6. per level, the kernel's time over that level's launches beside the
   plain version's time and the bound (bytes over 3.35 TB/s);
7. where a batch's device time goes: torch.profiler over PIPE batches,
   self device time by kernel name and the device's idle share.

Prints the figures on earlier lines, then one JSON line of kernels, the
card's line, and last `{"ok": true, "device": {...}}`. Exits non-zero,
printing no result, without a card or without the rest of the repo.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# level sums of seed matrix 0 from the TPU run of bench.py recorded in
# BENCH_r05.json (TPU v5e, same generator seeds): informational only,
# since another numpy could draw another graph
TPU_LEVEL_SUMS = [1009222, 3337375, 7608784]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
RUNS = 4                           # timed groups of PIPE batches
REACH_QUERIES = 48
KERNEL_REPS = 10
PLAIN_REPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def check_kernel_shapes(kernels, dev, card: str) -> int:
    """Phase 3: bucket_or against bucket_or_reference on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 40_000
    cases = [(20_000, d) for d in (1, 2, 3, 4, 6)]
    cases += [(3, 3_000), (1, (1 << 20) + 24)]      # split rows, a hub
    worst = 0
    for width in (1, 5, 128, 768):
        f = torch.randint(-2**31, 2**31, (n + 1, width), dtype=torch.int32,
                          device=dev, generator=gen)
        f[n] = 0                                     # dummy row
        for m, d in cases:
            nb = torch.randint(0, n + 1, (m, d), dtype=torch.int32,
                               device=dev, generator=gen)
            nb.view(-1)[::5] = n                     # padding entries
            if m > 7:
                nb[1::7] = n                         # all-padding rows
            got = kernels.bucket_or(f, nb)
            want = kernels.bucket_or_reference(f, nb)
            # the out= path: a slice inside a larger tensor, neighbours kept
            big = torch.full((m + 2, width), 7, dtype=torch.int32,
                             device=dev)
            kernels.bucket_or(f, nb, out=big[1:m + 1])
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want) or \
                    not torch.equal(big[1:m + 1], want) or \
                    not bool((big[0] == 7).all() & (big[m + 1] == 7).all()):
                raise AssertionError(
                    f"bucket_or != plain version at W={width} M={m} D={d}")
        del f
    log(f"kernel check: bucket_or bit-exact to its plain version on "
        f"W {{1,5,128,768}} x {len(cases)} shapes (hub D=2^20+24) | {card}")
    return worst


def level_records(calls, offsets: dict[int, int]):
    """Group the recorded (f, in_nb) calls of a digest into levels, one
    per frontier tensor in call order, each bucket with its row offset
    (looked up by the identity of its in_nb tensor)."""
    levels: list[tuple[torch.Tensor, list]] = []
    for f, nb in calls:
        if not levels or levels[-1][0] is not f:
            levels.append((f, []))
        levels[-1][1].append((nb, offsets[id(nb)]))
    return levels


def time_level(fn, f, recs, reps: int) -> tuple[float, torch.Tensor]:
    """Mean ms of one pass of `fn` over a level's buckets (CUDA events
    around `reps` passes after one warm-up), and that pass's output."""
    rows = sum(nb.shape[0] for nb, _ in recs)
    out = torch.empty((rows, f.shape[1]), dtype=torch.int32,
                      device=f.device)

    def one_pass():
        for nb, off in recs:
            fn(f, nb, out=out[off:off + nb.shape[0]])

    one_pass()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        one_pass()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def level_bound_ms(f, recs) -> float:
    """Least time for a level's gathers: the distinct frontier rows
    referenced, the index table and the output rows, over the memory
    rate."""
    width = f.shape[1]
    idx = torch.cat([nb.reshape(-1) for nb, _ in recs])
    distinct = int(torch.unique(idx).numel())
    rows = sum(nb.shape[0] for nb, _ in recs)
    nbytes = distinct * width * 4 + idx.numel() * 4 + rows * width * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def profile_batches(digest, mats, pipe: int, card: str) -> None:
    """Self device time by kernel name over `pipe` batches in flight,
    per batch, and the device's idle share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from dgraph_tpu_torch.bench import bfs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bfs.run(digest, mats, pipe)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memsets, copies): an operator's
    # row repeats the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile over {pipe} batches: device busy {busy_ms / pipe:.3f} "
        f"ms/batch of {wall_ms / pipe:.3f} ms wall, idle share "
        f"{1 - busy_ms / wall_ms:.4f} | {card}")
    for name, ms in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms / pipe:9.3f} ms/batch {ms / busy_ms:7.2%}  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dgraph_tpu_torch import backend
    from dgraph_tpu_torch.bench import bfs
    from dgraph_tpu_torch.ops import _build, kernels
    from dgraph_tpu_torch.ops import bitgraph as bg

    t_start = time.perf_counter()
    dev = backend.default_device()
    card = backend.card_info()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {np.__version__}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_library()
    build_s = time.perf_counter() - t0
    log(f"build: csrc/bucket_or.cu with nvcc (sm_90a) in {build_s:.2f} s")
    for line in _build.build_logs.get("bucket_or", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
    worst = check_kernel_shapes(kernels, dev, card)

    # -- 4. the main path at the reference regime --------------------------
    t0 = time.perf_counter()
    uniq_src, indptr, dst = bfs.make_graph(bfs.N_NODES, bfs.N_EDGES, seed=0)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    badj = bg.build_bitadjacency(bfs.csr_to_dict(uniq_src, indptr, dst),
                                 device=dev)
    core = bg.build_core_adjacency(badj)
    adj_s = time.perf_counter() - t0
    padded = sum(b.in_nb.numel() for b in badj.buckets)
    cpad = sum(b.in_nb.numel() for b in core.buckets)
    log(f"graph: {bfs.N_NODES} nodes, {bfs.N_EDGES} generated edges -> "
        f"{len(uniq_src)} srcs, {len(dst)} edges after dedup "
        f"({graph_s:.1f} s host)")
    log(f"adjacency ({adj_s:.1f} s host): slots={badj.n_slots} "
        f"covered={badj.n_covered} full_padded={padded} "
        f"core_padded={cpad} full_buckets={len(badj.buckets)} "
        f"core_buckets={len(core.buckets)} max_degree="
        f"{max(b.degree for b in badj.buckets)} | {card}")

    batch = bfs.fit_batch(badj, core, bfs.BATCH, dev)
    if batch != bfs.BATCH:
        raise AssertionError(f"batch {bfs.BATCH} does not fit the card's "
                             f"free memory (would halve to {batch})")
    n_mats = 1 + RUNS * bfs.PIPE
    seed_mat = bfs.seed_matrices(uniq_src, n_mats, batch)
    slot_mats = bfs.pack_seed_slots(badj, seed_mat, batch, dev)
    digest = bg.make_bfs_digest_batched(badj, core, bfs.DEPTH, batch,
                                        bfs.SEEDS)
    oracle_counts = [bfs.numpy_bfs(uniq_src, indptr, dst,
                                   np.unique(seed_mat[i]), bfs.DEPTH)
                     for i in range(32)]
    reach_seeds = [np.unique(seed_mat[i]) for i in range(REACH_QUERIES)]
    oracle_levels = [bfs.numpy_bfs_levels(uniq_src, indptr, dst, s,
                                          bfs.DEPTH) for s in reach_seeds]

    # the main path: the digest over every seed matrix
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.bucket_or.launches = 0
    t0 = time.perf_counter()
    sums0_t, col0 = digest(slot_mats[0])
    sums0 = sums0_t.cpu().numpy()
    first_s = time.perf_counter() - t0
    per_batch = kernels.bucket_or.launches
    times, _ = bfs.run(digest, slot_mats[1:], bfs.PIPE)
    torch.cuda.synchronize()
    launches = kernels.bucket_or.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    want_per_batch = len(badj.buckets) + (bfs.DEPTH - 1) * len(core.buckets)
    if per_batch != want_per_batch:
        raise AssertionError(f"{per_batch} launches per batch, expected "
                             f"{want_per_batch}")
    if launches == 0 or launches != n_mats * want_per_batch:
        raise AssertionError(f"the digest launched bucket_or {launches} "
                             f"times over {n_mats} batches, expected "
                             f"{n_mats * want_per_batch}")
    # the per-level reach path, counted on its own
    kernels.bucket_or.launches = 0
    reach = bg.bfs_bits_reach_batched(badj, reach_seeds, bfs.DEPTH)
    torch.cuda.synchronize()
    reach_launches = kernels.bucket_or.launches
    if reach_launches != bfs.DEPTH * len(badj.buckets):
        raise AssertionError(f"bfs_bits_reach_batched launched bucket_or "
                             f"{reach_launches} times, expected "
                             f"{bfs.DEPTH * len(badj.buckets)}")
    batch_ms = sum(times) * 1e3 / (len(times) * bfs.PIPE)
    median_ms = float(np.median(times)) * 1e3 / bfs.PIPE
    log(f"bucket_or launches: digest {per_batch} per batch, {launches} "
        f"over {n_mats} batches ({n_mats} x {per_batch}); "
        f"bfs_bits_reach_batched {reach_launches} "
        f"({bfs.DEPTH} x {len(badj.buckets)}) | {card}")
    log(f"first batch {first_s:.3f} s; sustained {batch_ms:.3f} ms/batch "
        f"({bfs.PIPE} in flight, {len(times) * bfs.PIPE} batches over "
        f"{sum(times):.4f} s; median group {median_ms:.3f} ms/batch, "
        f"group s {[round(t, 4) for t in times]}) for {batch} queries = "
        f"{batch / batch_ms * 1e3:.0f} QPS; peak device memory "
        f"{peak_gb:.2f} GiB | {card}")

    # -- 5. answers --------------------------------------------------------
    calls = []

    def recorded_plain(f, in_nb, out):
        calls.append((f, in_nb))
        return kernels.bucket_or_reference(f, in_nb, out)

    # the same digest with the plain version as its per-bucket step
    plain = bg.make_bfs_digest_batched(badj, core, bfs.DEPTH, batch,
                                       bfs.SEEDS)
    bg.bucket_or = recorded_plain
    try:
        sums_p, col0_p = plain(slot_mats[0])
    finally:
        bg.bucket_or = kernels.bucket_or
    if sums0.shape != (bfs.DEPTH,) or \
            tuple(col0.shape) != (core.n_core + 1, 1):
        raise AssertionError(f"digest shapes {sums0.shape} "
                             f"{tuple(col0.shape)}")
    if not np.array_equal(sums0, sums_p.cpu().numpy()) or \
            not torch.equal(col0, col0_p):
        raise AssertionError(f"digest level sums {sums0.tolist()} != plain "
                             f"{sums_p.cpu().tolist()} or col0 differs")
    log(f"level sums {sums0.tolist()} = plain version on the card; "
        f"TPU record (BENCH_r05.json, informational) {TPU_LEVEL_SUMS} "
        f"{'equal' if sums0.tolist() == TPU_LEVEL_SUMS else 'DIFFERENT'}")
    counts = bg.make_frontier_counts_batched(32)(col0).cpu().tolist()
    if counts != oracle_counts:
        raise AssertionError(f"per-query counts {counts} != numpy_bfs "
                             f"{oracle_counts}")
    for q, want in enumerate(oracle_levels):
        for lvl in range(bfs.DEPTH):
            if not np.array_equal(reach[q][lvl],
                                  want[lvl].astype(np.uint32)):
                raise AssertionError(f"bfs_bits_reach_batched query {q} "
                                     f"level {lvl} != numpy_bfs")
    log(f"answers: counts of queries 0..31 = numpy_bfs {counts[:8]}...; "
        f"per-level uid sets of {REACH_QUERIES} queries = numpy_bfs")

    # -- 6. per-level kernel time, plain time and bound --------------------
    levels = level_records(calls, {id(b.in_nb): b.offset
                                   for b in badj.buckets + core.buckets})
    del calls
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for i, (f, recs) in enumerate(levels):
        k_ms, k_out = time_level(kernels.bucket_or, f, recs, KERNEL_REPS)
        p_ms, p_out = time_level(kernels.bucket_or_reference, f, recs,
                                 PLAIN_REPS)
        err = int((k_out.long() - p_out.long()).abs().max())
        worst = max(worst, err)
        if err:
            raise AssertionError(f"level {i + 1}: kernel != plain version")
        b_ms = level_bound_ms(f, recs)
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["bound_ms"] += b_ms
        log(f"level {i + 1}: {len(recs)} bucket_or launches over "
            f"{f.shape[0]} x {f.shape[1]} words: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms (bytes) | {card}")
        del k_out, p_out

    # -- 7. device time by kernel ------------------------------------------
    profile_batches(digest, slot_mats[1:1 + bfs.PIPE], bfs.PIPE, card)

    log(json.dumps({"kernels": [{
        "name": "bucket_or", "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/bucket_or.cu",
        "replaces": "dgraph_tpu/ops/pallas_kernels.py:38",
        "launches": launches, "max_abs_err": worst,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
