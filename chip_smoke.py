#!/usr/bin/env python3
"""Drive the port's planes once on one NVIDIA H100 and check them.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the port's
kernels from `dgraph_tpu_torch/csrc/` into `build/dgraph_tpu_torch/`.
Phases, each of which fails the run:

1. card: name and power limit (nvidia-smi);
2. build: one nvcc per kernel source, all started together, timed;
3. kernels against their plain PyTorch versions on the card, bit-exact:
   bucket_or over W in {1, 5, 128, 768}, degrees {1, 2, 3, 4, 6}, a hub
   row of degree > 2^20 and padding indices at the dummy row N; the fused
   bucket_or_level (frontier, visited, masks and sum) over W in {1, 5,
   37, 128, 768, 1,100}, frontier densities 0, one bit a row and 1/2
   (and 1/2 with mask bits cleared), the same degrees plus a warp's
   whole chunk (256), split rows of 257 and 3,000 and the hub,
   all-padding rows, visited in place and level 1's seeds with a row
   map, into rows of larger tensors whose other rows must stay
   untouched;
4. the main path at the reference regime (bench.py's shape: 2M nodes,
   21M generated zipf(1.3) edges, B = 24,576 queries of 8 seeds, depth
   3): the digest, every level's buckets through bucket_or_level, with
   the launch counts set to 0 just before and read just after: its
   launches a batch asserted by their formula (one a bucket and level,
   split buckets included) and bucket_or's asserted 0; sustained
   ms per batch with PIPE batches in flight (all batches over all the
   timed wall time); then `bfs_bits_reach_batched`, counted on its own
   the same way (bucket_or, one a bucket and level);
5. answers: the digest's level sums and first-word column against the
   digest run with the plain version on the card; per-query counts of
   queries 0..31 and per-level uid sets of the first REACH_QUERIES
   queries against the numpy oracle;
6. per level, on the digest's own inputs: bucket_or_level's device time
   (CUDA events behind fills that outlast the host's queueing of the
   level's launches) beside the unfused path's (bucket_or and the PyTorch
   epilogue it replaced, composed here only, its answer asserted
   equal), the plain version's time and the bound (bytes over 3.35
   TB/s, counting the non-zero segments the level needs); bucket_or
   alone beside its plain version and its whole-row bound;
7. where a batch's device time goes: torch.profiler over PIPE batches,
   self device time by kernel name and the device's idle share.

The vector search plane (similar_to), at bench_vectors.py's accelerator
regime: 1M x 128 float32, batch 256, k 10, cosine, TF32 off:

8. score_dot and score_int8 against their plain versions on the card,
   element by element within the reordering bound, over b {1, 3, 256,
   257} (257: two query tiles), d {16, 100, 128} x n {1, 777, 65,536,
   1,000,064}, d 37 (rows off 16 bytes) and d 1024 (depth segments) at
   n {777, 65,536}, corpora that start off 16-byte alignment, and int8
   list slices; score_int8_lists against its plain version on
   hand-built tables (empty, a one-row list, m = 1, m = M_TILE + 1,
   lists at both ends of the code block, a mixed batch), and an entry
   of M_TILE + 1 queries refused;
9. the exact and two-stage tiers of `knn.topk_device` over a
   device-resident block: sustained QPS with score_dot's launches set to
   0 just before and asserted after (one per call); the exact top-10
   against the same call with the plain version and, for 16 queries,
   the float64 oracle (rounding flips printed with their gap); two-stage
   recall@10 >= 0.99; `score_dot` alone beside its plain version,
   torch.matmul and its bound;
10. the quantized IVF tier: `ivf.build` (assignment on the card), then
   `ivf.search` at the calibrated nprobe and every frontier budget, each
   search asserted to launch score_int8_lists once, over a table whose
   distinct lists are the search's distinct probed lists; the answer
   against the plain version, recall@10 >= 0.95; the one-launch stage
   of one calibrated batch, device time by CUDA events behind a fill,
   beside its plain version and bound, and its scores against the plain
   version's, score by score within phase 8's bound;
11. torch.profiler over one exact and one quantized batch;
12. the 100k regime, beside BENCH_VECTORS.json's record (informational).

The sorted-UID set-algebra plane (`ops/uidvec`, `ops/codec`,
`ops/setops`, `ops/mergepath`, through `bench/setops.py`):

13. bitmap_and against its plain version on the card, bit for bit, over
   k {1, 2, 3, 4, 8} x B {1, 7, 8, 9, 1,024, 4,096} blocks of 1,024
   words, an odd word count at a misaligned start, and a non-contiguous
   input the wrapper must refuse;
14. UID-intersect GB/s (bench_micro.py's three configs) through the
   batched `uidvec.intersect`, each pair equal to np.intersect1d; both
   membership arms timed; peak device memory;
15. the k-way configs (8 x 65,536, 64 x 8,192, 512 x 1,024) through the
   host folds and `union_many_device` / `intersect_many_device`, all
   equal;
16. the compressed sweep (bench_micro.py's four configs and the
   selective gate, on the host), then setops-and-67M: four seeded
   posting lists over 2^26 uids (densities 1/2, 1/2, 1/4, 1/4), all
   4 x 1,024 blocks bitmaps, through `intersect_packs` with the card as
   its device, bitmap_and's launches set to 0 just before and asserted
   one per call after; the answer against `intersect_many` on the dense
   lists and the host fold; the call's wall time beside the host
   fold's, a host profile of the call, the kernel beside its bound, its
   plain version and torch.bitwise_and (back to back, and alone from a
   flushed L2, by CUDA events), and the device's idle share (profiled,
   and from the call's device work timed part by part);
17. `mergepath_intersect` at the UID-intersect configs, equal to
   `uidvec.intersect` with no overflow at hit_frac=1, in GB/s.

The uid-vector graph-ops plane (`ops/graph`, `ops/traverse`), on the BFS
plane's graph (its CSR and seed sets reused, not drawn again); plain
PyTorch, no kernel of its own:

18. build: `graph.build_adjacency` of the CSR's dict on the card, its
   edge and source counts and degrees against the CSR; host time, the
   adjacency's bytes on the card and max_memory_allocated;
19. `expand` of sorted seeded frontiers of 8, 1,024 and 65,536 sources
   (the largest past a bucket's rows, so the member-mask dual runs),
   each equal to the numpy union of the CSR rows cut to max_expansion;
20. `bfs_reach` at depth 3 from phase 5's first seed sets, level by level
   against numpy_bfs_levels; `make_sssp` from one seed for one round past
   the numpy BFS eccentricity, every source slot's distance equal to its
   hop count (INT32_INF where unreached);
21. `build_values` over all sources with a wide and a 16-value key (LUT
   form) and over every 16th source (search form, asserted); then
   `multisort_page` (one and two keys, asc and desc, cursor and offset),
   `count_filter_sort_page` (a degree band, a kept and an excluded
   cursor), `order_topk` and `range_select` against numpy lexsort and
   masks; `fused_rank_page` with fop "and" over a rank leaf and an
   aligned set leaf, equal to the oracle and to `multisort_page` of the
   filtered candidates on the wide key (asc and desc), and reporting
   sel_count past FUSED_SEL_CAP on the 16-value key.
Each op of phases 19-21 is timed by CUDA events beside its bytes bound.

The engine's write-path plane (`engine/db.GraphDB` over `storage/`,
`cdc/` and `wire/`), on the golden movie graph (tests/golden/dataset.py,
the shape of the reference's systest/21million film graph) at scale 10,
about 267k RDF, plus 262,144 x 128 float32 embeddings (`gen_corpus`,
seed 0):

22. load: `GraphDB(device="cuda:0", plan_cache_size=0, wal_path=...)`
   takes the graph as RDF and the embeddings as JSON, in transactions of
   1,000 N-Quads (the default batch of `dgraph live`), every commit
   framed into the WAL; RDF/s and vectors/s;
23. rollup: `rollup_all(0)` with the launch counts set to 0 just before:
   it trains the embedding predicate's IVF index on the card
   (vecstore.build_ivf -> ivf.build), whose calibration launches
   score_int8_lists once a ladder step, asserted equal to the steps the
   index's nprobe implies, every other kernel 0 times, and no
   `vector_index_build_failed` in the engine's log; host seconds and the
   build's device time (CUDA events around each device step: no
   profiler session spans the rollup, whose long host stretches would
   blind the set-algebra plane's profile); recall@10 >= 0.95 over 256 queries against
   `exact_topk_blocked`, the search equal to the same with the plain
   score_int8_lists; the last calibration launch beside its plain
   version and bound, score by score within phase 8's bound;
24. durability: the engine closed, its WAL replayed into a fresh GraphDB
   on the card and one on the CPU, every predicate's dump_tablet bytes
   equal to the engine's before rollup; `save_snapshot` of the engine
   and `load_snapshot` on the card equal to it after rollup, the index
   included; replay rates;
25. tiles on the card: `device_adjacency` of every uid predicate,
   `device_radjacency` of the @reverse ones, `device_bitadjacency` of
   starring and `device_values` of rating, runtime and
   initial_release_date, each equal to the same tile built on the CPU;
   DeviceCacheLRU's device column equal to the tiles' tensor bytes and
   to the growth of memory_allocated up to 512-byte blocks; under a
   budget of half of it, admitting one more tile evicts the oldest
   tiles and frees their bytes on the card;
26. reads on the card: `GraphDB.bfs` at depth 3 from 64 seed sets on
   starring, genre and director.film, level by level equal to the host
   overlay path; `expand_np` of 8, 1,024 and all sources equal to
   `expand_frontier`; then 10,000 mixed sets and deletes under an open
   transaction: `device_adjacency` None while dirty, and after rollup
   the rebuilt tiles equal the CPU-built and the host reads. Each read
   is timed beside its bytes bound.

The planes run in the order BFS, graph ops, write path, set algebra,
vectors. Each
figure is printed beside the card's name and power limit. Then one
JSON line of kernels, the card's line, and last `{"ok": true, "device":
{...}}`. Exits non-zero, printing no result, without a card or without
the rest of the repo.
"""

from __future__ import annotations

import json
import math
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
FP32_FLOPS = 67e12                 # H100 SXM data sheet, outside tensor cores
RUNS = 4                           # timed groups of PIPE batches
# bucket_or_level's checks: partial segments (5, 37), and 1,100 words,
# whose segments widen to 64 words
LEVEL_WIDTHS = (1, 5, 37, 128, 768, 1100)
REACH_QUERIES = 48
KERNEL_REPS = 10
PLAIN_REPS = 2
# the vector plane's regime (bench_vectors.py's on an accelerator)
VEC_N = 1_000_000
VEC_D = 128
VEC_BATCH = 256
VEC_K = 10
VEC_METRIC = "cosine"
ORACLE_QUERIES = 16
SMALL_N = 100_000                  # bench_vectors.py always runs it
# corpus rows of the score kernels' checks; 1,000,064 is the 1M corpus
# padded to the two-stage bucket
SCORE_CHECK_ROWS = (1, 777, 65_536, 1_000_064)
# (d, n) of the checks: d 37 has rows off 16 bytes, d 1024 takes the
# query tile in depth segments
SCORE_CHECK_SHAPES = [(d, n) for d in (16, 100, 128)
                      for n in SCORE_CHECK_ROWS] + \
    [(d, n) for d in (37, 1024) for n in (777, 65_536)]
# 257 queries take two query tiles of score_dot
SCORE_CHECK_BATCHES = (1, 3, 256, 257)
# BENCH_VECTORS.json's 100k regime (a CPU run of the JAX package, same
# generator seeds): informational only
BENCH_VECTORS_100K = {"nlist": 256, "nprobe": 4, "sampleRecall": 1.0,
                      "two_stage_recall_at_k": 1.0}
# the set-algebra plane: timed device calls per UID-intersect config, and
# timed intersect_packs calls of setops-and-67M on each route
SET_RUNS = 5
AND_RUNS = 3
# the quantized tier's approximate stage of one calibrated batch when it
# was one score_int8 launch a probed list (444 launches, CUDA events
# around the loop; NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table)
PER_LIST_LOOP_MS = 7.423
# fills of a 512 MiB buffer queued before each cold timing: they flush
# the L2 and outlast the host work of the slowest timed wrapper
# (score_int8_lists builds and pins its table before it launches)
COLD_FILLS = 4


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


def level_frontier(rows: int, width: int, density: str, gen, dev,
                   word_bits: np.ndarray):
    """A frontier int32 [rows+1, W] with the dummy row zero: all zero,
    about one bit a row, or every bit set with probability 1/2."""
    if density == "1/2":
        f = torch.randint(-2**31, 2**31, (rows + 1, width), dtype=torch.int32,
                          device=dev, generator=gen)
    else:
        f = torch.zeros((rows + 1, width), dtype=torch.int32, device=dev)
        if density == "1 bit a row":
            col = torch.randint(0, 32 * width, (rows,), device=dev,
                                generator=gen)
            bits = torch.from_numpy(word_bits).to(dev)
            f[torch.arange(rows, device=dev), col // 32] = bits[col % 32]
    f[rows] = 0
    return f


def check_level_shapes(kernels, dev, card: str) -> int:
    """Phase 3, second half: bucket_or_level against its plain version on
    the card, bit for bit (frontier, visited, masks and the sum), in both
    modes (visited in place; level 1's seeds with a row map), writing
    into rows of larger tensors whose other rows must stay untouched.
    Returns the largest count of differing words (0, or it raises)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 40_000
    cases = [(20_000, d) for d in (1, 2, 3, 4, 6)]
    # a warp's whole chunk, the first split degree, split rows, a hub
    cases += [(40, kernels.LEVEL_CHUNK), (9, kernels.LEVEL_CHUNK + 1),
              (3, 3_000), (1, (1 << 20) + 24)]
    densities = ("0", "1 bit a row", "1/2", "1/2, mask bits cleared")
    checked = 0
    for width in LEVEL_WIDTHS:
        for density in densities:
            f = level_frontier(n, width, density.split(",")[0], gen, dev,
                               kernels.WORD_BITS)
            mask = kernels.segment_masks(f)
            if "cleared" in density:                 # masks honoured
                mask &= torch.randint(-2**31, 2**31, mask.shape,
                                      dtype=torch.int32, device=dev,
                                      generator=gen)
            for m, d in cases:
                nb = torch.randint(0, n + 1, (m, d), dtype=torch.int32,
                                   device=dev, generator=gen)
                nb.view(-1)[::5] = n                 # padding entries
                if m > 7:
                    nb[1::7] = n                     # all-padding rows
                for row_map in (False, True):
                    check_level_case(kernels, f, mask, nb, row_map, gen,
                                     f"W={width} density {density} M={m} "
                                     f"D={d} row map {row_map}")
                    checked += 1
            del f, mask
    log(f"kernel check: bucket_or_level bit-exact to its plain version "
        f"(frontier, visited, masks, sum) on {checked} cases: W "
        f"{list(LEVEL_WIDTHS)} x densities {list(densities)} x "
        f"{len(cases)} shapes (D={kernels.LEVEL_CHUNK} unsplit, split "
        f"D={kernels.LEVEL_CHUNK + 1} and 3,000, hub D=2^20+24, all-padding "
        f"rows) x (visited in place, level-1 seeds with a row map), into "
        f"rows of larger tensors with the rest kept | {card}")
    return 0


def check_level_case(kernels, f, mask, nb, row_map: bool, gen,
                     label: str) -> None:
    """One bucket_or_level call against its plain version on copies of
    the same output tensors; raises on any difference."""
    dev = f.device
    m, width = nb.shape[0], f.shape[1]
    n_out = m + 2

    def rand_words(rows):
        return torch.randint(-2**31, 2**31, (rows, width), dtype=torch.int32,
                             device=dev, generator=gen)

    outs = [torch.full((n_out, width), 7, dtype=torch.int32, device=dev),
            rand_words(n_out),
            torch.full((n_out,), 7, dtype=torch.int32, device=dev),
            torch.full((1,), 5, dtype=torch.int64, device=dev)]
    if row_map:
        seeds = rand_words(m) & rand_words(m)        # density 1/4
        kw = dict(seeds=seeds, seeds_mask=kernels.segment_masks(seeds),
                  rows=torch.randperm(n_out, device=dev, generator=gen)[:m]
                  .to(torch.int32))
    else:
        kw = {}
    want = [t.clone() for t in outs]

    def call(fn, fr, vis, om, tot):
        if row_map:
            fn(f, mask, nb, fr, vis, om, tot, **kw)
        else:
            fn(f, mask, nb, fr[1:m + 1], vis[1:m + 1], om[1:m + 1], tot)

    call(kernels.bucket_or_level, *outs)
    call(kernels.bucket_or_level_reference, *want)
    torch.cuda.synchronize()
    for got, ref, what in zip(outs, want, ("frontier", "visited", "masks",
                                          "sum")):
        if not torch.equal(got, ref):
            raise AssertionError(f"bucket_or_level != plain version: "
                                 f"{what} at {label}")


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


def profile_window(run, batches: int, unit: str, card: str) -> None:
    """Self device time by kernel name over one call of `run`, which
    answers `batches` batches, per batch, and the device's idle share of
    the window's wall time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # one traced warm-up step first: a later profiler session in the
    # same process loses the first kernels it traces
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # device-side events only (kernels, memsets, copies): an operator's
    # row repeats the time of the kernels it launched, and the step's
    # own row spans the whole step
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in traced[-1]
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile over {batches} {unit}: device busy "
        f"{busy_ms / batches:.3f} ms/batch of {wall_ms / batches:.3f} ms "
        f"wall, idle share {1 - busy_ms / wall_ms:.4f} | {card}")
    for name, ms in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms / batches:9.3f} ms/batch {ms / busy_ms:7.2%}  "
            f"{name[:90]}")


def build_kernels(_build, names: list[str]) -> None:
    """Phase 2: one nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    _build.build_all(names)
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'csrc/{n}.cu' for n in names)} with nvcc "
        f"(sm_90a), in parallel, in {build_s:.2f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                log(f"  ptxas {name}: {line.strip()}")


def fused_level_bound_ms(kernels, lv, out_mask) -> float:
    """Least time for one fused level (bucket_or_level's bound): bytes
    over the memory rate of the index table, the masks of the distinct
    rows it references, their non-zero segments once each, the frontier
    and its masks written in full, and visited: at level 1 the seeds'
    non-zero segments read and visited written in full, deeper its
    segments read and written where the new frontier is non-zero. It
    counts segments, not whole rows, so it is not `level_bound_ms`."""
    f, mask = lv["f"], lv["mask"]
    width = f.shape[1]
    rows = out_mask.shape[0] - 1
    seg = kernels.segment_words(width)
    nseg = -(-width // seg)
    seg_bytes = torch.tensor([4 * (min(width, (s + 1) * seg) - s * seg)
                              for s in range(nseg)], dtype=torch.int64,
                             device=f.device)
    shifts = torch.arange(nseg, dtype=torch.int32, device=f.device)

    def nz_bytes(masks):
        bits = ((masks[:, None] >> shifts) & 1).to(torch.int64)
        return int((bits * seg_bytes).sum())

    idx = torch.cat([c["in_nb"].reshape(-1) for c in lv["calls"]])
    distinct = torch.unique(idx).long()
    nbytes = 4 * idx.numel() + 4 * distinct.numel() + \
        nz_bytes(mask[distinct]) + 4 * rows * (width + 1)
    if lv["level1"]:
        seeds_mask = torch.cat([c["kw"]["seeds_mask"] for c in lv["calls"]])
        nbytes += nz_bytes(seeds_mask) + 4 * rows * width
    else:
        nbytes += 2 * nz_bytes(out_mask[:rows])
    return nbytes / HBM_BYTES_PER_S * 1e3


def digest_levels(calls, offsets: dict[int, int], n_rows: int):
    """Group the recorded bucket_or_level calls of a digest into levels,
    one per frontier tensor in call order, each call with its bucket's
    row offset (by the identity of its in_nb tensor); a deeper level
    gets its visited rows before the level (`vis0`) from the calls'
    snapshots."""
    levels = []
    for c in calls:
        if not levels or levels[-1]["f"] is not c["f"]:
            levels.append({"f": c["f"], "mask": c["mask"], "calls": [],
                           "level1": c["kw"].get("seeds") is not None})
        c["offset"] = offsets[id(c["in_nb"])]
        levels[-1]["calls"].append(c)
    for lv in levels:
        if lv["level1"]:
            continue
        width = lv["f"].shape[1]
        vis0 = torch.empty((n_rows + 1, width), dtype=torch.int32,
                           device=lv["f"].device)
        vis0[n_rows] = 0
        for c in lv["calls"]:
            vis0[c["offset"]:c["offset"] + c["in_nb"].shape[0]] = \
                c.pop("vis0")
        lv["vis0"] = vis0
    return levels


def timed_passes(one_pass, reset, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of `one_pass` over `reps` passes after one warm-up:
    CUDA events right around each pass, queued behind `reset` (which
    restores its inputs) and fills of `flush` (larger than the L2) that
    keep the card busy while the host queues the pass: COLD_FILLS, and
    for a pass of many launches one more for each 0.1 ms the host took
    to queue the warm-up pass, twice over (a fill takes about 0.16 ms),
    so the events time the card and not the host."""
    pairs = []
    lead = COLD_FILLS
    for r in range(reps + 1):
        reset()
        for _ in range(lead):
            flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        one_pass()
        host_s = time.perf_counter() - t0
        end.record()
        if r:
            pairs.append((start, end))
        else:
            lead = COLD_FILLS + math.ceil(2 * host_s / 1e-4)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def time_fused_level(fn, lv, n_rows: int, reps: int, flush):
    """Device ms of one pass of `fn` (bucket_or_level or its plain
    version) over a level's buckets as the digest calls them, into fresh
    core-space outputs, visited restored before each pass; and the
    pass's (frontier, visited, masks, sum)."""
    f, mask = lv["f"], lv["mask"]
    dev, width = f.device, f.shape[1]
    fr = torch.zeros((n_rows + 1, width), dtype=torch.int32, device=dev)
    vis = torch.zeros_like(fr)
    om = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    tot = torch.zeros(1, dtype=torch.int64, device=dev)

    def reset():
        if not lv["level1"]:
            vis.copy_(lv["vis0"])
        tot.zero_()

    def one_pass():
        for c in lv["calls"]:
            if lv["level1"]:
                fn(f, mask, c["in_nb"], fr, vis, om, tot, **c["kw"])
            else:
                sl = slice(c["offset"], c["offset"] + c["in_nb"].shape[0])
                fn(f, mask, c["in_nb"], fr[sl], vis[sl], om[sl], tot)

    return timed_passes(one_pass, reset, reps, flush), (fr, vis, om, tot)


def unfused_level(kernels, lv, buckets, row_slots, vis):
    """The level as the digest ran it before the fused kernel (the
    unfused path), composed here only as the fused level's yardstick:
    bucket_or over the buckets, then PyTorch's and-not, or and SWAR
    popcount, and
    at level 1 the boundary permutation into core row order. `vis` is
    the visited rows before a deeper level, updated in place. Returns
    (frontier, visited, sum)."""
    f = lv["f"]
    dev, width = f.device, f.shape[1]
    ncov = row_slots.numel()
    if lv["level1"]:
        reach1 = torch.empty((ncov, width), dtype=torch.int32, device=dev)
        for b in buckets:
            kernels.bucket_or(f, b.in_nb,
                              out=reach1[b.offset:b.offset + b.in_nb.shape[0]])
        seeds_core = f[:ncov]
        new = reach1.bitwise_and_(~seeds_core)
        total = kernels.popcount_sum(new)
        vis_s = seeds_core | new
        rows = row_slots.long()
        zrow = torch.zeros((1, width), dtype=torch.int32, device=dev)
        return (torch.cat([new[rows], zrow]), torch.cat([vis_s[rows], zrow]),
                total)
    reach = torch.empty((ncov + 1, width), dtype=torch.int32, device=dev)
    reach[ncov] = 0
    for b in buckets:
        kernels.bucket_or(f, b.in_nb,
                          out=reach[b.offset:b.offset + b.in_nb.shape[0]])
    frontier = reach.bitwise_and_(~vis)
    vis |= frontier
    return frontier, vis, kernels.popcount_sum(frontier)


def bfs_plane(dev, card: str) -> list[dict]:
    """Phases 3-7: the batched BFS traversal plane. Returns the kernels
    line's entries of bucket_or and bucket_or_level."""
    from dgraph_tpu_torch.bench import bfs
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.ops import bitgraph as bg

    # -- 3. kernels against their plain versions ---------------------------
    worst = check_kernel_shapes(kernels, dev, card)
    worst_level = check_level_shapes(kernels, dev, card)

    # -- 4. the main path at the reference regime --------------------------
    t0 = time.perf_counter()
    uniq_src, indptr, dst = bfs.make_graph(bfs.N_NODES, bfs.N_EDGES, seed=0)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    edges = bfs.csr_to_dict(uniq_src, indptr, dst)
    badj = bg.build_bitadjacency(edges, device=dev)
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
    GRAPH.update(csr=(uniq_src, indptr, dst), edges=edges,
                 reach=(reach_seeds[:GRAPH_REACH_SETS],
                        oracle_levels[:GRAPH_REACH_SETS]))
    del edges

    # the main path: the digest over every seed matrix
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.bucket_or.launches = 0
    kernels.bucket_or_level.launches = 0
    t0 = time.perf_counter()
    sums0_t, col0 = digest(slot_mats[0])
    sums0 = sums0_t.cpu().numpy()
    first_s = time.perf_counter() - t0
    per_batch = kernels.bucket_or_level.launches
    times, _ = bfs.run(digest, slot_mats[1:], bfs.PIPE)
    torch.cuda.synchronize()
    launches = kernels.bucket_or_level.launches
    digest_or = kernels.bucket_or.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    # one launch a bucket and level, split buckets included
    full_l, core_l = len(badj.buckets), len(core.buckets)
    want_per_batch = full_l + (bfs.DEPTH - 1) * core_l
    if per_batch != want_per_batch:
        raise AssertionError(f"{per_batch} bucket_or_level launches per "
                             f"batch, expected {want_per_batch}")
    if launches == 0 or launches != n_mats * want_per_batch:
        raise AssertionError(f"the digest launched bucket_or_level "
                             f"{launches} times over {n_mats} batches, "
                             f"expected {n_mats * want_per_batch}")
    if digest_or != 0:
        raise AssertionError(f"the digest launched bucket_or {digest_or} "
                             f"times, expected 0")
    # the per-level reach path, counted on its own
    kernels.bucket_or.launches = 0
    kernels.bucket_or_level.launches = 0
    reach = bg.bfs_bits_reach_batched(badj, reach_seeds, bfs.DEPTH)
    torch.cuda.synchronize()
    reach_launches = kernels.bucket_or.launches
    if reach_launches != bfs.DEPTH * len(badj.buckets) or \
            kernels.bucket_or_level.launches:
        raise AssertionError(f"bfs_bits_reach_batched launched bucket_or "
                             f"{reach_launches} times, expected "
                             f"{bfs.DEPTH * len(badj.buckets)}, and "
                             f"bucket_or_level "
                             f"{kernels.bucket_or_level.launches} times")
    batch_ms = sum(times) * 1e3 / (len(times) * bfs.PIPE)
    median_ms = float(np.median(times)) * 1e3 / bfs.PIPE
    n_split = sum(b.degree > kernels.LEVEL_CHUNK
                  for b in badj.buckets + core.buckets)
    log(f"bucket_or_level launches: digest {per_batch} per batch ({full_l} "
        f"buckets at level 1 + {bfs.DEPTH - 1} x {core_l} core buckets, one "
        f"a bucket; {n_split} of the {full_l + core_l} split across warps), "
        f"{launches} over {n_mats} batches; the digest launched "
        f"bucket_or {digest_or} times; bfs_bits_reach_batched launched "
        f"bucket_or {reach_launches} times ({bfs.DEPTH} x "
        f"{len(badj.buckets)}) | {card}")
    log(f"first batch {first_s:.3f} s; sustained {batch_ms:.3f} ms/batch "
        f"({bfs.PIPE} in flight, {len(times) * bfs.PIPE} batches over "
        f"{sum(times):.4f} s; median group {median_ms:.3f} ms/batch, "
        f"group s {[round(t, 4) for t in times]}) for {batch} queries = "
        f"{batch / batch_ms * 1e3:.0f} QPS; peak device memory "
        f"{peak_gb:.2f} GiB | {card}")

    # -- 5. answers --------------------------------------------------------
    calls = []

    def recorded_plain(f, mask, in_nb, frontier, visited, out_mask, total,
                       **kw):
        c = {"f": f, "mask": mask, "in_nb": in_nb, "kw": kw}
        if kw.get("seeds") is None:
            c["vis0"] = visited.clone()      # updated in place below
        calls.append(c)
        kernels.bucket_or_level_reference(f, mask, in_nb, frontier, visited,
                                          out_mask, total, **kw)

    # the same digest with the plain version as its per-bucket step
    plain = bg.make_bfs_digest_batched(badj, core, bfs.DEPTH, batch,
                                       bfs.SEEDS)
    bg.bucket_or_level = recorded_plain
    try:
        sums_p, col0_p = plain(slot_mats[0])
    finally:
        bg.bucket_or_level = kernels.bucket_or_level
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
    del plain, sums_p, col0_p

    # -- 6. per level: the fused kernel, the unfused path, plain, bounds ------
    levels = digest_levels(calls, {id(b.in_nb): b.offset
                                   for b in badj.buckets + core.buckets},
                           core.n_core)
    del calls
    ncov = core.n_core
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    tot = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms", "unfused_ms",
                            "or_ms", "or_plain_ms", "or_bound_ms")}
    for i, lv in enumerate(levels):
        f = lv["f"]
        buckets = badj.buckets if lv["level1"] else core.buckets
        k_ms, (fr, vis, om, k_sum) = time_fused_level(
            kernels.bucket_or_level, lv, ncov, KERNEL_REPS, flush)
        p_ms, p_out = time_fused_level(kernels.bucket_or_level_reference,
                                       lv, ncov, PLAIN_REPS, flush)
        for got, want, what in zip((fr, vis, om, k_sum), p_out,
                                   ("frontier", "visited", "masks", "sum")):
            if not torch.equal(got, want):
                raise AssertionError(f"level {i + 1}: bucket_or_level != "
                                     f"plain version ({what})")
        del p_out
        # the unfused path on the same inputs, and its answer
        vis_u = None if lv["level1"] else torch.empty_like(lv["vis0"])
        out_u = {}

        def reset_u():
            if vis_u is not None:
                vis_u.copy_(lv["vis0"])

        def run_u():
            out_u["res"] = unfused_level(kernels, lv, buckets,
                                         core.row_slots, vis_u)

        unfused_ms = timed_passes(run_u, reset_u, KERNEL_REPS, flush)
        fr_u, vis_u_out, sum_u = out_u.pop("res")
        if not (torch.equal(fr_u, fr) and torch.equal(vis_u_out, vis) and
                int(sum_u) == int(k_sum)):
            raise AssertionError(f"level {i + 1}: the fused level != the "
                                 f"unfused path")
        del fr_u, vis_u_out, vis_u
        # bucket_or alone over the level (the unfused path's kernel)
        recs = [(b.in_nb, b.offset) for b in buckets]
        b_ms, b_out = time_level(kernels.bucket_or, f, recs, KERNEL_REPS)
        bp_ms, bp_out = time_level(kernels.bucket_or_reference, f, recs,
                                   PLAIN_REPS)
        err = int((b_out != bp_out).sum())
        worst = max(worst, err)
        if err:
            raise AssertionError(f"level {i + 1}: bucket_or != plain version")
        del b_out, bp_out
        b_bound = level_bound_ms(f, recs)
        n_bound = fused_level_bound_ms(kernels, lv, om)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", n_bound),
                       ("unfused_ms", unfused_ms), ("or_ms", b_ms),
                       ("or_plain_ms", bp_ms), ("or_bound_ms", b_bound)):
            tot[key] += v
        log(f"level {i + 1}: {len(lv['calls'])} buckets over {f.shape[0]} x "
            f"{f.shape[1]} words, sum {int(k_sum)}: bucket_or_level "
            f"{k_ms:.4f} ms, unfused path (bucket_or + PyTorch epilogue) "
            f"{unfused_ms:.4f} ms of which bucket_or {b_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {n_bound:.4f} ms (bytes; bucket_or's "
            f"whole-row bound {b_bound:.4f} ms, its plain version "
            f"{bp_ms:.4f} ms) | {card}")
        del fr, vis, om
    log(f"levels 1-{len(levels)}: bucket_or_level {tot['ms']:.4f} ms, "
        f"unfused path {tot['unfused_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms | {card}")
    del levels, flush
    torch.cuda.empty_cache()

    # -- 7. device time by kernel ------------------------------------------
    profile_window(lambda: bfs.run(digest, slot_mats[1:1 + bfs.PIPE],
                                   bfs.PIPE),
                   bfs.PIPE, "batches", card)

    return [{"name": "bucket_or", "route": "cuda",
             "source": "dgraph_tpu_torch/csrc/bucket_or.cu",
             "replaces": "dgraph_tpu/ops/pallas_kernels.py:38",
             "launches": reach_launches, "max_abs_err": worst,
             "ms": tot["or_ms"], "plain_ms": tot["or_plain_ms"],
             "bound_ms": tot["or_bound_ms"], "bound_by": "bytes",
             "library_ms": None},
            {"name": "bucket_or_level", "route": "cuda",
             "source": "dgraph_tpu_torch/csrc/bucket_or.cu",
             "replaces": "dgraph_tpu/ops/pallas_kernels.py:38",
             "launches": launches, "max_abs_err": worst_level,
             "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"], "bound_by": "bytes",
             "library_ms": None}]


# -- the uid-vector graph-ops plane (phases 18-21) --------------------------

# the BFS plane's graph, kept for the graph-ops plane: the CSR, its dict
# form, and the first seed sets of phase 5 with their numpy_bfs_levels
GRAPH: dict = {}
GRAPH_REACH_SETS = 3
EXPAND_FRONTIERS = (8, 1024, 65_536)
GRAPH_REPS = 5
PAGE_WINDOW = 64
SPARSE_EVERY = 16
RANK_MISSING = 2**31 - 1
UID_PAD = 0xFFFFFFFF


def bfs_graph(bfs) -> dict:
    """The BFS plane's graph and reach answers, or fresh ones when that
    plane did not run in this process."""
    if not GRAPH:
        csr = bfs.make_graph(bfs.N_NODES, bfs.N_EDGES, seed=0)
        seed_mat = bfs.seed_matrices(csr[0], 1, GRAPH_REACH_SETS)
        seeds = [np.unique(s) for s in seed_mat]
        GRAPH.update(csr=csr, edges=bfs.csr_to_dict(*csr), reach=(
            seeds, [bfs.numpy_bfs_levels(*csr, s, bfs.DEPTH)
                    for s in seeds]))
    return GRAPH


def csr_union(csr, uids: np.ndarray, sorted_unique) -> np.ndarray:
    """The numpy oracle of one expansion: the sorted union of the CSR rows
    of `uids` (uint64)."""
    uniq_src, indptr, dst = csr
    idx = np.clip(np.searchsorted(uniq_src, uids), 0, len(uniq_src) - 1)
    rows = idx[uniq_src[idx] == uids]
    starts, lens = indptr[rows], indptr[rows + 1] - indptr[rows]
    total = int(lens.sum())
    if not total:
        return np.empty(0, np.uint64)
    offs = np.repeat(starts - (np.cumsum(lens) - lens), lens) + \
        np.arange(total)
    return sorted_unique(dst[offs])


def hop_distances(csr, seed: int, n_nodes: int, sorted_unique):
    """Hop distance of every uid 1..n_nodes from `seed` (RANK_MISSING's
    value, INT32_INF, where unreached) and the eccentricity, by numpy
    BFS levels over the CSR."""
    dist = np.full(n_nodes + 1, RANK_MISSING, np.int64)
    dist[seed] = 0
    frontier, d = np.asarray([seed], np.uint64), 0
    while len(frontier):
        nxt = csr_union(csr, frontier, sorted_unique)
        nxt = nxt[dist[nxt] == RANK_MISSING]
        if len(nxt):
            d += 1
            dist[nxt] = d
        frontier = nxt
    return dist, d


def oracle_stream(uids: np.ndarray, cols: list[np.ndarray]) -> np.ndarray:
    """numpy lexsort of candidates by (cols..., uid)."""
    return uids[np.lexsort((uids,) + tuple(reversed(cols)))]


def oracle_page(stream, after: int, offset: int, window: int, limit=None):
    """The page `window` long after the cursor and the offset, and its
    unclamped start, as the page ops define them."""
    hits = np.flatnonzero(stream == after)
    found = len(hits) > 0 and (limit is None or hits[0] < limit)
    start = (int(hits[0]) + 1 if found else 0) + offset
    s = min(max(start, 0), len(stream))
    ext = np.concatenate([stream, np.full(window, UID_PAD, np.int64)])
    return ext[s: s + window], start


def rank_col(ranks: np.ndarray, desc: bool) -> np.ndarray:
    """A rank column as the order ops key it: negated for desc, missing
    values last either way."""
    if not desc:
        return ranks
    return np.where(ranks == RANK_MISSING, ranks, -ranks)


def same_packed(label: str, got: torch.Tensor, want) -> None:
    got = got.cpu().numpy()
    want = np.asarray(want, np.int64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)[:4] if got.shape == want.shape \
            else "shape"
        raise AssertionError(f"{label}: != numpy oracle (first differing "
                             f"slots {bad})")


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def graph_plane(dev, card: str) -> None:
    """Phases 18-21: the uid-vector graph ops (`ops/graph`,
    `ops/traverse`) on the BFS plane's graph."""
    from dgraph_tpu_torch.bench import bfs
    from dgraph_tpu_torch.bench.setops import sorted_unique
    from dgraph_tpu_torch.ops import graph, traverse
    from dgraph_tpu_torch.ops.uidvec import from_numpy, pad_to, to_numpy

    g = bfs_graph(bfs)
    csr = g["csr"]
    uniq_src, indptr, dst = csr

    # -- 18. build ---------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    adj = graph.build_adjacency(g["edges"], device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if adj.n_edges != len(dst) or adj.n_src != len(uniq_src):
        raise AssertionError(f"adjacency holds {adj.n_edges} edges of "
                             f"{adj.n_src} sources, the CSR {len(dst)} of "
                             f"{len(uniq_src)}")
    n = adj.n_src
    if not np.array_equal(adj.degrees[:n].cpu().numpy(), np.diff(indptr)):
        raise AssertionError("adjacency degrees != the CSR's row lengths")
    tiles = [adj.src_uids, adj.degrees] + \
        [t for b in adj.buckets for t in (b.src, b.neighbors)]
    adj_gib = sum(t.numel() * t.element_size() for t in tiles) / 2**30
    slots = sum(b.neighbors.numel() for b in adj.buckets)
    log(f"graph ops, build: build_adjacency {build_s:.3f} s on the host "
        f"for {n} sources, {adj.n_edges} edges (= the CSR), {adj.n_dst} "
        f"distinct destinations; {len(adj.buckets)} buckets of degrees "
        f"{[b.degree for b in adj.buckets]}, {slots} padded slots; "
        f"adjacency {adj_gib:.3f} GiB on the card, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB | {card}")

    # -- 19. expand --------------------------------------------------------
    rng = np.random.default_rng(19)
    mask_duals = 0
    for f_n in EXPAND_FRONTIERS:
        fr = np.sort(rng.choice(uniq_src, f_n, replace=False))
        size = pad_to(f_n)
        frontier = from_numpy(fr.astype(np.uint32), size, device=dev)
        out = graph.max_expansion(adj, size)
        got = to_numpy(graph.expand(adj, frontier, out))
        want = csr_union(csr, fr, sorted_unique)
        if not np.array_equal(got, want[:out].astype(np.uint32)):
            raise AssertionError(f"expand of {f_n} sources != the numpy "
                                 f"union of their CSR rows")
        duals = sum(size > b.src.shape[0] for b in adj.buckets)
        mask_duals += duals
        gathered = sum(min(b.src.shape[0], size) * b.degree
                       for b in adj.buckets)
        ms = cuda_ms(lambda: graph.expand(adj, frontier, out), GRAPH_REPS)
        b_ms = bound_ms((3 * gathered + size + out) * 8)
        log(f"expand {f_n} sources: {len(got)} uids (union {len(want)}, "
            f"out size {out}) = numpy union; {duals} of "
            f"{len(adj.buckets)} buckets take the member-mask dual; "
            f"{ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms (bytes: "
            f"{gathered} gathered slots read, written and read as flat "
            f"candidates, 8 B each, frontier and output once) | {card}")
    if not mask_duals:
        raise AssertionError("no frontier ran expand's member-mask dual")

    # -- 20. traverse ------------------------------------------------------
    seeds, want_levels = g["reach"]
    for q, (s, want) in enumerate(zip(seeds, want_levels)):
        got = traverse.bfs_reach(adj, s.astype(np.uint32), bfs.DEPTH)
        for lvl in range(bfs.DEPTH):
            if not np.array_equal(got[lvl], want[lvl].astype(np.uint32)):
                raise AssertionError(f"bfs_reach seed set {q} level "
                                     f"{lvl + 1} != numpy_bfs_levels")
    size = pad_to(len(seeds[0]))
    fn = traverse.make_bfs(adj, size, bfs.DEPTH)
    sv = from_numpy(seeds[0].astype(np.uint32), size, device=dev)
    bfs_ms = cuda_ms(lambda: fn(sv), GRAPH_REPS)
    sizes = [size]
    for _ in range(bfs.DEPTH):
        sizes.append(graph.max_expansion(adj, sizes[-1]))
    bfs_bytes = sum((3 * sum(min(b.src.shape[0], f) * b.degree
                             for b in adj.buckets) + f + o) * 8
                    for f, o in zip(sizes[:-1], sizes[1:]))
    log(f"bfs_reach depth {bfs.DEPTH}: {len(seeds)} seed sets of 8, every "
        f"level = numpy_bfs_levels (sizes {[len(x) for x in want_levels[0]]} "
        f"for set 0, padded {sizes[1:]}); make_bfs {bfs_ms:.4f} ms a call "
        f"(CUDA events), bound {bound_ms(bfs_bytes):.4f} ms (bytes: each "
        f"level's expand as in phase 19, the dedup not counted) | {card}")

    seed = int(uniq_src[rng.integers(len(uniq_src))])
    hops, ecc = hop_distances(csr, seed, bfs.N_NODES, sorted_unique)
    iters = ecc + 1
    sssp = traverse.make_sssp(adj, iters)
    s1 = from_numpy(np.asarray([seed], np.uint32), 8, device=dev)
    src_t, dist_t = sssp(s1)
    src_np, dist_np = src_t.cpu().numpy(), dist_t.cpu().numpy()
    real = src_np != UID_PAD
    if not np.array_equal(dist_np[real], hops[src_np[real]]) or \
            not (dist_np[~real] == RANK_MISSING).all():
        raise AssertionError("make_sssp distances != numpy BFS hop counts")
    sssp_ms = cuda_ms(lambda: sssp(s1), 2)
    reached = int((dist_np[real] < RANK_MISSING).sum())
    log(f"make_sssp from uid {seed}: {iters} rounds (eccentricity {ecc}); "
        f"{reached} of {n} source slots reached, every distance = numpy "
        f"BFS hops, the rest INT32_INF; {sssp_ms:.4f} ms a call (CUDA "
        f"events), bound {bound_ms(iters * slots * 12):.4f} ms (bytes: per "
        f"round each padded slot's target index and candidate distance, 12 "
        f"B) | {card}")
    del sssp, src_t, dist_t

    # -- 21. values and pages ----------------------------------------------
    uids = uniq_src.astype(np.int64)
    k_wide = rng.integers(0, 1 << 40, n)
    k16 = rng.integers(0, 16, n)
    sparse = np.arange(0, n, SPARSE_EVERY)
    t0 = time.perf_counter()
    dv_wide = graph.build_values(dict(zip(uids.tolist(), k_wide.tolist())),
                                 device=dev)
    dv16 = graph.build_values(dict(zip(uids.tolist(), k16.tolist())),
                              device=dev)
    dv_sp = graph.build_values(dict(zip(uids[sparse].tolist(),
                                        k_wide[sparse].tolist())), device=dev)
    values_s = time.perf_counter() - t0
    forms = [graph.dv_view(dv)[1] for dv in (dv_wide, dv16, dv_sp)]
    if forms != [True, True, False]:
        raise AssertionError(f"value tables took forms {forms} (LUT?), "
                             f"expected LUT, LUT, search")

    def ranks_of(keys):
        return np.searchsorted(sorted_unique(keys), keys).astype(np.int64)

    n_pad = adj.src_uids.shape[0]
    pad = np.full(n_pad - n, RANK_MISSING, np.int64)
    r_wide = np.concatenate([ranks_of(k_wide), pad])
    r16 = np.concatenate([ranks_of(k16), pad])
    r_sp = np.full(n_pad, RANK_MISSING, np.int64)
    r_sp[sparse] = ranks_of(k_wide[sparse])
    cand_np = np.concatenate([uids, np.full(n_pad - n, UID_PAD, np.int64)])
    cand = adj.src_uids
    tables = {"wide": (dv_wide, r_wide), "k16": (dv16, r16),
              "sparse": (dv_sp, r_sp)}
    log(f"values: build_values {values_s:.3f} s on the host for three "
        f"tables: k_wide ({len(dv_wide.host_keys)} keys) and k16 "
        f"({len(dv16.host_keys)}) over {n} sources in the LUT form, every "
        f"{SPARSE_EVERY}th source ({dv_sp.n}) in the search form | {card}")
    window = PAGE_WINDOW

    def page_case(label, names, descs, after, offset):
        dvs = [tables[k][0] for k in names]
        cols = [rank_col(tables[k][1], d) for k, d in zip(names, descs)]
        stream = oracle_stream(cand_np, cols)
        page, start = oracle_page(stream, after, offset, window)
        args = (cand, tuple(dv.uids for dv in dvs),
                tuple(dv.ranks for dv in dvs), descs, window, after, offset)
        same_packed(label, graph.multisort_page(*args),
                    np.concatenate([page, [start & 0xFFFFFFFF]]))
        ms = cuda_ms(lambda: graph.multisort_page(*args), GRAPH_REPS)
        b_ms = bound_ms(n_pad * (8 + 4 * len(names)) + window * 8)
        log(f"multisort_page {label} by {list(zip(names, descs))}, after "
            f"{after}, offset {offset}: page = numpy lexsort (start "
            f"{start}); {ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms "
            f"(bytes: each candidate and its ranks read once) | {card}")

    mid = int(oracle_stream(cand_np, [r_wide])[n // 2])
    page_case("one key asc", ("wide",), (False,), mid, 5)
    page_case("one key desc", ("k16",), (True,), 0, 12_345)
    page_case("two keys", ("k16", "wide"), (False, True), mid, 0)
    page_case("two keys, one sparse", ("k16", "sparse"), (True, False), 0,
              n - 10)

    # has() + count band + order + page over the resident adjacency
    deg = np.concatenate([np.diff(indptr), np.zeros(n_pad - n, np.int64)])
    lo, hi = 4, 64
    keep = (deg >= lo) & (deg <= hi) & (cand_np != UID_PAD)
    n_kept = int(keep.sum())
    cols = [rank_col(r16, False), rank_col(r_wide, True)]
    stream = oracle_stream(cand_np, [(~keep).astype(np.int64)] + cols)
    excluded = int(cand_np[np.flatnonzero(~keep & (cand_np != UID_PAD))[0]])
    for after, offset in ((int(stream[500]), 3), (excluded, 7)):
        page, start = oracle_page(stream, after, offset, window,
                                  limit=n_kept)
        args = (cand, adj.degrees, lo, hi, (dv16.uids, dv_wide.uids),
                (dv16.ranks, dv_wide.ranks), (False, True), window, after,
                offset)
        same_packed("count_filter_sort_page",
                    graph.count_filter_sort_page(*args),
                    np.concatenate([page, [start, n_kept]]))
    cf_ms = cuda_ms(lambda: graph.count_filter_sort_page(*args), GRAPH_REPS)
    log(f"count_filter_sort_page degree [{lo}, {hi}] over {n} sources: "
        f"{n_kept} kept, pages after a kept and an excluded cursor = numpy "
        f"lexsort; {cf_ms:.4f} ms (CUDA events), bound "
        f"{bound_ms(n_pad * (8 + 4 + 8) + window * 8):.4f} ms (bytes: each "
        f"candidate, degree and two ranks read once) | {card}")

    k = 100
    top, cnt = graph.order_topk(dv16.uids, dv16.ranks, cand, k, desc=True)
    want = oracle_stream(cand_np, [rank_col(r16, True)])[:k]
    same_packed("order_topk", top, want)
    if int(cnt) != min(n, k):
        raise AssertionError(f"order_topk count {int(cnt)}")
    tk_ms = cuda_ms(lambda: graph.order_topk(dv16.uids, dv16.ranks, cand, k,
                                             desc=True), GRAPH_REPS)
    log(f"order_topk k {k} desc over {n} sources = numpy lexsort; "
        f"{tk_ms:.4f} ms (CUDA events), bound "
        f"{bound_ms(n_pad * 12 + k * 8):.4f} ms (bytes: each candidate and "
        f"its rank read once) | {card}")

    lo_k, hi_k = int(np.quantile(k_wide, 0.3)), int(np.quantile(k_wide, 0.6))
    got = to_numpy(graph.range_select(dv_wide, lo_k, hi_k))
    want = uids[(k_wide >= lo_k) & (k_wide <= hi_k)].astype(np.uint32)
    if not np.array_equal(got, want):
        raise AssertionError("range_select != the numpy mask")
    rs_ms = cuda_ms(lambda: graph.range_select(dv_wide, lo_k, hi_k),
                    GRAPH_REPS)
    log(f"range_select [{lo_k}, {hi_k}] over {n} values: {len(got)} uids = "
        f"numpy mask; {rs_ms:.4f} ms (CUDA events), bound "
        f"{bound_ms(n_pad * 20):.4f} ms (bytes: ranks and uids read, uids "
        f"written once) | {card}")

    # the fused tier: a rank leaf on k_wide and an aligned set leaf
    nk = len(dv_wide.host_keys)
    r_lo, r_hi = nk // 4, 3 * nk // 4
    setmask = np.zeros(n_pad, bool)
    setmask[:n] = uids % 3 != 0
    kept = (r_wide >= r_lo) & (r_wide < r_hi) & setmask
    view, is_lut = graph.dv_view(dv_wide)
    mask_t = torch.from_numpy(setmask).to(dev)
    kept_cand = from_numpy(cand_np[kept].astype(np.uint32), device=dev)
    offset = 100
    for ord_name, desc, over in (("wide", False, False), ("wide", True, False),
                                 ("k16", False, True)):
        odv, oranks = tables[ord_name]
        domain = max(1, len(odv.host_keys))
        shift = max(0, (domain - 1).bit_length() - 12)
        base0 = -(domain - 1) if desc else 0
        oview, olut = graph.dv_view(odv)

        def fused():
            return graph.fused_rank_page(
                cand, (view,), (is_lut,), (r_lo,), (r_hi,), (False,),
                (mask_t,), (False,), True, "and", (oview,), (olut,), (desc,),
                base0, shift, window, offset)
        out = fused().cpu().numpy()
        sel_count, got_kept = int(out[-2]), int(out[-1])
        if got_kept != int(kept.sum()):
            raise AssertionError(f"fused n_kept {got_kept} != "
                                 f"{int(kept.sum())}")
        if (sel_count > graph.FUSED_SEL_CAP) != over:
            raise AssertionError(f"fused on {ord_name}: sel_count "
                                 f"{sel_count}, expected "
                                 f"{'past' if over else 'within'} the cap")
        ms = cuda_ms(fused, GRAPH_REPS)
        b_ms = bound_ms(n_pad * (8 + 4 + 1 + 4) + window * 8)
        if not over:
            stream = oracle_stream(cand_np[kept], [rank_col(oranks[kept],
                                                            desc)])
            page, _ = oracle_page(stream, 0, offset, window)
            same_packed("fused_rank_page", torch.from_numpy(out[:-2]), page)
            staged = graph.multisort_page(kept_cand, (odv.uids,),
                                          (odv.ranks,), (desc,), window, 0,
                                          offset)
            same_packed("fused page against multisort_page",
                        torch.from_numpy(out[:-2]), staged.cpu().numpy()[:-1])
        log(f"fused_rank_page and(rank leaf, set leaf) ordered by "
            f"{ord_name} {'desc' if desc else 'asc'} (shift {shift}, base0 "
            f"{base0}): n_kept {got_kept}, sel_count {sel_count} "
            f"{'> cap ' + str(graph.FUSED_SEL_CAP) + ' (the staged chain answers)' if over else '<= cap, page = numpy lexsort = multisort_page'}; "
            f"{ms:.4f} ms (CUDA events), bound {b_ms:.4f} ms (bytes: each "
            f"candidate, leaf rank, mask byte and order rank read once) | "
            f"{card}")
    GRAPH.clear()
    log(f"graph ops: peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB | {card}")


# -- the engine's write-path plane (phases 22-26) ---------------------------

GOLDEN_SCALE = 10                  # tests/golden/dataset.py: ~267k RDF
WRITE_BATCH = 1000                 # N-Quads a transaction (dgraph live)
WRITE_VECS = 1 << 18               # 2 x the engine's vec_index_min_rows
WRITE_DIM = 128                    # SIFT1M's width
VEC_UID0 = 1 << 24                 # above every golden uid at scale 10
WRITE_QUERIES = 256
BFS_SETS = 64
BFS_SEEDS = 8
WRITE_BFS_PREDS = ("starring", "genre", "director.film")
WRITE_VALUE_PREDS = ("rating", "runtime", "initial_release_date")
MIXED_OPS = 10_000
WRITE_REPS = 3


def golden_dataset():
    """tests/golden/dataset.py, loaded by its path: the movie graph's
    generator, which imports only numpy (no part of either package)."""
    import importlib.util

    path = os.path.join(REPO, "tests", "golden", "dataset.py")
    spec = importlib.util.spec_from_file_location("golden_dataset", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tablet_dumps(db, wire, snapshot) -> dict:
    """{predicate -> wire bytes of its dump_tablet}."""
    return {p: wire.dumps(snapshot.dump_tablet(t))
            for p, t in sorted(db.tablets.items())}


def same_dumps(label: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: predicates {sorted(got)} != "
                             f"{sorted(want)}")
    bad = [p for p in want if got[p] != want[p]]
    if bad:
        raise AssertionError(f"{label}: dump_tablet bytes differ for {bad}")


def tile_tensors(obj) -> list:
    """Every tensor a tile holds (dataclass fields, lists), in order."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tile_tensors(x)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in tile_tensors(getattr(obj, f.name))]
    return []


def tile_alloc(obj) -> tuple[int, int]:
    """(tensor bytes, the allocator's bytes) of a tile: the latter over
    its distinct storages, each rounded up to 512 bytes, the caching
    allocator's block size."""
    ts = tile_tensors(obj)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in ts}
    return (sum(t.nbytes for t in ts),
            sum(-(-n // 512) * 512 for n in storages.values()))


def same_tile(label: str, got, want) -> None:
    """A tile on the card equal, field by field, to one built on the CPU."""
    import dataclasses

    if isinstance(want, torch.Tensor):
        if got.device.type != "cuda" or got.dtype != want.dtype or \
                not torch.equal(got.cpu(), want):
            raise AssertionError(f"{label}: tensor differs from the CPU's "
                                 f"or is not on the card")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{label}: {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_tile(f"{label}[{i}]", g, w)
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            if f.name != "device":
                same_tile(f"{label}.{f.name}", getattr(got, f.name),
                          getattr(want, f.name))
    elif isinstance(want, np.ndarray):
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: host array differs")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


def calibration_steps(ivf, ix) -> int:
    """Ladder steps `ivf._calibrate` walked to the index's nprobe: up to
    the first that cleared the target (or reached nlist), else all."""
    ladder = [min(p, ix.nlist) for p in ivf.NPROBE_LADDER]
    if ix.sample_recall >= ix.target_recall or ix.nprobe >= ix.nlist:
        return ladder.index(ix.nprobe) + 1
    return len(ladder)


def reset_launches(kernels) -> None:
    for fn in (kernels.bucket_or, kernels.bucket_or_level,
               kernels.score_dot, kernels.score_int8, kernels.bitmap_and):
        fn.launches = 0


def mixed_round(rng, tablets, n_ops: int) -> list[str]:
    """n_ops seeded sets and deletes over the graph's uid predicates, in
    transactions of WRITE_BATCH: new and deleted starring, genre and
    director.film edges, and S P * deletes."""
    out, cur = [], []
    srcs = {p: np.fromiter(tablets[p].edges, np.int64)
            for p in WRITE_BFS_PREDS}
    dsts = {p: np.fromiter(tablets[p].reverse or
                           {int(d) for v in tablets[p].edges.values()
                            for d in v}, np.int64)
            for p in WRITE_BFS_PREDS}
    for i in range(n_ops):
        p = WRITE_BFS_PREDS[i % len(WRITE_BFS_PREDS)]
        s = int(rng.choice(srcs[p]))
        kind = i % 10
        if kind < 6:
            cur.append(f"+<{s:#x}> <{p}> <{int(rng.choice(dsts[p])):#x}> .")
        elif kind < 9:
            row = tablets[p].edges.get(s)
            if row is not None and len(row):
                cur.append(f"-<{s:#x}> <{p}> <{int(row[0]):#x}> .")
            else:
                cur.append(f"-<{s:#x}> <{p}> * .")
        else:
            cur.append(f"-<{s:#x}> <{p}> * .")
        if len(cur) == WRITE_BATCH:
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def write_plane(dev, card: str) -> dict:
    """Phases 22-26: the engine's write path (`engine/db.GraphDB` over
    `storage/`, `cdc/`, `wire/`) on the card, its WAL and snapshot in a
    scratch directory under build/. Returns the kernels line's entry of
    score_int8_lists as rollup drives it."""
    import shutil

    work = os.path.join(REPO, "build", "write_plane")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        return write_phases(dev, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_phases(dev, card: str, work: str) -> dict:
    import io

    from dgraph_tpu_torch import wire
    from dgraph_tpu_torch.bench import vectors as bv
    from dgraph_tpu_torch.engine import device_cache as dc
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ops import bitgraph, graph, ivf, kernels
    from dgraph_tpu_torch.storage import snapshot, vecstore
    from dgraph_tpu_torch.utils.logger import log as engine_log

    torch.backends.cuda.matmul.allow_tf32 = False
    wal = os.path.join(work, "engine.wal")

    # -- 22. load ----------------------------------------------------------
    ds = golden_dataset()
    t0 = time.perf_counter()
    schema, lines = ds.generate(GOLDEN_SCALE)
    vecs = bv.gen_corpus(WRITE_VECS, WRITE_DIM, seed=0)
    row_fmt = "[" + ",".join(["%.9g"] * WRITE_DIM) + "]"
    rows = [row_fmt % tuple(r) for r in vecs.tolist()]
    gen_s = time.perf_counter() - t0
    db = GraphDB(device=dev, plan_cache_size=0, wal_path=wal,
                 vec_index_min_rows=WRITE_VECS // 2)
    db.alter(schema + "embedding: float32vector .\n")
    t0 = time.perf_counter()
    for s in range(0, len(lines), WRITE_BATCH):
        db.mutate(set_nquads="\n".join(lines[s:s + WRITE_BATCH]))
    rdf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in range(0, WRITE_VECS, WRITE_BATCH):
        db.mutate(set_json=[{"uid": hex(VEC_UID0 + i), "embedding": rows[i]}
                            for i in range(s, min(WRITE_VECS,
                                                  s + WRITE_BATCH))])
    vec_s = time.perf_counter() - t0
    del rows
    n_txn = -(-len(lines) // WRITE_BATCH) + -(-WRITE_VECS // WRITE_BATCH)
    log(f"write path, load: golden movie graph at scale {GOLDEN_SCALE}, "
        f"{len(lines)} RDF in {rdf_s:.2f} s ({len(lines) / rdf_s:.0f} "
        f"RDF/s), then {WRITE_VECS} x {WRITE_DIM} float32 embeddings as "
        f"JSON in {vec_s:.2f} s ({WRITE_VECS / vec_s:.0f} vectors/s), "
        f"{n_txn} transactions of {WRITE_BATCH}, each committed to the WAL "
        f"({os.path.getsize(wal) / 2**20:.1f} MiB); data set-up "
        f"{gen_s:.1f} s | {card}")
    t0 = time.perf_counter()
    before_rollup = tablet_dumps(db, wire, snapshot)
    dump_s = time.perf_counter() - t0

    # -- 23. rollup --------------------------------------------------------
    calls = []

    def recorded(codes, qs, table, out, **kw):
        calls.append((codes, qs, table, out, kw))
        return kernels.score_int8_lists(codes, qs, table, out, **kw)

    # the index build's device steps, each timed by a pair of CUDA events
    # (no profiler: a session spanning the rollup's long host stretches
    # leaves the next session in the process blind to copies)
    spans = []

    def timed(fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((start, end))
            return out
        return run

    steps_fns = {"_assign": ivf._assign, "_probe": ivf._probe,
                 "_approx_scores_device": ivf._approx_scores_device}
    to_device = ivf.IVFIndex.to_device
    logged = io.StringIO()
    stream, engine_log.stream = engine_log.stream, logged
    ivf.score_int8_lists = recorded
    for name, fn in steps_fns.items():
        setattr(ivf, name, timed(fn))
    ivf.IVFIndex.to_device = timed(to_device)
    try:
        reset_launches(kernels)
        t0 = time.perf_counter()
        db.rollup_all(0)
        torch.cuda.synchronize()
        rollup_s = time.perf_counter() - t0
        launches = kernels.score_int8.launches
        others = {f.__name__: f.launches for f in (
            kernels.bucket_or, kernels.bucket_or_level,
            kernels.score_dot, kernels.bitmap_and)}
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
        for name, fn in steps_fns.items():
            setattr(ivf, name, fn)
        ivf.IVFIndex.to_device = to_device
        engine_log.stream = stream
    dev_ms = sum(a.elapsed_time(b) for a, b in spans)
    tab = db.tablets["embedding"]
    ix = tab.vector_ivf()
    if ix is None or ix.device != dev:
        raise AssertionError("rollup trained no vector index on the card")
    if "vector_index_build_failed" in logged.getvalue():
        raise AssertionError(f"rollup logged {logged.getvalue()!r}")
    steps = calibration_steps(ivf, ix)
    if launches != steps or len(calls) != steps or any(others.values()):
        raise AssertionError(
            f"rollup launched score_int8_lists {launches} times ({len(calls)}"
            f" recorded calls) for {steps} calibration steps; other kernels "
            f"{others}")
    log(f"rollup_all(0): {rollup_s:.2f} s on the host for {len(db.tablets)} "
        f"tablets; the vector index {ix.describe()} trained on the card, "
        f"score_int8_lists launched {launches} times = {steps} calibration "
        f"steps (nprobe ladder {list(ivf.NPROBE_LADDER)} to {ix.nprobe}), "
        f"every other kernel 0; device time of the index build "
        f"{dev_ms:.3f} ms over its {len(spans)} device steps (CUDA events "
        f"around each assignment, upload, probe and approximate stage, "
        f"copies included), idle share {1 - dev_ms / (rollup_s * 1e3):.6f}"
        f" of the rollup | {card}")

    uids, block = vecstore._base_block(tab)
    if not np.array_equal(block, vecs) or not np.array_equal(
            uids, VEC_UID0 + np.arange(WRITE_VECS, dtype=np.uint64)):
        raise AssertionError("the vector tablet's base block != the corpus")
    queries = bv.draw_queries(vecs, WRITE_QUERIES)
    exact = ivf.exact_topk_blocked(vecs, queries, VEC_K, metric=VEC_METRIC)
    got, _ = ivf.search(ix, vecs, queries, VEC_K, VEC_METRIC)
    rec = bv.recall(exact, got)
    ivf.score_int8_lists = kernels.score_int8_lists_reference
    try:
        plain, _ = ivf.search(ix, vecs, queries, VEC_K, VEC_METRIC)
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    flips = same_topk("rollup index vs plain", got, plain, vecs, queries,
                      VEC_METRIC, (WRITE_DIM + 4) * 2.0 ** -24)
    if rec < bv.RECALL_FLOOR:
        raise AssertionError(f"rollup index recall@{VEC_K} {rec} < "
                             f"{bv.RECALL_FLOOR}")
    codes_s, q_s, table_s, out_s, kw_s = calls[-1]
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    int8_ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes_s, q_s, table_s, out_s, **kw_s), 20, flush)
    del flush
    plain_out = torch.empty_like(out_s)
    plain_ms = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes_s, q_s, table_s, plain_out, **kw_s), 3)
    err, ratio = lists_within_bound(codes_s, q_s, table_s, out_s, plain_out,
                                    kw_s, "score_int8_lists, last "
                                    "calibration step")
    int8_bound, int8_by = lists_bound_ms(codes_s, q_s, table_s)
    _, ln, _, m, _ = table_s.T
    log(f"rollup index at nprobe {ix.nprobe}: recall@{VEC_K} {rec} over "
        f"{WRITE_QUERIES} queries against exact_topk_blocked (>= "
        f"{bv.RECALL_FLOOR}); answer = the plain score_int8_lists' "
        f"({flips} rounding flips); the last calibration step's launch "
        f"({len(table_s)} entries, {int((m * ln).sum())} scores, worst "
        f"error/bound {ratio:.4g}): kernel {int8_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {int8_bound:.4f} ms ({int8_by}) | {card}")
    del calls, codes_s, q_s, out_s, plain_out
    after_rollup = tablet_dumps(db, wire, snapshot)

    # -- 24. durability ----------------------------------------------------
    db.close()
    replays = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        other = GraphDB(device=where, plan_cache_size=0, wal_path=wal,
                        vec_index_min_rows=WRITE_VECS // 2)
        replays[name] = time.perf_counter() - t0
        same_dumps(f"WAL replay on {where}", tablet_dumps(
            other, wire, snapshot), before_rollup)
        other.close()
        del other
    snap = os.path.join(work, "engine.snap")
    t0 = time.perf_counter()
    snapshot.save_snapshot(db, snap)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = snapshot.load_snapshot(snap, device=dev)
    load_s = time.perf_counter() - t0
    same_dumps("snapshot", tablet_dumps(restored, wire, snapshot),
               after_rollup)
    if restored.tablets["embedding"].vector_ivf().device != dev:
        raise AssertionError("the restored vector index is not on the card")
    del restored
    n_rec = len(lines) + WRITE_VECS
    log(f"durability: WAL replay ({n_txn} commit records, {n_rec} edges) "
        f"into a fresh GraphDB on the card {replays['card']:.2f} s "
        f"({n_rec / replays['card']:.0f} edges/s), on the CPU "
        f"{replays['cpu']:.2f} s ({n_rec / replays['cpu']:.0f} edges/s); "
        f"every predicate's dump_tablet bytes equal the engine's before "
        f"rollup (dumped in {dump_s:.2f} s); save_snapshot {save_s:.2f} s "
        f"({os.path.getsize(snap) / 2**20:.1f} MiB), load_snapshot on the "
        f"card {load_s:.2f} s, equal to the engine's after rollup | {card}")
    torch.cuda.empty_cache()

    # -- 25. tiles on the card ---------------------------------------------
    ts = db.coordinator.max_assigned()
    uid_preds = sorted(p for p, t in db.tablets.items() if t.is_uid)
    builds = ([("_device_adj", p) for p in uid_preds]
              + [("_device_radj", p) for p in uid_preds
                 if db.tablets[p].schema.reverse]
              + [("_device_badj", "starring")]
              + [("_device_values", p) for p in WRITE_VALUE_PREDS])
    build = {"_device_adj": dc.device_adjacency,
             "_device_radj": dc.device_radjacency,
             "_device_badj": dc.device_bitadjacency,
             "_device_values": dc.device_values}
    if db.device_cache.bytes:
        raise AssertionError("tiles resident before phase 25")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    tiles = {}
    for attr, p in builds:
        tiles[(attr, p)] = build[attr](db, db.tablets[p], ts)
        if tiles[(attr, p)] is None:
            raise AssertionError(f"no {attr} tile for {p}")
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated(dev)
    sizes = {k: tile_alloc(v) for k, v in tiles.items()}
    tensor_bytes = sum(s[0] for s in sizes.values())
    alloc_bytes = sum(s[1] for s in sizes.values())
    if db.device_cache.bytes != tensor_bytes:
        raise AssertionError(f"DeviceCacheLRU charges {db.device_cache.bytes}"
                             f" device bytes, the tiles hold {tensor_bytes}")
    if not tensor_bytes <= mem1 - mem0 <= alloc_bytes:
        raise AssertionError(f"memory_allocated grew {mem1 - mem0} bytes "
                             f"for tiles of {tensor_bytes} ({alloc_bytes} "
                             f"in 512-byte blocks)")
    for (attr, p), got in tiles.items():
        tab_p = db.tablets[p]
        if attr == "_device_values":
            want = graph.build_values(tab_p.sort_key_pairs(""), device="cpu")
        elif attr == "_device_badj":
            want = bitgraph.build_bitadjacency(dc._edges32(tab_p.edges),
                                               device="cpu")
        else:
            edges = tab_p.edges if attr == "_device_adj" else tab_p.reverse
            want = graph.build_adjacency(dc._edges32(edges), device="cpu")
        same_tile(f"{attr} of {p}", got, want)
    log(f"tiles on the card: {len(tiles)} tiles ({len(uid_preds)} "
        f"adjacencies, {sum(a == '_device_radj' for a, _ in builds)} reverse,"
        f" 1 bitmap adjacency, {len(WRITE_VALUE_PREDS)} value tables) built "
        f"in {tiles_s:.2f} s on the host, each equal to the CPU-built tile; "
        f"DeviceCacheLRU device column {tensor_bytes} bytes = the tiles' "
        f"tensor bytes; memory_allocated grew {mem1 - mem0} bytes (blocks of"
        f" 512: {alloc_bytes}) | {card}")
    order = list(tiles)
    del tiles, got, want
    total = db.device_cache.bytes
    db.device_cache.budget = total // 2
    before = set(db.device_cache._entries)
    torch.cuda.synchronize()
    mem_a = torch.cuda.memory_allocated(dev)
    extra = dc.device_bitadjacency(db, db.tablets["genre"], ts)
    extra_bytes, extra_alloc = tile_alloc(extra)
    del extra
    torch.cuda.synchronize()
    mem_b = torch.cuda.memory_allocated(dev)
    gone = before - set(db.device_cache._entries)
    named = [(attr, p) for attr, p in order
             if (id(db.tablets[p]), attr) in gone]
    freed = mem_a + extra_alloc - mem_b
    want_lo = sum(sizes[k][0] for k in named)
    want_hi = sum(sizes[k][1] for k in named)
    if not named or any(getattr(db.tablets[p], attr) is not None
                        for attr, p in named) or \
            named != order[:len(named)] or not want_lo <= freed <= want_hi:
        raise AssertionError(f"eviction under budget {total // 2}: evicted "
                             f"{named}, freed {freed} bytes, expected "
                             f"{want_lo}..{want_hi} from the oldest tiles")
    log(f"eviction under a budget of {total // 2} bytes (half the tiles): "
        f"admitting genre's bitmap adjacency ({extra_bytes} bytes) evicted "
        f"the {len(named)} least recently used tiles, their attributes "
        f"cleared, freeing {freed} bytes on the card (their tensors "
        f"{want_lo}) | {card}")
    db.device_cache.budget = 2 << 30

    # -- 26. reads on the card ---------------------------------------------
    rng = np.random.default_rng(26)
    for p in WRITE_BFS_PREDS:
        srcs = np.fromiter(db.tablets[p].edges, np.int64)
        sets = [rng.choice(srcs, BFS_SEEDS, replace=False)
                for _ in range(BFS_SETS)]
        db.prefer_device = True
        dev_levels = [db.bfs(p, s, 3) for s in sets]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for s in sets:
            db.bfs(p, s, 3)
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end) / BFS_SETS
        db.prefer_device = False
        t0 = time.perf_counter()
        host_levels = [db.bfs(p, s, 3) for s in sets]
        host_ms = (time.perf_counter() - t0) * 1e3 / BFS_SETS
        db.prefer_device = True
        for q, (a, b) in enumerate(zip(dev_levels, host_levels)):
            if len(a) != 3 or any(not np.array_equal(x, y)
                                  for x, y in zip(a, b)):
                raise AssertionError(f"bfs on {p}, seed set {q}: card != "
                                     f"the host overlay path")
        badj = db.tablets[p]._device_badj
        b_ms = bound_ms(3 * sum(b.in_nb.numel() * 4 for b in badj.buckets))
        log(f"GraphDB.bfs on {p}, depth 3, {BFS_SETS} seed sets of "
            f"{BFS_SEEDS}: card {dev_ms:.3f} ms a call (CUDA events around "
            f"the {BFS_SETS} calls), host overlay path {host_ms:.3f} ms "
            f"(host clock), level by "
            f"level equal; bound {b_ms:.4f} ms (bytes: the bitmap "
            f"adjacency's in-neighbour slots read once a level) | {card}")

    def expand_check(label: str, read_ts: int) -> None:
        tab_s = db.tablets["starring"]
        adj = dc.device_adjacency(db, tab_s, read_ts)
        srcs = np.asarray(sorted(tab_s.edges), np.uint64)
        for n in (8, 1024, len(srcs)):
            src = srcs[:: max(1, len(srcs) // n)][:n]
            got = dc.expand_np(adj, src)
            want = tab_s.expand_frontier(src, read_ts)
            if not np.array_equal(got, want):
                raise AssertionError(f"expand_np of {n} sources ({label}) "
                                     f"!= tab.expand_frontier")
            ms = cuda_ms(lambda: dc.expand_np(adj, src), WRITE_REPS)
            read = sum(len(tab_s.edges[int(u)]) for u in src)
            log(f"expand_np {label}, {n} sources: {len(got)} uids = "
                f"expand_frontier; {ms:.4f} ms a call (CUDA events, host "
                f"copies in and out included), bound "
                f"{bound_ms(8 * (2 * n + read + len(got))):.6f} ms (bytes: "
                f"sources, their rows and the union once) | {card}")

    expand_check("on the rolled-up graph", ts)
    t0 = time.perf_counter()
    pin = db.new_txn()          # pins the watermark: the tablets stay dirty
    for txn in mixed_round(rng, db.tablets, MIXED_OPS):
        db.mutate(set_nquads="\n".join(x[1:] for x in txn if x[0] == "+"),
                  del_nquads="\n".join(x[1:] for x in txn if x[0] == "-"))
    mixed_s = time.perf_counter() - t0
    ts2 = db.coordinator.max_assigned()
    for p in WRITE_BFS_PREDS:
        if not db.tablets[p].dirty() or \
                dc.device_adjacency(db, db.tablets[p], ts2) is not None:
            raise AssertionError(f"{p}: a dirty tablet answered a tile")
    db.discard(pin)
    t0 = time.perf_counter()
    db.rollup_all(0)
    torch.cuda.synchronize()
    rollup2_s = time.perf_counter() - t0
    ts3 = db.coordinator.max_assigned()
    for p in WRITE_BFS_PREDS:
        tab_p = db.tablets[p]
        got = dc.device_adjacency(db, tab_p, ts3)
        same_tile(f"rebuilt adjacency of {p}", got, graph.build_adjacency(
            dc._edges32(tab_p.edges), device="cpu"))
        for u in list(tab_p.edges)[:: max(1, len(tab_p.edges) // 64)]:
            want = tab_p.get_dst_uids(u, ts3)
            row = dc.expand_np(got, np.asarray([u], np.uint64))
            if not np.array_equal(row, want):
                raise AssertionError(f"{p}: rebuilt tile row of {u:#x} != "
                                     f"the host read")
    expand_check("after the mixed round", ts3)
    log(f"mixed round: {MIXED_OPS} sets and deletes in "
        f"{-(-MIXED_OPS // WRITE_BATCH)} transactions in {mixed_s:.2f} s, "
        f"device_adjacency None while dirty; rollup_all {rollup2_s:.2f} s; "
        f"the rebuilt tiles equal the CPU-built and the host reads | {card}")
    del db
    torch.cuda.empty_cache()
    return {"name": "score_int8_lists", "route": "cuda",
            "source": "dgraph_tpu_torch/csrc/score.cu",
            "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
            "path": "GraphDB.rollup_all -> vecstore.build_ivf -> "
                    "ivf._calibrate",
            "launches": launches, "max_abs_err": err, "ms": int8_ms,
            "plain_ms": plain_ms, "bound_ms": int8_bound,
            "bound_by": int8_by, "library_ms": None}


# -- the vector search plane (phases 8-12) ----------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean ms of one call of `fn` on the card: one warm-up, then CUDA
    events around `reps` calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def score_bound_ms(calls) -> tuple[float, str]:
    """Least time of the score products `calls` ((rows, queries) pairs)
    on the card: rows, queries and outputs moved once over the memory
    rate against 2 * b * n * d float32 operations over the float32 peak;
    (ms, what bounds it)."""
    nbytes = sum(c.numel() * c.element_size() + 4 * q.numel()
                 + 4 * q.shape[0] * c.shape[0] for c, q in calls)
    ops = sum(2.0 * q.shape[0] * c.shape[0] * c.shape[1] for c, q in calls)
    by_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(by_s, ops_s) * 1e3, "bytes" if by_s >= ops_s else "operations"


def lists_bound_ms(codes, queries, table) -> tuple[float, str]:
    """Least time of a list table's products on the card: each probed
    list's code rows and scales read once, the queries once, the table
    and each slot's query index and term once, each score written once,
    against 2 * d float32 operations a score; (ms, what bounds it)."""
    d = codes.shape[1]
    s, ln, _, m, _ = table.T
    _, first = np.unique(s, return_index=True)
    scores = int((m * ln).sum())
    nbytes = int(ln[first].sum()) * (d + 4) + queries.numel() * 4 + \
        table.nbytes + 12 * int(m.sum()) + 4 * scores
    by_s, ops_s = nbytes / HBM_BYTES_PER_S, 2.0 * scores * d / FP32_FLOPS
    return max(by_s, ops_s) * 1e3, "bytes" if by_s >= ops_s else "operations"


def check_score(fn, plain, rows, q, label: str) -> tuple[float, float]:
    """Kernel against plain version, element by element, within the
    reordering bound d * 2^-24 * sum_k |q_k c_k| (both sum the same
    float32 products, in another order). Also writes through `out=` into
    a slice of a larger buffer whose neighbours must stay untouched.
    Returns (max abs error, worst error / bound)."""
    got = fn(rows, q)
    want = plain(rows, q)
    d = q.shape[1]
    bound = d * 2.0 ** -24 * torch.matmul(q.abs(), rows.abs().float().T)
    b, n = want.shape
    big = torch.full((b * n + 2,), 7.0, device=q.device)
    fn(rows, q, out=big[1:b * n + 1].view(b, n))
    torch.cuda.synchronize()
    err = (got - want).abs()
    ratio = float((err / bound.clamp_min(1e-30)).max())
    if tuple(got.shape) != (b, n) or not bool((err <= bound).all()) or \
            not torch.equal(big[1:b * n + 1].view(b, n), got) or \
            float(big[0]) != 7.0 or float(big[-1]) != 7.0:
        raise AssertionError(f"{label}: kernel != plain version within the "
                             f"reordering bound (worst ratio {ratio:.3g})")
    return float(err.max()), ratio


def check_score_kernels(kernels, dev, card: str) -> tuple[float, float]:
    """Phase 8: score_dot and score_int8 against their plain versions on
    every tested shape, score_int8 over list-like slices of one resident
    code block, and score_int8_lists on hand-built tables. Returns each
    kernel's worst absolute error."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"dot": (0.0, 0.0), "int8": (0.0, 0.0)}
    shapes = 0

    def check(key, fn, plain, rows, q, label):
        nonlocal shapes
        e, r = check_score(fn, plain, rows, q, label)
        worst[key] = (max(worst[key][0], e), max(worst[key][1], r))
        shapes += 1

    def both(corpus, codes, batches, label):
        for b in batches:
            q = torch.randn((b, corpus.shape[1]), device=dev, generator=gen)
            check("dot", kernels.score_dot, kernels.score_dot_reference,
                  corpus, q, f"score_dot b={b} {label}")
            check("int8", kernels.score_int8, kernels.score_int8_reference,
                  codes, q, f"score_int8 b={b} {label}")

    for d, n in SCORE_CHECK_SHAPES:
        corpus = torch.randn((n, d), device=dev, generator=gen)
        codes = torch.randint(-127, 128, (n, d), device=dev, generator=gen,
                              dtype=torch.int8)
        both(corpus, codes, SCORE_CHECK_BATCHES, f"n={n} d={d}")
        del corpus, codes
    # corpora that start off 16-byte alignment (a slice's offset)
    n, d = 65_536, 128
    flat = torch.randn(n * d + 1, device=dev, generator=gen)
    flat8 = torch.randint(-127, 128, (n * d + 3,), device=dev, generator=gen,
                          dtype=torch.int8)
    both(flat[1:].view(n, d), flat8[3:].view(n, d), (3, 256),
         f"n={n} d={d} off 16-byte alignment")
    del flat, flat8
    # list-like slices: contiguous row ranges of one resident code block
    codes = torch.randint(-127, 128, (200_000, 128), device=dev,
                          generator=gen, dtype=torch.int8)
    for s, ln in ((0, 1), (7, 17), (1_001, 640), (50_000, 2_049),
                  (194_999, 5_000), (123_457, 4_321)):  # within 200,000
        for b in (1, 3, 37, 256):
            q = torch.randn((b, 128), device=dev, generator=gen)
            check("int8", kernels.score_int8, kernels.score_int8_reference,
                  codes[s:s + ln], q, f"score_int8 rows [{s}:{s + ln}] "
                  f"b={b}")
    # score_int8_lists on hand-built tables over the same block
    scales = torch.rand(200_000, device=dev, generator=gen) / 127
    q = torch.randn((40, 128), device=dev, generator=gen)
    rng = np.random.default_rng(8)
    starts = np.sort(rng.choice(200_000, 121, replace=False))
    mixed = [(int(starts[i]), int(starts[i]) + int(rng.integers(1, 3_000)),
              sorted(rng.choice(40, int(rng.integers(1, 41)),
                                replace=False).tolist()))
             for i in range(120)]
    mixed = [(s, min(e, int(starts[i + 1])), qis)
             for i, (s, e, qis) in enumerate(mixed)]
    m_big = kernels.lists_limits(128)[0] + 1
    tables = {"empty table": [], "one-row list": [(5, 6, [3])],
              "m = 1": [(1_000, 3_250, [7])],
              f"m = M_TILE + 1 = {m_big}": [(10_000, 12_000,
                                             list(range(m_big)))],
              "both ends of the block": [(0, 1_500, [0, 5, 9]),
                                         (198_500, 200_000, [1, 2])],
              "120 lists, m 1-40": mixed}
    for label, slices in tables.items():
        e, r = check_lists(kernels, codes, q, scales, slices, rng,
                           f"score_int8_lists {label}")
        worst["int8"] = (max(worst["int8"][0], e), max(worst["int8"][1], r))
        shapes += 1
    # an entry of more queries than the kernel holds is refused
    over, _, total = kernels.int8_lists_table(tables[
        f"m = M_TILE + 1 = {m_big}"])
    try:
        kernels.score_int8_lists(codes, q, over,
                                 torch.empty(total, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError(f"score_int8_lists took an entry of {m_big} "
                             f"queries")
    log(f"kernel check: score_dot, score_int8 and score_int8_lists within "
        f"the reordering bound of their plain versions on {shapes} shapes "
        f"(b 1/3/256/257, d 16/37/100/128/1024, n 1..1,000,064, corpora off "
        f"16-byte alignment, int8 list slices of 1-5,000 rows, "
        f"{len(tables)} list tables); worst error/bound: score_dot "
        f"{worst['dot'][1]:.4g}, score_int8 {worst['int8'][1]:.4g} | {card}")
    return worst["dot"][0], worst["int8"][0]


def check_lists(kernels, codes, q, scales, slices, rng, label: str
                ) -> tuple[float, float]:
    """score_int8_lists against its plain version on the table of
    `slices` ((start, end, query ids) a list), with random terms, written
    into a slice of a larger buffer whose neighbours must stay untouched;
    one launch unless the table is empty, then none; within
    `lists_bound`. Returns (max abs error, worst error / bound)."""
    table, qidx, total = kernels.int8_lists_table(
        slices, kernels.lists_m_tile(codes.shape[1], codes.device))
    cterm = rng.standard_normal(len(qidx)).astype(np.float32)
    kw = dict(qidx=qidx, scales=scales, cterm=cterm)
    big = torch.full((total + 2,), 7.0, device=q.device)
    before = kernels.score_int8.launches
    kernels.score_int8_lists(codes, q, table, big[1:total + 1], **kw)
    launched = kernels.score_int8.launches - before
    want = kernels.score_int8_lists_reference(
        codes, q, table, torch.empty(total, device=q.device), **kw)
    torch.cuda.synchronize()
    if launched != (1 if total else 0) or float(big[0]) != 7.0 or \
            float(big[-1]) != 7.0:
        raise AssertionError(f"{label}: {launched} launches, or a write "
                             f"outside its scores")
    return lists_within_bound(codes, q, table, big[1:total + 1], want, kw,
                              label)


def lists_within_bound(codes, q, table, got, want, kw, label: str
                       ) -> tuple[float, float]:
    """A list table's kernel scores `got` against the plain version's
    `want`, score by score, within the dots' reordering bound times
    |scale|, plus one rounding of the product and one of the sum on each
    side; raises outside it. `kw` holds the call's qidx, scales and
    cterm. Returns (max abs error, worst error / bound)."""
    total = got.numel()
    if not total:
        return 0.0, 0.0
    qidx, scales, cterm = kw["qidx"], kw["scales"], kw["cterm"]
    bound = torch.empty(total, dtype=torch.float64, device=q.device)
    qi = torch.from_numpy(qidx).to(q.device)
    ct = torch.from_numpy(cterm).to(q.device).double()
    for s, ln, a, m, off in table.tolist():
        qs = q.index_select(0, qi[a:a + m]).double()
        rows = codes[s:s + ln].double()
        sc = scales[s:s + ln].double()
        dot = torch.matmul(qs, rows.T)
        reorder = q.shape[1] * 2.0 ** -24 * torch.matmul(qs.abs(),
                                                         rows.abs().T)
        prod = (dot.abs() + reorder) * sc
        bound[off:off + m * ln] = (reorder * sc + 2.0 ** -23 * (
            2 * prod + 2 * (prod + ct[a:a + m, None].abs()))).reshape(-1)
    err = (got.double() - want.double()).abs()
    ratio = float((err / bound.clamp_min(1e-30)).max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{label}: kernel != plain version within the "
                             f"bound (worst ratio {ratio:.3g})")
    return float(err.max()), ratio


def same_topk(label: str, got, want, corpus, queries, metric: str,
              tol: float) -> int:
    """Index parity of two top-k answers, row by row. A row that differs
    passes only if, rank by rank, the two rows' float64 scores differ by
    at most `tol` (neighbours swapped within rounding); each such flip
    is printed with its gap. Returns the number of flipped rows."""
    from dgraph_tpu_torch.ops import knn

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {got.shape} {want.shape}")
    flips = 0
    for qi in range(len(want)):
        if np.array_equal(got[qi], want[qi]):
            continue
        sg = knn.score_host(corpus[got[qi]], queries[qi], metric)[0]
        sw = knn.score_host(corpus[want[qi]], queries[qi], metric)[0]
        gap = float(np.abs(sg - sw).max())
        log(f"  {label}: query {qi} flips {got[qi].tolist()} vs "
            f"{want[qi].tolist()}, largest float64 score gap {gap:.3g} "
            f"(tolerance {tol:.3g})")
        if gap > tol:
            raise AssertionError(f"{label}: query {qi} differs beyond "
                                 f"rounding")
        flips += 1
    return flips


def vector_plane(dev, card: str) -> list[dict]:
    """Phases 8-12: the similar_to vector search plane at 1M x 128.
    Returns the kernels line's entries of score_dot and score_int8."""
    from dgraph_tpu_torch.bench import vectors as bv
    from dgraph_tpu_torch.ops import ivf, kernels, knn

    # every float32 product of this plane, the plain versions and the
    # library yardstick included, runs in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 8. kernels against their plain versions ---------------------------
    err_dot, err_int8 = check_score_kernels(kernels, dev, card)

    # -- 9. exact and two-stage tiers at 1M x 128 --------------------------
    t0 = time.perf_counter()
    corpus = bv.gen_corpus(VEC_N, VEC_D, seed=0)
    queries = bv.draw_queries(corpus, VEC_BATCH)
    log(f"vector corpus {VEC_N} x {VEC_D} float32, batch {VEC_BATCH}, "
        f"k {VEC_K}, {VEC_METRIC} ({time.perf_counter() - t0:.1f} s host)")
    corpus_dev = torch.from_numpy(corpus).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def exact_fn(two_stage):
        return lambda qs: knn.topk_device(corpus_dev, qs, VEC_K, VEC_METRIC,
                                          two_stage=two_stage)

    dot_launches = 0
    answers = {}
    for name, two_stage in (("exact", False), ("two-stage", True)):
        fn = exact_fn(two_stage)
        fn(queries)                                     # warm
        kernels.score_dot.launches = 0
        times = bv.time_batches(fn, queries, bv.RUNS, dev)
        answers[name], _ = fn(queries)
        got = kernels.score_dot.launches
        if got != bv.RUNS + 1:
            raise AssertionError(f"{name} tier launched score_dot {got} "
                                 f"times in {bv.RUNS + 1} calls")
        dot_launches += got
        log(f"{name} tier: {bv.qps(VEC_BATCH, times):.1f} QPS sustained "
            f"({bv.RUNS} batches of {VEC_BATCH} over {sum(times):.4f} s, "
            f"s {times}); score_dot launched {got} times in {got} calls "
            f"| {card}")
    peak_exact = torch.cuda.max_memory_allocated(dev) / 2**30
    rec_two = bv.recall(answers["exact"], answers["two-stage"])

    # answers: the same exact call with the plain version as its scorer
    knn.score_dot = kernels.score_dot_reference
    try:
        plain_idx, _ = exact_fn(False)(queries)
    finally:
        knn.score_dot = kernels.score_dot
    # cosine scores are dots over norms: the reordering bound d * 2^-24
    # relative to |q||c|, plus a few roundings of the epilogue
    tol = (VEC_D + 4) * 2.0 ** -24
    flips = same_topk("exact vs plain", answers["exact"], plain_idx,
                      corpus, queries, VEC_METRIC, tol)
    oracle, _ = knn.topk_host(corpus, queries[:ORACLE_QUERIES], VEC_K,
                              VEC_METRIC)
    oflips = same_topk("exact vs float64 oracle",
                       answers["exact"][:ORACLE_QUERIES], oracle, corpus,
                       queries[:ORACLE_QUERIES], VEC_METRIC, tol)
    if rec_two < knn.RECALL_TARGET:
        raise AssertionError(f"two-stage recall@{VEC_K} {rec_two} < "
                             f"{knn.RECALL_TARGET}")
    log(f"answers: exact top-{VEC_K} = plain version on the card "
        f"({flips} rounding flips in {VEC_BATCH} queries), = float64 "
        f"topk_host on {ORACLE_QUERIES} queries ({oflips} flips); "
        f"two-stage recall@{VEC_K} {rec_two} (>= {knn.RECALL_TARGET}); "
        f"peak device memory {peak_exact:.2f} GiB | {card}")

    # score_dot alone at the main path's shape
    q_dev = torch.from_numpy(queries).to(dev)
    dot_ms = cuda_ms(lambda: kernels.score_dot(corpus_dev, q_dev), 10)
    dot_plain_ms = cuda_ms(
        lambda: kernels.score_dot_reference(corpus_dev, q_dev), 10)
    dot_lib_ms = cuda_ms(lambda: torch.matmul(q_dev, corpus_dev.T), 10)
    dot_bound, dot_by = score_bound_ms([(corpus_dev, q_dev)])
    log(f"score_dot at (b {VEC_BATCH}, n {VEC_N}, d {VEC_D}): kernel "
        f"{dot_ms:.4f} ms, plain {dot_plain_ms:.4f} ms, torch.matmul "
        f"(TF32 off) {dot_lib_ms:.4f} ms, bound {dot_bound:.4f} ms "
        f"({dot_by}) | {card}")
    del corpus_dev, q_dev
    torch.cuda.empty_cache()

    # -- 10. quantized IVF tier --------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.score_int8.launches = 0
    t0 = time.perf_counter()
    ix = ivf.build(corpus, seed=0, device=dev)
    build_s = time.perf_counter() - t0
    calib_launches = kernels.score_int8.launches
    log(f"ivf build {build_s:.1f} s (k-means assignment on the card, "
        f"quantization and calibration on the host): {ix.describe()}; "
        f"default_nlist {ivf.default_nlist(VEC_N)}; calibration launched "
        f"score_int8 {calib_launches} times (counted apart) | {card}")
    if ix.nlist != ivf.default_nlist(VEC_N):
        raise AssertionError(f"nlist {ix.nlist}, expected "
                             f"{ivf.default_nlist(VEC_N)}")

    def lists_probed(qs, p) -> int:
        q_t = torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(qs), np.float32)).to(dev)
        _, lists = ivf._probe(q_t, ix.centroids_dev, p, VEC_METRIC)
        li = np.unique(lists.cpu().numpy())
        return int(np.sum(ix.starts[li + 1] > ix.starts[li]))

    records = []
    tables = []

    def recorded_lists(codes, qs, table, out, **kw):
        tables.append((codes, qs, table, out, kw))
        return kernels.score_int8_lists(codes, qs, table, out, **kw)

    def counted(p, r):
        def fn(qs):
            kernels.score_int8.launches = 0
            tables.clear()
            res = ivf.search(ix, corpus, qs, VEC_K, VEC_METRIC, nprobe=p,
                             rerank=r)
            records.append((qs, p, kernels.score_int8.launches,
                            [len(np.unique(t[2][:, 0])) for t in tables]))
            return res
        return fn

    int8_launches = 0
    quant = None
    ivf.score_int8_lists = recorded_lists
    try:
        for p, r in [(ix.nprobe, None)] + bv.frontier_budgets(ix.nlist,
                                                              k=VEC_K):
            fn = counted(p, r)
            fn(queries[:8])                             # warm
            times = bv.time_batches(fn, queries, bv.RUNS, dev)
            gi, _ = fn(queries)
            # each search launched score_int8_lists once, over a table of
            # its distinct probed lists
            per_search = []
            for qs, pp, got, distinct in records:
                want = lists_probed(qs, pp)
                if got != 1 or distinct != [want]:
                    raise AssertionError(
                        f"search at nprobe {pp} launched score_int8 {got} "
                        f"times over tables of {distinct} distinct lists; "
                        f"expected once over {want}")
                per_search.append(got)
            records.clear()
            int8_launches += sum(per_search)
            rr = r or ivf.rerank_depth(VEC_K)
            rec = bv.recall(answers["exact"], gi)
            if r is None:
                quant = (gi, rec)
            log(f"quantized nprobe {p} rerank {rr}"
                f"{' (calibrated)' if r is None else ''}: "
                f"{bv.qps(VEC_BATCH, times):.1f} QPS sustained (s {times}), "
                f"recall@{VEC_K} {rec}; score_int8 launched once in each of "
                f"{len(per_search)} searches, over "
                f"{want} distinct lists in the last | {card}")
        # one calibrated batch's stage, kept for the timings below
        tables.clear()
        ivf.search(ix, corpus, queries, VEC_K, VEC_METRIC)
        stage = tables[0]
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    peak_quant = torch.cuda.max_memory_allocated(dev) / 2**30
    if quant[1] < bv.RECALL_FLOOR:
        raise AssertionError(f"quantized recall@{VEC_K} {quant[1]} < "
                             f"{bv.RECALL_FLOOR}")

    # answers: the same search with the plain version as its scorer
    ivf.score_int8_lists = kernels.score_int8_lists_reference
    try:
        pi, _ = ivf.search(ix, corpus, queries, VEC_K, VEC_METRIC,
                           nprobe=ix.nprobe)
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    qflips = same_topk("quantized vs plain", quant[0], pi, corpus,
                       queries, VEC_METRIC, tol)
    log(f"answers: quantized top-{VEC_K} at the calibrated budget = plain "
        f"version ({qflips} rounding flips); recall@{VEC_K} {quant[1]} "
        f"(>= {bv.RECALL_FLOOR}); peak device memory {peak_quant:.2f} GiB "
        f"| {card}")

    # the one-launch stage of one calibrated batch: device time by CUDA
    # events around the call (its table's upload and its launch), queued
    # behind fills that keep the card busy while the host builds and
    # queues them; then its scores against the plain version's, score by
    # score within the bound of phase 8's tables
    codes_s, q_s, table_s, out_s, kw_s = stage
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    int8_ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes_s, q_s, table_s, out_s, **kw_s), 20, flush)
    del flush
    plain_out = torch.empty_like(out_s)
    int8_plain_ms = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes_s, q_s, table_s, plain_out, **kw_s), 3)
    stage_err, stage_ratio = lists_within_bound(
        codes_s, q_s, table_s, out_s, plain_out, kw_s,
        "score_int8_lists over one calibrated batch")
    err_int8 = max(err_int8, stage_err)
    int8_bound, int8_by = lists_bound_ms(codes_s, q_s, table_s)
    _, ln, _, m, _ = table_s.T
    log(f"score_int8_lists over one calibrated batch (one launch, "
        f"{len(table_s)} entries over {len(np.unique(table_s[:, 0]))} "
        f"lists, {int((m * ln).sum())} scores, each within the bound of "
        f"the plain version's, worst error/bound {stage_ratio:.4g}): "
        f"kernel {int8_ms:.4f} ms "
        f"device time, plain {int8_plain_ms:.4f} ms, bound {int8_bound:.4f} "
        f"ms ({int8_by}); the per-list launch loop it replaced took "
        f"{PER_LIST_LOOP_MS} ms (PERF.md); no single PyTorch call converts "
        f"int8 and multiplies (library_ms null) | {card}")
    del stage, codes_s, q_s, out_s, plain_out

    # where a calibrated batch's wall time goes: the probe and the
    # approximate stage (device work, one copy back) against the whole
    # search, whose rest is the host's filter, cut and float64 re-rank
    stage_s, total_s = [], []
    for r in range(bv.RUNS):
        qs = queries + np.float32(1e-6 * (r + 1))
        t0 = time.perf_counter()
        q_t = torch.from_numpy(qs).to(dev)
        cs_t, lists_t = ivf._probe(q_t, ix.centroids_dev, ix.nprobe,
                                   VEC_METRIC)
        ivf._approx_scores_device(ix, lists_t.cpu().numpy(),
                                  cs_t.cpu().numpy(), q_t)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ivf.search(ix, corpus, qs, VEC_K, VEC_METRIC)
        torch.cuda.synchronize()
        total_s.append(time.perf_counter() - t0)
    log(f"quantized batch wall: probe + approximate stage "
        f"{sum(stage_s) / len(stage_s) * 1e3:.3f} ms of "
        f"{sum(total_s) / len(total_s) * 1e3:.3f} ms per search; the rest "
        f"is the host's filter, cut and float64 re-rank | {card}")

    # -- 11. device time by kernel -----------------------------------------
    corpus_dev = torch.from_numpy(corpus).to(dev)
    profile_window(lambda: exact_fn(False)(queries), 1, "exact batch", card)
    del corpus_dev
    profile_window(lambda: ivf.search(ix, corpus, queries, VEC_K,
                                      VEC_METRIC),
                   1, "quantized batch", card)
    del ix
    torch.cuda.empty_cache()

    # -- 12. the 100k regime, briefly --------------------------------------
    small = bv.run_regime(SMALL_N, VEC_D, VEC_BATCH, VEC_K, VEC_METRIC,
                          dev, budgets=[], runs=1)
    qi = small["quantized_index"]
    log(f"{SMALL_N} regime (informational; another numpy may draw another "
        f"corpus): nlist {qi['nlist']}, nprobe {qi['nprobe']}, "
        f"sampleRecall {qi['sampleRecall']}, two-stage recall "
        f"{small['two_stage_recall_at_k']}; BENCH_VECTORS.json's 100k "
        f"record {BENCH_VECTORS_100K}")

    return [
        {"name": "score_dot", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:123",
         "launches": dot_launches, "max_abs_err": err_dot,
         "ms": dot_ms, "plain_ms": dot_plain_ms, "bound_ms": dot_bound,
         "bound_by": dot_by, "library_ms": dot_lib_ms},
        {"name": "score_int8", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
         "launches": int8_launches, "max_abs_err": err_int8,
         "ms": int8_ms, "plain_ms": int8_plain_ms, "bound_ms": int8_bound,
         "bound_by": int8_by, "library_ms": None},
    ]


# -- the sorted-UID set-algebra plane (phases 13-17) ------------------------

def check_bitmap_and(kernels, dev, card: str) -> int:
    """Phase 13: bitmap_and against bitmap_and_reference on the card, bit
    for bit; the wrapper refuses a non-contiguous input. Returns the
    largest count of differing words (0, or the check raises)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-2**63, 2**63 - 1, shape, dtype=torch.int64,
                             device=dev, generator=gen)

    cases = [words(k, b, 1024) for k in (1, 2, 3, 4, 8)
             for b in (1, 7, 8, 9, 1024, 4096)]
    # an odd word count (one word a thread) starting 8 bytes past a
    # 16-byte boundary
    flat = words(4 * 15 + 1)
    cases.append(flat[1:].view(4, 3, 5))
    worst = 0
    for mats in cases:
        got = kernels.bitmap_and(mats)
        want = kernels.bitmap_and_reference(mats)
        torch.cuda.synchronize()
        worst = max(worst, int((got != want).sum()))
        if worst:
            raise AssertionError(f"bitmap_and != plain version at "
                                 f"{tuple(mats.shape)}")
    try:
        kernels.bitmap_and(words(2, 1024, 8).transpose(1, 2))
    except ValueError:
        pass
    else:
        raise AssertionError("bitmap_and took a non-contiguous input")
    log(f"kernel check: bitmap_and bit-exact to its plain version on "
        f"{len(cases)} shapes (k 1-8, B 1-4,096, an odd misaligned one); "
        f"a non-contiguous input refused | {card}")
    return worst


def uid_intersect_phase(bs, dev, card: str):
    """Phase 14: UID-intersect GB/s. Returns the device operands of each
    config for phase 17."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    records, operands = bs.uid_intersect_bench(runs=SET_RUNS, device=dev)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    for r in records:
        arms = r["member_mask_ms"]
        log(f"uid intersect {r['config']} {r['shape_a']} x {r['shape_b']}: "
            f"{r['ms']:.4f} ms = {r['device_gbps']:.3f} GB/s on the card "
            f"(CUDA events), CPU np.intersect1d {r['cpu_gbps']:.3f} GB/s, "
            f"{r['speedup']:.1f}x; member_mask binary search "
            f"{arms['searchsorted']:.4f} ms, co-sort {arms['cosort']:.4f} "
            f"ms | {card}")
    log(f"uid_intersect_gbps {max(r['device_gbps'] for r in records):.3f} "
        f"(best config); every pair = np.intersect1d; peak device memory "
        f"{peak_gb:.2f} GiB; phase {time.perf_counter() - t0:.1f} s | {card}")
    return operands


def and_67m_phase(bs, codec, setops, kernels, dev, card: str) -> dict:
    """Phase 16, second half: setops-and-67M through intersect_packs on
    the card. Returns the kernels line's entry of bitmap_and."""
    import cProfile
    import pstats

    t0 = time.perf_counter()
    lists = bs.and_lists()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packs = [codec.compress(x) for x in lists]
    comp_s = time.perf_counter() - t0
    n_blocks = 1 << (bs.AND_SPACE_BITS - 16)
    for p in packs:
        if len(p.keys) != n_blocks or \
                not bool((p.forms == codec.FORM_BITMAP).all()):
            raise AssertionError(f"setops-and-67M: {len(p.keys)} blocks, "
                                 f"forms {np.unique(p.forms).tolist()}")
    log(f"setops-and-67M: lists of {[len(x) for x in lists]} uids over "
        f"2^{bs.AND_SPACE_BITS} ({gen_s:.1f} s host), compressed to "
        f"{len(packs)} x {n_blocks} bitmap blocks, "
        f"{sum(p.nbytes for p in packs)} bytes ({comp_s:.1f} s host)")
    t0 = time.perf_counter()
    want = setops.intersect_many(lists)
    dense_s = time.perf_counter() - t0
    del lists

    # the main path: intersect_packs with the card as its device
    setops.intersect_packs(packs, device=dev)           # warm
    torch.cuda.synchronize()
    kernels.bitmap_and.launches = 0
    dev_s = []
    for _ in range(AND_RUNS):
        t0 = time.perf_counter()
        got = setops.intersect_packs(packs, device=dev)
        torch.cuda.synchronize()
        dev_s.append(time.perf_counter() - t0)
    launches = kernels.bitmap_and.launches
    if launches != AND_RUNS:
        raise AssertionError(f"{AND_RUNS} intersect_packs calls launched "
                             f"bitmap_and {launches} times")
    host_s = []
    for _ in range(AND_RUNS):
        t0 = time.perf_counter()
        host = setops.intersect_packs(packs)
        host_s.append(time.perf_counter() - t0)
    if not (np.array_equal(got, want) and np.array_equal(host, want)):
        raise AssertionError("setops-and-67M: intersect_packs on the card "
                             "!= intersect_many on the dense lists or the "
                             "host fold")
    log(f"setops-and-67M answer: {len(want)} uids = intersect_many on the "
        f"dense lists ({dense_s:.3f} s) = the host fold; bitmap_and "
        f"launched {launches} times in {AND_RUNS} calls")
    log(f"intersect_packs wall: card {np.mean(dev_s) * 1e3:.3f} ms "
        f"(s {[round(t, 4) for t in dev_s]}), host fold "
        f"{np.mean(host_s) * 1e3:.3f} ms (s {[round(t, 4) for t in host_s]}) "
        f"| {card}")
    profile_window(lambda: setops.intersect_packs(packs, device=dev), 1,
                   "intersect_packs call", card)
    prof = cProfile.Profile()
    prof.runcall(setops.intersect_packs, packs, device=dev)
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    total = sum(v[2] for v in stats.stats.values())
    log(f"host profile of one call (cProfile, {total * 1e3:.1f} ms "
        f"under the profiler), self time:")
    for (path, line, fn), (_, ncalls, tt, _, _) in rows:
        log(f"  {tt * 1e3:9.3f} ms {ncalls:7d} calls  "
            f"{os.path.basename(path)}:{line} {fn}")

    # the kernel alone at the main path's shape: the stacked words of
    # the 1,024 all-bitmap keys, as bitmap_and_device hands them over
    mats = torch.from_numpy(np.stack([
        np.stack([p.block_words(i) for i in range(n_blocks)])
        for p in packs]).view(np.int64)).to(dev)
    k, b, w = mats.shape
    err = int((kernels.bitmap_and(mats)
               != kernels.bitmap_and_reference(mats)).sum())
    if err:
        raise AssertionError("bitmap_and != plain version at the main "
                             "path's shape")
    two = mats[:2]
    fns = {"kernel": lambda: kernels.bitmap_and(mats),
           "plain": lambda: kernels.bitmap_and_reference(mats),
           "kernel k 2": lambda: kernels.bitmap_and(two),
           "torch.bitwise_and k 2": lambda: torch.bitwise_and(two[0],
                                                              two[1])}
    # a call as the caller sees it (CUDA events over back-to-back calls,
    # launch overhead included), and its device time alone with the
    # 50 MB L2 flushed before each call (40 MiB of words would stay
    # resident between calls)
    call_ms = {name: cuda_ms(fn, 50) for name, fn in fns.items()}
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    cold_ms = {name: device_ms_cold(fn, 20, flush)
               for name, fn in fns.items()}
    del flush
    bound = (k + 1) * b * w * 8 / HBM_BYTES_PER_S * 1e3
    log(f"bitmap_and at (k {k}, B {b}, W {w}), bound {bound:.4f} ms "
        f"(bytes), at k 2 {3 * b * w * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms; "
        f"ms a call back to back / alone from a flushed L2 (CUDA "
        f"events): " + ", ".join(
            f"{name} {call_ms[name]:.4f} / {cold_ms[name]:.4f}"
            for name in fns) + f" | {card}")
    # the call's device work, each part timed alone at its sizes by CUDA
    # events: the profile above can miss the upload (it did on an H100
    # with torch 2.11, after the BFS plane's profile)
    host_words = np.empty((k, b, w), np.int64)
    up_ms = cuda_ms(lambda: torch.from_numpy(host_words).to(dev), 5)
    res = kernels.bitmap_and(mats)
    down_ms = cuda_ms(lambda: res.cpu(), 5)
    busy = up_ms + cold_ms["kernel"] + down_ms
    wall_ms = np.mean(dev_s) * 1e3
    log(f"intersect_packs device work by parts: {up_ms:.4f} ms up, "
        f"{cold_ms['kernel']:.4f} ms kernel, {down_ms:.4f} ms down = "
        f"{busy:.4f} ms "
        f"of {wall_ms:.3f} ms wall, idle share {1 - busy / wall_ms:.4f} "
        f"| {card}")
    del mats, two, res
    return {"name": "bitmap_and", "route": "cuda",
            "source": "dgraph_tpu_torch/csrc/bitmap_and.cu",
            "replaces": "dgraph_tpu/ops/pallas_kernels.py:217",
            "launches": launches, "max_abs_err": err,
            "ms": cold_ms["kernel"], "plain_ms": cold_ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": cold_ms["torch.bitwise_and k 2"]}


def device_ms_cold(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of one call of `fn` with the L2 flushed before it:
    CUDA events right around each call, queued behind COLD_FILLS fills
    of `flush` (larger than the L2) that keep the card busy while the
    host queues the call, so no launch gap falls between the events."""
    fn()
    pairs = []
    for _ in range(reps):
        for _ in range(COLD_FILLS):
            flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def mergepath_phase(mergepath, operands, dev, card: str) -> None:
    """Phase 17: mergepath_intersect at the UID-intersect configs, pair by
    pair, against the batched uidvec.intersect of phase 14."""
    for pairs, da, db, want in operands:
        mergepath.mergepath_intersect(da[0], db[0], k=1024, hit_frac=1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # one timed pass over every pair, then its answers checked
        start.record()
        res = [mergepath.mergepath_intersect(da[i], db[i], k=1024,
                                             hit_frac=1)
               for i in range(da.shape[0])]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        got = torch.stack([o for o, _ in res])
        ovf = bool(torch.stack([f for _, f in res]).any())
        if not torch.equal(got, want) or ovf:
            raise AssertionError(f"mergepath_intersect != uidvec.intersect "
                                 f"(overflow {ovf}) at {tuple(da.shape)} x "
                                 f"{tuple(db.shape)}")
        nbytes = (da.numel() + db.numel()) * 4
        log(f"mergepath {tuple(da.shape)} x {tuple(db.shape)}, "
            f"{da.shape[0]} calls of k 1024, hit_frac 1: {ms:.3f} ms = "
            f"{nbytes / ms / 1e6:.3f} GB/s, = uidvec.intersect, no "
            f"overflow | {card}")


def setops_plane(dev, card: str) -> dict:
    """Phases 13-17: the sorted-UID set-algebra plane. Returns the
    kernels line's entry of bitmap_and."""
    from dgraph_tpu_torch.bench import setops as bs
    from dgraph_tpu_torch.ops import codec, kernels, mergepath, setops

    # -- 13. the kernel against its plain version --------------------------
    worst = check_bitmap_and(kernels, dev, card)

    # -- 14. UID-intersect GB/s --------------------------------------------
    operands = uid_intersect_phase(bs, dev, card)

    # -- 15. the k-way configs ---------------------------------------------
    t0 = time.perf_counter()
    for r in bs.kway_bench(runs=3, device=dev):
        log(f"k-way {r['sets']} x {r['set_size']}: union host "
            f"{r['union_kway_ms']:.3f} ms, card {r['union_device_ms']:.3f} "
            f"ms; intersect host {r['intersect_kway_ms']:.3f} ms, card "
            f"{r['intersect_device_ms']:.3f} ms (wall, best of 3, card = "
            f"host folds) | {card}")
    # the host folds' np.unique against a sort and an adjacent compare,
    # on the concatenation of the first config's union
    cat = np.concatenate(bs.kway_sets(8, 65_536, np.random.default_rng(7))[0])
    u_s, _ = bs.timed(lambda: np.unique(cat), 3, dev)
    s_s, _ = bs.timed(lambda: bs.sorted_unique(cat), 3, dev)
    log(f"host numpy {np.__version__} on {len(cat)} uint64: np.unique "
        f"{u_s * 1e3:.3f} ms, np.sort + adjacent compare {s_s * 1e3:.3f} ms; "
        f"k-way phase {time.perf_counter() - t0:.1f} s")

    # -- 16. the compressed sweep, then setops-and-67M ---------------------
    t0 = time.perf_counter()
    sweep = bs.setops_compressed_bench(runs=1)
    for r in sweep["records"]:
        log(f"compressed {r['mix']} n {r['set_size']} span 2^"
            f"{r['span_bits']}: dense {r['dense_intersect_ms']:.3f} ms, "
            f"decode+i {r['decode_then_intersect_ms']:.3f} ms, compressed "
            f"{r['compressed_intersect_ms']:.3f} ms; union dense "
            f"{r['dense_union_ms']:.3f} / compressed "
            f"{r['compressed_union_ms']:.3f} ms; bytes ratio "
            f"{r['bytes_ratio']:.2f}; bitmap blocks {r['bitmap_blocks']} "
            f"(host)")
    g = sweep["gate"]
    if not g["within_budget"]:
        raise AssertionError(f"selective gate lost: {g}")
    log(f"selective gate: probe {g['probe']} vs list {g['list']}: "
        f"decode+i {g['decode_then_intersect_ms']:.3f} ms, compressed "
        f"{g['compressed_intersect_ms']:.3f} ms, block skipping "
        f"{g['block_skip_speedup']:.1f}x (host); sweep "
        f"{time.perf_counter() - t0:.1f} s")
    entry = and_67m_phase(bs, codec, setops, kernels, dev, card)
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)

    # -- 17. merge-path ----------------------------------------------------
    t0 = time.perf_counter()
    mergepath_phase(mergepath, operands, dev, card)
    log(f"merge-path phase {time.perf_counter() - t0:.1f} s")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dgraph_tpu_torch import backend
    from dgraph_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = backend.default_device()
    card = backend.card_info()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {np.__version__}")
    build_kernels(_build, ["bucket_or", "score", "bitmap_and"])

    # the set-algebra plane runs before the vector plane: after the
    # vector plane's profiles, torch.profiler (torch 2.11, CUDA 12.8)
    # records no device activity for the rest of the process
    entries = []
    for plane in (bfs_plane, graph_plane, write_plane, setops_plane,
                  vector_plane):
        t0 = time.perf_counter()
        got = plane(dev, card)
        entries += got if isinstance(got, list) else [got] if got else []
        torch.cuda.empty_cache()
        log(f"{plane.__name__}: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": entries}))
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
