#!/usr/bin/env python3
"""Drive the port's planes once on one NVIDIA H100 and check them.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and g++; builds the port's
kernels and its host runtime from `dgraph_tpu_torch/csrc/` into
`build/dgraph_tpu_torch/`.
Phases, each of which fails the run:

1. card: name and power limit (nvidia-smi);
2. build: one nvcc per kernel source and g++ for the host runtime
   (csrc/native.cc), all started together, timed;
3. kernels against their plain PyTorch versions on the card, bit-exact:
   bucket_or over W in {1, 2, 3, 5, 128, 768, 1,100} (4-, 8- and 16-byte
   vectors, a partial last tile), degrees 1-6 and 16-17 (whole-row units
   and chunk units), a degree-1 bucket of 2^17 rows, 255-257 around a
   chunk, split rows of 3,000, a hub row of degree > 2^20, padding
   indices at the dummy row N and all-padding rows, each into a new
   tensor and into a slice of a larger one whose neighbours must stay
   (its rows off 8 or 16 bytes at odd W); the fused
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
   alone at W 768 beside its plain version, its whole-row bound, the
   bound a call summed over the level's calls, the rate at which it
   moves the rows it gathers (non-dummy indices x W x 4 bytes over its
   time) and the first design's times; then bucket_or at the reach
   path's own shape
   (48 queries, W 2) on that path's frontiers, each level's device time
   from a flushed L2 beside the host's time to queue its calls, the
   plain version and the whole-row bound;
7. where a batch's device time goes: torch.profiler over PIPE batches,
   self device time by kernel name and the device's idle share.

The vector search plane (similar_to), at bench_vectors.py's accelerator
regime: 1M x 128 float32, batch 256, k 10, cosine, TF32 off:

8. score_dot and score_int8 against their plain versions on the card,
   element by element within the reordering bound, every output also
   written through `out=` off 16 bytes: score_dot over b {1, 2, 3, 4,
   8, 16, 32, 64, 256, 257} and the crossover between its row and tile
   routes +-1 (row-route query tiles and passes; 257: two query tiles),
   d {16, 100, 128} x n {1, 777, 65,536, 262,144, 1,000,064}, d 37
   (rows off 16 bytes) and d 1024 (depth segments) at n {777, 65,536,
   262,144}; score_int8 over b {1, 3, 256, 257} at those shapes but
   262,144 rows; corpora that start off 16-byte alignment, and int8
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
   torch.matmul and its bound; then at the exact tier's shapes (one
   query over 262,144, 131,072, 65,536 and 16,384 rows, 256 over
   250,000 and 1M) on the plan's route and the other, beside the plain version,
   torch.matmul and the bound, and both routes over the batch at 262,144
   rows with the crossover they give (from a flushed L2);
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
about 267k RDF, plus 65,536 x 128 float32 embeddings (`gen_corpus`,
seed 0):

22. load: `GraphDB(device="cuda:0", plan_cache_size=0, wal_path=...)`
   takes the graph as RDF and the embeddings (`float32vector
   @index(vector)`) as JSON, in transactions of
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
   on the card, every predicate's dump_tablet bytes equal to the
   engine's before rollup; `save_snapshot` of the engine
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

The query plane, on the write plane's engine and state (plan cache
and planner as each phase says; `planner="static"` wherever launches
are counted):

27. golden conformance on the card: the golden movie graph at scale 1
   in `GraphDB(device="cuda:0", device_min_edges=1)` at the reference's
   defaults (plan cache 128, adaptive planner); all 75 golden queries
   equal tests/golden/expected under the golden suite's comparison, and
   every device tier the suite reaches (expand both ways, range, order
   pages and sorts, the count page, the fused page) moved;
28. the same 75 queries at scale 10 on the write plane's engine, on a
   CPU engine restored from its state and on its host path
   (`prefer_device=False`): equal data; each query's warm median of
   QUERY_REPS runs on the card and on the host path, by class of device
   tier, and where an analyzed run's time goes;
29. similar_to through `query()` on the embeddings (index from phase
   23), one request per query of phase 23: the quantized tier launches
   score_int8_lists once a request and nothing else, recall@10 >= 0.95
   against exact_topk_blocked, equal to the plain score_int8_lists; the
   exact device tier (`vec_quantized=False`) launches score_dot once a
   request, equal to the plain score_dot, its scores within rounding of
   float64 and its recall against knn.topk_host at least the two-stage
   target; `@filter(similar_to)` over `has(embedding)` takes the exact
   tier (score_dot once); p50 and p99 latency of each tier; each
   kernel's device time at a request's shape, and beside score_dot the
   rest of an exact request's device work (the corpus norms, the cosine
   epilogue, padding and mask, `_topk_ordered`);
30. pack algebra: LABEL_NODES fresh nodes with `label: string
   @index(term)` (words w0-w3 with probabilities 1/2, 1/2, 1/4, 1/4),
   bulk-loaded into the engine; every word's pack
   holds at least 8 BITMAP blocks on common keys; allofterms over 2, 3
   and 4 words, AND_REPS times each: one bitmap_and launch a query, the
   uids of a numpy oracle and of the plain bitmap_and; the kernel's time
   beside the query's;
31. `@recurse(depth: 3)` from 64 seeded films and `shortest` between 64
   seeded pairs through `query()` with the device tiers forced
   (device_min_edges=1): equal to the CPU engine and the host path,
   query_device_expand_total and query_device_sssp_total moved, timed
   beside the host path.

The multi-device plane (`parallel/`), on meshes whose entries all name
the one card (`make_mesh(devices=[cuda:0] * S)`: S logical shards, run
one after another on its stream), each phase inside the plane whose
state it reuses:

32. meshes: `make_mesh()` on the machine's cards has a `uid` axis of 1,
   and an engine on it takes the single-device expand and counts no
   sharded expand; `make_mesh(devices=[cuda:0] * 8)` is (2, 2, 2);
33. at the end of the graph-ops plane, on its graph: `build_sharded_
   adjacency` and `build_ring_adjacency` in 4 shards, their bytes on
   the card against memory_allocated; `expand_sharded_np` of phase 19's
   frontiers equal to the numpy union and `graph.expand`; `make_sharded_
   bfs` and `make_ring_bfs` at depth 3 from phase 20's seed sets equal
   to numpy_bfs level by level; each timed beside its single-device
   counterpart and a bytes bound;
34. `make_dist_query_step` on the (2, 2, 2) mesh over two tablets (the
   graph's edges and their reverse), a batch of 64 of phase 5's seed
   sets, with and without page (0, 10): counts and pages equal to a
   numpy oracle of dense masks over the CSR;
35. in the vector plane after phase 10: `sharded_topk` over 4 shards of
   phase 9's corpus launches score_dot 4 times a call, its top-10 equal
   to the same call with the plain score_dot and to the exact tier
   (flips within the bound), a keep mask too; `sharded_ivf_topk` on
   phase 10's index launches score_int8_lists 4 times a call, its ids
   and scores equal to `ivf.search`'s, with and without a keep mask;
   each timed beside its single-device counterpart, one shard's
   launches beside their plain versions and bounds;
36. after phase 31: the 75 goldens at scale 1 in `GraphDB(device=cuda:0,
   device_min_edges=1, mesh=<4 x cuda:0>, shard_min_edges=1)`, sharded
   expands both ways and the fused page on the mesh; the write plane's
   state restored into a mesh engine (static planner): its sharded
   tiles charged to the byte and evicted under half that budget, the 75
   goldens and phase 31's @recurse equal to the single-device engine,
   similar_to on the sharded_quantized tier (one score_int8_lists launch
   a shard whose slot range meets a probed list, answers equal to phase
   29's) and the sharded tier (4 score_dot launches a request), p50 and
   p99 of each.

The cold plane (cold storage and ingest), after phase 36 on the write
plane's engine, in build/cold_plane/ (removed at the end), run in the
order 37, 38, 39, 42, 40, 41:

37. `export_rdf` and `export_schema` of that engine to files;
   `bulk_load` of them into `GraphDB(store_dir, device=cuda:0)`, every
   predicate offloaded as its reduce finishes and no kernel launched;
   `rollup_all(0)` trains the vector index on the card (score_int8_lists
   once a calibration step); the trained tablet saved, `checkpoint()`,
   `close()`; RDF/s and vectors/s; `live_load` and `bulk_load` of the
   scale-1 golden RDF on the card give equal export lines;
38. the store reopened under a third of its tablets' approx_bytes with
   two prefetch workers and the adaptive planner: the 75 goldens, one
   cold pass, equal to phase 28's answers, with tablet loads and
   evictions;
39. reopened with the static planner and the default budget: phase 29's 256 similar_to requests
   on the quantized tier (one score_int8_lists launch a request, the
   index from the store) and the exact tier (one score_dot launch),
   equal to phase 29's answers; the vector tablet offloaded
   (memory_allocated before and after) and asked again alike;
   allofterms over the lazily loaded labels equal to phase 30's, one
   bitmap_and launch a query;
42. on 39's engine: a full backup to build/cold_plane/bk, a commit, an
   incremental backup; `restore` onto a fresh card engine and
   `restore_to_ts` at the full backup, dump_tablet bytes equal to the
   source's at each; the restored index answers similar_to with one
   score_int8_lists launch and no training;
40. reopened with `result_cache_entries=4096`: the goldens and the
   similar_to requests twice, the second pass all hits with no launch;
   a commit to `label` drops the entries that read it;
41. tools/bench_500m.py's S1-S5 at its widths (U 262,144 a group, follow
   16,384 x 448) over B500M_GROUPS seeded groups through bulkseed, under
   a budget below the sampled groups' working set with two prefetch
   workers: a cold pass, fused and staged arms, and the all-tiers-off
   postings oracle agree; p50 and p95 a shape.

The serving plane (`server/http`, `engine/batcher`, `server/grpc_api`,
`cli`), after phase 36 and before the cold plane, serving the write
plane's engine on the card:

43. `serve(db, port=0)`: the 75 golden queries at scale 10 POSTed to
   /query, each response's data equal to `query_json`'s in process; p50
   and p99 of a request over HTTP beside in-process `query()` and
   `query_json()`;
44. similar_to over HTTP, SERVE_SIMILAR requests on the quantized and
   the exact tier and SERVE_AND dense allofterms, one at a time: one
   score_int8_lists, score_dot or bitmap_and launch a request and no
   other kernel, answers equal to the same queries in process and to
   phases 29-30; each kernel at a served request's shapes against its
   plain version, bound and library call;
45. `serve(batch_window_us=...)`: SERVE_BATCH identical concurrent
   similar_to requests in one window execute once with one launch and
   16 bodies equal byte for byte; SERVE_BATCH distinct bindings run one
   after another on the leader, one launch each;
46. 408 through X-Dgraph-Deadline-Ms under the `executor.level`
   failpoint, 499 through /admin/cancel?traceId=, 429 under
   max_pending=1, `dgraph_queries_shed_total` and
   `dgraph_pending_queries` at /debug/prometheus_metrics;
47. where `grpc` imports, `api.Dgraph/Query` over the same AlphaServer
   (a golden and a similar_to request) equal to HTTP's; `python -m
   dgraph_tpu_torch version`; an `alpha` child with no --device:
   /alter, /mutate and /query over HTTP, its engine on the card (a new
   compute app in nvidia-smi, tiles in /state's deviceCache), stopped
   by SIGINT with exit 0.

The cluster plane (`cluster/`, `bench/spawn`, the CLI's `node`, `bulk`
and `rebalance`), after the serving plane and before the cold plane, on
the write plane's engine's state, in build/cluster/ (removed at the
end):

48. `save_snapshot` of that engine (the format `bulk --reduce-shards`
   writes a group); three `cluster.service.AlphaServer` replicas of
   group 1 in this process on localhost TCP, each booted from it with
   `db_kw={"device": cuda:0, "prefer_device": True}`: boot time and the
   bytes each charges the card, then the time to elect a leader;
49. through `cluster.client.ClusterClient`: the 75 goldens on the leader
   and on a follower, each equal to phase 28's; CLUSTER_SIMILAR
   similar_to requests a tier and CLUSTER_AND dense allofterms, one
   score_int8_lists, score_dot or bitmap_and launch a request and
   answers equal to phases 29-30's, each kernel at those shapes beside
   its plain version, bound and library call; BANK_TRANSFERS upsert
   transfers from BANK_CLIENTS clients through Raft, every acknowledged
   one read back from all three replicas and the balance total held;
   the leader closed: the time until a write commits on a new leader,
   writes after it and the goldens on both survivors; p50 and p99 of
   each kind of request beside the leader's engine in process;
50. `bench/spawn.ProcessCluster`: a Zero quorum of PROC_ZEROS and one
   group of three `python -m dgraph_tpu_torch node --device cuda:0`
   alphas with --wal, bulk-booted from 48's snapshot: quantized
   similar_to through `RoutedCluster` equal to phase 29's, with
   score_int8_lists launched in the alphas (their `stats` op); every
   alpha and no zero a compute app of the card; the leader SIGKILLed,
   written past, restarted from its WAL and caught up;
51. `bulk --reduce-shards 2` of the CLI child's graph (CLI_NODES nodes,
   CLI_EDGES edges), two groups booted from its outputs, a federated
   query across them equal to one engine's answer; `rebalance --once`
   moves a tablet, and the query again after the cutover.

The load plane (`bench/openloop`, `bench/workload`, `utils/lockcheck`,
`utils/racecheck`; tools/dgbench.py's and bench_queries.py
--concurrency's drives, copied here), last, in build/load/ (removed at
the end): the seeded LDBC-SNB-style workload of `Workload(WorkloadConfig(
seed=20260803, persons=2^17))` (2,359,296 quads, its default mix: 40%
short reads, 14% 2-hop and 6% 3-hop traversals, 7% similar_to over a
16-dim embedding, 13% counts, 20% inserts), generated, `bulk_load`ed
into `GraphDB(device=cuda:0, planner="static")` and rolled up, which
trains the embedding's index (score_int8_lists once a calibration
step, nothing launched by the load):

52. one alpha in process, as bench_queries.py --concurrency drives it:
   reads through `MicroBatcher(db, window_us=500, read_lock=...)`,
   writes on the engine under the write lock; a closed-loop probe of
   120 reads from 24 workers, then open-loop phases of 480 ops at 0.5,
   0.8 and 1.0 x the probed capacity with 24 workers (latency from the
   scheduled arrival), each with its launches set to 0 just before and
   read just after: every op ok, one score_int8_lists launch a
   similar_to op (their texts are distinct), no BFS kernel, and every
   7th read's data equal to its replay after quiescing; then a phase of
   240 ops at 0.5 x under the port's lockcheck and racecheck, its lock
   and batcher built after arming, failing on any violation;
53. tools/dgbench.py's cluster path: `ProcessCluster(groups=1,
   replicas=1, zeros=1, max_pending=48)` of `python -m dgraph_tpu_torch
   node --device cuda:0 --planner static`, bulk-booted from phase 52's
   engine's snapshot; dgbench's tablet claim, warmup, closed-loop probe
   and open-loop phases of 480 ops at 0.5 and 0.8 x capacity (deadline
   5 x the 400 ms SLO), its scoreboard, throughput at the SLO and
   parity replay (no mismatch, at least one read); score_int8_lists
   launched in the alpha (its `stats` op) at least once a similar_to op
   that reached it.

Every plane runs with the host runtime on (the default), its bindings'
call counts set to 0 just before it and read just after. Last, in
build/host/ (removed at the end):

54. the host runtime: the library loaded from build/dgraph_tpu_torch/;
   the write plane (with the query, serving, cluster and cold planes
   inside it) and the load plane took its branches (NativeWal,
   NativeKV, rdf_parse, tokenize_batch, json_rows, the gv codec, and
   query_flat_json_total moved; the cold plane's stores and phase 50's
   raft logs are NativeKV stores, checked in those phases); then, with
   the runtime on and switched off in turns (on, off, off, on):
   bulk_load RDF/s of the golden graph at scale 2 from a file (equal
   tablets), the 75 goldens' encode ms on a scale-1 card engine (equal
   data), and a fresh child's anonymous and file-backed RSS holding
   phase 41's seed (one bench_500m group) in a TabletStore, NativeKV
   against PyKV.

The planes run in the order BFS, graph ops, write path, queries,
serving, the cluster and cold storage, set algebra, vectors, load, the
host runtime. Each
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
# bucket_or's checks: 4-, 8- and 16-byte vectors, rows narrower than a
# warp (the reach path's W 2 at 48 queries), and 1,100 words, whose last
# tile of 32 vectors is partial
OR_WIDTHS = (1, 2, 3, 5, 128, 768, 1100)
REACH_QUERIES = 48
# bucket_or over phase 6's levels at W 768 with its first design (a block
# a row, 32 lanes along W), as this script measured it on an NVIDIA H100
# 80GB HBM3 at 700.00 W; printed beside the current times
OR_MS_FIRST = (16.640, 5.310, 5.314)
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
# score_int8's batches; 257 queries take two query tiles of score_dot's
# tile route
SCORE_CHECK_BATCHES = (1, 3, 256, 257)
# score_dot's (d, n): the above and the one-query paths' 262,144 rows
DOT_CHECK_SHAPES = [(d, n) for d in (16, 100, 128)
                    for n in (1, 777, 65_536, 262_144, 1_000_064)] + \
    [(d, n) for d in (37, 1024) for n in (777, 65_536, 262_144)]
# phase 9's route table: one query over 262,144 and 131,072 rows (the
# exact tier's shape when the write plane held that many embeddings),
# 65,536 (WRITE_VECS) and 16,384 (its sharded tier's shard);
# sharded_topk's shard and the bench batch
DOT_ROUTE_SHAPES = ((1, 262_144, 128), (1, 131_072, 128), (1, 65_536, 128),
                    (1, 16_384, 128), (256, 250_000, 128),
                    (256, 1_000_000, 128))
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
    """Phase 3: bucket_or against bucket_or_reference on the card, bit for
    bit, each shape also written into a slice of a larger tensor whose
    other rows must stay."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 40_000
    span = kernels.OR_SPAN
    # whole-row units on both sides of OR_ROW_MAX_D, a degree-1 bucket of
    # 2^17 rows, chunk units at and around OR_SPAN, split rows, a hub
    cases = [(20_000, d) for d in (1, 2, 3, 4, 6, kernels.OR_ROW_MAX_D,
                                   kernels.OR_ROW_MAX_D + 1)]
    cases += [(1 << 17, 1), (40, span - 1), (9, span), (9, span + 1),
              (3, 3_000), (1, (1 << 20) + 24)]
    worst = 0
    plans = set()
    for width in OR_WIDTHS:
        f = torch.randint(-2**31, 2**31, (n + 1, width), dtype=torch.int32,
                          device=dev, generator=gen)
        f[n] = 0                                     # dummy row
        for m, d in cases:
            nb = torch.randint(0, n + 1, (m, d), dtype=torch.int32,
                               device=dev, generator=gen)
            nb.view(-1)[::5] = n                     # padding entries
            if m > 7:
                nb[1::7] = n                         # all-padding rows
            want = kernels.bucket_or_reference(f, nb)
            got = kernels.bucket_or(f, nb)
            # the out= path: a slice inside a larger tensor, neighbours
            # kept; at an odd W its rows are off 8 and 16 bytes
            big = torch.full((m + 2, width), 7, dtype=torch.int32,
                             device=dev)
            kernels.bucket_or(f, nb, out=big[1:m + 1])
            torch.cuda.synchronize()
            for out in (got, big[1:m + 1]):
                plans.add(kernels.bucket_or_plan(
                    m, d, width, math.gcd(f.data_ptr(), out.data_ptr(),
                                          16))[:5])
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want) or \
                    not torch.equal(big[1:m + 1], want) or \
                    not bool((big[0] == 7).all() & (big[m + 1] == 7).all()):
                raise AssertionError(
                    f"bucket_or != plain version at W={width} M={m} D={d}")
            del want
        del f
    log(f"kernel check: bucket_or bit-exact to its plain version on W "
        f"{list(OR_WIDTHS)} x {len(cases)} shapes (D 1-17, 255-257, "
        f"3,000, the hub 2^20+24; a degree-1 bucket of 2^17 rows; "
        f"all-padding rows), {len(plans)} distinct plans (vec, lanes, "
        f"tiles, rows a unit, chunk), each into a new tensor and into a "
        f"slice of a larger one with its neighbours kept | {card}")
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


def calls_bound_ms(f, recs) -> float:
    """bucket_or's least time a call, summed over a level's calls: each
    call's distinct frontier rows, index table and output rows over the
    memory rate (one launch a bucket reuses no row across buckets)."""
    return sum(level_bound_ms(f, [rec]) for rec in recs)


def gathered_rows(f, recs) -> int:
    """A level's in-neighbour indices that are not the dummy row."""
    return sum(int((nb != f.shape[0] - 1).sum()) for nb, _ in recs)


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
    """Phase 2: one compiler per source, all started together: nvcc for
    each kernel source, g++ for the host runtime."""
    t0 = time.perf_counter()
    _build.build_all(names)
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'csrc/{_build.source_path(n).name}' for n in names)}"
        f" with nvcc (sm_90a) and g++, in parallel, in {build_s:.2f} s")
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


def reach_shape_levels(kernels, bg, bfs, badj, reach_seeds, dev,
                       card: str) -> None:
    """Phase 6, last: bucket_or at the reach path's own shape, 48 queries
    (W = 2) over the full buckets at each level, on that path's
    frontiers: device time from a flushed L2 (fills queued ahead outlast
    the host's queueing of the 42 calls, which is timed apart), against
    the plain version and the whole-row bound."""
    packed = bg.words_to_device(bg.uids_to_bits_batched(badj, reach_seeds),
                                dev)
    fronts = bg.make_bfs_bits_batched(badj, bfs.DEPTH)(packed)
    recs = [(b.in_nb, b.offset) for b in badj.buckets]
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    total = bound_total = 0.0
    for i, f in enumerate((packed,) + tuple(fronts[:-1])):
        outs = {}
        ms = {}
        for name, fn in (("kernel", kernels.bucket_or),
                         ("plain", kernels.bucket_or_reference)):
            out = outs[name] = torch.empty((badj.n_covered, f.shape[1]),
                                           dtype=torch.int32, device=dev)

            def one_pass(fn=fn, out=out):
                for nb, off in recs:
                    fn(f, nb, out=out[off:off + nb.shape[0]])

            ms[name] = timed_passes(one_pass, lambda: None,
                                    KERNEL_REPS if name == "kernel"
                                    else PLAIN_REPS, flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for nb, off in recs:
            kernels.bucket_or(f, nb, out=outs["kernel"][off:off +
                                                        nb.shape[0]])
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if not torch.equal(outs["kernel"], outs["plain"]):
            raise AssertionError(f"reach level {i + 1}: bucket_or != plain "
                                 f"version at W {f.shape[1]}")
        bound = level_bound_ms(f, recs)
        gathered = gathered_rows(f, recs)
        total += ms["kernel"]
        bound_total += bound
        log(f"reach level {i + 1}: bucket_or at W {f.shape[1]} "
            f"({len(reach_seeds)} queries), {len(recs)} calls over "
            f"{f.shape[0]} rows: {ms['kernel']:.4f} ms on the card from a "
            f"flushed L2 (the host queues the calls in {host_ms:.4f} ms), "
            f"plain {ms['plain']:.4f} ms, whole-row bound {bound:.4f} ms "
            f"(bytes), {gathered} gathered rows at "
            f"{gathered * f.shape[1] * 4 / ms['kernel'] / 1e9:.4f} TB/s | "
            f"{card}")
    log(f"reach levels 1-{bfs.DEPTH} at W {packed.shape[1]}: bucket_or "
        f"{total:.4f} ms, whole-row bound {bound_total:.4f} ms | {card}")


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
        b_calls = calls_bound_ms(f, recs)
        gathered = gathered_rows(f, recs)
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
        plan = kernels.bucket_or_plan(1, 1, f.shape[1], 16)
        log(f"level {i + 1}: bucket_or at W {f.shape[1]} {b_ms:.4f} ms "
            f"(first design {OR_MS_FIRST[i]:.3f}), whole-row bound "
            f"{b_bound:.4f} "
            f"ms (half {b_bound / 2:.4f}), bound a call summed over the "
            f"{len(recs)} calls {b_calls:.4f} ms; {gathered} gathered "
            f"rows, {gathered * f.shape[1] * 4 / 1e9:.3f} GB at "
            f"{gathered * f.shape[1] * 4 / b_ms / 1e9:.3f} TB/s; "
            f"{plan.ntiles} tile(s) of {plan.lanes} vectors of "
            f"{4 * plan.vec} bytes | {card}")
        del fr, vis, om
    log(f"levels 1-{len(levels)}: bucket_or_level {tot['ms']:.4f} ms, "
        f"unfused path {tot['unfused_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms; "
        f"bucket_or {tot['or_ms']:.4f} ms (first design "
        f"{sum(OR_MS_FIRST):.3f}), "
        f"whole-row bound {tot['or_bound_ms']:.4f} ms | {card}")
    del levels, flush
    reach_shape_levels(kernels, bg, bfs, badj, reach_seeds, dev, card)
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
    fronts = []
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
        fronts.append((fr, got))
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
    log(f"graph ops: peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB | {card}")
    mesh_graph_phases(dev, card, g, adj, fronts)
    GRAPH.clear()


# -- the multi-device plane (phases 32-36) ----------------------------------

# logical shards on the one card: S entries of cuda:0 in a mesh, as the
# reference's tests run theirs on 8 forced virtual host devices
MESH_SHARDS = 4
MESH_GRID = 8                      # phase 34's (data, tablet, uid) = (2, 2, 2)
MESH_BATCH = 64                    # phase 34's seed sets
MESH_PAGE = (0, 10)
MESH_REPS = 3


def mesh_of(dev, n: int, axes=("uid",)):
    from dgraph_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * n, axes=axes)


def host_ms(fn, reps: int) -> float:
    """Mean ms of one call of `fn` by the host clock, each call ended by
    a synchronize (one warm-up first): for paths whose boolean gathers
    wait on the card anyway."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_expand_bytes(host_adj, frontier: np.ndarray, out: int) -> int:
    """Bytes a sharded expand of `frontier` must move: every shard's
    source rows read once (the membership scan), the neighbour slots of
    the rows the frontier hits, the frontier and the output, 8 B each."""
    rows = slots = 0
    for b in host_adj.buckets:
        rows += b.src.size
        slots += int(np.isin(b.src, frontier).sum()) * b.degree
    return (rows + slots + len(frontier) + out) * 8


def mesh_graph_phases(dev, card: str, g: dict, adj, fronts) -> None:
    """Phases 32-34: meshes, the sharded graph and the distributed query
    step on the BFS plane's graph (its CSR, dict and seed sets),
    `fronts` being phase 19's frontiers with their single-device
    expands."""
    from dgraph_tpu_torch.bench import bfs
    from dgraph_tpu_torch.bench.setops import sorted_unique
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ops import graph, traverse
    from dgraph_tpu_torch.ops.uidvec import SENTINEL, from_numpy, pad_to
    from dgraph_tpu_torch.parallel import dist_graph as dg
    from dgraph_tpu_torch.parallel import dist_query as dq
    from dgraph_tpu_torch.parallel import make_mesh
    from dgraph_tpu_torch.utils import metrics

    csr = g["csr"]
    uniq_src, indptr, dst = csr
    t_plane = time.perf_counter()

    # -- 32. meshes ----------------------------------------------------------
    cards = make_mesh()
    grid = mesh_of(dev, MESH_GRID, ("data", "tablet", "uid"))
    if cards.shape["uid"] != torch.cuda.device_count() or \
            tuple(grid.shape.values()) != (2, 2, 2):
        raise AssertionError(f"meshes: {cards}, {grid}")
    small = GraphDB(device=dev, device_min_edges=1, mesh=cards,
                    shard_min_edges=1, plan_cache_size=0)
    small.alter("follows: [uid] .")
    rows = min(512, len(uniq_src))
    small.mutate(set_nquads="\n".join(
        f"<{int(s):#x}> <follows> <{int(d):#x}> ."
        for i, s in enumerate(uniq_src[:rows])
        for d in dst[indptr[i]:indptr[i + 1]][:16]))
    small.rollup_all(0)
    before = metrics.counters_snapshot()
    small.query("{ q(func: uid(%s)) { follows { uid } } }" % ", ".join(
        f"{int(s):#x}" for s in uniq_src[:8]))
    moved = metrics.counters_delta(before)
    if any(k.startswith("query_sharded_expand_total") for k in moved) or \
            moved.get('query_device_expand_total{dir="fwd"}', 0) <= 0:
        raise AssertionError(f"an engine on make_mesh()'s uid axis of "
                             f"{cards.shape['uid']} moved {moved}")
    log(f"meshes: make_mesh() on the machine's cards {dict(cards.shape)}; "
        f"GraphDB(mesh=that, shard_min_edges=1) took the single-device "
        f"expand and counted no sharded expand; make_mesh(devices=[cuda:0] "
        f"* {MESH_GRID}) {dict(grid.shape)} | {card}")
    del small

    # -- 33. sharded graph ---------------------------------------------------
    mesh = mesh_of(dev, MESH_SHARDS)
    built = {}
    for name, build in (("sharded", dg.build_sharded_adjacency),
                        ("ring", dg.build_ring_adjacency)):
        t0 = time.perf_counter()
        host = build(g["edges"], MESH_SHARDS)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        req0 = requested_bytes(dev)
        placed = host.put(mesh)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated(dev) - mem0
        asked = requested_bytes(dev) - req0
        nbytes, alloc = tile_alloc(placed)
        if asked != nbytes or placed.n_edges != len(dst) or \
                placed.n_dst != adj.n_dst:
            raise AssertionError(f"{name} adjacency: {placed.n_edges} "
                                 f"edges, {placed.n_dst} destinations, "
                                 f"{nbytes} bytes, requested {asked}, "
                                 f"allocated {grew}")
        built[name] = (host, placed)
        per_shard = [sum(int((b.src[i] != SENTINEL).sum())
                         for b in host.buckets) for i in range(MESH_SHARDS)]
        log(f"{name} adjacency of {len(uniq_src)} sources, {placed.n_edges}"
            f" edges in {MESH_SHARDS} shards: built in {build_s:.2f} s on "
            f"the host, {len(host.buckets)} buckets, sources a shard "
            f"{per_shard}; {nbytes / 2**30:.3f} GiB of int64 tensors on the "
            f"card, the allocator asked for {asked} bytes, memory_allocated "
            f"grew {grew} (512-byte blocks {alloc}) | {card}")
    host_s, sadj = built["sharded"]
    host_r, radj = built["ring"]
    out_size = pad_to(max(sadj.n_dst, 1))
    expand = dg.make_sharded_expand(mesh, sadj, out_size)
    for fr, single in fronts:
        got = dg.expand_sharded_np(mesh, sadj, fr.astype(np.uint64))
        want = csr_union(csr, fr, sorted_unique)
        if not (np.array_equal(got, want) and
                np.array_equal(got.astype(np.uint32), single)):
            raise AssertionError(f"sharded expand of {len(fr)} sources != "
                                 f"the numpy union and graph.expand")
        ft = from_numpy(fr.astype(np.uint32), pad_to(len(fr)), device=dev)
        out = graph.max_expansion(adj, pad_to(len(fr)))
        sh_ms = host_ms(lambda: expand(ft), MESH_REPS)
        one_ms = host_ms(lambda: graph.expand(adj, ft, out), MESH_REPS)
        b_ms = bound_ms(sharded_expand_bytes(host_s, fr, out_size))
        log(f"sharded expand of {len(fr)} sources over {MESH_SHARDS} shards:"
            f" {len(got)} uids = numpy union = graph.expand; {sh_ms:.3f} ms"
            f" a call against the single-device expand's {one_ms:.3f} ms "
            f"(host clock after synchronize; ratio {sh_ms / one_ms:.2f}), "
            f"bound {b_ms:.4f} ms (bytes: the shards' source rows, the hit "
            f"rows' neighbour slots, frontier and output, 8 B each) | "
            f"{card}")

    seeds, want_levels = g["reach"]
    depth = bfs.DEPTH
    sbfs = dg.make_sharded_bfs(mesh, sadj, 8, depth, out_size)
    block = pad_to(radj.n_dst + 8)
    rbfs = dg.make_ring_bfs(mesh, radj, 8, depth, block)
    per = -(-radj.space // MESH_SHARDS)
    for q, (s, want) in enumerate(zip(seeds, want_levels)):
        sv = from_numpy(s.astype(np.uint32), 8, device=dev)
        levels, n_last = sbfs(sv)
        rows_ = np.full((MESH_SHARDS, 8), SENTINEL, np.int64)
        for u in s:
            home = min(int(u) // per, MESH_SHARDS - 1)
            rows_[home, int((rows_[home] != SENTINEL).sum())] = int(u)
        ring_in = torch.from_numpy(np.sort(rows_, axis=1)).to(dev)
        rlevels, r_last = rbfs(ring_in)
        for lvl in range(depth):
            w = want[lvl].astype(np.int64)
            a = levels[lvl].cpu().numpy()
            b = rlevels[lvl].cpu().numpy().reshape(-1)
            if not (np.array_equal(a[a != SENTINEL], w) and
                    np.array_equal(np.sort(b[b != SENTINEL]), w)):
                raise AssertionError(f"seed set {q} level {lvl + 1}: "
                                     f"sharded or ring BFS != numpy_bfs")
        if int(n_last) != len(want[-1]) or int(r_last) != len(want[-1]):
            raise AssertionError(f"seed set {q}: reached counts "
                                 f"{int(n_last)}, {int(r_last)} != "
                                 f"{len(want[-1])}")
    sv = from_numpy(seeds[0].astype(np.uint32), 8, device=dev)
    single = traverse.make_bfs(adj, 8, depth)
    one_ms = host_ms(lambda: single(sv), MESH_REPS)
    sb_ms = host_ms(lambda: sbfs(sv), MESH_REPS)
    rb_ms = host_ms(lambda: rbfs(ring_in), MESH_REPS)
    fronts0 = [seeds[0]] + [x for x in want_levels[0][:-1]]
    bfs_b = sum(sharded_expand_bytes(host_s, f.astype(np.int64), out_size)
                for f in fronts0)
    log(f"sharded and ring BFS depth {depth} over {MESH_SHARDS} shards from "
        f"{len(seeds)} seed sets: every level = numpy_bfs (level sizes "
        f"{[len(x) for x in want_levels[0]]} for set 0; ring block "
        f"{block}); set 0: sharded {sb_ms:.3f} ms, ring {rb_ms:.3f} ms, "
        f"single-device make_bfs {one_ms:.3f} ms (host clock after "
        f"synchronize; ratios {sb_ms / one_ms:.2f}, {rb_ms / one_ms:.2f}), "
        f"bound {bound_ms(bfs_b):.4f} ms (bytes: each level's sharded "
        f"expand as above) | {card}")
    del built, host_s, sadj, host_r, radj, expand, sbfs, rbfs, single
    torch.cuda.empty_cache()

    # -- 34. distributed query step ------------------------------------------
    t0 = time.perf_counter()
    src_of = np.repeat(uniq_src, np.diff(indptr)).astype(np.int64)
    dst64 = dst.astype(np.int64)
    order = np.argsort(dst64, kind="stable")
    rdst, rsrc = dst64[order], src_of[order]
    cut = np.flatnonzero(np.diff(rdst)) + 1
    reverse = dict(zip(rdst[np.concatenate([[0], cut])].tolist(),
                       np.split(rsrc.astype(np.uint32), cut)))
    stack = dq.stack_tablets([g["edges"], reverse], grid.shape["uid"])
    stack_s = time.perf_counter() - t0
    del reverse
    raw = bfs.seed_matrices(uniq_src, 1, MESH_BATCH)
    seed_rows = np.full((MESH_BATCH, bfs.SEEDS), SENTINEL, np.int64)
    for b in range(MESH_BATCH):
        u = np.unique(raw[b])
        seed_rows[b, :len(u)] = u
    seeds_t = torch.from_numpy(seed_rows).to(dev)
    # the oracle: dense masks over the CSR, both directions
    n_uid = int(max(uniq_src.max(), dst.max())) + 1

    def hop(mask):
        out = np.zeros(n_uid, bool)
        out[dst64[mask[src_of]]] = True
        out[src_of[mask[dst64]]] = True
        return out

    t0 = time.perf_counter()
    want_n, want_pg = [], []
    for b in range(MESH_BATCH):
        m = np.zeros(n_uid, bool)
        m[seed_rows[b][seed_rows[b] != SENTINEL]] = True
        h1 = hop(m)
        both = np.flatnonzero(hop(h1) & h1)
        want_n.append(len(both))
        pg = np.full(MESH_PAGE[1], SENTINEL, np.int64)
        page = both[MESH_PAGE[0]:MESH_PAGE[0] + MESH_PAGE[1]]
        pg[:len(page)] = page
        want_pg.append(pg)
    oracle_s = time.perf_counter() - t0
    step = dq.make_dist_query_step(grid, stack, MESH_BATCH, bfs.SEEDS)
    paged = dq.make_dist_query_step(grid, stack, MESH_BATCH, bfs.SEEDS,
                                    page=MESH_PAGE)
    t0 = time.perf_counter()
    counts = step(seeds_t)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts2, pages = paged(seeds_t)
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    if not (np.array_equal(counts.cpu().numpy(), want_n) and
            np.array_equal(counts2.cpu().numpy(), want_n) and
            np.array_equal(pages.cpu().numpy(), np.stack(want_pg))):
        raise AssertionError("distributed query step: counts or pages != "
                             "the numpy oracle")
    log(f"distributed query step on the {dict(grid.shape)} mesh, tablets "
        f"= the graph's edges and their reverse (level cap "
        f"{stack.level_cap}; stacked in {stack_s:.1f} s on the host), "
        f"batch {MESH_BATCH} of phase 5's seed sets: counts |2-hop ∩ "
        f"1-hop| (median {int(np.median(want_n))}, max {max(want_n)}) and "
        f"the page {MESH_PAGE} = the numpy oracle ({oracle_s:.1f} s); "
        f"{step_s * 1e3 / MESH_BATCH:.2f} ms a query, paged "
        f"{paged_s * 1e3 / MESH_BATCH:.2f} ms (host clock, synchronized) "
        f"| {card}")
    log(f"multi-device graph phases 32-34: "
        f"{time.perf_counter() - t_plane:.1f} s | {card}")


def busy_shards(ix, lists: np.ndarray, shards: int) -> int:
    """Shards whose clustered-slot range meets a probed non-empty list:
    the launches of one sharded quantized stage (a shard with none
    launches nothing)."""
    li = np.unique(lists)
    per = -(-ix.n_rows // shards)
    return sum(bool((np.maximum(i * per, ix.starts[li]) <
                     np.minimum(min(ix.n_rows, (i + 1) * per),
                                ix.starts[li + 1])).any())
               for i in range(shards))


def probed_lists(ivf, ix, qs, nprobe, metric) -> np.ndarray:
    q_t = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(qs),
                                                np.float32)).to(ix.device)
    return ivf._probe(q_t, ix.centroids_dev, nprobe, metric)[1].cpu().numpy()


def mesh_kernel_entries(kernels, dev, card, label, path, dot_call,
                        dot_launches, lists_call, lists_launches
                        ) -> list[dict]:
    """The kernels line's entries of score_dot and score_int8_lists on a
    sharded path, timed at one shard's launch (`dot_call`: (rows,
    queries); `lists_call`: (codes, queries, table, out, kw))."""
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    rows, qv = dot_call
    dot_ms = device_ms_cold(lambda: kernels.score_dot(rows, qv), 20, flush)
    dot_plain = device_ms_cold(
        lambda: kernels.score_dot_reference(rows, qv), 20, flush)
    lib_ms = device_ms_cold(lambda: torch.matmul(qv, rows.T), 20, flush)
    derr, dratio = check_score(kernels.score_dot, kernels.score_dot_reference,
                               rows, qv, f"score_dot, {label}")
    dot_bound, dot_by = score_bound_ms([(rows, qv)])
    codes, qs, table, out, kw = lists_call
    int8_ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes, qs, table, out, **kw), 20, flush)
    plain_out = torch.empty_like(out)
    int8_plain = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes, qs, table, plain_out, **kw), 3)
    ierr, iratio = lists_within_bound(codes, qs, table, out, plain_out, kw,
                                      f"score_int8_lists, {label}")
    int8_bound, int8_by = lists_bound_ms(codes, qs, table)
    del flush
    log(f"  {label}, one shard's launches: score_dot ({qv.shape[0]} x "
        f"{rows.shape[0]} x {rows.shape[1]}, worst error/bound "
        f"{dratio:.4g}) {dot_ms:.4f} ms, plain {dot_plain:.4f} ms, "
        f"torch.matmul {lib_ms:.4f} ms, bound {dot_bound:.4f} ms ({dot_by}); "
        f"score_int8_lists ({len(table)} entries, worst error/bound "
        f"{iratio:.4g}) {int8_ms:.4f} ms, plain {int8_plain:.4f} ms, bound "
        f"{int8_bound:.4f} ms ({int8_by}) (device times from a flushed L2, "
        f"CUDA events) | {card}")
    return [
        {"name": "score_dot", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:123",
         "path": f"{path[0]} ({MESH_SHARDS} logical shards on one card)",
         "launches": dot_launches, "max_abs_err": derr, "ms": dot_ms,
         "plain_ms": dot_plain, "bound_ms": dot_bound, "bound_by": dot_by,
         "library_ms": lib_ms},
        {"name": "score_int8_lists", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
         "path": f"{path[1]} ({MESH_SHARDS} logical shards on one card)",
         "launches": lists_launches, "max_abs_err": ierr, "ms": int8_ms,
         "plain_ms": int8_plain, "bound_ms": int8_bound, "bound_by": int8_by,
         "library_ms": None}]


def mesh_vector_phase(dev, card: str, corpus, queries, exact_idx, ix,
                      tol: float) -> list[dict]:
    """Phase 35: sharded similar_to at the vector plane's 1M x 128, on
    phase 9's corpus and phase 10's index."""
    from dgraph_tpu_torch.ops import ivf, kernels, knn
    from dgraph_tpu_torch.parallel import dist_knn as dk

    t_phase = time.perf_counter()
    mesh = mesh_of(dev, MESH_SHARDS)
    block, n_real = dk.shard_corpus(mesh, corpus)

    def exact(mask=None):
        return dk.sharded_topk(mesh, block, queries, VEC_K, VEC_METRIC,
                               mask=mask, n_real=n_real)

    calls = MESH_REPS + 1
    exact()                                             # warm
    kernels.score_dot.launches = 0
    for _ in range(calls):
        got_i, _ = exact()
    dot_launches = kernels.score_dot.launches
    if dot_launches != MESH_SHARDS * calls:
        raise AssertionError(f"sharded_topk launched score_dot "
                             f"{dot_launches} times in {calls} calls")
    knn.score_dot = kernels.score_dot_reference
    try:
        plain_i, _ = exact()
    finally:
        knn.score_dot = kernels.score_dot
    p_flips = same_topk("sharded_topk vs plain", got_i, plain_i, corpus,
                        queries, VEC_METRIC, tol)
    e_flips = same_topk("sharded_topk vs the exact tier", got_i, exact_idx,
                        corpus, queries, VEC_METRIC, tol)
    keep = np.random.default_rng(35).random(len(corpus)) > 0.5
    corpus_dev = torch.from_numpy(corpus).to(dev)
    keep_i, _ = exact(keep)
    want_k, _ = knn.topk_device(corpus_dev, queries, VEC_K, VEC_METRIC,
                                mask=keep, two_stage=False)
    k_flips = same_topk("sharded_topk vs the exact tier, keep mask", keep_i,
                        want_k, corpus, queries, VEC_METRIC, tol)
    if not keep[keep_i].all():
        raise AssertionError("sharded_topk returned a masked row")
    sh_ms = host_ms(exact, MESH_REPS)
    one_ms = host_ms(lambda: knn.topk_device(
        corpus_dev, queries, VEC_K, VEC_METRIC, two_stage=False), MESH_REPS)
    log(f"sharded_topk over {MESH_SHARDS} shards of {block[0].shape[0]} rows"
        f" (batch {len(queries)}, k {VEC_K}, {VEC_METRIC}): score_dot launched "
        f"{dot_launches} times in {calls} calls; top-{VEC_K} = the plain "
        f"score_dot's ({p_flips} flips) = the exact tier's ({e_flips} "
        f"flips), keep mask = the exact tier's ({k_flips} flips), all "
        f"within {tol:.3g}; {sh_ms:.3f} ms a call against the single-device"
        f" exact tier's {one_ms:.3f} ms (host clock after synchronize; "
        f"ratio {sh_ms / one_ms:.2f}) | {card}")
    del corpus_dev

    tables = []

    def recorded(codes, qs, table, out, **kw):
        tables.append((codes, qs, table, out, kw))
        return kernels.score_int8_lists(codes, qs, table, out, **kw)

    def quant(keep_=None):
        return dk.sharded_ivf_topk(mesh, ix, corpus, queries, VEC_K,
                                   VEC_METRIC, keep=keep_)

    busy = busy_shards(ix, probed_lists(ivf, ix, queries, ix.nprobe,
                                        VEC_METRIC), MESH_SHARDS)
    ivf.score_int8_lists = recorded
    try:
        quant()                                         # warm
        kernels.score_int8.launches = 0
        for _ in range(calls):
            qi_, qs_ = quant()
        int8_launches = kernels.score_int8.launches
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    if int8_launches != busy * calls or busy != MESH_SHARDS:
        raise AssertionError(f"sharded_ivf_topk launched score_int8_lists "
                             f"{int8_launches} times in {calls} calls over "
                             f"{busy} busy shards")
    wi, ws = ivf.search(ix, corpus, queries, VEC_K, VEC_METRIC)
    ki, ks = quant(keep)
    kwi, kws = ivf.search(ix, corpus, queries, VEC_K, VEC_METRIC, keep=keep)
    if not (np.array_equal(qi_, wi) and np.array_equal(qs_, ws) and
            np.array_equal(ki, kwi) and np.array_equal(ks, kws)):
        raise AssertionError("sharded_ivf_topk != ivf.search")
    sq_ms = host_ms(quant, MESH_REPS)
    oq_ms = host_ms(lambda: ivf.search(ix, corpus, queries, VEC_K,
                                       VEC_METRIC), MESH_REPS)
    log(f"sharded_ivf_topk over {MESH_SHARDS} slot ranges (nprobe "
        f"{ix.nprobe}): score_int8_lists launched {int8_launches} times in "
        f"{calls} calls, one a shard; ids and scores = ivf.search's, with "
        f"and without a keep mask; {sq_ms:.3f} ms a call against "
        f"ivf.search's {oq_ms:.3f} ms (host clock after synchronize; ratio "
        f"{sq_ms / oq_ms:.2f}) | {card}")
    q_dev = torch.from_numpy(queries).to(dev)
    entries = mesh_kernel_entries(
        kernels, dev, card, "phase 35", (
            "parallel.dist_knn.sharded_topk",
            "parallel.dist_knn.sharded_ivf_topk"),
        (block[0], q_dev), dot_launches, tables[-1], int8_launches)
    log(f"sharded similar_to phase 35: {time.perf_counter() - t_phase:.1f} "
        f"s | {card}")
    return entries


def recurse_roots(db):
    """Phase 31's seeded films (the first draw of its generator), and the
    generator for its shortest pairs."""
    rng = np.random.default_rng(31)
    films = np.asarray(sorted(db.tablets["starring"].edges), np.int64)
    return rng, films, rng.choice(films, RECURSE_ROOTS, replace=False)


def mesh_engine_phase(dev, card: str, db, golden, state: dict,
                      single_quant: list, lits: list, root_q: str
                      ) -> list[dict]:
    """Phase 36: GraphDB(mesh=...) on the card: the goldens at scale 1
    and, on the write plane's state, at scale 10 with @recurse and
    similar_to on both sharded tiers; the sharded tiles' budget."""
    from dgraph_tpu_torch import wire
    from dgraph_tpu_torch.engine import device_cache as dc
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ops import ivf, kernels, knn
    from dgraph_tpu_torch.storage import snapshot
    from dgraph_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    mesh = mesh_of(dev, MESH_SHARDS)
    sharded = ('query_sharded_expand_total{dir="fwd"}',
               'query_sharded_expand_total{dir="rev"}')

    # scale 1, every predicate sharded, every device tier forced
    schema1, lines1 = golden_dataset().generate(1)
    gdb = GraphDB(device=dev, device_min_edges=1, mesh=mesh,
                  shard_min_edges=1)
    gdb.alter(schema_text=schema1)
    gdb.mutate(set_nquads="\n".join(lines1))
    before = metrics.counters_snapshot()
    t0 = time.perf_counter()
    bad = [name for name, text, want in golden
           if not json_close(gdb.query(text)["data"], want)]
    g1_s = time.perf_counter() - t0
    moved = metrics.counters_delta(before)
    if bad or any(moved.get(c, 0) <= 0 for c in
                  sharded + ("query_fused_dispatch_total",)):
        raise AssertionError(f"mesh engine at scale 1: drifted {bad}, "
                             f"counters {moved}")
    log(f"mesh engine at scale 1: GraphDB(device=cuda:0, device_min_edges=1,"
        f" mesh={dict(mesh.shape)} of cuda:0, shard_min_edges=1), all "
        f"{len(golden)} goldens equal tests/golden/expected in {g1_s:.2f} s;"
        f" sharded expands fwd {moved[sharded[0]]:g} rev "
        f"{moved[sharded[1]]:g}, fused pages through the mesh's executable "
        f"{moved['query_fused_dispatch_total']:g} | {card}")
    del gdb

    # scale 10: the write plane's state in a mesh engine
    t0 = time.perf_counter()
    mdb = snapshot.restore_state(
        wire.loads(wire.dumps(snapshot.dump_state(db))),
        GraphDB(device=dev, plan_cache_size=0, planner="static", mesh=mesh,
                shard_min_edges=1, vec_index_min_rows=WRITE_VECS // 2), dev)
    restore_s = time.perf_counter() - t0

    # the sharded tiles, charged to the byte, then evicted under budget
    ts = mdb.coordinator.max_assigned()
    uid_preds = sorted(p for p, t in mdb.tablets.items() if t.is_uid)
    builds = [(False, p) for p in uid_preds if mdb.tablets[p].edges] + \
        [(True, p) for p in uid_preds
         if mdb.tablets[p].schema.reverse and mdb.tablets[p].reverse]
    if mdb.device_cache.bytes:
        raise AssertionError("tiles resident in a restored engine")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    tiles = {}
    for rev, p in builds:
        tiles[(rev, p)] = dc.device_sharded_adjacency(
            mdb, mdb.tablets[p], ts, reverse=rev)
        if tiles[(rev, p)] is None:
            raise AssertionError(f"no sharded tile for {p} (reverse {rev})")
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(dev)
    sizes = {k: tile_alloc(v) for k, v in tiles.items()}
    tensor_bytes = sum(s[0] for s in sizes.values())
    alloc_bytes = sum(s[1] for s in sizes.values())
    if mdb.device_cache.bytes != tensor_bytes or \
            not tensor_bytes <= mem1 - mem0 <= alloc_bytes:
        raise AssertionError(f"sharded tiles: charged "
                             f"{mdb.device_cache.bytes}, hold {tensor_bytes},"
                             f" memory_allocated grew {mem1 - mem0}")
    order = list(tiles)
    del tiles
    budget = mdb.device_cache.budget
    mdb.device_cache.budget = tensor_bytes // 2
    gone_before = set(mdb.device_cache._entries)
    torch.cuda.synchronize()
    mem_a = torch.cuda.memory_allocated(dev)
    extra = dc.device_bitadjacency(mdb, mdb.tablets["genre"], ts)
    extra_alloc = tile_alloc(extra)[1]
    del extra
    torch.cuda.synchronize()
    freed = mem_a + extra_alloc - torch.cuda.memory_allocated(dev)
    gone = gone_before - set(mdb.device_cache._entries)
    attr = {False: "_device_sadj", True: "_device_sadj_r"}
    named = [(rev, p) for rev, p in order
             if (id(mdb.tablets[p]), attr[rev]) in gone]
    if not named or named != order[:len(named)] or any(
            getattr(mdb.tablets[p], attr[rev]) is not None
            for rev, p in named) or not \
            sum(sizes[k][0] for k in named) <= freed <= \
            sum(sizes[k][1] for k in named):
        raise AssertionError(f"sharded tiles under budget "
                             f"{tensor_bytes // 2}: evicted {named}, freed "
                             f"{freed}")
    mdb.device_cache.budget = budget
    log(f"mesh engine at scale {GOLDEN_SCALE}: the write plane's state "
        f"restored into GraphDB(mesh={dict(mesh.shape)}, shard_min_edges=1,"
        f" planner static) in {restore_s:.1f} s; {len(order)} sharded tiles "
        f"({len(uid_preds)} predicates and their reverses) charged "
        f"{tensor_bytes} bytes = their tensors', memory_allocated grew "
        f"{mem1 - mem0} (512-byte blocks {alloc_bytes}); under half that "
        f"budget one more tile evicted the {len(named)} oldest and freed "
        f"{freed} bytes on the card | {card}")

    # the goldens and @recurse against the single-device engine
    before = metrics.counters_snapshot()
    rows = []
    for name, text, _ in golden:
        if mdb.query(text)["data"] != db.query(text)["data"]:
            raise AssertionError(f"{name} at scale {GOLDEN_SCALE}: mesh "
                                 f"engine != single-device engine")
        mesh_ms = median_ms(lambda: mdb.query(text), QUERY_REPS)
        one_ms = median_ms(lambda: db.query(text), QUERY_REPS)
        rows.append((mesh_ms, one_ms))
    _, _, roots = recurse_roots(db)
    for r in roots:
        text = RECURSE_Q % int(r)
        if mdb.query(text)["data"] != db.query(text)["data"]:
            raise AssertionError(f"@recurse from {int(r):#x}: mesh engine "
                                 f"!= single-device engine")
    moved = metrics.counters_delta(before)
    if any(moved.get(c, 0) <= 0 for c in sharded):
        raise AssertionError(f"mesh engine at scale {GOLDEN_SCALE}: "
                             f"counters {moved}")
    r = np.asarray(rows)
    log(f"mesh engine at scale {GOLDEN_SCALE}: all {len(golden)} goldens and"
        f" @recurse from phase 31's {len(roots)} films equal the "
        f"single-device engine's data; sharded expands fwd "
        f"{moved[sharded[0]]:g} rev {moved[sharded[1]]:g}; sums of warm "
        f"medians of {QUERY_REPS} runs {r[:, 0].sum():.3f} ms on the mesh "
        f"engine, {r[:, 1].sum():.3f} ms single-device (host clock) | "
        f"{card}")

    # similar_to on both sharded tiers
    ix = mdb.tablets["embedding"].vector_ivf()
    if ix is None or ix.device != dev:
        raise AssertionError("the restored engine lost the index")
    nprobe = min(ix.nlist, int(mdb.vec_nprobe or ix.nprobe))
    last = {}

    def recorded(fn, key):
        def run(*args, **kw):
            last[key] = (args, kw)
            return fn(*args, **kw)
        return run

    vecs, queries = state["vecs"], state["queries"]
    tol = (WRITE_DIM + 4) * 2.0 ** -24
    lat = {"sharded_quantized": [], "sharded": []}
    launched = {"sharded_quantized": 0, "sharded": 0}
    full = 0
    host_idx, _ = knn.topk_host(vecs, queries, SIMILAR_K, VEC_METRIC)
    exact_rows = []
    ivf.score_int8_lists = recorded(kernels.score_int8_lists, "int8")
    knn.score_dot = recorded(kernels.score_dot, "dot")
    try:
        for tier, quantized in (("sharded_quantized", True),
                                ("sharded", False)):
            mdb.vec_quantized = quantized
            for i, lit in enumerate(lits):
                text = root_q % (SIMILAR_K, lit)
                want_l = busy_shards(ix, probed_lists(
                    ivf, ix, queries[i], nprobe, VEC_METRIC),
                    MESH_SHARDS) if quantized else MESH_SHARDS
                reset_launches(kernels)
                t0 = time.perf_counter()
                res = mdb.query(text, explain="analyze" if i == 0 else None)
                lat[tier].append((time.perf_counter() - t0) * 1e3)
                only_launched(f"{tier} request {i}", launches_of(kernels),
                              "score_int8" if quantized else "score_dot",
                              want_l)
                launched[tier] += want_l
                full += quantized and want_l == MESH_SHARDS
                if i == 0:
                    vd = res["extensions"]["explain"]["tiers"]["vector"]
                    if not vd or vd[0]["tier"] != tier:
                        raise AssertionError(f"EXPLAIN tier {vd}")
                out = res["data"]["q"]
                if quantized and out != single_quant[i]:
                    raise AssertionError(f"sharded_quantized request {i} "
                                         f"!= the single-device engine's")
                if not quantized:
                    exact_rows.append([int(x["uid"], 16) - VEC_UID0
                                       for x in out])
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
        knn.score_dot = kernels.score_dot
        mdb.vec_quantized = True
    flips = same_topk("sharded tier vs float64 topk_host",
                      np.asarray(exact_rows, np.int64), host_idx, vecs,
                      queries, VEC_METRIC, tol)
    log(f"similar_to on the mesh engine, {len(lits)} requests a tier on the "
        f"{WRITE_VECS} x {WRITE_DIM} embeddings: sharded_quantized (nprobe "
        f"{nprobe}) launched score_int8_lists once a shard whose slot range "
        f"meets a probed list ({launched['sharded_quantized']} in all; "
        f"{full} of {len(lits)} requests on all {MESH_SHARDS} shards), "
        f"answers = the single-device engine's; sharded (vec_quantized="
        f"False) launched score_dot {MESH_SHARDS} times a request, top-"
        f"{SIMILAR_K} = float64 topk_host ({flips} flips within {tol:.3g}) "
        f"| {card}")
    for tier, ms in lat.items():
        log(f"  {tier} tier, single request latency (host clock): p50 "
            f"{pct(ms, 50):.3f} ms, p99 {pct(ms, 99):.3f} ms | {card}")
    (codes, qs, table, out), kw = last["int8"]
    (rows_, qv), _ = last["dot"]
    entries = mesh_kernel_entries(
        kernels, dev, card, "phase 36, a request", (
            "GraphDB(mesh).query -> similar_to sharded tier -> "
            "parallel.dist_knn.sharded_topk",
            "GraphDB(mesh).query -> similar_to sharded_quantized tier -> "
            "parallel.dist_knn.sharded_ivf_topk"),
        (rows_, qv), launched["sharded"], (codes, qs, table, out, kw),
        launched["sharded_quantized"])
    del mdb
    log(f"mesh engine phase 36: {time.perf_counter() - t_phase:.1f} s | "
        f"{card}")
    return entries


# -- the engine's write-path plane (phases 22-26) ---------------------------

GOLDEN_SCALE = 10                  # tests/golden/dataset.py: ~267k RDF
WRITE_BATCH = 1000                 # N-Quads a transaction (dgraph live)
WRITE_VECS = 1 << 16               # half the engine's default
                                   # vec_index_min_rows; the planes'
                                   # engines train at half of this
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


def requested_bytes(dev) -> int:
    """Bytes the live tensors on `dev` asked the caching allocator for:
    memory_allocated before its rounding, and before it hands out a
    cached block up to 1 MiB larger than a request whole, which makes
    memory_allocated's growth depend on what earlier phases freed."""
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


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


def write_plane(dev, card: str) -> list[dict]:
    """Phases 22-26: the engine's write path (`engine/db.GraphDB` over
    `storage/`, `cdc/`, `wire/`) on the card, its WAL and snapshot in a
    scratch directory under build/; then phases 27-31, the query path,
    on the same engine and state, phases 43-47, the serving plane, on the
    same engine, phases 48-51, the cluster, on its state, and phases
    37-42, the cold plane, on its export. Returns the kernels line's
    entries of score_int8_lists as rollup drives it, and of
    score_int8_lists, score_dot and bitmap_and as queries drive them: in
    process, over HTTP, through Raft and through the store."""
    import shutil

    work = os.path.join(REPO, "build", "write_plane")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        entry, state = write_phases(dev, card, work)
        log(f"write path phases: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries = query_plane(dev, card, state)
        log(f"query plane: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries += serving_plane(dev, card, state)
        log(f"serving plane: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries += cluster_plane(dev, card, state)
        log(f"cluster plane: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries += cold_plane(dev, card, state)
        log(f"cold plane: {time.perf_counter() - t0:.1f} s")
        return [entry] + entries
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_phases(dev, card: str, work: str) -> tuple[dict, dict]:
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
    # @index(vector): similar_to at a query's root (phase 29) needs it;
    # its tokenizer writes no index tokens
    db.alter(schema + "embedding: float32vector @index(vector) .\n")
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
    # the card only: the CPU's replay (17.70 s beside an H100 80GB HBM3)
    # gave its time to the cluster plane; the CPU tests replay WALs
    # through both packages
    t0 = time.perf_counter()
    other = GraphDB(device=dev, plan_cache_size=0, wal_path=wal,
                    vec_index_min_rows=WRITE_VECS // 2)
    replay_s = time.perf_counter() - t0
    same_dumps(f"WAL replay on {dev}", tablet_dumps(
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
        f"into a fresh GraphDB on the card {replay_s:.2f} s "
        f"({n_rec / replay_s:.0f} edges/s); every predicate's dump_tablet bytes equal the engine's before "
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
    torch.cuda.empty_cache()
    return {"name": "score_int8_lists", "route": "cuda",
            "source": "dgraph_tpu_torch/csrc/score.cu",
            "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
            "path": "GraphDB.rollup_all -> vecstore.build_ivf -> "
                    "ivf._calibrate",
            "launches": launches, "max_abs_err": err, "ms": int8_ms,
            "plain_ms": plain_ms, "bound_ms": int8_bound,
            "bound_by": int8_by, "library_ms": None}, \
        {"db": db, "vecs": vecs, "queries": queries, "exact": exact}


# -- the query plane (phases 27-31) -----------------------------------------

QUERY_REPS = 5                     # warm runs of a golden query at scale 10
SIMILAR_K = 10
# phase 30: 2^19 fresh nodes from a block-aligned uid, so their 8 blocks
# of 65,536 uids are whole (the device AND's floor); words w0-w3 each
# with its own probability (PERF.md's setops-and-67M shape)
LABEL_NODES = 1 << 19
LABEL_UID0 = 1 << 25
LABEL_WORDS = (("w0", 0.5), ("w1", 0.5), ("w2", 0.25), ("w3", 0.25))
AND_REPS = 64
DEVICE_AND_KEYS = 8                # setops._DEVICE_MIN_BLOCKS
RECURSE_ROOTS = 64
# filtered children: a filtered recurse expands each level in one batch
# (the device expand); an unfiltered one reads per parent
RECURSE_Q = ("{ r(func: uid(%#x)) @recurse(depth: 3) { uid "
             "~director.film @filter(has(director.film)) "
             "director.film @filter(has(name)) "
             "starring @filter(has(performance.actor)) } }")
SHORTEST_PAIRS = 64
# the device tiers the golden suite reaches with device_min_edges=1
GOLDEN_TIERS = ('query_device_expand_total{dir="fwd"}',
                'query_device_expand_total{dir="rev"}',
                "query_device_range_total", "query_device_sort_page_total",
                "query_device_multisort_total",
                "query_device_count_page_total", "query_fused_dispatch_total")


def json_close(a, b) -> bool:
    """The golden suite's comparison (tests/test_golden.py _json_close):
    floats within a relative 1e-9, everything else exact; ints and
    floats never cross-match."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(json_close(v, b[k])
                                            for k, v in a.items())
    if isinstance(a, list):
        return len(a) == len(b) and all(json_close(x, y)
                                        for x, y in zip(a, b))
    return a == b


def golden_queries() -> list[tuple[str, str, dict]]:
    """(name, text, expected data) of tests/golden/queries/*.gql, read
    by path."""
    qdir = os.path.join(REPO, "tests", "golden", "queries")
    edir = os.path.join(REPO, "tests", "golden", "expected")
    out = []
    for f in sorted(os.listdir(qdir)):
        if f.endswith(".gql"):
            with open(os.path.join(qdir, f)) as fh:
                text = fh.read()
            with open(os.path.join(edir, f[:-4] + ".json")) as fh:
                out.append((f[:-4], text, json.load(fh)))
    return out


def launches_of(kernels) -> dict:
    return {f.__name__: f.launches for f in (
        kernels.bucket_or, kernels.bucket_or_level, kernels.score_dot,
        kernels.score_int8, kernels.bitmap_and)}


def only_launched(label: str, got: dict, name: str, n: int) -> None:
    """`name` launched exactly n times and every other kernel 0."""
    want = {k: (n if k == name else 0) for k in got}
    if name not in got or got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def median_ms(fn, reps: int) -> float:
    """Median host ms of `reps` calls of `fn` (which ends on the host:
    a query returns host data)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def vector_literal(row) -> str:
    return "[" + ",".join("%.9g" % x for x in row.tolist()) + "]"


def query_plane(dev, card: str, state: dict) -> list[dict]:
    """Phases 27-31: the query path (`GraphDB.query` over `query/`) on
    the card, on the write plane's engine and state. Returns the kernels
    line's entries of score_int8_lists, score_dot and bitmap_and as
    queries drive them."""
    from dgraph_tpu_torch import wire
    from dgraph_tpu_torch.bench import vectors as bv
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ops import ivf, kernels, knn, setops
    from dgraph_tpu_torch.storage import snapshot
    from dgraph_tpu_torch.utils import metrics

    # -- 27. golden conformance on the card --------------------------------
    ds = golden_dataset()
    schema1, lines1 = ds.generate(1)
    gdb = GraphDB(device=dev, device_min_edges=1)
    gdb.alter(schema_text=schema1)
    gdb.mutate(set_nquads="\n".join(lines1))
    golden = golden_queries()
    reset_launches(kernels)
    before = metrics.counters_snapshot()
    t0 = time.perf_counter()
    bad = [name for name, text, want in golden
           if not json_close(gdb.query(text)["data"], want)]
    golden_s = time.perf_counter() - t0
    tiers = metrics.counters_delta(before)
    if bad:
        raise AssertionError(f"golden queries on the card drifted: {bad}")
    missing = [c for c in GOLDEN_TIERS if tiers.get(c, 0) <= 0]
    if missing:
        raise AssertionError(f"golden queries on the card never reached "
                             f"{missing}")
    dev_counters = {k: v for k, v in sorted(tiers.items())
                    if "device" in k or "fused" in k}
    log(f"golden conformance on the card: {len(golden)} queries at scale 1 "
        f"through GraphDB(device=cuda:0, device_min_edges=1), plan cache "
        f"128, planner {gdb.planner}, each equal to tests/golden/expected "
        f"(floats within 1e-9) in {golden_s:.2f} s; device counters "
        f"{dev_counters}; kernel launches {launches_of(kernels)} | {card}")
    del gdb

    # -- 28. the golden queries at scale 10 --------------------------------
    db = state["db"]
    t0 = time.perf_counter()
    cpu = snapshot.restore_state(
        wire.loads(wire.dumps(snapshot.dump_state(db))),
        GraphDB(device="cpu", plan_cache_size=0,
                vec_index_min_rows=WRITE_VECS // 2), "cpu")
    copy_s = time.perf_counter() - t0
    rows = []
    classes: dict[str, list] = {}
    split = {"parse": 0.0, "execute": 0.0, "encode": 0.0}
    stage_by_tier: dict[str, float] = {}
    reset_launches(kernels)
    for name, text, _ in golden:
        db.prefer_device = True
        before = metrics.counters_snapshot()
        on_card = db.query(text)
        moved = sorted(k.split("{")[0] for k, v in metrics.counters_delta(
            before).items() if ("device" in k or "fused" in k) and v)
        on_cpu = cpu.query(text)["data"]
        db.prefer_device = False
        host = db.query(text)["data"]
        if not (on_card["data"] == on_cpu == host):
            raise AssertionError(f"{name} at scale {GOLDEN_SCALE}: card, "
                                 f"CPU and host path differ")
        state.setdefault("golden10", {})[name] = on_card["data"]
        host_ms = median_ms(lambda: db.query(text), QUERY_REPS)
        db.prefer_device = True
        card_ms = median_ms(lambda: db.query(text), QUERY_REPS)
        ex = db.query(text, explain="analyze")
        lat = ex["extensions"]["latency"]
        split["parse"] += lat["parsing_ns"] / 1e6
        split["execute"] += lat["processing_ns"] / 1e6
        split["encode"] += lat["encoding_ns"] / 1e6
        for st in ex["extensions"]["explain"]["stages"]:
            if st["stage"] not in ("block", "parse", "encode",
                                   "plan.compile"):
                key = f"{st['stage']}:{st.get('tier', '-')}"
                stage_by_tier[key] = stage_by_tier.get(key, 0.0) + \
                    st["durUs"] / 1e3
        cls = "+".join(sorted(set(moved))) or "host only"
        classes.setdefault(cls, []).append((card_ms, host_ms))
        rows.append(f"{name} {card_ms:.3f}/{host_ms:.3f}")
    log(f"golden queries at scale {GOLDEN_SCALE} on the write plane's "
        f"engine (static planner, device_min_edges 1024): card, a CPU "
        f"engine restored from its state ({copy_s:.1f} s) and the host path "
        f"(prefer_device=False) give equal data for all {len(golden)}; "
        f"kernel launches over the card's runs {launches_of(kernels)}; "
        f"warm median of {QUERY_REPS} runs, ms card/host path (host "
        f"clock): " + ", ".join(rows) + f" | {card}")
    for cls, ms in sorted(classes.items()):
        c = np.asarray(ms)
        log(f"  class {cls}: {len(ms)} queries, card {c[:, 0].sum():.3f} "
            f"ms, host path {c[:, 1].sum():.3f} ms (sums of medians) | "
            f"{card}")
    log(f"  one analyzed card run of each: parse {split['parse']:.1f} ms, "
        f"execute {split['execute']:.1f} ms, encode {split['encode']:.1f} "
        f"ms; stage spans by stage:tier (ms) " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(
                stage_by_tier.items(), key=lambda kv: -kv[1])[:12])
        + f" | {card}")

    # -- 29. similar_to through query() ------------------------------------
    tab = db.tablets["embedding"]
    ix = tab.vector_ivf()
    if ix is None or ix.device != dev:
        raise AssertionError("the embedding's index from phase 23 is gone")
    vecs, queries, exact = state["vecs"], state["queries"], state["exact"]
    lits = [vector_literal(q) for q in queries]
    root_q = ('{ q(func: similar_to(embedding, %d, "%s")) '
              '{ uid s: val(similar_to_score) } }')
    filt_q = ('{ q(func: has(embedding)) @filter(similar_to(embedding, '
              '%d, "%s")) { uid } }')
    last = {}

    def recorded(fn, key):
        def run(*args, **kw):
            last[key] = (args, kw)
            return fn(*args, **kw)
        return run

    def similar(text_fmt, name, launched):
        got, lat_ms = [], []
        for i, lit in enumerate(lits):
            reset_launches(kernels)
            t0 = time.perf_counter()
            out = db.query(text_fmt % (SIMILAR_K, lit))["data"]["q"]
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            only_launched(f"{name} query {i}", launches_of(kernels),
                          launched, 1)
            got.append(out)
        return got, lat_ms

    def rows_of(got):
        return np.asarray([[int(r["uid"], 16) - VEC_UID0 for r in out]
                           for out in got], np.int64)

    ivf.score_int8_lists = recorded(kernels.score_int8_lists, "int8")
    knn.score_dot = recorded(kernels.score_dot, "dot")
    try:
        db.vec_quantized = True
        quant, quant_ms = similar(root_q, "quantized tier", "score_int8")
        db.vec_quantized = False
        exact_dev, exact_ms = similar(root_q, "exact device tier",
                                      "score_dot")
        db.vec_quantized = True
        filt, filt_ms = similar(filt_q, "filtered similar_to", "score_dot")
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
        knn.score_dot = kernels.score_dot
    tol = (WRITE_DIM + 4) * 2.0 ** -24
    q_rows = rows_of(quant)
    rec = bv.recall(exact, q_rows)
    if rec < 0.95:
        raise AssertionError(f"quantized tier through query(): recall@"
                             f"{SIMILAR_K} {rec} < 0.95")
    # the same requests with the plain score_int8_lists
    ivf.score_int8_lists = kernels.score_int8_lists_reference
    try:
        db.vec_quantized = True
        quant_plain = [db.query(root_q % (SIMILAR_K, lit))["data"]["q"]
                       for lit in lits]
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    q_flips = same_topk("quantized tier vs plain", q_rows,
                        rows_of(quant_plain), vecs, queries, VEC_METRIC, tol)
    same_scores = all(a == b for a, b in zip(quant, quant_plain)
                      if [r["uid"] for r in a] == [r["uid"] for r in b])
    if not same_scores:
        raise AssertionError("quantized tier: equal uids, other scores "
                             "than with the plain score_int8_lists")
    # the exact device tier: the same call with the plain score_dot, and
    # the exact float64 top-k on the host
    e_rows = rows_of(exact_dev)
    knn.score_dot = kernels.score_dot_reference
    try:
        db.vec_quantized = False
        dot_plain = [db.query(root_q % (SIMILAR_K, lit))["data"]["q"]
                     for lit in lits]
    finally:
        knn.score_dot = kernels.score_dot
        db.vec_quantized = True
    e_flips = same_topk("exact device tier vs plain", e_rows,
                        rows_of(dot_plain), vecs, queries, VEC_METRIC, tol)
    host_idx, _ = knn.topk_host(vecs, queries, SIMILAR_K, VEC_METRIC)
    e_rec = bv.recall(host_idx, e_rows)
    e_same = int(sum(np.array_equal(a, b) for a, b in zip(e_rows, host_idx)))
    worst = 0.0
    for qi, out in enumerate(exact_dev):
        s64 = knn.score_host(vecs[e_rows[qi]], queries[qi], VEC_METRIC)[0]
        worst = max(worst, float(np.abs(np.asarray(
            [r["s"] for r in out]) - s64).max()))
    if worst > tol or e_rec < knn.RECALL_TARGET:
        raise AssertionError(f"exact device tier: scores off float64 by "
                             f"{worst} (> {tol}) or recall {e_rec}")
    f_sets = [sorted(int(r["uid"], 16) for r in out) for out in filt]
    if f_sets != [sorted(int(r["uid"], 16) for r in out)
                  for out in exact_dev]:
        raise AssertionError("filtered similar_to != the root exact tier")
    state["similar"] = {"lits": lits, "root_q": root_q, "quant": quant,
                        "exact": exact_dev}
    tier = "two-stage" if knn.plan_two_stage(WRITE_VECS, SIMILAR_K) \
        else "exact"
    log(f"similar_to through query(), {len(lits)} requests a tier, k "
        f"{SIMILAR_K}, on the {WRITE_VECS} x {WRITE_DIM} embeddings: "
        f"quantized tier (index nprobe {ix.nprobe}) one score_int8_lists "
        f"launch a request and no other kernel, recall@{SIMILAR_K} {rec} "
        f"against exact_topk_blocked, equal to the plain score_int8_lists "
        f"({q_flips} rounding flips, equal scores); exact device tier "
        f"({tier} top-k) one score_dot launch a request, equal to the "
        f"plain score_dot ({e_flips} flips), {e_same}/{len(lits)} rows "
        f"equal to knn.topk_host's, recall {e_rec}, scores within "
        f"{worst:.3g} of float64 (tolerance {tol:.3g}); @filter("
        f"similar_to) over has(embedding) one score_dot launch a request, "
        f"the root exact tier's uids | {card}")
    for name, ms in (("quantized", quant_ms), ("exact device", exact_ms),
                     ("filtered", filt_ms)):
        log(f"  {name} tier, single request latency (host clock): p50 "
            f"{pct(ms, 50):.3f} ms, p99 {pct(ms, 99):.3f} ms | {card}")
    entries = []
    (codes, qs, table, out), kw = last["int8"]
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    int8_ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes, qs, table, out, **kw), 20, flush)
    plain_out = torch.empty_like(out)
    int8_plain = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes, qs, table, plain_out, **kw), 3)
    err, ratio = lists_within_bound(codes, qs, table, out, plain_out, kw,
                                    "score_int8_lists, a similar_to request")
    int8_bound, int8_by = lists_bound_ms(codes, qs, table)
    entries.append({
        "name": "score_int8_lists", "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/score.cu",
        "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
        "path": "GraphDB.query -> similar_to quantized tier -> ivf.search",
        "launches": len(lits), "max_abs_err": err, "ms": int8_ms,
        "plain_ms": int8_plain, "bound_ms": int8_bound,
        "bound_by": int8_by, "library_ms": None})
    (corpus, qv), kw = last["dot"]
    dot_ms = device_ms_cold(lambda: kernels.score_dot(corpus, qv), 20, flush)
    dot_plain = device_ms_cold(
        lambda: kernels.score_dot_reference(corpus, qv), 20, flush)
    lib_ms = device_ms_cold(lambda: torch.matmul(qv, corpus.T), 20, flush)
    derr, dratio = check_score(kernels.score_dot,
                               kernels.score_dot_reference, corpus, qv,
                               "score_dot, a similar_to request")
    dot_bound, dot_by = score_bound_ms([(corpus, qv)])
    entries.append({
        "name": "score_dot", "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/score.cu",
        "replaces": "dgraph_tpu/ops/pallas_kernels.py:123",
        "path": "GraphDB.query -> similar_to exact device tier -> "
                "knn.topk_device",
        "launches": 2 * len(lits), "max_abs_err": derr, "ms": dot_ms,
        "plain_ms": dot_plain, "bound_ms": dot_bound, "bound_by": dot_by,
        "library_ms": lib_ms})
    rest = exact_rest_ms(knn, corpus, qv, SIMILAR_K, flush)
    del flush
    log(f"  a request's launch at its shapes: score_int8_lists "
        f"({len(table)} entries, worst error/bound {ratio:.4g}) "
        f"{int8_ms:.4f} ms, plain {int8_plain:.4f} ms, bound "
        f"{int8_bound:.4f} ms ({int8_by}); score_dot ({qv.shape[0]} x "
        f"{corpus.shape[0]} x {corpus.shape[1]}, worst error/bound "
        f"{dratio:.4g}) {dot_ms:.4f} ms, plain {dot_plain:.4f} ms, "
        f"torch.matmul {lib_ms:.4f} ms, bound {dot_bound:.4f} ms ({dot_by})"
        f" (device times from a flushed L2, CUDA events) | {card}")
    log(f"  the rest of an exact request's device time at that shape, ms "
        f"(flushed L2, CUDA events): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rest.items()) + f"; sum "
        f"{sum(rest.values()):.4f} beside score_dot's {dot_ms:.4f} | {card}")

    # -- 30. pack algebra on the card --------------------------------------
    entries.append(label_phase(db, dev, card, kernels, setops, state))

    # -- 31. @recurse and shortest through query() -------------------------
    recurse_and_shortest(db, cpu, card, kernels, metrics)
    del cpu

    # -- 36. the mesh engine ------------------------------------------------
    entries += mesh_engine_phase(dev, card, db, golden, state, quant, lits,
                                 root_q)
    return entries


def exact_rest_ms(knn, corpus, qv, k: int, flush) -> dict:
    """Device ms of what an exact cosine request runs on the card beside
    score_dot (`knn._score_device`, `knn.topk_device`), each from a
    flushed L2: the corpus norms, which reread the corpus every request;
    the rest of the cosine epilogue; the padding and the mask; the
    ordered top-k. Measurement only."""
    n = corpus.shape[0]
    n_pad = -(-n // knn.BUCKET_SIZE) * knn.BUCKET_SIZE
    dots = torch.matmul(qv, corpus.T)
    cn = torch.sqrt(torch.sum(corpus * corpus, dim=1))

    def cosine():
        qn = torch.sqrt(torch.sum(qv * qv, dim=1))
        denom = qn[:, None] * cn[None, :]
        pos = denom > 0
        return torch.where(pos, dots / torch.where(pos, denom, 1.0), 0.0)

    def mask():
        scores = torch.nn.functional.pad(dots, (0, n_pad - n),
                                         value=-math.inf)
        invalid = torch.arange(n_pad, device=dots.device) >= n
        return scores.masked_fill_(invalid[None, :], -math.inf)

    scores = mask()
    return {
        "norms": device_ms_cold(
            lambda: torch.sqrt(torch.sum(corpus * corpus, dim=1)), 20, flush),
        "cosine epilogue": device_ms_cold(cosine, 20, flush),
        "padding and mask": device_ms_cold(mask, 20, flush),
        "_topk_ordered": device_ms_cold(
            lambda: knn._topk_ordered(scores, k), 20, flush)}


def label_phase(db, dev, card: str, kernels, setops, state: dict) -> dict:
    """Phase 30: allofterms over a dense term index, through query(),
    with the device AND; each query's uids go into state["labels"].
    Returns the kernels line's entry of bitmap_and."""
    from dgraph_tpu_torch.gql.nquad import parse_rdf
    from dgraph_tpu_torch.ingest import bulk_load
    from dgraph_tpu_torch.models.tokenizer import get_tokenizer
    from dgraph_tpu_torch.ops import codec
    from dgraph_tpu_torch.utils.keys import token_bytes

    rng = np.random.default_rng(30)
    has = {w: rng.random(LABEL_NODES) < p for w, p in LABEL_WORDS}
    words = [w for w, _ in LABEL_WORDS]
    labels = [" ".join(w for w in words if has[w][i])
              for i in range(LABEL_NODES)]
    db.alter("label: string @index(term) .")
    # bulk_load writes the tablet's base state: transactions would leave
    # 2^19 postings for the rollup's fold, which inserts uid by uid
    # (143.82 s on the card's host)
    t0 = time.perf_counter()
    bulk_load(nquads=(parse_rdf("\n".join(
        f'<{LABEL_UID0 + i:#x}> <label> "{labels[i]}" .'
        for i in range(s, min(LABEL_NODES, s + WRITE_BATCH))))
        for s in range(0, LABEL_NODES, WRITE_BATCH)), db=db)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.rollup_all(0)
    rollup_s = time.perf_counter() - t0
    tab = db.tablets["label"]
    tix = tab.token_index_packs(db.coordinator.max_assigned())
    ident = get_tokenizer("term").ident
    packs = {w: tix.packs.get(token_bytes(ident, w)) for w in words}
    if any(p is None for p in packs.values()):
        raise AssertionError("label: a word's posting list is not a pack")
    common = set.intersection(*(set(p.keys.tolist())
                                for p in packs.values()))
    all_bitmap = [k for k in sorted(common) if all(
        p.forms[int(np.searchsorted(p.keys, k))] == codec.FORM_BITMAP
        for p in packs.values())]
    if len(all_bitmap) < DEVICE_AND_KEYS:
        raise AssertionError(f"label: {len(all_bitmap)} all-bitmap blocks "
                             f"on common keys < {DEVICE_AND_KEYS}")
    log(f"pack algebra, load: {LABEL_NODES} nodes with `label: string "
        f"@index(term)`, words {dict(LABEL_WORDS)}, through bulk_load "
        f"in {load_s:.2f} s ({LABEL_NODES / load_s:.0f} RDF/s); "
        f"rollup_all(0) {rollup_s:.2f} s; every word's pack holds "
        f"{len(all_bitmap)} BITMAP blocks on common keys | {card}")

    # the words a query's bitmap_and launch ANDs, as bitmap_and_device
    # stacks them (recorded there: the kernel's wrapper counts its
    # launches through its own module name, so it stays unpatched)
    last = {}
    and_device = setops.bitmap_and_device

    def recorded(mats, device=None):
        last["mats"] = (mats, device)
        return and_device(mats, device)

    shapes = [words[:k] for k in (2, 3, 4)]
    entry = None
    real_and = kernels.bitmap_and
    setops.bitmap_and_device = recorded
    try:
        for ws in shapes:
            text = '{ q(func: allofterms(label, "%s")) { uid } }' % \
                " ".join(ws)
            mask = np.logical_and.reduce([has[w] for w in ws])
            want = (LABEL_UID0 + np.flatnonzero(mask)).tolist()
            state.setdefault("labels", {})[" ".join(ws)] = want
            wall = []
            for r in range(AND_REPS):
                reset_launches(kernels)
                t0 = time.perf_counter()
                out = db.query(text)["data"]["q"]
                wall.append((time.perf_counter() - t0) * 1e3)
                only_launched(f"allofterms {ws} run {r}",
                              launches_of(kernels), "bitmap_and", 1)
                got = [int(x["uid"], 16) for x in out]
                if got != want:
                    raise AssertionError(f"allofterms {ws}: {len(got)} "
                                         f"uids != the oracle's {len(want)}")
            kernels.bitmap_and = kernels.bitmap_and_reference
            try:
                plain = [int(x["uid"], 16)
                         for x in db.query(text)["data"]["q"]]
            finally:
                kernels.bitmap_and = real_and
            if plain != want:
                raise AssertionError(f"allofterms {ws} with the plain "
                                     f"bitmap_and != the oracle")
            words_in, _ = last["mats"]
            mats = torch.from_numpy(np.stack([np.ascontiguousarray(
                m, np.uint64) for m in words_in]).view(np.int64)).to(dev)
            k, b, w = mats.shape
            flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
            k_ms = device_ms_cold(lambda: real_and(mats), 20, flush)
            p_ms = device_ms_cold(
                lambda: kernels.bitmap_and_reference(mats), 20, flush)
            lib = device_ms_cold(
                lambda: torch.bitwise_and(mats[0], mats[1]), 20, flush) \
                if k == 2 else None
            del flush
            err = int((real_and(mats)
                       != kernels.bitmap_and_reference(mats)).sum())
            if err:
                raise AssertionError("bitmap_and != plain version at a "
                                     "query's shape")
            bound = (k + 1) * b * w * 8 / HBM_BYTES_PER_S * 1e3
            log(f"allofterms(label, \"{' '.join(ws)}\") x {AND_REPS}: "
                f"{len(want)} uids = the numpy oracle = the plain "
                f"bitmap_and's; one bitmap_and launch a query at (k {k}, "
                f"B {b}, W {w}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                + (f", torch.bitwise_and {lib:.4f} ms" if lib else "")
                + f", bound {bound:.4f} ms (bytes), device times from a "
                f"flushed L2; query wall p50 {pct(wall, 50):.3f} ms, p99 "
                f"{pct(wall, 99):.3f} ms (host clock) | {card}")
            if k == 2:
                entry = {"name": "bitmap_and", "route": "cuda",
                         "source": "dgraph_tpu_torch/csrc/bitmap_and.cu",
                         "replaces": "dgraph_tpu/ops/pallas_kernels.py:217",
                         "path": "GraphDB.query -> allofterms -> "
                                 "setops.intersect_mixed -> intersect_packs",
                         "launches": len(shapes) * AND_REPS,
                         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": bound, "bound_by": "bytes",
                         "library_ms": lib}
    finally:
        setops.bitmap_and_device = and_device
        kernels.bitmap_and = real_and
    return entry


def recurse_and_shortest(db, cpu, card: str, kernels, metrics) -> None:
    """Phase 31: @recurse and shortest through query() on the card (the
    device tiers forced, device_min_edges=1, on both engines), each
    equal to the CPU engine's data and timed beside the host path."""
    rng, films, roots = recurse_roots(db)
    directors = np.asarray(sorted(db.tablets["director.film"].edges),
                           np.int64)
    genres = np.asarray(sorted(db.tablets["genre"].reverse), np.int64)
    pairs = []
    for i in range(SHORTEST_PAIRS):
        if i % 2:
            f = int(rng.choice(films))
            row = db.tablets["genre"].edges.get(f)
            g = int(row[0]) if i % 4 == 1 and row is not None and len(row) \
                else int(rng.choice(genres))
            pairs.append(("genre", f, g))
        else:
            d = int(rng.choice(directors))
            row = db.tablets["director.film"].edges[d]
            f = int(row[-1]) if i % 4 == 0 else int(rng.choice(films))
            pairs.append(("director.film", d, f))
    sp_q = ("{ p as shortest(from: %#x, to: %#x) { %s } "
            "n(func: uid(p)) { uid } }")
    cases = {"recurse": [RECURSE_Q % int(r) for r in roots],
             "shortest": [sp_q % (a, b, p) for p, a, b in pairs]}
    counters = {"recurse": "query_device_expand_total",
                "shortest": "query_device_sssp_total"}
    db.device_min_edges = cpu.device_min_edges = 1
    try:
        for kind, texts in cases.items():
            reset_launches(kernels)
            before = metrics.counters_snapshot()
            card_ms, host_ms, found = [], [], 0
            for text in texts:
                db.prefer_device = True
                t0 = time.perf_counter()
                got = db.query(text)["data"]
                card_ms.append((time.perf_counter() - t0) * 1e3)
                if got != cpu.query(text)["data"]:
                    raise AssertionError(f"{kind} on the card != the CPU "
                                         f"engine: {text}")
                found += bool(got.get("_path_") or got.get("r"))
                db.prefer_device = False
                t0 = time.perf_counter()
                host = db.query(text)["data"]
                host_ms.append((time.perf_counter() - t0) * 1e3)
                if host != got:
                    raise AssertionError(f"{kind}: host path != card: "
                                         f"{text}")
            db.prefer_device = True
            moved = sum(v for k, v in metrics.counters_delta(before).items()
                        if k.startswith(counters[kind]))
            if moved <= 0:
                raise AssertionError(f"{kind} never moved {counters[kind]}")
            ex = db.query(texts[0], explain="analyze")["extensions"]
            tiers = {k: v for k, v in ex["explain"]["counters"].items()
                     if "device" in k}
            log(f"{kind} through query(), {len(texts)} requests "
                f"({found} non-empty): equal to the CPU engine and the host "
                f"path; {counters[kind]} +{moved:g}; kernel launches "
                f"{launches_of(kernels)}; card p50 {pct(card_ms, 50):.3f} "
                f"ms p99 {pct(card_ms, 99):.3f} ms, host path p50 "
                f"{pct(host_ms, 50):.3f} ms p99 {pct(host_ms, 99):.3f} ms "
                f"(host clock, first runs included); EXPLAIN analyze of "
                f"the first, its device tier counters: {tiers} | {card}")
    finally:
        db.device_min_edges = cpu.device_min_edges = 1024
        db.prefer_device = True


# -- the cold plane (phases 37-42) ------------------------------------------

SERVE_REPS = 3                     # HTTP and in-process passes of the goldens
SERVE_SIMILAR = 64                 # similar_to requests a tier over HTTP
SERVE_AND = 8                      # dense allofterms requests over HTTP
SERVE_BATCH = 16                   # concurrent requests in one batcher window
SERVE_WINDOW_US = 200_000          # the batcher's window
CLI_NODES = 4096                   # the CLI child's graph: follows edges,
CLI_EDGES = 32_768                 # past GraphDB's device_min_edges (1,024)
                                   # and a frontier worth the device expand
CLI_COMMITS = 16                   # AlphaServer._maybe_rollup's period


def http_call(base: str, path: str, body: bytes = b"",
              ctype: str = "application/dql", headers=None,
              expect: int = 200, get: bool = False):
    """One request; (decoded JSON or text, raw bytes). Any other status
    than `expect`, or `errors` in a 200 body, fails the run: a CUDA
    error inside a handler thread comes back as a 500."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if get else body,
        headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    if status != expect:
        raise AssertionError(f"{path}: HTTP {status}, expected {expect}: "
                             f"{raw[:400]!r}")
    try:
        out = json.loads(raw)
    except ValueError:
        out = raw.decode()
    if expect == 200 and isinstance(out, dict) and out.get("errors"):
        raise AssertionError(f"{path}: errors in a 200 body: {out['errors']}")
    return out, raw


def serving_plane(dev, card: str, state: dict) -> list[dict]:
    """Phases 43-47: the serving surfaces (`server/http`, `engine/
    batcher`, `server/grpc_api`, `cli`) on the card, serving the write
    plane's engine (its goldens at scale 10, embeddings and labels)
    over HTTP and gRPC, and a CLI `alpha` child serving its own engine
    on the card. Returns the kernels line's entries of score_int8_lists,
    score_dot and bitmap_and as served requests drive them."""
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.server.http import serve

    db = state["db"]
    servers = []
    try:
        t0 = time.perf_counter()
        httpd, alpha = serve(db, port=0, block=False)
        servers.append(httpd)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        serving_goldens(db, base, card)
        log(f"serving plane, phase 43: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries = serving_kernels(db, dev, base, card, state, kernels)
        log(f"serving plane, phase 44: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serving_batcher(db, card, state, kernels, servers)
        log(f"serving plane, phase 45: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serving_robustness(db, base, alpha, card, servers)
        log(f"serving plane, phase 46: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serving_grpc(base, alpha, card, state, kernels)
        serving_cli(card)
        log(f"serving plane, phase 47: {time.perf_counter() - t0:.1f} s")
        return entries
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
        # an AlphaServer keeps reads from folding overlays; the cold
        # plane reads this engine in process again
        db.__dict__.pop("rollup_in_read", None)


def serving_goldens(db, base: str, card: str) -> None:
    """Phase 43: the 75 goldens over HTTP against query_json in process;
    p50 and p99 of a request over HTTP beside in-process query() and
    query_json()."""
    golden = golden_queries()
    for name, text, _ in golden:
        got, _ = http_call(base, "/query", text.encode())
        want = json.loads(db.query_json(text))["data"]
        if got["data"] != want:
            raise AssertionError(f"{name} over HTTP != query_json in process")
    lat = {"http": [], "query": [], "query_json": []}
    for _ in range(SERVE_REPS):
        for _, text, _ in golden:
            t0 = time.perf_counter()
            http_call(base, "/query", text.encode())
            lat["http"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            db.query(text)
            lat["query"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            db.query_json(text)
            lat["query_json"].append((time.perf_counter() - t0) * 1e3)
    log(f"serving: the {len(golden)} golden queries at scale {GOLDEN_SCALE} "
        f"over HTTP (serve(db) on the write plane's engine, POST /query), "
        f"each response's data equal to query_json's in process; "
        f"{SERVE_REPS} passes, ms a request (host clock): " + "; ".join(
            f"{k} p50 {pct(v, 50):.3f} p99 {pct(v, 99):.3f} sum of a pass "
            f"{sum(v) / SERVE_REPS:.3f}" for k, v in lat.items())
        + f"; the surface's p50 over query_json "
        f"{pct(lat['http'], 50) - pct(lat['query_json'], 50):.3f} ms | {card}")


def serving_kernels(db, dev, base: str, card: str, state: dict,
                    kernels) -> list[dict]:
    """Phase 44: similar_to over HTTP on the quantized and exact tiers and
    dense allofterms, one kernel launch a request; each kernel at a served
    request's shapes against its plain version, bound and library call."""
    from dgraph_tpu_torch.ops import ivf, knn, setops

    sim = state["similar"]
    lits, root_q = sim["lits"][:SERVE_SIMILAR], sim["root_q"]
    last = {}

    def recorded(fn, key):
        def run(*args, **kw):
            last[key] = (args, kw)
            return fn(*args, **kw)
        return run

    and_device = setops.bitmap_and_device

    def recorded_and(mats, device=None):
        last["mats"] = (mats, device)
        return and_device(mats, device)

    lat = {}
    ivf.score_int8_lists = recorded(kernels.score_int8_lists, "int8")
    knn.score_dot = recorded(kernels.score_dot, "dot")
    setops.bitmap_and_device = recorded_and
    quantized = db.vec_quantized
    try:
        for tier, name, key in (("quantized", "score_int8", "quant"),
                                ("exact", "score_dot", "exact")):
            db.vec_quantized = tier == "quantized"
            lat[tier] = []
            for i, lit in enumerate(lits):
                text = root_q % (SIMILAR_K, lit)
                reset_launches(kernels)
                t0 = time.perf_counter()
                got, _ = http_call(base, "/query", text.encode())
                lat[tier].append((time.perf_counter() - t0) * 1e3)
                only_launched(f"HTTP similar_to, {tier} tier, request {i}",
                              launches_of(kernels), name, 1)
                want = json.loads(db.query_json(text))["data"]
                if got["data"] != want or \
                        [r["uid"] for r in got["data"]["q"]] != \
                        [r["uid"] for r in sim[key][i]]:
                    raise AssertionError(f"HTTP similar_to, {tier} tier, "
                                         f"request {i}: other answers than "
                                         f"in process")
        words = "w0 w1"
        text = '{ q(func: allofterms(label, "%s")) { uid } }' % words
        lat["allofterms"] = []
        for i in range(SERVE_AND):
            reset_launches(kernels)
            t0 = time.perf_counter()
            got, _ = http_call(base, "/query", text.encode())
            lat["allofterms"].append((time.perf_counter() - t0) * 1e3)
            only_launched(f"HTTP allofterms request {i}",
                          launches_of(kernels), "bitmap_and", 1)
            if [int(r["uid"], 16) for r in got["data"]["q"]] != \
                    state["labels"][words]:
                raise AssertionError("HTTP allofterms != phase 30's uids")
    finally:
        db.vec_quantized = quantized
        ivf.score_int8_lists = kernels.score_int8_lists
        knn.score_dot = kernels.score_dot
        setops.bitmap_and_device = and_device
    log(f"serving: {len(lits)} similar_to requests a tier and {SERVE_AND} "
        f"allofterms(label, \"{words}\") over HTTP, one at a time: one "
        f"score_int8_lists (quantized), score_dot (exact) or bitmap_and "
        f"launch a request and no other kernel, answers equal to the same "
        f"queries in process and to phases 29-30; ms a request (host "
        f"clock): " + "; ".join(f"{k} p50 {pct(v, 50):.3f} p99 "
                                f"{pct(v, 99):.3f}" for k, v in lat.items())
        + f" | {card}")

    return path_kernel_entries(
        dev, card, last, {"score_int8": len(lits), "score_dot": len(lits),
                          "bitmap_and": SERVE_AND},
        "serving", "a served request (POST /query -> "
        "AlphaServer.handle_query_json)")


def fan_out(base: str, texts: list[str]) -> list[bytes]:
    """POST each text from its own thread, the threads started 2 ms
    apart (the server's listen backlog is 5 connections), all inside
    one batcher window; the raw bodies in order."""
    import threading

    out = [None] * len(texts)
    errors = []

    def go(i, text):
        try:
            out[i] = http_call(base, "/query", text.encode())[1]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=go, args=(i, t))
               for i, t in enumerate(texts)]
    for t in threads:
        t.start()
        time.sleep(0.002)
    for t in threads:
        t.join(timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"batched requests failed: {errors[:2]}")
    return out


def serving_batcher(db, card: str, state: dict, kernels, servers) -> None:
    """Phase 45: SERVE_BATCH concurrent similar_to requests inside one
    MicroBatcher window: identical ones execute once with one launch;
    distinct bindings run one after another on the leader."""
    import threading

    from dgraph_tpu_torch.query.plan import PlanCache
    from dgraph_tpu_torch.server.http import serve
    from dgraph_tpu_torch.utils import metrics

    httpd, _ = serve(db, port=0, block=False,
                     batch_window_us=SERVE_WINDOW_US)
    servers.append(httpd)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    sim = state["similar"]
    runs = []
    inner = db.query_json

    def counted(*a, **kw):
        runs.append(threading.get_ident())
        return inner(*a, **kw)

    def round_of(texts):
        runs.clear()
        reset_launches(kernels)
        before = metrics.counters_snapshot()
        bodies = fan_out(base, texts)
        delta = metrics.counters_delta(before)
        return bodies, launches_of(kernels), delta.get("batch_dispatches", 0)

    # batches group by plan-cache key: the write plane's engine runs
    # without a plan cache, so one stands in for this phase
    plan_cache = db.plan_cache
    db.plan_cache = PlanCache(128)
    db.vec_quantized = True
    db.query_json = counted
    try:
        same = [sim["root_q"] % (SIMILAR_K, sim["lits"][0])] * SERVE_BATCH
        bodies, launched, dispatches = round_of(same)
        if len(runs) != 1 or len(set(bodies)) != 1 or dispatches != 1:
            raise AssertionError(f"{SERVE_BATCH} identical requests: "
                                 f"{len(runs)} executions, {len(set(bodies))}"
                                 f" distinct bodies, {dispatches} dispatches")
        only_launched("identical batched requests", launched, "score_int8", 1)
        distinct = [sim["root_q"] % (SIMILAR_K, lit)
                    for lit in sim["lits"][:SERVE_BATCH]]
        dbodies, dlaunched, ddispatches = round_of(distinct)
        leaders = len(set(runs))
        only_launched("distinct batched requests", dlaunched, "score_int8",
                      SERVE_BATCH)
        if len(runs) != SERVE_BATCH or leaders > ddispatches:
            raise AssertionError(f"{SERVE_BATCH} distinct requests: "
                                 f"{len(runs)} executions on {leaders} "
                                 f"threads in {ddispatches} dispatches")
    finally:
        del db.query_json
        db.plan_cache = plan_cache
    for i, body in enumerate(dbodies):
        got = json.loads(body)["data"]["q"]
        if [r["uid"] for r in got] != [r["uid"] for r in sim["quant"][i]]:
            raise AssertionError(f"batched request {i} != phase 29's answer")
    log(f"serving: micro-batcher (serve(batch_window_us={SERVE_WINDOW_US})): "
        f"{SERVE_BATCH} identical concurrent similar_to requests (quantized "
        f"tier) in one window: 1 execution, 1 dispatch, launches {launched}, "
        f"{SERVE_BATCH} bodies identical byte for byte; {SERVE_BATCH} "
        f"distinct bindings: {len(runs)} executions one after another on "
        f"{leaders} leader thread(s) in {ddispatches} dispatch(es), "
        f"score_int8_lists launched {dlaunched['score_int8']} times, "
        f"answers equal to phase 29's | {card}")


def serving_robustness(db, base: str, alpha, card: str, servers) -> None:
    """Phase 46: 408 through X-Dgraph-Deadline-Ms, 499 through
    /admin/cancel, 429 under max_pending, and the shed and pending
    metrics, with the executor.level failpoint slowing traversals."""
    import threading

    from dgraph_tpu_torch.server.http import serve
    from dgraph_tpu_torch.utils import failpoint

    text = golden_queries()[0][1]
    got = {}

    def held(url, key, expect, headers=None):
        def go():
            try:
                got[key] = http_call(url, "/query", text.encode(),
                                     headers=headers, expect=expect)[0]
            except BaseException as e:  # noqa: BLE001 — checked below
                got[key] = e
        t = threading.Thread(target=go)
        t.start()
        return t

    def wait_pending(a, n=1):
        end = time.monotonic() + 30
        while a.pending() < n and time.monotonic() < end:
            time.sleep(0.005)
        if a.pending() < n:
            raise AssertionError("the held request never took its slot")

    shed_httpd, shed_alpha = serve(db, port=0, block=False, max_pending=1)
    servers.append(shed_httpd)
    shed_base = f"http://127.0.0.1:{shed_httpd.server_address[1]}"
    try:
        failpoint.arm("executor.level", "sleep(0.3)")
        t0 = time.perf_counter()
        http_call(base, "/query", text.encode(),
                  headers={"X-Dgraph-Deadline-Ms": "100"}, expect=408)
        dl_ms = (time.perf_counter() - t0) * 1e3
        t = held(base, "cancel", 499, {"X-Dgraph-Trace-Id": "serving-499"})
        wait_pending(alpha)
        http_call(base, "/admin/cancel?traceId=serving-499", b"")
        t.join(timeout=60)
        t = held(shed_base, "holder", 200)
        wait_pending(shed_alpha)
        http_call(shed_base, "/query", text.encode(), expect=429)
        t.join(timeout=60)
    finally:
        failpoint.clear()
    bad = {k: v for k, v in got.items() if isinstance(v, BaseException)}
    if bad or set(got) != {"cancel", "holder"}:
        raise AssertionError(f"held requests: {got}")
    prom, _ = http_call(shed_base, "/debug/prometheus_metrics", get=True)
    shed = [ln for ln in prom.splitlines()
            if ln.startswith("dgraph_queries_shed_total")]
    pending = [ln for ln in prom.splitlines()
               if ln.startswith("dgraph_pending_queries")]
    if not shed or float(shed[0].split()[-1]) < 1 or not pending:
        raise AssertionError(f"metrics: shed {shed}, pending {pending}")
    if failpoint.armed():
        raise AssertionError("failpoints still armed")
    log(f"serving: robustness on the card's engine: X-Dgraph-Deadline-Ms "
        f"100 under executor.level sleep(0.3) -> 408 in {dl_ms:.1f} ms; "
        f"/admin/cancel?traceId= -> 499; max_pending=1 with one request "
        f"held -> 429, the held one 200; /debug/prometheus_metrics {shed[0]}"
        f", {pending[0]}; failpoints cleared | {card}")


def serving_grpc(base: str, alpha, card: str, state: dict, kernels) -> None:
    """Phase 47, gRPC: `api.Dgraph/Query` (the protobuf service a dgo
    client calls) over the same AlphaServer: a golden query and a
    similar_to request, each equal to HTTP's answer."""
    try:
        import grpc

        from dgraph_tpu_torch.proto import api_pb2 as pb
        from dgraph_tpu_torch.server.grpc_api import serve_grpc
    except ImportError as e:
        log(f"serving: gRPC not run: {e} does not import on this host | "
            f"{card}")
        return
    server, port = serve_grpc(alpha, port=0)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        call = channel.unary_unary(
            "/api.Dgraph/Query",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.Response.FromString)
        sim = state["similar"]
        alpha.db.vec_quantized = True
        texts = [golden_queries()[1][1],
                 sim["root_q"] % (SIMILAR_K, sim["lits"][1])]
        for i, text in enumerate(texts):
            reset_launches(kernels)
            resp = call(pb.Request(query=text), timeout=120)
            launched = launches_of(kernels)
            if i == 1:
                only_launched("gRPC similar_to", launched, "score_int8", 1)
            want, _ = http_call(base, "/query", text.encode())
            if json.loads(resp.json) != want["data"]:
                raise AssertionError(f"gRPC request {i} != HTTP's answer")
    finally:
        channel.close()
        server.stop(0)
    log(f"serving: gRPC api.Dgraph/Query (grpc {grpc.__version__}) over the "
        f"same AlphaServer: a golden query and a similar_to request (one "
        f"score_int8_lists launch), each equal to HTTP's data | {card}")


def compute_apps() -> list[str]:
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def serving_cli(card: str) -> None:
    """Phase 47, the CLI: `python -m dgraph_tpu_torch version`, then an
    `alpha` child with no --device: alter, mutate and query over HTTP,
    its engine on the card (a new compute app holding memory, tiles
    built), stopped with SIGINT."""
    import signal
    import socket
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO)
    ver = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch",
                          "version"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    if ver.returncode != 0 or "dgraph-tpu" not in ver.stdout:
        raise AssertionError(f"version: rc {ver.returncode} {ver.stderr}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    apps0 = compute_apps()
    work = os.path.join(REPO, "build", "serving")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(work, "alpha.log"), "w") as errf:
        child = subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch", "alpha", "--host",
             "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
            stdout=errf, stderr=subprocess.STDOUT)
        try:
            cli_alpha(child, port, apps0, t0, card)
        finally:
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            try:
                rc = child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
                raise
    if rc != 0:
        raise AssertionError(f"alpha child exited {rc}: " + open(
            os.path.join(work, "alpha.log")).read()[-2000:])
    log(f"serving: `python -m dgraph_tpu_torch version`: "
        f"{' / '.join(ver.stdout.split(chr(10))[:3])}; the alpha child "
        f"stopped by SIGINT, exit 0 | {card}")


def cli_alpha(child, port: int, apps0: list[str], t0: float,
              card: str) -> None:
    base = f"http://127.0.0.1:{port}"
    end = time.monotonic() + 300
    while True:
        if child.poll() is not None:
            raise AssertionError(f"alpha child exited {child.returncode}")
        try:
            http_call(base, "/health", get=True)
            break
        except (OSError, AssertionError):
            if time.monotonic() > end:
                raise
            time.sleep(0.2)
    up_s = time.perf_counter() - t0
    http_call(base, "/alter", b"follows: [uid] @reverse .\n"
              b"name: string @index(exact) .")
    rng = np.random.default_rng(47)
    src = rng.integers(1, CLI_NODES + 1, CLI_EDGES)
    dst = rng.integers(1, CLI_NODES + 1, CLI_EDGES)
    pairs = sorted(set(zip(src.tolist(), dst.tolist())))
    rdf = [f'<{u:#x}> <name> "n{u}" .' for u in range(1, CLI_NODES + 1)] \
        + [f"<{a:#x}> <follows> <{b:#x}> ." for a, b in pairs]
    # CLI_COMMITS commits: the Alpha folds its overlays into the tablets'
    # base every 16 commits (reads never fold), and the device tiles are
    # built from the base
    step = -(-len(rdf) // CLI_COMMITS)
    for s in range(0, len(rdf), step):
        http_call(base, "/mutate?commitNow=true",
                  "\n".join(rdf[s:s + step]).encode(),
                  ctype="application/rdf")
    got, _ = http_call(base, "/query", b"{ q(func: has(follows)) "
                       b"{ follows { uid } } }")
    total = sum(len(r["follows"]) for r in got["data"]["q"])
    out, _ = http_call(base, "/query", b'{ q(func: eq(name, "n1")) '
                       b"{ follows { uid follows { uid } } ~follows { uid } } }")
    want1 = sorted(b for a, b in pairs if a == 1)
    hop1 = sorted(int(r["uid"], 16) for r in
                  (out["data"]["q"][0].get("follows") or []))
    st, _ = http_call(base, "/state", get=True)
    tiles = st["deviceCache"]["tiles"]
    apps = compute_apps()
    mine = [a for a in apps if a.split(",")[0].strip() == str(child.pid)]
    if total != len(pairs) or hop1 != want1 or tiles < 1 or \
            not mine and len(apps) <= len(apps0):
        raise AssertionError(f"alpha child: {total} edges of {len(pairs)}, "
                             f"hop {hop1[:4]} vs {want1[:4]}, deviceCache "
                             f"{st['deviceCache']}, compute apps {apps} "
                             f"(before {apps0}), pid {child.pid}")
    log(f"serving: `python -m dgraph_tpu_torch alpha --port {port}` (no "
        f"--device) up in {up_s:.1f} s; /alter, /mutate of {CLI_NODES} "
        f"names and {len(pairs)} follows edges, /query expands them all from "
        f"every source and walks two hops both ways from one; /state deviceCache {st['deviceCache']}; "
        f"nvidia-smi compute apps: the child's pid {child.pid} "
        + (f"listed ({mine[0]})" if mine else
           f"not listed under its own pid (the container's pid namespace "
           f"differs): {len(apps0)} compute app(s) before it started, "
           f"{len(apps)} with it up, {apps}") + f" | {card}")


# -- the cluster plane (phases 48-51) ----------------------------------------

CLUSTER_REPLICAS = 3               # one alpha group of 3 (docker-compose's)
CLUSTER_TICK_S = 0.05              # the reference's raft tick
CLUSTER_ELECTION_TICKS = 20        # 1 s: in-process replicas share a GIL
CLUSTER_SIMILAR = 64               # similar_to requests a tier, phase 49
CLUSTER_AND = 8                    # dense allofterms requests, phase 49
BANK_ACCOUNTS = 64
BANK_OPENING = 1000
BANK_TRANSFERS = 512               # within raft's snapshot_every (2,048)
BANK_CLIENTS = 8
PROC_ZEROS = 3                     # phase 50's Zero quorum
PROC_SIMILAR = 16                  # quantized requests to the processes
PROC_WRITES = 16                   # writes while phase 50's leader is down
CLUSTER_WAIT_S = 300


def cluster_plane(dev, card: str, state: dict) -> list[dict]:
    """Phases 48-51: the cluster (`cluster/service`, `raft`, `client`,
    `zero`, `topology`, `federated`, `bench/spawn`, `node` and
    `rebalance` on the CLI) on the card, booted from the write plane's
    engine's state, in build/cluster/ (removed at the end). Returns the
    kernels line's entries of score_int8_lists, score_dot and
    bitmap_and as requests through Raft's leader drive them."""
    import gc
    import shutil

    from dgraph_tpu_torch.storage.snapshot import save_snapshot

    work = os.path.join(REPO, "build", "cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        snap = os.path.join(work, "g1.snap")
        t = time.perf_counter()
        save_snapshot(state["db"], snap)
        save_s = time.perf_counter() - t
        srvs = cluster_boot(dev, card, snap, save_s)
        log(f"cluster plane, phase 48: {time.perf_counter() - t0:.1f} s")
        try:
            t0 = time.perf_counter()
            entries = cluster_serve(dev, card, state, srvs)
            log(f"cluster plane, phase 49: {time.perf_counter() - t0:.1f} s")
        finally:
            for s in srvs:
                s.close()
            srvs.clear()
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cluster_processes(dev, card, state, snap, work)
        log(f"cluster plane, phase 50: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cluster_groups(dev, card, work)
        log(f"cluster plane, phase 51: {time.perf_counter() - t0:.1f} s")
        return entries
    finally:
        shutil.rmtree(work, ignore_errors=True)


def wait_until(what: str, fn, timeout_s: float = CLUSTER_WAIT_S,
               every_s: float = 0.02):
    """fn()'s first truthy answer; AssertionError naming `what` after
    `timeout_s`."""
    end = time.monotonic() + timeout_s
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > end:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(every_s)


def cluster_boot(dev, card: str, snap: str, save_s: float) -> list:
    """Phase 48: three `cluster.service.AlphaServer` replicas of group 1
    in this process on localhost TCP, each bulk-booted from `snap` (the
    format `bulk --reduce-shards` writes a group) with its engine on the
    card; boot time and the bytes each charges the card, then the time
    to elect a leader."""
    from dgraph_tpu_torch.bench.spawn import free_ports
    from dgraph_tpu_torch.cluster.service import AlphaServer

    ports = free_ports(2 * CLUSTER_REPLICAS)
    raft = {i: ("127.0.0.1", ports[2 * i - 2])
            for i in range(1, CLUSTER_REPLICAS + 1)}
    srvs, rows = [], []
    # the write plane's engine's settings: the goldens, similar_to and
    # allofterms answers of phases 28-30 come from them
    db_kw = {"device": dev, "prefer_device": True, "plan_cache_size": 0,
             "vec_index_min_rows": WRITE_VECS // 2}
    try:
        for i in raft:
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            srvs.append(AlphaServer(
                i, raft, ("127.0.0.1", ports[2 * i - 1]), snapshot=snap,
                db_kw=dict(db_kw), tick_s=CLUSTER_TICK_S,
                election_ticks=CLUSTER_ELECTION_TICKS))
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0,
                         torch.cuda.memory_allocated(dev) - m0))
        t0 = time.perf_counter()
        wait_until("phase 48: a leader among the replicas",
                   lambda: any(s.is_leader() for s in srvs))
        elect_s = time.perf_counter() - t0
    except BaseException:
        for s in srvs:
            s.close()
        raise
    devices = {str(s.db.device) for s in srvs}
    if devices != {str(dev)}:
        raise AssertionError(f"phase 48: replica engines on {devices}")
    log(f"cluster: save_snapshot of the write plane's engine (goldens at "
        f"scale {GOLDEN_SCALE}, {WRITE_VECS} x {WRITE_DIM} embeddings with "
        f"their trained index, {LABEL_NODES} labels) {save_s:.2f} s, "
        f"{os.path.getsize(snap) / 2**20:.1f} MiB; {CLUSTER_REPLICAS} "
        f"AlphaServer replicas of group 1 in process (snapshot=, db_kw "
        f"device {dev}, prefer_device True), boot s and bytes charged to "
        f"the card (memory_allocated): " + "; ".join(
            f"n{i} {b:.2f} s {m / 2**20:.1f} MiB"
            for i, (b, m) in enumerate(rows, 1))
        + f"; a leader {elect_s:.3f} s after the last boot (tick "
        f"{CLUSTER_TICK_S} s, election {CLUSTER_ELECTION_TICKS} ticks) "
        f"| {card}")
    return srvs


def leader_of(srvs):
    return next((s for s in srvs if s.is_leader()), None)


def cluster_serve(dev, card: str, state: dict, srvs: list) -> list[dict]:
    """Phase 49: the goldens, similar_to on both tiers and dense
    allofterms through `cluster.client.ClusterClient`, a bank of
    transfers through Raft read back from every replica, and the
    leader closed under writes."""
    from dgraph_tpu_torch.cluster.client import ClusterClient
    from dgraph_tpu_torch.ops import ivf, kernels, knn, setops

    addrs = {s.id: s.client_addr for s in srvs}
    client = ClusterClient(dict(addrs), timeout=60.0)
    try:
        lead = wait_until("phase 49: a leader", lambda: leader_of(srvs))
        follower = next(s for s in srvs if s is not lead)
        golden = golden_queries()
        want = state["golden10"]
        lat = {"leader": [], "follower": [], "in-process": []}
        for name, text, _ in golden:
            t0 = time.perf_counter()
            got = client.query(text)
            lat["leader"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            at = client.query_at(follower.id, text)
            lat["follower"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            lead.db.query(text)
            lat["in-process"].append((time.perf_counter() - t0) * 1e3)
            if got["data"] != want[name] or at["data"] != want[name]:
                raise AssertionError(f"phase 49: {name} through the "
                                     f"cluster != phase 28's answer")
        log(f"cluster: the {len(golden)} goldens at scale {GOLDEN_SCALE} "
            f"through ClusterClient on the leader (n{lead.id}) and a "
            f"follower (n{follower.id}, a best-effort read), each equal "
            f"to phase 28's; ms a request (host clock): " + "; ".join(
                f"{k} p50 {pct(v, 50):.3f} p99 {pct(v, 99):.3f}"
                for k, v in lat.items()) + f" | {card}")
        entries = cluster_kernels(dev, card, state, srvs, client, kernels,
                                  ivf, knn, setops)
        cluster_bank(card, srvs, client)
        cluster_leader_loss(card, state, srvs, client, golden)
        return entries
    finally:
        client.close()


def cluster_kernels(dev, card: str, state: dict, srvs: list, client,
                    kernels, ivf, knn, setops) -> list[dict]:
    """Phase 49's kernels: CLUSTER_SIMILAR similar_to requests a tier and
    CLUSTER_AND dense allofterms through the leader, one launch a request
    and no other kernel, answers equal to phases 29-30's."""
    sim = state["similar"]
    lits, root_q = sim["lits"][:CLUSTER_SIMILAR], sim["root_q"]
    last = {}

    def recorded(fn, key):
        def run(*args, **kw):
            last[key] = (args, kw)
            return fn(*args, **kw)
        return run

    and_device = setops.bitmap_and_device

    def recorded_and(mats, device=None):
        last["mats"] = (mats, device)
        return and_device(mats, device)

    lat = {}
    ivf.score_int8_lists = recorded(kernels.score_int8_lists, "int8")
    knn.score_dot = recorded(kernels.score_dot, "dot")
    setops.bitmap_and_device = recorded_and
    try:
        for tier, name, key in (("quantized", "score_int8", "quant"),
                                ("exact", "score_dot", "exact")):
            for s in srvs:
                s.db.vec_quantized = tier == "quantized"
            lat[tier] = []
            for i, lit in enumerate(lits):
                reset_launches(kernels)
                t0 = time.perf_counter()
                got = client.query(root_q % (SIMILAR_K, lit))
                lat[tier].append((time.perf_counter() - t0) * 1e3)
                only_launched(f"cluster similar_to, {tier} tier, request "
                              f"{i}", launches_of(kernels), name, 1)
                if [r["uid"] for r in got["data"]["q"]] != \
                        [r["uid"] for r in sim[key][i]]:
                    raise AssertionError(f"cluster similar_to, {tier} "
                                         f"tier, request {i}: other "
                                         f"answers than phase 29's")
        words = "w0 w1"
        text = '{ q(func: allofterms(label, "%s")) { uid } }' % words
        lat["allofterms"] = []
        for i in range(CLUSTER_AND):
            reset_launches(kernels)
            t0 = time.perf_counter()
            got = client.query(text)
            lat["allofterms"].append((time.perf_counter() - t0) * 1e3)
            only_launched(f"cluster allofterms request {i}",
                          launches_of(kernels), "bitmap_and", 1)
            if [int(r["uid"], 16) for r in got["data"]["q"]] != \
                    state["labels"][words]:
                raise AssertionError("cluster allofterms != phase 30's")
    finally:
        for s in srvs:
            s.db.vec_quantized = True
        ivf.score_int8_lists = kernels.score_int8_lists
        knn.score_dot = kernels.score_dot
        setops.bitmap_and_device = and_device
    log(f"cluster: {len(lits)} similar_to requests a tier and "
        f"{CLUSTER_AND} allofterms(label, \"{words}\") through the "
        f"leader, one at a time: one score_int8_lists (quantized), "
        f"score_dot (exact) or bitmap_and launch a request and no other "
        f"kernel, answers equal to phases 29-30's; ms a request (host "
        f"clock): " + "; ".join(f"{k} p50 {pct(v, 50):.3f} p99 "
                                f"{pct(v, 99):.3f}" for k, v in lat.items())
        + f" | {card}")
    return path_kernel_entries(
        dev, card, last, {"score_int8": len(lits), "score_dot": len(lits),
                          "bitmap_and": CLUSTER_AND},
        "cluster", "a request through Raft's leader (ClusterClient.query "
        "-> cluster AlphaServer -> GraphDB.query)")


def bank_balances(client, node: int) -> dict:
    """uid -> balance on replica `node` (a best-effort read)."""
    got = client.query_at(node, "{ q(func: has(bal)) { uid bal } }")
    return {r["uid"]: r["bal"] for r in got["data"]["q"]}


def bank_ledger(client, node: int) -> set:
    got = client.query_at(node, "{ q(func: has(xfer)) { xfer } }")
    return {r["xfer"] for r in got["data"]["q"]}


def cluster_bank(card: str, srvs: list, client) -> None:
    """Phase 49's writes: BANK_TRANSFERS upsert transfers between
    BANK_ACCOUNTS accounts from BANK_CLIENTS clients through Raft, each
    leaving a ledger row; every acknowledged transfer's row read back
    from all three replicas, the balance total held on each, and the
    replicas' balances equal."""
    import random
    import threading

    from dgraph_tpu_torch.cluster.client import ClusterClient

    client.alter("bal: int .\nxfer: string .")
    out = client.mutate(set_nquads="\n".join(
        f'_:a{i} <bal> "{BANK_OPENING}" .' for i in range(BANK_ACCOUNTS)))
    uids = sorted(out["uids"].values())
    if len(uids) != BANK_ACCOUNTS:
        raise AssertionError(f"bank: {len(uids)} accounts opened")
    acked, failed, lat = set(), {}, []
    lock = threading.Lock()
    addrs = dict(client.addrs)

    def worker(w: int):
        rng = random.Random(w)
        cl = ClusterClient(dict(addrs), timeout=60.0)
        try:
            for n in range(w, BANK_TRANSFERS, BANK_CLIENTS):
                a, b = rng.sample(uids, 2)
                amt = rng.randint(1, 50)
                q = ('{ a as var(func: uid(%s)) { ab as bal na as math(ab - '
                     '%d) } b as var(func: uid(%s)) { bb as bal nb as '
                     'math(bb + %d) } }' % (a, amt, b, amt))
                t0 = time.perf_counter()
                try:
                    cl.mutate(query=q, set_nquads=(
                        'uid(a) <bal> val(na) .\nuid(b) <bal> val(nb) .\n'
                        f'_:t <xfer> "t{n}" .'))
                except Exception as e:  # noqa: BLE001 — counted below
                    with lock:
                        failed[n] = f"{type(e).__name__}: {e}"
                    continue
                with lock:
                    lat.append((time.perf_counter() - t0) * 1e3)
                    acked.add(f"t{n}")
        finally:
            cl.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(BANK_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    aborted = {n: e for n, e in failed.items() if "abort" in e.lower()
               or "conflict" in e.lower()}
    if len(failed) != len(aborted) or not acked:
        raise AssertionError(f"bank: {len(acked)} acknowledged, failures "
                             f"other than conflicts: "
                             f"{dict(list(failed.items())[:4])}")
    total = BANK_ACCOUNTS * BANK_OPENING
    views = {}
    for s in srvs:
        def caught_up(node=s.id):
            led = bank_ledger(client, node)
            return acked <= led and led
        led = wait_until(f"bank: replica n{s.id} reads back every "
                         f"acknowledged transfer", caught_up, 60, 0.1)
        if led - acked:
            raise AssertionError(f"bank: n{s.id} holds unacknowledged "
                                 f"transfers {sorted(led - acked)[:4]}")
        views[s.id] = bank_balances(client, s.id)
        if sum(views[s.id].values()) != total:
            raise AssertionError(f"bank: n{s.id} total "
                                 f"{sum(views[s.id].values())} != {total}")
    if len({json.dumps(v, sort_keys=True) for v in views.values()}) != 1:
        raise AssertionError("bank: replicas' balances differ")
    log(f"cluster: bank of {BANK_ACCOUNTS} accounts, {BANK_TRANSFERS} "
        f"upsert transfers from {BANK_CLIENTS} clients through Raft in "
        f"{wall:.2f} s: {len(acked)} acknowledged ({len(acked) / wall:.1f} "
        f"commits/s), {len(aborted)} aborted as conflicts; every "
        f"acknowledged transfer's ledger row read back from all "
        f"{len(srvs)} replicas and no other, the total {total} on each, "
        f"their balances equal; ms an acknowledged transfer p50 "
        f"{pct(lat, 50):.3f} p99 {pct(lat, 99):.3f} (host clock) | {card}")


def cluster_leader_loss(card: str, state: dict, srvs: list, client,
                        golden) -> None:
    """Phase 49's failover: the leader closed; the time until a write
    commits on a new leader; writes go on; the goldens on both
    survivors equal phase 28's."""
    lead = leader_of(srvs)
    t0 = time.perf_counter()
    lead.close()
    # a closed server's open connections still reach its engine (a
    # process that dies closes them): the client drops its own, as the
    # reference's kill-leader test does
    client._drop(lead.id)
    client._preferred = None
    client.mutate(set_nquads='_:k <xfer> "after-close" .')
    commit_s = time.perf_counter() - t0
    new = wait_until("phase 49: a new leader", lambda: leader_of(
        [s for s in srvs if s is not lead]))
    for i in range(8):
        client.mutate(set_nquads=f'_:k <xfer> "after-close-{i}" .')
    want = state["golden10"]
    survivors = [s for s in srvs if s is not lead]
    for s in survivors:
        def has_writes(node=s.id):
            return {f"after-close-{i}" for i in range(8)} <= \
                bank_ledger(client, node)
        wait_until(f"phase 49: n{s.id} reads the writes after the close",
                   has_writes, 60, 0.1)
        for name, text, _ in golden:
            if client.query_at(s.id, text)["data"] != want[name]:
                raise AssertionError(f"phase 49: {name} on survivor "
                                     f"n{s.id} != phase 28's answer")
    log(f"cluster: leader n{lead.id} closed; a write committed on the new "
        f"leader n{new.id} {commit_s:.3f} s later (ClusterClient retrying "
        f"through the election); 9 writes after it read back on both "
        f"survivors, whose {len(golden)} goldens equal phase 28's | {card}")


def proc_launches(pc) -> dict:
    """name -> the `kernelLaunches` a `stats` op reports, every alpha."""
    out = {}
    for name, cl in pc.node_clients(timeout=30.0).items():
        try:
            if name.startswith("alpha"):
                out[name] = cl._unwrap(cl.request(
                    {"op": "stats"}))["kernelLaunches"]
        finally:
            cl.close()
    return out


def cluster_processes(dev, card: str, state: dict, snap: str,
                      work: str) -> None:
    """Phase 50: `bench/spawn.ProcessCluster`, a Zero quorum of
    PROC_ZEROS and one group of CLUSTER_REPLICAS `python -m
    dgraph_tpu_torch node --device <card>` processes with --wal,
    bulk-booted from `snap`: quantized similar_to answered with
    score_int8_lists launched in the alphas (their `stats` op), each
    alpha and no zero a compute app, and the leader SIGKILLed, restarted
    from its WAL and caught up."""
    from dgraph_tpu_torch.bench.spawn import ProcessCluster

    sim = state["similar"]
    lits, root_q = sim["lits"][:PROC_SIMILAR], sim["root_q"]
    preds = sorted(state["db"].tablets)
    apps0 = compute_apps()
    t0 = time.perf_counter()
    with ProcessCluster(groups=1, replicas=CLUSTER_REPLICAS,
                        zeros=PROC_ZEROS, snapshots={1: snap},
                        data_dir=os.path.join(work, "data"),
                        log_dir=os.path.join(work, "logs"),
                        device=str(dev)) as pc:
        rc = pc.routed(timeout=120.0)
        try:
            pc.wait_ready(timeout_s=CLUSTER_WAIT_S)
            wait_until("phase 50: zero's tablet map holds the snapshot's "
                       "predicates", lambda: set(preds) <= set(
                           rc.tablet_map()["tablets"]), every_s=0.5)
            up_s = time.perf_counter() - t0
            apps = compute_apps()
            cluster_apps(pc, apps0, apps)
            before = proc_launches(pc)
            lat = []
            for i, lit in enumerate(lits):
                t = time.perf_counter()
                got = rc.query(root_q % (SIMILAR_K, lit))
                lat.append((time.perf_counter() - t) * 1e3)
                if [r["uid"] for r in got["data"]["q"]] != \
                        [r["uid"] for r in sim["quant"][i]]:
                    raise AssertionError(f"phase 50: similar_to request {i}"
                                         f" != phase 29's quantized answer")
            after = proc_launches(pc)
            launched = {n: after[n]["score_int8"] - before[n]["score_int8"]
                        for n in after}
            if not 0 < sum(launched.values()) <= len(lits):
                raise AssertionError(f"phase 50: score_int8_lists launches "
                                     f"in the alphas {launched} for "
                                     f"{len(lits)} quantized requests")
            rec_s, name = cluster_restart(pc, rc)
        finally:
            rc.close()
    kinds = raft_dir_kinds(os.path.join(work, "data"))
    log(f"cluster: ProcessCluster of {PROC_ZEROS} zeros and "
        f"{CLUSTER_REPLICAS} `python -m dgraph_tpu_torch node --device "
        f"{dev}` alphas with --wal, bulk-booted from phase 48's snapshot, "
        f"ready with the tablets in zero's map in {up_s:.1f} s; "
        f"{len(lits)} quantized similar_to requests through RoutedCluster "
        f"equal to phase 29's, p50 {pct(lat, 50):.3f} ms p99 "
        f"{pct(lat, 99):.3f} (host clock), score_int8_lists launches in "
        f"the alphas (their stats op) {launched}; {name} SIGKILLed, "
        f"{PROC_WRITES} writes on the new leader, restarted from its WAL "
        f"and caught up {rec_s:.1f} s after the kill; each node's raft "
        f"DiskStorage (--wal) a NativeKV store, keys {kinds} | {card}")


def raft_dir_kinds(data_dir: str) -> dict:
    """Each stopped node's --wal directory under `data_dir`, opened as a
    NativeKV: no PyKV snapshot, some keys, and each alpha's raft
    hardstate (the children's DiskStorage took the native branch).
    Returns {node: keys}."""
    from dgraph_tpu_torch import native

    kinds = {}
    for name in sorted(os.listdir(data_dir)):
        d = os.path.join(data_dir, name)
        if os.path.exists(os.path.join(d, "SNAPSHOT.py")):
            raise AssertionError(f"phase 50: {name}'s raft log is a PyKV")
        kv = native.NativeKV(d)
        try:
            kinds[name] = len(kv)
            if not len(kv) or (name.startswith("alpha")
                               and kv.get(b"hs") is None):
                raise AssertionError(f"phase 50: {name}'s raft store holds "
                                     f"{len(kv)} keys and no hardstate")
        finally:
            kv.close()
    if not any(n.startswith("alpha") for n in kinds):
        raise AssertionError(f"phase 50: no alpha raft directory {kinds}")
    return kinds


def cluster_apps(pc, apps0: list[str], apps: list[str]) -> None:
    """Each alpha and no zero of `pc` is a compute app of the card."""
    pids = {n: str(p.pid) for n, p in pc.procs.items()}
    listed = {a.split(",")[0].strip() for a in apps}
    alphas = [n for n in pids if n.startswith("alpha")]
    zeros = [n for n in pids if n.startswith("zero")]
    if listed & {pids[n] for n in zeros}:
        raise AssertionError(f"phase 50: a zero holds the card: {apps}")
    if all(pids[n] in listed for n in alphas):
        how = "by their pids"
    elif len(apps) - len(apps0) == len(alphas):
        how = (f"as {len(alphas)} new entries (the container's pid "
               f"namespace differs)")
    else:
        raise AssertionError(f"phase 50: compute apps {apps} (before "
                             f"{apps0}) for alphas {alphas}")
    log(f"cluster: nvidia-smi lists the {len(alphas)} alphas {how}, and "
        f"none of the {len(zeros)} zeros: {len(apps0)} compute app(s) "
        f"before, {len(apps)} with the cluster up")


def cluster_restart(pc, rc) -> tuple[float, str]:
    """SIGKILL the group's leader, write on its successor, restart it
    from its WAL; seconds from the kill until it caught up, and its
    name. Its engine then reads the writes."""
    name = pc.leader_of("g1", timeout_s=60)
    t0 = time.perf_counter()
    pc.kill(name)
    for i in range(PROC_WRITES):
        rc.mutate(set_nquads=f'_:w <xfer> "proc-{i}" .')
    pc.restart(name)
    pc.wait_caught_up(name, timeout_s=CLUSTER_WAIT_S)
    rec_s = time.perf_counter() - t0
    nid = int(name.rsplit("n", 1)[1])
    cl = pc.node_clients(timeout=30.0)
    try:
        got = cl[name].query_at(1, "{ q(func: has(xfer)) { xfer } }")
    finally:
        for c in cl.values():
            c.close()
    seen = {r["xfer"] for r in got["data"]["q"]}
    if not {f"proc-{i}" for i in range(PROC_WRITES)} <= seen:
        raise AssertionError(f"phase 50: restarted n{nid} lacks the writes "
                             f"made while it was down")
    return rec_s, name


FED_PREDS = ("fname", "fage", "ffollows")
FED_EXTRA = 3                      # small tablets claimed to unbalance


def cluster_groups(dev, card: str, work: str) -> None:
    """Phase 51: `bulk --reduce-shards 2` of the CLI child's graph, two
    single-replica groups booted from its outputs, a federated query
    across them equal to one engine's answer; `rebalance --once` moves a
    tablet, and the query again after the cutover."""
    from dgraph_tpu_torch import cli
    from dgraph_tpu_torch.bench.spawn import ProcessCluster
    from dgraph_tpu_torch.ingest.bulk import bulk_load

    rng = np.random.default_rng(51)
    src = rng.integers(1, CLI_NODES + 1, CLI_EDGES)
    dst = rng.integers(1, CLI_NODES + 1, CLI_EDGES)
    pairs = sorted(set(zip(src.tolist(), dst.tolist())))
    name, age, follows = FED_PREDS
    rdf = [f'<{u:#x}> <{name}> "n{u}" .' for u in range(1, CLI_NODES + 1)] \
        + [f'<{u:#x}> <{age}> "{u % 90}" .' for u in range(1, CLI_NODES + 1)] \
        + [f"<{a:#x}> <{follows}> <{b:#x}> ." for a, b in pairs]
    schema = (f"{name}: string @index(exact) .\n{age}: int @index(int) .\n"
              f"{follows}: [uid] @reverse .\n")
    path, spath = os.path.join(work, "fed.rdf"), os.path.join(work, "fed.s")
    with open(path, "w") as f:
        f.write("\n".join(rdf) + "\n")
    with open(spath, "w") as f:
        f.write(schema)
    out = os.path.join(work, "bulk")
    t0 = time.perf_counter()
    if cli.main(["bulk", path, "--schema", spath, "--out", out,
                 "--reduce-shards", "2", "--device", str(dev)]) != 0:
        raise AssertionError("phase 51: bulk --reduce-shards 2 failed")
    bulk_s = time.perf_counter() - t0
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    owner = manifest["tablets"]
    if len({owner[p] for p in FED_PREDS}) < 2:
        raise AssertionError(f"phase 51: the bulk put {FED_PREDS} on one "
                             f"group: {owner}")
    one = bulk_load([path], schema=schema, device=dev)
    q = ('{ q(func: eq(%s, "n7")) { %s %s %s { %s %s ~%s { %s } } } }'
         % (name, name, age, follows, name, age, follows, name))
    want = one.query(q)["data"]
    with ProcessCluster(groups=2, replicas=1, zeros=1, snapshots={
            g: os.path.join(out, f"g{g}", "p.snap") for g in (1, 2)},
            log_dir=os.path.join(work, "fed-logs"), device=str(dev)) as pc:
        rc = pc.routed(timeout=120.0)
        try:
            pc.wait_ready(timeout_s=CLUSTER_WAIT_S)
            wait_until("phase 51: both groups' bulk tablets in zero's map",
                       lambda: set(FED_PREDS) <= set(
                           rc.tablet_map()["tablets"]), every_s=0.5)
            got = rc.query(q)
            if got["data"] != want or not got["extensions"].get("federated"):
                raise AssertionError(f"phase 51: the federated query "
                                     f"{got.get('extensions')} != one "
                                     f"engine's answer")
            tmap = rc.tablet_map()["tablets"]
            heavy = max((1, 2), key=lambda g: sum(
                1 for p, o in tmap.items() if o == g
                and not p.startswith("dgraph.")))
            extra = [f"fextra{i}" for i in range(FED_EXTRA)]
            for p in extra:
                rc.zero.tablet(p, heavy)
                rc.mutate(set_nquads=f'<0x1> <{p}> "x" .')
            topo = os.path.join(work, "topology.json")
            with open(topo, "w") as f:
                json.dump({"zero": {str(i): f"{h}:{p}" for i, (h, p) in
                                    pc.zero_addrs.items()},
                           "groups": {str(g): {str(i): f"{h}:{p}" for i,
                                               (h, p) in a.items()}
                                      for g, a in pc.group_addrs.items()}},
                          f)
            before = dict(rc.tablet_map()["tablets"])
            t0 = time.perf_counter()
            if cli.main(["rebalance", topo, "--once", "--device",
                         str(dev)]) != 0:
                raise AssertionError("phase 51: rebalance --once failed")
            move_s = time.perf_counter() - t0
            moved = {p: (before[p], o) for p, o in
                     rc.tablet_map()["tablets"].items()
                     if p in before and before[p] != o}
            if not moved:
                raise AssertionError(f"phase 51: rebalance moved no tablet "
                                     f"({before})")
            again = rc.query(q)
            if again["data"] != want:
                raise AssertionError("phase 51: the query after the move "
                                     "!= one engine's answer")
        finally:
            rc.close()
    log(f"cluster: `bulk --reduce-shards 2` of {CLI_NODES} nodes' "
        f"{name}/{age} and {len(pairs)} {follows} edges in {bulk_s:.2f} s, "
        f"tablets {dict((p, owner[p]) for p in FED_PREDS)}; two groups of "
        f"`node --device {dev}` booted from g1/g2 p.snap; a query spanning "
        f"both (federated) equal to one engine's; `rebalance --once` after "
        f"{FED_EXTRA} tablets claimed on group {heavy} moved {moved} in "
        f"{move_s:.2f} s, and the query after the cutover equal again "
        f"| {card}")


COLD_LIVE_SCALE = 1                # phase 37's live_load against bulk_load
COLD_AND_REPS = 8                  # allofterms runs a word set, phase 39
COLD_RESTORED_QUERIES = 16         # similar_to on the restored engine, 42
B500M_GROUPS = 4                   # of tools/bench_500m.py's 64
B500M_SAMPLE = 2                   # of its 12 sampled groups
B500M_REPS = 3                     # of its 7


def bench_500m():
    """tools/bench_500m.py, loaded by its path: S1-S5's shapes, the
    schema and the published widths (its module imports only the
    standard library and numpy; its seeding uses the reference's store,
    so the plane seeds the port's with the same generator)."""
    import importlib.util

    path = os.path.join(REPO, "tools", "bench_500m.py")
    spec = importlib.util.spec_from_file_location("bench_500m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted_query(db, kernels, text: str, name: str, n: int, label: str):
    reset_launches(kernels)
    t0 = time.perf_counter()
    out = db.query(text)["data"]
    ms = (time.perf_counter() - t0) * 1e3
    only_launched(label, launches_of(kernels), name, n)
    return out, ms


def cold_plane(dev, card: str, state: dict) -> list[dict]:
    """Phases 37-42: cold storage and ingest (`ingest/`, `storage/backup`,
    `engine/lazy_tablets`, `prefetch`, `result_cache`) on the card, on
    the write plane's engine exported and bulk-loaded into a store under
    build/cold_plane/ (removed at the end). Phase 42 backs up the store
    engine of phase 39, so it runs before 40 and 41. Returns the kernels
    line's entries of score_int8_lists, score_dot and bitmap_and as the
    store-backed engines drive them."""
    import shutil

    work = os.path.join(REPO, "build", "cold_plane")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        cold = {}
        t0 = time.perf_counter()
        cold_load(dev, card, state, work, cold)
        log(f"cold plane, phase 37: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cold_reopen(dev, card, state, cold)
        log(f"cold plane, phase 38: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        db = cold_kernels(dev, card, state, cold)
        log(f"cold plane, phase 39: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cold_backup(dev, card, state, cold, db, work)
        log(f"cold plane, phase 42: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cold_result_cache(dev, card, state, cold)
        log(f"cold plane, phase 40: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cold_500m(dev, card, work)
        log(f"cold plane, phase 41: {time.perf_counter() - t0:.1f} s")
        launches = dict(cold["launches"])
        # score_int8_lists also ran once a calibration step of the rollup
        launches["score_int8"] += cold["rollup"]["launches"]
        return path_kernel_entries(dev, card, cold, launches, "cold",
                                   "the cold path")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cold_engine(store: str, dev, **kw):
    """A store-backed card engine; its store is the host runtime's LSM
    store (NativeKV), the default."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.engine.db import GraphDB

    db = GraphDB(store_dir=store, device=dev,
                 vec_index_min_rows=WRITE_VECS // 2, **kw)
    if not isinstance(db.tablet_store.kv, native.NativeKV):
        raise AssertionError(f"cold plane: the store is "
                             f"{type(db.tablet_store.kv).__name__}")
    return db


def cold_load(dev, card: str, state: dict, work: str, cold: dict) -> None:
    """Phase 37: export, bulk load into a store, train, checkpoint."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ingest import (
        bulk_load, export_rdf, export_schema, live_load,
    )
    from dgraph_tpu_torch.ops import ivf, kernels

    src = state["db"]
    t0 = time.perf_counter()
    lines = list(export_rdf(src))
    schema = export_schema(src)
    export_s = time.perf_counter() - t0
    preds = {ln.split(" ", 2)[1][1:-1] for ln in lines}
    vec_lines = [ln for ln in lines if " <embedding> " in ln]
    paths = {"graph": os.path.join(work, "graph.rdf"),
             "vectors": os.path.join(work, "vectors.rdf")}
    with open(paths["graph"], "w") as f:
        f.writelines(ln + "\n" for ln in lines if " <embedding> " not in ln)
    with open(paths["vectors"], "w") as f:
        f.writelines(ln + "\n" for ln in vec_lines)
    cold["sizes"] = {p: src.tablets[p].approx_bytes() for p in preds}
    n_lines, n_vecs = len(lines), len(vec_lines)
    del lines, vec_lines
    store = os.path.join(work, "store")
    cold["store"] = store
    db = cold_engine(store, dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    bulk_load([paths["graph"]], schema=schema, db=db)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk_load([paths["vectors"]], db=db)
    vec_s = time.perf_counter() - t0
    if dict.keys(db.tablets) or db.tablets.stored != preds:
        raise AssertionError(f"bulk_load left {sorted(dict.keys(db.tablets))}"
                             f" resident; stored {len(db.tablets.stored)} of "
                             f"{len(preds)} predicates")
    load_launches = launches_of(kernels)
    calls = []

    def recorded(codes, qs, table, out, **kw):
        calls.append((codes, qs, table, out, kw))
        return kernels.score_int8_lists(codes, qs, table, out, **kw)

    ivf.score_int8_lists = recorded
    try:
        reset_launches(kernels)
        t0 = time.perf_counter()
        db.rollup_all(0)
        torch.cuda.synchronize()
        rollup_s = time.perf_counter() - t0
        launches = launches_of(kernels)
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
    tab = db.tablets["embedding"]
    ix = tab.vector_ivf()
    if ix is None or ix.device != dev:
        raise AssertionError("rollup trained no vector index on the card")
    steps = calibration_steps(ivf, ix)
    only_launched("rollup after bulk_load", launches, "score_int8", steps)
    if len(calls) != steps or any(load_launches.values()):
        raise AssertionError(f"{len(calls)} recorded calibration calls for "
                             f"{steps} steps; bulk_load launched "
                             f"{load_launches}")
    cold["rollup"] = {"launches": steps, "call": calls[-1]}
    # flush_all writes back only tablets whose base moved since their last
    # save; the index trained over the bulk-loaded base reaches the store
    # by an explicit save (as it would through the reference's engine)
    t0 = time.perf_counter()
    db.tablet_store.save(tab)
    db.checkpoint()
    db.close()
    ckpt_s = time.perf_counter() - t0
    store_mb = sum(os.path.getsize(os.path.join(store, f))
                   for f in os.listdir(store)) / 2**20
    log(f"cold load: export_rdf of the write plane's engine ({len(preds)}"
        f" predicates: the golden graph at scale {GOLDEN_SCALE}, {WRITE_VECS}"
        f" x {WRITE_DIM} embeddings, {LABEL_NODES} labels) {n_lines} lines "
        f"in {export_s:.2f} s; bulk_load into GraphDB(store_dir, device="
        f"cuda:0): {n_lines - n_vecs} RDF in {graph_s:.2f} s "
        f"({(n_lines - n_vecs) / graph_s:.0f} RDF/s), {n_vecs} vectors in "
        f"{vec_s:.2f} s ({n_vecs / vec_s:.0f} vectors/s), every predicate "
        f"offloaded as its reduce finished (0 resident), no kernel "
        f"launched; rollup_all(0) {rollup_s:.2f} s trained the index "
        f"{ix.describe()} on the card, score_int8_lists {steps} launches = "
        f"{steps} calibration steps, every other kernel 0; save + "
        f"checkpoint + close {ckpt_s:.2f} s, store {store_mb:.1f} MiB | "
        f"{card}")

    # live_load and bulk_load agree (the systest bulk/live equivalence)
    schema1, lines1 = golden_dataset().generate(COLD_LIVE_SCALE)
    path1 = os.path.join(work, "golden1.rdf")
    with open(path1, "w") as f:
        f.write("\n".join(lines1) + "\n")
    live = GraphDB(device=dev)
    t0 = time.perf_counter()
    stats = live_load(live, [path1], schema=schema1)
    live_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk = bulk_load([path1], schema=schema1, device=dev)
    bulk_s = time.perf_counter() - t0
    a, b = sorted(export_rdf(live)), sorted(export_rdf(bulk))
    if a != b or stats["nquads"] != len(lines1):
        raise AssertionError(f"live_load ({stats}) and bulk_load export "
                             f"differ: {len(a)} against {len(b)} lines")
    log(f"live_load of the scale-{COLD_LIVE_SCALE} golden RDF into "
        f"GraphDB(device=cuda:0): {len(lines1)} RDF in {live_s:.2f} s "
        f"({len(lines1) / live_s:.0f} RDF/s, {stats['txns']} transactions, "
        f"{stats['aborts']} aborts); bulk_load {bulk_s:.2f} s "
        f"({len(lines1) / bulk_s:.0f} RDF/s); their {len(a)} export lines "
        f"equal after a sort | {card}")


def cold_reopen(dev, card: str, state: dict, cold: dict) -> None:
    """Phase 38: reopen under a budget a third of the tablets' bytes."""
    from dgraph_tpu_torch.utils import metrics

    total = sum(cold["sizes"].values())
    budget = total // 3
    cold["budget"] = budget
    db = cold_engine(cold["store"], dev, tablet_budget=budget,
                     prefetch_workers=2, planner="adaptive")
    golden = golden_queries()
    want = state["golden10"]
    split = {}
    before = metrics.counters_snapshot()
    # one cold pass: the warm pass (32.0 s beside an H100 80GB HBM3) gave
    # its time to the cluster plane
    for kind in ("cold",):
        ms = []
        for name, text, _ in golden:
            t0 = time.perf_counter()
            got = db.query(text)["data"]
            ms.append((time.perf_counter() - t0) * 1e3)
            if not json_close(got, want[name]):
                raise AssertionError(f"{name} from the reopened store ({kind}"
                                     f" pass) != phase 28's answer")
        split[kind] = ms
    delta = metrics.counters_delta(before)
    loads = delta.get("tablet_store_loads", 0)
    evictions = delta.get("tablet_store_evictions", 0)
    if loads <= 0 or evictions <= 0:
        raise AssertionError(f"budget {budget}: {loads} loads, {evictions} "
                             f"evictions")
    pf = db.prefetcher.stats()
    log(f"reopen: GraphDB(store_dir, tablet_budget={budget} (a third of the "
        f"{total} approx_bytes of the {len(cold['sizes'])} stored tablets), "
        f"prefetch_workers=2, planner=adaptive, device=cuda:0); the 75 "
        f"goldens equal phase 28's card answers on a cold pass "
        f"{sum(split['cold']):.1f} ms (a sum, host clock); tablet_store_loads +{loads:g}, evictions "
        f"+{evictions:g}, peak resident {db.tablets.peak_resident} bytes; "
        f"prefetch hits {pf['hits']}, misses {pf['misses']}, waits "
        f"{pf['waits']}, bytes {pf['bytes']} (scheduled {pf['scheduled']})"
        f" | {card}")
    db.close()


def cold_kernels(dev, card: str, state: dict, cold: dict):
    """Phase 39: similar_to and allofterms through the store."""
    import gc

    from dgraph_tpu_torch.ops import ivf, kernels, knn, setops

    # the default budget holds the whole store: phase 42's backups walk
    # every tablet, which under phase 38's budget would decode each anew
    db = cold_engine(cold["store"], dev, prefetch_workers=2,
                     planner="static")
    sim = state["similar"]
    lits, root_q = sim["lits"], sim["root_q"]
    last = {}

    def recorded(fn, key):
        def run(*args, **kw):
            last[key] = (args, kw)
            return fn(*args, **kw)
        return run

    def similar(tier, name, want, label):
        db.vec_quantized = tier == "quantized"
        ms = []
        for i, lit in enumerate(lits):
            out, t = counted_query(db, kernels, root_q % (SIMILAR_K, lit),
                                   name, 1, f"{label} {i}")
            if out["q"] != want[i]:
                raise AssertionError(f"{label} {i} != phase 29's answer")
            ms.append(t)
        db.vec_quantized = True
        return ms

    launches = {"score_int8": 0, "score_dot": 0, "bitmap_and": 0}
    ivf.score_int8_lists = recorded(kernels.score_int8_lists, "int8")
    knn.score_dot = recorded(kernels.score_dot, "dot")
    try:
        quant_ms = similar("quantized", "score_int8", sim["quant"],
                           "quantized tier from the store")
        exact_ms = similar("exact", "score_dot", sim["exact"],
                           "exact tier from the store")
        last.clear()            # the recorded arguments hold the index
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        ix_bytes = db.tablets["embedding"].vector_ivf().nbytes
        if not db.tablets.offload("embedding"):
            raise AssertionError("the vector tablet did not offload")
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated(dev)
        again_ms = similar("quantized", "score_int8", sim["quant"],
                           "quantized tier after an offload")
        similar("exact", "score_dot", sim["exact"],
                "exact tier after an offload")
        ix = db.tablets["embedding"].vector_ivf()
        if ix is None or ix.device != dev:
            raise AssertionError("the reloaded index is not on the card")
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated(dev)
    finally:
        ivf.score_int8_lists = kernels.score_int8_lists
        knn.score_dot = kernels.score_dot
    launches["score_int8"] = 2 * len(lits)
    launches["score_dot"] = 2 * len(lits)
    cold["int8"], cold["dot"] = last["int8"], last["dot"]
    log(f"similar_to through the store, {len(lits)} requests a pass, k "
        f"{SIMILAR_K}: the quantized tier one score_int8_lists launch a "
        f"request and no calibration (the index came from the blob), "
        f"p50 {pct(quant_ms, 50):.3f} ms p99 {pct(quant_ms, 99):.3f}; the "
        f"exact tier one score_dot launch a request, p50 "
        f"{pct(exact_ms, 50):.3f} ms; each answer equal to phase 29's; "
        f"offloading the vector tablet moved memory_allocated "
        f"{mem0} -> {mem1} bytes (its index {ix_bytes}); reloaded, both "
        f"tiers answer the same with the same launches (memory_allocated "
        f"{mem2}), quantized p50 {pct(again_ms, 50):.3f} ms (host clock) | "
        f"{card}")

    # allofterms over the lazily loaded label tablet
    and_device = setops.bitmap_and_device

    def rec_and(mats, device=None):
        last["mats"] = (mats, device)
        return and_device(mats, device)

    setops.bitmap_and_device = rec_and
    try:
        db.tablets.offload("label")
        for words, want in state["labels"].items():
            text = '{ q(func: allofterms(label, "%s")) { uid } }' % words
            ms = []
            for r in range(COLD_AND_REPS):
                out, t = counted_query(db, kernels, text, "bitmap_and", 1,
                                       f"allofterms {words} run {r}")
                ms.append(t)
                if [int(x["uid"], 16) for x in out["q"]] != want:
                    raise AssertionError(f"allofterms {words} from the "
                                         f"store != phase 30's answer")
            launches["bitmap_and"] += COLD_AND_REPS
            if len(words.split()) == 2:
                cold["mats"] = last["mats"]
            log(f"allofterms(label, \"{words}\") x {COLD_AND_REPS} from the "
                f"store: {len(want)} uids = phase 30's = the numpy oracle, "
                f"one bitmap_and launch a query, p50 {pct(ms, 50):.3f} ms "
                f"(host clock) | {card}")
    finally:
        setops.bitmap_and_device = and_device
    cold["launches"] = launches
    return db


def cold_backup(dev, card: str, state: dict, cold: dict, db,
                work: str) -> None:
    """Phase 42: backup, incremental backup, restore, restore_to_ts."""
    from dgraph_tpu_torch import wire
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ops import ivf, kernels
    from dgraph_tpu_torch.storage import backup, snapshot

    dest = "file://" + os.path.join(work, "bk")
    t0 = time.perf_counter()
    e1 = backup.backup(db, dest)
    full_s = time.perf_counter() - t0
    first = tablet_dumps(db, wire, snapshot)
    db.mutate(set_nquads=f'<{LABEL_UID0 + LABEL_NODES:#x}> <label> '
                         f'"w0 w1 cold" .')
    t0 = time.perf_counter()
    e2 = backup.backup(db, dest)
    inc_s = time.perf_counter() - t0
    if e1["type"] != "full" or e2["type"] != "incremental" or \
            e2["predicates"] != ["label"]:
        raise AssertionError(f"backup chain {e1['type']} {e2['type']} "
                             f"{e2['predicates']}")
    final = tablet_dumps(db, wire, snapshot)
    db.close()
    build = ivf.build
    ivf.build = None            # nothing below may train an index
    try:
        t0 = time.perf_counter()
        # static planner: the launch check pins the quantized tier
        restored = backup.restore(dest, db=GraphDB(
            device=dev, planner="static",
            vec_index_min_rows=WRITE_VECS // 2))
        restore_s = time.perf_counter() - t0
        same_dumps("restore", tablet_dumps(restored, wire, snapshot), final)
        t0 = time.perf_counter()
        at = backup.restore_to_ts(dest, e1["read_ts"], device=dev)
        pitr_s = time.perf_counter() - t0
        same_dumps("restore_to_ts at the full backup",
                   tablet_dumps(at, wire, snapshot), first)
        del at
        sim = state["similar"]
        ms = []
        for i, lit in enumerate(sim["lits"][:COLD_RESTORED_QUERIES]):
            out, t = counted_query(restored, kernels, sim["root_q"] % (
                SIMILAR_K, lit), "score_int8", 1, f"restored similar_to {i}")
            if out["q"] != sim["quant"][i]:
                raise AssertionError(f"restored similar_to {i} != phase 29's")
            ms.append(t)
        ix = restored.tablets["embedding"].vector_ivf()
        if ix is None or ix.device != dev:
            raise AssertionError("the restored index is not on the card")
    finally:
        ivf.build = build
    cold["launches"]["score_int8"] += COLD_RESTORED_QUERIES
    log(f"backup of the store engine to {dest[:7]}build/cold_plane/bk: full "
        f"{full_s:.2f} s ({len(e1['predicates'])} predicates, read_ts "
        f"{e1['read_ts']}), a commit, incremental {inc_s:.2f} s "
        f"({e2['predicates']}); restore onto GraphDB(device=cuda:0, "
        f"planner=static) "
        f"{restore_s:.2f} s, every predicate's dump_tablet bytes equal to the"
        f" source's; restore_to_ts({e1['read_ts']}) {pitr_s:.2f} s equal to "
        f"the dumps at the full backup; the restored index on the card, "
        f"{COLD_RESTORED_QUERIES} similar_to requests each one "
        f"score_int8_lists launch and no training, equal to phase 29's, p50 "
        f"{pct(ms, 50):.3f} ms | {card}")


def cold_result_cache(dev, card: str, state: dict, cold: dict) -> None:
    """Phase 40: the result cache on a reopened store engine."""
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.utils import metrics

    db = cold_engine(cold["store"], dev, result_cache_entries=4096)
    sim = state["similar"]
    texts = [t for _, t, _ in golden_queries()] + \
        [sim["root_q"] % (SIMILAR_K, lit) for lit in sim["lits"]]
    runs = {}
    hit_at = []
    for kind in ("fill", "hit"):
        before = metrics.counters_snapshot()
        reset_launches(kernels)
        outs, ms = [], []
        for i, text in enumerate(texts):
            h0 = metrics.get_counter("dgraph_result_cache_hits_total")
            t0 = time.perf_counter()
            outs.append(db.query(text)["data"])
            ms.append((time.perf_counter() - t0) * 1e3)
            if metrics.get_counter("dgraph_result_cache_hits_total") > h0:
                hit_at.append(i)
        runs[kind] = (outs, ms, metrics.counters_delta(before),
                      launches_of(kernels))
    fills = runs["fill"][2].get("dgraph_result_cache_misses_total", 0)
    hits = runs["hit"][2].get("dgraph_result_cache_hits_total", 0)
    if runs["hit"][0] != runs["fill"][0] or hits != fills or hits <= 0 \
            or any(runs["hit"][3].values()):
        raise AssertionError(f"result cache: {hits} hits for {fills} fills, "
                             f"hit-pass launches {runs['hit'][3]}")
    json.dumps(runs["hit"][0])       # answers hold no tensors
    text = '{ q(func: allofterms(label, "w0 w1")) { uid } }'
    db.query(text)
    before = metrics.counters_snapshot()
    db.query(text)
    new = LABEL_UID0 + LABEL_NODES + 1
    db.mutate(set_nquads=f'<{new:#x}> <label> "w0 w1" .')
    got = [int(x["uid"], 16) for x in db.query(text)["data"]["q"]]
    delta = metrics.counters_delta(before)
    if new not in got or delta.get("dgraph_result_cache_hits_total") != 1 \
            or delta.get("dgraph_result_cache_invalidations_total", 0) <= 0:
        raise AssertionError(f"a commit to label: {delta}, new uid served "
                             f"{new in got}")
    log(f"result cache (result_cache_entries=4096) on a reopened store "
        f"engine (the default tablet budget): {len(texts)} requests (75 "
        f"goldens, {len(sim['lits'])} similar_to) twice: {fills:g} fills, then {hits:g} hits with "
        f"answers equal to the fills' and zero kernel launches (fill pass "
        f"{runs['fill'][3]}); a commit to label invalidated "
        f"{delta.get('dgraph_result_cache_invalidations_total', 0):g} "
        f"entries and the next allofterms answer holds the write; p50 of a "
        f"miss {pct([runs['fill'][1][i] for i in hit_at], 50):.3f} ms, of a "
        f"hit {pct([runs['hit'][1][i] for i in hit_at], 50):.3f} ms (host "
        f"clock) | {card}")
    db.close()


def seed_500m(b5, store, groups: int, uids: int) -> tuple[int, int]:
    """tools/bench_500m.py's seed() through the port's bulkseed: the same
    generator, seeds and widths. Returns (edges, bytes)."""
    from dgraph_tpu_torch.storage import bulkseed

    schema = b5.schema_text(groups)
    edges = nbytes = 0
    fs, fd = min(b5.FOLLOW_SRCS, uids), b5.FOLLOW_DEG
    for g in range(groups):
        rng = np.random.default_rng(1000 + g)
        base = np.uint64(g) * np.uint64(uids)
        u = base + np.arange(1, uids + 1, dtype=np.uint64)
        scores = rng.integers(0, b5.SCORE_DOMAIN, uids).astype(np.int64)
        tcodes = rng.integers(0, len(b5.TIERS), uids).astype(np.int64)
        rcodes = rng.integers(0, len(b5.REGIONS), uids).astype(np.int64)
        indptr = np.arange(fs + 1, dtype=np.int64) * fd
        dsts = (base + 1 + rng.integers(0, uids, fs * fd)
                .astype(np.uint64)).reshape(fs, fd)
        dsts.sort(axis=1)
        dsts = dsts + np.arange(fd, dtype=np.uint64) * np.uint64(uids)
        blobs = [
            (f"score_{g}", bulkseed.int_tablet_blob(schema, u, scores, 1)),
            (f"tier_{g}", bulkseed.str_tablet_blob(
                schema, u, b5.TIERS, tcodes, 1)),
            (f"region_{g}", bulkseed.str_tablet_blob(
                schema, u, b5.REGIONS, rcodes, 1)),
            (f"follow_{g}", bulkseed.uid_tablet_blob(
                schema, u[:fs], indptr, dsts.reshape(-1), 1)),
        ]
        nbytes += bulkseed.seed_store(store, schema, blobs, max_ts=1)
        edges += b5.group_edges(uids, fs, fd)
    store.compact()
    store.close()
    return edges, nbytes


def cold_500m(dev, card: str, work: str) -> None:
    """Phase 41: tools/bench_500m.py's S1-S5 at its published widths."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.engine.lazy_tablets import TabletStore
    from dgraph_tpu_torch.utils import metrics

    b5 = bench_500m()
    uids = b5.U_DEFAULT
    path = os.path.join(work, "b500m")
    t0 = time.perf_counter()
    edges, nbytes = seed_500m(b5, TabletStore(path, dev), B500M_GROUPS, uids)
    seed_s = time.perf_counter() - t0
    gsel = sorted(np.random.default_rng(7).choice(
        B500M_GROUPS, min(B500M_SAMPLE, B500M_GROUPS),
        replace=False).tolist())
    shape_names = list(b5.shapes(0))
    # a group's three tablets hold about 87 approx bytes a uid (score 32,
    # tier 29, region 26): a group and a half, below the sampled groups'
    # working set
    budget = 3 * 87 * uids // 2
    db = GraphDB(store_dir=path, tablet_budget=budget, prefetch_workers=2,
                 planner="adaptive", device=dev)
    answers = {"cold": {}, "fused": {}, "staged": {}}
    sizes = {}
    before = metrics.counters_snapshot()
    t0 = time.perf_counter()
    for g in gsel:
        for name, q in b5.shapes(g).items():
            answers["cold"][(g, name)] = b5._uids(db, q)
        # the group's tablets are resident after its shapes ran
        sizes.update({p: n for p, n in db.tablets._lru.items()
                      if p.endswith(f"_{g}")})
    cold_s = time.perf_counter() - t0
    delta = metrics.counters_delta(before)
    pf = db.prefetcher.stats()
    working = sum(sizes.values())
    times = {arm: {s: [] for s in shape_names} for arm in ("fused", "staged")}
    evict0 = db.tablets.evictions
    for arm in ("fused", "staged"):
        db.prefer_fused = arm == "fused"
        # group-major: a cyclic walk over more groups than the budget
        # holds would reload every tablet on every repetition
        for g in gsel:
            for q in b5.shapes(g).values():
                b5._uids(db, q)          # warm-up: tiles, memos
            for _ in range(B500M_REPS):
                for name, q in b5.shapes(g).items():
                    t0 = time.perf_counter()
                    answers[arm][(g, name)] = b5._uids(db, q)
                    times[arm][name].append(time.perf_counter() - t0)
    db.prefer_fused = True
    fusion = {name: db.query(q, explain="plan")["extensions"]["explain"][
        "blocks"][0].get("fusion") for name, q in b5.shapes(gsel[0]).items()}
    arm_evictions = db.tablets.evictions - evict0
    db.close()
    oracle = GraphDB(store_dir=path, tablet_budget=budget,
                     prefer_device=False, prefer_columnar=False,
                     prefer_compressed=False, prefer_fused=False, device=dev)
    t0 = time.perf_counter()
    want = {k: b5._uids(oracle, b5.shapes(k[0])[k[1]])
            for k in answers["fused"]}
    oracle_s = time.perf_counter() - t0
    oracle.close()
    bad = [k for k in want if not (want[k] == answers["fused"][k]
                                   == answers["staged"][k]
                                   == answers["cold"][k])]
    if bad or delta.get("tablet_store_evictions", 0) <= 0 or \
            len(sizes) != 3 * len(gsel) or working <= budget:
        raise AssertionError(f"S1-S5: arms disagree at {bad[:4]}; "
                             f"evictions {delta}; working set {working}")
    log(f"S1-S5 (tools/bench_500m.py, U {uids}, score/tier/region of U "
        f"postings, follow {b5.FOLLOW_SRCS} x {b5.FOLLOW_DEG}): seeded "
        f"{B500M_GROUPS} groups, {edges} edges, {nbytes / 2**20:.1f} MiB of "
        f"blobs through bulkseed and compacted in {seed_s:.2f} s; sampled "
        f"groups {gsel} (default_rng(7)); tablet_budget {budget} against a "
        f"working set of {working} approx bytes; cold pass {cold_s:.2f} s; "
        f"loads +{delta.get('tablet_store_loads', 0):g}, evictions "
        f"+{delta.get('tablet_store_evictions', 0):g} over it, "
        f"{arm_evictions} in the arms; prefetch {pf}; fused, staged, cold "
        f"and the all-tiers-off postings oracle ({oracle_s:.2f} s) "
        f"agree on all {len(want)} answers | {card}")
    for name in shape_names:
        f, s = times["fused"][name], times["staged"][name]
        log(f"  {name}: fused p50 {pct(f, 50) * 1e3:.3f} ms p95 "
            f"{pct(f, 95) * 1e3:.3f}, staged p50 {pct(s, 50) * 1e3:.3f} ms "
            f"p95 {pct(s, 95) * 1e3:.3f} ({B500M_REPS} reps x {len(gsel)} "
            f"groups, host clock); fusion {fusion[name]} | {card}")


def path_kernel_entries(dev, card: str, last: dict, launches: dict,
                        path: str, label: str) -> list[dict]:
    """The kernels line's entries of one path: score_int8_lists,
    score_dot and bitmap_and, each timed at the path's last recorded
    call (`last["int8"]`, `last["dot"]`, `last["mats"]`) from a flushed
    L2 beside its plain version, its bound and the library call;
    `launches` holds each kernel's launches on the path."""
    from dgraph_tpu_torch.ops import kernels

    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    (codes, qs, table, out), kw = last["int8"]
    int8_ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes, qs, table, out, **kw), 20, flush)
    plain_out = torch.empty_like(out)
    int8_plain = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes, qs, table, plain_out, **kw), 3)
    int8_err, ratio = lists_within_bound(codes, qs, table, out, plain_out,
                                         kw, f"score_int8_lists, {label}")
    int8_bound, int8_by = lists_bound_ms(codes, qs, table)
    (corpus, qv), _ = last["dot"]
    dot_ms = device_ms_cold(lambda: kernels.score_dot(corpus, qv), 20, flush)
    dot_plain = device_ms_cold(
        lambda: kernels.score_dot_reference(corpus, qv), 20, flush)
    dot_lib = device_ms_cold(lambda: torch.matmul(qv, corpus.T), 20, flush)
    dot_err, dratio = check_score(kernels.score_dot,
                                  kernels.score_dot_reference, corpus, qv,
                                  f"score_dot, {label}")
    dot_bound, dot_by = score_bound_ms([(corpus, qv)])
    words_in, _ = last["mats"]
    mats = torch.from_numpy(np.stack([np.ascontiguousarray(
        m, np.uint64) for m in words_in]).view(np.int64)).to(dev)
    k, b, w = mats.shape
    and_ms = device_ms_cold(lambda: kernels.bitmap_and(mats), 20, flush)
    and_plain = device_ms_cold(lambda: kernels.bitmap_and_reference(mats), 20,
                               flush)
    and_lib = device_ms_cold(lambda: torch.bitwise_and(mats[0], mats[1]), 20,
                             flush)
    and_err = int((kernels.bitmap_and(mats)
                   != kernels.bitmap_and_reference(mats)).sum())
    if and_err:
        raise AssertionError(f"bitmap_and != plain version, {label}")
    and_bound = (k + 1) * b * w * 8 / HBM_BYTES_PER_S * 1e3
    del flush
    log(f"  {label}: the launches at their shapes (device times from a "
        f"flushed L2): score_int8_lists ({len(table)} entries, worst error/"
        f"bound {ratio:.4g}) {int8_ms:.4f} ms, plain {int8_plain:.4f}, bound "
        f"{int8_bound:.5f} ({int8_by}); score_dot ({qv.shape[0]} x "
        f"{corpus.shape[0]} x {corpus.shape[1]}, worst error/bound "
        f"{dratio:.4g}) {dot_ms:.4f} ms, plain {dot_plain:.4f}, torch.matmul "
        f"{dot_lib:.4f}, bound {dot_bound:.4f} ({dot_by}); bitmap_and (k {k},"
        f" B {b}, W {w}) {and_ms:.4f} ms, plain {and_plain:.4f}, "
        f"torch.bitwise_and {and_lib:.4f}, bound {and_bound:.5f} (bytes); "
        f"launches {launches} | {card}")
    return [
        {"name": "score_int8_lists", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:158", "path": path,
         "launches": launches["score_int8"],
         "max_abs_err": int8_err, "ms": int8_ms, "plain_ms": int8_plain,
         "bound_ms": int8_bound, "bound_by": int8_by, "library_ms": None},
        {"name": "score_dot", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/score.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:123", "path": path,
         "launches": launches["score_dot"], "max_abs_err": dot_err,
         "ms": dot_ms, "plain_ms": dot_plain, "bound_ms": dot_bound,
         "bound_by": dot_by, "library_ms": dot_lib},
        {"name": "bitmap_and", "route": "cuda",
         "source": "dgraph_tpu_torch/csrc/bitmap_and.cu",
         "replaces": "dgraph_tpu/ops/pallas_kernels.py:217", "path": path,
         "launches": launches["bitmap_and"], "max_abs_err": and_err,
         "ms": and_ms, "plain_ms": and_plain, "bound_ms": and_bound,
         "bound_by": "bytes", "library_ms": and_lib},
    ]


# -- the load plane (phases 52-53) ------------------------------------------

LOAD_SEED = 20260803               # tools/dgbench.py's --seed
LOAD_PERSONS = 1 << 17             # the engine's vec_index_min_rows
LOAD_CHUNK = 50_000                # N-Quads a parse_rdf batch of bulk_load
LOAD_CONCURRENCY = 24              # dgbench's --concurrency
LOAD_OPS = 480                     # dgbench's --ops-per-phase
LOAD_PROBE = 120                   # dgbench's closed-loop probe reads
LOAD_RATES = (0.5, 0.8, 1.0)       # phase 52's offered load, x capacity
LOAD_WITNESS_OPS = 240             # phase 52's witnessed phase
LOAD_WITNESS_RATE = 0.5
LOAD_WINDOW_US = 500               # bench_queries.py's CONC_WINDOW_US
LOAD_SAMPLE_EVERY = 7              # dgbench's Driver.sample_every
DGBENCH_RATES = (0.5, 0.8)         # phase 53: dgbench's --max-phases 2
DGBENCH_SLO_MS = 400.0             # dgbench's --slo-ms
DGBENCH_MAX_PENDING = 48           # dgbench's --max-pending
DGBENCH_ERROR_BUDGET = 0.01        # dgbench's --error-budget
LOAD_OUTCOMES = ("ok", "shed", "deadline", "error")


def load_plane(dev, card: str) -> list[dict]:
    """Phases 52-53: the seeded LDBC-SNB-style workload
    (`bench/workload`) under open-loop arrivals (`bench/openloop`),
    served from the card in process through the micro-batcher and by a
    `node` process, in build/load/ (removed at the end). Returns the
    kernels line's entry of score_int8_lists as the load drives it."""
    import gc
    import shutil

    from dgraph_tpu_torch.ops import ivf, kernels
    from dgraph_tpu_torch.storage.snapshot import save_snapshot

    work = os.path.join(REPO, "build", "load")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    last: dict = {}

    def recorded(*args, **kw):
        last["int8"] = (args, kw)
        return kernels.score_int8_lists(*args, **kw)

    try:
        t0 = time.perf_counter()
        db, w = load_graph(dev, card)
        log(f"load plane, set-up: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ivf.score_int8_lists = recorded
        try:
            inproc = load_in_process(dev, card, db, w)
        finally:
            ivf.score_int8_lists = kernels.score_int8_lists
        log(f"load plane, phase 52: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        snap = os.path.join(work, "g1.snap")
        save_snapshot(db, snap)
        save_s = time.perf_counter() - t0
        del db
        gc.collect()
        torch.cuda.empty_cache()
        alphas = load_cluster(dev, card, w, snap, save_s, work)
        log(f"load plane, phase 53: {time.perf_counter() - t0:.1f} s")
        return load_kernel_entries(dev, card, last, inproc, alphas)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_graph(dev, card: str):
    """The workload's graph (2^17 persons) bulk-loaded into a card engine
    with the static planner, rolled up so its vector index is trained."""
    from dgraph_tpu_torch.bench.workload import Workload, WorkloadConfig
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.gql.nquad import parse_rdf
    from dgraph_tpu_torch.ingest import bulk_load
    from dgraph_tpu_torch.ops import ivf, kernels

    t0 = time.perf_counter()
    w = Workload(WorkloadConfig(seed=LOAD_SEED, persons=LOAD_PERSONS))
    quads = w.quads()
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    db = GraphDB(device=dev, planner="static")
    reset_launches(kernels)
    t0 = time.perf_counter()
    bulk_load(nquads=(parse_rdf("\n".join(quads[s:s + LOAD_CHUNK]))
                      for s in range(0, len(quads), LOAD_CHUNK)),
              schema=w.schema(), db=db)
    load_s = time.perf_counter() - t0
    loaded = launches_of(kernels)
    t0 = time.perf_counter()
    db.rollup_all(0)
    torch.cuda.synchronize()
    rollup_s = time.perf_counter() - t0
    launches = launches_of(kernels)
    ix = db.tablets["person.embedding"].vector_ivf()
    if ix is None or ix.device != dev:
        raise AssertionError("load: rollup trained no vector index on the "
                             "card")
    if any(loaded.values()):
        raise AssertionError(f"load: bulk_load launched {loaded}")
    only_launched("load: rollup after bulk_load", launches, "score_int8",
                  calibration_steps(ivf, ix))
    m1 = torch.cuda.memory_allocated(dev)
    log(f"load: Workload(WorkloadConfig(seed={LOAD_SEED}, persons="
        f"{LOAD_PERSONS})) default mix {dict(w.cfg.mix)}: {len(quads)} "
        f"quads generated in {gen_s:.2f} s; bulk_load into GraphDB(device="
        f"{dev}, planner=static) in {load_s:.2f} s ({len(quads) / load_s:.0f}"
        f" RDF/s); rollup_all(0) {rollup_s:.2f} s trained person.embedding's"
        f" index (nlist {ix.nlist}, nprobe {ix.nprobe}, "
        f"{launches['score_int8']} calibration launches); "
        f"{(m1 - m0) / 2**20:.1f} MiB charged to the card | {card}")
    return db, w


def load_submit(db, mb, rw):
    """bench_queries.py --concurrency's submit, for one op of the
    workload: reads through the micro-batcher (under the read lock), writes
    on the engine under the write lock. Never raises: the open loop keeps
    its schedule whatever the engine answers."""
    def submit(req) -> dict:
        i, op = req
        rec = {"outcome": "ok", "kind": op.kind, "write": op.write}
        try:
            if op.write:
                with rw.write:
                    db.mutate(set_nquads=op.set_nquads, commit_now=True)
            else:
                out = json.loads(mb.query_json(op.query))
                if i % LOAD_SAMPLE_EVERY == 0:
                    rec["data"] = json.dumps(out.get("data"),
                                             sort_keys=True)
        except Exception as e:  # noqa: BLE001 — classified, reported
            rec["outcome"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"[:200]
        return rec
    return submit


def load_run_phase(submit, ops, rate: float, concurrency: int) -> dict:
    """tools/dgbench.py's run_phase: one open-loop phase at `rate`
    offered QPS; latencies (from the scheduled arrival) and records
    aligned by op index."""
    from dgraph_tpu_torch.bench.openloop import run_open_loop

    results: list = []
    t0 = time.monotonic()
    lat = run_open_loop(submit, list(enumerate(ops)), concurrency, rate,
                        results=results)
    wall = time.monotonic() - t0
    recs = [None] * len(ops)
    for i, rec in results:
        recs[i] = rec
    return {"lat": lat, "recs": recs, "wall_s": wall, "rate": rate}


def load_phase_report(phase: dict, slo_ms: float,
                      error_budget: float) -> dict:
    """tools/dgbench.py's phase_report: outcome counts, p99 over
    successful ops, the per-class split, pass or fail against the SLO."""
    from dgraph_tpu_torch.bench.openloop import latency_summary

    lat, recs = phase["lat"], phase["recs"]
    out = {k: 0 for k in LOAD_OUTCOMES}
    ok_lat, by_class, by_outcome = [], {}, {}
    errors = []
    for i, rec in enumerate(recs):
        if rec is None:
            continue
        out[rec["outcome"]] += 1
        by_outcome.setdefault(rec["outcome"], []).append(lat[i])
        if rec["outcome"] == "ok":
            ok_lat.append(lat[i])
            by_class.setdefault(rec["kind"], []).append(lat[i])
        elif "error" in rec:
            errors.append(rec["error"])
    total = max(sum(out.values()), 1)
    bad = out["shed"] + out["deadline"] + out["error"]
    p99 = latency_summary(ok_lat).get("p99_ms") if ok_lat else None
    passed = (bool(ok_lat) and p99 <= slo_ms
              and bad / total <= error_budget)
    return {
        "offered_qps": round(phase["rate"], 2),
        "wall_s": round(phase["wall_s"], 2),
        "ok_qps": round(out["ok"] / max(phase["wall_s"], 1e-9), 2),
        "p99_ms": p99,
        "ok": latency_summary(ok_lat),
        "outcomes": out,
        "bad_frac": round(bad / total, 4),
        "error_budget": error_budget,
        "passed": passed,
        "by_class": {k: latency_summary(v)
                     for k, v in sorted(by_class.items())},
        "by_outcome": {k: latency_summary(v)
                       for k, v in sorted(by_outcome.items())},
        "errors_sample": sorted(set(errors))[:5],
    }


def load_parity(phase: dict, ops, replay) -> tuple[int, list]:
    """tools/dgbench.py's differential parity: each sampled read's data,
    taken under load, against `replay(query)` run one after another after
    quiescing; (reads checked, mismatches)."""
    checked, mismatches = 0, []
    for i, rec in enumerate(phase["recs"]):
        if not rec or "data" not in rec:
            continue
        try:
            oracle = json.dumps(replay(ops[i].query).get("data"),
                                sort_keys=True)
        except Exception as e:  # noqa: BLE001 — a mismatch, reported
            oracle = f"<replay failed: {e}>"
        checked += 1
        if oracle != rec["data"]:
            mismatches.append({"kind": rec["kind"], "index": i,
                               "got": rec["data"][:160],
                               "oracle": oracle[:160]})
    return checked, mismatches


def class_line(rep: dict) -> str:
    return "; ".join(f"{k} n {v['count']} p50 {v['p50_ms']} p99 "
                     f"{v['p99_ms']}" for k, v in rep["by_class"].items())


def load_probe(submit, reads, concurrency: int) -> float:
    """dgbench's closed-loop capacity probe: `reads` from `concurrency`
    workers, each firing the next the moment the last returns; ops/s.
    Any read that is not ok fails it."""
    import threading

    nxt, lock = [0], threading.Lock()
    bad = []

    def worker():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(reads):
                    return
                nxt[0] += 1
            rec = submit((i, reads[i]))
            if rec["outcome"] != "ok":
                bad.append(rec)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if bad:
        raise AssertionError(f"load probe: {bad[:3]}")
    return len(reads) / (time.monotonic() - t0)


def load_in_process(dev, card: str, db, w) -> int:
    """Phase 52: one alpha in process, as bench_queries.py --concurrency
    drives it: a capacity probe, open-loop phases at LOAD_RATES x the
    probed capacity, then a fixed-rate phase under the port's lockcheck
    and racecheck. Returns score_int8_lists' launches over the phases."""
    import gc
    import threading

    from dgraph_tpu_torch.engine.batcher import MicroBatcher
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.utils import lockcheck, metrics, racecheck
    from dgraph_tpu_torch.utils.rwlock import RWLock

    def replay(q):
        with rw.read:
            return json.loads(db.query_json(q))

    def one_phase(label, ops, rate, submit):
        similar = [op.query for op in ops if op.kind == "similar"]
        if len(set(similar)) != len(similar):
            raise AssertionError(f"{label}: repeated similar_to texts")
        gc.collect()
        gen2 = gc.get_stats()[2]["collections"]
        reset_launches(kernels)
        d0 = metrics.counters_snapshot().get("batch_dispatches", 0)
        ph = load_run_phase(submit, ops, rate, LOAD_CONCURRENCY)
        launches = launches_of(kernels)
        gen2 = gc.get_stats()[2]["collections"] - gen2
        dispatches = metrics.counters_snapshot().get(
            "batch_dispatches", 0) - d0
        rep = load_phase_report(ph, DGBENCH_SLO_MS, DGBENCH_ERROR_BUDGET)
        checked, bad = load_parity(ph, ops, replay)
        oc = rep["outcomes"]
        if oc["ok"] != len(ops):
            raise AssertionError(f"{label}: outcomes {oc}, "
                                 f"{rep['errors_sample']}")
        if bad or not checked:
            raise AssertionError(f"{label}: parity {len(bad)} of {checked} "
                                 f"sampled reads differ: {bad[:3]}")
        if launches["score_int8"] != len(similar) or launches["bucket_or"] \
                or launches["bucket_or_level"]:
            raise AssertionError(f"{label}: launches {launches} for "
                                 f"{len(similar)} similar_to ops")
        log(f"load: {label}: {len(ops)} ops offered at {rate:.1f}/s, "
            f"achieved {rep['ok_qps']}/s in {rep['wall_s']} s; ms from the "
            f"scheduled arrival (host clock) p50 {rep['ok']['p50_ms']} p99 "
            f"{rep['ok']['p99_ms']}; by class: {class_line(rep)}; outcomes "
            f"{oc}; batcher dispatches {dispatches}; launches {launches} "
            f"({len(similar)} similar_to ops); {gen2} full garbage "
            f"collections; parity {checked} sampled reads equal to their "
            f"replay | {card}")
        return rep, launches["score_int8"]

    rw = RWLock()
    mb = MicroBatcher(db, window_us=LOAD_WINDOW_US, read_lock=lambda: rw.read)
    submit = load_submit(db, mb, rw)
    for op in w.ops(40, stream_seed=999):   # dgbench's warmup
        if not op.write:
            submit((1, op))
    reads = [op for op in w.ops(400, stream_seed=998)
             if not op.write][:LOAD_PROBE]
    # a full collection scans every object the earlier planes left
    # (millions): seconds that stall all 24 workers. Each measurement
    # starts after one, and reports the full collections inside it
    gc.collect()
    gen2 = gc.get_stats()[2]["collections"]
    capacity = load_probe(submit, reads, LOAD_CONCURRENCY)
    log(f"load: closed-loop probe, {len(reads)} reads from "
        f"{LOAD_CONCURRENCY} workers through MicroBatcher(window_us="
        f"{LOAD_WINDOW_US}): {capacity:.1f} reads/s (host clock; 24 "
        f"workers share one GIL, so the host, not the card, bounds it; "
        f"{threading.active_count()} threads in the process, "
        f"{gc.get_stats()[2]['collections'] - gen2} full garbage "
        f"collections during the probe, {len(gc.get_objects())} objects "
        f"tracked) | {card}")
    launched, p50 = 0, {}
    for ix, f in enumerate(LOAD_RATES):
        rep, n = one_phase(f"phase 52 at {f} x capacity",
                           w.ops(LOAD_OPS, stream_seed=ix + 1),
                           capacity * f, submit)
        launched += n
        p50[f] = rep["ok"]["p50_ms"]

    lockcheck.enable(strict=False)
    racecheck.enable(strict=False)
    try:
        # objects born before arming are invisible to racecheck, and
        # locks built before it unwrapped: a fresh lock and batcher
        wrw = RWLock()
        wmb = MicroBatcher(db, window_us=LOAD_WINDOW_US,
                           read_lock=lambda: wrw.read)
        rep, n = one_phase(
            "phase 52 witnessed (lockcheck, racecheck)",
            w.ops(LOAD_WITNESS_OPS, stream_seed=len(LOAD_RATES) + 1),
            capacity * LOAD_WITNESS_RATE, load_submit(db, wmb, wrw))
        stats = (lockcheck.stats(), racecheck.stats())
    finally:
        found = racecheck.disable() + lockcheck.disable()
    if found:
        raise AssertionError("phase 52: witnessed violations:\n" + "\n".join(
            str(v) for v in found))
    launched += n
    log(f"load: witnessed phase: lockcheck {stats[0]}, racecheck "
        f"{stats[1]}, no violation; p50 {rep['ok']['p50_ms']} ms armed "
        f"against {p50[LOAD_WITNESS_RATE]} unarmed at the same rate | {card}")
    return launched


class LoadDriver:
    """tools/dgbench.py's Driver: submits ops against the routed
    cluster, classifying outcomes and keeping every 7th read's data."""

    def __init__(self, rc, deadline_ms: int, nonce: str,
                 sample_every: int = LOAD_SAMPLE_EVERY):
        self.rc = rc
        self.deadline_ms = deadline_ms
        self.nonce = nonce
        self.sample_every = sample_every

    def tid(self, phase: int, i: int) -> str:
        return f"{self.nonce}{phase & 0xFF:02x}{i & (1 << 80) - 1:020x}"

    def submit(self, phase: int, i: int, op) -> dict:
        """One op -> {outcome, kind, tid, data?}. Never raises."""
        from dgraph_tpu_torch.utils import tracing
        from dgraph_tpu_torch.utils.reqctx import (
            DeadlineExceeded, Overloaded,
        )

        tid = self.tid(phase, i)
        rec = {"outcome": "ok", "kind": op.kind, "tid": tid,
               "write": op.write}
        try:
            with tracing.bind(tid, node="dgbench"):
                if op.write:
                    self.rc.mutate(set_nquads=op.set_nquads,
                                   deadline_ms=self.deadline_ms)
                else:
                    out = self.rc.query(op.query,
                                        deadline_ms=self.deadline_ms)
                    if i % self.sample_every == 0:
                        rec["data"] = json.dumps(out.get("data"),
                                                 sort_keys=True)
        except Overloaded:
            rec["outcome"] = "shed"
        except DeadlineExceeded:
            rec["outcome"] = "deadline"
        except Exception as e:  # noqa: BLE001 — classified, reported
            rec["outcome"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"[:200]
        return rec


def claim_tablets(rc, groups_n: int) -> dict:
    """tools/dgbench.py's claim_tablets: the workload's predicate bundles
    pinned to groups round-robin before any write."""
    bundles = [
        ("person.name", "person.age", "person.city", "knows"),
        ("post.author", "post.topic", "post.score"),
        ("person.embedding",),
        ("churn.note",),
        ("churn.ref",),
    ]
    placement = {}
    for i, bundle in enumerate(bundles):
        gid = sorted(rc.groups)[i % groups_n]
        for pred in bundle:
            placement[pred] = rc.zero.tablet(pred, gid)
    return placement


def load_cluster(dev, card: str, w, snap: str, save_s: float,
                 work: str) -> int:
    """Phase 53: dgbench's cluster path against a ProcessCluster of one
    `python -m dgraph_tpu_torch node --device <card> --planner static`
    alpha and one zero, bulk-booted from phase 52's snapshot: warmup,
    closed-loop probe, open-loop phases at DGBENCH_RATES x capacity, the
    parity replay, the scoreboard and throughput at the SLO. Returns
    score_int8_lists' launches in the alpha over the phases and replay."""
    from dgraph_tpu_torch.bench.spawn import ProcessCluster

    deadline_ms = int(DGBENCH_SLO_MS * 5)
    t0 = time.perf_counter()
    with ProcessCluster(groups=1, replicas=1, zeros=1,
                        snapshots={1: snap}, max_pending=DGBENCH_MAX_PENDING,
                        alpha_args=["--planner", "static"],
                        log_dir=os.path.join(work, "logs"),
                        device=str(dev)) as pc:
        rc = pc.routed(timeout=120.0)
        try:
            pc.wait_ready(timeout_s=CLUSTER_WAIT_S)
            preds = set(w.read_predicates())
            wait_until("phase 53: zero's tablet map holds the snapshot's "
                       "predicates", lambda: preds <= set(
                           rc.tablet_map()["tablets"]), every_s=0.5)
            up_s = time.perf_counter() - t0
            placement = claim_tablets(rc, 1)
            driver = LoadDriver(rc, deadline_ms, os.urandom(5).hex())
            for op in w.ops(40, stream_seed=999):
                if not op.write:
                    driver.submit(0xFF, 0, op)
            reads = [op for op in w.ops(400, stream_seed=998)
                     if not op.write][:LOAD_PROBE]
            capacity = load_probe(
                lambda req: driver.submit(0xFE, req[0], req[1]), reads,
                LOAD_CONCURRENCY)
            before = proc_launches(pc)
            phases, best, best_ph, best_ops = [], None, None, None
            n_similar = 0
            for ix, f in enumerate(DGBENCH_RATES):
                ops = w.ops(LOAD_OPS, stream_seed=ix + 1)
                ph = load_run_phase(
                    lambda req, _ix=ix: driver.submit(_ix, req[0], req[1]),
                    ops, capacity * f, LOAD_CONCURRENCY)
                rep = load_phase_report(ph, DGBENCH_SLO_MS,
                                        DGBENCH_ERROR_BUDGET)
                rep["phase"] = ix
                phases.append(rep)
                n_similar += rep["by_class"].get("similar", {}).get(
                    "count", 0)
                if rep["passed"] and (best is None or rep["offered_qps"]
                                      > best["offered_qps"]):
                    best, best_ph, best_ops = rep, ph, ops
            time.sleep(0.5)  # drain in-flight churn writes
            evidence = (best_ph, best_ops) if best is not None else (ph, ops)
            checked, bad = load_parity(evidence[0], evidence[1], rc.query)
            n_similar += sum(1 for i, rec in enumerate(evidence[0]["recs"])
                             if rec and "data" in rec
                             and rec["kind"] == "similar")
            after = proc_launches(pc)
        finally:
            rc.close()
    launched = {n: after[n]["score_int8"] - before[n]["score_int8"]
                for n in after}
    others = {n: {k: after[n][k] - before[n][k] for k in after[n]
                  if k != "score_int8"} for n in after}
    for rep in phases:
        log(f"load: phase 53, dgbench phase {rep['phase']}: "
            f"{LOAD_OPS} ops offered at {rep['offered_qps']}/s, achieved "
            f"{rep['ok_qps']}/s in {rep['wall_s']} s; ms from the scheduled "
            f"arrival (host clock) p50 {rep['ok'].get('p50_ms')} p99 "
            f"{rep['p99_ms']}; by class: {class_line(rep)}; outcomes "
            f"{rep['outcomes']}, passed {rep['passed']} (SLO "
            f"{DGBENCH_SLO_MS} ms, error budget {DGBENCH_ERROR_BUDGET}); "
            f"errors {rep['errors_sample']} | {card}")
    log(f"load: phase 53 scoreboard: " + json.dumps(phases))
    log(f"load: phase 53, dgbench on ProcessCluster(groups=1, replicas=1, "
        f"zeros=1, max_pending={DGBENCH_MAX_PENDING}) of `python -m "
        f"dgraph_tpu_torch node --device {dev} --planner static`, "
        f"bulk-booted from phase 52's snapshot (save_snapshot {save_s:.2f} "
        f"s, {os.path.getsize(snap) / 2**20:.1f} MiB), ready in {up_s:.1f} "
        f"s; placement {placement}; closed-loop capacity {capacity:.1f} "
        f"reads/s; throughput at the p99 SLO of {DGBENCH_SLO_MS} ms: "
        f"{best['ok_qps'] if best else None} ok/s (offered "
        f"{best['offered_qps'] if best else None}/s, host clock); parity "
        f"{checked} sampled reads, {len(bad)} differ; score_int8_lists "
        f"launches in the alpha (its stats op) {launched} for {n_similar} "
        f"similar_to ops that reached it, other kernels {others} | {card}")
    if best is None:
        raise AssertionError("phase 53: no phase passed dgbench's gate")
    if bad or not checked:
        raise AssertionError(f"phase 53: parity {len(bad)} of {checked} "
                             f"sampled reads differ: {bad[:3]}")
    if any(rep["outcomes"]["deadline"] or rep["outcomes"]["error"]
           for rep in phases):
        raise AssertionError("phase 53: deadline or error outcomes")
    if sum(launched.values()) < n_similar or not n_similar:
        raise AssertionError(f"phase 53: score_int8_lists launches "
                             f"{launched} for {n_similar} similar_to ops")
    return sum(launched.values())


def load_kernel_entries(dev, card: str, last: dict, inproc: int,
                        alphas: int) -> list[dict]:
    """The kernels line's entry of score_int8_lists on the load path,
    timed at its last recorded call of phase 52 (d = 16) from a flushed
    L2 beside its plain version and bound."""
    from dgraph_tpu_torch.ops import kernels

    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)
    (codes, qs, table, out), kw = last["int8"]
    ms = device_ms_cold(lambda: kernels.score_int8_lists(
        codes, qs, table, out, **kw), 20, flush)
    plain_out = torch.empty_like(out)
    plain = cuda_ms(lambda: kernels.score_int8_lists_reference(
        codes, qs, table, plain_out, **kw), 3)
    err, ratio = lists_within_bound(codes, qs, table, out, plain_out, kw,
                                    "score_int8_lists, load path")
    bound, by = lists_bound_ms(codes, qs, table)
    del flush
    log(f"  load path: score_int8_lists at a similar_to op's shapes ("
        f"{len(table)} entries, d {codes.shape[1]}, worst error/bound "
        f"{ratio:.4g}) {ms:.4f} ms from a flushed L2, plain {plain:.4f}, "
        f"bound {bound:.5f} ({by}); launches {inproc} in process (phase "
        f"52), {alphas} in the alpha (phase 53) | {card}")
    return [{"name": "score_int8_lists", "route": "cuda",
             "source": "dgraph_tpu_torch/csrc/score.cu",
             "replaces": "dgraph_tpu/ops/pallas_kernels.py:158",
             "path": "load", "launches": inproc + alphas,
             "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": by, "library_ms": None}]


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

    def both(corpus, codes, dot_batches, int8_batches, label):
        for b in sorted(set(dot_batches) | set(int8_batches)):
            q = torch.randn((b, corpus.shape[1]), device=dev, generator=gen)
            if b in dot_batches:
                check("dot", kernels.score_dot, kernels.score_dot_reference,
                      corpus, q, f"score_dot b={b} {label} "
                      f"{kernels.score_dot_plan(b, corpus.shape[1], 16)}")
            if codes is not None and b in int8_batches:
                check("int8", kernels.score_int8,
                      kernels.score_int8_reference, codes, q,
                      f"score_int8 b={b} {label}")

    # score_dot's batches: the row route's query tiles and their passes,
    # its crossover into the tile route and the neighbours of it, and two
    # query tiles of the tile route
    cross = kernels.DOT_ROWS_MAX_B
    dot_batches = sorted({1, 2, 3, 4, 8, 16, 32, 64, 256, 257, cross - 1,
                          cross, cross + 1})
    for d, n in DOT_CHECK_SHAPES:
        corpus = torch.randn((n, d), device=dev, generator=gen)
        codes = None
        if (d, n) in SCORE_CHECK_SHAPES:
            codes = torch.randint(-127, 128, (n, d), device=dev,
                                  generator=gen, dtype=torch.int8)
        both(corpus, codes, dot_batches, SCORE_CHECK_BATCHES,
             f"n={n} d={d}")
        del corpus, codes
    # corpora that start off 16-byte alignment (a slice's offset)
    n, d = 65_536, 128
    flat = torch.randn(n * d + 1, device=dev, generator=gen)
    flat8 = torch.randint(-127, 128, (n * d + 3,), device=dev, generator=gen,
                          dtype=torch.int8)
    both(flat[1:].view(n, d), flat8[3:].view(n, d),
         (1, 3, cross, cross + 1, 256), (3, 256),
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
        f"(score_dot b {'/'.join(map(str, dot_batches))} (row route up to "
        f"{cross}), score_int8 b 1/3/256/257; d 16/37/100/128/1024, n "
        f"1..1,000,064, corpora off 16-byte alignment, every output "
        f"written through out= off 16 bytes, int8 list slices of 1-5,000 "
        f"rows, "
        f"{len(tables)} list tables); worst error/bound: score_dot "
        f"{worst['dot'][1]:.4g}, score_int8 {worst['int8'][1]:.4g} | {card}")
    return worst["dot"][0], worst["int8"][0]


def dot_routes(kernels, dev, card: str) -> None:
    """Phase 9's route table: score_dot at DOT_ROUTE_SHAPES on the plan's
    route and on the other one, beside the plain version, torch.matmul
    and the bound; then both routes over the batch at the first shape's
    (n, d) and the crossover they give, beside the plan's. Device times
    from a flushed L2, CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)

    def other(plan, b):
        if plan.route == kernels.DOT_ROWS:
            return kernels.DotPlan(kernels.DOT_TILE, plan.vec,
                                   kernels.DOT_TILE_Q, 1)
        tile = min(t for t in kernels.DOT_ROW_LANES if t >= min(b, 32))
        return kernels.DotPlan(kernels.DOT_ROWS, plan.vec, tile,
                               kernels.DOT_ROW_LANES[tile])

    def cold(fn):
        return device_ms_cold(fn, 20, flush)

    names = {kernels.DOT_TILE: "tile", kernels.DOT_ROWS: "row"}
    for b, n, d in DOT_ROUTE_SHAPES:
        corpus = torch.randn((n, d), device=dev, generator=gen)
        q = torch.randn((b, d), device=dev, generator=gen)
        plan = kernels.score_dot_plan(b, d, 16)
        alt = other(plan, b)
        ms = cold(lambda: kernels.score_dot(corpus, q))
        alt_ms = cold(lambda: kernels.score_dot(corpus, q, plan=alt))
        plain = cold(lambda: kernels.score_dot_reference(corpus, q))
        lib = cold(lambda: torch.matmul(q, corpus.T))
        bound, by = score_bound_ms([(corpus, q)])
        log(f"score_dot at ({b}, {n:,}, {d}): {names[plan.route]} route "
            f"{ms:.4f} ms ({plan}), {names[alt.route]} route {alt_ms:.4f}, "
            f"plain {plain:.4f}, torch.matmul {lib:.4f}, bound {bound:.4f} "
            f"({by}) | {card}")
        del corpus, q
    n, d = DOT_ROUTE_SHAPES[0][1:]
    corpus = torch.randn((n, d), device=dev, generator=gen)
    cross = kernels.DOT_ROWS_MAX_B
    tile = kernels.DotPlan(kernels.DOT_TILE, 4, kernels.DOT_TILE_Q, 1)
    times, measured, lost = [], 0, False
    for b in sorted({1, 2, 3, 4, 8, 16, 32, cross - 1, cross, cross + 1, 48,
                     64}):
        q = torch.randn((b, d), device=dev, generator=gen)
        rows = other(tile, b)
        r_ms = cold(lambda: kernels.score_dot(corpus, q, plan=rows))
        t_ms = cold(lambda: kernels.score_dot(corpus, q, plan=tile))
        times.append(f"b {b}: row {r_ms:.4f} tile {t_ms:.4f}")
        lost = lost or r_ms >= t_ms
        measured = measured if lost else b
    del corpus, flush
    log(f"score_dot's routes over the batch at (b, {n:,}, {d}), ms: "
        f"{'; '.join(times)}; the row route wins up to b {measured} of this "
        f"sweep, the plan takes it up to {cross} | {card}")


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
    dot_routes(kernels, dev, card)

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

    # -- 35. sharded similar_to ----------------------------------------------
    mesh_entries = mesh_vector_phase(dev, card, corpus, queries,
                                     answers["exact"], ix, tol)

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
    ] + mesh_entries


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


# -- the host runtime (phase 54) ----------------------------------------------

HOST_SCALE = 2                     # phase 54's bulk input: the golden graph
HOST_TURNS = (True, False, False, True)  # the runtime on / switched off
HOST_RSS_GROUPS = 1                # bench_500m groups of phase 41's seed
# the bindings each plane must have called (its counts set to 0 just
# before it and read just after): the write plane runs the query,
# serving, cluster and cold planes inside it
HOST_BRANCHES = {
    "write_plane": ("NativeWal", "NativeKV", "rdf_parse", "tokenize_batch",
                    "json_rows", "gv_encode", "gv_decode"),
    "load_plane": ("tokenize_batch", "json_rows", "gv_encode"),
}
RSS_CHILD = """
import json, resource, sys, tracemalloc
sys.path.insert(0, sys.argv[3])
from dgraph_tpu_torch import native
if sys.argv[2] == "off":
    native.available = lambda: False
from dgraph_tpu_torch.engine.lazy_tablets import TabletStore
page = resource.getpagesize() // 1024
def mem():
    # KiB: resident pages less the file-backed (shared) ones, those,
    # and the peak resident set since exec where the kernel reports it
    # (getrusage's would include the parent's, from before the exec)
    with open("/proc/self/statm") as f:
        rss, shared = (int(x) for x in f.read().split()[1:3])
    with open("/proc/self/status") as f:
        hwm = [int(ln.split()[1]) for ln in f if ln.startswith("VmHWM:")]
    return {"RssAnon": (rss - shared) * page, "RssFile": shared * page,
            "VmHWM": hwm[0] if hwm else -1}
start = mem()
tracemalloc.start()
store = TabletStore(sys.argv[1], "cpu")
opened = dict(mem(), py=tracemalloc.get_traced_memory()[0] // 1024)
preds = store.preds()
blobs = sum(len(store.kv.get(b"tab:" + p.encode())) for p in preds)
py, py_peak = tracemalloc.get_traced_memory()
read = dict(mem(), py=py // 1024, py_peak=py_peak // 1024)
print(json.dumps({"kv": type(store.kv).__name__, "preds": len(preds),
                  "blob_bytes": blobs, "start": start, "opened": opened,
                  "read": read}))
store.close()
"""


class runtime_switched:
    """The host runtime on (the default) or switched off as the tests
    switch it: `native.available` False, and `native.json_rows` (which,
    as in the reference, does not consult `available`) refusing every
    block, so flat blocks take the dict emitter."""

    def __init__(self, on: bool):
        from dgraph_tpu_torch import native

        self.native, self.on = native, on

    def __enter__(self):
        n = self.native
        self.saved = n.available, n.json_rows
        if not self.on:
            n.available = lambda: False
            n.json_rows = lambda n_rows, cols: None
        return self

    def __exit__(self, *exc):
        self.native.available, self.native.json_rows = self.saved


def plane_branches(counts: dict, card: str) -> None:
    """Phase 54, first part: each plane's binding calls; the planes
    that must take the native branches took them."""
    for name, (calls, flat) in counts.items():
        moved = {k: v for k, v in calls.items() if v}
        log(f"host runtime on {name}: binding calls {moved}; "
            f"query_flat_json_total +{flat:g} | {card}")
    for name, need in HOST_BRANCHES.items():
        calls, flat = counts[name]
        missing = [b for b in need if calls[b] <= 0]
        if missing or flat <= 0:
            raise AssertionError(f"phase 54: {name} took no native branch "
                                 f"through {missing} (flat JSON +{flat})")


def tablet_contents(db) -> dict:
    """Every tablet's edges, values and index by content (the index's
    token order follows the tokenizer, its lists do not)."""
    return {p: ({u: v.tolist() for u, v in t.edges.items()},
                repr(sorted(t.values.items())),
                {k: v.tolist() for k, v in t.index.items()})
            for p, t in dict.items(db.tablets)}


def host_bulk(dev, card: str, work: str) -> None:
    """Phase 54: bulk_load of the golden graph at HOST_SCALE from an RDF
    file, then save_snapshot and a boot from it (load_snapshot), the
    runtime on and off in turns: RDF/s and seconds, the same tablets."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.ingest.bulk import bulk_load
    from dgraph_tpu_torch.storage.snapshot import load_snapshot, save_snapshot

    schema, lines = golden_dataset().generate(HOST_SCALE)
    path = os.path.join(work, "golden.rdf")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    snap = os.path.join(work, "golden.snap")
    rates = {True: [], False: []}
    saves = {True: [], False: []}
    boots = {True: [], False: []}
    want = None
    for on in HOST_TURNS:
        native.reset_calls()
        with runtime_switched(on):
            t0 = time.perf_counter()
            db = bulk_load([path], schema=schema, device=dev)
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            save_snapshot(db, snap)
            saves[on].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            booted = load_snapshot(snap, device=dev)
            boots[on].append(time.perf_counter() - t0)
        calls = native.call_counts()
        if any((calls[b] > 0) != on for b in ("rdf_parse", "tokenize_batch",
                                              "gv_encode", "gv_decode")):
            raise AssertionError(f"phase 54: bulk_load and the snapshot with "
                                 f"the runtime {'on' if on else 'off'} "
                                 f"called {calls}")
        got = tablet_contents(db)
        if want is None:
            want = got
        if got != want or tablet_contents(booted) != want:
            raise AssertionError("phase 54: bulk_load's or the booted "
                                 "engine's tablets differ with the runtime "
                                 "on and off")
        rates[on].append(len(lines) / dt)
        del db, booted
    log(f"host runtime: bulk_load of the golden graph at scale {HOST_SCALE} "
        f"({len(lines)} RDF, explicit uids, from a file) into GraphDB(device="
        f"{dev}), turns on/off/off/on: native map {rates[True][0]:.0f} and "
        f"{rates[True][1]:.0f} RDF/s, Python grammar (runtime off) "
        f"{rates[False][0]:.0f} and {rates[False][1]:.0f} RDF/s; "
        f"save_snapshot ({os.path.getsize(snap) / 2**20:.1f} MiB) "
        f"{saves[True][0]:.3f} and {saves[True][1]:.3f} s native, "
        f"{saves[False][0]:.3f} and {saves[False][1]:.3f} s off; boot "
        f"(load_snapshot onto {dev}) {boots[True][0]:.3f} and "
        f"{boots[True][1]:.3f} s native, {boots[False][0]:.3f} and "
        f"{boots[False][1]:.3f} s off; equal tablets | {card}")


def host_encode(dev, card: str) -> None:
    """Phase 54: the 75 goldens' encode time (`latency.encoding_ns` of
    query_json) on a fresh scale-1 card engine, the runtime on (flat
    blocks through `json_rows`) and off (the dict emitter) in turns:
    equal bytes."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.utils import metrics

    schema, lines = golden_dataset().generate(1)
    db = GraphDB(device=dev, device_min_edges=1)
    db.alter(schema_text=schema)
    db.mutate(set_nquads="\n".join(lines))
    golden = golden_queries()

    def one_pass():
        data, enc = [], 0
        for _, text, _ in golden:
            body = json.loads(db.query_json(text))
            data.append(body["data"])
            enc += body["extensions"]["latency"]["encoding_ns"]
        return data, enc / 1e6

    want, _ = one_pass()                   # warm: plans, tiles, memos
    ms = {True: [], False: []}
    for on in HOST_TURNS:
        native.reset_calls()
        before = metrics.counters_snapshot()
        with runtime_switched(on):
            got, enc_ms = one_pass()
        flat = metrics.counters_delta(before).get("query_flat_json_total", 0)
        rows = native.json_rows.calls
        if got != want or (flat > 0) != on or (rows > 0) != on:
            raise AssertionError(f"phase 54: goldens with the runtime "
                                 f"{'on' if on else 'off'}: equal "
                                 f"{got == want}, flat {flat}, json_rows "
                                 f"{rows}")
        ms[on].append(enc_ms)
        if on:
            flat_on = flat
    log(f"host runtime: the {len(golden)} goldens' encode (query_json's "
        f"latency.encoding_ns summed) on a scale-1 GraphDB(device={dev}, "
        f"device_min_edges=1), turns on/off/off/on: columnar json_rows "
        f"{ms[True][0]:.3f} and {ms[True][1]:.3f} ms ({flat_on:g} flat "
        f"blocks a pass), dict emitter (runtime off) {ms[False][0]:.3f} and "
        f"{ms[False][1]:.3f} ms; equal data | {card}")


def host_rss(card: str, work: str) -> None:
    """Phase 54: phase 41's seed (HOST_RSS_GROUPS bench_500m groups, its
    published widths) in a TabletStore of each kind, opened by a fresh
    child process: the Python heap and resident memory it holds and
    their peaks, NativeKV against PyKV (the runtime switched off)."""
    import subprocess

    from dgraph_tpu_torch.engine.lazy_tablets import TabletStore

    b5 = bench_500m()
    rows, procs = {}, {}
    for on in (True, False):
        path = os.path.join(work, f"seed-{'on' if on else 'off'}")
        with runtime_switched(on):
            t0 = time.perf_counter()
            edges, nbytes = seed_500m(b5, TabletStore(path, "cpu"),
                                      HOST_RSS_GROUPS, b5.U_DEFAULT)
            rows[on] = {"seed_s": time.perf_counter() - t0,
                        "nbytes": nbytes, "edges": edges}
        # the two children run at once, each in its own process
        procs[on] = subprocess.Popen(
            [sys.executable, "-c", RSS_CHILD, path, "on" if on else "off",
             REPO], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        for on, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"phase 54: RSS child failed:\n"
                                     f"{err[-2000:]}")
            rows[on].update(json.loads(out.splitlines()[-1]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    on, off = rows[True], rows[False]
    if (on["kv"], off["kv"]) != ("NativeKV", "PyKV") or \
            on["preds"] != off["preds"] or \
            on["blob_bytes"] != off["blob_bytes"]:
        raise AssertionError(f"phase 54: the RSS children read {rows}")

    def peak(r):
        kib = r["read"]["VmHWM"]
        return f"{kib / 1024:.1f} MiB" if kib >= 0 else "not reported"

    def held(r, at):
        return (f"Python heap {r[at]['py'] / 1024:.1f} MiB, resident "
                f"anonymous +{(r[at]['RssAnon'] - r['start']['RssAnon']) / 1024:.1f}"
                f" MiB and file-backed +"
                f"{(r[at]['RssFile'] - r['start']['RssFile']) / 1024:.1f} MiB")

    log(f"host runtime: phase 41's seed ({HOST_RSS_GROUPS} bench_500m group, "
        f"U {b5.U_DEFAULT}, {on['edges']} edges, {on['preds']} tablets, "
        f"{on['nbytes'] / 2**20:.1f} MiB of blobs; seeded in "
        f"{on['seed_s']:.2f} s on NativeKV, {off['seed_s']:.2f} s on PyKV) "
        f"in a TabletStore opened by a fresh process (/proc/self/statm; "
        f"{on['start']['RssAnon'] / 1024:.1f} MiB resident at start): "
        f"NativeKV open {held(on, 'opened')}; every blob read "
        f"{held(on, 'read')}, Python heap peak {on['read']['py_peak'] / 1024:.1f}"
        f" MiB, peak RSS {peak(on)}; PyKV (runtime "
        f"off) open {held(off, 'opened')}; every blob read {held(off, 'read')},"
        f" Python heap peak {off['read']['py_peak'] / 1024:.1f} MiB, peak RSS "
        f"{peak(off)} | {card}")


def host_plane(dev, card: str, counts: dict) -> None:
    """Phase 54: the host runtime (`dgraph_tpu_torch.native`,
    csrc/native.cc, built with g++ in phase 2), in build/host/ (removed
    at the end): it is loaded; every plane took its branches; then bulk
    RDF/s, the goldens' encode ms and a seeded store's RSS with the
    runtime on and switched off."""
    import shutil
    import subprocess

    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.ops import _build

    if not native.available():
        raise AssertionError("phase 54: the host runtime is not loaded")
    lib = os.path.relpath(native._lib._name, REPO)
    if lib != os.path.relpath(_build.library_path("native"), REPO):
        raise AssertionError(f"phase 54: loaded {lib}")
    gxx = subprocess.run([_build.gxx_path(), "--version"],
                         capture_output=True, text=True).stdout.splitlines()
    log(f"host runtime: {lib} from dgraph_tpu_torch/csrc/native.cc, "
        f"{gxx[0] if gxx else 'g++'} {' '.join(_build.GXX_FLAGS)}, "
        f"available() True | {card}")
    plane_branches(counts, card)
    work = os.path.join(REPO, "build", "host")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        host_bulk(dev, card, work)
        host_encode(dev, card)
        host_rss(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    build_kernels(_build, ["bucket_or", "score", "bitmap_and", "native"])
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.utils import metrics

    # the set-algebra plane runs before the vector plane: after the
    # vector plane's profiles, torch.profiler (torch 2.11, CUDA 12.8)
    # records no device activity for the rest of the process
    entries = []
    counts = {}
    for plane in (bfs_plane, graph_plane, write_plane, setops_plane,
                  vector_plane, load_plane):
        t0 = time.perf_counter()
        native.reset_calls()
        before = metrics.counters_snapshot()
        got = plane(dev, card)
        counts[plane.__name__] = (native.call_counts(), metrics.counters_delta(
            before).get("query_flat_json_total", 0))
        entries += got if isinstance(got, list) else [got] if got else []
        torch.cuda.empty_cache()
        log(f"{plane.__name__}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_plane(dev, card, counts)
    log(f"host_plane: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": entries}))
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
