"""dgraph_tpu_torch: the PyTorch and CUDA port of dgraph_tpu for NVIDIA
Hopper (H100).

The package stands alone: it imports torch and numpy, never jax and
nothing of `dgraph_tpu`. Where it needs numpy code that lives in a JAX
module of the reference package it keeps its own copy.

Ported so far:
- the batched BFS traversal plane (`ops.bitgraph`), with the gather-OR
  step as a hand-written CUDA kernel (`ops.kernels.bucket_or`,
  `csrc/bucket_or.cu`), and its benchmark (`bench.bfs`);
- the similar_to vector search plane: the exact and two-stage device
  tiers (`ops.knn`) and the quantized IVF tier (`ops.ivf`), with the
  scoring products as hand-written CUDA kernels (`ops.kernels.score_dot`
  and `score_int8_lists`, the quantized tier's approximate stage in one
  launch, `csrc/score.cu`), and its benchmark (`bench.vectors`);
- the sorted-UID set algebra: padded uid vectors (`ops.uidvec`), the
  compressed block codec (`ops.codec`), pack-level set operations
  (`ops.setops`, the k-way AND of bitmap blocks as a hand-written CUDA
  kernel, `ops.kernels.bitmap_and`, `csrc/bitmap_and.cu`) and the
  merge-path intersect (`ops.mergepath`), with its benchmark
  (`bench.setops`);
- the uid-vector graph ops: degree-bucketed adjacency, expansion, value
  ranks, order-by pages and the fused rank page (`ops.graph`), BFS and
  SSSP over them (`ops.traverse`) and the batched Levenshtein verify
  (`ops.editdist`), all plain PyTorch or numpy;
- the host leaf layer, copies of the reference's numpy and standard
  library modules with their imports rewritten: `models` (types,
  stemmer, geo, tokenizer, schema), `gql` (lexer, AST, parser, RDF and
  JSON mutations), `utils.keys`, `failpoint`, `metrics` and `tracing`
  (`profile_device` wraps `torch.profiler`), and
  `cluster.coordinator`;
- storage and the engine's write path: MVCC tablets, the WAL,
  encryption at rest, snapshots, tablet statistics and the vector store
  (`storage`), the wire codec (`wire`), change streams (`cdc`),
  `utils.logger`, `reqlog` and `coststore`, the tile budget and the
  device tiles (`engine.tile_cache`, `engine.device_cache`), and
  `engine.db.GraphDB`; its rollup trains vector indexes on the engine's
  device;
- the query path: the executor (`query.executor`), compiled plans and
  the plan cache (`query.plan`), the adaptive planner
  (`query.planner`), whole-plan fusion (`query.fusion`), EXPLAIN
  (`query.explain`), columnar value variables (`query.colvar`), the
  regexp trigram compiler (`query.retrigram`), typed cluster errors
  and hash-range shards (`cluster.errors`, `cluster.shard`), and
  `GraphDB.query`, `query_json`, upserts and @if conditions. Every
  device tier of a query runs on the engine's device: the pack
  algebra's AND through `bitmap_and`, similar_to through `score_dot`
  and `score_int8_lists`, the rest plain PyTorch;
- multi-device (`parallel`): a device mesh and its partition rules, the
  uid-range-sharded adjacency with its expand, sharded and ring BFS,
  the (data, tablet, uid) query step and sharded similar_to, in one
  process (per-shard loops, collectives as copies between the shards'
  devices); `GraphDB(mesh=...)` runs its sharded tiers on them.

Entry points run on `cuda:0` unless the caller passes `device="cpu"`;
see `backend.resolve_device`.
"""
