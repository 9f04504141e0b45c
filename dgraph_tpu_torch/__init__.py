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
  devices); `GraphDB(mesh=...)` runs its sharded tiers on them;
- cold storage and ingest: a tablet store larger than RAM under a byte
  budget (`engine.lazy_tablets` over the host runtime's LSM store,
  `native.NativeKV`), read-ahead
  (`engine.prefetch`), the CDC-invalidated result cache
  (`engine.result_cache`), backups and point-in-time restore to local
  or S3 URIs (`storage.backup`, `storage.uri`), bulk seeding
  (`storage.bulkseed`) and the bulk, live, distributed, export and
  conversion loaders (`ingest`); `GraphDB(store_dir=...)` serves from
  a reopened store on the card;
- the serving surfaces: the HTTP Alpha (`server.http`: `AlphaServer`,
  `serve`), the query micro-batcher (`engine.batcher`), ACL, per-tenant
  QoS, TLS and the debug mux (`server.acl`, `qos`, `tls`,
  `debug_http`), the gRPC API with the reference's protobuf service
  (`server.grpc_api`, `proto`), request contexts, the reader-writer
  lock, the network fault plane, the sampling profiler, alerts and the
  watchdog (`utils.reqctx`, `rwlock`, `netfault`, `pprof`, `alerts`,
  `watchdog`) and the command line (`cli`;
  `python -m dgraph_tpu_torch alpha` serves GraphQL± from the card);
- the cluster: Raft (`cluster.raft`, persisted through
  `native.NativeKV`), its TCP transport, the deterministic harness,
  the leader-following client, Zero's state machine and the rebalance
  planner (`cluster.transport`, `harness`, `client`, `zero`,
  `rebalance`), replicated engine groups and cross-cluster standby
  replication (`cluster.replica`, `replication`), federated queries
  and the predicate-sharded topology with tablet moves and the
  rebalancer (`cluster.federated`, `topology`), the networked alpha
  and zero servers (`cluster.service`), a multi-process deployment
  (`bench.spawn`) and `node`, `standby` and `rebalance` on the command
  line; an alpha's engine runs on its `device`, a zero touches no card;
- the host runtime (`native`): the LSM KV store and WAL, the
  group-varint codec, the RDF parser, the batch tokenizer, the columnar
  JSON row writer and the match and merge-count loops, C++ in
  `csrc/native.cc` that g++ builds at first use; the storage, ingest
  and query layers take its branches, as the reference's do.

Entry points run on `cuda:0` unless the caller passes `device="cpu"`;
see `backend.resolve_device`.
"""

__version__ = "0.1.0"
