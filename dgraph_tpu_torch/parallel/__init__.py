"""Distribution: device mesh, sharded tablets, cross-shard collectives;
the port of `dgraph_tpu/parallel/`.

Parallelism mapping (SURVEY §2b): the reference scales by
  - predicate sharding ("tablets" moved between groups by Zero,
    dgraph/cmd/zero/tablet.go)          -> mesh axis "tablet"
  - multi-part posting lists (one huge edge list split across nodes,
    posting/list.go:1149)               -> mesh axis "uid" (uid-range
                                           shards of one predicate's
                                           adjacency)
  - scatter-gather query fan-out
    (query/query.go:2017 goroutines)    -> mesh axis "data" (query/seed
                                           batch)

The reference runs each sharded step as one `shard_map` program over a
`jax.sharding.Mesh`, exchanging data with ICI collectives. The port is
single-process: a `Mesh` is an array of `torch.device`s, per-shard work
is a loop over the shards, and the collectives are copies between their
devices (`parallel/compat.py`). A mesh may repeat one device: S entries
of `cuda:0` run every sharded path with S shards on one card, one shard
after another on its stream.
"""

from dgraph_tpu_torch.parallel.mesh import make_mesh
from dgraph_tpu_torch.parallel.dist_graph import (
    RingAdjacency, ShardedAdjacency, build_ring_adjacency,
    build_sharded_adjacency, make_ring_bfs, make_sharded_bfs,
)
from dgraph_tpu_torch.parallel.dist_knn import (
    shard_corpus, sharded_ivf_topk, sharded_topk,
)
