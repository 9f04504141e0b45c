"""Single-process engine: the Alpha-equivalent, port of
`dgraph_tpu/engine/`. Ties together schema, tablets, the coordinator
and the WAL behind the reference's api.Dgraph write surface
(edgraph/server.go): Alter / Mutate / CommitOrAbort. The query executor
comes with a later slice (ROADMAP Queue 1 item 7).
"""

from dgraph_tpu_torch.engine.db import GraphDB, Txn  # noqa: F401
