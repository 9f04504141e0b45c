"""Single-process engine: the Alpha-equivalent, port of
`dgraph_tpu/engine/`. Ties together schema, tablets, the coordinator,
the WAL and the query executor behind the reference's api.Dgraph
surface (edgraph/server.go): Alter / Mutate / Query / CommitOrAbort.
"""

from dgraph_tpu_torch.engine.db import GraphDB, Txn  # noqa: F401
