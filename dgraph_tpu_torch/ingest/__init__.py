"""Ingest/egress: streaming chunkers, xid→uid assignment, offline bulk
map-reduce loader, online live loader, and RDF/JSON export.

Ref: chunker/ (streaming parse), xidmap/ (xid assignment),
dgraph/cmd/bulk/ (offline loader), dgraph/cmd/live/ (online loader),
worker/export.go (export).

Port of `dgraph_tpu/ingest/`.
"""

from dgraph_tpu_torch.ingest.chunker import (
    Chunker, chunk_file, detect_format,
)
from dgraph_tpu_torch.ingest.xidmap import XidMap
from dgraph_tpu_torch.ingest.bulk import bulk_load
from dgraph_tpu_torch.ingest.live import live_load
from dgraph_tpu_torch.ingest.export import (
    export_json, export_rdf, export_schema,
)

__all__ = ["Chunker", "chunk_file", "detect_format", "XidMap",
           "bulk_load", "live_load", "export_json", "export_rdf",
           "export_schema"]
