"""cdc/ — change data capture: WAL-backed per-predicate change streams.

The reference declares the streaming surface in its proto
(protos/pb.proto pb.Worker.Subscribe) but never serves it; this package
does. Committed mutations are tailed off the engine's durable apply
path (the same expanded records the WAL frames and Raft replicates)
into bounded per-predicate change logs with monotonic, commit-ts-
anchored offsets, served to subscribers via HTTP long-poll
(server/http.py /subscribe) and the cluster wire ({"op": "subscribe"}).

Delivery contract: at-least-once, resumable by offset, per-predicate
commit order. Offsets are deterministic functions of the replicated
record stream, so a subscriber can resume against ANY replica of the
serving group with the offset it got from another.

Port of `dgraph_tpu/cdc/__init__.py`: a copy, its imports pointed at this
package.
"""

from dgraph_tpu_torch.cdc.changelog import (  # noqa: F401
    CdcPlane, OffsetTruncated, offset_for_ts,
)
