"""Versioned wire format for durable records and network frames.

The reference's stable encoding is protobuf (protos/pb.proto:469-501
Posting/PostingList/Proposal et al); every durable or networked payload
goes through it, so old WALs replay and mixed-version nodes interoperate.
This package is the analogue: a compact, self-describing, versioned
binary encoding (tag + varint TLV) with first-class records for the
engine's EdgeOp/Posting/Val, Raft's Entry/Msg, and numpy arrays.
Pickle — self-compatible only, code-layout-fragile — is no longer used
for anything durable or replicated.

Layout: one version byte, then a tagged value tree. Integers are
zigzag varints; arrays carry dtype + shape + raw little-endian bytes.

Port of `dgraph_tpu/wire/__init__.py`: a copy, its imports pointed at this
package.
"""

from dgraph_tpu_torch.wire.codec import (  # noqa: F401
    WIRE_VERSION, WireError, decode, dumps, encode, loads, loads_compat,
    read_frame, write_frame,
)
