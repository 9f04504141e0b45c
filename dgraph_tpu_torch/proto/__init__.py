"""Protobuf client API (the reference's primary protocol is gRPC with
protobuf messages — dgraph/cmd/alpha/run.go:362 api.Dgraph).

`api.proto` is the source of truth; `api_pb2.py` is committed
generated code (protoc --python_out=. api.proto) so the runtime needs
no grpcio-tools. Clients in any language generate from api.proto.

Port of `dgraph_tpu/proto/__init__.py`: a copy, its imports pointed at this
package. `api.proto` and `api_pb2.py` are the
reference's, byte for byte: the same file name and package (`api`),
so dgo clients reach `/api.Dgraph/Query`, and both packages register
one descriptor in protobuf's default pool.
"""

from dgraph_tpu_torch.proto import api_pb2  # noqa: F401
