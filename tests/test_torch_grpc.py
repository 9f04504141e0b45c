"""The port's gRPC API (dgraph_tpu_torch.server.grpc_api, proto) against
the reference's, on the CPU.

Every case of the reference's test_grpc runs through both packages
(`tests/torch_twins.run_twins`): the wire-dict service, TLS, bind
failure, the protobuf `api.Dgraph` service a dgo client calls, stock
dgo frames, deadlines and overload. Each `AlphaServer.handle_*` result
and each protobuf response must be equal between the passes: the
protobuf responses as serialized bytes with their `latency` cleared,
beside their decoded JSON payloads and uid maps, masked as
`torch_twins.MASKED` names. Both packages register one `api.proto`
descriptor in protobuf's default pool, so their message classes are
one and the same and only bytes and fields can tell the passes apart.
A case on a module-scoped client runs after the case that sets up its
schema, as in the reference's file order.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_grpc as ref_grpc
from dgraph_tpu.proto import api_pb2 as jpb
from dgraph_tpu_torch import __version__
from dgraph_tpu_torch.proto import api_pb2 as tpb
from dgraph_tpu_torch.server.grpc_api import GrpcClient, serve_grpc
from dgraph_tpu_torch.server.http import AlphaServer
from tests.torch_twins import reference_cases, run_twins

CASES = reference_cases("test_grpc")
SETUP = {"client": "test_alter_mutate_query",
         "pbc": "test_pb_alter_mutate_query"}


def test_the_reference_file_holds_its_cases():
    assert len(CASES) == 20


def _after_schema(case):
    params = inspect.signature(getattr(ref_grpc, case)).parameters
    for fixture, setup in SETUP.items():
        if fixture in params and case != setup:
            return [setup, case]
    return [case]


@pytest.mark.parametrize("case", CASES)
def test_grpc_through_both(case, tmp_path):
    logs = run_twins("test_grpc", _after_schema(case), tmp_path)
    if "pbc" in inspect.signature(getattr(ref_grpc, case)).parameters:
        assert any(e[0] == "pb" for e in logs["port"])


def test_one_descriptor_same_bytes():
    """The port's api.proto and api_pb2 are the reference's: the same
    file, package and service path, so a message built from either
    serializes to the same bytes."""
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.services_by_name["Dgraph"].full_name == \
        "api.Dgraph"
    req = tpb.Request(query="{ q(func: has(a)) { a } }", vars={"$x": "1"},
                      commit_now=True)
    assert req.SerializeToString(deterministic=True) == jpb.Request(
        query=req.query, vars=dict(req.vars),
        commit_now=True).SerializeToString(deterministic=True)


def test_check_version_reports_the_package_version():
    alpha = AlphaServer(device="cpu")
    server, port = serve_grpc(alpha, port=0)
    c = GrpcClient(f"127.0.0.1:{port}")
    try:
        assert c.check_version()["tag"] == f"dgraph-tpu-{__version__}"
        assert __version__ == "0.1.0"
    finally:
        c.close()
        server.stop(0)
