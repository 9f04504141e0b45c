"""The port's HTTP Alpha (dgraph_tpu_torch.server: http, acl, qos, tls,
debug_http; utils.rwlock) against the reference's, on the CPU.

The reference's tests of the HTTP surface (test_http, test_http_
concurrency, test_acl) and its three live-load-over-HTTP tests
(test_ingest's `remote_live_load` cases) run through both packages
(`tests/torch_twins.run_twins`): the reference with the engines its
tests build (`prefer_device=False`), the port with `GraphDB`,
`AlphaServer` and `serve` on `device="cpu"`. Each HTTP
response (status and body) and each `AlphaServer.handle_*` result must
be equal between the passes, masked as `torch_twins.MASKED` names. A
case that uses test_http's module-scoped server runs after
`test_alter_and_schema` on its own server, as it does in the
reference's file order.

`AlphaServer()` and `serve()` build their engine on the card unless
given `device`; without a card they raise.
"""

from __future__ import annotations

import inspect
import json
import urllib.request

import pytest
import torch

import tests.test_http as ref_http
from dgraph_tpu_torch.engine.db import GraphDB
from dgraph_tpu_torch.server import AlphaServer, serve
from tests.torch_twins import reference_cases, run_twins

HTTP = reference_cases("test_http")
CONCURRENCY = reference_cases("test_http_concurrency")
ACL = reference_cases("test_acl")
LIVE = ["test_remote_live_load_into_running_alpha",
        "test_remote_live_load_datetime_facet",
        "test_remote_live_load_xid_subjects"]
# balances each reader sees depend on how its reads interleave with the
# transfers, so the two passes' bodies differ; the case's own
# invariant (every read sums to the total) holds in both
TIMING = {"test_concurrent_queries_and_mutations_consistent"}


def test_the_reference_files_hold_their_cases():
    assert (len(HTTP), len(CONCURRENCY), len(ACL)) == (17, 6, 9)


def _after_schema(case):
    uses_server = "server" in inspect.signature(
        getattr(ref_http, case)).parameters
    return ["test_alter_and_schema", case] \
        if uses_server and case != "test_alter_and_schema" else [case]


@pytest.mark.parametrize("case", HTTP)
def test_http_through_both(case, tmp_path):
    run_twins("test_http", _after_schema(case), tmp_path)


@pytest.mark.parametrize("case", CONCURRENCY)
def test_http_concurrency_through_both(case, tmp_path, capsys):
    run_twins("test_http_concurrency", [case], tmp_path, capsys=capsys,
              compare=None if case in TIMING else "multiset")


@pytest.mark.parametrize("case", ACL)
def test_acl_through_both(case, tmp_path):
    run_twins("test_acl", [case], tmp_path)


@pytest.mark.parametrize("case", LIVE)
def test_remote_live_load_through_both(case, tmp_path):
    logs = run_twins("test_ingest", [case], tmp_path)
    assert any(e[0] == "http" and e[1] == 200 for e in logs["port"])


# -- the device an Alpha's engine runs on ----------------------------------


def test_alpha_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlphaServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(port=0, block=False)
    assert AlphaServer(device="cpu").db.device == torch.device("cpu")
    # a caller's engine keeps its own device
    db = GraphDB(device="cpu")
    assert AlphaServer(db).db is db


def test_serve_builds_its_engine_on_device():
    httpd, alpha = serve(port=0, block=False, device="cpu")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(
            base + "/alter", b"sname: string @index(exact) .",
            {"Content-Type": "application/dql"})
        urllib.request.urlopen(req, timeout=30).read()
        req = urllib.request.Request(
            base + "/mutate?commitNow=true", b'_:a <sname> "s" .',
            {"Content-Type": "application/rdf"})
        urllib.request.urlopen(req, timeout=30).read()
        req = urllib.request.Request(
            base + "/query", b'{ q(func: eq(sname, "s")) { sname } }',
            {"Content-Type": "application/dql"})
        got = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert got["data"]["q"] == [{"sname": "s"}]
        assert alpha.db.device == torch.device("cpu")
    finally:
        httpd.shutdown()
        httpd.server_close()
