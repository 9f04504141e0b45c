"""gRPC API surface for the Alpha.

The reference's primary client protocol is gRPC (api.Dgraph service:
Login/Query/Mutate/Alter/CommitOrAbort/CheckVersion —
dgraph/cmd/alpha/run.go:362 serveGRPC, protos/api). Same service shape
here over grpc's generic handlers: method names match the reference,
message bodies are wire-format dicts (dgraph_tpu_torch/wire) instead of
protobuf — the framework's one stable encoding everywhere. Status
codes map like the reference: ABORTED for txn conflicts,
PERMISSION_DENIED for ACL, INVALID_ARGUMENT for bad requests.

Serving and the HTTP front end share AlphaServer's
transport-independent handlers, so every feature (ACL, txns by
startTs, draining, upserts) behaves identically on both transports.

Port of `dgraph_tpu/server/grpc_api.py`: a copy, its imports pointed at this
package. `CheckVersion` reports the
package's `__version__`.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.cluster.coordinator import TxnAborted
from dgraph_tpu_torch.server.acl import AclError
from dgraph_tpu_torch.server.http import AlphaServer
from dgraph_tpu_torch.utils.reqctx import (
    Cancelled, DeadlineExceeded, Overloaded, RequestContext,
)

_SERVICE = "dgraph.tpu.Alpha"


def _abort_for(context, e):
    """One exception -> gRPC status table for BOTH services (status
    codes as the reference maps them: ABORTED for txn conflicts,
    PERMISSION_DENIED for ACL, INVALID_ARGUMENT for bad requests,
    DEADLINE_EXCEEDED / CANCELLED / RESOURCE_EXHAUSTED for the
    request-context + admission-control layer)."""
    if isinstance(e, TxnAborted):
        context.abort(grpc.StatusCode.ABORTED,
                      f"Transaction has been aborted. Please retry: {e}")
    if isinstance(e, DeadlineExceeded):
        context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
    if isinstance(e, Cancelled):
        context.abort(grpc.StatusCode.CANCELLED, str(e))
    if isinstance(e, Overloaded):
        # retryable by contract (the reference's rate limiter answers
        # the same status; clients back off with jitter)
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
    if isinstance(e, AclError):
        context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
    if isinstance(e, (ValueError, KeyError)):
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
    context.abort(grpc.StatusCode.INTERNAL,
                  f"{type(e).__name__}: {e}")


def _ctx_of(context) -> Optional[RequestContext]:
    """RequestContext from the gRPC deadline + trace metadata:
    time_remaining() carries the client's timeout field through every
    hop (the reference's context.Context), and a W3C `traceparent`
    metadata entry (or x-dgraph-trace-id) joins this request's spans
    — on every node it touches — to the caller's trace; None when the
    client sent neither."""
    from dgraph_tpu_torch.utils import tracing

    if context is None:
        return None
    tr = context.time_remaining()
    tid = parent = ""
    md = dict(context.invocation_metadata() or ())
    got = tracing.parse_traceparent(md.get("traceparent", ""))
    if got is not None:
        tid, parent = got
    tid = md.get("x-dgraph-trace-id", "") or tid
    if tr is None:
        if tid:
            return RequestContext.background(trace_id=tid,
                                             parent_span=parent)
        return None
    return RequestContext.with_timeout(tr, trace_id=tid,
                                       parent_span=parent)


def _wrap(fn):
    def method(request, context):
        try:
            return fn(request or {}, _ctx_of(context))
        except Exception as e:  # noqa: BLE001  # dglint: disable=DG07 (_abort_for maps RequestAborted to typed gRPC status then raises via context.abort)
            _abort_for(context, e)

    return method


def _handlers(alpha: AlphaServer) -> dict:
    def login(req, ctx):
        return alpha.handle_login(req.get("body", {}))

    def query(req, ctx):
        return alpha.handle_query(req.get("q", ""),
                                  req.get("params", {}),
                                  req.get("token", ""), ctx=ctx)

    def mutate(req, ctx):
        return alpha.handle_mutate(req.get("body", b""),
                                   req.get("content_type",
                                           "application/rdf"),
                                   req.get("params", {}),
                                   req.get("token", ""), ctx=ctx)

    def alter(req, ctx):
        return alpha.handle_alter(req.get("body", b""),
                                  req.get("token", ""), ctx=ctx)

    def commit(req, ctx):
        return alpha.handle_commit(req.get("params", {}),
                                   req.get("token", ""), ctx=ctx)

    def check_version(req, ctx):
        from dgraph_tpu_torch import __version__
        return {"tag": f"dgraph-tpu-{__version__}"}

    return {"Login": login, "Query": query, "Mutate": mutate,
            "Alter": alter, "CommitOrAbort": commit,
            "CheckVersion": check_version}


_PB_SERVICE = "api.Dgraph"  # the reference's published service path
                            # (/api.Dgraph/Query ... — dgo/pydgraph)


def _pb_wrap(fn):
    def method(request, context):
        try:
            return fn(request, context)
        except Exception as e:  # noqa: BLE001  # dglint: disable=DG07 (_abort_for maps RequestAborted to typed gRPC status then raises via context.abort)
            _abort_for(context, e)

    return method


def _strip_dollar(vars_map) -> dict:
    """Clients send GraphQL vars keyed "$n" (the dgo convention);
    the engine's variable table is keyed bare."""
    return {(k[1:] if k.startswith("$") else k): v
            for k, v in dict(vars_map).items()}


def _rdf_escape(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n").replace("\t", "\\t")
            .replace("\r", "\\r"))


def _go_time_decode(data: bytes) -> str:
    """Go time.Time.MarshalBinary -> RFC3339 text. dgo clients build
    DatetimeVal/DATETIME facets with exactly these bytes (ref
    types/conversion.go DateTimeID arm); layout: version byte (1|2),
    int64 BE seconds since year 1, int32 BE nanos, int16 BE zone
    offset in minutes (-1 = UTC)."""
    import struct
    from datetime import datetime, timedelta, timezone
    if len(data) < 15 or data[0] not in (1, 2):
        # lenient fallback: some clients send RFC3339 text bytes
        return data.decode()
    sec, nsec, off = struct.unpack(">xqih", data[:15])
    unix = sec - 62135596800  # year 1 -> unix epoch
    tz = timezone.utc if off in (-1, 0) \
        else timezone(timedelta(minutes=off))
    dt = datetime.fromtimestamp(unix, tz) + timedelta(
        microseconds=nsec // 1000)
    return dt.isoformat()


def _pb_value_literal(v) -> str:
    """api.Value -> RDF object literal (typed per the oneof arm, the
    inverse of chunker/rdf_parser.go's typed-literal handling)."""
    import base64 as _b64
    which = v.WhichOneof("val")
    if which is None or which == "default_val":
        return f'"{_rdf_escape(v.default_val)}"'
    if which == "str_val":
        return f'"{_rdf_escape(v.str_val)}"'
    if which == "int_val":
        return f'"{v.int_val}"^^<xs:int>'
    if which == "bool_val":
        return f'"{"true" if v.bool_val else "false"}"^^<xs:boolean>'
    if which == "double_val":
        return f'"{v.double_val!r}"^^<xs:float>'
    if which == "password_val":
        return f'"{_rdf_escape(v.password_val)}"^^<xs:password>'
    if which == "geo_val":
        return f'"{_rdf_escape(v.geo_val.decode())}"^^<geo:geojson>'
    if which == "date_val":
        return (f'"{_rdf_escape(_go_time_decode(v.date_val))}"'
                '^^<xs:date>')
    if which == "datetime_val":
        return (f'"{_rdf_escape(_go_time_decode(v.datetime_val))}"'
                '^^<xs:dateTime>')
    if which == "bytes_val":
        return (f'"{_b64.b64encode(v.bytes_val).decode()}"'
                '^^<xs:base64Binary>')
    if which == "uid_val":
        return f"<{hex(v.uid_val)}>"
    raise ValueError(f"unsupported Value arm {which!r}")


def _pb_facet_literal(f, pb) -> str:
    """api.Facet value bytes -> facet literal text. dgraph's facet
    values travel BINARY-encoded (types/conversion.go Marshal to
    BinaryID: int64/float64 little-endian, bool one byte, datetime
    Go MarshalBinary); text is accepted too for lenient clients."""
    import struct
    raw = bytes(f.value)
    if f.val_type == pb.Facet.INT:
        if len(raw) == 8:
            return str(struct.unpack("<q", raw)[0])
        return str(int(raw.decode()))
    if f.val_type == pb.Facet.FLOAT:
        if len(raw) == 8:
            return repr(struct.unpack("<d", raw)[0])
        return raw.decode()
    if f.val_type == pb.Facet.BOOL:
        if len(raw) == 1 and raw[0] in (0, 1):
            return "true" if raw[0] else "false"
        return "true" if raw.decode().lower() in ("true", "1") \
            else "false"
    if f.val_type == pb.Facet.DATETIME:
        return f'"{_rdf_escape(_go_time_decode(raw))}"'
    # STRING renders quoted; the parser re-infers
    return f'"{_rdf_escape(raw.decode())}"'


def _pb_nquads_rdf(nqs, pb) -> str:
    """api.NQuad list -> RDF lines the chunker grammar accepts (the
    structured-mutation arm of the dgo contract: Mutation.set/del)."""
    lines = []
    for nq in nqs:
        subj = nq.subject if nq.subject.startswith(("_:", "uid(")) \
            else f"<{nq.subject}>"
        if nq.object_id:
            if nq.object_id in ("_STAR_ALL", "*"):
                obj = "*"
            elif nq.object_id.startswith(("_:", "uid(")):
                obj = nq.object_id
            else:
                obj = f"<{nq.object_id}>"
        else:
            obj = _pb_value_literal(nq.object_value)
            if nq.lang:
                obj += f"@{nq.lang}"
        line = f"{subj} <{nq.predicate}> {obj}"
        if nq.facets:
            inner = ", ".join(
                f"{f.key}={_pb_facet_literal(f, pb)}" for f in nq.facets)
            line += f" ({inner})"
        lines.append(line + " .")
    return "\n".join(lines)


def _pb_handlers(alpha: AlphaServer) -> dict:
    """The protobuf api.Dgraph service (proto/api.proto — the dgo/v2
    public contract, field numbers included) — same transport-
    independent AlphaServer handlers as HTTP and the wire-dict
    service, so stock dgo/pydgraph clients work against this server
    (ref alpha/run.go:362 registering api.Dgraph;
    edgraph/server.go:634 doQuery)."""
    import json

    from dgraph_tpu_torch.proto import api_pb2 as pb

    def token_of(req, context):
        md = dict(context.invocation_metadata() or ())
        return md.get("accessjwt", "")

    def _latency(ext: dict) -> "pb.Latency":
        lat = ext.get("latency") or {}
        return pb.Latency(
            parsing_ns=int(lat.get("parsing_ns", 0)),
            processing_ns=int(lat.get("processing_ns", 0)),
            encoding_ns=int(lat.get("encoding_ns", 0)),
            assign_timestamp_ns=int(lat.get("assign_timestamp_ns", 0)))

    def _txn_ctx(ext: dict) -> "pb.TxnContext":
        txn = ext.get("txn") or {}
        return pb.TxnContext(
            start_ts=int(txn.get("start_ts", 0)),
            commit_ts=int(txn.get("commit_ts", 0)),
            aborted=bool(txn.get("aborted", False)),
            preds=[str(p) for p in txn.get("preds", ())])

    def login(req, context):
        out = alpha.handle_login({
            "userid": req.userid, "password": req.password,
            "refresh_token": req.refresh_token})
        data = out.get("data", {})
        # the dgo contract ships the Jwt SERIALIZED inside
        # Response.json (edgraph/access_ee.go:91 marshals api.Jwt
        # into resp.Json); dgo/pydgraph parse it from there
        jwt = pb.Jwt(
            access_jwt=data.get("accessJwt", "")
            or data.get("accessJWT", ""),
            refresh_jwt=data.get("refreshJwt", "")
            or data.get("refreshJWT", ""))
        return pb.Response(json=jwt.SerializeToString())

    def query(req, context):
        token = token_of(req, context)
        ctx = _ctx_of(context)
        params = {}
        # pb.Request carries no explain field; an `x-dgraph-explain:
        # plan|analyze` metadata entry (or the in-query `@explain`
        # directive, which needs no transport support) requests the
        # plan tree — pb.Response has no extensions slot either, so
        # the tree comes back as `x-dgraph-explain-json` trailing
        # metadata; the data payload stays byte-identical
        md = dict(context.invocation_metadata() or ()) \
            if context is not None else {}
        if md.get("x-dgraph-explain"):
            params["explain"] = md["x-dgraph-explain"]
        if req.start_ts:
            params["startTs"] = str(req.start_ts)
        if req.best_effort:
            params["be"] = "true"
        if req.read_only:
            params["ro"] = "true"
        if req.mutations:
            # mutation / upsert request (the reference's do-request
            # path: mutations ride in the same Request as the query;
            # each is independently @if-gated in ONE transaction)
            def one(m) -> dict:
                d: dict = {}
                if m.set_json:
                    d["set"] = json.loads(m.set_json.decode())
                if m.delete_json:
                    d["delete"] = json.loads(m.delete_json.decode())
                set_rdf = m.set_nquads.decode() if m.set_nquads else ""
                del_rdf = m.del_nquads.decode() if m.del_nquads else ""
                # structured NQuads (dgo's api.NQuad arm) join the
                # text arm as RDF lines
                m_del = getattr(m, "del")  # python keyword
                if m.set:
                    set_rdf = "\n".join(
                        x for x in (set_rdf, _pb_nquads_rdf(m.set, pb))
                        if x)
                if m_del:
                    del_rdf = "\n".join(
                        x for x in (del_rdf, _pb_nquads_rdf(m_del, pb))
                        if x)
                if set_rdf:
                    d["setNquads"] = set_rdf
                if del_rdf:
                    d["delNquads"] = del_rdf
                if m.cond:
                    d["cond"] = m.cond
                return d

            if len(req.mutations) == 1:
                env = one(req.mutations[0])
            else:
                env = {"mutations": [one(m) for m in req.mutations]}
            if req.query:
                env["query"] = req.query
                if req.vars:
                    env["variables"] = _strip_dollar(req.vars)
            commit_now = req.commit_now or any(
                m.commit_now for m in req.mutations)
            params["commitNow"] = "true" if commit_now else "false"
            out = alpha.handle_mutate(
                json.dumps(env).encode(), "application/json",
                params, token, ctx=ctx)
            ext = out.get("extensions", {})
            data = out.get("data", out)
            return pb.Response(
                json=json.dumps(data.get("queries", {}),
                                separators=(",", ":")).encode(),
                txn=_txn_ctx(ext), latency=_latency(ext),
                uids={k: str(v)
                      for k, v in (data.get("uids") or
                                   out.get("uids") or {}).items()})
        payload = {"query": req.query,
                   "variables": _strip_dollar(req.vars)} \
            if req.vars else req.query
        out = alpha.handle_query(payload, params, token, ctx=ctx)
        ext = out.get("extensions", {})
        if ext.get("explain") is not None and context is not None:
            context.set_trailing_metadata((
                ("x-dgraph-explain-json",
                 json.dumps(ext["explain"], separators=(",", ":"))),))
        return pb.Response(
            json=json.dumps(out.get("data", {}),
                            separators=(",", ":")).encode(),
            txn=_txn_ctx(ext), latency=_latency(ext))

    def alter(req, context):
        token = token_of(req, context)
        if req.drop_all or req.drop_op == pb.Operation.ALL:
            body = json.dumps({"drop_all": True}).encode()
        elif req.drop_attr:
            body = json.dumps({"drop_attr": req.drop_attr}).encode()
        elif req.drop_op == pb.Operation.ATTR:
            body = json.dumps({"drop_attr": req.drop_value}).encode()
        elif req.drop_op != pb.Operation.NONE or req.drop_value:
            raise ValueError(
                "this drop_op is not supported by this server; use "
                "drop_attr or drop_all")
        else:
            body = req.schema.encode()
        alpha.handle_alter(body, token, ctx=_ctx_of(context))
        return pb.Payload(Data=b"Success")

    def commit_or_abort(req, context):
        # dgo semantics: CommitOrAbort COMMITS unless the context's
        # aborted flag is set (txn.Discard sends aborted=true;
        # edgraph/server.go:920 CommitOrAbort)
        token = token_of(req, context)
        out = alpha.handle_commit(
            {"startTs": str(req.start_ts),
             "abort": "true" if req.aborted else "false"}, token,
            ctx=_ctx_of(context))
        return _txn_ctx(out.get("extensions", {}))

    def check_version(req, context):
        from dgraph_tpu_torch import __version__
        return pb.Version(tag=f"dgraph-tpu-{__version__}")

    return {"Login": (login, pb.LoginRequest),
            "Query": (query, pb.Request),
            "Alter": (alter, pb.Operation),
            "CommitOrAbort": (commit_or_abort, pb.TxnContext),
            "CheckVersion": (check_version, pb.Check)}


def serve_grpc(alpha: AlphaServer, host: str = "127.0.0.1",
               port: int = 9080, max_workers: int = 16,
               tls_dir: str = "", require_client_cert: bool = False
               ) -> tuple[grpc.Server, int]:
    """Start the gRPC front end; -> (server, bound port). With
    tls_dir, serves over TLS from the same cert dir as the HTTP front
    end (x/tls_helper.go applies one TLS config to both listeners);
    require_client_cert turns on mTLS."""
    import os

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers))
    rpcs = {
        name: grpc.unary_unary_rpc_method_handler(
            _wrap(fn), request_deserializer=wire.loads,
            response_serializer=wire.dumps)
        for name, fn in _handlers(alpha).items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, rpcs),))
    # the protobuf api.Dgraph service on the SAME listener: serialized
    # with the committed generated messages (proto/api.proto), so
    # generated clients in any language interoperate
    pb_rpcs = {
        name: grpc.unary_unary_rpc_method_handler(
            _pb_wrap(fn),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())
        for name, (fn, req_cls) in _pb_handlers(alpha).items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_PB_SERVICE, pb_rpcs),))
    addr = f"{host}:{port}"
    if tls_dir:
        with open(os.path.join(tls_dir, "node.key"), "rb") as f:
            key = f.read()
        with open(os.path.join(tls_dir, "node.crt"), "rb") as f:
            crt = f.read()
        root = None
        if require_client_cert:
            with open(os.path.join(tls_dir, "ca.crt"), "rb") as f:
                root = f.read()
        creds = grpc.ssl_server_credentials(
            [(key, crt)], root_certificates=root,
            require_client_auth=require_client_cert)
        bound = server.add_secure_port(addr, creds)
    else:
        bound = server.add_insecure_port(addr)
    if bound == 0:
        raise OSError(f"gRPC could not bind {addr}")
    server.start()
    return server, bound


class GrpcClient:
    """The dgo-shaped client: Login/Query/Mutate/Alter/CommitOrAbort
    over the gRPC channel."""

    def __init__(self, addr: str, token: str = ""):
        self.channel = grpc.insecure_channel(addr)
        self.token = token
        self._stubs = {
            name: self.channel.unary_unary(
                f"/{_SERVICE}/{name}", request_serializer=wire.dumps,
                response_deserializer=wire.loads)
            for name in ("Login", "Query", "Mutate", "Alter",
                         "CommitOrAbort", "CheckVersion")
        }

    def login(self, userid: str, password: str) -> dict:
        out = self._stubs["Login"](
            {"body": {"userid": userid, "password": password}})
        self.token = out["data"]["accessJWT"]
        return out

    def query(self, q: str, variables: Optional[dict] = None,
              start_ts: int = 0, best_effort: bool = False,
              timeout: Optional[float] = None) -> dict:
        params = {}
        if start_ts:
            params["startTs"] = str(start_ts)
        if best_effort:
            params["be"] = "true"
        # handle_query accepts either DQL text or the JSON envelope
        payload = {"query": q, "variables": variables} if variables else q
        # `timeout` becomes the gRPC deadline; the server reads it via
        # context.time_remaining() and aborts work past it
        return self._stubs["Query"](
            {"q": payload, "params": params, "token": self.token},
            timeout=timeout)

    def mutate(self, body: bytes | str,
               content_type: str = "application/rdf",
               commit_now: bool = True, start_ts: int = 0) -> dict:
        params = {"commitNow": "true" if commit_now else "false"}
        if start_ts:
            params["startTs"] = str(start_ts)
        if isinstance(body, str):
            body = body.encode()
        return self._stubs["Mutate"](
            {"body": body, "content_type": content_type,
             "params": params, "token": self.token})

    def alter(self, schema_text: str) -> dict:
        return self._stubs["Alter"](
            {"body": schema_text.encode(), "token": self.token})

    def commit(self, start_ts: int, abort: bool = False) -> dict:
        return self._stubs["CommitOrAbort"](
            {"params": {"startTs": str(start_ts),
                        "abort": "true" if abort else "false"},
             "token": self.token})

    def check_version(self) -> dict:
        return self._stubs["CheckVersion"]({})

    def close(self):
        self.channel.close()
