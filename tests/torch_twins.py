"""Run the reference's serving and cluster tests through both packages.

`run_twins(ref_name, names)` runs test cases of `tests/<ref_name>.py`
twice in one process: once as they are (the reference, its engines on
the host with `prefer_device=False` as the tests build them), and once
with every name they take from `dgraph_tpu` bound to the port's
counterpart (`GraphDB`, `AlphaServer` and every function taking
`device` default to `device="cpu"`). The cases of one call share their
fixtures, as cases of one module share a module-scoped fixture, so a
case that needs the schema an earlier case set up names that case
before it; each call builds its own servers and data, so nothing is
shared between the port's tests.

While a pass runs, every response the serving layer produces is
recorded: each HTTP response (status and body) at the handler's
`_send_raw`, each `AlphaServer.handle_*` result or raised error, each
`MicroBatcher.query_json` body, each protobuf response of the
`api.Dgraph` service serialized to bytes, and each answer of the cluster
(`CLUSTER_CALLS`: what a `ClusterClient`, `RoutedCluster` or
`ReplicatedGroup` caller got back at its outermost call, the seeded raft
harness's elections, proposals and drained `ready()`s), the last one
only where a caller repeats one request (polling).

The cluster's engines follow the same rule: in the port's pass the
cluster `AlphaServer` and `ReplicatedGroup` get `device="cpu"` in their
engine keywords, `FederatedDB`, `RoutedCluster` and `ProcessCluster` get
`device="cpu"` (their `__init__` wrapped in place), and every `python -m
dgraph_tpu node` a case spawns (`subprocess.Popen`) becomes `python -m
dgraph_tpu_torch node --device cpu`. The two passes' records must
be equal after masking the fields named in `MASKED` (wall-clock
timings, uptimes, trace and span ids, JWTs, sampled stacks), in a
cluster answer also `CLUSTER_MASKED` (Zero's timestamps), and
reading each pass's own directory as `<tmp>`: as multisets, since a
case's threads race for the order, or not at all where the recorded
values themselves depend on thread timing (`compare=None`, given with
the reason at the call).

Both passes start from a clean observability plane (metrics, spans,
request log, cost store, watchdog, failpoints, fault rules) in their
own package, and a pass that leaves a failpoint or a fault rule armed
fails. Both passes take the ports of the nodes they spawn from below
the kernel's ephemeral range (`steady_free_ports`, in place of
`bench.spawn.free_ports` and a test file's own `_free_ports`).

A case the reference marks `lockcheck` or `racecheck` (on its function,
its class or its module's `pytestmark`) runs with its own pass's
runtime witness armed (`utils/lockcheck`, `utils/racecheck` of the
reference in the reference's pass, of the port in the port's; never
both at once, since each patches `threading.Lock` for the process),
with the marker's `strict` and `sample` keywords, and any violation
recorded fails the pass, as tests/conftest.py fails the reference's own
run. As under pytest, the case's module-scoped fixtures are built
before the witness is armed, its function-scoped ones after.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import json
import os
import random
import re
import socket
import subprocess
import sys
import threading
import traceback
import types
from pathlib import Path

import pytest

from dgraph_tpu.bench import spawn as jspawn
from dgraph_tpu.engine import batcher as jbatcher
from dgraph_tpu.server import grpc_api as jgrpc
from dgraph_tpu.server import http as jhttp
from dgraph_tpu_torch.bench import spawn as tspawn
from dgraph_tpu_torch.cluster import federated as tfederated
from dgraph_tpu_torch.cluster import replica as treplica
from dgraph_tpu_torch.cluster import service as tservice
from dgraph_tpu_torch.cluster import topology as ttopology
from dgraph_tpu_torch.engine import batcher as tbatcher
from dgraph_tpu_torch.engine.db import GraphDB as TDB
from dgraph_tpu_torch.server import grpc_api as tgrpc
from dgraph_tpu_torch.server import http as thttp

# masked wherever they appear in a recorded body, with why:
MASKED = {
    # wall-clock durations of the request's own stages
    "server_latency", "latency", "latency_ms", "parsing_ns",
    "processing_ns", "encoding_ns", "assign_timestamp_ns", "total_ns",
    "uptime_s", "elapsed_ms", "wall_ms", "duration_ms",
    # random per-request identities
    "trace_id", "traceId", "span_id", "spanId", "parent_id",
    # JWTs sign a wall-clock expiry
    "accessJwt", "refreshJwt",
    # the sampling profiler's catch: which stacks, how many samples
    # and threads it saw in its window
    "collapsed", "profiles", "shared", "samples", "threads",
    # a backup manifest entry's wall-clock second: the two passes may
    # take their backups in different seconds
    "unix_ts",
}
# masked in what a cluster client got back, with why: Zero leases every
# timestamp, and background work (rebalance ticks, moves, writers the
# case runs beside its reads) draws from the same oracle
CLUSTER_MASKED = {"start_ts", "commit_ts", "read_ts"}
# a trace id quoted in an error message
_TRACE_RE = re.compile(r"trace [0-9a-f]{16}")

# reference modules the tests import inside their bodies: loaded before a
# port pass so that `sys.modules` aliases them to the port's
PRELOAD = ("cli", "server", "server.acl", "server.qos", "server.tls",
           "server.debug_http", "proto", "proto.api_pb2",
           "storage.backup", "storage.snapshot", "ingest.live",
           "ingest.bulk", "ingest.export", "gql", "gql.parser",
           "utils.logger", "utils.rwlock", "utils.reqctx", "utils.pprof",
           "utils.alerts", "utils.watchdog", "utils.netfault",
           "cluster.raft", "cluster.transport", "cluster.harness",
           "cluster.client", "cluster.zero", "cluster.rebalance",
           "cluster.replica", "cluster.replication", "cluster.federated",
           "cluster.topology", "cluster.service", "bench.spawn",
           "cdc.changelog", "storage.versions", "storage.wal",
           "storage.tablet", "gql.nquad", "engine.result_cache",
           "bench.openloop", "bench.workload", "utils.lockcheck",
           "utils.racecheck")
for _name in PRELOAD:
    importlib.import_module(f"dgraph_tpu.{_name}")
    importlib.import_module(f"dgraph_tpu_torch.{_name}")

# the handlers whose results are recorded
HANDLERS = ("handle_query", "handle_query_json", "handle_mutate",
            "handle_commit", "handle_alter", "handle_login",
            "handle_export", "handle_backup", "handle_get_schema",
            "handle_cancel", "handle_draining", "handle_assign")
# the cluster's calls whose answers are recorded (module, class, methods,
# whether only the test's own thread's calls count): what a caller of
# the cluster gets back, and the deterministic raft harness's elections
# and proposals (a served node's raft runs on its tick thread, on the
# wall clock)
CLUSTER_CALLS = (
    ("cluster.client", "ClusterClient",
     ("query", "query_at", "mutate", "txn_mutate", "txn_commit", "alter",
      "hello"), False),
    ("cluster.topology", "RoutedCluster", ("query", "mutate", "alter"),
     False),
    ("cluster.replica", "ReplicatedGroup", ("query", "mutate", "alter"),
     False),
    ("cluster.harness", "SimCluster",
     ("leader", "wait_leader", "propose", "pump"), True),
    ("cluster.raft", "RaftNode", ("propose", "ready"), True),
)


# -- binding the reference's names to the port's ----------------------------


class CpuGraphDB(TDB):
    """The port's GraphDB, on the CPU unless told otherwise."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


class CpuAlphaServer(thttp.AlphaServer):
    """The port's AlphaServer, its own engine on the CPU unless told
    otherwise."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


_CPU_CLASSES = {TDB: CpuGraphDB, thttp.AlphaServer: CpuAlphaServer}


def _device_cpu(init):
    @functools.wraps(init)
    def run(self, *args, device="cpu", **kw):
        init(self, *args, device=device, **kw)
    return run


def _db_kw_cpu(init):
    @functools.wraps(init)
    def run(self, *args, db_kw=None, **kw):
        init(self, *args, db_kw={"device": "cpu", **(db_kw or {})}, **kw)
    return run


def _kw_cpu(init):
    @functools.wraps(init)
    def run(self, *args, **db_kw):
        db_kw.setdefault("device", "cpu")
        init(self, *args, **db_kw)
    return run


# the cluster's classes whose engines a port pass puts on the CPU, by
# wrapping their __init__ in place (the classes stay themselves, so a
# `RoutedCluster` that `ProcessCluster.routed()` builds is the one the
# test imports): the cluster AlphaServer's `db_kw`, ReplicatedGroup's
# engine keywords, and the device of the rest
_CPU_INITS = ((tservice.AlphaServer, _db_kw_cpu),
              (treplica.ReplicatedGroup, _kw_cpu),
              (tfederated.FederatedDB, _device_cpu),
              (ttopology.RoutedCluster, _device_cpu),
              (tspawn.ProcessCluster, _device_cpu))


def _is_reference_name(name: str) -> bool:
    return name == "dgraph_tpu" or name.startswith("dgraph_tpu.")


def _port_module(name: str):
    try:
        return importlib.import_module(
            "dgraph_tpu_torch" + name[len("dgraph_tpu"):])
    except ImportError:
        return None


def _cpu_kw(fn):
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def run(*args, **kw):
        if "device" not in sig.bind_partial(*args, **kw).arguments:
            kw["device"] = "cpu"
        return fn(*args, **kw)
    return run


def on_cpu(obj):
    """`obj` as a test of the port receives it."""
    if isinstance(obj, type) and obj in _CPU_CLASSES:
        return _CPU_CLASSES[obj]
    if inspect.isfunction(obj) and \
            "device" in inspect.signature(obj).parameters:
        return _cpu_kw(obj)
    return obj


class PortModule(types.ModuleType):
    """A port module seen through `on_cpu`, standing under the
    reference's module name while a case runs on the port."""

    def __init__(self, mod):
        super().__init__(mod.__name__)
        self.__dict__["_mod"] = mod

    def __getattr__(self, name):
        return on_cpu(getattr(self.__dict__["_mod"], name))

    def __setattr__(self, name, value):
        setattr(self.__dict__["_mod"], name, value)

    def __delattr__(self, name):
        delattr(self.__dict__["_mod"], name)


def _port_counterpart(obj):
    if inspect.ismodule(obj):
        if not _is_reference_name(obj.__name__):
            return obj
        mod = _port_module(obj.__name__)
        return PortModule(mod) if mod is not None else obj
    mod_name = getattr(obj, "__module__", "") or ""
    if not _is_reference_name(mod_name):
        return obj
    mod = _port_module(mod_name)
    if mod is None or not hasattr(mod, obj.__qualname__):
        return obj
    return on_cpu(getattr(mod, obj.__qualname__))


def bind_port(ref_mod, mp, helpers=()):
    """Rebind the names `ref_mod` and the `helpers` modules it drives
    took from dgraph_tpu, and alias the reference's loaded modules to
    the port's (imports inside test bodies), for one pass."""
    for mod in (ref_mod, *helpers):
        for name, obj in list(vars(mod).items()):
            if inspect.ismodule(obj) or inspect.isclass(obj) or \
                    callable(obj):
                got = _port_counterpart(obj)
                if got is not obj:
                    mp.setattr(mod, name, got)
    for name in [k for k in sys.modules if _is_reference_name(k)]:
        if name == "dgraph_tpu":
            continue
        mod = _port_module(name)
        if mod is not None:
            mp.setitem(sys.modules, name, PortModule(mod))


# -- recording responses -----------------------------------------------------


def _decoded(body):
    if isinstance(body, (bytes, bytearray)):
        try:
            body = body.decode()
        except UnicodeDecodeError:
            return bytes(body)
    if isinstance(body, str):
        try:
            return json.loads(body)
        except ValueError:
            return body
    return body


def mask(obj, root="", keys=MASKED):
    """`obj` with the value of every key in `keys` replaced, and the
    pass's own directory `root` in strings read as `<tmp>`."""
    if isinstance(obj, dict):
        return {k: "<masked>" if k in keys else mask(v, root, keys)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v, root, keys) for v in obj]
    if isinstance(obj, str):
        if root:
            obj = obj.replace(root, "<tmp>")
        return _TRACE_RE.sub("trace <masked>", obj)
    return obj


def _install_recorders(mp, http, batcher, grpc_api, log, where):
    lock = threading.Lock()

    last = threading.local()

    def put(entry, call=None):
        """Append `entry`; a `call` (the request) equal to the one this
        thread recorded last replaces that record instead: a caller
        polling one request until the answer changes is compared on
        the answer it stopped at, since how often it asked is timing."""
        entry = tuple(mask(entry, str(where), MASKED if call is None
                           else MASKED | CLUSTER_MASKED))
        with lock:
            if call is not None and getattr(last, "call", None) == call \
                    and last.at < len(log):
                log[last.at] = entry
                return
            last.call, last.at = call, len(log)
            log.append(entry)

    send_raw = http._Handler._send_raw

    def rec_send_raw(self, code, data, _f=send_raw):
        put(("http", code, _decoded(data)))
        return _f(self, code, data)
    mp.setattr(http._Handler, "_send_raw", rec_send_raw)

    for name in HANDLERS:
        fn = getattr(http.AlphaServer, name)

        def rec(self, *a, _f=fn, _n=name, **kw):
            try:
                out = _f(self, *a, **kw)
            except Exception as e:
                put(("alpha", _n, "raised", type(e).__name__, str(e)))
                raise
            put(("alpha", _n, _decoded(out)))
            return out
        mp.setattr(http.AlphaServer, name, rec)

    qj = batcher.MicroBatcher.query_json

    def rec_batch(self, *a, _f=qj, **kw):
        try:
            out = _f(self, *a, **kw)
        except Exception as e:
            put(("batcher", "raised", type(e).__name__, str(e)))
            raise
        put(("batcher", _decoded(out)))
        return out
    mp.setattr(batcher.MicroBatcher, "query_json", rec_batch)

    pb_handlers = grpc_api._pb_handlers

    def rec_pb_handlers(alpha, _f=pb_handlers):
        out = {}
        for name, (fn, req_cls) in _f(alpha).items():
            def call(req, context, _fn=fn, _n=name):
                resp = _fn(req, context)
                put(("pb", _n, _pb_bytes(resp)))
                return resp
            out[name] = (call, req_cls)
        return out
    mp.setattr(grpc_api, "_pb_handlers", rec_pb_handlers)
    _install_cluster_recorders(mp, http.__name__.split(".")[0], put)


def _install_cluster_recorders(mp, pkg, put):
    """Record each answer of CLUSTER_CALLS at the caller's outermost
    call (a RoutedCluster query's inner ClusterClient calls are its own
    business: retries and routing differ with timing)."""
    depth = threading.local()
    main = threading.current_thread()
    for mod_name, cls_name, methods, main_only in CLUSTER_CALLS:
        cls = getattr(importlib.import_module(f"{pkg}.{mod_name}"),
                      cls_name)
        for name in methods:
            fn = getattr(cls, name)

            def rec(self, *a, _f=fn, _n=f"{cls_name}.{name}",
                    _main=main_only, **kw):
                outer = getattr(depth, "n", 0) == 0 and \
                    (not _main or threading.current_thread() is main)
                call = (id(self), _n, repr(a), repr(sorted(kw.items())))
                depth.n = getattr(depth, "n", 0) + 1
                try:
                    out = _f(self, *a, **kw)
                except Exception as e:
                    if outer:
                        put(("cluster", _n, "raised", type(e).__name__,
                             str(e)), call)
                    raise
                finally:
                    depth.n -= 1
                if outer:
                    put(("cluster", _n, _decoded(out)), call)
                return out
            mp.setattr(cls, name, rec)


def port_argv(args):
    """A spawned `python -m dgraph_tpu ...` command line as the port's
    pass runs it: `-m dgraph_tpu_torch`, and `node` on the CPU."""
    if not isinstance(args, (list, tuple)):
        return args
    args = list(args)
    for i in range(len(args) - 1):
        if args[i] == "-m" and args[i + 1] == "dgraph_tpu":
            args[i + 1] = "dgraph_tpu_torch"
            if args[i + 2:i + 3] == ["node"] and "--device" not in args:
                args += ["--device", "cpu"]
            break
    return args


class PortPopen(subprocess.Popen):
    """subprocess.Popen with `port_argv` applied."""

    def __init__(self, args, *a, **kw):
        super().__init__(port_argv(args), *a, **kw)


def _pb_bytes(resp):
    """A protobuf response's bytes with its timings cleared, beside
    its decoded JSON payload (map fields serialize in any order)."""
    resp = type(resp).FromString(resp.SerializeToString())
    if resp.DESCRIPTOR.name != "Response":
        return resp.SerializeToString(deterministic=True), None, None
    payload, uids = mask(_decoded(resp.json)), dict(resp.uids)
    for field in ("latency", "json", "uids"):
        resp.ClearField(field)
    return resp.SerializeToString(deterministic=True), payload, uids


# -- the runtime witnesses -----------------------------------------------------

WITNESSES = ("lockcheck", "racecheck")


def witness_marks(*holders) -> dict:
    """{marker name: kwargs} of the lockcheck and racecheck marks on
    `holders` (a case's function, its class, its module), the closest
    holder's mark winning as in pytest's `get_closest_marker`."""
    out: dict = {}
    for holder in holders:
        marks = getattr(holder, "pytestmark", ())
        if not isinstance(marks, (list, tuple)):
            marks = [marks]
        for m in marks:
            m = getattr(m, "mark", m)
            if m.name in WITNESSES:
                out.setdefault(m.name, dict(m.kwargs))
    return out


@contextlib.contextmanager
def witnessed(pkg: str, marks: dict):
    """Arm `pkg`'s own witnesses as `marks` ask (lockcheck first, then
    racecheck, as tests/conftest.py's fixtures do), and fail on any
    violation either recorded."""
    armed = []
    if "lockcheck" in marks:
        lc = importlib.import_module(f"{pkg}.utils.lockcheck")
        lc.enable(strict=bool(marks["lockcheck"].get("strict", False)))
        armed.append(lc)
    if "racecheck" in marks:
        rc = importlib.import_module(f"{pkg}.utils.racecheck")
        rc.enable(strict=bool(marks["racecheck"].get("strict", False)),
                  sample=int(marks["racecheck"].get("sample", 1)))
        armed.append(rc)
    found = []
    try:
        yield
    finally:
        for mod in reversed(armed):
            found += [(mod.__name__, v) for v in mod.disable()]
    if found:
        pytest.fail(f"{pkg}: violation(s) witnessed:\n" + "\n".join(
            f"[{name}] {v}" for name, v in found))


# -- ports of spawned nodes -----------------------------------------------------

# below Linux's default ephemeral range (32768-60999), from which the
# kernel picks the local port of every outbound connection
STEADY_PORTS = (20000, 32768)
# disjoint slices of STEADY_PORTS, one a pytest-xdist worker (gwN takes
# slice N mod PORT_SLICES; a replaced worker's N runs on past the count)
PORT_SLICES = 16
_port_rng = random.Random()
_port_next: dict = {}  # slice -> the next port to try


def port_slice(worker: str | None) -> tuple[int, int]:
    """The [lo, hi) ports of STEADY_PORTS that xdist worker `worker`
    (PYTEST_XDIST_WORKER, None outside xdist) draws from."""
    n = int(worker[2:]) if worker and worker[2:].isdigit() else 0
    lo, hi = STEADY_PORTS
    width = (hi - lo) // PORT_SLICES
    start = lo + n % PORT_SLICES * width
    return start, start + width


def steady_free_ports(n: int) -> list[int]:
    """`bench.spawn.free_ports` (and the cluster tests' own
    `_free_ports`) drawing from STEADY_PORTS. Theirs bind port 0 and
    close it, so the port lies in the ephemeral range: a node started or
    restarted onto it later (`ProcessCluster.restart` keeps a node's
    ports) finds it taken whenever an outbound connection of another
    process picked it as its local port in between, and exits at bind
    (`Address already in use`), which a busy host running other
    clusters' clients makes likely. Each xdist worker draws from its own
    slice (`port_slice`): two workers' clusters that drew the same free
    port at once left one node unable to bind, and a case with no
    leader. Within the slice the ports are handed out in turn from a
    random start, so one comes back only after the whole slice has:
    a client of an earlier case still dialling its node never reaches a
    later case's node."""
    out: list[int] = []
    lo, hi = span = port_slice(os.environ.get("PYTEST_XDIST_WORKER"))
    port = _port_next.get(span, _port_rng.randrange(lo, hi))
    while len(out) < n:
        port = lo + (port + 1 - lo) % (hi - lo)
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        out.append(port)
    _port_next[span] = port
    return out


# -- one pass -----------------------------------------------------------------


def _reset_plane(utils):
    utils.watchdog.stop()
    utils.metrics.reset()
    utils.tracing.clear()
    utils.tracing.set_enabled(True)
    utils.reqlog.reset()
    utils.coststore.reset()
    utils.coststore.set_enabled(True)
    utils.failpoint.clear()
    utils.netfault.clear()


def _utils(pkg):
    return types.SimpleNamespace(**{
        n: importlib.import_module(f"{pkg}.utils.{n}")
        for n in ("watchdog", "metrics", "tracing", "reqlog", "coststore",
                  "failpoint", "netfault")})


def _params(fn) -> dict:
    """{id: {argname: value}} of a test's one parametrize mark."""
    out = {}
    for mark in getattr(fn, "pytestmark", ()):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        values = mark.args[1]
        ids = mark.kwargs.get("ids") or [str(v) for v in values]
        for pid, v in zip(ids, values):
            out[pid] = dict(zip(names, v if len(names) > 1 else (v,)))
    return out


def _autouse(ref_mod):
    return [n for n, obj in vars(ref_mod).items()
            if getattr(getattr(obj, "_fixture_function_marker", None),
                       "autouse", False)]


class _TmpFactory:
    """pytest's tmp_path_factory, inside one pass's directory."""

    def __init__(self, where):
        self.where = Path(where)

    def mktemp(self, basename, numbered=True):
        n = 0
        while (self.where / f"{basename}{n}").exists():
            n += 1
        path = self.where / (f"{basename}{n}" if numbered else basename)
        path.mkdir()
        return path


class _Pass:
    def __init__(self, ref_mod, where, mp, builtins, pkg):
        self.ref_mod, self.where, self.mp = ref_mod, where, mp
        self.builtins = builtins
        self.pkg = pkg
        self.cache: dict = {}
        self.cleanups: list = []

    def shared(self, name) -> bool:
        marker = getattr(getattr(self.ref_mod, name, None),
                         "_fixture_function_marker", None)
        return marker is not None and marker.scope != "function"

    def fixture(self, name, scoped):
        if name == "monkeypatch":
            return self.mp
        if name == "tmp_path":
            return self.where
        if name == "tmp_path_factory":
            return _TmpFactory(self.where)
        if name in self.builtins:
            return self.builtins[name]
        if name in self.cache:
            return self.cache[name]
        fn = getattr(self.ref_mod, name)._get_wrapped_function()
        shared = self.shared(name)
        args = {p: self.fixture(p, scoped)
                for p in inspect.signature(fn).parameters}
        got = fn(**args)
        if inspect.isgenerator(got):
            gen = got
            got = next(gen)
            (self.cleanups if shared else scoped).append(
                lambda: next(gen, None))
        if shared:
            self.cache[name] = got
        return got

    def run(self, case):
        cls_name, _, fn_name = case.rpartition("::")
        fn_name, _, param_id = fn_name.partition("[")
        cls = getattr(self.ref_mod, cls_name) if cls_name else None
        fn = getattr(cls(), fn_name) if cls else \
            getattr(self.ref_mod, fn_name)
        params = _params(fn)[param_id.rstrip("]")] if param_id else {}
        names = [p for p in inspect.signature(fn).parameters
                 if p not in params]
        for name in _autouse(self.ref_mod) + names:
            if self.shared(name):
                self.fixture(name, None)
        scoped: list = []
        with witnessed(self.pkg, witness_marks(fn, cls, self.ref_mod)):
            try:
                for name in _autouse(self.ref_mod):
                    self.fixture(name, scoped)
                args = {p: params[p] if p in params
                        else self.fixture(p, scoped)
                        for p in inspect.signature(fn).parameters}
                fn(**args)
            finally:
                for c in reversed(scoped):
                    c()

    def close(self):
        for c in reversed(self.cleanups):
            c()


def _run_side(side, ref_mod, cases, where, builtins, port_setup, helpers,
              setup):
    utils = _utils("dgraph_tpu" if side == "ref" else "dgraph_tpu_torch")
    http, batcher, grpc_api = (jhttp, jbatcher, jgrpc) if side == "ref" \
        else (thttp, tbatcher, tgrpc)
    log: list = []
    mp = pytest.MonkeyPatch()
    _reset_plane(utils)
    try:
        for spawn in (jspawn, tspawn):
            mp.setattr(spawn, "free_ports", steady_free_ports)
        if hasattr(ref_mod, "_free_ports"):     # the cluster tests' own
            mp.setattr(ref_mod, "_free_ports", steady_free_ports)
        _install_recorders(mp, http, batcher, grpc_api, log, where)
        if port_setup is not None:
            port_setup(mp, ref_mod)
        if side == "port":
            bind_port(ref_mod, mp, helpers)
            for cls, on in _CPU_INITS:
                mp.setattr(cls, "__init__", on(cls.__init__))
            mp.setattr(subprocess, "Popen", PortPopen)
        if setup is not None:
            setup(mp, ref_mod)
        run = _Pass(ref_mod, where, mp, builtins,
                    "dgraph_tpu" if side == "ref" else "dgraph_tpu_torch")
        try:
            for case in cases:
                run.run(case)
        finally:
            run.close()
        leaked = (utils.failpoint.armed(), utils.netfault.rules())
        assert not any(leaked), f"{side} pass leaked {leaked}"
    finally:
        mp.undo()
        _reset_plane(utils)
    return log


def run_twins(ref_name, cases, tmp_path, compare="multiset", capsys=None,
              port_setup=None, helpers=(), setup=None):
    """Run `cases` of tests/<ref_name>.py on the reference, then on the
    port, and hold their recorded responses equal (see the module
    docstring). A case is `name`, `Class::name` or `name[param id]`.
    `port_setup(monkeypatch, ref_mod)` runs before the port's pass only
    (its environment, a subprocess's module), and `setup(monkeypatch,
    ref_mod)` before both, after the port's names are bound; `helpers`
    names modules the cases drive whose `dgraph_tpu` names the port's
    pass rebinds too (a tool the test imports). Returns the two
    records."""
    ref_mod = importlib.import_module(f"tests.{ref_name}")
    helpers = tuple(importlib.import_module(h) for h in helpers)
    logs = {}
    for side in ("ref", "port"):
        where = Path(tmp_path) / side
        where.mkdir()
        builtins = {}
        if capsys is not None:
            capsys.readouterr()
            builtins["capsys"] = capsys
        try:
            logs[side] = _run_side(side, ref_mod, list(cases), where,
                                   builtins,
                                   port_setup if side == "port" else None,
                                   helpers, setup)
        except Exception as e:
            e.add_note(f"(in the {side} pass)")
            raise
    if compare == "multiset":
        assert sorted(map(repr, logs["port"])) == \
            sorted(map(repr, logs["ref"]))
    else:
        assert compare is None, compare
    return logs


def run_each(calls, tmp_path):
    """Run every call of `calls` through `run_twins`, each in its own
    directory under `tmp_path`, one after another, and fail naming every
    call that failed. A call is `(ref_name, case)`, `(ref_name, [cases])`
    or either with a dict of `run_twins` keywords last.

    The cluster's twins run this way, a file's cases as one test item:
    under `pytest -n` the load scheduler hands items out in chunks whose
    bounds move with the number of items, and a bound inside one of the
    reference's files whose cases share module state (test_http's
    schema) splits that file across workers."""
    failed = []
    for i, call in enumerate(calls):
        ref_name, cases, *kw = call
        cases = [cases] if isinstance(cases, str) else list(cases)
        where = Path(tmp_path) / f"c{i}"
        where.mkdir()
        try:
            run_twins(ref_name, cases, where, **(kw[0] if kw else {}))
        except Exception:  # noqa: BLE001 — reported below, all of them
            failed.append(f"{ref_name}::{'+'.join(cases)}:\n"
                          + traceback.format_exc(limit=-4)[-3000:])
    assert not failed, "\n".join(failed)


def reference_cases(ref_name, skip=()):
    """Every test of tests/<ref_name>.py, classes' methods as
    `Class::method`, parametrized ones as `name[id]`, in file order."""
    mod = importlib.import_module(f"tests.{ref_name}")
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            ids = list(_params(obj))
            out += [f"{name}[{i}]" for i in ids] if ids else [name]
        elif name.startswith("Test") and inspect.isclass(obj):
            out += [f"{name}::{m}" for m, f in vars(obj).items()
                    if m.startswith("test_") and inspect.isfunction(f)]
    return [n for n in out if n not in skip]

