"""The port's query path (dgraph_tpu_torch.query, GraphDB.query and
query_json, upserts and @if conditions) against the reference's, on the
CPU, through the reference's own tests.

Each case runs one test function of a reference test file with the
names that file imports from `dgraph_tpu` rebound to twins: a twin
holds the reference object and the port's counterpart, forwards every
call to both (`GraphDB(...)` becomes `GraphDB(..., device="cpu")` on
the port's side), and compares what the two return, or that both raise
the same error. Plain results (dicts, lists, strings, numbers, arrays)
must be equal after dropping wall times (`latency`, `server_latency`,
EXPLAIN's `durUs`, `compile_us`) and EXPLAIN's `tierDecisions`, which
follow measured costs;
the reference's value then goes back to the test, whose own assertions
run unchanged. Process-global statistics read by the tests (`metrics`,
`jit_stage_stats`) are the port's, so the assertions on counters and
on the executable registry hold the port to them: device counters
(`query_device_expand_total`, `query_device_sssp_total` and the rest)
must move where the reference's test asserts they move.

The files: `tests/test_fusion.py` (EXPLAIN's fusion tier and fallback
reasons, the zero-new-executable check on a parameter-only change),
`test_device_routing.py`, `test_upsert.py` and `test_shortest.py`;
then the 75 golden queries' `query_json` bytes. The port has no native
build and always takes the reference's branch for a build without it;
where the reference has its native build, its columnar JSON emitter
gives the same bytes as the port's general one on every golden query,
so neither side is patched.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import inspect
import json

import numpy as np
import pytest
import torch

from dgraph_tpu.engine.db import GraphDB as JGraphDB
from dgraph_tpu_torch.query import plan as tplan
from dgraph_tpu_torch.utils import metrics as tmetrics
from tests.golden import runner

# keys whose values are wall times, measured costs or per-run ids:
# dropped before a comparison (everything else must be equal)
TIMING_KEYS = frozenset((
    "latency", "server_latency", "compile_us", "durUs", "costUs",
    "encode_us", "parse_us", "process_us", "ageS", "age_s", "traceId",
    "max_trace", "freshestAgeS",
    # the adaptive planner's per-stage choices, and the counter deltas
    # they move: they follow measured costs, which differ between the
    # packages (test_torch_query_modules holds the decisions equal on
    # equal coststore contents)
    "tierDecisions", "counters", "stages",
    # debug_stats' process-global cost table and its summary (every
    # test in the process writes to them)
    "cost", "costStore",
    # plan memo entries: the reference memoizes one more per block,
    # the spec of its native columnar JSON emitter, which the port
    # does not have
    "memoEntries",
))

# names a reference test reads process-global state through (counters,
# the stage executable registry): the twin gives the test the port's,
# so its assertions hold the port
PORT_ONLY = {"metrics": tmetrics,
             "jit_stage": tplan.jit_stage,
             "jit_stage_stats": tplan.jit_stage_stats}


def _port_module_name(name: str) -> str:
    return "dgraph_tpu_torch" + name[len("dgraph_tpu"):]


def _is_reference(obj) -> bool:
    mod = getattr(obj, "__module__", None) or ""
    if inspect.ismodule(obj):
        mod = obj.__name__
    return mod == "dgraph_tpu" or mod.startswith("dgraph_tpu.")


def _counterpart(obj):
    """The port's object of the same module path and name."""
    if inspect.ismodule(obj):
        return importlib.import_module(_port_module_name(obj.__name__))
    mod = importlib.import_module(_port_module_name(obj.__module__))
    return getattr(mod, obj.__qualname__)


def _canon(x, strip=True):
    """A comparable form: package-neutral (class names, not classes),
    wall times dropped, arrays by dtype, shape and bytes."""
    if isinstance(x, Twin):
        return _canon(x._r, strip)
    if isinstance(x, dict):
        return {"dict": sorted(
            ((repr(_canon(k, strip)), _canon(v, strip))
             for k, v in x.items()
             if not (strip and isinstance(k, str) and k in TIMING_KEYS)),
            key=lambda kv: kv[0])}
    if isinstance(x, (list, tuple)):
        return [type(x).__name__, [_canon(v, strip) for v in x]]
    if isinstance(x, (set, frozenset)):
        return ["set", sorted(repr(_canon(v, strip)) for v in x)]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return ["nd", x.dtype.str, x.shape, x.tobytes()]
    if isinstance(x, np.generic):
        return ["np", x.dtype.str, x.item()]
    if isinstance(x, enum.Enum):
        return ["enum", type(x).__name__, x.name]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ["dc", type(x).__name__,
                {f.name: _canon(getattr(x, f.name), strip)
                 for f in dataclasses.fields(x)}]
    if isinstance(x, float) and x != x:
        return ["nan"]
    return x


def _plain(x) -> bool:
    """Data the twin compares and hands back, rather than wraps."""
    if x is None or isinstance(x, (bool, int, float, str, bytes,
                                   np.generic, np.ndarray, enum.Enum)):
        return True
    if isinstance(x, (list, tuple, set, frozenset)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(_plain(k) and _plain(v) for k, v in x.items())
    return False


def _port_arg(x):
    """An argument as the port's side of a call receives it."""
    if isinstance(x, Twin):
        return x._p
    if isinstance(x, (list, tuple)):
        return type(x)(_port_arg(v) for v in x)
    if isinstance(x, dict):
        return {k: _port_arg(v) for k, v in x.items()}
    if isinstance(x, enum.Enum) and _is_reference(type(x)):
        return _counterpart(type(x))[x.name]
    if dataclasses.is_dataclass(x) and not isinstance(x, type) \
            and _is_reference(type(x)):
        cls = _counterpart(type(x))
        return cls(**{f.name: _port_arg(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    return x


def _ref_arg(x):
    if isinstance(x, Twin):
        return x._r
    if isinstance(x, (list, tuple)):
        return type(x)(_ref_arg(v) for v in x)
    if isinstance(x, dict):
        return {k: _ref_arg(v) for k, v in x.items()}
    return x


def _same(r, p, what):
    if isinstance(r, str) and isinstance(p, str) and r[:1] == "{":
        try:
            r, p = json.loads(r), json.loads(p)
        except ValueError:
            pass
    cr, cp = _canon(r), _canon(p)
    assert cr == cp, (
        f"{what}: the port differs from the reference at "
        f"{_first_difference(cr, cp)}")


def _first_difference(a, b, path="") -> str:
    if isinstance(a, dict) and isinstance(b, dict):
        a, b = dict(a.get("dict", [])), dict(b.get("dict", []))
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                return _first_difference(a.get(k), b.get(k), f"{path}/{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return f"{path}: reference {str(a)[:800]} port {str(b)[:800]}"


# one twin per (reference, port) pair, so identity checks against a
# module's singletons (`q is ALL`) hold; cleared after every case
_TWINS: dict = {}


def _wrap(r, p, what):
    if _plain(r):
        _same(r, p, what)
        return r
    key = (id(r), id(p))
    if key not in _TWINS:
        _TWINS[key] = Twin(r, p, what)
    return _TWINS[key]


class Twin:
    """A reference object and its port counterpart, driven together."""

    __slots__ = ("_r", "_p", "_what")

    def __init__(self, ref, port, what=""):
        object.__setattr__(self, "_r", ref)
        object.__setattr__(self, "_p", port)
        object.__setattr__(self, "_what", what or repr(ref)[:60])

    @property
    def __class__(self):  # isinstance() sees the reference's class
        return type(self._r)

    def __instancecheck__(self, inst):  # a twinned class
        return isinstance(_ref_arg(inst), self._r)

    def __subclasscheck__(self, cls):
        return issubclass(cls, self._r)

    def __getattr__(self, name):
        what = f"{self._what}.{name}"
        r = getattr(self._r, name)
        if name.startswith("__"):
            # vars() and the like, from reference code handed a twin
            return r
        if name in PORT_ONLY and inspect.ismodule(self._r):
            return PORT_ONLY[name]
        return _wrap(r, getattr(self._p, name), what)

    def __setattr__(self, name, value):
        setattr(self._r, name, _ref_arg(value))
        setattr(self._p, name, _port_arg(value))

    def __call__(self, *args, **kw):
        what = f"{self._what}(...)"
        pkw = {k: _port_arg(v) for k, v in kw.items()}
        if self._r is JGraphDB:
            pkw["device"] = "cpu"
        r_err = p_err = None
        try:
            r = self._r(*_ref_arg(args), **_ref_arg(kw))
        except Exception as e:  # noqa: BLE001 (compared below)
            r_err = e
        try:
            p = self._p(*_port_arg(args), **pkw)
        except Exception as e:  # noqa: BLE001 (compared below)
            p_err = e
        if r_err is not None or p_err is not None:
            assert type(r_err).__name__ == type(p_err).__name__, (
                f"{what}: reference raised {r_err!r}, port {p_err!r}")
            assert str(r_err) == str(p_err), (what, r_err, p_err)
            raise r_err
        return _wrap(r, p, what)

    def __getitem__(self, key):
        return _wrap(self._r[_ref_arg(key)], self._p[_port_arg(key)],
                     f"{self._what}[{key!r}]")

    def __len__(self):
        n = len(self._r)
        assert n == len(self._p), self._what
        return n

    def __iter__(self):
        rs, ps = list(self._r), list(self._p)
        assert len(rs) == len(ps), self._what
        return iter([_wrap(r, p, f"{self._what}[]")
                     for r, p in zip(rs, ps)])

    def __contains__(self, x):
        got = _ref_arg(x) in self._r
        assert got == (_port_arg(x) in self._p), self._what
        return got

    def __eq__(self, other):
        got = self._r == _ref_arg(other)
        assert got == (self._p == _port_arg(other)), self._what
        return got

    def __bool__(self):
        got = bool(self._r)
        assert got == bool(self._p), self._what
        return got

    def __array__(self, dtype=None, copy=None):
        r = np.asarray(self._r, dtype=dtype)
        _same(r, np.asarray(self._p, dtype=dtype), self._what)
        return r

    __hash__ = None


def _reference_modules():
    import sys
    return [m for k, m in list(sys.modules.items())
            if m is not None and (k == "dgraph_tpu"
                                  or k.startswith("dgraph_tpu."))]


def twin_module(monkeypatch, ref_mod):
    """Rebind every name `ref_mod` imported from `dgraph_tpu` to a twin
    (or, for PORT_ONLY names, to the port's)."""
    for name, obj in list(vars(ref_mod).items()):
        if name in PORT_ONLY:
            monkeypatch.setattr(ref_mod, name, PORT_ONLY[name])
        elif inspect.isclass(obj) and issubclass(obj, BaseException):
            pass  # a twin raises the reference's error (and checks both)
        elif _is_reference(obj) and (inspect.ismodule(obj)
                                     or inspect.isclass(obj)
                                     or callable(obj)):
            monkeypatch.setattr(ref_mod, name,
                                Twin(obj, _counterpart(obj), name))
        elif _is_reference(type(obj)) and not _plain(obj):
            # a module's singleton (retrigram's ALL and NONE)
            src = next(m for m in _reference_modules()
                       if vars(m).get(name) is obj)
            port = getattr(_counterpart(src), name)
            monkeypatch.setattr(ref_mod, name, _wrap(obj, port, name))


# -- running reference test functions -----------------------------------

_MODULE_FIXTURES: dict = {}


def _fixture_value(ref_mod, name, request, monkeypatch, cleanups):
    if name == "monkeypatch":
        return monkeypatch
    if name == "tmp_path":
        return request.getfixturevalue("tmp_path")
    fx = getattr(ref_mod, name)
    fn = fx._get_wrapped_function()
    scope = fx._fixture_function_marker.scope
    key = (ref_mod.__name__, name)
    if scope == "module" and key in _MODULE_FIXTURES:
        return _MODULE_FIXTURES[key]
    args = {p: _fixture_value(ref_mod, p, request, monkeypatch, cleanups)
            for p in inspect.signature(fn).parameters}
    got = fn(**args)
    if inspect.isgenerator(got):
        gen = got
        got = next(gen)
        cleanups.append(lambda: next(gen, None))
    if scope == "module":
        _MODULE_FIXTURES[key] = got
    return got


def run_reference_case(ref_name, test_name, request, monkeypatch,
                       params=None):
    """Run reference test `test_name` ("fn" or "Class.fn", with its
    parametrized arguments `params`) of module `tests.<ref_name>` with
    its dgraph_tpu names twinned; a module that reads the golden
    runner's engine gets a twin of both packages' golden engines."""
    ref_mod = importlib.import_module(f"tests.{ref_name}")
    twin_module(monkeypatch, ref_mod)
    if getattr(ref_mod, "runner", None) is runner:
        monkeypatch.setattr(runner, "get_db", twin_golden_db)
    if "." in test_name:
        cls_name, fn_name = test_name.split(".")
        fn = getattr(getattr(ref_mod, cls_name)(), fn_name)
    else:
        fn = getattr(ref_mod, test_name)
    params = dict(params or {})
    cleanups: list = []
    try:
        args = {p: params[p] if p in params else
                _fixture_value(ref_mod, p, request, monkeypatch, cleanups)
                for p in inspect.signature(fn).parameters}
        fn(**args)
    finally:
        for c in reversed(cleanups):
            c()
        _TWINS.clear()


def reference_tests(ref_name, skip=()):
    """The test functions of reference module `tests.<ref_name>`, in
    file order, as ("fn" or "Class.fn", parametrized arguments), one
    entry per parameter set."""
    ref_mod = importlib.import_module(f"tests.{ref_name}")
    names = []
    for name, obj in vars(ref_mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            names.append((name, obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            names += [(f"{name}.{m}", f) for m, f in vars(obj).items()
                      if m.startswith("test_")]
    out = []
    for name, fn in names:
        if name in skip:
            continue
        sets = [{}]
        for mark in getattr(fn, "pytestmark", ()):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            keys = [k.strip() for k in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            rows = [dict(zip(keys, v if len(keys) > 1 else (v,)))
                    for v in values]
            sets = [{**a, **b} for a in sets for b in rows]
        out += [(name, ps) for ps in sets]
    return out


def case_id(ref_name, test_name, params):
    return f"{ref_name}::{test_name}" + "".join(
        f"[{v}]" for v in params.values())


CASES = [(mod, name, ps)
         for mod in ("test_fusion", "test_device_routing", "test_upsert",
                     "test_shortest")
         for name, ps in reference_tests(mod)]


@pytest.mark.parametrize("ref_name,test_name,params", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_reference_case_through_both(ref_name, test_name, params, request,
                                     monkeypatch):
    run_reference_case(ref_name, test_name, request, monkeypatch, params)


def test_the_reference_files_hold_their_cases():
    assert [len(reference_tests(m)) for m in
            ("test_fusion", "test_device_routing", "test_upsert",
             "test_shortest")] == [6, 5, 14, 11]


# -- query_json bytes over the golden workload ---------------------------

_PORT_GOLDEN: dict = {}


def port_golden_db():
    """The golden movie graph at scale 1 in the port's GraphDB at the
    reference runner's settings (tests/golden/runner.py get_db)."""
    if "db" not in _PORT_GOLDEN:
        from dgraph_tpu_torch.engine.db import GraphDB

        from tests.golden.dataset import generate

        schema, quads = generate()
        db = GraphDB(device_min_edges=1, device="cpu")
        db.alter(schema_text=schema)
        db.mutate(set_nquads="\n".join(quads))
        _PORT_GOLDEN["db"] = db
    return _PORT_GOLDEN["db"]


def golden_text(name: str) -> str:
    with open(f"{runner.QUERY_DIR}/{name}.gql") as f:
        return f.read()


def _data_bytes(body: str) -> str:
    """The `data` member of a query_json body, as the bytes it holds."""
    assert body.startswith('{"data":')
    end = body.rindex(',"extensions":')
    return body[len('{"data":'):end]


def twin_golden_db():
    """A reference and a port golden engine, both fresh, driven as one
    twin (the reference runner's singleton may already hold plans and
    counters from other tests)."""
    if "twin" not in _PORT_GOLDEN:
        from tests.golden.dataset import generate

        schema, quads = generate()
        db = Twin(JGraphDB, _counterpart(JGraphDB), "GraphDB")(
            device_min_edges=1)
        db.alter(schema_text=schema)
        db.mutate(set_nquads="\n".join(quads))
        _PORT_GOLDEN["twin"] = db
    return _PORT_GOLDEN["twin"]


@pytest.mark.parametrize("name", runner.query_names())
def test_golden_query_json_bytes_equal(name):
    q = golden_text(name)
    want = _data_bytes(runner.get_db().query_json(q))
    got = _data_bytes(port_golden_db().query_json(q))
    assert got == want
    assert json.loads(got) == port_golden_db().query(q)["data"]
