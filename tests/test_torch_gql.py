"""The port's GraphQL± front end (dgraph_tpu_torch.gql: lexer, AST,
parser, RDF and JSON mutations) against the reference (dgraph_tpu.gql).

The inputs are the reference's own test inputs, read from its test files
by an AST scan: every call of a front-end function there whose arguments
are literals (or locals bound once to literals) is evaluated through both
packages, and the results must be equal as structures (dataclasses field
by field, enums by name and value) or raise the same error with the same
message. Query texts that the reference's geo and fulltext tests send to
GraphDB are parsed through both parsers the same way.
"""

import ast
import dataclasses
import datetime
import enum
import re
from pathlib import Path

import numpy as np
import pytest

import dgraph_tpu.gql as jgql
import dgraph_tpu_torch.gql as tgql
from dgraph_tpu.gql import lexer as jlex
from dgraph_tpu.gql import nquad as jnq
from dgraph_tpu.models import types as jtypes
from dgraph_tpu_torch.gql import lexer as tlex
from dgraph_tpu_torch.gql import nquad as tnq
from dgraph_tpu_torch.models import types as ttypes

TESTS = Path(__file__).resolve().parent


def norm(x):
    """A structure of plain values: dataclasses by class name and fields,
    enums by class name and value, containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, dict):
        return {"dict": sorted(((norm(k), norm(v)) for k, v in x.items()),
                               key=repr)}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((norm(v) for v in x), key=repr)))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    if isinstance(x, (str, bytes, int, float, bool, type(None),
                      datetime.datetime, datetime.date)):
        return x
    if callable(x):
        return ("callable", getattr(x, "__name__", type(x).__name__))
    if hasattr(x, "__dict__"):
        return (type(x).__name__, norm(vars(x)))
    return re.sub(r"dgraph_tpu(_torch)?\.", "", repr(x))


def outcome(fn):
    """('ok', normalised result) or ('raise', class name, message)."""
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 - both sides must raise alike
        return ("raise", type(e).__name__, str(e))


def same_outcome(run_ref, run_port):
    want, got = outcome(run_ref), outcome(run_port)
    assert got == want
    return want


def _literal_locals(fn_node):
    """Names a test function binds exactly once, to a literal."""
    seen, lits = {}, {}
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    seen[t.id] = seen.get(t.id, 0) + 1
                    try:
                        lits[t.id] = ast.literal_eval(node.value)
                    except ValueError:
                        lits.pop(t.id, None)
    return {k: v for k, v in lits.items() if seen[k] == 1}


def calls_in(filename, targets, names):
    """(id, source, locals) of each outermost call in tests/`filename` of
    a function in `targets` whose free names are all in `names` or are
    literal locals of its test function."""
    path = TESTS / filename
    text = path.read_text()
    tree = ast.parse(text)
    out = []

    def visit(node, local):
        if isinstance(node, ast.FunctionDef):
            local = _literal_locals(node)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in targets:
            free = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
            if free <= set(names) | set(local):
                out.append((f"{filename}:{node.lineno}:{node.col_offset}",
                            ast.get_source_segment(text, node),
                            {k: local[k] for k in free & set(local)}))
                return
        for child in ast.iter_child_nodes(node):
            visit(child, local)

    visit(tree, {})
    return out


def dual_eval(src, local, ref_ns, port_ns):
    code = compile(src, "<test input>", "eval")
    want = same_outcome(lambda: eval(code, dict(ref_ns, **local)),
                        lambda: eval(code, dict(port_ns, **local)))
    # an input the scan could not bind is not a comparison
    assert want[:2] not in (("raise", "NameError"), ("raise", "TypeError"))
    return want


REF_NS = {"parse": jgql.parse, "parse_rdf": jgql.parse_rdf,
          "parse_json_mutation": jgql.parse_json_mutation,
          "GQLError": jgql.GQLError, "TypeID": jtypes.TypeID}
PORT_NS = {"parse": tgql.parse, "parse_rdf": tgql.parse_rdf,
           "parse_json_mutation": tgql.parse_json_mutation,
           "GQLError": tgql.GQLError, "TypeID": ttypes.TypeID}

CALLS = calls_in("test_gql_parser.py", {"parse"}, REF_NS) + \
    calls_in("test_nquad.py", {"parse_rdf", "parse_json_mutation"}, REF_NS)


def test_the_scan_finds_the_reference_inputs():
    parser = [c for c in CALLS if c[0].startswith("test_gql_parser")]
    nquad = [c for c in CALLS if c[0].startswith("test_nquad")]
    assert len(parser) >= 60 and len(nquad) >= 9
    # inputs through locals bound to literals are found too
    assert any(c[2] for c in parser)


@pytest.mark.parametrize("src,local", [c[1:] for c in CALLS],
                         ids=[c[0] for c in CALLS])
def test_reference_inputs_give_equal_results(src, local):
    dual_eval(src, local, REF_NS, PORT_NS)


def query_texts(filename):
    """String constants the reference's engine tests send as queries."""
    tree = ast.parse((TESTS / filename).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("query", "_names", "_uids"):
                for a in node.args:
                    if isinstance(a, ast.Constant) and \
                            isinstance(a.value, str) and "{" in a.value:
                        out.append((f"{filename}:{node.lineno}", a.value))
    return out


QUERIES = query_texts("test_geo.py") + query_texts("test_fulltext_lang.py")


@pytest.mark.parametrize("text", [q[1] for q in QUERIES],
                         ids=[q[0] for q in QUERIES])
def test_engine_test_queries_parse_equal(text):
    same_outcome(lambda: jgql.parse(text), lambda: tgql.parse(text))


RDF = ['<1> <bio> "the tales of burning empires" .\n'
       '<2> <bio> "die Geschichten der brennenden Reiche"@de .',
       '<9> <noidx> "{\\"type\\":\\"Point\\",\\"coordinates\\":[0,0]}"'
       '^^<geo:geojson> .',
       '<1> <when> "2006-01-02T15:04:05"^^<xs:dateTime> .\n'
       '<1> <f> "2.5"^^<xs:float> . <1> <b> "true"^^<xs:boolean> .',
       '<1> <v> "[1.0, 2.0, 3.5]"^^<float32vector> .',
       '_:a <p> _:b (w=1.5, t=2020-01-01T00:00:00, s="x") .',
       '<1> <name> "a"', '<1> <name> "a" . junk', '<1> <name> .',
       '<0x1> * * .', 'uid(v) <name> "x" .']


@pytest.mark.parametrize("text", RDF)
def test_rdf_more_inputs(text):
    same_outcome(lambda: jgql.parse_rdf(text), lambda: tgql.parse_rdf(text))


JSON = [{"uid": "0x1", "loc": {"type": "Point", "coordinates": [2.3, 48.8]}},
        [{"name": "a", "tags": ["x", "y"]}, {"uid": "_:n", "n": 1.5}],
        {"uid": "0x1", "friend": [{"uid": "0x2", "friend|w": 2}]},
        {"name": "x", "age": "notanint", "ok": False},
        "not a mutation"]


@pytest.mark.parametrize("delete", [False, True])
@pytest.mark.parametrize("i", range(len(JSON)))
def test_json_more_inputs(i, delete):
    same_outcome(lambda: jgql.parse_json_mutation(JSON[i], delete=delete),
                 lambda: tgql.parse_json_mutation(JSON[i], delete=delete))


@pytest.mark.parametrize("i", range(len(RDF) - 4))
def test_nquad_wire_round_trip(i):
    def run(nq):
        quads = nq.parse_rdf(RDF[i])
        wire = [nq.nquad_to_wire(q) for q in quads]
        return wire, [nq.nquad_from_wire(w) for w in wire]
    same_outcome(lambda: run(jnq), lambda: run(tnq))


@pytest.mark.parametrize("text", ['{ q(func: eq(name, "x")) { name } }',
                                  'query a($x: int = 3) { q(func: uid(0x1)) '
                                  '{ n: count(friend) } }', '{ q(func: ',
                                  '"unterminated', "@filter(a) # c\n x"])
def test_lexer_tokens(text):
    same_outcome(lambda: jlex.tokenize(text), lambda: tlex.tokenize(text))
