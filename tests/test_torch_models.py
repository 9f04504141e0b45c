"""The port's host leaf layer (dgraph_tpu_torch.models, utils.keys,
failpoint, metrics, tracing and cluster.coordinator) against the
reference's copies of the same modules.

The schema, conversion and tokenizer inputs are the reference's own test
inputs (`tests/test_schema_types.py`, read by the AST scan of
`test_torch_gql.py`); the geo inputs are the geometries and query shapes
of `tests/test_geo.py`; the stemmer inputs are the words and sentences of
`tests/test_fulltext_lang.py`. Each goes through both packages, and the
results must be equal as structures or raise alike.
"""

import ast
import datetime
import json
import re

import numpy as np
import pytest
import torch

from dgraph_tpu.cluster import coordinator as jco
from dgraph_tpu.models import geo as jgeo
from dgraph_tpu.models import schema as jschema
from dgraph_tpu.models import stemmer as jstem
from dgraph_tpu.models import tokenizer as jtok
from dgraph_tpu.models import types as jtypes
from dgraph_tpu.utils import failpoint as jfp
from dgraph_tpu.utils import keys as jkeys
from dgraph_tpu.utils import metrics as jmet
from dgraph_tpu.utils import tracing as jtr
from dgraph_tpu_torch.cluster import coordinator as tco
from dgraph_tpu_torch.models import geo as tgeo
from dgraph_tpu_torch.models import schema as tschema
from dgraph_tpu_torch.models import stemmer as tstem
from dgraph_tpu_torch.models import tokenizer as ttok
from dgraph_tpu_torch.models import types as ttypes
from dgraph_tpu_torch.utils import failpoint as tfp
from dgraph_tpu_torch.utils import keys as tkeys
from dgraph_tpu_torch.utils import metrics as tmet
from dgraph_tpu_torch.utils import tracing as ttr
from tests.test_torch_gql import TESTS, calls_in, dual_eval, same_outcome


def namespace(schema, tok, types):
    return {"parse_schema": schema.parse_schema,
            "SchemaState": schema.SchemaState,
            "get_tokenizer": tok.get_tokenizer, "tokens_for": tok.tokens_for,
            "TypeID": types.TypeID, "Val": types.Val,
            "convert": types.convert, "sort_key": types.sort_key,
            "datetime": datetime}


REF_NS = namespace(jschema, jtok, jtypes)
PORT_NS = namespace(tschema, ttok, ttypes)
CALLS = calls_in("test_schema_types.py",
                 {"parse_schema", "convert", "sort_key", "tokens_for",
                  "get_tokenizer", "SchemaState"}, REF_NS)


def test_the_scan_finds_the_schema_inputs():
    assert len(CALLS) >= 20
    assert any("parse_schema" in c[1] for c in CALLS)
    assert any("convert" in c[1] for c in CALLS)
    assert any("tokens_for" in c[1] for c in CALLS)


@pytest.mark.parametrize("src,local", [c[1:] for c in CALLS],
                         ids=[c[0] for c in CALLS])
def test_schema_type_inputs_give_equal_results(src, local):
    dual_eval(src, local, REF_NS, PORT_NS)


SCHEMAS = [
    "name: string @index(exact) .\nfriend: [uid] @reverse .",
    "name: string @index(term, exact) @lang .\nage: int @index(int) .\n"
    "friend: [uid] @reverse @count .\ntype Person { name friend }",
    "emb: float32vector @index(hnsw(metric: \"cosine\")) .",
    "bio: string @index(fulltext) @lang @upsert .",
    "x: password .\ny: [string] @index(hash) .",
]


@pytest.mark.parametrize("text", SCHEMAS)
def test_schema_state(text):
    def run(schema):
        st = schema.SchemaState()
        st.apply_text(text)
        preds = sorted(st.predicates()) if hasattr(st, "predicates") else []
        names = {"name", "friend", "age", "emb", "bio", "x", "y",
                 "dgraph.type", "missing"}
        return preds, {p: (st.has(p), st.is_indexed(p), st.is_reversed(p),
                           st.is_list(p)) for p in sorted(names)}, \
            schema.parse_schema(text)
    same_outcome(lambda: run(jschema), lambda: run(tschema))


# -- types and tokenizers ------------------------------------------------------


def values(types):
    TID, Val = types.TypeID, types.Val
    dt = datetime.datetime(2020, 3, 14, 15, 9, 26)
    return [Val(TID.STRING, "42"), Val(TID.STRING, "Héllo, the World!"),
            Val(TID.STRING, "2006-01-02T15:04:05"), Val(TID.STRING, "true"),
            Val(TID.STRING, ""), Val(TID.STRING, "-7.25"),
            Val(TID.INT, 3), Val(TID.INT, -(1 << 40)), Val(TID.FLOAT, 2.7),
            Val(TID.FLOAT, -0.0), Val(TID.BOOL, True), Val(TID.DATETIME, dt),
            Val(TID.DEFAULT, "dflt"),
            Val(TID.GEO, {"type": "Point", "coordinates": [-122.4, 37.7]})]


TYPE_NAMES = [t.name for t in jtypes.TypeID]


@pytest.mark.parametrize("to", TYPE_NAMES)
def test_convert_every_value_to_every_type(to):
    """A password hash has a random salt: each is held by the other
    package's verify_password instead."""
    def run(types, other):
        out = []
        for v in values(types):
            try:
                got = types.convert(v, types.TypeID[to])
            except Exception as e:  # noqa: BLE001 - compared below
                out.append((type(e).__name__, str(e)))
                continue
            if to == "PASSWORD":
                plain = types.convert(v, types.TypeID.STRING).value
                got = (got.tid.name, other.verify_password(plain, got.value))
            out.append(got)
        return out
    same_outcome(lambda: run(jtypes, ttypes), lambda: run(ttypes, jtypes))


@pytest.mark.parametrize("fn", ["sort_key", "to_json_value",
                                "value_fingerprint"])
def test_value_functions(fn):
    def run(types):
        out = []
        for v in values(types):
            try:
                out.append(getattr(types, fn)(v))
            except Exception as e:  # noqa: BLE001 - compared below
                out.append((type(e).__name__, str(e)))
        return out
    same_outcome(lambda: run(jtypes), lambda: run(ttypes))


@pytest.mark.parametrize("raw", ["2006-01-02T15:04:05", "2006-01-02",
                                 "2006-01", "2006", "2006-01-02T15:04:05Z",
                                 "2006-01-02T15:04:05.123+02:00", "nope"])
def test_parse_datetime(raw):
    same_outcome(lambda: jtypes.parse_datetime(raw),
                 lambda: ttypes.parse_datetime(raw))


@pytest.mark.parametrize("raw", ["[1, 2.5, -3]", [0.5, 1.5], "[]", "[a]"])
def test_parse_vector(raw):
    same_outcome(lambda: jtypes.parse_vector(raw),
                 lambda: ttypes.parse_vector(raw))


def test_password_hashes_verify_across_packages():
    h = jtypes.hash_password("s3cret!")
    assert ttypes.verify_password("s3cret!", h)
    assert not ttypes.verify_password("wrong", h)
    assert jtypes.verify_password("s3cret!", ttypes.hash_password("s3cret!"))


TOKENIZERS = sorted(jtok._REGISTRY)


def test_same_tokenizers_registered():
    assert sorted(ttok._REGISTRY) == TOKENIZERS
    for name in TOKENIZERS:
        a, b = jtok.get_tokenizer(name), ttok.get_tokenizer(name)
        assert (a.name, a.ident, a.for_type.name, a.sortable, a.lossy) == \
            (b.name, b.ident, b.for_type.name, b.sortable, b.lossy)


@pytest.mark.parametrize("lang", ["", "en", "de", "fr"])
@pytest.mark.parametrize("name", TOKENIZERS)
def test_tokenizers_on_every_value(name, lang):
    def run(types, tok):
        out = []
        for v in values(types):
            try:
                out.append(tok.tokens_for(v, tok.get_tokenizer(name), lang))
            except Exception as e:  # noqa: BLE001 - compared below
                out.append((type(e).__name__, str(e)))
        return out
    same_outcome(lambda: run(jtypes, jtok), lambda: run(ttypes, ttok))


def test_custom_tokenizer_plugin(tmp_path):
    plug = tmp_path / "rev.py"
    plug.write_text(
        "class T:\n"
        "    name = 'rev'\n    for_type = 'string'\n    identifier = 0x91\n"
        "    def tokens(self, value):\n        return [str(value)[::-1]]\n"
        "def tokenizer():\n    return T()\n")

    def run(types, tok):
        spec = tok.load_custom_tokenizer(str(plug))
        return (spec.name, spec.ident, spec.sortable, spec.lossy,
                tok.tokens_for(types.Val(types.TypeID.STRING, "abc"), spec))
    try:
        same_outcome(lambda: run(jtypes, jtok), lambda: run(ttypes, ttok))
    finally:
        jtok._REGISTRY.pop("rev", None)
        ttok._REGISTRY.pop("rev", None)


# -- stemmers (tests/test_fulltext_lang.py's words) ----------------------------


def fulltext_words():
    tree = ast.parse((TESTS / "test_fulltext_lang.py").read_text())
    words = {n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and re.fullmatch(r"[^\W\d_]{1,24}", n.value)}
    return sorted(words)


WORDS = fulltext_words()
LANGS = sorted(jstem.STEMMERS) + ["", "xx", "de-DE", "pt_BR", "."]


def test_the_scan_finds_the_fulltext_words():
    assert len(WORDS) >= 40 and "irritant" in WORDS


@pytest.mark.parametrize("lang", LANGS)
def test_stemmers_on_the_fulltext_words(lang):
    def run(stem):
        return (stem.lang_base(lang), sorted(stem.stopwords(lang)),
                [stem.stem(w, lang) for w in WORDS],
                [stem.porter_en(w) for w in WORDS])
    same_outcome(lambda: run(jstem), lambda: run(tstem))


SENTENCES = [("the tales of burning empires", ""),
             ("die Geschichten der brennenden Reiche", "de"),
             ("les histoires des empires", "fr"),
             ("uma historia dos livros", "pt"),
             ("The runner was running races", "en")]


@pytest.mark.parametrize("text,lang", SENTENCES)
def test_fulltext_tokens(text, lang):
    same_outcome(
        lambda: jtok.fulltext_tokens(jtypes.Val(jtypes.TypeID.STRING, text),
                                     lang),
        lambda: ttok.fulltext_tokens(ttypes.Val(ttypes.TypeID.STRING, text),
                                     lang))


# -- geo (tests/test_geo.py's geometries and query shapes) ---------------------


def pt(lon, lat):
    return {"type": "Point", "coordinates": [lon, lat]}


def poly(*rings):
    return {"type": "Polygon", "coordinates": [list(r) for r in rings]}


def box(x0, y0, x1, y1):
    return [[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]


GEOMS = {
    "ferry": pt(-122.393, 37.795),
    "ggpark": poly(box(-122.51, 37.765, -122.45, 37.775)),
    "la": pt(-118.24, 34.05),
    "donut": poly(box(-121.0, 36.0, -120.0, 37.0),
                  box(-120.7, 36.3, -120.3, 36.7)),
    "museum": pt(2.337, 48.861),
    "origin": pt(0, 0),
    "multi": {"type": "MultiPolygon",
              "coordinates": [[box(0, 0, 1, 1)], [box(5, 5, 6, 6)]]},
}
QUERY_SHAPES = {
    "sf": poly(box(-122.6, 37.7, -122.3, 37.9)),
    "straddle": poly(box(-122.48, 37.7, -122.3, 37.9)),
    "edge": poly(box(-122.46, 37.768, -122.40, 37.772)),
}
POINTS = [(-122.39, 37.79), (-122.48, 37.77), (-120.1, 36.1),
          (-120.5, 36.5), (-118.24, 34.05), (2.34, 48.86), (0, 0)]


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_geo_on_a_geometry(name):
    g = GEOMS[name]

    def run(geo):
        parsed = geo.parse_geom(json.dumps(g))
        out = [parsed, geo.cover_tokens(parsed)]
        for p in POINTS:
            out += [geo.geom_contains_point(parsed, p),
                    geo.min_distance_m(parsed, p)]
        for q in QUERY_SHAPES.values():
            out += [geo.geom_within(parsed, q), geo.geom_intersects(parsed, q)]
        return out
    same_outcome(lambda: run(jgeo), lambda: run(tgeo))


@pytest.mark.parametrize("radius", [10, 1000, 2000, 5000, 20000])
def test_geo_near_query_tokens(radius):
    def run(geo):
        return [(geo.expand_bbox_m(p, radius),
                 geo.query_tokens(geo.expand_bbox_m(p, radius)),
                 [geo.haversine_m(p, q) for q in POINTS]) for p in POINTS]
    same_outcome(lambda: run(jgeo), lambda: run(tgeo))


@pytest.mark.parametrize("raw", ['{"type": "Point"}', "not json",
                                 '{"type": "Line", "coordinates": []}',
                                 {"type": "Point", "coordinates": [1, 2]}])
def test_geo_parse_errors(raw):
    same_outcome(lambda: jgeo.parse_geom(raw), lambda: tgeo.parse_geom(raw))


# -- utils ---------------------------------------------------------------------


KEYS = [("data_key", ("name", 0x1234)), ("reverse_key", ("friend", 7)),
        ("index_key", ("name", b"\x01alice")),
        ("count_key", ("friend", 3)), ("count_key", ("friend", 3, True)),
        ("schema_key", ("age",)), ("type_key", ("Person",))]


@pytest.mark.parametrize("fn,args", KEYS)
def test_keys_pack_and_unpack(fn, args):
    def run(keys):
        k = getattr(keys, fn)(*args)
        raw = k.pack()
        return raw, keys.unpack(raw), repr(k)
    want = same_outcome(lambda: run(jkeys), lambda: run(tkeys))
    assert want[0] == "ok"


@pytest.mark.parametrize("token", [0, -5, 1 << 40, b"ab", "héllo"])
def test_keys_token_bytes(token):
    assert tkeys.token_bytes(0x02, token) == jkeys.token_bytes(0x02, token)


def test_metrics_counter_get_counter_and_render():
    """The same updates through both registries render the same
    exposition lines; `counter` is `get_counter` without labels.

    The registries are process-global and other tests' queries write to
    them, so the test compares only series it alone writes: a counter
    name no code path increments, and a `case` label on every series,
    which the exposition filter matches exactly."""
    name = "torch_models_metrics_case_total"
    case = {"case": "torch_models"}
    lab = {"tier": 'dev"ice\n', **case}
    before = (jmet.get_counter(name), tmet.get_counter(name))
    for m in (jmet, tmet):
        m.inc_counter(name)
        m.inc_counter(name, 2.5)
        m.inc_counter(name, 1, labels=lab)
        m.set_gauge("device_cache_bytes", 123.0, labels={"g": "1", **case})
        m.observe("dgraph_query_latency_ms", 3.0, labels={"t": "x", **case})
        m.observe("dgraph_wal_fsync_seconds", 0.0003,
                  labels={"t": "x", **case})
    assert tmet.get_counter(name) - before[1] == \
        jmet.get_counter(name) - before[0] == 3.5
    assert tmet.counter(name) == tmet.get_counter(name)
    assert tmet.get_counter(name, labels=lab) == \
        jmet.get_counter(name, labels=lab)
    assert tmet.counter("never_counted_here") == 0
    assert tmet.REGISTERED == jmet.REGISTERED

    def lines(m):
        keep = 'case="torch_models"'
        return sorted(ln for ln in m.render_prometheus().splitlines()
                      if keep in ln)
    assert any('tier="dev\\"ice\\n"' in ln for ln in lines(tmet))
    assert lines(tmet) == lines(jmet) and len(lines(tmet)) > 10


def test_profile_device_writes_a_trace_on_the_cpu(tmp_path):
    with ttr.profile_device(str(tmp_path / "prof")):
        x = torch.arange(1000, dtype=torch.float32)
        (x * 2).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::mul" in n for n in names)


def test_tracing_spans_and_traceparent():
    def run(tr):
        tr.clear()
        with tr.bind("ab" * 16, "cd" * 8):
            with tr.span("outer", k=1) as outer:
                with tr.span("inner"):
                    pass
        spans = tr.spans_for("ab" * 16)
        shape = sorted((s["name"], s["parent"] == outer["span_id"],
                        s["trace_id"]) for s in spans)
        return (shape, tr.format_traceparent("ab" * 16, "cd" * 8),
                tr.parse_traceparent(tr.format_traceparent("ab" * 16,
                                                           "cd" * 8)),
                tr.parse_traceparent("junk"),
                len(tr.export_chrome_trace("ab" * 16)))
    same_outcome(lambda: run(jtr), lambda: run(ttr))


def test_failpoint_registry_and_actions():
    assert tfp.SITES == jfp.SITES and tfp.ENV_VAR == jfp.ENV_VAR

    def run(fp):
        out = []
        try:
            fp.arm("port.test", "2*error(boom)")
            for _ in range(3):
                try:
                    fp.fire("port.test")
                    out.append("pass")
                except fp.FailpointError as e:
                    out.append(str(e))
            out += [fp.hits("port.test"), fp.armed()]
            for bad in ("explode", "3*sleep(x)"):
                try:
                    fp.arm("port.bad", bad)
                except ValueError as e:
                    out.append(str(e))
        finally:
            fp.clear()
        return out
    same_outcome(lambda: run(jfp), lambda: run(tfp))


def coordinator_script(co):
    c = co.Coordinator()
    out = [c.next_ts(), c.assign_uids(5), c.assign_uids(1)]
    c.bump_uids(100)
    out.append(c.assign_uids(2))
    a, b = c.begin(), c.begin()
    out += [a.start_ts, b.start_ts, c.commit(a, {1, 2})]
    try:
        c.commit(b, {2, 3})
    except co.TxnAborted as e:
        out.append(("aborted", str(e)))
    d = c.begin()
    out += [c.commit(d, {2}), c.min_active_ts(), c.max_assigned()]
    e = c.begin()
    c.abort(e)
    try:
        c.commit(e, {9})
    except co.TxnAborted as err:
        out.append(("aborted", str(err)))
    try:
        c.begin_at(10_000)
    except ValueError as err:
        out.append(str(err))
    out.append(c.should_serve("name"))
    return out


def test_coordinator_runs_the_same_script():
    same_outcome(lambda: coordinator_script(jco),
                 lambda: coordinator_script(tco))


def test_package_exports():
    import dgraph_tpu.cluster as jcl
    import dgraph_tpu_torch.cluster as tcl
    assert tcl.Coordinator is tco.Coordinator and tcl.TxnAborted is \
        tco.TxnAborted
    assert jcl.Coordinator is jco.Coordinator
    assert np.isclose(tgeo.EARTH_R_M, jgeo.EARTH_R_M)
