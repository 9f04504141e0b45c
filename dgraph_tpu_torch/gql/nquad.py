"""Mutation input parsing: RDF N-Quads and JSON.

Re-provides the reference's chunker package behavior (chunker/rdf_parser.go:58
ParseRDFs, chunker/json_parser.go) — triples with optional facets, language
tags, type hints (`"3"^^<xs:int>`), blank nodes, star deletion — as a fresh
regex/recursive parser.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any

from dgraph_tpu_torch.gql.lexer import GQLError
from dgraph_tpu_torch.models.types import TypeID, Val


@dataclass
class NQuad:
    """One parsed triple. Ref pb.NQuad / api.NQuad."""

    subject: str              # uid literal "0x1", blank "_:x", xid, or "uid(v)"
    predicate: str
    object_id: str = ""       # set for uid objects (may be "uid(v)")
    object_value: Val | None = None
    lang: str = ""
    facets: dict[str, Val] = field(default_factory=dict)
    star: bool = False        # object was *  (delete-all)
    val_var: str = ""         # object was val(v) — upsert value substitution


_XS_TYPES = {
    "xs:int": TypeID.INT, "xs:integer": TypeID.INT,
    "xs:positiveInteger": TypeID.INT,
    "xs:float": TypeID.FLOAT, "xs:double": TypeID.FLOAT,
    "xs:boolean": TypeID.BOOL, "xs:bool": TypeID.BOOL,
    "xs:dateTime": TypeID.DATETIME, "xs:date": TypeID.DATETIME,
    "xs:string": TypeID.STRING,
    "geo:geojson": TypeID.GEO,
    "xs:password": TypeID.PASSWORD,
    "xs:base64Binary": TypeID.BINARY,
    # modern Dgraph's vfloat literal: "[0.1, 0.2]"^^<xs:float32vector>
    "xs:float32vector": TypeID.FLOAT32VECTOR,
    "float32vector": TypeID.FLOAT32VECTOR,
}


def _coerce(raw: str, tid: TypeID) -> Val:
    if tid == TypeID.INT:
        return Val(tid, int(raw))
    if tid == TypeID.FLOAT:
        return Val(tid, float(raw))
    if tid == TypeID.BOOL:
        return Val(tid, raw.lower() == "true")
    if tid == TypeID.DATETIME:
        from dgraph_tpu_torch.models.types import parse_datetime

        return Val(tid, parse_datetime(raw))
    if tid == TypeID.GEO:
        return Val(tid, json.loads(raw))
    if tid == TypeID.BINARY:
        import base64

        return Val(tid, base64.b64decode(raw))
    if tid == TypeID.FLOAT32VECTOR:
        from dgraph_tpu_torch.models.types import parse_vector

        return Val(tid, parse_vector(raw))
    return Val(tid, raw)


_TERM = re.compile(
    r"""\s*(?:
      (?P<iri><[^>]*>)
    | (?P<blank>_:[\w.\-]+)
    | (?P<star>\*)
    | (?P<literal>"(?:\\.|[^"\\])*")
        (?:@(?P<lang>[\w\-]+)|\^\^<(?P<dtype>[^>]+)>)?
    | (?P<func>(?:uid|val)\(\s*[\w.\-]+\s*\))
    | (?P<word>[\w.\-~/]+)
    )""",
    re.VERBOSE,
)

_UNESC = re.compile(r"\\(.)")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "'": "'"}


def _unescape(s: str) -> str:
    return _UNESC.sub(lambda m: _ESCAPES.get(m.group(1), m.group(1)), s)


# Fast path: one regex for the overwhelmingly common one-statement-
# per-line shapes (`<s> <p> <o> .`, `<s> <p> "lit"[@lang|^^<dt>] .`,
# blank nodes either side) — one match() instead of three cursor steps
# with per-group dispatch. Anything else (facets, uid()/val() terms,
# graph labels, multiple statements per line, `*`) falls back to the
# full grammar below. Bulk-load profiles are parse-bound without this.
_FAST = re.compile(
    r'(?:<(?P<si>[^>]*)>|(?P<sb>_:[\w.\-]+))'
    r'\s+(?:<(?P<pi>[^>]+)>|(?P<pw>[\w.\-~/]+))'
    r'\s+(?:<(?P<oi>[^>]*)>|(?P<ob>_:[\w.\-]+)|'
    r'"(?P<lit>(?:\\.|[^"\\])*)"'
    r'(?:@(?P<lang>[\w\-]+)|\^\^<(?P<dt>[^>]+)>)?)'
    r'\s*\.\s*$')


def _fast_nquad(m) -> NQuad:
    si = m.group("si")
    nq = NQuad(subject=si if si is not None else m.group("sb"),
               predicate=m.group("pi") or m.group("pw"))
    lit = m.group("lit")
    if lit is not None:
        if "\\" in lit:
            lit = _unescape(lit)
        dtype = m.group("dt")
        if dtype:
            tid = _XS_TYPES.get(
                dtype.split("#")[-1] if "#" in dtype else dtype)
            nq.object_value = _coerce(
                lit, TypeID.STRING if tid is None else tid)
        else:
            nq.object_value = Val(TypeID.DEFAULT, lit)
        nq.lang = m.group("lang") or ""
    else:
        oi = m.group("oi")
        nq.object_id = oi if oi is not None else m.group("ob")
    return nq


def parse_rdf(text: str) -> list[NQuad]:
    """Parse N-Quad statements — '.'-terminated, possibly several per
    line (the grammar's terminator is the dot, not the newline).
    Ref: chunker.ParseRDFs / parseNQuad (chunker/rdf_parser.go:58).
    Trailing junk after a statement is an error, never silently
    dropped."""
    out: list[NQuad] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _FAST.match(line)
        if m is not None:
            out.append(_fast_nquad(m))
            continue
        while line and not line.startswith("#"):
            nq, rest = _parse_one(line, lineno)
            out.append(nq)
            line = rest.strip()
    return out


def _norm_func(raw: str, lineno: int, subject: bool) -> str:
    """Normalize `uid( v )`/`val( v )` upsert references to `uid(v)` form
    (ref chunker/rdf_parser.go uid/val function terms)."""
    kind = raw[:3]
    inner = raw[4:-1].strip()
    if subject and kind == "val":
        raise GQLError(f"rdf line {lineno}: val() not allowed as subject")
    return f"{kind}({inner})"


def _take(line: str, lineno: int):
    m = _TERM.match(line)
    if not m:
        raise GQLError(f"rdf line {lineno}: cannot parse at {line[:30]!r}")
    return m, line[m.end():]


def _parse_one(line: str, lineno: int) -> tuple[NQuad, str]:
    m, rest = _take(line, lineno)
    if m.group("iri"):
        subject = m.group("iri")[1:-1]
    elif m.group("blank"):
        subject = m.group("blank")
    elif m.group("func"):
        subject = _norm_func(m.group("func"), lineno, subject=True)
    elif m.group("word"):
        subject = m.group("word")
    else:
        raise GQLError(f"rdf line {lineno}: bad subject")

    m, rest = _take(rest, lineno)
    if m.group("star"):
        pred = "*"  # S * * — delete every predicate of S (expanded later)
    else:
        pred = (m.group("iri") or "")[1:-1] if m.group("iri") \
            else m.group("word")
    if not pred:
        raise GQLError(f"rdf line {lineno}: bad predicate")

    nq = NQuad(subject=subject, predicate=pred)
    m, rest = _take(rest, lineno)
    if m.group("literal") is not None:
        raw = _unescape(m.group("literal")[1:-1])
        dtype = m.group("dtype")
        if dtype:
            tid = _XS_TYPES.get(dtype.split("#")[-1] if "#" in dtype else dtype)
            if tid is None:
                tid = TypeID.STRING
            nq.object_value = _coerce(raw, tid)
        else:
            nq.object_value = Val(TypeID.DEFAULT, raw)
        nq.lang = m.group("lang") or ""
    elif m.group("star"):
        nq.star = True
    elif m.group("iri"):
        nq.object_id = m.group("iri")[1:-1]
    elif m.group("blank"):
        nq.object_id = m.group("blank")
    elif m.group("func"):
        f = _norm_func(m.group("func"), lineno, subject=False)
        if f.startswith("val("):
            nq.val_var = f[4:-1]
        else:
            nq.object_id = f
    elif m.group("word"):
        nq.object_id = m.group("word")

    # optional graph-label term (standard N-Quads 4th term; the
    # reference parses and discards it, chunker/rdf_parser.go label)
    rest = rest.strip()
    if rest.startswith("<"):
        m2 = _TERM.match(rest)
        if m2 and m2.group("iri"):
            rest = rest[m2.end():]

    # optional facets: ( key = value , ... )
    rest = rest.strip()
    if rest.startswith("("):
        end = rest.index(")")
        nq.facets.update(parse_facet_text(rest[1:end]))
        rest = rest[end + 1:]
    rest = rest.strip()
    if not rest.startswith("."):
        # '.' is the statement terminator — and with several statements
        # per line, the load-bearing separator; a missing dot must
        # error, not silently accept a truncated statement
        raise GQLError(
            f"rdf line {lineno}: statement not '.'-terminated at "
            f"{rest[:30]!r}")
    return nq, rest[1:]


def parse_facet_text(inner: str) -> dict[str, Val]:
    """`key = value, ...` between facet parens → typed facet dict.
    Shared by the python grammar and the native parser's facet spans
    (native.cc dgt_rdf_parse returns the span verbatim)."""
    out: dict[str, Val] = {}
    for part in inner.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = _facet_val(v.strip())
    return out


def _facet_val(raw: str) -> Val:
    """Facet values are type-inferred (ref chunker facets handling +
    types/facets/utils.go:129)."""
    if raw.startswith('"') and raw.endswith('"'):
        inner = _unescape(raw[1:-1])
        try:
            from dgraph_tpu_torch.models.types import parse_datetime

            return Val(TypeID.DATETIME, parse_datetime(inner))
        except ValueError:
            return Val(TypeID.STRING, inner)
    if raw.lower() in ("true", "false"):
        return Val(TypeID.BOOL, raw.lower() == "true")
    try:
        return Val(TypeID.INT, int(raw))
    except ValueError:
        pass
    try:
        return Val(TypeID.FLOAT, float(raw))
    except ValueError:
        pass
    try:
        # unquoted RFC3339 tokens are datetime facets (ref
        # types/facets/utils.go:129 FacetFor's type sniffing; an
        # unparseable offset like +30:00 stays a string there too)
        from dgraph_tpu_torch.models.types import parse_datetime

        return Val(TypeID.DATETIME, parse_datetime(raw))
    except ValueError:
        pass
    return Val(TypeID.STRING, raw)


# -- JSON mutations ----------------------------------------------------------


def parse_json_mutation(data: Any, *, delete: bool = False,
                        _counter: list | None = None) -> list[NQuad]:
    """JSON object(s) -> NQuads. Ref: chunker/json_parser.go mapToNquads.

    Maps use the "uid" key for node identity (auto blank node otherwise),
    nested objects become uid edges, lists fan out, `key|facet` keys attach
    facets, and `key@lang` sets the language tag.
    """
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    counter = _counter if _counter is not None else [0]
    out: list[NQuad] = []
    items = data if isinstance(data, list) else [data]
    for obj in items:
        _map_to_nquads(obj, out, counter, delete)
    return out


def _fresh_blank(counter: list) -> str:
    counter[0] += 1
    return f"_:dg.json.{counter[0]}"


def _json_val(v: Any) -> Val:
    if isinstance(v, bool):
        return Val(TypeID.BOOL, v)
    if isinstance(v, int):
        return Val(TypeID.INT, v)
    if isinstance(v, float):
        return Val(TypeID.FLOAT, v)
    if isinstance(v, dict):  # geojson value object
        return Val(TypeID.GEO, v)
    return Val(TypeID.DEFAULT, str(v))


def _map_to_nquads(obj: dict, out: list[NQuad], counter: list,
                   delete: bool) -> str:
    if not isinstance(obj, dict):
        raise GQLError(f"JSON mutation: expected object, got {obj!r}")
    uid = obj.get("uid") or _fresh_blank(counter)
    if isinstance(uid, int):
        uid = hex(uid)
    facets_by_pred: dict[str, dict[str, Val]] = {}
    plain: list[tuple[str, Any]] = []
    for key, v in obj.items():
        if key == "uid":
            continue
        if "|" in key:
            pred, _, fkey = key.partition("|")
            facets_by_pred.setdefault(pred, {})[fkey] = _json_val(v)
        else:
            plain.append((key, v))
    for key, v in plain:
        lang = ""
        pred = key
        if "@" in key:
            pred, _, lang = key.partition("@")
        facets = facets_by_pred.get(pred, {})
        if v is None:
            if delete:
                out.append(NQuad(subject=uid, predicate=pred, star=True))
            continue
        vals = v if isinstance(v, list) else [v]
        for item in vals:
            if isinstance(item, dict) and not _is_geojson(item):
                child = _map_to_nquads(item, out, counter, delete)
                out.append(NQuad(subject=uid, predicate=pred,
                                 object_id=child, facets=dict(facets)))
            elif isinstance(item, str) and item.startswith("val(") \
                    and item.endswith(")"):
                # upsert value substitution in JSON bodies —
                # {"bal": "val(n)"} behaves like `<s> <bal> val(n) .`
                # (ref edgraph/server.go:503 updateValInMutations works
                # on both body formats)
                out.append(NQuad(subject=uid, predicate=pred,
                                 val_var=item[4:-1], lang=lang,
                                 facets=dict(facets)))
            elif isinstance(item, str) and item.startswith("uid(") \
                    and item.endswith(")"):
                # {"friend": "uid(v)"} links to every uid in v
                out.append(NQuad(subject=uid, predicate=pred,
                                 object_id=item, facets=dict(facets)))
            else:
                out.append(NQuad(subject=uid, predicate=pred,
                                 object_value=_json_val(item), lang=lang,
                                 facets=dict(facets)))
    return uid


def _is_geojson(d: dict) -> bool:
    return "type" in d and "coordinates" in d


def nquad_to_wire(nq: NQuad) -> tuple:
    """NQuad -> wire-encodable tuple, for shipping parsed (already
    uid-resolved) triples between cluster processes — a text
    round-trip would re-risk escaping/precision; this keeps Vals
    typed (wire T_VAL). Inverse: nquad_from_wire."""
    return (nq.subject, nq.predicate, nq.object_id, nq.object_value,
            nq.lang, dict(nq.facets), nq.star, nq.val_var)


def nquad_from_wire(t) -> NQuad:
    s, p, oid, oval, lang, facets, star, val_var = t
    return NQuad(subject=s, predicate=p, object_id=oid,
                 object_value=oval, lang=lang, facets=dict(facets),
                 star=bool(star), val_var=val_var)
