"""Export a live store to RDF or JSON + schema text.

Re-provides worker/export.go:376: full-database egress at a read
timestamp, RDF N-Quads with language tags, typed literals and facets,
or JSON objects; plus the schema document. The output round-trips
through the bulk/live loaders (the reference's export→bulk cycle).

Port of `dgraph_tpu/ingest/export.py`, with one difference: a
float32vector value is written with nine significant digits an element
(`[x0,x1,...]`), which round-trips every float32. The reference writes
numpy's `str()` of the array, which keeps at most eight fractional
digits (most rows of a unit-scale corpus change on reload) and
summarizes arrays past 1,000 elements with "...".
"""

from __future__ import annotations

import base64
import json
from typing import Iterator

from dgraph_tpu_torch.models.types import TypeID, Val, to_json_value


def _rdf_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")


_XS = {TypeID.INT: "xs:int", TypeID.FLOAT: "xs:float",
       TypeID.BOOL: "xs:boolean", TypeID.DATETIME: "xs:dateTime",
       TypeID.GEO: "geo:geojson", TypeID.PASSWORD: "xs:password",
       TypeID.BINARY: "xs:base64Binary"}


def _rdf_value(v: Val) -> str:
    if v.tid == TypeID.DATETIME:
        from dgraph_tpu_torch.models.types import iso8601
        raw = iso8601(v.value)
    elif v.tid == TypeID.GEO:
        raw = json.dumps(v.value)
    elif v.tid == TypeID.BOOL:
        raw = "true" if v.value else "false"
    elif v.tid == TypeID.BINARY:
        raw = base64.b64encode(v.value).decode()
    elif v.tid == TypeID.FLOAT32VECTOR:
        # nine significant digits round-trip every float32, at any width
        raw = "[" + ",".join("%.9g" % x for x in v.value.tolist()) + "]"
    else:
        raw = str(v.value)
    lit = f'"{_rdf_escape(raw)}"'
    xs = _XS.get(v.tid)
    return f"{lit}^^<{xs}>" if xs else lit


def _facet_str(facets: dict) -> str:
    if not facets:
        return ""
    parts = []
    for k, v in sorted(facets.items()):
        if isinstance(v, Val):
            if v.tid == TypeID.STRING:
                parts.append(f'{k}="{_rdf_escape(str(v.value))}"')
            elif v.tid == TypeID.DATETIME:
                parts.append(f'{k}={v.value.isoformat()}')
            elif v.tid == TypeID.BOOL:
                parts.append(f"{k}={'true' if v.value else 'false'}")
            else:
                parts.append(f"{k}={v.value}")
        else:
            parts.append(f"{k}={v}")
    return " (" + ", ".join(parts) + ")"


def export_rdf(db, read_ts: int | None = None) -> Iterator[str]:
    """Yield N-Quad lines for every posting visible at read_ts."""
    read_ts = read_ts if read_ts is not None \
        else db.coordinator.max_assigned()
    for pred in sorted(db.tablets):
        tab = db.tablets[pred]
        if tab.is_uid:
            for src in sorted(tab.src_uids(read_ts).tolist()):
                for dst in tab.get_dst_uids(src, read_ts).tolist():
                    fc = tab.get_facets(src, int(dst), read_ts)
                    yield (f"<{hex(src)}> <{pred}> <{hex(int(dst))}>"
                           f"{_facet_str(fc)} .")
        else:
            for src in sorted(tab.src_uids(read_ts).tolist()):
                for p in tab.get_postings(src, read_ts):
                    lang = f"@{p.lang}" if p.lang else ""
                    val = _rdf_value(p.value)
                    if lang and val.startswith('"') and "^^" not in val:
                        yield (f"<{hex(src)}> <{pred}> {val}{lang}"
                               f"{_facet_str(p.facets)} .")
                    else:
                        yield (f"<{hex(src)}> <{pred}> {val}"
                               f"{_facet_str(p.facets)} .")


def export_json(db, read_ts: int | None = None) -> list[dict]:
    """All nodes as JSON objects keyed by uid (ref export.go JSON mode)."""
    read_ts = read_ts if read_ts is not None \
        else db.coordinator.max_assigned()
    nodes: dict[int, dict] = {}

    def node(uid: int) -> dict:
        n = nodes.get(uid)
        if n is None:
            n = {"uid": hex(uid)}
            nodes[uid] = n
        return n

    for pred in sorted(db.tablets):
        tab = db.tablets[pred]
        if tab.is_uid:
            for src in tab.src_uids(read_ts).tolist():
                node(src)[pred] = [
                    {"uid": hex(int(d))}
                    for d in tab.get_dst_uids(src, read_ts).tolist()]
        else:
            for src in tab.src_uids(read_ts).tolist():
                ps = tab.get_postings(src, read_ts)
                if tab.schema.list_:
                    node(src)[pred] = [to_json_value(p.value) for p in ps]
                else:
                    for p in ps:
                        key = f"{pred}@{p.lang}" if p.lang else pred
                        node(src)[key] = to_json_value(p.value)
    return [nodes[u] for u in sorted(nodes)]


def export_schema(db) -> str:
    """Schema document re-parseable by alter()
    (ref worker/export.go schema output)."""
    return db.schema.describe_all()
