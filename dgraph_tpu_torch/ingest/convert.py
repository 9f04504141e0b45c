"""Data converters: SQL -> RDF (migrate) and GeoJSON -> RDF (conv).

The reference ships `dgraph migrate` (dgraph/cmd/migrate: walks a SQL
database's schema, turns tables into types, rows into nodes, foreign
keys into uid edges, and emits .rdf + .schema files) and `dgraph conv`
(dgraph/cmd/conv: geo files into RDF). Same tools here, with sqlite as
the SQL source (stdlib; the reference targets MySQL — the mapping
logic is identical, the driver differs).

Port of `dgraph_tpu/ingest/convert.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

import json
import re
import sqlite3
from typing import TextIO

from dgraph_tpu_torch.ingest.export import _rdf_escape

_LABEL_BAD = re.compile(r"[^0-9A-Za-z_.-]")
_PRED_BAD = re.compile(r"[^0-9A-Za-z_.]")


def _label(s: str) -> str:
    """Blank-node label component: only [A-Za-z0-9_.-] survive; other
    bytes hex-encode so distinct keys stay distinct ('John Smith' and
    'John_Smith' must not collide)."""
    return _LABEL_BAD.sub(lambda m: f"_x{ord(m.group(0)):02x}", str(s))


def _pred(s: str) -> str:
    """Predicate name: word chars + dots (GeoJSON property names in
    the wild contain spaces and punctuation)."""
    return _PRED_BAD.sub("_", str(s)) or "_"


# ---------------------------------------------------------------------------
# migrate: sqlite -> RDF + schema  (ref dgraph/cmd/migrate/run.go)
# ---------------------------------------------------------------------------

_SQL_TO_DGRAPH = {
    "INTEGER": "int", "INT": "int", "BIGINT": "int", "SMALLINT": "int",
    "REAL": "float", "FLOAT": "float", "DOUBLE": "float",
    "NUMERIC": "float", "DECIMAL": "float",
    "BOOLEAN": "bool", "BOOL": "bool",
    "DATE": "datetime", "DATETIME": "datetime", "TIMESTAMP": "datetime",
}


def _dgraph_type(sql_type: str) -> str:
    base = (sql_type or "").split("(")[0].strip().upper()
    return _SQL_TO_DGRAPH.get(base, "string")


def _sql_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def migrate_sqlite(db_path: str, rdf_out: TextIO, schema_out: TextIO,
                   separator: str = ".") -> dict:
    """Walk a sqlite database: every table row becomes a node typed by
    the table, every column a `table.column` predicate, every foreign
    key a uid edge to the referenced row's blank node (ref
    migrate/table_guide.go blank-node naming _:<table>_<pk>).

    A FK edge is only emitted when the referenced columns ARE the
    referenced table's primary key (in order) — that's the only case
    where the target blank-node label is derivable; anything else
    (rowid refs without an INTEGER PRIMARY KEY, FKs onto non-pk
    columns) is counted in stats["skipped_fks"] instead of emitting
    silently dangling edges."""
    conn = sqlite3.connect(db_path)
    conn.row_factory = sqlite3.Row
    tables = [r["name"] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name NOT LIKE 'sqlite_%' ORDER BY name")]
    stats = {"tables": len(tables), "rows": 0, "edges": 0,
             "skipped_fks": 0}
    preds: dict[str, str] = {}
    types: dict[str, list[str]] = {}

    def pk_of(table: str) -> list[str]:
        cols = list(conn.execute(f"PRAGMA table_info({_sql_ident(table)})"))
        pk = sorted((c["pk"], c["name"]) for c in cols if c["pk"])
        return [name for _, name in pk] or [c["name"] for c in cols]

    for table in tables:
        cols = list(conn.execute(f"PRAGMA table_info({_sql_ident(table)})"))
        # composite-aware FK map: fk id -> (ref table, [(from, to)...])
        fk_groups: dict[int, tuple[str, list]] = {}
        for r in conn.execute(
                f"PRAGMA foreign_key_list({_sql_ident(table)})"):
            fk_groups.setdefault(r["id"], (r["table"], []))[1].append(
                (r["from"], r["to"]))
        # resolvable FK: referenced cols == referenced table's pk order
        fk_cols: dict[str, tuple[str, int]] = {}  # from-col -> (ref, id)
        fk_emittable: dict[int, list[str]] = {}
        for fid, (ref_table, pairs) in fk_groups.items():
            ref_pk = pk_of(ref_table)
            tos = [t if t is not None else rp
                   for (_, t), rp in zip(pairs, ref_pk)] \
                if len(pairs) == len(ref_pk) else None
            if tos == ref_pk:
                fk_emittable[fid] = [f for f, _ in pairs]
            for f, _ in pairs:
                fk_cols[f] = (ref_table, fid)

        pk_cols = pk_of(table)
        type_preds = []
        for c in cols:
            pred = f"{_pred(table)}{separator}{_pred(c['name'])}"
            if c["name"] in fk_cols:
                preds[pred] = "[uid] @reverse"
            else:
                preds[pred] = _dgraph_type(c["type"])
            type_preds.append(pred)
        types[_pred(table)] = type_preds

        for row in conn.execute(f"SELECT * FROM {_sql_ident(table)}"):
            pk = "_".join(_label(row[c]) for c in pk_cols)
            subj = f"_:{_label(table)}_{pk}"
            rdf_out.write(
                f'{subj} <dgraph.type> "{_rdf_escape(table)}" .\n')
            stats["rows"] += 1
            emitted_fks: set[int] = set()
            for c in cols:
                name = c["name"]
                v = row[name]
                if v is None:
                    continue
                pred = f"{_pred(table)}{separator}{_pred(name)}"
                if name in fk_cols:
                    ref_table, fid = fk_cols[name]
                    if fid not in fk_emittable or fid in emitted_fks:
                        if fid not in fk_emittable:
                            stats["skipped_fks"] += 1
                        continue
                    emitted_fks.add(fid)
                    parts = [row[f] for f in fk_emittable[fid]]
                    if any(p is None for p in parts):
                        continue
                    target = "_".join(_label(p) for p in parts)
                    rdf_out.write(
                        f"{subj} <{pred}> _:{_label(ref_table)}_{target}"
                        " .\n")
                    stats["edges"] += 1
                elif isinstance(v, bytes):
                    continue  # blobs don't survive RDF text form
                else:
                    rdf_out.write(
                        f'{subj} <{pred}> "{_rdf_escape(str(v))}" .\n')

    for pred, ptype in sorted(preds.items()):
        # every scalar column gets a lookup index: migrated data is
        # queried by former SQL key columns (root eq/ineq needs an
        # index, like the reference server)
        idx = {"string": " @index(exact)", "int": " @index(int)",
               "float": " @index(float)", "bool": " @index(bool)",
               "datetime": " @index(datetime)"}.get(ptype, "")
        schema_out.write(f"{pred}: {ptype}{idx} .\n")
    for tname, tpreds in sorted(types.items()):
        schema_out.write(f"type {tname} {{\n")
        for p in tpreds:
            schema_out.write(f"  {p}\n")
        schema_out.write("}\n")
    conn.close()
    return stats


# ---------------------------------------------------------------------------
# conv: GeoJSON -> RDF  (ref dgraph/cmd/conv/conv.go)
# ---------------------------------------------------------------------------


def convert_geojson(geojson_in: TextIO, rdf_out: TextIO,
                    geopred: str = "loc") -> dict:
    """FeatureCollection -> one node per feature: geometry under
    `geopred` (geojson literal) plus every scalar property (property
    names sanitized to legal predicate form)."""
    doc = json.load(geojson_in)
    feats = doc.get("features", [doc] if doc.get("geometry") else [])
    n = 0
    for i, feat in enumerate(feats):
        geom = feat.get("geometry")
        if not geom:
            continue
        subj = f"_:geo_{i}"
        gq = _rdf_escape(json.dumps(geom, separators=(",", ":")))
        rdf_out.write(
            f'{subj} <{_pred(geopred)}> "{gq}"^^<geo:geojson> .\n')
        for k, v in (feat.get("properties") or {}).items():
            if v is None or isinstance(v, (dict, list)):
                continue
            rdf_out.write(
                f'{subj} <{_pred(k)}> "{_rdf_escape(str(v))}" .\n')
        n += 1
    return {"features": n}
