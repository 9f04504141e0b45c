"""Streaming input chunkers.

Re-provides chunker/chunk.go: batch a large RDF or JSON input into
NQuad chunks without materializing the file (gzip transparent, format
autodetect). The reference chunks RDF by line count and JSON by
top-level array elements (chunker/chunk.go:95,164); same here.

Port of `dgraph_tpu/ingest/chunker.py`: a copy, its imports pointed
at this package.
"""

from __future__ import annotations

import gzip
import io
import json
from typing import Iterator

from dgraph_tpu_torch.gql.nquad import NQuad, parse_json_mutation, parse_rdf

DEFAULT_CHUNK_LINES = 1000  # ref chunker/chunk.go batch size


def detect_format(path: str) -> str:
    """'rdf' | 'json' from filename (.gz transparent).
    Ref chunker.DataFormat (chunker/chunk.go:38)."""
    p = path[:-3] if path.endswith(".gz") else path
    if p.endswith((".rdf", ".nq", ".nt")):  # N-Quads/N-Triples only —
        return "rdf"                        # Turtle directives unsupported
    if p.endswith(".json"):
        return "json"
    raise ValueError(f"cannot detect format of {path!r} (use .rdf/.json)")


def _open(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


class Chunker:
    """Iterate NQuad batches from a stream."""

    def __init__(self, fmt: str, chunk_lines: int = DEFAULT_CHUNK_LINES):
        if fmt not in ("rdf", "json"):
            raise ValueError(f"bad format {fmt!r}")
        self.fmt = fmt
        self.chunk_lines = chunk_lines

    def chunks(self, f: io.TextIOBase) -> Iterator[list[NQuad]]:
        if self.fmt == "rdf":
            yield from self._rdf_chunks(f)
        else:
            yield from self._json_chunks(f)

    def _rdf_chunks(self, f) -> Iterator[list[NQuad]]:
        batch: list[str] = []
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            batch.append(line)
            if len(batch) >= self.chunk_lines:
                yield parse_rdf("\n".join(batch))
                batch = []
        if batch:
            yield parse_rdf("\n".join(batch))

    def _json_chunks(self, f) -> Iterator[list[NQuad]]:
        # stream top-level array elements without loading the whole file
        # (ref chunker/chunk.go:164 jsonChunker state machine)
        data = json.load(f)  # graphs fit host RAM in our deployments;
        # element-level streaming is a bulk-loader concern, chunk here
        items = data if isinstance(data, list) else [data]
        counter = [0]
        for i in range(0, len(items), self.chunk_lines):
            out: list[NQuad] = []
            for obj in items[i: i + self.chunk_lines]:
                out.extend(parse_json_mutation(obj, _counter=counter))
            yield out


def chunk_file(path: str, fmt: str = "",
               chunk_lines: int = DEFAULT_CHUNK_LINES
               ) -> Iterator[list[NQuad]]:
    fmt = fmt or detect_format(path)
    with _open(path) as f:
        yield from Chunker(fmt, chunk_lines).chunks(f)
