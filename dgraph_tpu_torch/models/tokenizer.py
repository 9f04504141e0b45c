"""Index tokenizers.

Re-provides the reference's tokenizer registry (tok/tok.go:56 Tokenizer
interface, tok/tok.go:84-101 built-in registry): term, exact, hash,
trigram, fulltext, int, float, bool, datetime buckets (year/month/day/hour),
geo.  Each token is prefixed with a one-byte identifier so tokens of
different tokenizers for the same predicate never collide and sortable
tokenizers keep byte order (ref tok/tok.go identifier scheme).

TPU angle: tokenizers run host-side at mutation/ingest time; what reaches
the device are the *posting UID vectors per token* and, for sortable
indexes (int/float/datetime/exact), a parallel sorted array of int64 token
keys so inequality lookups (le/lt/ge/gt/between) become one searchsorted
over the token-key vector (ref worker/tokens.go:113 getInequalityTokens
walks Badger in order instead).
"""

from __future__ import annotations

import datetime as _dt
import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Iterable

from dgraph_tpu_torch.models.types import (
    TypeID, Val, convert, sort_key, value_fingerprint,
)


@dataclass(frozen=True)
class TokenizerSpec:
    name: str
    ident: int          # one-byte namespace prefix
    for_type: TypeID    # schema type this tokenizer applies to
    sortable: bool      # supports inequality via ordered token keys
    lossy: bool         # token does not uniquely identify the value
    fn: Callable[[Val], list]


def _fold(s: str) -> str:
    """Unicode-fold + lowercase, the reference's bleve normalize chain
    (tok/bleve.go) reduced to NFKD-strip-marks + casefold."""
    nfkd = unicodedata.normalize("NFKD", s)
    stripped = "".join(c for c in nfkd if not unicodedata.combining(c))
    return stripped.casefold()


_TERM_SPLIT = re.compile(r"[^\w]+", re.UNICODE)

from dgraph_tpu_torch.models.stemmer import stem as _stem
from dgraph_tpu_torch.models.stemmer import stopwords as _stopwords


def term_tokens(v: Val) -> list[str]:
    """Ref: tok.TermTokenizer — fold + split on non-word."""
    return sorted({t for t in _TERM_SPLIT.split(_fold(str(v.value))) if t})


def fulltext_tokens(v: Val, lang: str = "") -> list[str]:
    """Ref: tok.FullTextTokenizer — fold, per-language stopword filter,
    per-language stem (tok/bleve.go analyzers, tok/langbase.go). The
    value's @lang tag selects the analyzer at index time; fn.lang
    (`alloftext(pred@de, ...)`) selects it at query time. Tokens share
    one namespace like the reference (same Identifier byte for every
    language)."""
    stops = _stopwords(lang)
    toks = {_stem(t, lang)
            for t in _TERM_SPLIT.split(_fold(str(v.value)))
            if t and t not in stops}
    return sorted(t for t in toks if t)


def exact_tokens(v: Val) -> list[str]:
    return [str(v.value)]


def hash_tokens(v: Val) -> list[int]:
    return [value_fingerprint(convert(v, TypeID.STRING))]


def trigram_tokens(v: Val) -> list[str]:
    """Ref: tok.TrigramTokenizer (regexp index, worker/trigram.go)."""
    s = str(v.value)
    return sorted({s[i : i + 3] for i in range(len(s) - 2)})


def int_tokens(v: Val) -> list[int]:
    return [int(convert(v, TypeID.INT).value)]


def float_tokens(v: Val) -> list[int]:
    # Sortable int64 key so inequality works over one searchsorted.
    return [sort_key(convert(v, TypeID.FLOAT))]


def bool_tokens(v: Val) -> list[int]:
    return [1 if convert(v, TypeID.BOOL).value else 0]


def _dt_of(v: Val) -> _dt.datetime:
    return convert(v, TypeID.DATETIME).value


def year_tokens(v: Val) -> list[int]:
    return [_dt_of(v).year]


def month_tokens(v: Val) -> list[int]:
    d = _dt_of(v)
    return [d.year * 100 + d.month]


def day_tokens(v: Val) -> list[int]:
    d = _dt_of(v)
    return [(d.year * 100 + d.month) * 100 + d.day]


def hour_tokens(v: Val) -> list[int]:
    d = _dt_of(v)
    return [((d.year * 100 + d.month) * 100 + d.day) * 100 + d.hour]


def geo_tokens(v: Val) -> list[str]:
    """Geo cell covering.  The reference uses S2 cells at levels 5-16
    (types/s2index.go).  We grid lon/lat into multi-resolution square
    cells (models/geo.py, levels 5..12) — the geometry's bbox cover at
    every level where it stays small, so contains/within/intersects
    prefilters find polygons by interior cells, not just vertices."""
    from dgraph_tpu_torch.models.geo import cover_tokens, parse_geom

    return cover_tokens(parse_geom(v.value))


_REGISTRY: dict[str, TokenizerSpec] = {}


def _register(name, ident, for_type, sortable, lossy, fn):
    _REGISTRY[name] = TokenizerSpec(name, ident, for_type, sortable, lossy, fn)


_register("term", 0x1, TypeID.STRING, False, True, term_tokens)
_register("exact", 0x2, TypeID.STRING, True, False, exact_tokens)
_register("fulltext", 0x3, TypeID.STRING, False, True, fulltext_tokens)
_register("hash", 0x4, TypeID.STRING, False, True, hash_tokens)
_register("trigram", 0x5, TypeID.STRING, False, True, trigram_tokens)
_register("int", 0x6, TypeID.INT, True, False, int_tokens)
_register("float", 0x7, TypeID.FLOAT, True, True, float_tokens)
_register("bool", 0x8, TypeID.BOOL, True, False, bool_tokens)
_register("datetime", 0x9, TypeID.DATETIME, True, True, year_tokens)
_register("year", 0x9, TypeID.DATETIME, True, True, year_tokens)
_register("month", 0xA, TypeID.DATETIME, True, True, month_tokens)
_register("day", 0xB, TypeID.DATETIME, True, True, day_tokens)
_register("hour", 0xC, TypeID.DATETIME, True, True, hour_tokens)
_register("geo", 0xD, TypeID.GEO, False, True, geo_tokens)
# `@index(vector)` marks a float32vector predicate as similarity-
# searchable. Unlike every other tokenizer it emits NO index tokens:
# the "index" is the per-predicate columnar vector block
# (storage/vecstore.py) scored by brute-force MIPS (ops/knn.py), the
# TPU-KNN formulation — token posting lists have no role.
_register("vector", 0xE, TypeID.FLOAT32VECTOR, False, True,
          lambda v: [])


# Identifier bytes >= 0x80 are reserved for custom tokenizers (ref
# tok/tok.go IdentCustom); built-ins stay below.
IDENT_CUSTOM = 0x80


def load_custom_tokenizer(path: str) -> TokenizerSpec:
    """Load and register a custom tokenizer plugin.

    Ref tok/tok.go:116 LoadCustomTokenizer: the reference opens a Go
    plugin .so exporting `Tokenizer() interface{}`; the TPU build loads
    a Python module file exporting `tokenizer()` returning an object
    with attributes `name` (str), `for_type` (schema type name, e.g.
    "string"/"int"), `identifier` (int >= 0x80), and a method
    `tokens(value) -> list[str]` — the PluginTokenizer contract
    (tok/tok.go:398). Custom tokenizers are never sortable and always
    lossy, like the reference's CustomTokenizer wrapper hard-codes."""
    import importlib.util
    import os

    from dgraph_tpu_torch.models.types import type_from_name

    modname = ("dgt_customtok_"
               + os.path.splitext(os.path.basename(path))[0])
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ValueError(f"cannot load custom tokenizer from {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    plug = mod.tokenizer()
    ident = int(plug.identifier)
    if not (IDENT_CUSTOM <= ident <= 0xFF):
        raise ValueError(
            f"custom tokenizer identifier byte must be >= "
            f"{IDENT_CUSTOM:#x}, but was {ident:#x}")
    name = str(plug.name)
    prev = _REGISTRY.get(name)
    if prev is not None and prev.ident < IDENT_CUSTOM:
        raise ValueError(
            f"custom tokenizer may not shadow built-in {name!r}")
    # identifier bytes namespace the index keys: two tokenizers on one
    # ident would silently share posting lists (the reference's
    # registerTokenizer asserts uniqueness)
    for other in _REGISTRY.values():
        if other.ident == ident and other.name != name:
            raise ValueError(
                f"identifier {ident:#x} already used by tokenizer "
                f"{other.name!r}")

    def fn(v: Val, _plug=plug) -> list:
        return [str(t) for t in _plug.tokens(v.value)]

    ts = TokenizerSpec(name, ident, type_from_name(str(plug.for_type)),
                       False, True, fn)
    _REGISTRY[name] = ts
    return ts


def load_custom_tokenizers(paths: Iterable[str]) -> list[TokenizerSpec]:
    return [load_custom_tokenizer(p) for p in paths if p]


def get_tokenizer(name: str) -> TokenizerSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"Undefined tokenizer {name!r}")
    return spec


def get_tokenizers(names: Iterable[str]) -> list[TokenizerSpec]:
    return [get_tokenizer(n) for n in names]


def default_tokenizer_for(tid: TypeID) -> TokenizerSpec | None:
    """Tokenizer implied by `@index` with no args / inequality support.
    Ref: tok.GetTokenizer defaults per type (tok/tok.go)."""
    return {
        TypeID.INT: _REGISTRY["int"],
        TypeID.FLOAT: _REGISTRY["float"],
        TypeID.BOOL: _REGISTRY["bool"],
        TypeID.DATETIME: _REGISTRY["datetime"],
        TypeID.GEO: _REGISTRY["geo"],
        TypeID.STRING: None,  # string requires an explicit tokenizer choice
        TypeID.DEFAULT: None,
        # `@index` on a vector predicate must spell @index(vector)
        TypeID.FLOAT32VECTOR: None,
    }.get(tid)


def tokens_for(v: Val, spec: TokenizerSpec, lang: str = "") -> list:
    """Tokens for value under tokenizer, converted to the tokenizer's
    input type first (ref posting/index.go:83 addIndexMutations does
    types.Convert before tokenizing). `lang` selects the analyzer for
    language-aware tokenizers (fulltext only, like the reference's
    GetTokenizerForLang)."""
    converted = convert(v, spec.for_type)
    if spec.name == "fulltext":
        return spec.fn(converted, lang)
    return spec.fn(converted)
