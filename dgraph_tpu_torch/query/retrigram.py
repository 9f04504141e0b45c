"""Regex → trigram AND/OR query compilation.

The reference answers ``regexp()`` by compiling the regex AST into a
boolean query over trigrams — a NECESSARY condition for any match —
walking the trigram index with it, then regex-verifying the survivors
(ref worker/trigram.go:35 uidsForRegex → cindex.RegexpQuery, which
handles alternation, optionality and anchors).  Round 3 approximated
this with literal-fragment extraction and an unconditional intersect,
which wrongly ANDs trigram sets across alternation branches
(``/foo|bar/`` demanded both).  This module is the real compiler.

Design (simplified from codesearch's RegexpQuery):
  * Walk CPython's own ``re`` parse tree (``re._parser``) — the ground
    truth for what the verify pass will accept, so the filter can never
    be stricter than the verifier along a path we constrain.
  * For each subexpression compute either its small EXACT string set
    (alternations/optionals/char-classes multiply sets, bounded) or a
    trigram query that any containing string must satisfy.
  * Concatenation ANDs, alternation ORs, ``x{0,n}`` widens to the empty
    string, ``x{1,}`` keeps one copy's constraint, anchors/lookarounds
    contribute nothing (necessity is preserved by ignoring them).
  * Unconstrainable nodes (``.``, negated classes, backrefs) become ALL;
    an ALL branch of an OR makes the whole OR unconstrained, exactly as
    in the reference's query algebra.

The output query is evaluated against the index by the executor
(`_trigram_query_uids`); ALL means "no index help — full scan".
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from itertools import product
from typing import Optional

try:  # Python 3.11+ moved the sre internals under re.*
    from re import _constants as _sc
    from re import _parser as _sre
except ImportError:  # Python <= 3.10: the public top-level names
    import sre_constants as _sc
    import sre_parse as _sre

# opcodes added in 3.11 (atomic groups / possessive quantifiers): a
# 3.10 parser never emits them, so distinct sentinels keep the `is`
# dispatch below falsy instead of AttributeError-ing into the
# degrade-to-ALL path on every pattern
_OPC_ATOMIC_GROUP = getattr(_sc, "ATOMIC_GROUP", object())
_OPC_POSSESSIVE_REPEAT = getattr(_sc, "POSSESSIVE_REPEAT", object())

# Bounds on the exact-set tracking: past these we degrade to trigram
# queries (still correct, just a weaker prefilter).  codesearch uses
# comparable small constants for the same reason — exact sets exist
# only to form trigrams across node boundaries like (foo|bar)baz.
_EXACT_SET_MAX = 64
_EXACT_LEN_MAX = 32
_CLASS_ENUM_MAX = 16

_OP_ALL = "all"
_OP_NONE = "none"
_OP_AND = "and"
_OP_OR = "or"


@dataclass(frozen=True)
class TriQuery:
    """AND/OR tree over trigram index lookups."""

    op: str
    trigrams: tuple = ()
    subs: tuple = ()

    def __repr__(self):  # compact, for test goldens / debugging
        if self.op in (_OP_ALL, _OP_NONE):
            return self.op.upper()
        parts = [repr(t) for t in self.trigrams] + [repr(s) for s in self.subs]
        return f"{self.op}({' '.join(parts)})"


ALL = TriQuery(_OP_ALL)
NONE = TriQuery(_OP_NONE)


def _and(parts: list) -> TriQuery:
    tris: list = []
    subs: list = []
    for p in parts:
        if p.op == _OP_NONE:
            return NONE
        if p.op == _OP_ALL:
            continue
        if p.op == _OP_AND:
            tris.extend(p.trigrams)
            subs.extend(p.subs)
        else:
            subs.append(p)
    if not tris and not subs:
        return ALL
    return TriQuery(_OP_AND, tuple(dict.fromkeys(tris)), tuple(subs))


def _or(parts: list) -> TriQuery:
    tris: list = []
    subs: list = []
    for p in parts:
        if p.op == _OP_ALL:
            return ALL
        if p.op == _OP_NONE:
            continue
        if p.op == _OP_OR:
            tris.extend(p.trigrams)
            subs.extend(p.subs)
        else:
            subs.append(p)
    if not tris and not subs:
        return NONE
    return TriQuery(_OP_OR, tuple(dict.fromkeys(tris)), tuple(subs))


class _Info:
    """Analysis result for one subexpression: either the exact set of
    strings it can match (small), or a necessary trigram query for any
    string containing a match of it."""

    __slots__ = ("exact", "match")

    def __init__(self, exact: Optional[frozenset] = None,
                 match: TriQuery = ALL):
        self.exact = exact
        self.match = match


_EMPTY_STR = _Info(exact=frozenset({""}))


try:  # sre's own table of extra case equivalents (ſ↔s, ı↔i, µ↔μ…)
    from re._casefix import _EXTRA_CASES
except ImportError:  # Python <= 3.10 keeps the same table as
    # codepoint tuples in sre_compile._equivalences
    try:
        from sre_compile import _equivalences
        _EXTRA_CASES = {i: [j for j in t if i != j]
                        for t in _equivalences for i in t}
    except ImportError:  # pragma: no cover
        _EXTRA_CASES = {}

# chr → every codepoint that sre's LITERAL_UNI_IGNORE accepts for it.
# sre matches X against literal c iff lower(X) == lower(c) or lower(X)
# is one of lower(c)'s extra cases, so completeness needs the INVERSE
# lower map (e.g. 'k' must admit KELVIN SIGN U+212A).  Built lazily on
# the first ignorecase compile and cached for the process.
_INV_LOWER: Optional[dict] = None
_VARIANTS_MAX = 32  # per-window cap: 3 variants/char (e.g. s/S/ſ) = 27


def _inv_lower_map() -> dict:
    global _INV_LOWER
    if _INV_LOWER is None:
        import numpy as np
        # One C-level lower() over the whole codepoint space, then a
        # vectorized diff: only the ~3k chars whose lowercase differs
        # need dict entries (identity is handled at lookup time).
        # U+0130 İ is excluded up front — its lowercase is two chars,
        # which would misalign the parallel arrays (and sre cannot
        # enumerate it either; _case_variants bails the same way).
        big = "".join(
            chr(cp) for cp in range(0x110000)
            if cp != 0x130 and not 0xD800 <= cp <= 0xDFFF)
        low = big.lower()
        assert len(low) == len(big), "unexpected multi-char lowercase"
        a = np.frombuffer(big.encode("utf-32-le"), dtype=np.uint32)
        b = np.frombuffer(low.encode("utf-32-le"), dtype=np.uint32)
        m: dict = {}
        for cp, lo in zip(a[a != b].tolist(), b[a != b].tolist()):
            m.setdefault(chr(lo), []).append(chr(cp))
        _INV_LOWER = m
    return _INV_LOWER


def _case_variants(ch: str) -> Optional[tuple]:
    """All characters the verifier's IGNORECASE literal `ch` matches,
    or None when the set can't be enumerated soundly (multi-char
    lowercase like İ → i̇)."""
    lo = ch.lower()
    if len(lo) != 1:
        return None
    inv = _inv_lower_map()
    out = set(inv.get(lo, ())) | {lo}
    for e in _EXTRA_CASES.get(ord(lo), ()):
        ec = chr(e)
        out |= set(inv.get(ec, ())) | {ec}
    return tuple(sorted(out))


def _trigram_query_for(s: str, ignorecase: bool) -> TriQuery:
    """Necessary condition for a string CONTAINING literal `s`."""
    if len(s) < 3:
        return ALL  # too short to pin a trigram
    parts: list = []
    for i in range(len(s) - 2):
        win = s[i:i + 3]
        if not ignorecase:
            parts.append(TriQuery(_OP_AND, (win,)))
            continue
        # Case-fold: the value may carry any case mix, so the necessary
        # condition per window is an OR over its full case-variant set.
        # An unenumerable or oversized set degrades that WINDOW to
        # unconstrained (skipped); other windows still filter.
        per_char = [_case_variants(c) for c in win]
        if any(v is None for v in per_char):
            continue
        n = 1
        for v in per_char:
            n *= len(v)
        if n > _VARIANTS_MAX:
            continue
        variants = ["".join(t) for t in product(*per_char)]
        if len(variants) == 1:
            parts.append(TriQuery(_OP_AND, (variants[0],)))
        else:
            parts.append(TriQuery(_OP_OR, tuple(variants)))
    return _and(parts)


def _matchq(info: _Info, ignorecase: bool) -> TriQuery:
    if info.exact is None:
        return info.match
    return _or([_trigram_query_for(s, ignorecase) for s in info.exact])


def _concat(a: _Info, b: _Info, ignorecase: bool) -> _Info:
    if a.exact is not None and b.exact is not None:
        prod = len(a.exact) * len(b.exact)
        if prod <= _EXACT_SET_MAX:
            joined = {x + y for x in a.exact for y in b.exact}
            if all(len(s) <= _EXACT_LEN_MAX for s in joined):
                return _Info(exact=frozenset(joined))
    return _Info(match=_and([_matchq(a, ignorecase),
                             _matchq(b, ignorecase)]))


def _an_class(items) -> _Info:
    """[...] character class: enumerate small positive classes."""
    chars: set = set()
    for it in items:
        op, av = it
        if op is _sc.LITERAL:
            chars.add(chr(av))
        elif op is _sc.RANGE:
            lo, hi = av
            if hi - lo + 1 > _CLASS_ENUM_MAX:
                return _Info(match=ALL)
            chars.update(chr(c) for c in range(lo, hi + 1))
        else:  # NEGATE, CATEGORY (\w, \d…) — unconstrainable
            return _Info(match=ALL)
        if len(chars) > _CLASS_ENUM_MAX:
            return _Info(match=ALL)
    if not chars:
        return _Info(match=ALL)
    return _Info(exact=frozenset(chars))


def _an_node(node, ic: bool) -> _Info:
    op, av = node
    if op is _sc.LITERAL:
        return _Info(exact=frozenset({chr(av)}))
    if op is _sc.IN:
        return _an_class(av)
    if op is _sc.AT:  # anchors: zero-width, ignore
        return _EMPTY_STR
    if op in (_sc.ASSERT, _sc.ASSERT_NOT):
        # Lookarounds only narrow the match; dropping them keeps the
        # query a necessary condition.
        return _EMPTY_STR
    if op is _sc.SUBPATTERN:
        _gid, add_flags, del_flags, seq = av
        ic2 = (ic or bool(add_flags & re.IGNORECASE)) \
            and not bool(del_flags & re.IGNORECASE)
        return _an_seq(seq, ic2)
    if op is _OPC_ATOMIC_GROUP:
        return _an_seq(av, ic)
    if op in (_sc.MAX_REPEAT, _sc.MIN_REPEAT, _OPC_POSSESSIVE_REPEAT):
        lo, hi, seq = av
        sub = _an_seq(seq, ic)
        if lo == 0:
            if hi == 0:
                return _EMPTY_STR
            if hi == 1 and sub.exact is not None \
                    and len(sub.exact) < _EXACT_SET_MAX:
                return _Info(exact=sub.exact | {""})  # x? → {"", x…}
            return _Info(match=ALL)  # x* — may be absent entirely
        # lo >= 1: at least one copy is present.
        if lo == hi and sub.exact is not None:
            acc = _Info(exact=frozenset({""}))
            for _ in range(lo):
                acc = _concat(acc, sub, ic)
                if acc.exact is None:
                    break
            if acc.exact is not None:
                return acc
        return _Info(match=_matchq(sub, ic))
    # ANY (.), NOT_LITERAL, GROUPREF, and anything unrecognised:
    # a match exists but we can say nothing about its text.
    return _Info(match=ALL)


def _an_seq(nodes, ic: bool) -> _Info:
    # Fold left, but keep the exact-string run alive ACROSS match-typed
    # nodes: "abc.*def" must yield and(abc-query, def-query), not lose
    # "def" to one-char-at-a-time concatenation below trigram length.
    pending: list = []
    cur = _EMPTY_STR

    def flush():
        nonlocal cur
        if cur.exact != _EMPTY_STR.exact:
            q = _matchq(cur, ic)
            if q is not ALL:
                pending.append(q)
        cur = _EMPTY_STR

    for node in nodes:
        if node[0] is _sc.BRANCH:
            _unused, branches = node[1]
            infos = [_an_seq(b, ic) for b in branches]
            if all(i.exact is not None for i in infos) \
                    and sum(len(i.exact) for i in infos) <= _EXACT_SET_MAX:
                info = _Info(exact=frozenset().union(
                    *[i.exact for i in infos]))
            else:
                info = _Info(match=_or([_matchq(i, ic) for i in infos]))
        else:
            info = _an_node(node, ic)
        if info.exact is None:
            flush()
            if info.match is not ALL:
                pending.append(info.match)
            continue
        if cur.exact is not None:
            joined = _concat(cur, info, ic)
            if joined.exact is not None:
                cur = joined
                continue
        flush()
        cur = info

    if not pending:
        return cur
    flush()
    return _Info(match=_and(pending))


def compile_trigram_query(pattern: str, flags: int = 0) -> TriQuery:
    """Compile `pattern` into a trigram AND/OR query that every string
    with an ``re.search`` match must satisfy.  Returns ALL (no index
    help) when the pattern cannot be constrained or fails to parse —
    the caller then falls back to a full scan + verify, matching the
    reference's behaviour for e.g. ``/.*/``."""
    try:
        tree = _sre.parse(pattern, flags)
    except Exception:
        return ALL
    # Inline global flags like (?i) land in the parse state, not in the
    # caller's flags — fold them in so the filter matches the verifier.
    eff = flags | getattr(getattr(tree, "state", None), "flags", 0)
    ic = bool(eff & re.IGNORECASE)
    try:
        info = _an_seq(list(tree), ic)
        return _matchq(info, ic)
    except Exception:
        return ALL
