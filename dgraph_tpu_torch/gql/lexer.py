"""Query-language lexer.

The reference uses a Rob Pike-style state-function lexer (lex/lexer.go:42);
here a single master regex plus a token cursor gives the same token stream
with far less machinery — the parser is the interesting part.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class GQLError(ValueError):
    pass


@dataclass(frozen=True)
class Token:
    kind: str
    val: str
    pos: int
    line: int


_MASTER = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<comment>\#[^\n]*)
    | (?P<string>"(?:\\.|[^"\\])*")
    | (?P<spread>\.\.\.)
    | (?P<iri><[^>\s]*>)
    | (?P<hex>0[xX][0-9a-fA-F]+)
    | (?P<number>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+|-?\d+)
    | (?P<dollar>\$[A-Za-z_][\w]*)
    | (?P<name>[A-Za-z_~À-￿][\w.À-￿]*)
    | (?P<lbrace>\{) | (?P<rbrace>\})
    | (?P<lparen>\() | (?P<rparen>\))
    | (?P<lbracket>\[) | (?P<rbracket>\])
    | (?P<colon>:) | (?P<comma>,) | (?P<at>@) | (?P<pipe>\|)
    | (?P<op><=|>=|==|!=|[+\-*/%<>=!])
    | (?P<star>\*)
    | (?P<dot>\.)
    """,
    re.VERBOSE,
)


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    pos = 0
    line = 1
    n = len(text)
    while pos < n:
        # contextual regex literal, the reference's lexer-state trick
        # (lex/lexer.go regexp state): a '/' opening a function
        # argument (right after '(' or ',') starts /pattern/flags —
        # scanned manually so ^ $ \d \/ # and friends all pass
        # through; '/' anywhere else stays the division operator
        if text[pos] == "/" and toks and \
                toks[-1].kind in ("lparen", "comma"):
            tok, pos = _scan_regex(text, pos, line)
            toks.append(tok)
            continue
        m = _MASTER.match(text, pos)
        if m is None:
            raise GQLError(
                f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        val = m.group()
        line += val.count("\n")
        pos = m.end()
        if kind in ("ws", "comment"):
            continue
        if kind == "string":
            val = _unquote(val, line)
        elif kind == "iri":
            val = val[1:-1]
            kind = "name"
        toks.append(Token(kind, val, m.start(), line))
    toks.append(Token("eof", "", n, line))
    return toks


def _scan_regex(text: str, pos: int, line: int) -> tuple[Token, int]:
    """Scan /pattern/flags starting at the opening slash. The pattern
    body keeps its backslashes verbatim (the regex engine interprets
    them; \\/ escapes the delimiter, like the reference)."""
    i = pos + 1
    n = len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n:
            i += 2
            continue
        if c == "/":
            break
        if c == "\n":
            raise GQLError(
                f"line {line}: newline inside regex literal")
        i += 1
    else:
        raise GQLError(f"line {line}: unterminated regex literal")
    body = text[pos + 1 : i]
    i += 1
    flags = ""
    while i < n and text[i].isalpha():
        flags += text[i]
        i += 1
    return Token("regex", body + "\x00" + flags, pos, line), i


_ESCAPES = {
    '"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t", "r": "\r",
    "b": "\b", "f": "\f", "'": "'",
}


def _unquote(raw: str, line: int) -> str:
    body = raw[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            i += 1
            if i >= len(body):
                raise GQLError(f"line {line}: dangling escape in string")
            e = body[i]
            if e == "u":
                out.append(chr(int(body[i + 1 : i + 5], 16)))
                i += 4
            else:
                out.append(_ESCAPES.get(e, e))
        else:
            out.append(c)
        i += 1
    return "".join(out)


class Cursor:
    def __init__(self, toks: list[Token], src: str = ""):
        self.toks = toks
        self.src = src
        self.i = 0

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.peek()
        if t.kind == "eof":
            # consuming past the end must error, not return eof forever:
            # `while not accept(...)` loops would otherwise spin on
            # truncated input (found by the fuzz suite)
            raise GQLError(f"line {t.line}: unexpected end of input")
        self.i += 1
        return t

    def accept(self, kind: str, val: str | None = None) -> Token | None:
        t = self.peek()
        if t.kind == kind and (val is None or t.val == val):
            return self.next()
        return None

    def expect(self, kind: str, what: str = "") -> Token:
        t = self.next()
        if t.kind != kind:
            raise GQLError(
                f"line {t.line}: expected {what or kind}, got "
                f"{t.kind} {t.val!r}")
        return t
