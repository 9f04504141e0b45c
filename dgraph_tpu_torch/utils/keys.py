"""Storage key model.

Re-provides the reference's key taxonomy (x/keys.go:113-220: DataKey,
IndexKey, ReverseKey, CountKey, SchemaKey, TypeKey + split keys at
x/keys.go:450) with a canonical sortable binary encoding shared by the
Python store, the WAL, and the C++ storage backend.

Layout (byte-sortable, groups a predicate's keys contiguously like the
reference's Badger layout so tablet moves are range scans):

    [0x00][len(attr):u16BE][attr bytes][kind:u8][suffix]

    kind DATA    0x00  suffix = uid:u64BE
    kind REVERSE 0x01  suffix = uid:u64BE
    kind INDEX   0x02  suffix = token bytes (tokenizer ident prefixed)
    kind COUNT   0x03  suffix = count:u32BE [0x01 if reverse]
    kind SCHEMA  0x04  suffix = empty
    kind TYPE    0x05  suffix = empty (attr = type name)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

DATA = 0x00
REVERSE = 0x01
INDEX = 0x02
COUNT = 0x03
SCHEMA = 0x04
TYPE = 0x05

_KIND_NAMES = {DATA: "data", REVERSE: "reverse", INDEX: "index",
               COUNT: "count", SCHEMA: "schema", TYPE: "type"}


@dataclass(frozen=True)
class Key:
    attr: str
    kind: int
    uid: int = 0
    token: bytes = b""
    count: int = 0
    count_reverse: bool = False

    def pack(self) -> bytes:
        ab = self.attr.encode()
        head = b"\x00" + struct.pack(">H", len(ab)) + ab + bytes([self.kind])
        if self.kind in (DATA, REVERSE):
            return head + struct.pack(">Q", self.uid)
        if self.kind == INDEX:
            return head + self.token
        if self.kind == COUNT:
            return head + struct.pack(">I", self.count) + (
                b"\x01" if self.count_reverse else b"\x00")
        return head

    def __repr__(self):
        kind = _KIND_NAMES.get(self.kind, "?")
        extra = ""
        if self.kind in (DATA, REVERSE):
            extra = f" uid={self.uid:#x}"
        elif self.kind == INDEX:
            extra = f" token={self.token!r}"
        elif self.kind == COUNT:
            extra = f" count={self.count}"
        return f"<Key {kind}:{self.attr}{extra}>"


def data_key(attr: str, uid: int) -> Key:
    return Key(attr, DATA, uid=uid)


def reverse_key(attr: str, uid: int) -> Key:
    return Key(attr, REVERSE, uid=uid)


def index_key(attr: str, token: bytes) -> Key:
    return Key(attr, INDEX, token=token)


def count_key(attr: str, count: int, reverse: bool = False) -> Key:
    return Key(attr, COUNT, count=count, count_reverse=reverse)


def schema_key(attr: str) -> Key:
    return Key(attr, SCHEMA)


def type_key(name: str) -> Key:
    return Key(name, TYPE)


def unpack(raw: bytes) -> Key:
    if raw[0] != 0x00:
        raise ValueError("bad key prefix")
    (alen,) = struct.unpack_from(">H", raw, 1)
    attr = raw[3 : 3 + alen].decode()
    kind = raw[3 + alen]
    suffix = raw[4 + alen :]
    if kind in (DATA, REVERSE):
        (uid,) = struct.unpack(">Q", suffix)
        return Key(attr, kind, uid=uid)
    if kind == INDEX:
        return Key(attr, kind, token=suffix)
    if kind == COUNT:
        (count,) = struct.unpack_from(">I", suffix, 0)
        return Key(attr, kind, count=count, count_reverse=suffix[4] == 1)
    return Key(attr, kind)


def token_bytes(ident: int, token) -> bytes:
    """Index token -> bytes with tokenizer-identifier prefix so different
    tokenizers on one predicate never collide and sortable tokenizers
    keep byte order (ref tok/tok.go identifier bytes; int64 tokens use
    order-preserving offset encoding)."""
    if isinstance(token, int):
        return bytes([ident]) + struct.pack(">Q", token + (1 << 63))
    if isinstance(token, bytes):
        return bytes([ident]) + token
    return bytes([ident]) + str(token).encode()
