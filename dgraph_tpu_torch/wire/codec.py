"""Tagged binary encoding (the pb.proto role: a stable record format).

Every value is `tag byte + payload`. Varints are LEB128; signed ints
zigzag. Strings are UTF-8, arrays raw little-endian. Dataclass records
(Val, Posting, EdgeOp, raft Entry/Msg) get their own tags with
positional fields — adding a field later means a new tag, old tags stay
decodable (the protobuf discipline, without the codegen).

Ref: protos/pb.proto Posting (:469), DirectedEdge, Proposal; codec
discipline: raftwal/storage.go encodes entries through proto too.

Port of `dgraph_tpu/wire/codec.py`: every tag encodes to the reference's
bytes and decodes into this package's classes (the raft Entry and Msg
into `cluster/raft`).
"""

from __future__ import annotations

import datetime as _dt
import struct
from typing import Any, BinaryIO

import numpy as np

WIRE_VERSION = 1


class WireError(ValueError):
    pass


# -- tags -------------------------------------------------------------------

T_NONE = 0x00
T_TRUE = 0x01
T_FALSE = 0x02
T_INT = 0x03
T_FLOAT = 0x04
T_STR = 0x05
T_BYTES = 0x06
T_LIST = 0x07
T_TUPLE = 0x08
T_DICT = 0x09
T_NDARRAY = 0x0A
T_DATETIME = 0x0B
T_DATE = 0x0C
T_VAL = 0x10
T_POSTING = 0x11
T_EDGEOP = 0x12
T_ENTRY = 0x13
T_MSG = 0x14


def _uvarint(out: bytearray, n: int):
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if -(1 << 63) <= n < (1 << 63) \
        else _big_zigzag(n)


def _big_zigzag(n: int) -> int:
    # arbitrary-precision fallback (uids are < 2^64; this is belt &
    # braces for e.g. huge math() artifacts that land in a Val).
    # Decode bounds varints at 126 shift bits — reject anything the
    # decoder could not read back, never write-then-brick.
    u = (n << 1) if n >= 0 else ((-n) << 1) - 1
    if u.bit_length() > 126:
        raise WireError(f"int too large to encode ({n.bit_length()} bits)")
    return u


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise WireError("truncated payload")
        self.pos += n
        return b

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise WireError("truncated payload")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        shift = 0
        n = 0
        while True:
            b = self.byte()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 126:
                raise WireError("varint too long")


# -- encode -----------------------------------------------------------------


def encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(T_NONE)
    elif obj is True:
        out.append(T_TRUE)
    elif obj is False:
        out.append(T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        out.append(T_INT)
        _uvarint(out, _zigzag(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(T_FLOAT)
        out += struct.pack("<d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(T_STR)
        _uvarint(out, len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(T_BYTES)
        _uvarint(out, len(obj))
        out += obj
    elif isinstance(obj, list):
        out.append(T_LIST)
        _uvarint(out, len(obj))
        for x in obj:
            encode(x, out)
    elif isinstance(obj, tuple):
        out.append(T_TUPLE)
        _uvarint(out, len(obj))
        for x in obj:
            encode(x, out)
    elif isinstance(obj, dict):
        out.append(T_DICT)
        _uvarint(out, len(obj))
        for k, v in obj.items():
            encode(k, out)
            encode(v, out)
    elif isinstance(obj, np.ndarray):
        out.append(T_NDARRAY)
        dt = obj.dtype.str  # e.g. '<u8' — endian-explicit
        db = dt.encode()
        _uvarint(out, len(db))
        out += db
        _uvarint(out, obj.ndim)
        for s in obj.shape:
            _uvarint(out, s)
        raw = np.ascontiguousarray(obj).tobytes()
        _uvarint(out, len(raw))
        out += raw
    elif isinstance(obj, _dt.datetime):
        out.append(T_DATETIME)
        s = obj.isoformat()
        b = s.encode()
        _uvarint(out, len(b))
        out += b
    elif isinstance(obj, _dt.date):
        out.append(T_DATE)
        b = obj.isoformat().encode()
        _uvarint(out, len(b))
        out += b
    else:
        enc = _RECORD_ENC.get(type(obj).__name__)
        if enc is None:
            raise WireError(
                f"wire: unencodable type {type(obj).__name__}")
        enc(obj, out)


def _enc_val(v, out: bytearray):
    out.append(T_VAL)
    _uvarint(out, int(v.tid))
    encode(v.value, out)


def _enc_posting(p, out: bytearray):
    out.append(T_POSTING)
    _enc_val(p.value, out)
    encode(p.lang, out)
    encode(p.facets, out)


def _enc_edgeop(e, out: bytearray):
    out.append(T_EDGEOP)
    encode(e.op, out)
    _uvarint(out, _zigzag(e.src))
    _uvarint(out, _zigzag(e.dst))
    encode(e.posting, out)
    encode(e.facets, out)


def _enc_entry(e, out: bytearray):
    out.append(T_ENTRY)
    _uvarint(out, e.term)
    _uvarint(out, e.index)
    encode(e.data, out)


_MSG_FIELDS = ("type", "frm", "to", "term", "last_log_index",
               "last_log_term", "granted", "prev_index", "prev_term",
               "entries", "commit", "success", "match_index",
               "reject_hint", "snap_index", "snap_term", "snap_data")


def _enc_msg(m, out: bytearray):
    out.append(T_MSG)
    for f in _MSG_FIELDS:
        encode(getattr(m, f), out)


_RECORD_ENC = {
    "Val": _enc_val,
    "Posting": _enc_posting,
    "EdgeOp": _enc_edgeop,
    "Entry": _enc_entry,
    "Msg": _enc_msg,
}


# -- decode -----------------------------------------------------------------


def decode(r: _Reader) -> Any:
    tag = r.byte()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _unzigzag(r.uvarint())
    if tag == T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == T_STR:
        return r.take(r.uvarint()).decode("utf-8")
    if tag == T_BYTES:
        return bytes(r.take(r.uvarint()))
    if tag == T_LIST:
        return [decode(r) for _ in range(r.uvarint())]
    if tag == T_TUPLE:
        return tuple(decode(r) for _ in range(r.uvarint()))
    if tag == T_DICT:
        return {decode(r): decode(r) for _ in range(r.uvarint())}
    if tag == T_NDARRAY:
        dt = np.dtype(r.take(r.uvarint()).decode())
        shape = tuple(r.uvarint() for _ in range(r.uvarint()))
        raw = r.take(r.uvarint())
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag == T_DATETIME:
        return _dt.datetime.fromisoformat(r.take(r.uvarint()).decode())
    if tag == T_DATE:
        return _dt.date.fromisoformat(r.take(r.uvarint()).decode())
    if tag == T_VAL:
        from dgraph_tpu_torch.models.types import TypeID, Val
        tid = TypeID(r.uvarint())
        return Val(tid, decode(r))
    if tag == T_POSTING:
        from dgraph_tpu_torch.storage.tablet import Posting
        val = decode(r)
        return Posting(val, decode(r), decode(r))
    if tag == T_EDGEOP:
        from dgraph_tpu_torch.storage.tablet import EdgeOp
        op = decode(r)
        src = _unzigzag(r.uvarint())
        dst = _unzigzag(r.uvarint())
        return EdgeOp(op, src, dst, decode(r), decode(r))
    if tag == T_ENTRY:
        from dgraph_tpu_torch.cluster.raft import Entry
        term = r.uvarint()
        index = r.uvarint()
        return Entry(term, index, decode(r))
    if tag == T_MSG:
        from dgraph_tpu_torch.cluster.raft import Msg
        kw = {f: decode(r) for f in _MSG_FIELDS}
        return Msg(**kw)
    raise WireError(f"wire: unknown tag {tag:#x}")


# -- public API -------------------------------------------------------------


def dumps(obj: Any) -> bytes:
    out = bytearray([WIRE_VERSION])
    encode(obj, out)
    return bytes(out)


def loads(data: bytes) -> Any:
    if not data:
        raise WireError("empty payload")
    if data[0] != WIRE_VERSION:
        raise WireError(f"wire version {data[0]} unsupported")
    r = _Reader(data, 1)
    obj = decode(r)
    return obj


def loads_compat(data: bytes) -> Any:
    """loads() with a pickle fallback for payloads written before the
    wire format existed (pickle's PROTO opcode is 0x80, which can never
    be a wire version byte). Use for durable artifacts that may predate
    the migration — raft snapshots, engine snapshot blobs."""
    if data[:1] == b"\x80":
        import pickle
        return pickle.loads(data)
    return loads(data)


# -- framing (TCP transport / file records) ---------------------------------

_FRAME_HDR = struct.Struct("<I")
MAX_FRAME = 1 << 30


def write_frame(sock_or_file, payload: bytes) -> None:
    """Length-prefixed frame; works on sockets (sendall) and files."""
    hdr = _FRAME_HDR.pack(len(payload))
    if hasattr(sock_or_file, "sendall"):
        sock_or_file.sendall(hdr + payload)
    else:
        sock_or_file.write(hdr + payload)


def _read_exact(src, n: int) -> bytes:
    if hasattr(src, "recv"):
        parts = []
        got = 0
        while got < n:
            b = src.recv(n - got)
            if not b:
                raise EOFError("peer closed")
            parts.append(b)
            got += len(b)
        return b"".join(parts)
    b = src.read(n)
    if len(b) != n:
        raise EOFError("short read")
    return b


def read_frame(src: BinaryIO) -> bytes:
    (n,) = _FRAME_HDR.unpack(_read_exact(src, _FRAME_HDR.size))
    if n > MAX_FRAME:
        raise WireError(f"frame too large ({n} bytes)")
    return _read_exact(src, n)
