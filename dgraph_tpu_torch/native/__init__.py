"""ctypes bindings for the host runtime (csrc/native.cc).

The device plane is PyTorch and CUDA; the runtime around it — the
storage engine (LSM KV store + WAL, the Badger/raftwal role:
posting/mvcc.go, raftwal/storage.go in the reference), the group-varint
UID codec (codec/codec.go), the RDF parser (chunker/rdf_parser.go), the
batch tokenizer (tok/tok.go), the columnar JSON row writer
(query/outputnode.go fastJsonNode), and the string-match and
merge-count loops (worker/match.go) — is C++.

Port of `dgraph_tpu/native/__init__.py`, with the same names and
behaviour over the port's own copy of the source. The library is built
with g++ into `build/dgraph_tpu_torch/` at first use (`ops/_build.py`:
a content-hashed name, a temporary file renamed into place), never at
import. Where the reference degrades to its pure-Python branches when
the build fails, the port raises with the compiler's output: a caller
takes a pure-Python branch only when it is switched off on purpose, by
patching `available` to return False, as the tests do.

Each binding counts the calls that reach its C entry in
`<binding>.calls` (the classes count opens), as the kernel wrappers
count launches, so a run can show which branches it took
(`call_counts`).
"""

from __future__ import annotations

import ctypes
import threading

from dgraph_tpu_torch.ops import _build

_lib = None
_lock = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _count(binding) -> None:
    """One more call of `binding`'s C entry."""
    with _COUNT_LOCK:
        binding.calls += 1


def _load():
    """The bound library, built and bound on the first call; raises if
    the build fails."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = _build.load("native")
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.dgt_kv_open.restype = ctypes.c_void_p
    lib.dgt_kv_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dgt_kv_put.restype = ctypes.c_int
    lib.dgt_kv_put.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                               u8p, ctypes.c_uint32]
    lib.dgt_kv_del.restype = ctypes.c_int
    lib.dgt_kv_del.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.dgt_kv_get.restype = ctypes.c_int64
    lib.dgt_kv_get.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                               u8p, ctypes.c_uint64]
    lib.dgt_kv_count.restype = ctypes.c_uint64
    lib.dgt_kv_count.argtypes = [ctypes.c_void_p]
    lib.dgt_kv_set_memtable.restype = None
    lib.dgt_kv_set_memtable.argtypes = [ctypes.c_void_p,
                                        ctypes.c_uint64]
    lib.dgt_kv_flush.restype = ctypes.c_int
    lib.dgt_kv_flush.argtypes = [ctypes.c_void_p]
    lib.dgt_kv_snapshot.restype = ctypes.c_int
    lib.dgt_kv_snapshot.argtypes = [ctypes.c_void_p]
    lib.dgt_kv_close.restype = None
    lib.dgt_kv_close.argtypes = [ctypes.c_void_p]
    lib.dgt_kv_iter.restype = ctypes.c_void_p
    lib.dgt_kv_iter.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.dgt_kv_iter_next.restype = ctypes.c_int
    lib.dgt_kv_iter_next.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, u64p,
        u8p, ctypes.c_uint64, u64p]
    lib.dgt_kv_iter_close.restype = None
    lib.dgt_kv_iter_close.argtypes = [ctypes.c_void_p]
    lib.dgt_wal_open.restype = ctypes.c_void_p
    lib.dgt_wal_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dgt_wal_append.restype = ctypes.c_int
    lib.dgt_wal_append.argtypes = [ctypes.c_void_p, u8p,
                                   ctypes.c_uint64]
    lib.dgt_wal_flush.restype = ctypes.c_int
    lib.dgt_wal_flush.argtypes = [ctypes.c_void_p]
    lib.dgt_wal_replay.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dgt_wal_replay.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.dgt_wal_truncate.restype = ctypes.c_int
    lib.dgt_wal_truncate.argtypes = [ctypes.c_void_p]
    lib.dgt_wal_close.restype = None
    lib.dgt_wal_close.argtypes = [ctypes.c_void_p]
    lib.dgt_free.restype = None
    lib.dgt_free.argtypes = [ctypes.c_void_p]
    # the codec's pointers pass as addresses and bytes objects (no
    # copy): a snapshot makes millions of calls on short lists
    lib.dgt_gv_encode.restype = ctypes.c_int64
    lib.dgt_gv_encode.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_void_p]
    lib.dgt_gv_decode.restype = ctypes.c_int64
    lib.dgt_gv_decode.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_void_p]
    lib.dgt_gv_count.restype = ctypes.c_uint64
    lib.dgt_gv_count.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.dgt_levenshtein.restype = ctypes.c_int32
    lib.dgt_levenshtein.argtypes = [u8p, ctypes.c_uint32, u8p,
                                    ctypes.c_uint32, ctypes.c_int32]
    lib.dgt_match_mask.restype = ctypes.c_int
    lib.dgt_match_mask.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_int32, u8p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, u8p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dgt_match_mask_idx.restype = ctypes.c_int
    lib.dgt_match_mask_idx.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_int32, u8p,
        i64p, i64p, ctypes.c_int64, u8p]
    lib.dgt_merge_count.restype = ctypes.c_int
    lib.dgt_merge_count.argtypes = [
        u64p, i64p, ctypes.c_int64, ctypes.c_int64, u64p, i64p]
    lib.dgt_tokenize_batch.restype = ctypes.c_int
    lib.dgt_tokenize_batch.argtypes = [
        u8p, u64p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        u64p,
        ctypes.POINTER(u64p), u64p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)), u64p,
        ctypes.POINTER(u64p)]
    lib.dgt_rdf_parse.restype = ctypes.c_int
    lib.dgt_rdf_parse.argtypes = [
        u8p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), u64p]
    lib.dgt_json_rows.restype = ctypes.c_int
    lib.dgt_json_rows.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64)]


def available() -> bool:
    """True once the library is built and bound (a failed build
    raises). Callers test it before each native branch; patching it to
    return False switches those branches off."""
    return _load() is not None


def _buf(b: bytes):
    return ctypes.cast(ctypes.create_string_buffer(b, len(b) or 1),
                       ctypes.POINTER(ctypes.c_uint8))


class NativeKV:
    """Ordered KV store with WAL durability + snapshot compaction.
    Crash recovery = snapshot load + WAL replay with torn-tail truncate
    (the contract Badger provides the reference)."""
    # dglint: guarded-by=*:external (the native layer has its own
    # internal locking for reads; writes arrive only on the engine's
    # serialized write path — Python-side handle state is set once in
    # __init__ and cleared only at close)

    def __init__(self, directory: str, sync: bool = False):
        lib = _load()
        self._lib = lib
        self._h = lib.dgt_kv_open(directory.encode(), 1 if sync else 0)
        _count(NativeKV)
        if not self._h:
            raise OSError(f"cannot open native kv store at {directory}")

    def put(self, key: bytes, val: bytes):
        if self._lib.dgt_kv_put(self._h, _buf(key), len(key),
                                _buf(val), len(val)) != 0:
            raise OSError("kv put failed")

    def delete(self, key: bytes):
        if self._lib.dgt_kv_del(self._h, _buf(key), len(key)) != 0:
            raise OSError("kv del failed")

    def get(self, key: bytes):
        # size-probe + copy are separate store calls; retry if a
        # concurrent writer grew the value in between.
        n = self._lib.dgt_kv_get(self._h, _buf(key), len(key), None, 0)
        while True:
            if n < 0:
                return None
            out = (ctypes.c_uint8 * max(n, 1))()
            m = self._lib.dgt_kv_get(self._h, _buf(key), len(key), out, n)
            if m < 0:
                return None
            if m <= n:
                # string_at copies the buffer once; the reference's
                # bytes(out[:m]) goes through a list of m ints
                return ctypes.string_at(out, m)
            n = m

    def __len__(self):
        return self._lib.dgt_kv_count(self._h)

    def scan(self, prefix: bytes = b""):
        """Yields (key, value) over a stable snapshot, key-ordered."""
        it = self._lib.dgt_kv_iter(self._h, _buf(prefix), len(prefix))
        try:
            klen = ctypes.c_uint64()
            vlen = ctypes.c_uint64()
            while self._lib.dgt_kv_iter_next(
                    it, None, 0, ctypes.byref(klen),
                    None, 0, ctypes.byref(vlen)) == 0:
                kout = (ctypes.c_uint8 * max(klen.value, 1))()
                vout = (ctypes.c_uint8 * max(vlen.value, 1))()
                self._lib.dgt_kv_iter_next(
                    it, kout, klen.value, ctypes.byref(klen),
                    vout, vlen.value, ctypes.byref(vlen))
                yield (ctypes.string_at(kout, klen.value),
                       ctypes.string_at(vout, vlen.value))
        finally:
            self._lib.dgt_kv_iter_close(it)

    def flush(self):
        self._lib.dgt_kv_flush(self._h)

    def snapshot(self):
        """Durability point: flush the memtable to a run and fully
        compact the runs into one, truncating the WAL (the LSM's
        replacement for the old whole-store SNAPSHOT dump)."""
        if self._lib.dgt_kv_snapshot(self._h) != 0:
            raise OSError("kv snapshot failed")

    def set_memtable(self, nbytes: int):
        """Lower/raise the memtable flush threshold (default 64MB, or
        DGT_KV_MEMTABLE_BYTES at open)."""
        self._lib.dgt_kv_set_memtable(self._h, nbytes)

    def close(self):
        if self._h:
            self._lib.dgt_kv_close(self._h)
            self._h = None


class NativeWal:
    """Append-only CRC-framed record log (the raftwal/storage.go role)."""

    def __init__(self, path: str, sync: bool = False):
        lib = _load()
        self._lib = lib
        self._h = lib.dgt_wal_open(path.encode(), 1 if sync else 0)
        _count(NativeWal)
        if not self._h:
            from dgraph_tpu_torch.storage.wal import raise_if_legacy_wal
            raise_if_legacy_wal(path)
            raise OSError(f"cannot open wal at {path}")

    def append(self, payload: bytes):
        if self._lib.dgt_wal_append(self._h, _buf(payload),
                                    len(payload)) != 0:
            raise OSError("wal append failed")

    def flush(self):
        self._lib.dgt_wal_flush(self._h)

    def replay(self):
        """All valid records in order (truncates any torn tail)."""
        total = ctypes.c_uint64()
        count = ctypes.c_uint64()
        buf = self._lib.dgt_wal_replay(self._h, ctypes.byref(total),
                                       ctypes.byref(count))
        records = []
        if buf and total.value:
            raw = ctypes.string_at(buf, total.value)
            off = 0
            for _ in range(count.value):
                ln = int.from_bytes(raw[off:off + 8], "little")
                records.append(raw[off + 8: off + 8 + ln])
                off += 8 + ln
        if buf:
            self._lib.dgt_free(buf)
        return records

    def truncate(self):
        if self._lib.dgt_wal_truncate(self._h) != 0:
            raise OSError("wal truncate failed")

    def close(self):
        if self._h:
            self._lib.dgt_wal_close(self._h)
            self._h = None


def gv_encode(uids) -> bytes:
    """Sorted uint64 array -> group-varint delta stream."""
    import numpy as np
    lib = _load()
    a = np.ascontiguousarray(uids, dtype=np.uint64)
    out = ctypes.create_string_buffer(16 + len(a) * 9)
    n = lib.dgt_gv_encode(a.__array_interface__["data"][0], len(a), out)
    _count(gv_encode)
    if n < 0:
        raise ValueError("gv encode failed")
    return ctypes.string_at(out, n)


def gv_decode(buf: bytes):
    """group-varint delta stream -> uint64 numpy array."""
    import numpy as np
    lib = _load()
    buf = bytes(buf)
    n = lib.dgt_gv_count(buf, len(buf))
    out = np.empty(int(n), dtype=np.uint64)
    got = lib.dgt_gv_decode(buf, len(buf), out.__array_interface__["data"][0])
    _count(gv_decode)
    if got < 0:
        raise ValueError("gv decode: malformed stream")
    return out[:got]


def levenshtein(a: str, b: str, max_d: int) -> int:
    """Bounded edit distance; > max_d reported as max_d + 1."""
    lib = _load()
    ab = a.encode("utf-8", "surrogatepass")
    bb = b.encode("utf-8", "surrogatepass")
    _count(levenshtein)
    return lib.dgt_levenshtein(_buf(ab), len(ab), _buf(bb), len(bb),
                               max_d)


# column type tags for json_rows (mirror native.cc dgt_json_rows)
JCOL_INT = 0
JCOL_FLOAT = 1
JCOL_BOOL = 2
JCOL_STR = 3
JCOL_UID = 4


def json_rows(n_rows: int, cols) -> "bytes | None":
    """Serialize typed columns into a JSON array of row objects — the
    query-result fast path (ref query/outputnode.go fastJsonNode, a
    documented reference hot loop). `cols` is a list of
    (name: str, type: JCOL_*, data: np.ndarray, offsets: np.ndarray
    | None, present: np.ndarray(uint8) | None). Returns the serialized
    bytes, or None when the C entry refuses the columns (callers fall
    back to dict + json.dumps). As in the reference, this entry does
    not consult `available`."""
    lib = _load()
    import numpy as np
    n_cols = len(cols)
    names = (ctypes.c_char_p * n_cols)()
    types = (ctypes.c_int32 * n_cols)()
    data = (ctypes.c_void_p * n_cols)()
    offsets = (ctypes.POINTER(ctypes.c_int64) * n_cols)()
    present = (ctypes.POINTER(ctypes.c_uint8) * n_cols)()
    keep = []  # hold refs so buffers outlive the call
    for i, (name, t, d, off, pres) in enumerate(cols):
        nb = name.encode("utf-8")
        keep.append(nb)
        names[i] = nb
        types[i] = t
        d = np.ascontiguousarray(d)
        keep.append(d)
        data[i] = d.ctypes.data_as(ctypes.c_void_p)
        if off is not None:
            off = np.ascontiguousarray(off, dtype=np.int64)
            keep.append(off)
            offsets[i] = off.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64))
        if pres is not None:
            pres = np.ascontiguousarray(pres, dtype=np.uint8)
            keep.append(pres)
            present[i] = pres.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8))
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.dgt_json_rows(n_rows, n_cols, names, types, data, offsets,
                           present, ctypes.byref(out),
                           ctypes.byref(out_len))
    _count(json_rows)
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.dgt_free(out)


def match_mask(term_lower: bytes, max_d: int, blob, offsets) -> "object":
    """Batched fuzzy-match verify: uint8 mask per value (1 = within
    max_d of the pre-lowercased term, 0 = no, 2 = non-ASCII value the
    caller must re-verify with Python lowercasing)."""
    lib = _load()
    import numpy as np
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    out = np.zeros(max(n, 1), np.uint8)
    lib.dgt_match_mask(
        _buf(term_lower), len(term_lower), max_d,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    _count(match_mask)
    return out[:n]


def match_mask_idx(term_lower: bytes, max_d: int, blob, offsets,
                   idx) -> "object":
    """match_mask over SELECTED rows of a cached whole-column payload
    blob."""
    lib = _load()
    import numpy as np
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    out = np.zeros(max(n, 1), np.uint8)
    lib.dgt_match_mask_idx(
        _buf(term_lower), len(term_lower), max_d,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    _count(match_mask_idx)
    return out[:n]


def merge_count(buckets: "list", need: int) -> "object":
    """uids appearing in >= need of the given SORTED uid buckets, via
    one k-way linear merge (no concatenate+sort). None when the C entry
    refuses the input."""
    lib = _load()
    import numpy as np
    offs = np.zeros(len(buckets) + 1, np.int64)
    np.cumsum([len(b) for b in buckets], out=offs[1:])
    total = int(offs[-1])
    if total == 0:
        return np.empty(0, np.uint64)
    vals = np.empty(total, np.uint64)
    for i, b in enumerate(buckets):
        vals[offs[i]:offs[i + 1]] = b
    out = np.empty(total, np.uint64)
    out_n = ctypes.c_int64(0)
    rc = lib.dgt_merge_count(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(buckets), need,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(out_n))
    _count(merge_count)
    if rc != 0:
        return None
    return out[:out_n.value].copy()


# dgt_tokenize_batch mode bits (mirror native.cc)
TOK_TERM = 1
TOK_TRIGRAM = 2
TOK_FULLTEXT_EN = 4
TOK_EXACT = 8


def tokenize_batch(payload, offsets, mode: int, idents) -> "object":
    """Batched ASCII tokenization for index builds (ref tok/tok.go
    built-in tokenizers; native.cc dgt_tokenize_batch).  `payload` is
    the concatenated utf-8 (ASCII-only) values, `offsets` a uint64
    array of n+1 boundaries, `idents` the (term, trigram, fulltext,
    exact) identifier bytes.  Returns (tokens: list[bytes] with ident
    prefixes, groups: list[np.uint32 value-index arrays]); tokens are
    UNIQUE and each group is ascending, but the token list is NOT
    globally sorted (short-packed tokens precede long ones — the C
    sort runs per partition).  None when the C entry refuses the
    input."""
    lib = _load()
    import numpy as np
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    n = len(offsets) - 1
    u8pp = ctypes.POINTER(ctypes.c_uint8)
    u64pp = ctypes.POINTER(ctypes.c_uint64)
    tok_out = u8pp()
    tok_len = ctypes.c_uint64()
    tok_offs = u64pp()
    n_toks = ctypes.c_uint64()
    val_idx = ctypes.POINTER(ctypes.c_uint32)()
    n_pairs = ctypes.c_uint64()
    bounds = u64pp()
    rc = lib.dgt_tokenize_batch(
        payload.ctypes.data_as(u8pp),
        offsets.ctypes.data_as(u64pp),
        n, mode, idents[0], idents[1], idents[2], idents[3],
        ctypes.byref(tok_out), ctypes.byref(tok_len),
        ctypes.byref(tok_offs), ctypes.byref(n_toks),
        ctypes.byref(val_idx), ctypes.byref(n_pairs),
        ctypes.byref(bounds))
    _count(tokenize_batch)
    if rc != 0:
        return None
    try:
        nt = n_toks.value
        npair = n_pairs.value
        toks_b = ctypes.string_at(tok_out, tok_len.value)
        offs = np.ctypeslib.as_array(tok_offs, shape=(nt + 1,)).copy()
        bnds = np.ctypeslib.as_array(bounds, shape=(nt + 1,)).copy()
        vidx = np.ctypeslib.as_array(
            val_idx, shape=(max(npair, 1),))[:npair].copy()
        tokens = [toks_b[offs[i]:offs[i + 1]] for i in range(nt)]
        groups = [vidx[bnds[i]:bnds[i + 1]] for i in range(nt)]
        return tokens, groups
    finally:
        lib.dgt_free(tok_out)
        lib.dgt_free(tok_offs)
        lib.dgt_free(val_idx)
        lib.dgt_free(bounds)


class ParsedRdf:
    """Columnar result of dgt_rdf_parse (see native.cc blob layout):
    edge rows, literal rows, interned pred/lang/dtype tables, and the
    fallback line spans the python grammar must parse."""

    __slots__ = ("edges", "vals", "fallback", "preds", "langs",
                 "dtypes")

    def __init__(self, edges, vals, fallback, preds, langs, dtypes):
        self.edges = edges        # (subj, pred_id, dst, fac_start, fac_len)
        self.vals = vals          # (subj, pred_id, lit_start, lit_len,
        #                            flags, lang_id, dtype_id,
        #                            fac_start, fac_len)
        self.fallback = fallback  # (start, len) line spans
        self.preds = preds
        self.langs = langs
        self.dtypes = dtypes


def rdf_parse(text: bytes) -> "ParsedRdf | None":
    """Parse an N-Quad text chunk natively; None when the C entry
    refuses the chunk.  Lines outside the fast grammar come back as
    spans in .fallback — the caller routes them through
    gql.nquad.parse_rdf."""
    lib = _load()
    import numpy as np
    blob_p = ctypes.POINTER(ctypes.c_uint8)()
    blob_len = ctypes.c_uint64()
    buf = np.frombuffer(text, np.uint8)
    rc = lib.dgt_rdf_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(text),
        ctypes.byref(blob_p), ctypes.byref(blob_len))
    _count(rdf_parse)
    if rc != 0:
        return None
    try:
        raw = np.frombuffer(
            ctypes.string_at(blob_p, blob_len.value), np.uint64)
        n_e, n_v, n_fb, n_p, n_l, n_d, pb, lb, db = raw[:9].tolist()
        o = 9

        def take(n):
            nonlocal o
            a = raw[o:o + n]
            o += n
            return a

        edges = tuple(take(n_e) for _ in range(5))
        vals = tuple(take(n_v) for _ in range(9))
        fallback = (take(n_fb), take(n_fb))

        def table(n, nbytes):
            nonlocal o
            offs = take(n + 1)
            bview = raw[o:o + (nbytes + 7) // 8].tobytes()[:nbytes]
            o += (nbytes + 7) // 8
            return [bview[offs[i]:offs[i + 1]].decode("utf-8")
                    for i in range(n)]

        preds = table(n_p, pb)
        langs = table(n_l, lb)
        dtypes = table(n_d, db)
        return ParsedRdf(edges, vals, fallback, preds, langs, dtypes)
    finally:
        lib.dgt_free(blob_p)


_BINDINGS = (NativeKV, NativeWal, gv_encode, gv_decode, levenshtein,
             json_rows, match_mask, match_mask_idx, merge_count,
             tokenize_batch, rdf_parse)
for _b in _BINDINGS:
    _b.calls = 0
del _b


def call_counts() -> dict:
    """Calls (opens, for the classes) of each binding in this process
    so far, by its name."""
    return {b.__name__: b.calls for b in _BINDINGS}


def reset_calls() -> None:
    """Every binding's count back to 0."""
    with _COUNT_LOCK:
        for b in _BINDINGS:
            b.calls = 0
