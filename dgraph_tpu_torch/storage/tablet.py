"""Per-predicate MVCC tablet.

Equivalent of the reference's posting-list layer for one predicate
(posting/list.go List + posting/index.go index/reverse/count upkeep), with
the storage model inverted for TPU residency:

  reference: Badger key per (pred, uid), immutable pack + per-txn deltas,
             iterator merges layers at read time (posting/list.go:559)
  here:      one Tablet per pred = base state (numpy dicts, rolled up at
             base_ts) + commit-ts-stamped delta overlay; reads at read_ts
             overlay deltas in (base_ts, read_ts]; rollup folds the
             overlay forward and re-packs device tiles (ops/graph.py)

Indexes (token->uids), reverse edges and counts are maintained
transactionally inside the same commit apply, mirroring
posting.AddMutationWithIndex (posting/index.go:377): an overwrite of a
single-valued indexed predicate first emits deletes for the old value's
tokens.

Port of `dgraph_tpu/storage/tablet.py`. The host state is numpy, as in
the reference. A tablet carries its engine's `device` (None: the card):
the vector index (storage/vecstore.py) and the device tiles
(engine/device_cache.py) are built there. `rebuild_index` tokenizes
ASCII string postings through the host runtime's batch tokenizer
(`native.tokenize_batch`) and the rest in Python, as the reference
does; with the runtime switched off it tokenizes all in Python, which
gives the same posting lists in another token order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from dgraph_tpu_torch.models.schema import PredicateSchema
from dgraph_tpu_torch.models.tokenizer import get_tokenizer, tokens_for
from dgraph_tpu_torch.models.types import (
    TypeID, Val, convert, sort_key, value_fingerprint,
)
from dgraph_tpu_torch.utils import failpoint
from dgraph_tpu_torch.utils.keys import token_bytes

_EMPTY = np.empty(0, dtype=np.uint64)


class ValueColumns:
    # dglint: guarded-by=*:external (owned by a Tablet; shares its
    # externally-synchronized discipline)
    """Columnar view of a scalar tablet's untagged values (the JSON
    fast path's input). Iterable as (srcs, tid, data, enc) and exposes
    .nbytes so DeviceCacheLRU can budget/evict it like a device tile —
    string payload copies are NOT free host memory.

    For string tablets, `extra_srcs`/`extra_enc` carry every
    LANG-TAGGED payload (absent from the untagged column) so batch
    scans like match() cover the full posting surface without a
    per-uid host pass; extra_ok=False marks a tablet whose tagged
    values defied encoding — batch consumers must fall back."""

    host_resident = True  # tile LRU: host bytes, never HBM

    __slots__ = ("srcs", "tid", "data", "enc", "nbytes",
                 "extra_srcs", "extra_enc", "extra_ok", "_ascii",
                 "_codes", "dt_secs", "dt_objs", "_blob",
                 "_sort_safe", "_bytes", "_dec")

    def __init__(self, srcs, tid, data, enc,
                 extra_srcs=None, extra_enc=None, extra_ok=True):
        self.srcs = srcs
        self.tid = tid
        self.data = data
        self.enc = enc
        self._codes = None
        self._blob = None
        self._sort_safe = None
        self._bytes = None
        self._dec = None
        # DATETIME tablets also carry the numeric column (float epoch
        # seconds, the dict math path's float() domain) plus the exact
        # datetime objects for var materialization
        self.dt_secs = None
        self.dt_objs = None
        self.extra_srcs = extra_srcs if extra_srcs is not None \
            else np.empty(0, np.uint64)
        self.extra_enc = extra_enc or []
        self.extra_ok = extra_ok
        self._ascii = None
        self.nbytes = int(srcs.nbytes) \
            + (int(data.nbytes) if data is not None else 0) \
            + (sum(len(e) + 49 for e in enc) if enc else 0) \
            + int(self.extra_srcs.nbytes) \
            + sum(len(e) + 49 for e in self.extra_enc)

    @property
    def ascii_only(self) -> bool:
        """Bytes-level regex over the payloads is only str-equivalent
        when every payload is ASCII ('.' must mean one codepoint).
        Computed lazily: only the regexp batch reads it, and the scan
        is O(total payload bytes)."""
        if self._ascii is None:
            self._ascii = all(e.isascii() for e in self.enc or []) \
                and all(e.isascii() for e in self.extra_enc)
        return self._ascii

    def __iter__(self):
        return iter((self.srcs, self.tid, self.data, self.enc))

    def payload_blob(self):
        """(uint8 blob, int64 offsets) of the payload column, joined
        ONCE per view lifetime — batch scanners (match, regexp) index
        into it instead of rebuilding python byte lists per query."""
        if self._blob is None:
            offs = np.zeros(len(self.enc or ()) + 1, np.int64)
            if self.enc:
                np.cumsum([len(e) for e in self.enc], out=offs[1:])
                blob = np.frombuffer(b"".join(self.enc), np.uint8)
            else:
                blob = np.zeros(1, np.uint8)
            self._blob = (blob, offs)
        return self._blob

    def enc_codes(self):
        """(codes int64 aligned to srcs, table: code -> bytes) for the
        string/datetime payload column — np fixed-width-bytes unique
        (C-order compare) instead of a per-row python dict pass, which
        was most of the 21M groupby-by-string profile. Cached for the
        colview's lifetime (per base_ts, like the view itself).
        Returns None when payloads carry trailing NULs ('S' dtype
        strips them, so codes would conflate distinct values)."""
        if self._codes is not None:
            return self._codes or None
        if not self.enc:
            self._codes = (np.empty(0, np.int64), [])
            return self._codes
        arr = np.asarray(self.enc, dtype=np.bytes_)
        uniq, codes = np.unique(arr, return_inverse=True)
        table = uniq.tolist()  # strips trailing NULs
        lens = np.fromiter((len(e) for e in self.enc),
                           np.int64, len(self.enc))
        tlens = np.asarray([len(t) for t in table], np.int64)
        if not np.array_equal(tlens[codes], lens):
            self._codes = False  # NUL-tailed payloads: exact path
            return None
        self._codes = (codes.astype(np.int64), table)
        return self._codes

    def decoded(self) -> list:
        """Payloads decoded back to str, ONCE per view lifetime — the
        emission paths gather from this instead of re-decoding the
        same bytes on every query (enc came from str.encode, so the
        round-trip cannot fail)."""
        if self._dec is None:
            self._dec = [e.decode("utf-8") for e in self.enc or ()]
        return self._dec

    # fixed-width byte matrices are rows x WIDEST payload: bound the
    # footprint so one multi-KB outlier payload can't inflate a
    # million-row column into gigabytes on the first string compare
    _BYTES_COL_CAP = 64 << 20

    def bytes_column(self):
        """(untagged 'S' array aligned to srcs, extra 'S' array aligned
        to extra_srcs) for vectorized string compares: UTF-8 byte order
        equals codepoint order, so fixed-width byte comparisons ARE the
        host loop's str comparisons. None when any payload embeds a NUL
        byte — the 'S' dtype strips trailing NULs, which would conflate
        distinct values — or when the rows x max-width matrix would
        exceed the footprint cap. Cached for the view's lifetime."""
        if self._bytes is not None:
            return self._bytes or None
        wid = max((len(e) for e in self.enc or ()), default=1)
        ewid = max((len(e) for e in self.extra_enc), default=1)
        if len(self.enc or ()) * wid > self._BYTES_COL_CAP \
                or len(self.extra_enc) * ewid > self._BYTES_COL_CAP:
            self._bytes = False
            return None
        if any(b"\x00" in e for e in self.enc or ()) \
                or any(b"\x00" in e for e in self.extra_enc):
            self._bytes = False
            return None
        main = np.asarray(self.enc, np.bytes_) if self.enc \
            else np.empty(0, "S1")
        extra = np.asarray(self.extra_enc, np.bytes_) \
            if self.extra_enc else np.empty(0, "S1")
        self._bytes = (main, extra)
        return self._bytes

    def enc_sort_safe(self) -> bool:
        """True when sorting the DECODED payload strings by
        str((v,)) — the groupby output-ordering contract — equals
        sorting the raw bytes: every byte printable ASCII with no
        quote/backslash, so repr() wraps each value identically and
        UTF-8 byte order is codepoint order. Cached per view."""
        if self._sort_safe is None:
            if not self.enc:
                self._sort_safe = True
            else:
                # bytes must be STRICTLY above the closing quote 0x27
                # that str((v,)) appends: with any byte below it, a
                # value that extends a shorter prefix ("New York" vs
                # "New") sorts after the prefix in byte order but
                # BEFORE it in the quoted contract order
                b = np.frombuffer(b"".join(self.enc), np.uint8)
                self._sort_safe = bool(
                    ((b > 0x27) & (b < 127) & (b != 0x5C)).all())
        return self._sort_safe


class TokenIndexCSR:
    """CSR export of a clean tablet's token index: every posting list
    concatenated into ONE sorted-run uid buffer with per-token offsets,
    so a k-token probe is k dict hits + k contiguous slices feeding one
    k-way merge (ops/setops) — no per-token overlay generators, no
    k-1 incremental union re-sorts.  The reference's UidPack blocks
    play the same role for its posting iterator (codec/codec.go:43).

    Exposes .nbytes so DeviceCacheLRU budgets it like a device tile."""

    host_resident = True

    __slots__ = ("rows", "offsets", "uids", "nbytes",
                 "posting_nbytes")

    def __init__(self, index: dict[bytes, np.ndarray]):
        toks = list(index.keys())
        self.rows = {t: i for i, t in enumerate(toks)}
        self.offsets = np.zeros(len(toks) + 1, np.int64)
        if toks:
            np.cumsum([len(index[t]) for t in toks],
                      out=self.offsets[1:])
            self.uids = np.concatenate(
                [np.asarray(index[t], np.uint64) for t in toks]) \
                if int(self.offsets[-1]) else _EMPTY.copy()
        else:
            self.uids = _EMPTY.copy()
        # posting bytes (the uid plane) apart from the token-key map,
        # which every index export carries identically — the
        # compressed-vs-dense comparison the bench gates on
        self.posting_nbytes = int(self.uids.nbytes) \
            + int(self.offsets.nbytes)
        self.nbytes = self.posting_nbytes \
            + sum(len(t) + 49 for t in toks)

    def probe(self, token: bytes) -> np.ndarray:
        """The token's sorted posting slice (empty when absent)."""
        i = self.rows.get(token)
        if i is None:
            return _EMPTY
        return self.uids[int(self.offsets[i]): int(self.offsets[i + 1])]


class CompressedTokenIndex:
    """Hybrid compressed export of a clean tablet's token index —
    sized by WHERE the bytes are, not by token count: real token
    indexes are zipfian (at the bench regime ~74% of tokens are
    singletons while ~80% of the uids live in the few hundred long
    posting lists), so

      * posting lists >= PACK_MIN uids become
        ops/codec.CompressedPack operands (adaptive array / bitmap /
        run blocks, ~2 B/uid and far below on runny lists) — set
        algebra runs on the compressed forms with block-descriptor
        skipping (ops/setops pack + mixed kernels);
      * the long tail of tiny lists stays one shared dense CSR
        buffer: per-token roaring descriptors would cost MORE than
        the 8 B/uid they replace, and a zero-copy slice keeps the
        many-token probes (trigram OR-trees, geo cell covers) at
        dense-tier speed.

    The tile LRU budgets this object by the resulting (mostly
    compressed) byte size.  The reference keeps the same split:
    group-varint UidPacks at rest (codec/codec.go), algo/uidlist.go
    intersecting block by block."""

    host_resident = True

    # below this posting-list length the roaring descriptor overhead
    # exceeds the dense bytes it saves; measured crossover on the
    # bench index shapes (bench_micro --setops-compressed)
    PACK_MIN = 128

    __slots__ = ("packs", "rows", "offsets", "uids", "nbytes",
                 "posting_nbytes")

    def __init__(self, index: dict[bytes, np.ndarray]):
        from dgraph_tpu_torch.ops import codec as _codec
        self.packs = {}
        small: dict[bytes, np.ndarray] = {}
        for t, uids in index.items():
            if len(uids) >= self.PACK_MIN:
                self.packs[t] = _codec.compress(uids)
            else:
                small[t] = uids
        toks = list(small.keys())
        self.rows = {t: i for i, t in enumerate(toks)}
        self.offsets = np.zeros(len(toks) + 1, np.int64)
        if toks:
            np.cumsum([len(small[t]) for t in toks],
                      out=self.offsets[1:])
            self.uids = np.concatenate(
                [np.asarray(small[t], np.uint64) for t in toks]) \
                if int(self.offsets[-1]) else _EMPTY.copy()
        else:
            self.uids = _EMPTY.copy()
        self.posting_nbytes = \
            sum(p.nbytes for p in self.packs.values()) \
            + int(self.uids.nbytes) + int(self.offsets.nbytes)
        self.nbytes = self.posting_nbytes \
            + sum(len(t) + 49 for t in index)

    def probe_operand(self, token: bytes):
        """The token's set-algebra operand: a CompressedPack for long
        lists, a zero-copy dense slice for the small-list tail, None
        when absent — ops/setops' mixed kernels take either form."""
        p = self.packs.get(token)
        if p is not None:
            return p
        i = self.rows.get(token)
        if i is None:
            return None
        return self.uids[int(self.offsets[i]): int(self.offsets[i + 1])]

    def probe(self, token: bytes) -> np.ndarray:
        """Densified posting list (small tokens: the shared-buffer
        slice; packed tokens: a fresh decode).  A sanctioned DG09
        decode site: consumers that can, should use probe_operand."""
        op = self.probe_operand(token)
        if op is None:
            return _EMPTY
        if isinstance(op, np.ndarray):
            return op
        return op.densify()


class OrderPermutation:
    """One cached (key, uid)-sorted view of a sort-key column:
    `uids` in emission order, `perm` the permutation back into
    sort_key_arrays. Exposes .nbytes for the tile LRU."""

    host_resident = True

    __slots__ = ("uids", "perm", "nbytes")

    def __init__(self, uids: np.ndarray, perm: np.ndarray):
        self.uids = uids
        self.perm = perm
        self.nbytes = int(uids.nbytes) + int(perm.nbytes)


@dataclass
class Posting:
    """One value posting. Ref pb.Posting (value side)."""

    value: Val
    lang: str = ""
    facets: dict = field(default_factory=dict)


@dataclass
class EdgeOp:
    """One committed operation inside a tablet. op: 'set' | 'del' |
    'del_all' (S P * wildcard)."""

    op: str
    src: int
    dst: int = 0                       # uid objects
    posting: Optional[Posting] = None  # value objects
    facets: dict = field(default_factory=dict)


def _ins(arr: np.ndarray, uid: int) -> np.ndarray:
    i = np.searchsorted(arr, uid)
    if i < len(arr) and arr[i] == uid:
        return arr
    return np.insert(arr, i, uid)


def _rm(arr: np.ndarray, uid: int) -> np.ndarray:
    i = np.searchsorted(arr, uid)
    if i < len(arr) and arr[i] == uid:
        return np.delete(arr, i)
    return arr


class Tablet:
    # dglint: guarded-by=*:external (tablets are engine data-plane
    # state: mutated only by the raft-apply/write path, read under
    # the server's rw read lock — synchronization lives a layer up,
    # see GraphDB; racecheck witnesses contract violations)
    def __init__(self, pred: str, schema: PredicateSchema,
                 device=None):
        self.pred = pred
        self.schema = schema
        # where this tablet's vector index and device tiles live (a
        # torch device or its name; None: the card)
        self.device = device
        self.base_ts = 0
        # base state (committed, <= base_ts)
        self.edges: dict[int, np.ndarray] = {}        # src -> sorted dst u64
        self.reverse: dict[int, np.ndarray] = {}      # dst -> sorted src u64
        self.values: dict[int, list[Posting]] = {}    # src -> postings
        self.index: dict[bytes, np.ndarray] = {}      # token -> sorted uids
        self.edge_facets: dict[tuple[int, int], dict] = {}
        # delta overlay: ts-ascending op lists
        self.deltas: list[tuple[int, list[EdgeOp]]] = []
        self.max_commit_ts = 0
        # per-uid overlay index (lazily built, extended on apply,
        # dropped on rollup): without it every per-uid read scans the
        # WHOLE visible overlay — O(total ops) per get_postings call,
        # which dominated profiles on bulk-mutated, un-rolled stores
        self._ov_by_src: dict[int, list] | None = None
        self._ov_by_dst: dict[int, list] | None = None
        self._ov_della: list | None = None
        # device snapshot cache (built lazily; see engine/device_cache —
        # residency is budgeted by the engine's DeviceCacheLRU)
        self._device_adj = None
        self._device_values = None
        self._device_adj_ts = -1
        # query-path lookups since boot (executor._tablet bumps it):
        # the stats plane's "hottest tablets" signal. A plain int —
        # GIL-atomic enough for a statistic, never for correctness.
        self.touches = 0

    # -- schema helpers --
    @property
    def is_uid(self) -> bool:
        return self.schema.value_type == TypeID.UID

    def _converted(self, p: Posting) -> Val:
        want = self.schema.value_type
        if want in (TypeID.DEFAULT,):
            return p.value
        return convert(p.value, want)

    def _tokens(self, p: Posting) -> list[bytes]:
        out = []
        for tname in self.schema.tokenizers:
            spec = get_tokenizer(tname)
            for t in tokens_for(p.value, spec, p.lang):
                out.append(token_bytes(spec.ident, t))
        return out

    # -- commit application (engine's apply loop calls this) --

    def apply(self, commit_ts: int, ops: list[EdgeOp]):
        """Append a committed delta. Ops are expanded with the implicit
        index/reverse maintenance (old-value token deletes etc.) at apply
        time so the overlay is self-contained for reads.

        Commits MUST apply in ts order: overlay consumers early-break
        on the ts-sorted deltas, and single-value overwrite expansion
        (del old + set new) is computed against apply-time state.  The
        service layer guarantees the order by applying decided 2PC
        finalizes sorted by commit_ts (_apply_finalizes); a violation
        here must surface as a hard error, never a silent mis-ordered
        append (a stripped assert once let a racing finalize lose a
        committed bank credit)."""
        # chaos seam: an armed `tablet.apply` failpoint delays or
        # fails a commit delta landing (the reference's Jepsen runs
        # surface the same window by killing alphas mid-apply)
        failpoint.fire("tablet.apply")
        if self.deltas and commit_ts <= self.max_commit_ts:
            raise RuntimeError(
                f"out-of-order commit apply: ts {commit_ts} after "
                f"{self.max_commit_ts} on tablet {self.pred!r}")
        self.deltas.append((commit_ts, ops))
        self.max_commit_ts = max(self.max_commit_ts, commit_ts)
        if self._ov_by_src is not None:
            self._ov_extend(commit_ts, ops)

    # -- overlay index upkeep --

    def _ov_extend(self, ts: int, ops: list[EdgeOp]):
        for idx, op in enumerate(ops):
            entry = (ts, idx, op)
            self._ov_by_src.setdefault(op.src, []).append(entry)
            if op.op == "del_all":
                self._ov_della.append(entry)
            elif op.dst:
                self._ov_by_dst.setdefault(op.dst, []).append(entry)

    def _ov_index(self):
        if self._ov_by_src is None:
            self._ov_by_src = {}
            self._ov_by_dst = {}
            self._ov_della = []
            for ts, ops in self.deltas:
                self._ov_extend(ts, ops)

    def _ov_drop(self):
        self._ov_by_src = None
        self._ov_by_dst = None
        self._ov_della = None

    def _src_overlay(self, src: int, read_ts: int):
        """This src's overlay ops visible at read_ts, in commit order."""
        self._ov_index()
        for ts, _, op in self._ov_by_src.get(src, ()):
            if ts > read_ts:
                break
            yield op

    # -- reads (read_ts snapshot) --

    def _overlay(self, read_ts: int):
        for ts, ops in self.deltas:
            if ts > read_ts:
                break
            yield from ops

    def _overlay_ts(self, read_ts: int):
        for ts, ops in self.deltas:
            if ts > read_ts:
                break
            for i, op in enumerate(ops):
                yield ts, i, op

    def _postings_before(self, src: int, ts: int, idx: int) -> list[Posting]:
        """Value postings of `src` just before op position (ts, idx) —
        used by wildcard deletes to find the tokens they must drop,
        including postings set earlier in the SAME commit."""
        out = list(self.values.get(src, ()))
        for dts, i, op in self._overlay_ts(ts):
            if dts == ts and i >= idx:
                break
            if op.src != src:
                continue
            if op.op == "del_all":
                out = []
            elif op.op == "set":
                out = self._merge_posting(out, op.posting)
            elif op.op == "del" and op.posting is not None:
                fp = value_fingerprint(op.posting.value)
                out = [p for p in out
                       if not (p.lang == op.posting.lang
                               and value_fingerprint(p.value) == fp)]
        return out

    def _dsts_before(self, src: int, ts: int, idx: int) -> np.ndarray:
        """Destination uids of `src` just before op position (ts, idx)."""
        out = self.edges.get(src, _EMPTY)
        dirty = False
        for dts, i, op in self._overlay_ts(ts):
            if dts == ts and i >= idx:
                break
            if op.src != src:
                continue
            if not dirty:
                out = out.copy()
                dirty = True
            if op.op == "set":
                out = _ins(out, op.dst)
            elif op.op == "del":
                out = _rm(out, op.dst)
            elif op.op == "del_all":
                out = _EMPTY
        return out

    def get_dst_uids(self, src: int, read_ts: int) -> np.ndarray:
        out = self.edges.get(src, _EMPTY)
        dirty = False
        for op in self._src_overlay(src, read_ts):
            if not dirty:
                out = out.copy()
                dirty = True
            if op.op == "set":
                out = _ins(out, op.dst)
            elif op.op == "del":
                out = _rm(out, op.dst)
            elif op.op == "del_all":
                out = _EMPTY
        return out

    def get_reverse_uids(self, dst: int, read_ts: int) -> np.ndarray:
        out = self.reverse.get(dst, _EMPTY)
        self._ov_index()
        # merge this dst's set/del ops with every del_all, in commit
        # order — both lists are already (ts, idx)-sorted, so a linear
        # two-pointer merge beats re-sorting per frontier uid
        entries = self._ov_by_dst.get(dst, [])
        if self._ov_della:
            import heapq
            entries = heapq.merge(entries, self._ov_della,
                                  key=lambda e: (e[0], e[1]))
        for ts, i, op in entries:
            if ts > read_ts:
                break
            if op.op == "set" and op.dst == dst:
                out = _ins(out, op.src)
            elif op.op == "del" and op.dst == dst:
                out = _rm(out, op.src)
            elif op.op == "del_all":
                # wildcard covers edges added earlier in the overlay too:
                # reconstruct src's out-edges just before this delete
                if dst in self._dsts_before(op.src, ts, i):
                    out = _rm(out, op.src)
        return out

    def get_postings(self, src: int, read_ts: int) -> list[Posting]:
        out = list(self.values.get(src, ()))
        for op in self._src_overlay(src, read_ts):
            if op.op == "del_all":
                out = []
            elif op.op == "set":
                out = self._merge_posting(out, op.posting)
            elif op.op == "del":
                fp = value_fingerprint(op.posting.value) if op.posting else None
                out = [p for p in out
                       if not (p.lang == (op.posting.lang if op.posting else "")
                               and (fp is None
                                    or value_fingerprint(p.value) == fp))]
        return out

    def _merge_posting(self, cur: list[Posting], p: Posting) -> list[Posting]:
        if self.schema.list_:
            fp = value_fingerprint(p.value)
            rest = [q for q in cur if value_fingerprint(q.value) != fp]
            return rest + [p]
        # single-valued: one posting per lang (ref posting lang handling)
        rest = [q for q in cur if q.lang != p.lang]
        return rest + [p]

    def merge_base_value(self, src: int, p: Posting):
        """Bulk-load seam: merge `p` into the BASE value list for
        `src` with the same list/lang replacement semantics as the
        MVCC apply path. Only loaders building base state below the
        tablet's base_ts (ingest/bulk.py) may call this — it bypasses
        the overlay entirely (dglint DG03 guards the private helper)."""
        self.values[src] = self._merge_posting(
            self.values.get(src, []), p)

    def index_uids(self, token: bytes, read_ts: int) -> np.ndarray:
        out = self.index.get(token, _EMPTY)
        dirty = False
        for ts, i, op in self._overlay_ts(read_ts):
            toks: Iterable[bytes] = ()
            if op.op in ("set", "del") and op.posting is not None \
                    and self.schema.indexed:
                toks = self._tokens(op.posting)
            elif op.op == "del_all" and self.schema.indexed:
                # wildcard delete: drop src from every token of every
                # posting live just before this delete (incl. postings
                # added earlier in the overlay — even in the same commit)
                for p in self._postings_before(op.src, ts, i):
                    for tk in self._tokens(p):
                        if tk == token:
                            if not dirty:
                                out = out.copy(); dirty = True
                            out = _rm(out, op.src)
                continue
            if token in toks:
                if not dirty:
                    out = out.copy(); dirty = True
                if op.op == "set":
                    out = _ins(out, op.src)
                else:
                    out = _rm(out, op.src)
            # an overwrite (set on single-valued pred) removes the uid
            # from tokens of the *old* value: handled by explicit del ops
            # emitted at commit build time (engine mutation path).
        return out

    def get_postings_at_base(self, src: int) -> list[Posting]:
        return list(self.values.get(src, ()))

    def token_index_csr(self, read_ts: int):
        """CSR export of the token index for batched probes (clean
        tablets only — overlay-carrying reads keep the exact per-token
        index_uids path). Cached per (base_ts, schema object), like
        value_columns: alter() rebinds the schema and rebuild_index
        replaces the dict, so both invalidators are covered."""
        if self.dirty() or read_ts < self.base_ts \
                or not self.schema.indexed:
            return None
        if len(self.index) > (1 << 18):
            # mostly-exact-token indexes (one tiny posting list per
            # distinct value): the python-loop concat of a million
            # arrays costs seconds per rollup while contiguous slices
            # buy nothing over dict gets — keep the direct path
            return None
        cached = getattr(self, "_tok_csr", None)
        if cached is not None \
                and getattr(self, "_tok_csr_ts", -1) == self.base_ts \
                and getattr(self, "_tok_csr_schema", None) \
                is self.schema:
            return cached
        csr = TokenIndexCSR(self.index)
        self._tok_csr = csr
        self._tok_csr_ts = self.base_ts
        self._tok_csr_schema = self.schema
        return csr

    def token_index_packs(self, read_ts: int):
        """Compressed token-index export (CompressedTokenIndex) — the
        compressed tier's operand plane. Same contract as
        token_index_csr: clean tablets only, cached per (base_ts,
        schema object), the same 2^18-token cap (mostly-exact-token
        indexes gain nothing over dict gets), rebuilt after rollup or
        alter. Build cost is encode-at-export (rollup-path), like the
        dense CSR and the device tiles."""
        if self.dirty() or read_ts < self.base_ts \
                or not self.schema.indexed:
            return None
        if len(self.index) > (1 << 18):
            return None
        cached = getattr(self, "_tok_packs", None)
        if cached is not None \
                and getattr(self, "_tok_packs_ts", -1) == self.base_ts \
                and getattr(self, "_tok_packs_schema", None) \
                is self.schema:
            return cached
        packs = CompressedTokenIndex(self.index)
        self._tok_packs = packs
        self._tok_packs_ts = self.base_ts
        self._tok_packs_schema = self.schema
        return packs

    def src_uids(self, read_ts: int) -> np.ndarray:
        """All uids with >=1 posting — has() root. Ref
        worker/task.go:2075. Clean tablets answer from one sorted
        array cached per base_ts: dict keys are unique already, so the
        python-set pass the overlay path needs is pure overhead here
        (a 1M-row has() root rebuilt a 1M-entry set every query)."""
        if not self.deltas:
            cached = getattr(self, "_src_uids_cache", None)
            if cached is not None and cached[0] == self.base_ts:
                return cached[1]
            store = self.edges if self.is_uid else self.values
            out = np.fromiter(store.keys(), np.uint64, len(store))
            out.sort()
            self._src_uids_cache = (self.base_ts, out)
            return out
        base = set(self.edges) if self.is_uid else set(self.values)
        for op in self._overlay(read_ts):
            if op.op == "set":
                base.add(op.src)
            elif op.op == "del_all":
                base.discard(op.src)
            elif op.op == "del":
                pass  # conservative: cheap check below
        out = np.fromiter(base, dtype=np.uint64, count=len(base))
        out.sort()
        # exact: drop uids whose postings are now empty
        keep = [u for u in out.tolist()
                if (len(self.get_dst_uids(u, read_ts)) if self.is_uid
                    else len(self.get_postings(u, read_ts)))]
        return np.asarray(keep, dtype=np.uint64)

    def dst_uids(self, read_ts: int) -> np.ndarray:
        """All uids appearing as an edge destination — the reverse-side
        analogue of src_uids (root scans over `~pred`)."""
        if not self.deltas:
            cached = getattr(self, "_dst_uids_cache", None)
            if cached is not None and cached[0] == self.base_ts:
                return cached[1]
            out = np.fromiter(self.reverse.keys(), np.uint64,
                              len(self.reverse))
            out.sort()
            self._dst_uids_cache = (self.base_ts, out)
            return out
        base = set(self.reverse)
        for op in self._overlay(read_ts):
            if op.op == "set" and self.is_uid:
                base.add(op.dst)
        out = np.fromiter(base, dtype=np.uint64, count=len(base))
        out.sort()
        keep = [u for u in out.tolist()
                if len(self.get_reverse_uids(u, read_ts))]
        return np.asarray(keep, dtype=np.uint64)

    def expand_frontier(self, frontier: np.ndarray, read_ts: int,
                        reverse: bool = False) -> np.ndarray:
        """Union of destination uids over a frontier — the single host
        implementation of one BFS level (device analogue:
        ops/graph.expand). Both the executor and GraphDB.bfs use this."""
        getter = self.get_reverse_uids if reverse else self.get_dst_uids
        parts = [getter(int(u), read_ts) for u in frontier.tolist()]
        parts = [p for p in parts if len(p)]
        if not parts:
            return _EMPTY.copy()
        return np.unique(np.concatenate(parts))

    def edge_count(self, reverse: bool = False) -> int:
        """Total base edges (cached per base_ts): the executor's
        device/host cost model sizes expansions with it."""
        cached = getattr(self, "_edge_count_cache", None)
        if cached is not None and cached[0] == self.base_ts:
            fwd, rev = cached[1], cached[2]
        else:
            fwd = sum(len(v) for v in self.edges.values())
            rev = sum(len(v) for v in self.reverse.values())
            self._edge_count_cache = (self.base_ts, fwd, rev)
        return rev if reverse else fwd

    def count_of(self, src: int, read_ts: int,
                 reverse: bool = False) -> int:
        if reverse:
            return len(self.get_reverse_uids(src, read_ts))
        if self.is_uid:
            return len(self.get_dst_uids(src, read_ts))
        return len(self.get_postings(src, read_ts))

    def count_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized fan-out counts over the BASE state: (sorted src
        uint64 array, aligned int64 counts) — the count-index column
        the reference maintains per @count predicate (posting/index.go
        count keys), recomputed per base_ts instead of per mutation.
        Overlay-touched uids must be answered via count_of; callers
        partition with overlay_srcs()."""
        cached = getattr(self, "_count_table", None)
        if cached is not None and cached[0] == self.base_ts:
            return cached[1], cached[2]
        store = self.edges if self.is_uid else self.values
        srcs = np.fromiter(store.keys(), np.uint64, len(store))
        order = np.argsort(srcs)
        srcs = srcs[order]
        counts = np.fromiter((len(store[int(s)]) for s in srcs),
                             np.int64, len(srcs))
        self._count_table = (self.base_ts, srcs, counts)
        return srcs, counts

    def get_facets(self, src: int, dst: int, read_ts: int) -> dict:
        out = self.edge_facets.get((src, dst), {})
        for op in self._src_overlay(src, read_ts):
            if op.op == "set" and op.dst == dst and op.facets:
                out = op.facets
        return out

    def value_columns(self, read_ts: int):
        """Columnar view of a CLEAN single-valued scalar tablet for the
        JSON fast path (ref query/outputnode.go fastJsonNode feeding
        valToBytes): (srcs sorted u64, tid, data, enc) where data is a
        typed numpy array aligned to srcs for INT/FLOAT/BOOL and None
        for strings, and enc is the per-src utf-8-encoded payload list
        for STRING/DEFAULT/DATETIME. Rows without an untagged posting
        are simply absent from srcs. Returns None when the tablet is
        dirty at read_ts, historical (read_ts < base_ts), list-typed,
        value-type-mixed, or schema-converted — those keep the exact
        per-posting path. Cached per base_ts, like the device tiles."""
        if self.dirty() or read_ts < self.base_ts or self.schema.list_:
            return None
        # validity = same base AND the same schema OBJECT (held by
        # reference, so a recycled id() can never false-validate):
        # alter() rebinds tab.schema, and a type change must
        # invalidate the typed view
        cached = getattr(self, "_val_cols", None)
        if cached is not None \
                and getattr(self, "_val_cols_ts", -1) == self.base_ts \
                and getattr(self, "_val_cols_schema", None) \
                is self.schema:
            return cached or None
        cols = self._build_value_columns()
        self._val_cols = cols if cols is not None else False
        self._val_cols_ts = self.base_ts
        self._val_cols_schema = self.schema
        return cols

    def lang_value_columns(self, read_ts: int, lang: str):
        """Columnar view of ONE language's postings (first posting per
        uid tagged `lang`) — the lang-tagged groupby/gather analogue of
        value_columns. Same clean-tablet contract; cached per
        (base_ts, lang) under a per-lang attribute so each language's
        column copy is individually budgeted/evictable by the tile
        LRU (one shared key would account only the first language)."""
        if self.dirty() or read_ts < self.base_ts or self.schema.list_:
            return None
        attr = f"_val_cols_lang@{lang}"
        cached = getattr(self, attr, None)
        if cached is not None \
                and getattr(self, attr + "_ts", -1) == self.base_ts \
                and getattr(self, attr + "_schema", None) \
                is self.schema:
            return cached or None
        from dgraph_tpu_torch.models.types import TypeID
        srcs: list[int] = []
        vals: list = []
        tid = None
        for u, ps in self.values.items():
            sel = None
            for p in ps:
                if p.lang == lang:
                    sel = p
                    break
            if sel is None:
                continue
            v = sel.value
            if tid is None:
                tid = v.tid
            elif v.tid is not tid:
                tid = False  # mixed types: exact path only
                break
            srcs.append(u)
            vals.append(v.value)
        out = None
        if tid in (TypeID.STRING, TypeID.DEFAULT):
            order = np.argsort(np.asarray(srcs, np.uint64))
            try:
                enc = [vals[j].encode("utf-8") for j in order.tolist()]
                out = ValueColumns(
                    np.asarray(srcs, np.uint64)[order], tid, None, enc)
            except (AttributeError, ValueError):
                out = None
        setattr(self, attr, out if out is not None else False)
        setattr(self, attr + "_ts", self.base_ts)
        setattr(self, attr + "_schema", self.schema)
        return out

    def edge_table(self, read_ts: int):
        """Flat (src-repeated, dst) uint64 arrays of a CLEAN uid
        tablet, src-sorted — one vectorized join key for groupby over
        uid predicates instead of a per-member edges[] walk. Cached
        per base_ts."""
        if self.dirty() or read_ts < self.base_ts or not self.is_uid:
            return None
        cached = getattr(self, "_edge_table", None)
        if cached is not None and self._edge_table_ts == self.base_ts:
            return cached
        parts_s, parts_d = [], []
        for u in sorted(self.edges):
            d = self.edges[u]
            if not len(d):
                continue
            parts_d.append(np.asarray(d, np.uint64))
            parts_s.append(np.full(len(d), u, np.uint64))
        if parts_s:
            table = (np.concatenate(parts_s), np.concatenate(parts_d))
        else:
            table = (np.empty(0, np.uint64), np.empty(0, np.uint64))
        self._edge_table = table
        self._edge_table_ts = self.base_ts
        return table

    def _build_value_columns(self):
        from dgraph_tpu_torch.models.types import TypeID
        stype = self.schema.value_type
        srcs: list[int] = []
        vals: list = []
        tid = None
        for u, ps in self.values.items():
            sel = None
            for p in ps:
                if not p.lang:
                    sel = p
                    break
            if sel is None:
                continue
            v = sel.value
            if tid is None:
                tid = v.tid
            elif v.tid is not tid:
                return None  # mixed types: exact path only
            srcs.append(u)
            vals.append(v.value)
        if tid is None:
            return None
        if stype != TypeID.DEFAULT and tid != stype:
            # stored tid predates a schema change; reads convert per
            # cell, which the columnar view would skip
            return None
        order = np.argsort(np.asarray(srcs, np.uint64))
        srcs_a = np.asarray(srcs, np.uint64)[order]
        try:
            if tid == TypeID.INT:
                data = np.asarray(vals, np.int64)[order]
                return ValueColumns(srcs_a, tid, data, None)
            if tid == TypeID.FLOAT:
                data = np.asarray(vals, np.float64)[order]
                return ValueColumns(srcs_a, tid, data, None)
            if tid == TypeID.BOOL:
                data = np.asarray(
                    [1 if v else 0 for v in vals], np.uint8)[order]
                return ValueColumns(srcs_a, tid, data, None)
            if tid == TypeID.DATETIME:
                from dgraph_tpu_torch.models.types import iso8601
                enc = [iso8601(vals[j]).encode("utf-8")
                       for j in order.tolist()]
                vc = ValueColumns(srcs_a, tid, None, enc)
                vc.dt_secs = np.asarray(
                    [vals[j].timestamp() for j in order.tolist()],
                    np.float64)
                objs = np.empty(len(order), object)
                for i, j in enumerate(order.tolist()):
                    objs[i] = vals[j]
                vc.dt_objs = objs
                return vc
            if tid in (TypeID.STRING, TypeID.DEFAULT):
                enc = [vals[j].encode("utf-8") for j in order.tolist()]
                ex_srcs, ex_enc, ex_ok = [], [], True
                for u, ps in self.values.items():
                    for p in ps:
                        if not p.lang:
                            continue
                        try:
                            ex_enc.append(
                                p.value.value.encode("utf-8"))
                            ex_srcs.append(u)
                        except (AttributeError, ValueError):
                            ex_ok = False
                return ValueColumns(
                    srcs_a, tid, None, enc,
                    extra_srcs=np.asarray(ex_srcs, np.uint64),
                    extra_enc=ex_enc, extra_ok=ex_ok)
        except (TypeError, ValueError, AttributeError, OverflowError):
            # ValueError covers UnicodeEncodeError: a lone-surrogate
            # payload keeps the exact dict path on BOTH emitters
            return None
        return None

    # -- rollup (ref posting/list.go:708 Rollup + worker/draft.go:407) --

    def dirty(self) -> bool:
        return bool(self.deltas)

    def approx_bytes(self) -> int:
        """Rough resident size — the tablet-space report zero's
        rebalancer weighs moves by (ref zero/tablet.go:180 tablet
        sizes from membership updates)."""
        n = 0
        for arr in self.edges.values():
            n += arr.nbytes
        for arr in self.reverse.values():
            n += arr.nbytes
        for arr in self.index.values():
            n += arr.nbytes
        for plist in self.values.values():
            for p in plist:
                v = p.value.value
                n += 16 + (len(v) if isinstance(v, (str, bytes)) else 8)
        n += 64 * sum(len(ops) for _, ops in self.deltas)
        return n

    def overlay_srcs(self, read_ts: int, reverse: bool = False
                     ) -> set[int]:
        """Uids whose out-edges (in-edges with reverse=True) are
        touched by overlay ops visible at read_ts — the exactness
        boundary for overlay-on-device reads: rows NOT in this set are
        identical in the base arrays, so a device tile built at
        base_ts answers them exactly; touched rows take the host MVCC
        path (ref posting/mvcc.go: immutable layer + mutable layer
        split, read through both)."""
        out: set[int] = set()
        for op in self._overlay(read_ts):
            if op.op == "del_all":
                # wildcard wipes src's row AND removes src from every
                # dst's reverse row — which dsts is row-dependent, so
                # conservatively all of src's base+overlay targets
                out.add(op.src)
                if reverse:
                    out.update(self.base_dsts_of(op.src))
            else:
                out.add(op.dst if reverse else op.src)
        return out

    def base_dsts_of(self, src: int) -> list[int]:
        arr = self.edges.get(src)
        return arr.tolist() if arr is not None else []

    def rollup(self, watermark: int):
        """Fold deltas with ts <= watermark into base state."""
        if not self.deltas:
            return  # nothing to fold — skip the (traced) fold path
        from dgraph_tpu_torch.utils.tracing import span as _span

        with _span("tablet.rollup", pred=self.pred,
                   deltas=len(self.deltas)) as sp:
            keep: list[tuple[int, list[EdgeOp]]] = []
            folded = False
            for ts, ops in self.deltas:
                if ts > watermark:
                    keep.append((ts, ops))
                    continue
                folded = True
                for op in ops:
                    self._fold(op)
                self.base_ts = max(self.base_ts, ts)
            self.deltas = keep
            sp["folded"] = folded
            if folded:
                self._device_adj_ts = -1  # invalidate device snapshot
                self._ov_drop()           # overlay index keys shifted

    def _fold(self, op: EdgeOp):
        src = op.src
        if op.op == "del_all":
            if self.is_uid:
                for dst in self.edges.pop(src, _EMPTY):
                    self.reverse[int(dst)] = _rm(
                        self.reverse.get(int(dst), _EMPTY), src)
                    self.edge_facets.pop((src, int(dst)), None)
            else:
                for p in self.values.pop(src, []):
                    if self.schema.indexed:
                        for tk in self._tokens(p):
                            self.index[tk] = _rm(
                                self.index.get(tk, _EMPTY), src)
            return
        if self.is_uid:
            if op.op == "set":
                self.edges[src] = _ins(self.edges.get(src, _EMPTY), op.dst)
                if self.schema.reverse:
                    self.reverse[op.dst] = _ins(
                        self.reverse.get(op.dst, _EMPTY), src)
                if op.facets:
                    self.edge_facets[(src, op.dst)] = op.facets
            else:
                self.edges[src] = _rm(self.edges.get(src, _EMPTY), op.dst)
                if not len(self.edges[src]):
                    del self.edges[src]
                if self.schema.reverse:
                    self.reverse[op.dst] = _rm(
                        self.reverse.get(op.dst, _EMPTY), src)
                self.edge_facets.pop((src, op.dst), None)
            return
        # value posting
        if op.op == "set":
            self.values[src] = self._merge_posting(
                self.values.get(src, []), op.posting)
            if self.schema.indexed:
                for tk in self._tokens(op.posting):
                    self.index[tk] = _ins(self.index.get(tk, _EMPTY), src)
        else:
            before = self.values.get(src, [])
            after = [p for p in before
                     if not (p.lang == op.posting.lang
                             and value_fingerprint(p.value)
                             == value_fingerprint(op.posting.value))]
            self.values[src] = after
            if not after:
                del self.values[src]
            if self.schema.indexed:
                for tk in self._tokens(op.posting):
                    self.index[tk] = _rm(self.index.get(tk, _EMPTY), src)

    # -- index (re)build: Alter adding @index to live data
    #    (ref posting/index.go:496 rebuilder) --

    # tokenizer names dgt_tokenize_batch covers for ASCII payloads
    _NATIVE_TOKS = frozenset(("term", "exact", "trigram", "fulltext"))

    def rebuild_index(self):
        # batch build: collect per token, ONE sort+unique per posting
        # list at the end — per-element sorted np.insert is O(n^2) and
        # dominated bulk-load profiles
        self.index = {}
        if not self.schema.indexed:
            return
        # `ready` holds token lists that are already sorted-unique
        # (single clean native chunk) — the common case; one np.unique
        # per token across 600k exact/term tokens was half the native
        # path's wall clock otherwise
        ready: dict[bytes, np.ndarray] = {}
        acc: dict[bytes, list[np.ndarray]] = {}
        rest = self._index_batch_native(ready, acc)
        pyacc: dict[bytes, list[int]] = {}
        for src, p in rest:
            for tk in self._tokens(p):
                pyacc.setdefault(tk, []).append(src)
        for tk, srcs in pyacc.items():
            acc.setdefault(tk, []).append(np.asarray(srcs, np.uint64))
        for tk, parts in acc.items():
            prev = ready.pop(tk, None)
            if prev is not None:
                parts.append(prev)
            ready[tk] = np.unique(np.concatenate(parts)) \
                if len(parts) > 1 else np.unique(parts[0])
        self.index = ready

    def _index_batch_native(self, ready: dict, acc: dict) -> list:
        """Tokenize the ASCII string postings through the C++ batch
        tokenizer (native.cc dgt_tokenize_batch) — the reference maps
        at 75-80k RDF/s WITH index entries (bulk/mapper.go:272) where
        the per-value python tokenizer managed ~20k.  Returns the
        postings the native path cannot serve bit-identically
        (non-ASCII, non-string-typed, non-English fulltext tags,
        tokenizers outside the native set); ASCII folding equals the
        python NFKD+casefold chain, so handled postings produce the
        same tokens."""
        from dgraph_tpu_torch import native
        from dgraph_tpu_torch.models.stemmer import lang_base

        toks = set(self.schema.tokenizers or ())
        if not toks or not toks <= self._NATIVE_TOKS \
                or not native.available():
            return [(src, p) for src, plist in self.values.items()
                    for p in plist]
        mode = (native.TOK_TERM if "term" in toks else 0) \
            | (native.TOK_TRIGRAM if "trigram" in toks else 0) \
            | (native.TOK_FULLTEXT_EN if "fulltext" in toks else 0) \
            | (native.TOK_EXACT if "exact" in toks else 0)
        idents = tuple(get_tokenizer(n).ident
                       for n in ("term", "trigram", "fulltext", "exact"))
        need_en = "fulltext" in toks
        rest: list = []
        srcs: list[int] = []
        payloads: list[bytes] = []

        def flush():
            if not srcs:
                return
            payload = b"".join(payloads)
            offsets = np.zeros(len(payloads) + 1, np.uint64)
            np.cumsum([len(b) for b in payloads],
                      out=offsets[1:], dtype=np.uint64)
            got = native.tokenize_batch(
                np.frombuffer(payload, np.uint8), offsets, mode, idents)
            src_arr = np.asarray(srcs, np.uint64)
            if got is None:
                rest.extend(
                    (int(s), p) for s, p in zip(srcs, chunk_postings))
            else:
                # within a chunk the groups are ascending value-index;
                # with strictly increasing srcs the gathered uid lists
                # are therefore already sorted-unique -> `ready`
                clean = len(src_arr) < 2 \
                    or bool(np.all(src_arr[1:] > src_arr[:-1]))
                for tk, grp in zip(*got):
                    arr = src_arr[grp]
                    if clean and tk not in acc and tk not in ready:
                        ready[tk] = arr
                        continue
                    prev = ready.pop(tk, None)
                    if prev is not None:
                        acc.setdefault(tk, []).append(prev)
                    acc.setdefault(tk, []).append(arr)
            srcs.clear()
            payloads.clear()
            chunk_postings.clear()

        chunk_postings: list = []
        for src, plist in self.values.items():
            for p in plist:
                v = p.value
                s = v.value
                if v.tid not in (TypeID.STRING, TypeID.DEFAULT) \
                        or not isinstance(s, str) or not s.isascii() \
                        or (need_en and p.lang
                            and lang_base(p.lang) != "en"):
                    rest.append((src, p))
                    continue
                srcs.append(src)
                payloads.append(s.encode("ascii"))
                chunk_postings.append(p)
                if len(srcs) >= 131072:
                    flush()
        flush()
        return rest

    def rebuild_reverse(self):
        self.reverse = {}
        if not (self.is_uid and self.schema.reverse):
            return
        if self.edges:
            # one flat (dst, src) sort instead of per-edge inserts
            srcs = np.concatenate([
                np.full(len(d), s, np.uint64)
                for s, d in self.edges.items()])
            dsts = np.concatenate(
                [d.astype(np.uint64) for d in self.edges.values()])
            order = np.lexsort((srcs, dsts))
            srcs, dsts = srcs[order], dsts[order]
            uniq, starts = np.unique(dsts, return_index=True)
            bounds = np.append(starts, len(srcs))
            self.reverse = {
                int(u): np.unique(srcs[bounds[i]:bounds[i + 1]])
                for i, u in enumerate(uniq)}

    # -- columnar vector block (float32vector predicates) --

    def vector_view(self, read_ts: int):
        """Dense (n, d) float32 view of this predicate's embeddings at
        read_ts: packed base block (cached per base_ts, device-
        cacheable) + MVCC overlay side rows. See storage/vecstore.py;
        ops/knn.py consumes it for similar_to()."""
        from dgraph_tpu_torch.storage.vecstore import vector_view
        return vector_view(self, read_ts)

    def vector_ivf(self):
        """The trained quantized ANN index for the CURRENT base state,
        or None (stale after a rollup that folded vector ops — the
        exact tiers keep serving until retrain)."""
        from dgraph_tpu_torch.storage.vecstore import vector_ivf
        return vector_ivf(self)

    def build_vector_ivf(self, **kw):
        """Train (or reuse) the quantized index over the base block
        (storage/vecstore.build_ivf)."""
        from dgraph_tpu_torch.storage.vecstore import build_ivf
        return build_ivf(self, **kw)

    # -- sortable keys for device values --

    def sort_key_arrays(self, lang: str = ""):
        """(uids u64, int64 keys) of sort_key_pairs as cached arrays —
        an inequality root at the 21M regime otherwise paid a fresh
        1M-entry dict build + fromiter on EVERY query (ref
        worker/tokens.go:113 walks an index that already exists; this
        is our equivalent persistent structure). Cached per (base_ts,
        schema object, lang) exactly like value_columns."""
        cached = getattr(self, "_sk_arrays", None)
        tag = (self.base_ts, self.schema, lang)
        if cached is not None and cached[0][0] == self.base_ts \
                and cached[0][1] is self.schema and cached[0][2] == lang:
            return cached[1], cached[2]
        pairs = self.sort_key_pairs(lang)
        uids = np.fromiter(pairs.keys(), np.uint64, len(pairs))
        keys = np.fromiter(pairs.values(), np.int64, len(pairs))
        # uid-ASCENDING is part of the contract: consumers gather by
        # np.searchsorted (the values dict iterates in insertion
        # order, which mutation-built tablets do NOT keep sorted)
        order = np.argsort(uids, kind="stable")
        uids, keys = uids[order], keys[order]
        self._sk_arrays = (tag, uids, keys)
        return uids, keys

    def sorted_by_key_uids(self, lang: str = "", desc: bool = False):
        """(OrderPermutation, cache attr) — uids ordered by
        (key, uid asc), asc or desc on the key, ties always
        uid-ascending (the executor's lexsort contract), plus the
        permutation into sort_key_arrays. A single-key order-by over a
        large candidate set then reduces to ONE membership gather
        through this cached permutation instead of a per-query lexsort
        (ref worker/sort.go walks the value-ordered index the same
        way); the permutation lets the caller probe in the SMALLER
        direction (candidates into the uid-sorted column) and re-order
        the hit mask. Cached per (base_ts, schema) under a per-
        (lang, desc) attribute so DeviceCacheLRU can budget and evict
        each entry (the attr is the caller's budget key)."""
        attr = f"_ordperm@{lang}@{'d' if desc else 'a'}"
        cached = getattr(self, attr, None)
        if cached is not None \
                and getattr(self, attr + "_ts", -1) == self.base_ts \
                and getattr(self, attr + "_schema", None) \
                is self.schema:
            return cached, attr
        uids, keys = self.sort_key_arrays(lang)
        # desc via bitwise-not: monotone-decreasing int64 map with no
        # INT64_MIN negation overflow
        order = np.lexsort((uids, ~keys if desc else keys))
        out = OrderPermutation(uids[order], order)
        setattr(self, attr, out)
        setattr(self, attr + "_ts", self.base_ts)
        setattr(self, attr + "_schema", self.schema)
        return out, attr

    def sort_key_pairs(self, lang: str = "") -> dict[int, int]:
        """uid -> int64 sort key for ORDERING in `lang`. Unlike
        filters/emission (strict tag match), sorting falls back:
        requested tag, else the untagged value, else the first posting
        (ref posting.List.ValueFor — query1_test.go
        TestToFastJSONOrderLang sorts alias@en over untagged
        aliases)."""
        out = {}
        for src, plist in self.values.items():
            sel = None
            for p in plist:
                if p.lang == lang:
                    sel = p
                    break
            if sel is None and lang:
                for p in plist:
                    if not p.lang:
                        sel = p
                        break
                if sel is None and plist:
                    sel = plist[0]
            if sel is None:
                continue
            try:
                out[src] = sort_key(self._converted(sel))
            except ValueError:
                pass
        return out
