"""UID block codec: port of `dgraph_tpu/ops/codec.py`, the re-design of
the reference's group-varint delta codec (codec/codec.go:43-274).

Two planes:

- The decode format `UidPack32`: per block a uint32 base, uint16 deltas
  and a count, encoded on the host (`encode`, numpy, copied from the
  reference) and decoded on the device (`decode_padded`: one cumsum
  over the delta matrix, padding masked to SENTINEL, one sort) into a
  padded sorted vector of the port's `ops.uidvec` (int64 holding
  uint32 values).
- The compressed operand format `CompressedPack` of ops/setops: a
  sorted-unique uint64 uid set cut into 2^16-uid blocks keyed by
  `uid >> 16`, each in the byte-smallest of three forms (PACKED delta +
  bitpacked lows, BITMAP 1024 uint64 words, RUN (start, length-1)
  pairs). It is host numpy, copied from the reference and kept
  host-resident (`host_resident = True`); the bitmap word-AND of
  `ops/setops.intersect_packs` is the only part that runs on the card.
  `compressed_pack_from_arrays` carries a reference pack across.

The group-varint at-rest stream goes through the host runtime
(`dgraph_tpu_torch.native`, dgt_gv_encode / dgt_gv_decode), as the
reference's does; the reference's numpy encoders and decoder
(`gv_encode_np`, `_gv_encode_py_small`, `gv_decode_np`) write and read
the same bytes and run when the runtime is switched off.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.backend import resolve_device
from dgraph_tpu_torch.ops.uidvec import SENTINEL, compact

BLOCK_SIZE = 256  # the reference's block size (wire.go)
_MAX_DELTA = np.uint32(0xFFFF)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


@dataclass
class UidPack32:
    """Block-delta pack; arrays are numpy on the host or torch tensors
    after `device()`."""

    bases: object   # [B] uint32 (int64 on the device)
    deltas: object  # [B, BLOCK_SIZE-1] uint16 (int32 on the device)
    counts: object  # [B] int32, 1..BLOCK_SIZE
    n: int          # total number of UIDs

    def device(self, device: str | torch.device | None = None
               ) -> "UidPack32":
        """The pack's arrays on `device` (the card unless told
        otherwise), widened to types torch computes with."""
        dev = resolve_device(device)
        return UidPack32(
            torch.as_tensor(np.asarray(self.bases, np.int64), device=dev),
            torch.as_tensor(np.asarray(self.deltas, np.int32), device=dev),
            torch.as_tensor(np.asarray(self.counts, np.int32), device=dev),
            self.n)

    @property
    def nbytes(self) -> int:
        return (_nbytes(self.bases) + _nbytes(self.deltas)
                + _nbytes(self.counts))


def encode(uids: np.ndarray) -> UidPack32:
    """Sorted uint32 UIDs -> UidPack32. Host-side, vectorized numpy.

    Ref: codec.Encode (codec/codec.go:283) + Encoder.packBlock.
    Block boundaries: every BLOCK_SIZE elements, plus wherever a delta
    exceeds uint16 (analogue of the reference's 32-MSB boundary rule).
    """
    uids = np.asarray(uids, dtype=np.uint32)
    n = len(uids)
    if n == 0:
        return UidPack32(
            np.zeros(0, np.uint32),
            np.zeros((0, BLOCK_SIZE - 1), np.uint16),
            np.zeros(0, np.int32), 0)

    deltas = np.diff(uids.astype(np.uint64)).astype(np.uint32)
    # A block starts at 0, after every big delta, and at BLOCK_SIZE fill.
    big = np.flatnonzero(deltas > _MAX_DELTA) + 1
    starts = [0]
    next_forced = iter(big.tolist() + [n])
    forced = next(next_forced)
    i = 0
    while i < n:
        end = min(i + BLOCK_SIZE, n)
        while forced <= i:
            forced = next(next_forced)
        if forced < end:
            end = forced
        i = end
        if i < n:
            starts.append(i)
    starts_arr = np.asarray(starts, dtype=np.int64)
    ends = np.append(starts_arr[1:], n)
    nb = len(starts_arr)

    bases = uids[starts_arr]
    counts = (ends - starts_arr).astype(np.int32)
    dmat = np.zeros((nb, BLOCK_SIZE - 1), dtype=np.uint16)
    for bi in range(nb):
        s, e = starts_arr[bi], ends[bi]
        if e - s > 1:
            dmat[bi, : e - s - 1] = deltas[s : e - 1].astype(np.uint16)
    return UidPack32(bases, dmat, counts, n)


def decode_padded(pack: UidPack32, size: int,
                  device: str | torch.device | None = None
                  ) -> torch.Tensor:
    """UidPack32 (host or device arrays) -> padded sorted UID vector of
    static length `size` on `device` (the card unless told otherwise).

    Ref: codec.Decode / Decoder.unpackBlock (codec/codec.go:319,128).
    One cumsum over the delta matrix; padding slots become SENTINEL via
    the per-block count mask, then one sort re-establishes the
    invariant. Sums wrap at 2^32 as the reference's uint32 cumsum does.
    """
    dev = resolve_device(device)
    if not isinstance(pack.bases, torch.Tensor):
        pack = pack.device(dev)
    # torch has no uint32 arithmetic: sums run in int64
    bases = pack.bases.to(dev, torch.int64)
    deltas = pack.deltas.to(dev, torch.int64)
    counts = pack.counts.to(dev, torch.int64)
    if bases.shape[0] == 0:
        return torch.full((size,), SENTINEL, dtype=torch.int64, device=dev)
    # [B, BLOCK_SIZE]: base, base+d0, base+d0+d1, ...
    csum = torch.cumsum(deltas, dim=1)
    vals = torch.cat([bases[:, None], bases[:, None] + csum], dim=1) \
        & 0xFFFFFFFF
    lane = torch.arange(vals.shape[1], device=dev)[None, :]
    vals = vals.masked_fill(lane >= counts[:, None], SENTINEL)
    flat = compact(vals.reshape(-1))
    if flat.shape[0] >= size:
        return flat[:size]
    return torch.cat([flat, torch.full((size - flat.shape[0],), SENTINEL,
                                       dtype=torch.int64, device=dev)])


# ======================================================================
# Compressed block plane: set-algebra operands that stay compressed
# (host numpy, as in the reference).
#
#   PACKED  delta + bitpacked lows: per-block descriptor (base = first
#           low uint16, bit width, count); count-1 deltas packed at
#           `width` bits, little-endian bit order.  Sparse blocks.
#   BITMAP  1024 x uint64 little-endian words (8 KiB).  Dense blocks.
#   RUN     (start, length-1) uint16 pairs.  Runny blocks.
# ======================================================================

BLOCK_SPAN = 1 << 16          # uid space per block (key = uid >> 16)
BITMAP_WORDS = BLOCK_SPAN // 64   # 1024 uint64 words = 8 KiB
_BITMAP_BYTES = BLOCK_SPAN // 8

FORM_PACKED = 0
FORM_BITMAP = 1
FORM_RUN = 2


def _bitpack(vals: np.ndarray, width: int) -> np.ndarray:
    """uint32 values < 2^width -> little-endian packed uint8 bits."""
    if width == 0 or not len(vals):
        return np.zeros(0, np.uint8)
    bits = ((vals[:, None] >> np.arange(width, dtype=np.uint32)) & 1
            ).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def _bitunpack(buf: np.ndarray, n: int, width: int) -> np.ndarray:
    """Inverse of _bitpack: n values of `width` bits -> uint32."""
    if n == 0:
        return np.zeros(0, np.uint32)
    if width == 0:
        return np.zeros(n, np.uint32)
    bits = np.unpackbits(buf, count=n * width,
                         bitorder="little").reshape(n, width)
    weights = (np.uint32(1) << np.arange(width, dtype=np.uint32))
    return (bits.astype(np.uint32) * weights).sum(
        axis=1, dtype=np.uint32)


def _bitmap_bytes(lows: np.ndarray) -> np.ndarray:
    """Sorted-unique lows (< 2^16) -> the block's 8 KiB bitmap: uid u is
    bit u % 8 of byte u // 8, the bytes of little-endian uint64 words
    with bit u % 64 of word u // 64 set."""
    bits = np.zeros(BLOCK_SPAN, np.uint8)
    bits[lows] = 1
    return np.packbits(bits, bitorder="little")


class CompressedPack:
    """One sorted-unique uint64 uid set as adaptive compressed blocks.

    Arrays (aligned per block, keys ascending):
      keys     uint64[B]  block key (uid >> 16)
      forms    uint8[B]   FORM_PACKED / FORM_BITMAP / FORM_RUN
      counts   int64[B]   uids in the block (1..65536)
      widths   uint8[B]   PACKED delta bit width (0 otherwise)
      bases    uint16[B]  PACKED first low value (0 otherwise)
      offsets  int64[B+1] payload byte offsets, 8-byte aligned so
                          BITMAP word views and RUN uint16 views are
                          zero-copy
      sizes    int64[B]   exact payload bytes (offsets include pad)
      payload  uint8[...] per-block payload bytes (see above)

    `host_resident`: the pack is host memory, as in the reference."""

    host_resident = True

    __slots__ = ("keys", "forms", "counts", "widths", "bases",
                 "offsets", "sizes", "payload", "n", "nbytes", "sid")

    def __init__(self, keys, forms, counts, widths, bases, offsets,
                 sizes, payload, n):
        # process-unique id for the decode-block cache: id() recycles
        # after GC, a stale cache hit would corrupt results
        self.sid = _next_sid()
        self.keys = keys
        self.forms = forms
        self.counts = counts
        self.widths = widths
        self.bases = bases
        self.offsets = offsets
        self.sizes = sizes
        self.payload = payload
        self.n = int(n)
        self.nbytes = int(keys.nbytes + forms.nbytes + counts.nbytes
                          + widths.nbytes + bases.nbytes
                          + offsets.nbytes + sizes.nbytes
                          + payload.nbytes)

    def __len__(self) -> int:
        return self.n

    # -- per-block access (ops/setops' kernels) ------------------------

    def block_of(self, key: int) -> int:
        """Index of block `key`, or -1."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and int(self.keys[i]) == int(key):
            return i
        return -1

    def block_payload(self, bi: int) -> np.ndarray:
        off = int(self.offsets[bi])
        return self.payload[off: off + int(self.sizes[bi])]

    def block_words(self, bi: int) -> np.ndarray:
        """A BITMAP block's 1024 uint64 words, zero-copy (offsets are
        8-byte aligned by construction)."""
        return self.block_payload(bi).view(np.uint64)

    def block_runs(self, bi: int) -> np.ndarray:
        """A RUN block's (start, length-1) uint16 pairs, zero-copy."""
        return self.block_payload(bi).view(np.uint16).reshape(-1, 2)

    def block_lows(self, bi: int, scratch=None) -> np.ndarray:
        """One block's sorted low-16 values as uint32. With a
        DecodeScratch, decoded blocks land in its bounded block cache
        (read-only to callers)."""
        if scratch is not None:
            got = scratch.cache_get(self.sid, bi)
            if got is None:
                got = self._decode_lows(bi)
                scratch.cache_put(self.sid, bi, got)
            return got
        return self._decode_lows(bi)

    def _decode_lows(self, bi: int) -> np.ndarray:
        form = int(self.forms[bi])
        cnt = int(self.counts[bi])
        buf = self.block_payload(bi)
        if form == FORM_PACKED:
            deltas = _bitunpack(buf, cnt - 1, int(self.widths[bi]))
            out = np.empty(cnt, np.uint32)
            out[0] = self.bases[bi]
            if cnt > 1:
                np.cumsum(deltas, out=out[1:])
                out[1:] += np.uint32(self.bases[bi])
            return out
        if form == FORM_BITMAP:
            bits = np.unpackbits(buf, bitorder="little")
            return np.flatnonzero(bits).astype(np.uint32)
        # FORM_RUN
        runs = self.block_runs(bi)
        starts = runs[:, 0].astype(np.uint32)
        lens = runs[:, 1].astype(np.uint32) + 1
        total = int(lens.sum())
        out = np.empty(total, np.uint32)
        # concat of aranges: index - repeat(start offsets) + starts
        ends = np.cumsum(lens)
        out[:] = np.arange(total, dtype=np.uint32)
        out -= np.repeat((ends - lens).astype(np.uint32), lens)
        out += np.repeat(starts, lens)
        return out

    def block_bitmap(self, bi: int, scratch=None) -> np.ndarray:
        """One block as a 1024-word uint64 bitmap (BITMAP blocks view
        their payload zero-copy; other forms materialize)."""
        form = int(self.forms[bi])
        if form == FORM_BITMAP:
            return self.block_words(bi)
        words = _take_scratch(scratch, BITMAP_WORDS, np.uint64)
        words[:] = 0
        if form == FORM_RUN:
            runs = self.block_runs(bi)
            for s, lm1 in runs.tolist():
                e = s + lm1 + 1
                ws, we = s >> 6, (e - 1) >> 6
                if ws == we:
                    span = ~np.uint64(0) if e - s == 64 \
                        else (np.uint64(1) << np.uint64(e - s)) \
                        - np.uint64(1)
                    words[ws] |= span << np.uint64(s & 63)
                else:
                    words[ws] |= ~np.uint64(0) << np.uint64(s & 63)
                    words[ws + 1: we] = ~np.uint64(0)
                    words[we] |= ~np.uint64(0) >> np.uint64(
                        63 - ((e - 1) & 63))
            return words
        lows = self.block_lows(bi, scratch=None)
        words[:] = _bitmap_bytes(lows).view(np.uint64)
        return words

    def block_member(self, bi: int, lows: np.ndarray,
                     scratch=None) -> np.ndarray:
        """Bool mask: which `lows` (uint32) are in block `bi`: the
        no-decode membership probe (bitmap bit test / run interval
        probe; PACKED blocks decode, via the scratch block cache when
        one is given)."""
        form = int(self.forms[bi])
        if form == FORM_BITMAP:
            words = self.block_words(bi)
            return ((words[lows >> 6] >> (lows.astype(np.uint64)
                                          & np.uint64(63)))
                    & np.uint64(1)).astype(bool)
        if form == FORM_RUN:
            runs = self.block_runs(bi)
            starts = runs[:, 0].astype(np.uint32)
            ends = starts + runs[:, 1] + 1  # exclusive
            i = np.searchsorted(starts, lows, side="right") - 1
            ok = i >= 0
            i = np.maximum(i, 0)
            return ok & (lows < ends[i])
        mine = self.block_lows(bi, scratch=scratch)
        i = np.searchsorted(mine, lows)
        np.minimum(i, max(len(mine) - 1, 0), out=i)
        return mine[i] == lows if len(mine) else \
            np.zeros(len(lows), bool)

    def singleton_mask(self) -> np.ndarray:
        """Bool per block: count == 1. Singleton blocks are always
        PACKED with an empty payload (base IS the low value)."""
        return self.counts == 1

    def densify(self, out: np.ndarray | None = None,
                scratch=None) -> np.ndarray:
        """Decode the whole pack to a sorted uint64 uid vector (block
        decodes ride the scratch block cache when given)."""
        if out is None:
            out = np.empty(self.n, np.uint64)
        offs = np.cumsum(self.counts) - self.counts
        sing = self.singleton_mask()
        if sing.any():
            out[offs[sing]] = (self.keys[sing] << np.uint64(16)) \
                | self.bases[sing].astype(np.uint64)
        for bi in np.flatnonzero(~sing).tolist():
            cnt = int(self.counts[bi])
            pos = int(offs[bi])
            lows = self.block_lows(bi, scratch=scratch)
            out[pos: pos + cnt] = (np.uint64(self.keys[bi])
                                   << np.uint64(16)) \
                | lows.astype(np.uint64)
        return out[:self.n]


def compressed_pack_from_arrays(keys, forms, counts, widths, bases,
                                offsets, sizes, payload,
                                n) -> CompressedPack:
    """A CompressedPack over the given arrays (numpy, the reference's
    dtypes): carries a reference pack's state into the port."""
    return CompressedPack(
        np.asarray(keys, np.uint64), np.asarray(forms, np.uint8),
        np.asarray(counts, np.int64), np.asarray(widths, np.uint8),
        np.asarray(bases, np.uint16), np.asarray(offsets, np.int64),
        np.asarray(sizes, np.int64), np.asarray(payload, np.uint8), n)


def _take_scratch(scratch, n: int, dtype) -> np.ndarray:
    if scratch is None:
        return np.empty(n, dtype)
    return scratch.take(n, dtype)


_SID_LOCK = threading.Lock()
_SID = [0]


def _next_sid() -> int:
    with _SID_LOCK:
        _SID[0] += 1
        return _SID[0]


def _encode_block(lows: np.ndarray):
    """sorted-unique uint32 lows (< 2^16) -> (form, width, base,
    payload uint8). Picks the byte-smallest of the three forms, the
    density-adaptive roaring rule. The bitmap is built by
    `_bitmap_bytes`, the same bytes as the reference's scatter-OR into
    uint64 words."""
    cnt = len(lows)
    deltas = np.diff(lows)
    n_runs = int((deltas != 1).sum()) + 1 if cnt else 0
    run_bytes = 4 * n_runs
    width = int(deltas.max()).bit_length() if cnt > 1 else 0
    packed_bytes = ((cnt - 1) * width + 7) >> 3
    best = min(run_bytes, packed_bytes, _BITMAP_BYTES)
    if run_bytes == best:
        runs = np.empty((n_runs, 2), np.uint16)
        bounds = np.flatnonzero(deltas != 1)
        starts = np.concatenate(([0], bounds + 1))
        ends = np.concatenate((bounds, [cnt - 1]))
        runs[:, 0] = lows[starts]
        runs[:, 1] = (lows[ends] - lows[starts]).astype(np.uint16)
        return FORM_RUN, 0, 0, runs.reshape(-1).view(np.uint8)
    if packed_bytes == best:
        return (FORM_PACKED, width, int(lows[0]),
                _bitpack(deltas.astype(np.uint32), width))
    return FORM_BITMAP, 0, 0, _bitmap_bytes(lows)


def compress(uids: np.ndarray) -> CompressedPack:
    """Sorted-unique uint64 uids -> CompressedPack (host, numpy)."""
    uids = np.asarray(uids, dtype=np.uint64)
    n = len(uids)
    if n == 0:
        return CompressedPack(
            np.zeros(0, np.uint64), np.zeros(0, np.uint8),
            np.zeros(0, np.int64), np.zeros(0, np.uint8),
            np.zeros(0, np.uint16), np.zeros(1, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.uint8), 0)
    hi = uids >> np.uint64(16)
    keys, starts = np.unique(hi, return_index=True)
    bounds = np.append(starts, n)
    nb = len(keys)
    forms = np.zeros(nb, np.uint8)
    counts = np.zeros(nb, np.int64)
    widths = np.zeros(nb, np.uint8)
    bases = np.zeros(nb, np.uint16)
    offsets = np.zeros(nb + 1, np.int64)
    sizes = np.zeros(nb, np.int64)
    payloads: list[np.ndarray] = []
    blk_counts = np.diff(bounds)
    counts[:] = blk_counts
    # singleton blocks (the ultra-sparse regime) wholesale: PACKED,
    # width 0, empty payload, base = the low value
    sing = blk_counts == 1
    bases[sing] = (uids[bounds[:-1][sing]]
                   & np.uint64(0xFFFF)).astype(np.uint16)
    for bi in np.flatnonzero(~sing).tolist():
        lows = uids[bounds[bi]: bounds[bi + 1]].astype(np.uint32) \
            & np.uint32(0xFFFF)
        form, width, base, payload = _encode_block(lows)
        forms[bi] = form
        widths[bi] = width
        bases[bi] = base
        sizes[bi] = len(payload)
        payloads.append(payload)
        padded = (len(payload) + 7) & ~7  # keep offsets 8-aligned
        if padded != len(payload):
            payloads.append(np.zeros(padded - len(payload), np.uint8))
    np.cumsum((sizes + 7) & ~7, out=offsets[1:])
    payload = np.concatenate(payloads) if payloads \
        else np.zeros(0, np.uint8)
    return CompressedPack(keys, forms, counts, widths, bases,
                          offsets, sizes, payload, n)


def decompress(pack: CompressedPack) -> np.ndarray:
    """CompressedPack -> sorted uint64 uid vector."""
    return pack.densify()


# -- bounded decode scratch pool ---------------------------------------


class DecodeScratch:
    """Per-thread bounded decode pool for the compressed set-algebra
    kernels: a reusable arena for transient intermediates (bitmap
    accumulators, 2^16 counters) plus a bounded LRU of decoded posting
    blocks.

    Contracts: a `take()` view is valid until the NEXT take of the
    same arena; callers use it for intermediates consumed immediately,
    never for results that escape the query. `cache_get`/`cache_put`
    views are READ-ONLY to callers and evict LRU-first past
    `cache_budget`. Requests past `budget_bytes` allocate fresh and are
    not retained."""

    def __init__(self, budget_bytes: int = 4 << 20,
                 cache_budget: int = 8 << 20):
        self.budget = int(budget_bytes)
        self.cache_budget = int(cache_budget)
        # the arena is threading.local: every thread sees only its own
        # cells; the gauges are statistics where a lost update is
        # acceptable
        self._tls = threading.local()
        self.high_water = 0
        self.overflows = 0

    def _cache(self):
        c = getattr(self._tls, "cache", None)
        if c is None:
            c = self._tls.cache = OrderedDict()
            self._tls.cache_bytes = 0
        return c

    def cache_get(self, sid: int, bi: int):
        c = self._cache()
        got = c.get((sid, bi))
        if got is not None:
            c.move_to_end((sid, bi))
        return got

    def cache_put(self, sid: int, bi: int, arr) -> None:
        if arr.nbytes > self.cache_budget:
            return  # a whole-budget block: serve it, never retain it
        c = self._cache()
        c[(sid, bi)] = arr
        self._tls.cache_bytes += arr.nbytes
        while self._tls.cache_bytes > self.cache_budget:
            _, old = c.popitem(last=False)
            self._tls.cache_bytes -= old.nbytes
        self.high_water = max(self.high_water,
                              self._tls.cache_bytes)

    def take(self, n: int, dtype=np.uint64) -> np.ndarray:
        nbytes = int(n) * np.dtype(dtype).itemsize
        if nbytes > self.budget:
            self.overflows += 1
            return np.empty(n, dtype)
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.nbytes < nbytes:
            size = max(nbytes, min(self.budget,
                                   max(64 << 10, nbytes * 2)))
            buf = self._tls.buf = np.empty(size, np.uint8)
            self.high_water = max(self.high_water, size)
        return buf[:nbytes].view(dtype)

    def stats(self) -> dict:
        return {"budget": self.budget,
                "cacheBudget": self.cache_budget,
                "cacheBytes": int(getattr(self._tls, "cache_bytes",
                                          0)),
                "highWater": self.high_water,
                "overflows": self.overflows}


# -- group-varint at-rest stream (numpy) --------------------------------

_GV_WIDTH = np.array([1, 2, 4, 8], np.int64)


def gv_encode_np(uids: np.ndarray) -> bytes:
    """Group-varint delta encoder, byte-identical to the reference's
    native dgt_gv_encode stream: u64 count, u64 first uid, then groups
    of <=4 deltas behind a 2-bit-per-slot width tag."""
    a = np.ascontiguousarray(np.asarray(uids, np.uint64))
    n = len(a)
    head = int(n).to_bytes(8, "little")
    if n == 0:
        return head
    d = np.diff(a)  # uint64, wraps like the native subtraction
    wc = np.zeros(len(d), np.uint8)
    wc[d >= (1 << 8)] = 1
    wc[d >= (1 << 16)] = 2
    wc[d >= (1 << 32)] = 3
    widths = _GV_WIDTH[wc]
    ng = (len(d) + 3) // 4
    wcp = np.zeros(ng * 4, np.uint8)
    wcp[:len(d)] = wc
    tags = (wcp.reshape(ng, 4)
            * np.array([1, 4, 16, 64], np.uint8)).sum(
                axis=1).astype(np.uint8)
    cw = np.cumsum(widths) - widths        # delta payload bytes before i
    # delta i sits after 16 header bytes, (i//4 + 1) tag bytes, cw[i]
    pos = 16 + (np.arange(len(d)) // 4) + 1 + cw
    total = 16 + ng + int(widths.sum())
    out = np.zeros(total, np.uint8)
    out[:8] = np.frombuffer(head, np.uint8)
    out[8:16] = np.frombuffer(a[:1].tobytes(), np.uint8)
    out[16 + cw[::4][:ng] + np.arange(ng)] = tags
    j = np.arange(int(widths.sum())) - np.repeat(cw, widths)
    src = (d[np.repeat(np.arange(len(d)), widths)]
           >> (np.uint64(8) * j.astype(np.uint64))) & np.uint64(0xFF)
    out[np.repeat(pos, widths) + j] = src.astype(np.uint8)
    return out.tobytes()


def gv_decode_np(buf: bytes) -> np.ndarray:
    """Decoder for the group-varint stream of `gv_encode_np`."""
    raw = np.frombuffer(buf, np.uint8)
    if len(raw) < 8:
        raise ValueError("gv decode: truncated header")
    n = int(np.frombuffer(buf[:8], np.uint64)[0])
    if n == 0:
        return np.empty(0, np.uint64)
    if len(raw) < 16:
        raise ValueError("gv decode: truncated first uid")
    first = np.frombuffer(buf[8:16], np.uint64)[0]
    nd = n - 1
    ng = (nd + 3) // 4
    # tag positions depend on prior groups' widths: one cheap python
    # pass over GROUPS (n/4) finds them, the byte gather is vectorized
    tag_pos = np.zeros(ng, np.int64)
    wc = np.zeros(nd, np.uint8)
    p = 16
    for g in range(ng):
        if p >= len(raw):
            raise ValueError("gv decode: truncated tag")
        tag_pos[g] = p
        tag = int(raw[p])
        cnt = min(4, nd - g * 4)
        codes = (tag >> (2 * np.arange(cnt))) & 3
        wc[g * 4: g * 4 + cnt] = codes
        p += 1 + int(_GV_WIDTH[codes].sum())
    if p > len(raw):
        raise ValueError("gv decode: truncated payload")
    widths = _GV_WIDTH[wc]
    cw = np.cumsum(widths) - widths
    pos = np.repeat(tag_pos, np.minimum(
        4, nd - np.arange(ng) * 4)) + 1 + (cw - cw[(np.arange(nd)
                                                    // 4) * 4])
    j = np.arange(int(widths.sum())) - np.repeat(cw, widths)
    b = raw[np.repeat(pos, widths) + j].astype(np.uint64) \
        << (np.uint64(8) * j.astype(np.uint64))
    d = np.zeros(nd, np.uint64)
    np.add.at(d, np.repeat(np.arange(nd), widths), b)
    out = np.empty(n, np.uint64)
    out[0] = first
    np.cumsum(d, out=out[1:])
    out[1:] += first
    return out


_GV_W_OF = {0: 1, 1: 2, 2: 4, 3: 8}


def _gv_encode_py_small(a) -> bytes:
    """Scalar encoder for SHORT lists, byte-identical to gv_encode_np;
    the numpy path pays a fixed array-op overhead per call."""
    n = len(a)
    out = bytearray(n.to_bytes(8, "little"))
    if n == 0:
        return bytes(out)
    vals = a.tolist() if isinstance(a, np.ndarray) else list(a)
    out += int(vals[0]).to_bytes(8, "little")
    i = 1
    while i < n:
        grp = vals[i - 1:i + 4]
        tag = 0
        payload = bytearray()
        for k in range(len(grp) - 1):
            d = (grp[k + 1] - grp[k]) % (1 << 64)
            code = 0 if d < (1 << 8) else 1 if d < (1 << 16) \
                else 2 if d < (1 << 32) else 3
            tag |= code << (2 * k)
            payload += d.to_bytes(_GV_W_OF[code], "little")
        out.append(tag)
        out += payload
        i += 4
    return bytes(out)


def gv_encode(uids: np.ndarray) -> bytes:
    """Group-varint delta stream: native dgt_gv_encode, or with the
    runtime switched off the byte-identical scalar path for short lists
    (below the numpy path's fixed-overhead crossover) and numpy
    otherwise."""
    from dgraph_tpu_torch import native
    if native.available():
        return native.gv_encode(np.asarray(uids, np.uint64))
    if len(uids) < 48:
        return _gv_encode_py_small(uids)
    return gv_encode_np(uids)


def _gv_decode_py_small(buf: bytes) -> np.ndarray:
    """Scalar decoder for SHORT streams, equal to gv_decode_np; the
    numpy path pays a fixed array-op overhead per call, which dominated
    restoring the many short posting lists of a snapshot."""
    n = int.from_bytes(buf[:8], "little")
    if n == 0:
        return np.empty(0, np.uint64)
    if len(buf) < 16:
        raise ValueError("gv decode: truncated first uid")
    out = [int.from_bytes(buf[8:16], "little")]
    p = 16
    while len(out) < n:
        if p >= len(buf):
            raise ValueError("gv decode: truncated tag")
        tag = buf[p]
        p += 1
        for k in range(min(4, n - len(out))):
            w = _GV_W_OF[(tag >> (2 * k)) & 3]
            if p + w > len(buf):
                raise ValueError("gv decode: truncated payload")
            d = int.from_bytes(buf[p:p + w], "little")
            p += w
            out.append((out[-1] + d) & 0xFFFFFFFFFFFFFFFF)
    return np.asarray(out, np.uint64)


def gv_decode(buf: bytes) -> np.ndarray:
    """Decoder for the `gv_encode` stream: native dgt_gv_decode, or
    with the runtime switched off scalar for short streams, as the
    encoder, numpy otherwise."""
    from dgraph_tpu_torch import native
    if native.available():
        return native.gv_decode(buf)
    if len(buf) >= 8 and int.from_bytes(buf[:8], "little") < 48:
        return _gv_decode_py_small(buf)
    return gv_decode_np(buf)
