"""UID-set algebra microbenchmarks: the port's counterpart of
`bench_micro.py`'s three set-algebra benchmarks, plus the compressed AND at
a real size.

- `uid_intersect_bench`: the "UID-intersect GB/s" metric of
  BASELINE.json (the reference's algo/uidlist_test.go IntersectSorted
  microbench shape): K pairs of sorted uint32 lists a batch, through
  the batched `uidvec.intersect`, against np.intersect1d pair by pair.
  Bytes are those of the padded operands as uint32, (|a| + |b|) * 4,
  whatever the device dtype, so the figure reads against the
  reference's definition. The device time is taken with CUDA events on
  the card.
- `kway_bench`: the k-way host set algebra (`ops/setops`), k = 8 / 64
  / 512 sets, and the same sets through the one-call device variants
  (`union_many_device`, `intersect_many_device`).
- `setops_compressed_bench`: compressed against dense set algebra over
  four block-form mixes, and the selective gate (a small probe against
  a 2M-uid list: block skipping must beat decoding).
- `and_lists`: the `setops-and-67M` configuration, k = 4 seeded uniform
  posting lists over a 2^26-uid space with densities 1/2, 1/2, 1/4 and
  1/4 (boolean and four-label `@index(exact)` predicates), every 2^16
  block of which compresses to a bitmap.

Every function takes `device` (the card unless told otherwise) and
returns its records; each result is checked against its host oracle
and a mismatch raises.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from dgraph_tpu_torch import backend
from dgraph_tpu_torch.ops import codec, setops, uidvec

RUNS = 9
# (|a|, |b| / |a|, overlap, pairs a batch): bench_micro.py's main
UID_CONFIGS = [(1_000_000, 1, 0.3, 8), (65_536, 8, 0.1, 128),
               (16_384, 1, 0.3, 1024)]
# (sets, set size): bench_micro.kway_bench
KWAY_CONFIGS = [(8, 65_536), (64, 8_192), (512, 1_024)]
# (mix, n per set, uid span): bench_micro.setops_compressed_bench
COMPRESSED_CONFIGS = [
    ("array", 20_000, 1 << 34),   # sparse: packed blocks
    ("array", 200_000, 1 << 26),  # mid density
    ("bitmap", 200_000, 1 << 19),  # dense: bitmap blocks
    ("run", 100_000, 1 << 24),    # runny
]
# the selective gate: (list size, probe size, span)
GATE = (2_000_000, 2_000, 1 << 36)
# setops-and-67M: a 2^26-uid space, densities 2^-1, 2^-1, 2^-2, 2^-2
AND_SPACE_BITS = 26
AND_DENSITY_SHIFTS = (1, 1, 2, 2)


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """np.unique of a 1-D array by one sort and an adjacent compare: the
    same values, and it keeps the data's set-up time down on hosts where
    np.unique is many times slower than np.sort."""
    s = np.sort(x)
    if len(s) < 2:
        return s
    keep = np.empty(len(s), bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def make_pair(n_a: int, ratio: int, overlap: float, seed: int = 0):
    """Two sorted unique uint32 lists; |b| = n_a * ratio; ~overlap of
    a's elements also appear in b (the reference's sweep axes)."""
    rng = np.random.default_rng(seed)
    n_b = n_a * ratio
    space = np.uint32(4_000_000_000)
    b = sorted_unique(rng.integers(0, space, n_b, dtype=np.uint32))
    take = rng.random(len(b)) < (overlap * n_a / max(len(b), 1))
    shared = b[take][:n_a]
    fresh = sorted_unique(rng.integers(0, space, n_a, dtype=np.uint32))
    a = sorted_unique(np.concatenate([shared, fresh]))[:n_a]
    return a, b


def padded_stack(rows: list[np.ndarray], device: torch.device
                 ) -> torch.Tensor:
    """Sorted uint32 rows -> one [K, 2^ceil(log2 max len)] padded
    matrix on `device`, as bench_micro pads them."""
    size = 1 << (max(len(r) for r in rows) - 1).bit_length()
    mat = np.full((len(rows), size), uidvec.SENTINEL, np.int64)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    return torch.from_numpy(mat).to(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn: Callable[[], object], runs: int,
              device: torch.device) -> float:
    """Mean ms of one call of `fn`, after one warm-up: CUDA events
    around `runs` calls on the card, the host clock elsewhere."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def timed(fn: Callable[[], object], runs: int, device: torch.device):
    """Best wall seconds of `runs` calls (each ending with the device
    synchronised) and the last result."""
    best = float("inf")
    got = None
    for _ in range(runs):
        t0 = time.perf_counter()
        got = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, got


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def uid_intersect_bench(configs=UID_CONFIGS, runs: int = RUNS,
                        device: str | torch.device | None = None):
    """UID-intersect GB/s at each config -> (records, operands), where
    operands[i] = (pairs, da, db, out) of config i for later phases.
    Each record also times the two membership arms of `uidvec`
    (binary search and co-sort) on the same operands."""
    dev = backend.resolve_device(device)
    records, operands = [], []
    for n_a, ratio, overlap, k in configs:
        pairs = [make_pair(n_a, ratio, overlap, seed=s) for s in range(k)]
        da = padded_stack([a for a, _ in pairs], dev)
        db = padded_stack([b for _, b in pairs], dev)
        t0 = time.perf_counter()
        want = [np.intersect1d(a, b, assume_unique=True) for a, b in pairs]
        cpu_s = time.perf_counter() - t0
        out = uidvec.intersect(da, db)
        host = out.cpu().numpy()
        for i in range(k):
            _check(np.array_equal(host[i][host[i] != uidvec.SENTINEL],
                                  want[i]), f"intersect pair {i} of "
                   f"a={n_a} ratio={ratio} != np.intersect1d")
        search = uidvec._member_mask_search(da, db)
        _check(torch.equal(search, uidvec._member_mask_cosort(da, db)),
               "member_mask arms differ")
        ms = device_ms(lambda: uidvec.intersect(da, db), runs, dev)
        arm_ms = {
            "searchsorted": device_ms(
                lambda: uidvec._member_mask_search(da, db), runs, dev),
            "cosort": device_ms(
                lambda: uidvec._member_mask_cosort(da, db), runs, dev)}
        nbytes = (da.numel() + db.numel()) * 4
        records.append({
            "config": f"a={n_a} ratio={ratio} overlap={overlap} pairs={k}",
            "device": str(dev), "shape_a": list(da.shape),
            "shape_b": list(db.shape), "ms": ms,
            "device_gbps": nbytes / ms / 1e6,
            "cpu_gbps": nbytes / cpu_s / 1e9,
            "speedup": cpu_s * 1e3 / ms,
            "member_mask_ms": arm_ms})
        operands.append((pairs, da, db, out))
    return records, operands


def kway_sets(k: int, n: int, rng: np.random.Generator):
    """bench_micro.kway_bench's sets: k uniform sets of n draws over
    4kn uids, and for the intersections each set's first half plus one
    shared run, so the intersections are non-empty."""
    space = 4 * k * n
    sets = [sorted_unique(rng.integers(0, space, n).astype(np.uint64))
            for _ in range(k)]
    shared = sorted_unique(rng.integers(0, space, n // 4).astype(np.uint64))
    isets = [sorted_unique(np.concatenate([s[: n // 2], shared]))
             for s in sets]
    return sets, isets


def kway_bench(configs=KWAY_CONFIGS, runs: int = 5,
               device: str | torch.device | None = None) -> list[dict]:
    """k-way host set algebra and the one-call device variants on
    `device`, each result equal to the host k-way fold. (bench_micro.py's
    pairwise folds are left out: on hosts whose np.unique is slow they
    take minutes and measure only numpy.)"""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(7)
    out = []
    for k, n in configs:
        sets, isets = kway_sets(k, n, rng)
        ku_t, ku = timed(lambda: setops.union_many(sets), runs, dev)
        du_t, du = timed(lambda: setops.union_many_device(sets, dev),
                         runs, dev)
        ki_t, ki = timed(lambda: setops.intersect_many(isets), runs, dev)
        di_t, di = timed(lambda: setops.intersect_many_device(isets, dev),
                         runs, dev)
        _check(np.array_equal(ku, du), f"union of {k} x {n} differs")
        _check(np.array_equal(ki, di), f"intersection of {k} x {n} differs")
        rec = {"metric": "setops_kway", "sets": k, "set_size": n,
               "device": str(dev), "union_kway_ms": ku_t * 1e3,
               "union_device_ms": du_t * 1e3,
               "intersect_kway_ms": ki_t * 1e3,
               "intersect_device_ms": di_t * 1e3,
               "union_size": len(ku), "intersect_size": len(ki)}
        out.append(rec)
    return out


def compressed_set(rng: np.random.Generator, mix: str, n: int, span: int,
                   base: int = 0) -> np.ndarray:
    """One set of bench_micro.setops_compressed_bench's `mk`."""
    if mix == "run":
        starts = sorted_unique(rng.integers(
            0, span, max(n // 64, 1), dtype=np.uint64))
        s = sorted_unique(np.concatenate(
            [np.arange(st, st + 64, dtype=np.uint64)
             for st in starts]))[:n]
    elif mix == "bitmap":
        # dense inside few blocks
        s = sorted_unique(rng.integers(
            0, max(n * 3 // 2, 1), n, dtype=np.uint64))
    else:  # array/packed: sparse over the whole span
        s = sorted_unique(rng.integers(0, span, n, dtype=np.uint64))
    return s + np.uint64(base)


def setops_compressed_bench(configs=COMPRESSED_CONFIGS, gate=GATE,
                            runs: int = 5) -> dict:
    """Compressed against dense set algebra (host numpy, as in the
    reference): per config four sets of n (plus a shared quarter), the
    dense intersect, decode-then-intersect and the compressed
    intersect, the dense and compressed unions; then the selective
    gate, which the compressed intersect must win (bench_micro.py's
    default budget, 1.0). Returns {"records": [...], "gate": {...}}."""
    host = torch.device("cpu")
    rng = np.random.default_rng(20260803)
    scratch = codec.DecodeScratch()
    out = []
    for mix, n, span in configs:
        shared = compressed_set(rng, mix, n // 4, span)
        sets = [sorted_unique(np.concatenate(
            [compressed_set(rng, mix, n, span), shared]))
            for _ in range(4)]
        packs = [codec.compress(s) for s in sets]
        d_t, want = timed(lambda: setops.intersect_many(sets), runs, host)
        dd_t, got_d = timed(lambda: setops.intersect_many(
            [p.densify() for p in packs]), runs, host)
        c_t, got = timed(lambda: setops.intersect_packs(
            packs, scratch=scratch), runs, host)
        _check(np.array_equal(want, got) and np.array_equal(want, got_d),
               f"{mix} intersection differs")
        u_t, uw = timed(lambda: setops.union_many(sets), runs, host)
        cu_t, ug = timed(lambda: setops.union_packs(
            packs, scratch=scratch), runs, host)
        _check(np.array_equal(uw, ug), f"{mix} union differs")
        dense_b = sum(s.nbytes for s in sets)
        comp_b = sum(p.nbytes for p in packs)
        out.append({"metric": "setops_compressed", "mix": mix,
                    "set_size": n, "span_bits": span.bit_length() - 1,
                    "dense_intersect_ms": d_t * 1e3,
                    "decode_then_intersect_ms": dd_t * 1e3,
                    "compressed_intersect_ms": c_t * 1e3,
                    "dense_union_ms": u_t * 1e3,
                    "compressed_union_ms": cu_t * 1e3,
                    "bytes_dense": dense_b, "bytes_compressed": comp_b,
                    "bytes_ratio": dense_b / max(comp_b, 1),
                    "bitmap_blocks": [int((p.forms == codec.FORM_BITMAP)
                                          .sum()) for p in packs],
                    "intersect_size": len(want)})
    n_list, n_probe, span = gate
    big = compressed_set(rng, "array", n_list, span)
    probe = sorted_unique(np.concatenate(
        [compressed_set(rng, "array", n_probe, span),
         big[:: len(big) // 500]]))
    bigp, probep = codec.compress(big), codec.compress(probe)
    want = setops.intersect_many([probe, big])
    dd_t, got_d = timed(lambda: setops.intersect_many(
        [probep.densify(), bigp.densify()]), runs, host)
    c_t, got = timed(lambda: setops.intersect_packs(
        [probep, bigp], scratch=scratch), runs, host)
    _check(np.array_equal(want, got) and np.array_equal(want, got_d),
           "selective intersection differs")
    ratio = dd_t / max(c_t, 1e-9)
    return {"records": out,
            "gate": {"metric": "setops_compressed_selective",
                     "probe": len(probe), "list": len(big),
                     "decode_then_intersect_ms": dd_t * 1e3,
                     "compressed_intersect_ms": c_t * 1e3,
                     "block_skip_speedup": ratio,
                     "within_budget": ratio > 1.0}}


def and_lists(space_bits: int = AND_SPACE_BITS,
              shifts=AND_DENSITY_SHIFTS, seed: int = 0
              ) -> list[np.ndarray]:
    """Seeded uniform posting lists over a 2^space_bits uid space: list
    i holds each uid independently with probability 2^-shifts[i] (a
    uniform random bit ANDed shifts[i] times), as sorted uint64 uids."""
    rng = np.random.default_rng(seed)
    n_words = max(1, (1 << space_bits) // 64)
    out = []
    for s in shifts:
        words = np.frombuffer(rng.bytes(n_words * 8), np.uint64).copy()
        for _ in range(s - 1):
            words &= np.frombuffer(rng.bytes(n_words * 8), np.uint64)
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        out.append(np.flatnonzero(bits[: 1 << space_bits]).astype(np.uint64))
    return out
