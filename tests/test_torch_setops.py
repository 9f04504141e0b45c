"""The port's set algebra (dgraph_tpu_torch.ops.setops) against the
reference (dgraph_tpu.ops.setops) on the CPU, byte for byte: the host
folds of tests/test_setops.py, the fuzz cases of
tests/test_codec_compressed.py over compressed and mixed operands, the
device variants on CPU tensors against the reference's JAX ones, and
the device route of `intersect_packs` (the word-AND of its all-bitmap
keys through `kernels.bitmap_and`) against the reference's jitted and
Pallas (interpret mode) routes. This plane is integer: no tolerance
applies anywhere.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import codec as jcodec
from dgraph_tpu.ops import setops as jset
from dgraph_tpu_torch.ops import codec as tcodec
from dgraph_tpu_torch.ops import kernels
from dgraph_tpu_torch.ops import setops as tset

RNG = np.random.default_rng
ARRAYS = ("keys", "forms", "counts", "widths", "bases", "offsets", "sizes",
          "payload")


def same(want, got):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def carried(pack):
    return tcodec.compressed_pack_from_arrays(
        *(getattr(pack, name) for name in ARRAYS), pack.n)


def _rand_sets(rng, k, lo=0, hi=1 << 20, maxlen=4000):
    return [np.unique(rng.integers(lo, hi, int(rng.integers(0, maxlen)))
                      .astype(np.uint64)) for _ in range(k)]


# -- host folds (tests/test_setops.py) ----------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 8, 33])
def test_union_and_intersect_many_match_reference(k):
    rng = RNG(k)
    for _ in range(4):
        parts = _rand_sets(rng, k)
        same(jset.union_many(parts), tset.union_many(parts))
        iparts = _rand_sets(rng, k, hi=3000)
        same(jset.intersect_many(iparts), tset.intersect_many(iparts))
        ratios = [int(r) for r in rng.integers(2, 60, k)]
        same(jset.intersect_many(iparts, ratios),
             tset.intersect_many(iparts, ratios))


def test_edge_cases_match_reference():
    e = np.empty(0, np.uint64)
    a = np.array([1, 5, 9], np.uint64)
    big = np.arange(0, 100000, 3, dtype=np.uint64)
    for fn, args in [("union_many", ([],)), ("intersect_many", ([],)),
                     ("union_many", ([e, a, e],)),
                     ("intersect_many", ([a, e],)),
                     ("union_many", ([a],)), ("intersect_many", ([a],)),
                     ("intersect_pair", (a, big)),
                     ("intersect_pair", (big, a, 4)),
                     ("union_pair", (a, big)), ("union_pair", (e, a)),
                     ("difference", (big[:50], big[20:]))]:
        same(getattr(jset, fn)(*args), getattr(tset, fn)(*args))


@pytest.mark.parametrize("need", [1, 2, 5, 8, 17, 18])
def test_count_filter_matches_reference(need):
    parts = _rand_sets(RNG(need), 17, hi=4000, maxlen=900)
    same(jset.count_filter(parts, need), tset.count_filter(parts, need))


@pytest.mark.parametrize("k", [2, 5, 9])
def test_device_variants_on_cpu_match_reference(k):
    """The *_device variants with CPU tensors against the reference's
    (JAX on the CPU)."""
    parts = _rand_sets(RNG(7 + k), k, hi=5000, maxlen=800)
    same(jset.union_many_device(parts),
         tset.union_many_device(parts, device="cpu"))
    same(jset.intersect_many_device(parts),
         tset.intersect_many_device(parts, device="cpu"))
    same(jset.union_many(parts), tset.union_many_device(parts, "cpu"))


def test_device_matrix_matches_reference_padding():
    parts = _rand_sets(RNG(3), 5, hi=5000, maxlen=300)
    want = jset._device_matrix(parts)
    got = tset._device_matrix(parts)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_device_variants_reject_wide_uids():
    wide = np.array([1, 2, 0xFFFFFFFF00], np.uint64)
    other = np.array([1, 2, 3], np.uint64)
    assert jset.union_many_device([wide, other]) is None
    assert tset.union_many_device([wide, other], device="cpu") is None
    assert tset.intersect_many_device([wide, other], device="cpu") is None
    assert tset._device_matrix([wide, other]) is None
    same(jset.union_many([wide, other]), tset.union_many([wide, other]))


# -- compressed and mixed operands (tests/test_codec_compressed.py) ------------


def _fuzz_sets(rng, k):
    space = int(rng.choice([2_000, 90_000, 1 << 22, 1 << 40]))
    sets = []
    for _ in range(k):
        mode = rng.integers(0, 3)
        n = int(rng.integers(0, 8_000))
        if mode == 0:
            s = np.unique(rng.integers(0, space, n, dtype=np.uint64))
        elif mode == 1:
            starts = rng.integers(0, space, max(n // 40, 1), dtype=np.uint64)
            s = np.unique(np.concatenate(
                [np.arange(st, st + int(rng.integers(1, 90)),
                           dtype=np.uint64) for st in starts]))
        else:
            s = (np.cumsum(rng.integers(1, 30, n + 1).astype(np.uint64))
                 + np.uint64(rng.integers(space)))
        sets.append(s)
    shared = np.unique(rng.integers(0, space, 400, dtype=np.uint64))
    return [np.unique(np.concatenate([s, shared])) for s in sets]


@pytest.mark.parametrize("seed", range(12))
def test_pack_algebra_fuzz_matches_reference(seed):
    rng = RNG(seed)
    k = int(rng.integers(2, 6))
    sets = _fuzz_sets(rng, k)
    jp = [jcodec.compress(s) for s in sets]
    tp = [tcodec.compress(s) for s in sets]
    cp = [carried(p) for p in jp]
    need = int(rng.integers(1, k + 1))
    js, ts = jcodec.DecodeScratch(), tcodec.DecodeScratch()
    want = {"i": jset.intersect_packs(jp, scratch=js),
            "u": jset.union_packs(jp, scratch=js),
            "d": jset.difference_pack(jp[0], jp[1], scratch=js),
            "c": jset.count_filter_packs(jp, need, scratch=js)}
    same(jset.intersect_many(sets), want["i"])
    for packs in (tp, cp):
        same(want["i"], tset.intersect_packs(packs, scratch=ts))
        same(want["i"], tset.intersect_packs(packs))
        same(want["u"], tset.union_packs(packs, scratch=ts))
        same(want["d"], tset.difference_pack(packs[0], packs[1], scratch=ts))
        same(want["c"], tset.count_filter_packs(packs, need, scratch=ts))
        same(want["c"], tset.count_filter(sets, need))


@pytest.mark.parametrize("seed", range(6))
def test_mixed_algebra_fuzz_matches_reference(seed):
    rng = RNG(100 + seed)
    k = int(rng.integers(2, 6))
    sets = _fuzz_sets(rng, k)
    jops = [jcodec.compress(s) if (i + seed) % 2 else s
            for i, s in enumerate(sets)]
    tops = [carried(o) if (i + seed) % 2 else o for i, o in enumerate(jops)]
    need = int(rng.integers(1, k + 1))
    js, ts = jcodec.DecodeScratch(), tcodec.DecodeScratch()
    same(jset.intersect_mixed(jops, scratch=js),
         tset.intersect_mixed(tops, scratch=ts))
    same(jset.union_mixed(jops, scratch=js),
         tset.union_mixed(tops, scratch=ts))
    same(jset.count_filter_mixed(jops, need, scratch=js),
         tset.count_filter_mixed(tops, need, scratch=ts))
    probe = np.unique(np.concatenate([sets[0][::7], sets[-1][::5]]))
    for jo, to in zip(jops, tops):
        if not isinstance(jo, np.ndarray):
            np.testing.assert_array_equal(tset.pack_member(to, probe),
                                          jset.pack_member(jo, probe))


def test_pack_member_block_skipping():
    p = tcodec.compress(np.arange(1000, dtype=np.uint64))
    probe = np.array([0, 500, 999, 1000, 1 << 30], np.uint64)
    np.testing.assert_array_equal(tset.pack_member(p, probe),
                                  [True, True, True, False, False])


def test_intersect_disjoint_blocks_never_decodes(monkeypatch):
    a = tcodec.compress(np.arange(100, dtype=np.uint64))
    b = tcodec.compress(np.arange(100, dtype=np.uint64) + np.uint64(1 << 20))
    calls = []
    orig = tcodec.CompressedPack.block_lows
    monkeypatch.setattr(tcodec.CompressedPack, "block_lows",
                        lambda self, bi, scratch=None:
                        calls.append(bi) or orig(self, bi, scratch))
    assert len(tset.intersect_packs([a, b])) == 0
    assert not calls


# -- the device route of intersect_packs --------------------------------------


def bitmap_sets(n_sets=3, span=1 << 19, n=150_000, seed=3):
    """tests/test_codec_compressed.py's device case: 8 blocks of 2^16,
    dense enough that every block of every set is a bitmap."""
    rng = RNG(seed)
    return [np.unique(rng.integers(0, span, n, dtype=np.uint64))
            for _ in range(n_sets)]


@pytest.fixture
def counted(monkeypatch):
    """Record every stack bitmap_and_device hands to the kernel's
    wrapper."""
    calls = []
    real = kernels.bitmap_and

    def spy(mats):
        calls.append(tuple(mats.shape))
        return real(mats)

    monkeypatch.setattr(kernels, "bitmap_and", spy)
    return calls


def test_intersect_packs_device_route_matches_reference(counted):
    sets = bitmap_sets()
    jp = [jcodec.compress(s) for s in sets]
    assert all((p.forms == jcodec.FORM_BITMAP).all() and len(p.keys) == 8
               for p in jp)
    want = jset.intersect_many(sets)
    for use_pallas in (False, True):
        same(want, jset.intersect_packs(jp, device=True,
                                        use_pallas=use_pallas))
    tp = [carried(p) for p in jp]
    same(want, tset.intersect_packs(tp, device="cpu"))
    same(want, tset.intersect_packs(tp, device=torch.device("cpu")))
    same(want, tset.intersect_mixed(tp, device="cpu"))
    same(want, tset.intersect_packs(tp))                 # the host fold
    # one k-way stack per device call, none for the host fold
    assert counted == [(3, 8, 1024)] * 3


def test_bitmap_and_device_matches_reference_routes():
    from dgraph_tpu.ops.pallas_kernels import bitmap_and_pallas

    import jax.numpy as jnp

    rng = RNG(5)
    mats = [rng.integers(0, 2**64, (9, 1024), dtype=np.uint64)
            for _ in range(4)]
    got = tset.bitmap_and_device(mats, device="cpu")
    assert got.dtype == np.uint64 and got.shape == (9, 1024)
    np.testing.assert_array_equal(got, jset.bitmap_and_device(mats))
    np.testing.assert_array_equal(
        got, jset.bitmap_and_device(mats, use_pallas=True))
    acc = mats[0].view(np.uint32)
    for m in mats[1:]:
        acc = np.asarray(bitmap_and_pallas(jnp.asarray(acc),
                                           jnp.asarray(m.view(np.uint32)),
                                           interpret=True))
    np.testing.assert_array_equal(got, acc.view(np.uint64))


def test_device_route_needs_eight_bitmap_keys(counted):
    """The reference's threshold: fewer than 8 all-bitmap keys fold on
    the host whatever `device` says."""
    sets = bitmap_sets(span=7 << 16, n=130_000)
    tp = [tcodec.compress(s) for s in sets]
    assert all(len(p.keys) == 7 and (p.forms == tcodec.FORM_BITMAP).all()
               for p in tp)
    same(jset.intersect_many(sets), tset.intersect_packs(tp, device="cpu"))
    assert counted == []


def test_device_route_raises_without_card(monkeypatch):
    """device=True or None means the card: no card is an error, never a
    quiet host fold."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp = [tcodec.compress(s) for s in bitmap_sets()]
    for dev in (True, None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tset.intersect_packs(tp, device=dev)


def test_device_route_propagates_kernel_failure(monkeypatch):
    """A kernel that fails on the device route raises through
    intersect_packs; nothing folds on the host instead."""
    def broken(mats):
        raise RuntimeError("bitmap_and kernel launch failed: CUDA error 700")

    monkeypatch.setattr(kernels, "bitmap_and", broken)
    tp = [tcodec.compress(s) for s in bitmap_sets()]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tset.intersect_packs(tp, device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tset.intersect_mixed(tp, device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tset.bitmap_and_device([p.block_words(0)[None] for p in tp], "cpu")
