"""The port's UID codec (dgraph_tpu_torch.ops.codec) against the
reference (dgraph_tpu.ops.codec) on the CPU, byte for byte: the
compressed packs of the adversarial shapes of
tests/test_codec_compressed.py (every array, dtype and payload byte),
their per-block views, the group-varint streams against the reference's
native encoder, and the UidPack32 encode / decode_padded pair. This
plane is integer: no tolerance applies anywhere.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu.ops import codec as jcodec
from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.ops import codec as tcodec
from dgraph_tpu_torch.ops import uidvec as tuv

RNG = np.random.default_rng
ARRAYS = ("keys", "forms", "counts", "widths", "bases", "offsets", "sizes",
          "payload")
# per-block views are checked on at most this many blocks of a shape
MAX_BLOCKS = 40


def _shapes():
    """tests/test_codec_compressed.py's adversarial uid sets."""
    rng = RNG(7)
    yield "empty", np.empty(0, np.uint64)
    yield "singleton", np.array([0], np.uint64)
    yield "max_uid", np.array([2**64 - 1], np.uint64)
    yield "min_and_max", np.array([0, 2**64 - 1], np.uint64)
    yield "block_straddle", np.arange(65530, 65550, dtype=np.uint64)
    yield "full_block", np.arange(1 << 16, dtype=np.uint64)
    yield "overfull_block", np.arange((1 << 16) - 1, (1 << 17) + 1,
                                      dtype=np.uint64)
    yield "word_run", np.arange(128, 192, dtype=np.uint64)
    yield "block_singletons", (np.arange(500, dtype=np.uint64)
                               << np.uint64(16)) + np.uint64(7)
    steps = rng.integers(1, 60, 100_000).astype(np.uint64)
    yield "clustered", np.cumsum(steps)
    yield "sparse_u64", np.unique(
        rng.integers(0, 2**63, 50_000, dtype=np.uint64))
    yield "dense_blocks", np.unique(
        rng.integers(0, 3 << 16, 80_000, dtype=np.uint64))
    parts = [np.arange(s, s + int(rng.integers(1, 300)), dtype=np.uint64)
             for s in rng.integers(0, 1 << 24, 200, dtype=np.uint64)]
    parts.append(rng.integers(0, 1 << 24, 500, dtype=np.uint64))
    yield "runs_and_dust", np.unique(np.concatenate(parts))


SHAPES = list(_shapes())


def same_arrays(want, got):
    """Every array of two packs equal in dtype, shape and bytes."""
    for name in ARRAYS:
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert got.n == want.n and got.nbytes == want.nbytes


def carried(pack):
    """The reference pack's state as a port pack."""
    return tcodec.compressed_pack_from_arrays(
        *(getattr(pack, name) for name in ARRAYS), pack.n)


@pytest.mark.parametrize("name,uids", SHAPES, ids=[s[0] for s in SHAPES])
def test_compress_arrays_byte_identical(name, uids):
    want = jcodec.compress(uids)
    got = tcodec.compress(uids)
    same_arrays(want, got)
    assert got.host_resident
    np.testing.assert_array_equal(got.densify(), uids)
    assert got.densify().dtype == np.uint64
    np.testing.assert_array_equal(tcodec.decompress(got), want.densify())
    assert len(got) == len(uids)
    # the carried state is the same pack
    same_arrays(want, carried(want))
    np.testing.assert_array_equal(carried(want).densify(), uids)


@pytest.mark.parametrize("name,uids", SHAPES, ids=[s[0] for s in SHAPES])
def test_block_views_agree(name, uids):
    want = jcodec.compress(uids)
    got = carried(want)
    rng = RNG(len(uids))
    wscr, tscr = jcodec.DecodeScratch(), tcodec.DecodeScratch()
    for bi in range(min(len(want.keys), MAX_BLOCKS)):
        lows = want.block_lows(bi)
        np.testing.assert_array_equal(got.block_lows(bi), lows)
        assert got.block_lows(bi).dtype == lows.dtype == np.uint32
        np.testing.assert_array_equal(got.block_lows(bi, scratch=tscr),
                                      want.block_lows(bi, scratch=wscr))
        np.testing.assert_array_equal(got.block_bitmap(bi),
                                      want.block_bitmap(bi))
        probe = np.unique(np.concatenate([
            lows[:: max(1, len(lows) // 50)],
            rng.integers(0, 1 << 16, 64).astype(np.uint32)]))
        np.testing.assert_array_equal(got.block_member(bi, probe),
                                      want.block_member(bi, probe))
        key = int(want.keys[bi])
        assert got.block_of(key) == want.block_of(key) == bi
    assert got.block_of(2**48 - 1) == want.block_of(2**48 - 1)
    np.testing.assert_array_equal(got.singleton_mask(),
                                  want.singleton_mask())
    np.testing.assert_array_equal(got.densify(scratch=tscr),
                                  want.densify(scratch=wscr))


def test_form_choice_by_density_matches_reference():
    cases = [np.arange(1 << 16, dtype=np.uint64),
             np.unique(RNG(0).integers(0, 1 << 16, 40_000, dtype=np.uint64)),
             np.unique(RNG(0).integers(0, 1 << 16, 200, dtype=np.uint64))]
    forms = [tcodec.FORM_RUN, tcodec.FORM_BITMAP, tcodec.FORM_PACKED]
    for uids, form in zip(cases, forms):
        assert list(tcodec.compress(uids).forms) == [form]
        same_arrays(jcodec.compress(uids), tcodec.compress(uids))
    assert (tcodec.FORM_PACKED, tcodec.FORM_BITMAP, tcodec.FORM_RUN) == \
        (jcodec.FORM_PACKED, jcodec.FORM_BITMAP, jcodec.FORM_RUN)
    assert (tcodec.BLOCK_SPAN, tcodec.BITMAP_WORDS, tcodec.BLOCK_SIZE) == \
        (jcodec.BLOCK_SPAN, jcodec.BITMAP_WORDS, jcodec.BLOCK_SIZE)


@pytest.mark.parametrize("density", [2, 4, 8, 64])
def test_bitmap_bytes_match_reference_scatter(density):
    """The port builds a bitmap with packbits; the reference ORs bits
    into uint64 words. Same bytes at every density of one block."""
    rng = RNG(density)
    lows = np.flatnonzero(rng.integers(0, density, 1 << 16) == 0) \
        .astype(np.uint32)
    words = np.zeros(tcodec.BITMAP_WORDS, np.uint64)
    np.bitwise_or.at(words, lows >> 6,
                     np.uint64(1) << (lows & np.uint64(63)))
    assert tcodec._bitmap_bytes(lows).tobytes() == words.tobytes()
    got, want = tcodec._encode_block(lows), jcodec._encode_block(lows)
    assert got[:3] == want[:3]
    assert got[3].tobytes() == want[3].tobytes()


# -- the group-varint at-rest stream -----------------------------------------


def _gv_cases():
    rng = RNG(11)
    yield np.empty(0, np.uint64)
    yield np.array([0], np.uint64)
    yield np.array([2**64 - 1], np.uint64)
    yield np.array([0, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32,
                    2**64 - 1], np.uint64)
    yield np.arange(1000, dtype=np.uint64)
    yield np.unique(rng.integers(0, 2**63, 10_000, dtype=np.uint64))
    yield np.cumsum(rng.integers(1, 2**40, 513).astype(np.uint64))


GV = list(enumerate(_gv_cases()))


@pytest.mark.parametrize("i,uids", GV, ids=[str(i) for i, _ in GV])
def test_gv_stream_byte_identical_to_reference(i, uids):
    stream = tcodec.gv_encode_np(uids)
    # the reference's gv_encode: its native encoder where that library
    # is built, its numpy encoder otherwise; both one byte format
    assert stream == jcodec.gv_encode(uids)
    assert stream == jcodec.gv_encode_np(uids)
    np.testing.assert_array_equal(tcodec.gv_decode_np(stream), uids)
    np.testing.assert_array_equal(jcodec.gv_decode(stream), uids)
    np.testing.assert_array_equal(
        tcodec.gv_decode_np(jcodec.gv_encode(uids)), uids)


def test_gv_small_scalar_encoder_matches_reference():
    rng = RNG(23)
    cases = [np.empty(0, np.uint64), np.array([0], np.uint64),
             np.array([2**64 - 1], np.uint64),
             np.array([0, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32,
                       2**64 - 1], np.uint64)]
    cases += [np.unique(rng.integers(0, 2**48, n, dtype=np.uint64))
              for n in range(1, 64)]
    for uids in cases:
        small = tcodec._gv_encode_py_small(uids)
        assert small == jcodec._gv_encode_py_small(uids)
        assert small == tcodec.gv_encode_np(uids) == jcodec.gv_encode(uids)


def test_gv_decode_rejects_truncation():
    buf = tcodec.gv_encode_np(np.arange(100, dtype=np.uint64))
    for cut in (5, 12, 20):
        with pytest.raises(ValueError):
            tcodec.gv_decode_np(buf[:cut])
        with pytest.raises(ValueError):
            jcodec.gv_decode_np(buf[:cut])


# -- the decode scratch pool ---------------------------------------------------


def test_scratch_pool_matches_reference():
    for mod in (jcodec, tcodec):
        sc = mod.DecodeScratch(budget_bytes=1 << 12, cache_budget=1 << 13)
        a = sc.take(16, np.uint64)
        a[:] = 7
        big = sc.take(1 << 20, np.uint64)
        assert big.nbytes == (1 << 20) * 8 and sc.overflows == 1
        for bi in range(6):
            sc.cache_put(1, bi, np.zeros(512, np.uint32))   # 2 KiB each
        assert sc.cache_get(1, 0) is None and sc.cache_get(1, 5) is not None
        if mod is jcodec:
            want = sc.stats()
        else:
            assert sc.stats() == want


# -- UidPack32: encode / decode_padded ----------------------------------------


def clustered_uids(rng, n, spread=100):
    return np.cumsum(rng.integers(1, spread, size=n).astype(np.uint64)) \
        .astype(np.uint32)


ENCODE_CASES = [np.array([1, 2, 70_000, 70_001, 5_000_000, 4_000_000_000],
                         np.uint32),
                np.array([0, 2**32 - 2], np.uint32)]
ENCODE_CASES += [clustered_uids(RNG(n), n)
                 for n in (0, 1, 2, 255, 256, 257, 1000, 20_000)]


@pytest.mark.parametrize("uids", ENCODE_CASES,
                         ids=[f"n{len(u)}_{i}"
                              for i, u in enumerate(ENCODE_CASES)])
def test_encode_and_decode_padded_match_reference(uids):
    want = jcodec.encode(uids)
    got = tcodec.encode(uids)
    for name in ("bases", "deltas", "counts"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert got.n == want.n and got.nbytes == want.nbytes
    size = juv.pad_to(len(uids))
    jdec = np.asarray(jcodec.decode_padded(want, size))
    for pack in (got, got.device("cpu"), tcodec.UidPack32(
            want.bases, want.deltas, want.counts, want.n)):
        dec = tcodec.decode_padded(pack, size, device="cpu")
        assert dec.dtype == torch.int64 and tuple(dec.shape) == (size,)
        np.testing.assert_array_equal(dec.numpy(), jdec.astype(np.int64))
        np.testing.assert_array_equal(tuv.to_numpy(dec), uids)
    # a size shorter and longer than the pack
    for s in (max(1, len(uids) // 2), size * 2):
        np.testing.assert_array_equal(
            tcodec.decode_padded(got, s, device="cpu").numpy(),
            np.asarray(jcodec.decode_padded(want, s)).astype(np.int64))


def test_uidpack_device_widens_types():
    pack = tcodec.encode(clustered_uids(RNG(1), 600)).device("cpu")
    assert pack.bases.dtype == torch.int64
    assert pack.deltas.dtype == torch.int32
    assert pack.counts.dtype == torch.int32
    assert pack.nbytes == 3 * 8 + 3 * 255 * 4 + 3 * 4


def test_decode_padded_defaults_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodec.decode_padded(tcodec.encode(np.arange(5, dtype=np.uint32)), 8)
