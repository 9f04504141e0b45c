"""The set-algebra plane as a whole: the port's benchmark helpers
(dgraph_tpu_torch.bench.setops) against bench_micro.py's benchmarks and
the reference's functions, at small sizes on the CPU. The same seeds
must draw the same pairs and sets, and every result must equal the
reference's, byte for byte.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench_micro
from dgraph_tpu.ops import codec as jcodec
from dgraph_tpu.ops import setops as jset
from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.bench import setops as bs
from dgraph_tpu_torch.ops import codec as tcodec
from dgraph_tpu_torch.ops import setops as tset

UID_CONFIGS = [(4_000, 1, 0.3, 4), (512, 8, 0.1, 8), (256, 1, 0.3, 16)]


@pytest.mark.parametrize("n_a,ratio,overlap", [(1_000, 1, 0.3),
                                               (512, 8, 0.1),
                                               (3, 1, 1.0), (1, 4, 0.0)])
@pytest.mark.parametrize("seed", [0, 5])
def test_make_pair_draws_bench_micros_pairs(n_a, ratio, overlap, seed):
    got = bs.make_pair(n_a, ratio, overlap, seed=seed)
    want = bench_micro.make_pair(n_a, ratio, overlap, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_sorted_unique_is_np_unique(n):
    x = np.random.default_rng(n).integers(0, 50, n).astype(np.uint64)
    got = bs.sorted_unique(x)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, np.unique(x))


def test_uid_intersect_bench_matches_vmap_of_reference():
    """bench_micro.py's main: K pairs a call, padded to powers of two,
    through jax.vmap(intersect); the port's batched intersect."""
    records, operands = bs.uid_intersect_bench(UID_CONFIGS, runs=1,
                                               device="cpu")
    vmapped = jax.jit(jax.vmap(juv.intersect))
    for (n_a, ratio, overlap, k), rec, (pairs, da, db, out) in zip(
            UID_CONFIGS, records, operands):
        sz_a = max(len(a) for a, _ in pairs)
        sz_b = max(len(b) for _, b in pairs)
        ja = jnp.stack([juv.from_numpy(a, size=1 << (sz_a - 1).bit_length())
                        for a, _ in pairs])
        jb = jnp.stack([juv.from_numpy(b, size=1 << (sz_b - 1).bit_length())
                        for _, b in pairs])
        assert tuple(da.shape) == ja.shape and tuple(db.shape) == jb.shape
        np.testing.assert_array_equal(da.numpy(),
                                      np.asarray(ja).astype(np.int64))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(vmapped(ja, jb)).astype(np.int64))
        for (a, b), (wa, wb) in zip(pairs, [bench_micro.make_pair(
                n_a, ratio, overlap, seed=s) for s in range(k)]):
            np.testing.assert_array_equal(a, wa)
            np.testing.assert_array_equal(b, wb)
        assert rec["shape_a"] == list(ja.shape)
        assert rec["device"] == "cpu" and rec["device_gbps"] > 0
        # the reference's bytes: uint32 operands, whatever the dtype
        assert rec["device_gbps"] == pytest.approx(
            (ja.size + jb.size) * 4 / rec["ms"] / 1e6)


def _bench_micro_kway_sets(k, n, rng):
    """bench_micro.kway_bench's draws, as written there."""
    space = 4 * k * n
    sets = [np.unique(rng.integers(0, space, n).astype(np.uint64))
            for _ in range(k)]
    shared = np.unique(rng.integers(0, space, n // 4).astype(np.uint64))
    isets = [np.unique(np.concatenate([s[: n // 2], shared])) for s in sets]
    return sets, isets


def test_kway_bench_matches_reference():
    configs = [(8, 512), (64, 64), (5, 1)]
    records = bs.kway_bench(configs, runs=1, device="cpu")
    rng_port, rng_ref = np.random.default_rng(7), np.random.default_rng(7)
    for (k, n), rec in zip(configs, records):
        sets, isets = bs.kway_sets(k, n, rng_port)
        wsets, wisets = _bench_micro_kway_sets(k, n, rng_ref)
        for got, want in zip(sets + isets, wsets + wisets):
            np.testing.assert_array_equal(got, want)
        assert rec["union_size"] == len(jset.union_many(wsets))
        assert rec["intersect_size"] == len(jset.intersect_many(wisets))
        assert rec["sets"] == k and rec["set_size"] == n
        for key in ("union_kway_ms", "union_device_ms", "intersect_kway_ms",
                    "intersect_device_ms"):
            assert rec[key] > 0


def _bench_micro_mk(rng, mix, n, span):
    """bench_micro.setops_compressed_bench's `mk`, as written there."""
    if mix == "run":
        starts = np.unique(rng.integers(0, span, max(n // 64, 1),
                                        dtype=np.uint64))
        return np.unique(np.concatenate(
            [np.arange(st, st + 64, dtype=np.uint64) for st in starts]))[:n]
    if mix == "bitmap":
        return np.unique(rng.integers(0, max(n * 3 // 2, 1), n,
                                      dtype=np.uint64))
    return np.unique(rng.integers(0, span, n, dtype=np.uint64))


def test_setops_compressed_bench_matches_reference():
    configs = [("array", 2_000, 1 << 34), ("array", 4_000, 1 << 20),
               ("bitmap", 20_000, 1 << 19), ("run", 5_000, 1 << 24)]
    gate = (20_000, 200, 1 << 36)
    res = bs.setops_compressed_bench(configs, gate, runs=1)
    rng = np.random.default_rng(20260803)
    for (mix, n, span), rec in zip(configs, res["records"]):
        shared = _bench_micro_mk(rng, mix, n // 4, span)
        sets = [np.unique(np.concatenate(
            [_bench_micro_mk(rng, mix, n, span), shared])) for _ in range(4)]
        packs = [jcodec.compress(s) for s in sets]
        assert rec["intersect_size"] == len(jset.intersect_packs(packs))
        assert rec["bytes_compressed"] == sum(p.nbytes for p in packs)
        assert rec["bytes_dense"] == sum(s.nbytes for s in sets)
        assert rec["bitmap_blocks"] == [
            int((p.forms == jcodec.FORM_BITMAP).sum()) for p in packs]
    big = _bench_micro_mk(rng, "array", gate[0], gate[2])
    probe = np.unique(np.concatenate(
        [_bench_micro_mk(rng, "array", gate[1], gate[2]),
         big[:: len(big) // 500]]))
    g = res["gate"]
    assert g["probe"] == len(probe) and g["list"] == len(big)
    assert g["block_skip_speedup"] > 0
    assert g["within_budget"] == (g["block_skip_speedup"] > 1.0)


def test_and_lists_small_space_all_bitmaps_and_device_route():
    """setops-and-67M's generator at 2^20 uids (16 blocks): densities
    1/2, 1/2, 1/4, 1/4, every block a bitmap, and intersect_packs on the
    device route (CPU tensors) equal to the reference's device route and
    to the dense fold."""
    lists = bs.and_lists(space_bits=20)
    assert [x.dtype for x in lists] == [np.dtype(np.uint64)] * 4
    for x, s in zip(lists, bs.AND_DENSITY_SHIFTS):
        assert abs(len(x) / (1 << 20) - 2.0 ** -s) < 0.01
        assert int(x[-1]) < 1 << 20
    np.testing.assert_array_equal(bs.and_lists(space_bits=20)[2], lists[2])
    jp = [jcodec.compress(x) for x in lists]
    tp = [tcodec.compress(x) for x in lists]
    for p in tp:
        assert len(p.keys) == 16 and (p.forms == tcodec.FORM_BITMAP).all()
    want = jset.intersect_many(lists)
    assert abs(len(want) / (1 << 20) - 1 / 64) < 0.002
    np.testing.assert_array_equal(jset.intersect_packs(jp, device=True), want)
    got = tset.intersect_packs(tp, device="cpu")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_bench_entry_points_default_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.uid_intersect_bench(UID_CONFIGS[:1], runs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.kway_bench([(2, 8)], runs=1)
