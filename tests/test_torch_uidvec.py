"""The port's sorted-UID vectors (dgraph_tpu_torch.ops.uidvec) against
the reference (dgraph_tpu.ops.uidvec, JAX on the CPU), bit for bit on
seeded inputs: padded outputs, sentinel slots included, equal as values
(the port holds uint32 uids in int64), both membership and lookup arms,
and the batched set operations against jax.vmap of the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.ops import uidvec as tuv

CASES = [(0, 0), (5, 7), (100, 3), (3, 100), (1000, 1000)]


def rand_sorted(rng, n, hi=1 << 16):
    return np.sort(rng.choice(np.arange(1, hi, dtype=np.uint32), size=n,
                              replace=False))


def both(x, size=None):
    """The same host uids as a reference and a port padded vector."""
    return juv.from_numpy(x, size), tuv.from_numpy(x, size, device="cpu")


def same(want, got):
    want = np.asarray(want)
    assert got.dtype == torch.int64
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sentinel_and_padding_match_reference():
    assert tuv.SENTINEL == int(juv.SENTINEL)
    for n in (0, 1, 7, 8, 9, 1000, 1025):
        assert tuv.pad_to(n) == juv.pad_to(n)
        assert tuv.pad_to(n, minimum=2) == juv.pad_to(n, minimum=2)


@pytest.mark.parametrize("n,size", [(0, None), (5, None), (8, None),
                                    (9, 32), (300, 512)])
def test_from_and_to_numpy(n, size):
    x = rand_sorted(np.random.default_rng(n), n)
    jv, tv = both(x, size)
    same(jv, tv)
    got = tuv.to_numpy(tv)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, juv.to_numpy(jv))
    assert int(tuv.count(tv)) == int(juv.count(jv)) == n
    with pytest.raises(ValueError):
        tuv.from_numpy(x, size=max(n - 1, 0), device="cpu") if n else \
            tuv.from_numpy(np.ones(3, np.uint32), size=2, device="cpu")


@pytest.mark.parametrize("op", ["intersect", "union", "difference"])
@pytest.mark.parametrize("na,nb", CASES)
def test_pair_ops_match_reference(op, na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a, b = rand_sorted(rng, na), rand_sorted(rng, nb)
    (ja, ta), (jb, tb) = both(a), both(b)
    same(getattr(juv, op)(ja, jb), getattr(tuv, op)(ta, tb))
    oracle = {"intersect": np.intersect1d, "union": np.union1d,
              "difference": np.setdiff1d}[op]
    np.testing.assert_array_equal(tuv.to_numpy(getattr(tuv, op)(ta, tb)),
                                  oracle(a, b))


@pytest.mark.parametrize("na,nb", [(8, 8), (64, 1024), (1024, 64),
                                   (500, 500), (0, 40)])
def test_member_mask_both_arms_match_reference(monkeypatch, na, nb):
    rng = np.random.default_rng(na + 7 * nb)
    a = np.unique(rng.integers(0, 5000, na).astype(np.uint32))
    b = np.unique(rng.integers(0, 5000, nb).astype(np.uint32))
    (ja, ta), (jb, tb) = both(a), both(b)
    want_search = np.asarray(juv.member_mask(ja, jb))
    monkeypatch.setattr(juv, "_sort_backend", lambda: True)
    want_cosort = np.asarray(juv.member_mask(ja, jb))
    np.testing.assert_array_equal(want_search, want_cosort)
    for got in (tuv.member_mask(ta, tb), tuv._member_mask_search(ta, tb),
                tuv._member_mask_cosort(ta, tb)):
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want_search)


@pytest.mark.parametrize("na,nb", [(8, 8), (64, 1024), (1024, 64),
                                   (500, 500)])
def test_lookup_both_arms_match_reference(na, nb):
    """As tests/test_uidvec.py: duplicates between query and table,
    sentinels, and empty overlaps."""
    rng = np.random.default_rng(11 + na + nb)
    a = np.unique(rng.integers(0, 5000, na).astype(np.uint32))
    b = np.unique(rng.integers(0, 5000, nb).astype(np.uint32))
    (ja, ta), (jb, tb) = both(a), both(b)
    want = np.asarray(juv.sorted_lookup(jb, ja))
    np.testing.assert_array_equal(want, np.searchsorted(np.asarray(jb),
                                                        np.asarray(ja)))
    np.testing.assert_array_equal(want, np.asarray(juv.lookup_idx(jb, ja)))
    for got in (tuv.sorted_lookup(tb, ta), tuv.lookup_idx(tb, ta)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _stacks(rng, k, na, nb, hi):
    rows_a = [rand_sorted(rng, int(rng.integers(0, na + 1)), hi)
              for _ in range(k)]
    rows_b = [rand_sorted(rng, int(rng.integers(0, nb + 1)), hi)
              for _ in range(k)]
    sa, sb = juv.pad_to(na), juv.pad_to(nb)
    ja = jnp.stack([juv.from_numpy(r, sa) for r in rows_a])
    jb = jnp.stack([juv.from_numpy(r, sb) for r in rows_b])
    ta = torch.stack([tuv.from_numpy(r, sa, device="cpu") for r in rows_a])
    tb = torch.stack([tuv.from_numpy(r, sb, device="cpu") for r in rows_b])
    return ja, jb, ta, tb


@pytest.mark.parametrize("op", ["intersect", "difference", "member_mask"])
@pytest.mark.parametrize("k,na,nb", [(8, 100, 100), (5, 60, 480),
                                     (16, 16, 16)])
def test_batched_ops_match_vmap_of_reference(op, k, na, nb):
    """bench_micro.py vmaps intersect over K pairs; the port's leading
    batch dimension is that vmap."""
    ja, jb, ta, tb = _stacks(np.random.default_rng(k * na + nb), k, na,
                             nb, hi=1 << 10)
    want = np.asarray(jax.vmap(getattr(juv, op))(ja, jb))
    got = getattr(tuv, op)(ta, tb)
    if op == "member_mask":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        same(want, got)
        for i in range(k):
            same(getattr(juv, op)(ja[i], jb[i]), got[i])


def test_batched_member_mask_cosort_arm_matches_search_arm():
    _, _, ta, tb = _stacks(np.random.default_rng(3), 6, 200, 900, 1 << 11)
    assert torch.equal(tuv._member_mask_cosort(ta, tb),
                       tuv._member_mask_search(ta, tb))


def test_merge_many_and_intersect_many_match_reference():
    rng = np.random.default_rng(3)
    rows = [rand_sorted(rng, int(rng.integers(0, 500)), 1 << 14)
            for _ in range(6)]
    size = juv.pad_to(max(len(r) for r in rows))
    jm = jnp.stack([juv.from_numpy(r, size) for r in rows])
    tm = torch.stack([tuv.from_numpy(r, size, device="cpu") for r in rows])
    same(juv.merge_many(jm), tuv.merge_many(tm))
    base = rand_sorted(rng, 300, 1 << 12)
    irows = [np.union1d(base, rand_sorted(rng, 100, 1 << 12))
             for _ in range(4)]
    size = juv.pad_to(max(len(r) for r in irows))
    jm = jnp.stack([juv.from_numpy(r, size) for r in irows])
    tm = torch.stack([tuv.from_numpy(r, size, device="cpu") for r in irows])
    same(juv.intersect_many(jm), tuv.intersect_many(tm))


def test_overlap_sweep_matches_reference():
    """Ref algo/uidlist_test.go:290: size ratio x overlap."""
    rng = np.random.default_rng(7)
    for ratio in (1, 10, 100):
        for overlap in (0.0, 0.3, 1.0):
            a = rand_sorted(rng, 1000, 1 << 30)
            nb = max(1, 1000 // ratio)
            take = int(nb * overlap)
            b = np.unique(np.concatenate([
                rng.choice(a, size=take, replace=False),
                rand_sorted(rng, nb - take, 1 << 30)]))
            (ja, ta), (jb, tb) = both(a, 1024), both(b, 1024)
            same(juv.intersect(ja, jb), tuv.intersect(ta, tb))


@pytest.mark.parametrize("k,offset", [(3, 0), (3, 2), (16, 0), (4, 14),
                                      (4, 16), (0, 3)])
def test_first_k_and_compact_match_reference(k, offset):
    a = np.array([3, 9, 12, 40, 41], dtype=np.uint32)
    jv, tv = both(a, 16)
    same(juv.first_k(jv, k, offset), tuv.first_k(tv, k, offset))
    shuffled = np.random.default_rng(k).permutation(np.asarray(jv))
    same(juv.compact(jnp.asarray(shuffled)),
         tuv.compact(torch.from_numpy(shuffled.astype(np.int64))))


def test_sentinel_padding_is_inert():
    a = tuv.from_numpy(np.array([], dtype=np.uint32), 8, device="cpu")
    b = tuv.from_numpy(np.array([1, 2], dtype=np.uint32), 8, device="cpu")
    assert tuv.to_numpy(tuv.intersect(a, b)).size == 0
    np.testing.assert_array_equal(tuv.to_numpy(tuv.union(a, b)), [1, 2])
    assert tuv.to_numpy(tuv.difference(a, b)).size == 0
    assert int(tuv.count(a)) == 0
    assert not tuv.member_mask(a, a).any()


def test_from_numpy_defaults_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuv.from_numpy(np.array([1, 2], np.uint32))
