"""The port's merge-path intersect (dgraph_tpu_torch.ops.mergepath)
against the reference (dgraph_tpu.ops.mergepath, JAX on the CPU) on the
cases of tests/test_mergepath.py: the padded result, the overflow flag,
the slab split points and the per-slab hits, all equal, and the result
equal to np.intersect1d wherever the flag is down. Integer plane: no
tolerance.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.ops import mergepath as jmp
from dgraph_tpu.ops import uidvec as juv
from dgraph_tpu_torch.ops import mergepath as tmp
from dgraph_tpu_torch.ops import uidvec as tuv


@functools.partial(jax.jit, static_argnums=(2, 3))
def _ref(a, b, k, hf):
    return jmp.mergepath_intersect(a, b, k=k, hit_frac=hf)


@functools.partial(jax.jit, static_argnums=(2,))
def _ref_hits(a, b, k):
    return jmp.mergepath_hits(a, b, k=k)


def _size(x):
    return max(8, 1 << (max(1, len(x)) - 1).bit_length())


def _check(a, b, k=256, hit_frac=1):
    """Port against reference (and numpy); returns the overflow flag."""
    ja, jb = juv.from_numpy(a, _size(a)), juv.from_numpy(b, _size(b))
    ta = tuv.from_numpy(a, _size(a), device="cpu")
    tb = tuv.from_numpy(b, _size(b), device="cpu")
    want, wovf = _ref(ja, jb, k, hit_frac)
    got, ovf = tmp.mergepath_intersect(ta, tb, k=k, hit_frac=hit_frac)
    assert got.dtype == torch.int64 and ovf.dtype == torch.bool
    assert ovf.shape == () and bool(ovf) == bool(wovf)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    if hit_frac == 1:
        assert not bool(ovf)
    if not bool(ovf):
        np.testing.assert_array_equal(
            tuv.to_numpy(got), np.intersect1d(a, b, assume_unique=True))
        np.testing.assert_array_equal(got, tuv.intersect(ta, tb))
    # the building blocks too
    hits, counts, n = tmp.mergepath_hits(ta, tb, k=k)
    jh, jc, jn = _ref_hits(ja, jb, k)
    np.testing.assert_array_equal(hits.numpy(),
                                  np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert n == int(jn)
    return bool(ovf)


def _pair(n_a, ratio, overlap, seed):
    rng = np.random.default_rng(seed)
    b = np.unique(rng.integers(0, 4_000_000_000, n_a * ratio,
                               dtype=np.uint32))
    take = rng.random(len(b)) < (overlap * n_a / max(len(b), 1))
    shared = b[take][:n_a]
    fresh = np.unique(rng.integers(0, 4_000_000_000, n_a, dtype=np.uint32))
    a = np.unique(np.concatenate([shared, fresh]))[:n_a]
    return a, b


@pytest.mark.parametrize("n_a,ratio,overlap",
                         [(2048, 1, 0.3), (2048, 8, 0.1),
                          (1024, 16, 0.05), (4096, 2, 0.5)])
@pytest.mark.parametrize("k", [256, 1024])
def test_uniform_configs(n_a, ratio, overlap, k):
    a, b = _pair(n_a, ratio, overlap, seed=3)
    _check(a, b, k=k, hit_frac=1)
    _check(a, b, k=k, hit_frac=4)


def test_skewed_a_never_overflows_windows():
    rng = np.random.default_rng(11)
    a = np.sort(rng.choice(np.arange(1_000_000, 1_050_000, dtype=np.uint32),
                           2048, replace=False))
    b = np.unique(rng.integers(0, 4_000_000_000, 64 * 2048, dtype=np.uint32))
    _check(a, b, k=512, hit_frac=1)


def test_dense_subset_hits_overflow_sparse_slice():
    rng = np.random.default_rng(5)
    b = np.unique(rng.integers(0, 1_000_000, 6_000, dtype=np.uint32))
    a = np.sort(rng.choice(b, 4096, replace=False))
    assert _check(a, b, k=1024, hit_frac=4)        # flag up, as reference
    assert not _check(a, b, k=1024, hit_frac=1)    # the exact fallback


def test_identical_and_disjoint_and_empty():
    rng = np.random.default_rng(9)
    a = np.unique(rng.integers(0, 1 << 30, 3000, dtype=np.uint32))
    _check(a, a.copy(), k=512, hit_frac=1)
    _check(a, np.unique(a + np.uint32(1 << 30)), k=512, hit_frac=1)
    _check(np.empty(0, np.uint32), a, k=256, hit_frac=1)
    _check(a, np.empty(0, np.uint32), k=256, hit_frac=1)


def test_equal_values_straddling_slab_boundary():
    a = np.arange(0, 4096, 2, dtype=np.uint32)
    b = np.arange(0, 4096, 1, dtype=np.uint32)
    _check(a, b, k=64, hit_frac=1)


@pytest.mark.parametrize("n,m", [(8, 8), (64, 2048), (2048, 64), (512, 512)])
def test_partition_matches_reference(n, m):
    rng = np.random.default_rng(n + m)
    a = np.unique(rng.integers(0, 5000, n).astype(np.uint32))
    b = np.unique(rng.integers(0, 5000, m).astype(np.uint32))
    ja, jb = juv.from_numpy(a, _size(a)), juv.from_numpy(b, _size(b))
    ta = tuv.from_numpy(a, _size(a), device="cpu")
    tb = tuv.from_numpy(b, _size(b), device="cpu")
    total = _size(a) + _size(b)
    diag = np.arange(0, total + 1, 7, dtype=np.int32)
    want = np.asarray(jmp._partition(ja, jb, jnp.asarray(diag)))
    got = tmp._partition(ta, tb, torch.from_numpy(diag.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
