"""The port's gather-OR (dgraph_tpu_torch.ops.kernels) on the CPU: its
plain version against the TPU kernel run in interpret mode and against
the reference's XLA gather path, and the wrapper's checks.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu.ops.bitgraph import _gather_or
from dgraph_tpu.ops.pallas_kernels import bucket_or_pallas
from dgraph_tpu_torch.ops import _build, kernels


def frontier(n, width, seed):
    """Random uint32 words [n+1, width] with the dummy row n all zero,
    and the same bits as an int32 tensor."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 2**32, (n + 1, width), dtype=np.uint32)
    f[n] = 0
    return f, torch.from_numpy(f.view(np.int32).copy())


def in_neighbours(n, m, d, seed):
    """int32 [m, d] indices into [0, n], padding (n) mixed in."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, n + 1, (m, d)).astype(np.int32)
    nb.reshape(-1)[::5] = n
    return nb


@pytest.mark.parametrize("m,d", [(7, 1), (50, 3), (5, 8), (2, 100),
                                 (3, 13)])
def test_reference_matches_pallas_interpret(m, d):
    f, ft = frontier(40, 128, seed=m * 100 + d)
    nb = in_neighbours(40, m, d, seed=d)
    want = np.asarray(bucket_or_pallas(jnp.asarray(f), jnp.asarray(nb),
                                       interpret=True))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("width", [1, 5, 33])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 6, 12, 100, 257])
def test_reference_matches_jax_gather_or(width, degree):
    f, ft = frontier(60, width, seed=width * 1000 + degree)
    nb = in_neighbours(60, 9, degree, seed=degree)
    want = np.asarray(_gather_or(jnp.asarray(f), jnp.asarray(nb), degree))
    got = kernels.bucket_or_reference(ft, torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        want, np.bitwise_or.reduce(f[nb], axis=1))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 11])
def test_or_reduce_dim1(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 2**32, (4, k, 6), dtype=np.uint32)
    got = kernels._or_reduce_dim1(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.bitwise_or.reduce(x, axis=1))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    f, ft = frontier(30, 7, seed=1)
    nb = torch.from_numpy(in_neighbours(30, 12, 4, seed=2))
    before = kernels.bucket_or.launches
    got = kernels.bucket_or(ft, nb)
    assert kernels.bucket_or.launches == before
    assert torch.equal(got, kernels.bucket_or_reference(ft, nb))


def test_wrapper_writes_into_out_slice():
    _, ft = frontier(30, 7, seed=3)
    nb = torch.from_numpy(in_neighbours(30, 12, 4, seed=4))
    big = torch.full((14, 7), 7, dtype=torch.int32)
    res = kernels.bucket_or(ft, nb, out=big[1:13])
    assert res.data_ptr() == big[1:13].data_ptr()
    assert torch.equal(big[1:13], kernels.bucket_or_reference(ft, nb))
    assert bool((big[0] == 7).all()) and bool((big[13] == 7).all())


def _bad_inputs(case):
    f = torch.zeros((10, 4), dtype=torch.int32)
    nb = torch.zeros((3, 2), dtype=torch.int32)
    out = None
    if case == "f_dtype":
        f = f.to(torch.int64)
    elif case == "nb_dtype":
        nb = nb.to(torch.int64)
    elif case == "f_rank":
        f = f.reshape(-1)
    elif case == "non_contiguous":
        f = torch.zeros((4, 10), dtype=torch.int32).t()
    elif case == "out_shape":
        out = torch.zeros((3, 5), dtype=torch.int32)
    elif case == "out_dtype":
        out = torch.zeros((3, 4), dtype=torch.int64)
    elif case == "out_strided":
        out = torch.zeros((3, 8), dtype=torch.int32)[:, ::2]
    elif case == "device":
        f, nb = f.to("meta"), nb.to("meta")
    elif case == "mixed_devices":
        nb = nb.to("meta")
    return f, nb, out


@pytest.mark.parametrize("case", [
    "f_dtype", "nb_dtype", "f_rank", "non_contiguous", "out_shape",
    "out_dtype", "out_strided", "device", "mixed_devices"])
def test_wrapper_rejects(case):
    f, nb, out = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        kernels.bucket_or(f, nb, out=out)


def test_build_targets_hopper_and_lands_in_ignored_build_dir():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    path = _build.library_path("bucket_or")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "dgraph_tpu_torch")
    assert (_build.CSRC_DIR / "bucket_or.cu").exists()


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed build is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("bucket_or")
    assert not list(tmp_path.glob("*.so"))


# -- score_dot and score_int8 (csrc/score.cu) ---------------------------------


def reorder_bound(q, rows):
    """d * 2^-24 * sum_k |q_k c_k|: the most two float32 dot products of
    depth d that sum the same products in other orders can differ by
    (here float64, element by element)."""
    q64, c64 = np.abs(np.asarray(q, np.float64)), np.abs(
        np.asarray(rows, np.float64))
    return q.shape[1] * 2.0 ** -24 * (q64 @ c64.T)


def test_score_dot_reference_matches_pallas_interpret():
    """As tests/test_knn.py's Pallas parity case: 2,048 x 64, b = 4."""
    from dgraph_tpu.ops.pallas_kernels import score_dot_pallas

    rng = np.random.default_rng(6)
    corpus = rng.standard_normal((2048, 64), dtype=np.float32)
    q = rng.standard_normal((4, 64), dtype=np.float32)
    got = kernels.score_dot_reference(torch.from_numpy(corpus),
                                      torch.from_numpy(q)).numpy()
    bound = reorder_bound(q, corpus)
    for want in (np.asarray(score_dot_pallas(jnp.asarray(corpus),
                                             jnp.asarray(q),
                                             interpret=True)),
                 np.asarray(jnp.dot(jnp.asarray(q), jnp.asarray(corpus).T))):
        assert got.shape == want.shape == (4, 2048)
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_score_int8_reference_matches_pallas_interpret():
    """As tests/test_knn.py's IVF case: an index's first 512 code rows."""
    from dgraph_tpu.ops import ivf
    from dgraph_tpu.ops.pallas_kernels import score_int8_pallas, score_int8_xla

    rng = np.random.default_rng(33)
    centers = rng.standard_normal((32, 64)).astype(np.float32)
    corpus = centers[rng.integers(0, 32, 4096)] + np.float32(0.3) * \
        rng.standard_normal((4096, 64)).astype(np.float32)
    ix = ivf.build(corpus, seed=0, calibrate=False)
    codes = np.asarray(ix.codes[:512], np.int8)
    q = corpus[:3] + np.float32(0.01)
    got = kernels.score_int8_reference(torch.from_numpy(codes),
                                       torch.from_numpy(q)).numpy()
    bound = reorder_bound(q, codes)
    for want in (np.asarray(score_int8_pallas(jnp.asarray(codes),
                                              jnp.asarray(q),
                                              interpret=True)),
                 np.asarray(score_int8_xla(jnp.asarray(codes),
                                           jnp.asarray(q)))):
        assert got.shape == want.shape == (3, 512)
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("name", ["score_dot", "score_int8"])
@pytest.mark.parametrize("n,b,d", [(1, 1, 16), (777, 3, 100), (130, 5, 7)])
def test_score_wrapper_on_cpu_runs_plain_version_without_launch(name, n, b,
                                                                d):
    rng = np.random.default_rng(n + b + d)
    if name == "score_dot":
        rows = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    else:
        rows = torch.from_numpy(rng.integers(-127, 128, (n, d), np.int8))
    q = torch.from_numpy(rng.standard_normal((b, d), np.float32))
    wrapper = getattr(kernels, name)
    plain = getattr(kernels, f"{name}_reference")
    before = wrapper.launches
    got = wrapper(rows, q)
    assert wrapper.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    assert torch.equal(got, plain(rows, q))
    # out=: a [b, n] view of a flat buffer, neighbours kept
    big = torch.full((b * n + 2,), 7.0)
    res = wrapper(rows, q, out=big[1:b * n + 1].view(b, n))
    assert res.data_ptr() == big[1:].data_ptr()
    assert torch.equal(res, got)
    assert float(big[0]) == 7.0 and float(big[-1]) == 7.0


def _bad_score_inputs(name, case):
    dtype = torch.float32 if name == "score_dot" else torch.int8
    rows = torch.zeros((10, 4), dtype=dtype)
    q = torch.zeros((3, 4), dtype=torch.float32)
    out = None
    if case == "rows_dtype":
        rows = rows.to(torch.float64 if name == "score_dot" else torch.int16)
    elif case == "q_dtype":
        q = q.to(torch.float64)
    elif case == "rank":
        rows = rows.reshape(-1)
    elif case == "depth":
        q = torch.zeros((3, 5), dtype=torch.float32)
    elif case == "non_contiguous":
        rows = torch.zeros((4, 10), dtype=dtype).t()
    elif case == "out_shape":
        out = torch.zeros((3, 11))
    elif case == "out_dtype":
        out = torch.zeros((3, 10), dtype=torch.float64)
    elif case == "out_strided":
        out = torch.zeros((3, 20))[:, ::2]
    elif case == "device":
        rows, q = rows.to("meta"), q.to("meta")
    elif case == "mixed_devices":
        q = q.to("meta")
    return rows, q, out


@pytest.mark.parametrize("name", ["score_dot", "score_int8"])
@pytest.mark.parametrize("case", [
    "rows_dtype", "q_dtype", "rank", "depth", "non_contiguous", "out_shape",
    "out_dtype", "out_strided", "device", "mixed_devices"])
def test_score_wrapper_rejects(name, case):
    rows, q, out = _bad_score_inputs(name, case)
    with pytest.raises((TypeError, ValueError)):
        getattr(kernels, name)(rows, q, out=out)


def test_score_source_builds_beside_bucket_or():
    assert (_build.CSRC_DIR / "score.cu").exists()
    assert _build.library_path("score").parent == _build.BUILD_DIR
    src = (_build.CSRC_DIR / "score.cu").read_text()
    for entry in ("score_dot_launch", "score_int8_launch"):
        assert f'extern "C" int {entry}(' in src


def test_build_all_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    """One nvcc per source, started together; any failure raises."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["bucket_or", "score"])
    assert not list(tmp_path.glob("*.so"))


# -- bitmap_and (csrc/bitmap_and.cu) ------------------------------------------


def bitmap_words(k, b, seed, w=1024):
    """k random uint64 word matrices [k, b, w] and the same bits as an
    int64 tensor."""
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 2**64, (k, b, w), dtype=np.uint64)
    return mats, torch.from_numpy(mats.view(np.int64).copy())


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("b", [1, 7, 8, 9])
def test_bitmap_and_reference_matches_pallas_interpret(k, b):
    """The k-way AND against the TPU kernel folded pairwise over the
    uint32 lanes, as the reference's bitmap_and_device does, and against
    numpy's &."""
    from dgraph_tpu.ops.pallas_kernels import bitmap_and_pallas

    mats, mt = bitmap_words(k, b, seed=k * 100 + b)
    got = kernels.bitmap_and_reference(mt)
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, 1024)
    acc = mats[0].view(np.uint32)
    for m in mats[1:]:
        acc = np.asarray(bitmap_and_pallas(jnp.asarray(acc),
                                           jnp.asarray(m.view(np.uint32)),
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  acc.view(np.uint64))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.bitwise_and.reduce(mats, axis=0))


@pytest.mark.parametrize("k,b,w", [(1, 3, 1024), (2, 5, 5), (5, 1, 1024),
                                   (3, 4096, 1024)])
def test_bitmap_and_wrapper_on_cpu_runs_plain_version_without_launch(k, b, w):
    mats, mt = bitmap_words(k, b, seed=k + b + w, w=w)
    before = kernels.bitmap_and.launches
    got = kernels.bitmap_and(mt)
    assert kernels.bitmap_and.launches == before
    assert torch.equal(got, kernels.bitmap_and_reference(mt))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.bitwise_and.reduce(mats, axis=0))
    # the plain version leaves its inputs as they were
    np.testing.assert_array_equal(mt.numpy().view(np.uint64), mats)


@pytest.mark.parametrize("case", ["dtype", "rank", "empty_k",
                                  "non_contiguous", "device"])
def test_bitmap_and_wrapper_rejects(case):
    mats = torch.zeros((3, 4, 1024), dtype=torch.int64)
    if case == "dtype":
        mats = mats.to(torch.int32)
    elif case == "rank":
        mats = mats[0]
    elif case == "empty_k":
        mats = mats[:0]
    elif case == "non_contiguous":
        mats = torch.zeros((3, 1024, 4), dtype=torch.int64).transpose(1, 2)
    elif case == "device":
        mats = mats.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.bitmap_and(mats)


def test_bitmap_and_source_builds_beside_the_others():
    assert (_build.CSRC_DIR / "bitmap_and.cu").exists()
    assert _build.library_path("bitmap_and").parent == _build.BUILD_DIR
    src = (_build.CSRC_DIR / "bitmap_and.cu").read_text()
    assert 'extern "C" int bitmap_and_launch(' in src


def test_bitmap_and_build_failure_raises(monkeypatch, tmp_path):
    """On a CUDA tensor a failed build raises; nothing falls back to the
    plain version."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.load_bitmap_library()
