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
