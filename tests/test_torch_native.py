"""gdm_tpu_torch.native (csrc/native.cpp, built by _build) against
gdm_tpu.native, and against its own numpy plain versions; and
gdm_tpu_torch/ops/subsample.py against gdm_tpu/ops/subsample.py.

knn and knn_batch return the JAX package's indices and distances bit for
bit (its library is built with -march=native, where g++ contracts the
squared distance into fma(dz, dz, fma(dx, dx, dy * dy)); the port's C++
writes those FMAs out); grid_subsample keeps the collision-free packed
key and the first-occurrence voxel order, so its points and features are
bit-equal; radius_nn is the one GT generation uses.  The plain versions
give the C++'s bits too (the KD-tree breaks exact distance ties by
traversal order, the plain sort by index: the seeded clouds have none).
"""

import numpy as np
import pytest

from gdm_tpu import native as ref
from gdm_tpu.ops.subsample import voxel_grid_subsample_np as ref_voxel
from gdm_tpu_torch import native
from gdm_tpu_torch.data import gt_gen
from gdm_tpu_torch.ops.subsample import voxel_grid_subsample_np


@pytest.fixture(scope="module", autouse=True)
def jax_library_is_built():
    assert ref.available(), "the JAX package's native library did not build"


def cloud(seed, n, scale=0.05):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(
        np.float32)


@pytest.mark.parametrize("n,m,k", [(1, 5, 1), (7, 20, 16), (500, 300, 1),
                                   (2000, 1000, 16), (4096, 512, 32)])
def test_knn(n, m, k):
    s, q = cloud(n, n), cloud(m + 1, m)
    i_ref, d_ref = ref.knn(s, q, k, return_dist=True)
    i, d = native.knn(s, q, k, return_dist=True)
    assert i.dtype == np.int32 and d.dtype == np.float32
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_array_equal(native.knn(s, q, k), i)
    i_plain, d_plain = native.knn_plain(s, q, k, return_dist=True)
    np.testing.assert_array_equal(i_plain, i)
    np.testing.assert_array_equal(d_plain, d)


@pytest.mark.parametrize("b,n,m,k", [(1, 64, 10, 4), (3, 300, 100, 8),
                                     (2, 5, 9, 8)])
def test_knn_batch(b, n, m, k):
    s = np.stack([cloud(10 + i, n) for i in range(b)])
    q = np.stack([cloud(20 + i, m) for i in range(b)])
    got = native.knn_batch(s, q, k)
    np.testing.assert_array_equal(got, ref.knn_batch(s, q, k))
    for i in range(b):
        np.testing.assert_array_equal(got[i], native.knn_plain(s[i], q[i], k))


@pytest.mark.parametrize("radius", [0.001, 0.01, 0.1])
def test_radius_nn(radius):
    s, q = cloud(3, 2000), cloud(4, 3000)
    q[:40] = s[:40]
    assert native.radius_nn is gt_gen.radius_nn
    np.testing.assert_array_equal(native.radius_nn(s, q, radius),
                                  ref.radius_nn(s, q, radius))


@pytest.mark.parametrize("dl,n,fdim", [(0.01, 3000, 0), (0.02, 5000, 4),
                                       (0.5, 100, 2), (0.003, 2000, 0)])
def test_grid_subsample(dl, n, fdim):
    pts = cloud(n, n)
    feats = np.random.RandomState(1).randn(n, fdim).astype(np.float32) \
        if fdim else None
    got, want = native.grid_subsample(pts, dl, feats), \
        ref.grid_subsample(pts, dl, feats)
    plain = native.grid_subsample_plain(pts, dl, feats)
    if fdim:
        for g, w, p in zip(got, want, plain):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("dl,fdim", [(0.25, 0), (0.1, 3)])
def test_voxel_grid_subsample_np(dl, fdim):
    pts = np.random.RandomState(2).rand(1000, 3).astype(np.float32)
    feats = np.random.RandomState(3).randn(1000, fdim).astype(np.float32) \
        if fdim else None
    got, want = voxel_grid_subsample_np(pts, dl, feats), \
        ref_voxel(pts, dl, feats)
    if feats is None:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_available():
    assert native.available() is True is ref.available()


def test_contract_errors():
    with pytest.raises(ValueError, match="empty support"):
        native.knn(np.zeros((0, 3), np.float32), cloud(0, 4), 2)
    with pytest.raises(ValueError, match="empty support"):
        native.radius_nn(np.zeros((0, 3), np.float32), cloud(0, 4), 0.1)
    with pytest.raises(ValueError, match="points"):
        native.knn(cloud(0, 4)[:, :2], cloud(0, 4), 2)
    with pytest.raises(ValueError, match="queries"):
        native.knn_batch(np.stack([cloud(0, 4)] * 2), cloud(0, 4)[None], 2)
    with pytest.raises(ValueError, match="features"):
        native.grid_subsample(cloud(0, 4), 0.1, np.zeros((3, 2)))
