"""gdm_tpu_torch/ops/pointops.py against gdm_tpu/ops/pointops.py on seeded
clouds, one cloud at a time as JAX's take them and a batch of clouds
against ``jax.vmap``.

Indices are equal, except at near-ties: where the two packages pick
other points, their float64 squared distances to the query differ by at
most NEAR (1e-6, the f32 rounding of the expanded distance
|a|^2 - 2ab + |b|^2 at |a|^2 ~ 1), and a point in one ball and not the
other lies within NEAR of the radius squared; farthest point sampling
may part only at a step whose two candidates' distances are that close.
Histograms are equal; three_nn_interpolate agrees within 1e-6 of the
output's largest magnitude (measured ~2e-7); feature_gather's gradient
within 1e-5 (measured: equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gdm_tpu.ops import pointops as J
from gdm_tpu_torch.ops import pointops as T

torch.set_num_threads(1)
NEAR = 1e-6


def cloud(rng, n, spread=1.0):
    return (rng.rand(n, 3) * spread).astype(np.float32)


def d2_64(q, s):
    return ((q.astype(np.float64)[:, None] - s.astype(np.float64)[None])
            ** 2).sum(-1)


def assert_near_tie_equal(got, want, d2, radius=None):
    """got/want [m, k] indices into the columns of d2 [m, n] (float64)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rows = np.nonzero((got != want).any(-1))[0]
    assert len(rows) <= max(1, len(got) // 100), len(rows)
    for r in rows:
        dg, dw = d2[r, got[r]], d2[r, want[r]]
        bad = (got[r] != want[r]) & (np.abs(dg - dw) > NEAR)
        if radius is not None:
            r2 = radius * radius
            bad &= ~((np.abs(dg - r2) <= NEAR) | (np.abs(dw - r2) <= NEAR))
        assert not bad.any(), (r, got[r], want[r], dg, dw)


def fps_ok(got, want, xyz):
    """Equal, or parted at a step whose two candidates are a near-tie."""
    got, want = np.asarray(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    i = int(np.argmax(got != want))
    d = d2_64(xyz[got[:i]], xyz).min(0)
    assert abs(d[got[i]] - d[want[i]]) <= NEAR, (i, got[i], want[i])


@pytest.mark.parametrize("n,m,seed", [(64, 16, 0), (512, 128, 1),
                                      (2048, 512, 2), (4096, 64, 3)])
def test_farthest_point_sample(n, m, seed):
    xyz = cloud(np.random.RandomState(seed), n)
    want = np.asarray(J.farthest_point_sample(jnp.asarray(xyz), m))
    got = T.farthest_point_sample(torch.from_numpy(xyz), m)
    assert got.shape == (m,) and got[0] == 0
    fps_ok(got.numpy(), want, xyz)


def test_farthest_point_sample_batched_like_vmap():
    xyz = np.stack([cloud(np.random.RandomState(s), 300) for s in range(3)])
    want = np.asarray(jax.vmap(lambda x: J.farthest_point_sample(x, 40))(
        jnp.asarray(xyz)))
    got = T.farthest_point_sample(torch.from_numpy(xyz), 40).numpy()
    for b in range(3):
        fps_ok(got[b], want[b], xyz[b])


def test_gather_and_group_points():
    rng = np.random.RandomState(4)
    feats = rng.randn(50, 6).astype(np.float32)
    idx = rng.randint(0, 50, 17)
    nbr = rng.randint(0, 50, (17, 5))
    np.testing.assert_array_equal(
        T.gather_points(torch.from_numpy(feats), torch.from_numpy(idx)),
        np.asarray(J.gather_points(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        T.group_points(torch.from_numpy(feats), torch.from_numpy(nbr)),
        np.asarray(J.group_points(jnp.asarray(feats), jnp.asarray(nbr))))
    fb = np.stack([feats, feats[::-1].copy()])
    got = T.group_points(torch.from_numpy(fb),
                         torch.from_numpy(np.stack([nbr, nbr])))
    np.testing.assert_array_equal(got[1], fb[1][nbr])


@pytest.mark.parametrize("radius,k,seed", [(0.05, 8, 0), (0.2, 16, 1),
                                           (0.4, 32, 2), (0.01, 4, 3)])
def test_ball_query(radius, k, seed):
    rng = np.random.RandomState(seed)
    xyz, centers = cloud(rng, 1024), cloud(rng, 128)
    want = np.asarray(J.ball_query(jnp.asarray(xyz), jnp.asarray(centers),
                                   radius, k))
    got = T.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers),
                       radius, k).numpy()
    assert_near_tie_equal(got, want, d2_64(centers, xyz), radius)


def test_ball_query_batched_like_vmap():
    rng = np.random.RandomState(5)
    xyz = np.stack([cloud(rng, 256) for _ in range(2)])
    cen = np.stack([cloud(rng, 32) for _ in range(2)])
    want = np.asarray(jax.vmap(lambda x, c: J.ball_query(x, c, 0.3, 8))(
        jnp.asarray(xyz), jnp.asarray(cen)))
    got = T.ball_query(torch.from_numpy(xyz), torch.from_numpy(cen), 0.3,
                       8).numpy()
    for b in range(2):
        assert_near_tie_equal(got[b], want[b], d2_64(cen[b], xyz[b]), 0.3)


@pytest.mark.parametrize("n,m,c,spread,seed", [
    (64, 200, 8, 1.0, 0), (512, 64, 8, 1.0, 1), (1024, 4096, 32, 0.2, 2),
    (300, 300, 4, 5.0, 3)])
def test_three_nn_interpolate(n, m, c, spread, seed):
    rng = np.random.RandomState(seed)
    src, dst = cloud(rng, n, spread), cloud(rng, m, spread)
    feats = rng.randn(n, c).astype(np.float32)
    want = np.asarray(J.three_nn_interpolate(
        jnp.asarray(src), jnp.asarray(feats), jnp.asarray(dst)))
    got = T.three_nn_interpolate(torch.from_numpy(src),
                                 torch.from_numpy(feats),
                                 torch.from_numpy(dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_three_nn_interpolate_exact_at_sources_and_batched():
    rng = np.random.RandomState(6)
    src = rng.randn(64, 3).astype(np.float32)
    feats = rng.randn(64, 8).astype(np.float32)
    out = T.three_nn_interpolate(torch.from_numpy(src),
                                 torch.from_numpy(feats),
                                 torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(out, feats, atol=1e-4)
    sb, fb = np.stack([src, src * 2]), np.stack([feats, -feats])
    want = np.asarray(jax.vmap(J.three_nn_interpolate)(
        jnp.asarray(sb), jnp.asarray(fb), jnp.asarray(sb[:, :20])))
    got = T.three_nn_interpolate(torch.from_numpy(sb), torch.from_numpy(fb),
                                 torch.from_numpy(sb[:, :20].copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k,seed", [(1, 0), (8, 1), (16, 2), (40, 3)])
def test_knn_query(k, seed):
    rng = np.random.RandomState(seed)
    xyz, centers = cloud(rng, 32 if k == 40 else 1500), cloud(rng, 200)
    want = np.asarray(J.knn_query(jnp.asarray(xyz), jnp.asarray(centers), k))
    got = T.knn_query(torch.from_numpy(xyz), torch.from_numpy(centers),
                      k).numpy()
    assert_near_tie_equal(got, want, d2_64(centers, xyz))


@pytest.mark.parametrize("radius,seed", [(0.1, 0), (0.3, 1), (0.6, 2)])
def test_labelstat_ballrange(radius, seed):
    rng = np.random.RandomState(seed)
    xyz, centers = cloud(rng, 700), cloud(rng, 50)
    stat = rng.randint(0, 4, (700, 6)).astype(np.int32)
    want = np.asarray(J.labelstat_ballrange(
        jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(stat), radius))
    got = T.labelstat_ballrange(torch.from_numpy(xyz),
                                torch.from_numpy(centers),
                                torch.from_numpy(stat), radius)
    assert got.dtype == torch.int32
    d2 = d2_64(centers, xyz)
    edge = (np.abs(d2 - radius * radius) <= NEAR).any(1)
    np.testing.assert_array_equal(got.numpy()[~edge], want[~edge])


def test_labelstat_idx_and_the_fused_pair():
    rng = np.random.RandomState(7)
    stat = np.eye(5, dtype=np.int32)[rng.randint(0, 5, 90)]
    idx = rng.randint(0, 90, (12, 9))
    got = T.labelstat_idx(torch.from_numpy(stat), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        J.labelstat_idx(jnp.asarray(stat), jnp.asarray(idx))))
    xyz, centers = cloud(rng, 90), cloud(rng, 12)
    hist, bq = T.labelstat_and_ballquery(
        torch.from_numpy(xyz), torch.from_numpy(centers),
        torch.from_numpy(stat), 0.35, 8)
    jh, jb = J.labelstat_and_ballquery(jnp.asarray(xyz), jnp.asarray(centers),
                                       jnp.asarray(stat), 0.35, 8)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert_near_tie_equal(bq.numpy(), np.asarray(jb), d2_64(centers, xyz),
                          0.35)


@pytest.mark.parametrize("n,m,seed", [(16, 40, 0), (256, 2000, 1),
                                      (1000, 300, 2)])
def test_feature_distribute(n, m, seed):
    rng = np.random.RandomState(seed)
    anchors, pts = cloud(rng, n), cloud(rng, m)
    want = np.asarray(J.feature_distribute(jnp.asarray(anchors),
                                           jnp.asarray(pts)))
    got = T.feature_distribute(torch.from_numpy(anchors),
                               torch.from_numpy(pts)).numpy()
    assert_near_tie_equal(got[:, None], want[:, None], d2_64(pts, anchors))


@pytest.mark.parametrize("n,m,c", [(8, 4, 4), (64, 300, 16)])
def test_feature_gather_and_its_gradient(n, m, c):
    rng = np.random.RandomState(n)
    feats = rng.randn(n, c).astype(np.float32)
    idx = rng.randint(0, n, m)
    cot = rng.randn(m, c).astype(np.float32)
    out, vjp = jax.vjp(lambda f: J.feature_gather(f, jnp.asarray(idx)),
                       jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_()
    got = T.feature_gather(x, torch.from_numpy(idx))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), rtol=1e-5, atol=1e-5)
