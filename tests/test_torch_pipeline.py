"""Device preprocessing of the port against the JAX package:
finalize_batch (uint16 ship format, zero-depth mask, normals, gather) and
the exact index pyramid (build_pyramid(approx=False)), key by key."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch.data import pipeline as P
from gdm_tpu_torch.ops import knn as K

torch.set_num_threads(1)

NEAR_TIE = 1e-6      # m^2: distance gap under which neighbour order is free


@pytest.fixture(scope="module")
def finalized():
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import build_pyramid, finalize_batch

    raw = H.raw_request(seed=0)
    fin_j = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    fin_j = {k: np.asarray(v) for k, v in fin_j.items()}
    pyr_j = jax.vmap(lambda c, x: build_pyramid(
        c, x, knn_chunk=H.KNN_CHUNK, approx=False))(
            jnp.asarray(fin_j["cld_rgb_nrm"][..., :3]),
            jnp.asarray(fin_j["xyz_img"]))
    pyr_j = {k: np.asarray(v) for k, v in pyr_j.items()}
    fin_t = P.finalize_batch(P.to_device(raw, "cpu"))
    pyr_t = P.build_pyramid(fin_t["cld_rgb_nrm"][..., :3], fin_t["xyz_img"],
                            knn_chunk=H.KNN_CHUNK)
    return raw, fin_j, pyr_j, fin_t, {k: v.numpy() for k, v in pyr_t.items()}


def test_to_device_widens_ship_types():
    t = P.to_device(H.raw_request(), "cpu")
    assert t["dpt_u16"].dtype == torch.int32
    assert t["choose"].dtype == torch.int64
    assert t["rgb_u8"].dtype == torch.uint8
    assert t["K_crop"].dtype == torch.float32


@pytest.mark.parametrize("key", ["rgb", "cld_rgb_nrm", "xyz_img", "choose",
                                 "det"])
def test_finalize_matches_jax(finalized, key):
    _, fin_j, _, fin_t, _ = finalized
    np.testing.assert_allclose(fin_t[key].numpy(), fin_j[key], rtol=0,
                               atol=1e-5)


def test_zero_depth_is_masked(finalized):
    raw, _, _, fin_t, _ = finalized
    hole = raw["dpt_u16"] == 0
    assert hole.any()
    assert (fin_t["xyz_img"].numpy()[hole] == 0).all()


def _levels(fin):
    cld = np.asarray(fin["cld_rgb_nrm"])[..., :3]
    xyz = np.asarray(fin["xyz_img"])
    n = cld.shape[1]
    sub = [cld[:, :n // 4 ** i] for i in range(5)]

    def grid(s):
        g = xyz[:, ::s, ::s]
        return g.reshape(g.shape[0], -1, 3)

    return sub, grid(4), grid(8), grid(2)


def _query_support(key, fin):
    """(query, support) point sets of a pyramid key."""
    sub, g4, g8, g2 = _levels(fin)
    i = int(key[-1])
    up = ((sub[3], g4), (sub[2], g2), (sub[1], g2))
    table = {
        "cld_nei_idx": lambda: (sub[i], sub[i]),
        "cld_sub_idx": lambda: (sub[i + 1], sub[i]),
        "cld_interp_idx": lambda: (sub[i], sub[i + 1]),
        "r2p_ds_nei_idx": lambda: (sub[i + 1], g4 if i == 0 else g8),
        "r2p_up_nei_idx": lambda: up[i],
        "p2r_ds_nei_idx": lambda: (g4 if i == 0 else g8, sub[i + 1]),
        "p2r_up_nei_idx": lambda: up[i][::-1],
    }
    return table[key[:-1]]()


PYRAMID_KEYS = [f"{name}{i}" for name in (
    "cld_nei_idx", "cld_sub_idx", "cld_interp_idx", "r2p_ds_nei_idx",
    "p2r_ds_nei_idx") for i in range(4)] + [
    f"{name}{i}" for name in ("r2p_up_nei_idx", "p2r_up_nei_idx")
    for i in range(3)]


@pytest.mark.parametrize("key", PYRAMID_KEYS)
def test_pyramid_matches_exact_jax(finalized, key):
    """Equal indices, except where the two picks are a near-tie (their
    squared distances to the query differ by < 1e-6 m^2), on < 1% of
    rows."""
    _, fin_j, pyr_j, _, pyr_t = finalized
    a, b = pyr_j[key], pyr_t[key]
    assert a.shape == b.shape and b.dtype == np.int64
    query, support = _query_support(key, fin_j)
    diff = a != b
    rows = diff.any(axis=-1)
    assert rows.mean() < 0.01, (key, rows.mean())
    for bi, r, j in zip(*np.nonzero(diff)):
        q = query[bi, r].astype(np.float64)
        da = np.sum((support[bi, a[bi, r, j]] - q) ** 2)
        db = np.sum((support[bi, b[bi, r, j]] - q) ** 2)
        assert abs(da - db) < NEAR_TIE, (key, bi, r, j, da, db)


@pytest.mark.parametrize("key", [f"cld_xyz{i}" for i in range(4)])
def test_pyramid_point_levels(finalized, key):
    _, _, pyr_j, _, pyr_t = finalized
    np.testing.assert_allclose(pyr_t[key], pyr_j[key], rtol=0, atol=1e-5)


def test_knn_ties_go_to_lowest_index_and_short_support_repeats():
    """Duplicate support points tie exactly: the lower index comes first.
    With fewer support points than k the last neighbour repeats."""
    pts = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [3, 0, 0]]])
    q = torch.tensor([[[1.1, 0, 0]]])
    idx = K.knn(pts, q, 6)
    assert idx.tolist() == [[[1, 2, 0, 3, 3, 3]]]
    assert K.knn(pts, q, 1).tolist() == [[[1]]]
    (p2,) = K.argmin_prefixes(pts, q, (1,))
    assert p2.tolist() == [[[0]]]


def test_knn_matches_jax_on_random_cloud():
    import jax.numpy as jnp

    from gdm_tpu.ops.knn import knn as knn_j

    rng = np.random.RandomState(5)
    sup = rng.rand(300, 3).astype(np.float32)
    qry = rng.rand(77, 3).astype(np.float32)
    a = np.asarray(knn_j(jnp.asarray(sup), jnp.asarray(qry), 16, chunk=32))
    b = K.knn(torch.from_numpy(sup)[None], torch.from_numpy(qry)[None], 16,
              chunk=32)[0].numpy()
    np.testing.assert_array_equal(a, b)
