"""GeoMatch of the port against the flax GeoMatch under the same weights
(exported by gdm_tpu.train.import_torch.export_state_dict): the seg, rgbd
and mesh end points and encode_mesh within max|d|/max|ref| <= 1e-4, the
mesh-graph build bit-equal, and the pieces the forward is made of."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch.models import pspnet as psp_t
from gdm_tpu_torch.models import randla as randla_t
from gdm_tpu_torch.models.geomatch import MeshArrays
from gdm_tpu_torch.models.layers import BatchNorm
from gdm_tpu_torch.models.spline_mesh import build_mesh_graph
from gdm_tpu_torch.ops.spline_basis import spline_conv_dense

torch.set_num_threads(1)

TOL = 1e-4   # f32 forward, different summation orders: max|d| / max|ref|


@pytest.fixture(scope="module")
def problem():
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models.geomatch import MeshArrays as MeshArraysJ
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j

    fps = H.mesh_fps()
    graph_j = build_j(fps, H.N_MESH)
    mesh_j = MeshArraysJ.from_graph(graph_j)
    data, _ = make_batch(fps, H.B, H.intrinsics(), im_size=H.IM,
                         n_sample=H.N_SAMPLE, seed=0)
    inputs = assemble_inputs(
        jnp.asarray(data["rgb"]), jnp.asarray(data["cld_rgb_nrm"]),
        jnp.asarray(data["choose"]), jnp.asarray(data["xyz_img"]),
        knn_chunk=H.KNN_CHUNK, approx=False)
    model, variables = H.jax_model_and_variables(inputs, mesh_j)
    out_j = model.apply(variables, inputs, mesh_j, train=False)
    mesh_feats_j = model.apply(variables, mesh_j, train=False,
                               method="encode_mesh")

    port = H.port_model(variables)
    graph_t = build_mesh_graph(fps, H.N_MESH)
    mesh_t = MeshArrays.from_graph(graph_t, "cpu")
    with torch.no_grad():
        out_t = port(H.to_torch(inputs), mesh_t)
        mesh_feats_t = port.encode_mesh(mesh_t)
    return {"graph_j": graph_j, "graph_t": graph_t,
            "out_j": {k: np.asarray(v) for k, v in out_j.items()},
            "out_t": {k: v.numpy() for k, v in out_t.items()},
            "mesh_j": np.asarray(mesh_feats_j),
            "mesh_t": mesh_feats_t.numpy()}


@pytest.mark.parametrize("key", ["seg", "rgbd", "mesh"])
def test_end_points_match_jax(problem, key):
    a, ref = problem["out_t"][key], problem["out_j"][key]
    assert a.shape == ref.shape
    assert np.isfinite(a).all()
    assert H.rel_err(a, ref) <= TOL, H.rel_err(a, ref)


def test_encode_mesh_matches_jax(problem):
    assert H.rel_err(problem["mesh_t"], problem["mesh_j"]) <= TOL


@pytest.mark.parametrize("field", ["xyz", "node_x", "neigh_idx", "basis",
                                   "slot"])
def test_mesh_graph_bit_equal(problem, field):
    a = getattr(problem["graph_t"], field)
    b = getattr(problem["graph_j"], field)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_mesh_graph_bit_equal_at_lmo_size():
    """The numpy exact KNN of the port against gdm_tpu.native's KD-tree,
    through the whole graph build, at the served 4096 vertices."""
    from gdm_tpu.data.synthetic import make_object
    from gdm_tpu.models.spline_mesh import build_mesh_graph as build_j

    fps = make_object(4096, np.random.RandomState(1), radius=0.08)
    a, b = build_mesh_graph(fps, 4096), build_j(fps, 4096)
    for field in ("node_x", "neigh_idx", "basis", "slot"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)


@pytest.mark.parametrize("k", [1, 4, 7, 27, 700])
def test_knn_np_equals_a_stable_sort_under_ties(k):
    """knn_np selects by partition; on an integer grid with duplicated
    points (distances tied at every rank, 612 points) its indices equal
    the first k of a stable argsort of each distance row, and k > n
    repeats the last neighbour."""
    from gdm_tpu_torch.models.spline_mesh import knn_np

    g = np.stack(np.meshgrid(*[np.arange(8)] * 3), -1).reshape(-1, 3)
    g = np.concatenate([g, g[:100]]).astype(np.float32)
    q = np.random.RandomState(k).randint(0, 8, (50, 3)).astype(np.float32)
    for query in (None, q):
        qq = g if query is None else query
        d2 = ((qq[:, None] - g[None]) ** 2).sum(-1)
        ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
        ref = np.concatenate([ref] + [ref[:, -1:]] * (k - ref.shape[1]), 1)
        np.testing.assert_array_equal(knn_np(g, k, query=query), ref)


@pytest.mark.parametrize("n_in,n_out", [(1, 8), (8, 16), (32, 32), (6, 32),
                                        (13, 4)])
def test_resize_and_pool_matrices(n_in, n_out):
    from gdm_tpu.models import pspnet as psp_j

    np.testing.assert_array_equal(psp_t._interp_matrix_ac(n_in, n_out),
                                  psp_j._interp_matrix_ac(n_in, n_out))
    np.testing.assert_array_equal(psp_t._adaptive_pool_matrix(n_in, n_out),
                                  psp_j._adaptive_pool_matrix(n_in, n_out))


def test_resize_bilinear_nchw_matches_jax_nhwc():
    import jax.numpy as jnp

    from gdm_tpu.models import pspnet as psp_j

    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(psp_j.resize_bilinear_ac(jnp.asarray(x), (10, 14)))
    got = psp_t.resize_bilinear_ac(
        torch.from_numpy(x).permute(0, 3, 1, 2), (10, 14)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_batchnorm_eval_matches_flax(eps):
    import jax.numpy as jnp

    from gdm_tpu.models.layers import BatchNorm as BatchNormJ

    rng = np.random.RandomState(1)
    x = rng.randn(4, 6, 8).astype(np.float32)
    stats = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.rand(8).astype(np.float32) + 0.1}
    params = {"scale": rng.randn(8).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32)}
    ref = BatchNormJ(epsilon=eps).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    bn = BatchNorm(8, eps).eval()
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_randla_gathers_match_jax():
    import jax.numpy as jnp

    from gdm_tpu.models import randla as randla_j

    rng = np.random.RandomState(2)
    feats = rng.randn(2, 30, 5).astype(np.float32)
    idx = rng.randint(0, 30, (2, 12, 4)).astype(np.int32)
    ft, it = torch.from_numpy(feats), torch.from_numpy(idx).long()
    np.testing.assert_array_equal(
        randla_t.max_pool_neighbours(ft, it).numpy(),
        np.asarray(randla_j.max_pool_neighbours(jnp.asarray(feats),
                                                jnp.asarray(idx))))
    np.testing.assert_array_equal(
        randla_t.nearest_upsample(ft, it[..., :1]).numpy(),
        np.asarray(randla_j.nearest_upsample(jnp.asarray(feats),
                                             jnp.asarray(idx[..., :1]))))


def test_spline_conv_dense_matches_jax(problem):
    import jax.numpy as jnp

    from gdm_tpu.ops.spline_basis import spline_conv_dense as conv_j

    g = problem["graph_j"]
    rng = np.random.RandomState(3)
    x = rng.randn(g.n_nodes, 9).astype(np.float32)
    w = rng.randn(125, 9, 16).astype(np.float32) / 3
    wr = rng.randn(9, 16).astype(np.float32) / 3
    b = rng.randn(16).astype(np.float32)
    ref = conv_j(jnp.asarray(x), jnp.asarray(g.neigh_idx),
                 jnp.asarray(g.basis), jnp.asarray(g.slot), jnp.asarray(w),
                 jnp.asarray(wr), jnp.asarray(b))
    got = spline_conv_dense(
        torch.from_numpy(x), torch.from_numpy(g.neigh_idx).long(),
        torch.from_numpy(g.basis), torch.from_numpy(g.slot).long(),
        torch.from_numpy(w), torch.from_numpy(wr), torch.from_numpy(b))
    assert H.rel_err(got.numpy(), ref) <= 1e-5
