"""parallel/sp.py of the port on gloo CPU ranks against gdm_tpu.parallel.sp
on the CPU's virtual devices (as tests/test_sp.py runs it), with the same
numpy-seeded inputs, on (data, model) grids of 1 x 2 (two ranks) and
2 x 2 (four ranks):

  * sharded_cosine_argmax: indices equal wherever the top-2 gap of the
    row exceeds 1e-5, scores within 1e-5;
  * sharded_matching_loss, for the flagship (radius, visibility), the
    symmetric-positive mask (sym_idx) and DGCNN's one-hot pad column
    with the depth-scaled radius: the loss within 1e-5 relative, equal
    on every rank, and the gradients with respect to the scene and the
    mesh features within 1e-5 (max|d| / max|ref|) per tensor.

The gradient scale (parallel/mesh.py): each rank backs out the global
loss and every collective's backward sums its cotangents, so the
gradient of the loss with respect to a tensor is the sum of the ranks'
gradients over its copies divided by the number of ranks W: the mesh
features' is the mean over all ranks, a data row's scene features' the
sum over its model row / W (each copy alone is off by the data size
times its share)."""

import numpy as np
import pytest

import _torch_harness as H
import _torch_mp
import conftest  # noqa: F401  (JAX on the CPU platform)

TOL = 1e-5
GAP = 1e-5
GRIDS = [(1, 2), (2, 2)]                   # (data, model)


def _problem(b=4, n=48, c=16, mcols=32, seed=5):
    """tests/test_sp.py's problem."""
    rng = np.random.RandomState(seed)
    return {
        "rgbd": rng.randn(b, n, c).astype(np.float32),
        "meshf": rng.randn(mcols, c).astype(np.float32),
        "mesh_xyz": ((rng.rand(mcols, 3) - 0.5) * 0.1).astype(np.float32),
        "labels": (rng.rand(b, n) < 0.7).astype(np.int32),
        "match_idx": rng.randint(0, mcols + 1, (b, n)).astype(np.int32),
        "vis": (rng.rand(b, mcols) < 0.8).astype(np.int32),
    }


def _cases():
    from scipy.spatial.transform import Rotation

    flag = dict(_problem(seed=2), positive_r=0.04)
    sym = dict(_problem(seed=4), positive_r=0.04)
    sym["sym_idx"] = np.random.RandomState(11).permutation(
        sym["meshf"].shape[0]).astype(np.int32)
    dg = dict(_problem(seed=6), positive_r=0.0, pad_onehot=True, r_mm=40.0)
    dg["rt"] = np.stack([np.hstack([
        Rotation.random(random_state=i).as_matrix(),
        np.array([[0.0], [0.0], [0.5 + 0.1 * i]])])
        for i in range(dg["rgbd"].shape[0])]).astype(np.float32)
    return {"flagship": flag, "sym": sym, "dgcnn": dg}


def _jax_refs(data, model, cases, argmax):
    """gdm_tpu.parallel.sp on a (data, model) mesh of virtual CPU
    devices: (idx, score) and, per case, (loss, d/d scene, d/d mesh)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gdm_tpu.parallel import make_mesh_2d, sharded_cosine_argmax, \
        sharded_matching_loss

    mesh2d = make_mesh_2d(jax.devices("cpu")[:data * model], data=data,
                          model=model)

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh2d, spec))

    scene, meshf = argmax
    idx, score = jax.jit(lambda s, m: sharded_cosine_argmax(s, m, mesh2d))(
        put(scene, P("data")), put(meshf, P("model")))
    refs = {"idx": np.asarray(idx), "score": np.asarray(score)}
    for name, c in cases.items():
        fixed = (put(c["mesh_xyz"], P()), put(c["labels"], P("data")),
                 put(c["match_idx"], P("data")),
                 put(c["vis"], P("data", "model")))
        kw = {}
        if "sym_idx" in c:
            kw["sym_idx"] = jnp.asarray(c["sym_idx"])
        if c.get("pad_onehot"):
            kw.update(pad_onehot=True, rt=put(c["rt"], P("data")),
                      depth_scaled_r_mm=c["r_mm"])

        def loss(f, g, fixed=fixed, kw=kw, c=c):
            return sharded_matching_loss(f, g, *fixed, c["positive_r"],
                                         mesh2d, **kw)

        val, (gf, gg) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            put(c["rgbd"], P("data")), put(c["meshf"], P("model")))
        refs[name] = (float(val), np.asarray(gf), np.asarray(gg))
    return refs


@pytest.fixture(scope="module", params=GRIDS, ids=["1x2", "2x2"])
def runs(request, tmp_path_factory):
    data, model = request.param
    cases = _cases()
    rng = np.random.RandomState(1)
    argmax = (rng.randn(4, 96, 32).astype(np.float32),
              rng.randn(128, 32).astype(np.float32))
    ranks = _torch_mp.run("_torch_mp_cases:sp_functions", data * model,
                          tmp_path_factory.mktemp("sp"),
                          {"shards": model, "cases": cases,
                           "argmax": argmax})
    return {"grid": (data, model), "cases": cases, "argmax": argmax,
            "ranks": ranks, "jax": _jax_refs(data, model, cases, argmax)}


def test_argmax_matches_jax(runs):
    scene, meshf = runs["argmax"]
    ref = runs["jax"]
    f = scene / np.linalg.norm(scene, axis=-1, keepdims=True)
    g = meshf / np.linalg.norm(meshf, axis=-1, keepdims=True)
    gap = H.top2_gap(f.reshape(-1, f.shape[-1]), g).reshape(f.shape[:2])
    for r in runs["ranks"]:
        lo, hi = r["rows"]
        far = gap[lo:hi] > GAP
        assert far.mean() > 0.9
        np.testing.assert_array_equal(r["idx"][far], ref["idx"][lo:hi][far])
        np.testing.assert_allclose(r["score"], ref["score"][lo:hi],
                                   rtol=0, atol=TOL)
    # every rank of a model row holds the same merged result
    data, model = runs["grid"]
    for d in range(data):
        row = runs["ranks"][d * model:(d + 1) * model]
        for r in row[1:]:
            np.testing.assert_array_equal(r["idx"], row[0]["idx"])


@pytest.mark.parametrize("case", ["flagship", "sym", "dgcnn"])
def test_loss_matches_jax(runs, case):
    ref = runs["jax"][case][0]
    losses = [r["loss"][case][0] for r in runs["ranks"]]
    assert np.isfinite(ref) and len(set(losses)) == 1, losses
    assert abs(losses[0] - ref) <= TOL * abs(ref), (losses[0], ref)


@pytest.mark.parametrize("case", ["flagship", "sym", "dgcnn"])
def test_gradients_match_jax(runs, case):
    data, model = runs["grid"]
    world = data * model
    _, ref_f, ref_g = runs["jax"][case]
    ranks = runs["ranks"]
    grad_g = sum(r["loss"][case][2] for r in ranks) / world
    grad_f = np.concatenate([
        sum(r["loss"][case][1] for r in ranks[d * model:(d + 1) * model])
        / world for d in range(data)])
    assert np.abs(ref_f).max() > 0 and np.abs(ref_g).max() > 0
    assert H.rel_err(grad_f, ref_f) <= TOL, H.rel_err(grad_f, ref_f)
    assert H.rel_err(grad_g, ref_g) <= TOL, H.rel_err(grad_g, ref_g)
