"""Pose refinement of the port (ops/prng, ops/knn.knn_with_dist,
ops/ransac, ops/meanshift, eval/pose_fit icp_refine and apply_refine)
against the JAX package on the CPU, on the oracle problem of
tests/test_pose_refine.py: scene points are posed mesh points (with
noise and outliers), and one-hot-like features make every correspondence
exact.  Inputs come from numpy seeds; each tolerance is stated where it
is checked."""

import numpy as np
import pytest
import torch

import _torch_harness as H  # noqa: F401  (JAX on the CPU platform)
from gdm_tpu_torch.eval import pose_fit
from gdm_tpu_torch.ops import knn as knn_t
from gdm_tpu_torch.ops import prng
from gdm_tpu_torch.ops.meanshift import mean_shift
from gdm_tpu_torch.ops.ransac import ransac_kabsch

torch.set_num_threads(1)
POSE_TOL = 1e-5         # |port pose - JAX pose|, same correspondences


def _problem(b=3, n=512, m=300, noise=0.0, outlier_frac=0.0, seed=0,
             unique=False):
    """b frames of one mesh under b random poses: scene = posed mesh
    points (+ noise; the first outlier_frac of the points displaced by
    ~0.2 m), features = scaled one-hot-like rows, every point
    foreground.  ``unique`` takes each mesh point at most once (n <= m),
    so that the nearest scene point of a posed mesh point is never a
    near-tie (ICP).  Returns numpy (cld [b,n,3], out {'seg','rgbd',
    'mesh'}, mesh_xyz [m,3], gt [b,3,4], sel [b,n])."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    mesh_xyz = rng.randn(m, 3).astype(np.float32) * 0.05
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t = np.stack([np.array([0.02, -0.01, 0.5]) + 0.05 * rng.randn(3)
                  for _ in range(b)]).astype(np.float32)
    sel = (np.stack([rng.permutation(m)[:n] for _ in range(b)]) if unique
           else rng.randint(0, m, (b, n)))
    cld = np.einsum("bnj,bij->bni", mesh_xyz[sel], R) + t[:, None]
    if noise:
        cld = cld + rng.randn(b, n, 3).astype(np.float32) * noise
    n_out = int(outlier_frac * n)
    if n_out:
        cld[:, :n_out] += rng.randn(b, n_out, 3).astype(np.float32) * 0.2
    c = 64
    basis = rng.randn(m, c).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    seg = np.zeros((b, n, 2), np.float32)
    seg[..., 1] = 5.0
    out = {"seg": seg, "rgbd": basis[sel] * 10.0, "mesh": basis * 10.0}
    gt = np.concatenate([R, t[..., None]], axis=2)
    return cld.astype(np.float32), out, mesh_xyz, gt, sel


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _errors(rt, gt):
    r_err = np.rad2deg(np.arccos(np.clip(
        (np.trace(rt[:, :3] @ gt[:, :3].T) - 1) / 2, -1, 1)))
    return r_err, np.linalg.norm(rt[:, 3] - gt[:, 3])


# ---------------------------------------------------------------- prng

@pytest.mark.parametrize("seed,data", [(0, 0), (0, 7), (0, 123456),
                                       (3, 2 ** 31 - 1), (12, 2 ** 32 - 1)])
def test_fold_in_and_key_equal_jax(seed, data):
    """Bit-equal keys (integers: no tolerance)."""
    import jax

    kj = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    kt = prng.fold_in(prng.prng_key(seed), torch.tensor(data))
    np.testing.assert_array_equal(kt.numpy(), kj.astype(np.int64))
    np.testing.assert_array_equal(
        prng.prng_key(seed).numpy(),
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (3, 5), (32, 100), (7, 33)])
@pytest.mark.parametrize("data", [0, 5, 99991])
def test_random_bits_and_uniform_equal_jax(shape, data):
    """Bits and uniforms bit-equal to jax.random's (no tolerance)."""
    import jax

    kj = jax.random.fold_in(jax.random.PRNGKey(0), data)
    kt = prng.fold_in(prng.prng_key(0), torch.tensor(data))
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy(),
        np.asarray(jax.random.bits(kj, shape)).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(kt, shape, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(kj, shape, minval=tiny, maxval=1.0)))


def test_batched_keys_give_each_keys_bits():
    import jax

    data = torch.tensor([3, 10, 4000])
    keys = prng.fold_in(prng.prng_key(0), data)
    bits = prng.random_bits(keys, (4, 6)).numpy()
    for i, d in enumerate(data.tolist()):
        kj = jax.random.fold_in(jax.random.PRNGKey(0), d)
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(kj, (4, 6))).astype(np.int64))


def test_gumbel_and_top4_match_jax():
    """Gumbel noise within rtol 1e-6 (+ atol 1e-6 near 0): torch.log and
    XLA's log differ in the last place.  The RANSAC draw, the top-4
    index sets of g + log w with half of the weights 0, is equal for
    every hypothesis."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    n, h = 1024, 32
    for d in range(12):
        kj = jax.random.fold_in(jax.random.PRNGKey(0), d * 977)
        kt = prng.fold_in(prng.prng_key(0), torch.tensor(d * 977))
        gj = np.asarray(jax.random.gumbel(kj, (h, n)))
        gt = prng.gumbel(kt, (h, n)).numpy()
        np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)
        w = (rng.rand(n) > 0.5).astype(np.float32)
        logw = np.log(np.maximum(w, 1e-9))
        _, ij = jax.lax.top_k(jnp.asarray(gj + logw), 4)
        it = torch.topk(torch.from_numpy(gt + logw), 4).indices
        assert (np.sort(np.asarray(ij), 1) == np.sort(it.numpy(), 1)).all()


# --------------------------------------------------------------- knn

@pytest.mark.parametrize("k", [1, 4, 80])
def test_knn_with_dist_matches_jax(k):
    """Indices equal except where the k-th and (k+1)-th squared
    distances lie within 1e-6 m^2 (a near-tie), distances within 1e-6 m;
    k = 80 > 64 support points repeats the last neighbour."""
    import jax

    from gdm_tpu.ops.knn import knn_with_dist

    rng = np.random.RandomState(k)
    sup = (rng.rand(2, 64, 3) * 0.2).astype(np.float32)
    qry = (rng.rand(2, 100, 3) * 0.2).astype(np.float32)
    idx_j, dist_j = jax.vmap(lambda s, q: knn_with_dist(s, q, k, chunk=32))(
        sup, qry)
    idx_t, dist_t = knn_t.knn_with_dist(_t(sup), _t(qry), k, chunk=32)
    assert idx_t.shape == (2, 100, k) and dist_t.shape == (2, 100, k)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j),
                               rtol=0, atol=1e-6)
    sq = ((qry[:, :, None] - sup[:, None]) ** 2).sum(-1).astype(np.float64)
    srt = np.sort(sq, -1)
    kk = min(k, 64)
    # a neighbour's rank is sure when its distance is 1e-6 m^2 away from
    # both neighbours in the sorted order
    gaps = np.diff(srt, axis=-1)
    lo = np.concatenate([np.full(gaps.shape[:-1] + (1,), np.inf), gaps], -1)
    hi = np.concatenate([gaps, np.full(gaps.shape[:-1] + (1,), np.inf)], -1)
    sure = np.minimum(lo, hi)[..., :kk] > 1e-6
    got, ref = idx_t.numpy()[..., :kk], np.asarray(idx_j)[..., :kk]
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], ref[sure])
    if k > 64:
        assert (idx_t[..., 64:] == idx_t[..., 63:64]).all()
        assert (dist_t[..., 64:] == dist_t[..., 63:64]).all()


# ------------------------------------------------------------- ransac

def test_ransac_matches_jax():
    """Per-frame keys as apply_refine makes them; poses within 1e-5 of
    JAX's ransac_kabsch on a problem with 2 mm noise, 30% outliers and
    half of the weights 0 in one frame."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.ops.ransac import ransac_kabsch as ransac_j

    cld, _, mesh_xyz, gt, sel = _problem(b=4, noise=0.002,
                                         outlier_frac=0.3, seed=1)
    A = mesh_xyz[sel]
    w = np.ones(sel.shape, np.float32)
    w[2, ::2] = 0.0
    data = sel.sum(-1)
    keys_j = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0),
                                           jnp.int32(d)) for d in data])
    ref = np.asarray(jax.vmap(ransac_j)(jnp.asarray(A), jnp.asarray(cld),
                                        jnp.asarray(w), keys_j))
    keys_t = prng.fold_in(prng.prng_key(0), torch.from_numpy(data))
    got = ransac_kabsch(_t(A), _t(cld), _t(w), keys_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_TOL)
    for b in range(4):
        r_err, t_err = _errors(got[b], gt[b])
        assert r_err < 1.0 and t_err < 3e-3, (b, r_err, t_err)


# --------------------------------------------------------- mean shift

def test_mean_shift_matches_jax():
    """Centres within 1e-5 of JAX's vmapped mean_shift, labels equal.
    The frames converge after different numbers of shifts in one batch
    (the per-frame stop of a vmapped while_loop), one frame fully
    masked."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.ops.meanshift import mean_shift as mean_shift_j

    rng = np.random.RandomState(2)
    b, n = 4, 400
    pts = np.empty((b, n, 3), np.float32)
    for f in range(b):
        spread = 0.004 * (1 + 3 * f)        # wider clouds shift longer
        pts[f] = (rng.randn(n, 3) * spread
                  + np.array([0.0, 0.0, 0.5])).astype(np.float32)
        pts[f, : n // 4] += (rng.randn(n // 4, 3) * 0.1).astype(np.float32)
    mask = (rng.rand(b, n) > 0.2).astype(np.float32)
    mask[3] = 0.0
    c_j, l_j = jax.vmap(lambda p, mk: mean_shift_j(p, 0.05, mk))(
        jnp.asarray(pts), jnp.asarray(mask))
    c_t, l_t, it = mean_shift(_t(pts), 0.05, _t(mask), chunk=3)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert len(set(it[:3].tolist())) > 1, it
    assert int(it[3]) == 1                  # masked: nothing moves


# ---------------------------------------------------------------- icp

def test_icp_matches_jax():
    """icp_refine from a perturbed start against JAX's per frame: poses
    within 1e-5; per-frame gates (one frame gated at 1 mm keeps fewer
    matches)."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.eval.pose_fit import icp_refine as icp_j
    from scipy.spatial.transform import Rotation

    cld, _, mesh_xyz, gt, _ = _problem(b=3, n=400, m=400, noise=0.002,
                                       outlier_frac=0.3, seed=4, unique=True)
    w = np.ones(cld.shape[:2], np.float32)
    w[1, 100:200] = 0.0
    d = Rotation.from_rotvec(np.full((3, 3), 0.02)).as_matrix()
    init = gt.copy()
    init[:, :, :3] = np.einsum("bij,bjk->bik", d, gt[:, :, :3])
    init[:, :, 3] += 0.004
    init = init.astype(np.float32)
    gates = np.array([0.01, 0.001, 0.02], np.float32)
    ref = np.stack([np.asarray(icp_j(
        jnp.asarray(mesh_xyz), jnp.asarray(cld[b]), jnp.asarray(w[b]),
        jnp.asarray(init[b]), reject_dist=jnp.float32(gates[b])))
        for b in range(3)])
    got = pose_fit.icp_refine(_t(mesh_xyz), _t(cld), _t(w), _t(init),
                              reject_dist=_t(gates)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_TOL)
    r_err, t_err = _errors(got[0], gt[0])
    assert r_err < 1.0 and t_err < 2e-3


# -------------------------------------------------------- pose fit

@pytest.mark.parametrize("refine", [None, "ransac", "icp", "meanshift"])
def test_fit_poses_matches_jax(refine):
    """fit_poses_from_outputs, B = 3 with frame 1's detection failed:
    port against JAX within 1e-5, frame 1 the miss sentinel in both."""
    from gdm_tpu.eval.pose_fit import fit_poses_from_outputs as fit_j

    cld, out, mesh_xyz, _, _ = _problem(b=3, n=400, m=400, noise=0.002,
                                        outlier_frac=0.3, seed=5, unique=True)
    det = np.array([1.0, 0.0, 1.0], np.float32)
    ref = np.asarray(fit_j(cld, out, mesh_xyz, det=det, refine=refine))
    rt, w, _ = pose_fit.fit_poses_from_outputs(
        _t(cld), {k: _t(v) for k, v in out.items()}, _t(mesh_xyz),
        det=_t(det), refine=refine)
    np.testing.assert_allclose(rt.numpy(), ref, rtol=0, atol=POSE_TOL)
    miss = np.eye(3, 4, dtype=np.float32)
    miss[2, 3] = -1000.0
    np.testing.assert_array_equal(rt[1].numpy(), miss)
    assert float(w[1].sum()) == 0.0


@pytest.mark.parametrize("refine", [None, "ransac", "icp", "meanshift"])
def test_refine_recovers_pose(refine):
    """Clean oracle problem (tests/test_pose_refine.py's): < 1 degree and
    < 2 mm in every frame."""
    cld, out, mesh_xyz, gt, _ = _problem()
    rt, _, _ = pose_fit.fit_poses_from_outputs(
        _t(cld), {k: _t(v) for k, v in out.items()}, _t(mesh_xyz),
        refine=refine)
    for b in range(len(gt)):
        r_err, t_err = _errors(rt[b].numpy(), gt[b])
        assert r_err < 1.0 and t_err < 2e-3, (refine, b, r_err, t_err)


def test_ransac_beats_plain_with_outliers():
    cld, out, mesh_xyz, gt, _ = _problem(b=1, outlier_frac=0.3, seed=3)
    args = (_t(cld), {k: _t(v) for k, v in out.items()}, _t(mesh_xyz))
    rt_plain = pose_fit.fit_poses_from_outputs(*args)[0][0].numpy()
    rt_ransac = pose_fit.fit_poses_from_outputs(
        *args, refine="ransac")[0][0].numpy()
    r_p, t_p = _errors(rt_plain, gt[0])
    r_r, t_r = _errors(rt_ransac, gt[0])
    assert t_r < t_p and r_r < r_p
    assert r_r < 1.0 and t_r < 2e-3


def test_unknown_refine_mode_raises():
    cld, out, mesh_xyz, _, _ = _problem(b=1)
    with pytest.raises(ValueError, match="refine"):
        pose_fit.fit_poses_from_outputs(
            _t(cld), {k: _t(v) for k, v in out.items()}, _t(mesh_xyz),
            refine="lm")
