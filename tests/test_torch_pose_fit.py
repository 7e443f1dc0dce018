"""Pose fit of the port: weighted Kabsch against the JAX package and the
ground truth on well-conditioned rigid pairs, the reflection fix, the
degenerate-covariance case, and the miss sentinel.  Fitted poses under
random network weights are never compared (an SVD of a near-degenerate
covariance is chaotic)."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch.eval import pose_fit
from gdm_tpu_torch.ops.kabsch import weighted_kabsch

torch.set_num_threads(1)


def _rigid_pairs(seed, n=200, b=3):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    A = (rng.rand(b, n, 3) - 0.5).astype(np.float32) * 0.2
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t = rng.uniform(-0.1, 0.5, (b, 3)).astype(np.float32)
    B = np.einsum("bij,bnj->bni", R, A) + t[:, None]
    rt = np.concatenate([R, t[..., None]], axis=2)
    return A, B.astype(np.float32), rt


@pytest.mark.parametrize("weights", ["ones", "mask", "random"])
@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_kabsch_matches_jax_and_truth(seed, weights):
    import jax
    import jax.numpy as jnp

    from gdm_tpu.ops.kabsch import weighted_kabsch as kabsch_j

    A, B, rt = _rigid_pairs(seed)
    rng = np.random.RandomState(10 + seed)
    w = {"ones": np.ones(A.shape[:2]),
         "mask": (rng.rand(*A.shape[:2]) > 0.5),
         "random": rng.rand(*A.shape[:2])}[weights].astype(np.float32)
    if weights == "mask":                   # masked rows carry outliers
        B = np.where(w[..., None] > 0, B, B + 5.0).astype(np.float32)
    got = weighted_kabsch(torch.from_numpy(A), torch.from_numpy(B),
                          torch.from_numpy(w)).numpy()
    ref = np.asarray(jax.vmap(kabsch_j)(jnp.asarray(A), jnp.asarray(B),
                                        jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, rt, rtol=0, atol=1e-5)


def test_reflection_is_corrected():
    """Mirrored target points: the best orthogonal map is a reflection,
    the fit returns a proper rotation."""
    A, _, _ = _rigid_pairs(3, b=1)
    B = A * np.array([1, 1, -1], np.float32)
    rt = weighted_kabsch(torch.from_numpy(A), torch.from_numpy(B),
                         torch.ones(1, A.shape[1]))[0]
    R = rt[:, :3].double()
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype), atol=1e-5)


def test_degenerate_correspondences_give_a_rotation():
    """Every scene point matched to one mesh vertex (untrained features):
    H has ~1e-19 entries; the scale normalisation keeps R orthonormal."""
    A = np.zeros((2, 50, 3), np.float32) + np.float32(0.03)
    B = np.random.RandomState(4).rand(2, 50, 3).astype(np.float32)
    rt = weighted_kabsch(torch.from_numpy(A), torch.from_numpy(B),
                         torch.ones(2, 50))
    assert torch.isfinite(rt).all()
    R = rt[:, :, :3].double()
    eye = torch.eye(3, dtype=R.dtype).expand(2, 3, 3)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-5)


@pytest.mark.parametrize("case", ["few_fg", "det_zero"])
def test_miss_sentinel(case):
    rng = np.random.RandomState(5)
    n, m, c = 40, 30, 16
    seg = np.zeros((2, n, 2), np.float32)
    seg[..., 1] = 1.0                                   # all foreground
    det = np.ones(2, np.float32)
    if case == "few_fg":
        seg[0, 4:, 1] = -1.0                            # frame 0: 4 points
    else:
        det[0] = 0.0
    rt, w, idx = pose_fit.fit_poses_from_outputs(
        torch.from_numpy(rng.rand(2, n, 3).astype(np.float32)),
        {"seg": torch.from_numpy(seg),
         "mesh": torch.from_numpy(rng.randn(m, c).astype(np.float32)),
         "rgbd": torch.from_numpy(rng.randn(2, n, c).astype(np.float32))},
        torch.from_numpy(rng.rand(m, 3).astype(np.float32)),
        det=torch.from_numpy(det))
    miss = torch.eye(3, 4)
    miss[2, 3] = -1000.0
    assert torch.equal(rt[0], miss)
    assert not torch.equal(rt[1], miss)
    assert float(w[0].sum()) < 5 and float(w[1].sum()) == n
    assert idx.shape == (2, n) and idx.dtype == torch.int64


def test_fit_weights_and_indices_match_jax():
    """fg mask, Kabsch weights and correspondence ids of the port's fit
    against jax.vmap(fit_pose_single) on the same random outputs."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.eval.pose_fit import fit_pose_single

    rng = np.random.RandomState(6)
    n, m, c = 300, 200, 32
    cld = rng.rand(2, n, 3).astype(np.float32)
    seg = rng.randn(2, n, 2).astype(np.float32)
    mf = rng.randn(m, c).astype(np.float32)
    rf = rng.randn(2, n, c).astype(np.float32)
    mxyz = rng.rand(m, 3).astype(np.float32)
    det = np.array([1.0, 1.0], np.float32)
    _, w_j, idx_j = jax.vmap(
        lambda a, s, r, d: fit_pose_single(a, s, jnp.asarray(mf), r,
                                           jnp.asarray(mxyz), d))(
        jnp.asarray(cld), jnp.asarray(seg), jnp.asarray(rf),
        jnp.asarray(det))
    t = torch.from_numpy
    _, w, idx = pose_fit.fit_poses_from_outputs(
        t(cld), {"seg": t(seg), "mesh": t(mf), "rgbd": t(rf)}, t(mxyz),
        det=t(det))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    f = rf / np.linalg.norm(rf, axis=-1, keepdims=True)
    mfn = mf / np.linalg.norm(mf, axis=-1, keepdims=True)
    sure = H.top2_gap(f.reshape(-1, c), mfn) > 1e-5
    np.testing.assert_array_equal(idx.numpy().reshape(-1)[sure],
                                  np.asarray(idx_j).reshape(-1)[sure])
