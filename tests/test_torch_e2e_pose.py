"""tests/test_e2e_pose.py's five tests on the port's chain: the port's
synthetic frames (data/synthetic.make_batch), GT correspondences, the
similarity argmax, the masked Kabsch fit and ICP, each also held against
the JAX package's outputs for the same arrays.

With oracle descriptors (each matched scene point carries its GT
vertex's feature) the argmax has no near-ties, so correspondences and
Kabsch weights must be equal and the fitted poses of the two packages
agree to f32 rounding of a well-posed 3x3 SVD (POSE_TOL).  ICP's
nearest-neighbour search uses the expanded distance form, whose f32
rounding can pick another of two near-equidistant neighbours in either
package, so its refined pose is held to ICP_TOL, far below the error it
removes (millimetres).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import conftest  # noqa: F401  (JAX on the CPU platform)
from gdm_tpu.data.synthetic import make_batch as make_batch_j
from gdm_tpu.eval.pose_fit import fit_pose_single
from gdm_tpu.eval.pose_fit import fit_poses_from_outputs as fit_j
from gdm_tpu.eval.pose_fit import icp_refine as icp_j
from gdm_tpu_torch.data.synthetic import make_batch, make_object
from gdm_tpu_torch.eval.metrics import add_err, re_err, te_err
from gdm_tpu_torch.eval.pose_fit import fit_poses_from_outputs, icp_refine

torch.set_num_threads(1)
K = np.array([[280.0, 0, 128], [0, 280.0, 128], [0, 0, 1]], np.float32)
POSE_TOL = 1e-5     # |port pose - JAX pose|, same correspondences
ICP_TOL = 1e-4      # |port ICP pose - JAX ICP pose|


def _oracle_outputs(batch, m, dim=32, seed=0):
    """Descriptors that are perfect for matched points, noise elsewhere
    (test_e2e_pose._oracle_outputs), as numpy."""
    rng = np.random.RandomState(seed)
    mesh_feat = rng.randn(m, dim).astype(np.float32)
    mesh_feat /= np.linalg.norm(mesh_feat, axis=1, keepdims=True)
    B, N = batch["match_idx"].shape
    rgbd = rng.randn(B, N, dim).astype(np.float32) * 0.01
    seg = np.zeros((B, N, 2), np.float32)
    seg[..., 0] = 5.0
    for b in range(B):
        mi = batch["match_idx"][b]
        ok = mi < m
        rgbd[b, ok] = mesh_feat[mi[ok]]
        seg[b, ok, 0] = -5.0
        seg[b, ok, 1] = 5.0
    return {"seg": seg, "rgbd": rgbd, "mesh": mesh_feat}


def _batch(mesh, **kw):
    """The port's batch, after checking that it is JAX's bit for bit."""
    got, poses = make_batch(mesh, K=K, **kw)
    want, _ = make_batch_j(mesh, K=K, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    return got, poses


def _fits(batch, outputs, mesh_pts, det=None):
    """(port poses, weights, idx) and JAX's, on the same arrays."""
    cld = batch["cld_rgb_nrm"][..., :3]
    t = {k: torch.from_numpy(v) for k, v in outputs.items()}
    poses, w, idx = fit_poses_from_outputs(
        torch.from_numpy(cld), t, torch.from_numpy(mesh_pts),
        det=None if det is None else torch.from_numpy(det))
    d = jnp.ones(len(cld)) if det is None else jnp.asarray(det)
    rt_j, w_j, idx_j = jax.vmap(
        lambda c, s, r, dd: fit_pose_single(
            c, s, jnp.asarray(outputs["mesh"]), r, jnp.asarray(mesh_pts),
            dd))(jnp.asarray(cld), jnp.asarray(outputs["seg"]),
                 jnp.asarray(outputs["rgbd"]), d)
    poses_j = np.asarray(fit_j(
        jnp.asarray(cld), {k: jnp.asarray(v) for k, v in outputs.items()},
        jnp.asarray(mesh_pts), det=None if det is None else d))
    np.testing.assert_array_equal(poses_j, np.asarray(rt_j))
    return ((poses.numpy(), w.numpy(), idx.numpy()),
            (poses_j, np.asarray(w_j), np.asarray(idx_j)))


def _same_fit(port, ref):
    (p, w, idx), (p_j, w_j, idx_j) = port, ref
    np.testing.assert_array_equal(w, w_j)
    np.testing.assert_array_equal(idx[w > 0], idx_j[w_j > 0])
    assert np.abs(p - p_j).max() <= POSE_TOL


class TestEndToEndPose:
    def test_pose_recovery_oracle_features(self):
        mesh = make_object(512, np.random.RandomState(3))
        mesh_pts = mesh[:, :3] / 1000.0
        batch, poses = _batch(mesh, batch=3, im_size=128, n_sample=1024)
        port, ref = _fits(batch, _oracle_outputs(batch, 512), mesh_pts)
        _same_fit(port, ref)
        fit = port[0]
        for b in range(3):
            r_deg = re_err(fit[b, :, :3], poses[b, :, :3])
            t_m = te_err(fit[b, :, 3], poses[b, :, 3])
            ad = add_err(fit[b, :, :3], fit[b, :, 3],
                         poses[b, :, :3], poses[b, :, 3], mesh_pts)
            # pixel quantisation of the synthetic render (~1 px at
            # f=280, z=0.4 -> ~1.4 mm point noise), as the JAX test
            assert r_deg < 6.0, f"frame {b}: rot err {r_deg}"
            assert t_m < 0.01, f"frame {b}: trans err {t_m}"
            assert ad < 0.008, f"frame {b}: add {ad}"

    def test_failed_detection_sentinel(self):
        mesh = make_object(256, np.random.RandomState(4))
        mesh_pts = mesh[:, :3] / 1000.0
        batch, _ = _batch(mesh, batch=2, im_size=128, n_sample=512)
        port, ref = _fits(batch, _oracle_outputs(batch, 256), mesh_pts,
                          det=np.array([1.0, 0.0], np.float32))
        _same_fit(port, ref)
        fit = port[0]
        assert fit[1, 2, 3] == -1000.0        # sentinel for failed det
        np.testing.assert_array_equal(fit[1], ref[0][1])
        assert fit[0, 2, 3] > -999.0

    def test_icp_refinement_improves_noisy_pose(self):
        from scipy.spatial.transform import Rotation

        mesh = make_object(512, np.random.RandomState(5))
        mesh_pts = mesh[:, :3] / 1000.0
        batch, poses = _batch(mesh, batch=1, im_size=128, n_sample=1024)
        cld = batch["cld_rgb_nrm"][0, :, :3]
        w = (batch["labels"][0] > 0).astype(np.float32)
        dR = Rotation.from_rotvec([0.05, -0.03, 0.02]).as_matrix()
        noisy = poses[0].copy()
        noisy[:, :3] = dR @ noisy[:, :3]
        noisy[:, 3] += np.array([0.005, -0.004, 0.006])
        # the visible vertices only: hidden back-face vertices matched to
        # front-surface points bias point-to-point ICP
        vis_pts = mesh_pts[batch["visible_flag"][0] > 0]
        refined = icp_refine(
            torch.from_numpy(vis_pts), torch.from_numpy(cld[None]),
            torch.from_numpy(w[None]), torch.from_numpy(noisy[None]),
            iters=15)[0].numpy()
        refined_j = np.asarray(icp_j(
            jnp.asarray(vis_pts), jnp.asarray(cld), jnp.asarray(w),
            jnp.asarray(noisy), iters=15))
        assert np.abs(refined - refined_j).max() <= ICP_TOL
        before = add_err(noisy[:, :3], noisy[:, 3], poses[0][:, :3],
                         poses[0][:, 3], mesh_pts)
        after = add_err(refined[:, :3], refined[:, 3], poses[0][:, :3],
                        poses[0][:, 3], mesh_pts)
        assert after < before * 0.5, (before, after)


class TestSyntheticData:
    def test_gt_correspondences_are_geometric(self):
        """match_idx points at the mesh vertex that lands on the scene
        point under the GT pose (and equals JAX's, _batch)."""
        mesh = make_object(512, np.random.RandomState(6))
        mesh_pts = mesh[:, :3] / 1000.0
        batch, poses = _batch(mesh, batch=1, im_size=128, n_sample=1024)
        mi = batch["match_idx"][0]
        cld = batch["cld_rgb_nrm"][0, :, :3]
        ok = mi < mesh_pts.shape[0]
        assert ok.sum() > 30
        proj = mesh_pts[mi[ok]] @ poses[0][:, :3].T + poses[0][:, 3]
        d = np.linalg.norm(proj - cld[ok], axis=1)
        assert np.percentile(d, 90) < 0.012

    def test_visible_flag_plausible(self):
        mesh = make_object(512, np.random.RandomState(7))
        batch, _ = _batch(mesh, batch=1, im_size=128, n_sample=512)
        vis = batch["visible_flag"][0]
        assert 0.2 < vis.mean() < 0.9
