"""BOP VSD of the port (gdm_tpu_torch.ops.render_depth and
gdm_tpu_torch.eval.vsd) against the JAX package on the CPU, class by class
as tests/test_vsd.py checks the JAX package, from the same numpy inputs.

Tolerances:
  * host code (subdivision, binning, culling, buckets, _prep_job windows
    and crops): bit-equal;
  * the plain renderers against JAX's: equal depth images (the port
    reproduces XLA's fused multiply-adds with fma32);
  * VSD errors: equal with the step cost; within 1e-6 with tlinear, whose
    per-tau sums run in another order.

The CUDA kernels run only on the card: the tests marked ``cuda`` compare
them with the plain versions there and skip here."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import _torch_harness as H  # noqa: F401  (JAX on the CPU platform)
import test_vsd as J
from gdm_tpu.eval import vsd as vsd_j
from gdm_tpu.ops import render_depth as rd_j
from gdm_tpu_torch.eval import vsd as vsd_t
from gdm_tpu_torch.ops import render_depth as rd_t

torch.set_num_threads(1)
K = J.K
TLINEAR_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _scatter_pair(vc, f, Kx, origin, window, tile):
    """(JAX, port plain) scatter renders of camera-frame vertices."""
    ref = np.asarray(rd_j.render_depth_window(
        _jnp(vc), _jnp(f), _jnp(Kx), _jnp(origin), window=window,
        tile=tile))
    got = rd_t.render_depth_window(_t(vc), _t(f), _t(Kx), _t(origin),
                                   window=window, tile=tile).numpy()
    return ref, got


def _render_full(verts, faces, hw=(480, 640), tile=16, max_edge=None):
    """tests/test_vsd.render_full through both packages; asserts the
    subdivisions and the images equal and returns the image."""
    if max_edge is None:
        zmin = float(verts[:, 2].min())
        max_edge = 0.5 * (tile - 4) * zmin / float(K[0, 0])
    v, f = rd_t.subdivide_max_edge(verts, faces, max_edge)
    vj, fj = rd_j.subdivide_max_edge(verts, faces, max_edge)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    ref, got = _scatter_pair(v, f, K, np.zeros(2, np.float32), hw, tile)
    np.testing.assert_array_equal(got, ref)
    return got


def _vsd_pair(*args, **kw):
    """vsd_err of both packages (the port on the CPU)."""
    e_j = vsd_j.vsd_err(*args, **kw)
    e_t = vsd_t.vsd_err(*args, device="cpu", **kw)
    assert e_t.shape == e_j.shape == (len(kw.get("taus", vsd_t.BOP19_TAUS)),)
    return e_j, e_t


class TestSubdivide:
    def test_edges_bounded_and_surface_preserved(self):
        verts, faces = J.square_mesh(half=0.2, z=1.0)
        v, f = rd_t.subdivide_max_edge(verts, faces, 0.05)
        vj, fj = rd_j.subdivide_max_edge(verts, faces, 0.05)
        np.testing.assert_array_equal(v, vj)
        np.testing.assert_array_equal(f, fj)
        assert v.dtype == np.float32 and f.dtype == np.int32
        tri = v[f]
        e = np.linalg.norm(tri - np.roll(tri, -1, axis=1), axis=2)
        assert e.max() <= 0.05 + 1e-6

    def test_small_mesh_untouched(self):
        verts, faces = J.square_mesh(half=0.01)
        v, f = rd_t.subdivide_max_edge(verts, faces, 1.0)
        assert len(v) == 4 and len(f) == 2

    def test_unit_mismatch_fails_fast(self):
        verts, faces = J.square_mesh(half=200.0, z=1000.0)  # mm units
        with pytest.raises(ValueError, match="millimetre"):
            rd_t.subdivide_max_edge(verts, faces, 0.008, max_faces=100_000)


class TestRenderDepth:
    """The plain scatter renderer gives JAX's depth images."""

    def test_flat_square_depth_and_coverage(self):
        verts, faces = J.square_mesh(half=0.1, z=2.0)
        d = _render_full(verts, faces)
        inside = d[240 - 20:240 + 20, 320 - 20:320 + 20]
        assert np.all(inside > 0)
        assert d[:200, :].max() == 0.0

    def test_no_holes_across_shared_edges(self):
        verts, faces = J.square_mesh(half=0.15, z=1.5)
        d = _render_full(verts, faces, max_edge=0.02)
        r = int(0.14 * 500 / 1.5)
        assert np.all(d[240 - r:240 + r, 320 - r:320 + r] > 0)

    def test_perspective_correct_slanted_plane(self):
        verts = np.array([[-0.3, -0.3, 0.7], [0.3, -0.3, 1.3],
                          [0.3, 0.3, 1.3], [-0.3, 0.3, 0.7]], np.float32)
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        d = _render_full(verts, faces, max_edge=0.02)
        for u in (300, 320, 340):
            z_true = 1.0 / (1.0 - (u + 0.5 - K[0, 2]) / K[0, 0])
            assert d[240, u] == pytest.approx(z_true, rel=5e-3)

    def test_z_buffer_occlusion(self):
        v1, f1 = J.square_mesh(half=0.1, z=2.0)
        v2, f2 = J.square_mesh(half=0.03, z=1.0)
        d = _render_full(np.concatenate([v1, v2]),
                         np.concatenate([f1, f2 + 4]).astype(np.int32))
        assert d[240, 320] == pytest.approx(1.0, abs=1e-4)
        assert d[240, 320 - 22] == pytest.approx(2.0, abs=1e-4)

    def test_window_origin_offset(self):
        verts, faces = J.square_mesh(half=0.1, z=2.0)
        v, f = rd_t.subdivide_max_edge(verts, faces, 0.02)
        full = _render_full(verts, faces, max_edge=0.02)
        ref, win = _scatter_pair(v, f, K, np.array([280.0, 200.0],
                                                   np.float32), (80, 80), 16)
        np.testing.assert_array_equal(win, ref)
        np.testing.assert_array_equal(win, full[200:280, 280:360])

    def test_degenerate_padding_faces_ignored(self):
        verts, faces = J.square_mesh(half=0.05, z=1.0)
        v, f = rd_t.subdivide_max_edge(verts, faces, 0.01)
        fp = np.zeros((2 * len(f), 3), np.int32)
        fp[:len(f)] = f
        o = np.zeros(2, np.float32)
        ref, a = _scatter_pair(v, f, K, o, (480, 640), 16)
        _, b = _scatter_pair(v, fp, K, o, (480, 640), 16)
        np.testing.assert_array_equal(a, ref)
        np.testing.assert_array_equal(b, ref)

    def test_empty_face_array_renders_nothing(self):
        verts, _ = J.square_mesh(half=0.05, z=1.0)
        d = rd_t.render_depth_window(_t(verts), torch.zeros(
            (0, 3), dtype=torch.int32), _t(K), torch.zeros(2), (64, 64), 16)
        assert d.shape == (64, 64) and float(d.max()) == 0.0

    def test_batch_of_renders_equals_each_render(self):
        """The batched call (one kernel launch on the card) renders each
        of its N renders as the single call does."""
        verts, faces = J.square_mesh(half=0.05, z=1.0)
        v, f = rd_t.subdivide_max_edge(verts, faces, 0.01)
        vs = np.stack([v, v + np.float32(0.01)])
        os_ = np.array([[280.0, 200.0], [270.0, 210.0]], np.float32)
        both = rd_t.render_depth_window(_t(vs), _t(np.stack([f, f[::-1]])),
                                        _t(K), _t(os_), (80, 80), 16)
        for i in range(2):
            ref, _ = _scatter_pair(vs[i], f, K, os_[i], (80, 80), 16)
            np.testing.assert_array_equal(both[i].numpy(), ref)


class TestGatherRenderer:
    """The plain gather renderer gives JAX's images and the scatter
    renderer's, in both the dense and the slot layout."""

    def _object(self, seed, side=128, tile=32):
        from gdm_tpu.data.synthetic import make_object
        from scipy.spatial import ConvexHull

        rng = np.random.RandomState(seed)
        mesh = make_object(128, rng, radius=0.05)
        verts = (mesh[:, :3] / 1000.0).astype(np.float32)
        faces = ConvexHull(verts).simplices.astype(np.int32)
        Kw = np.array([[500.0, 0, side / 2], [0, 500.0, side / 2],
                       [0, 0, 1]], np.float32)
        v, f = rd_t.subdivide_max_edge(verts, faces,
                                       (tile - 2) * 0.6 / Kw[0, 0])
        t = np.array([rng.uniform(-0.01, 0.01),
                      rng.uniform(-0.01, 0.01), 0.7], np.float32)
        return (v + t).astype(np.float32), f, Kw

    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_scatter_bitwise(self, seed):
        tile, side = 32, 128
        vc, f, Kw = self._object(seed, side, tile)
        origin = np.zeros(2, np.float32)
        ref, scat = _scatter_pair(vc, f, Kw, origin, (side, side), tile)
        np.testing.assert_array_equal(scat, ref)
        p, valid = J.TestGatherRenderer()._project_valid(vc, f, Kw, origin,
                                                         side, tile)
        cand = rd_t.bin_faces_to_tiles(p, valid, f, side, tile)
        np.testing.assert_array_equal(
            cand, rd_j.bin_faces_to_tiles(p, valid, f, side, tile))
        assert ref.max() > 0
        got = rd_t.render_depth_window_gather(
            _t(vc), _t(cand), _t(Kw), _t(origin), (side, side), tile).numpy()
        got_j = np.asarray(rd_j.render_depth_window_gather(
            _jnp(vc), _jnp(cand), _jnp(Kw), _jnp(origin),
            window=(side, side), tile=tile))
        np.testing.assert_array_equal(got, got_j)
        np.testing.assert_array_equal(got, ref)
        # slot layout, rows spilling at a small capacity
        cs, st = rd_t.bin_faces_to_slots(p, valid, f, side, tile, 8)
        assert len(st) > len(np.unique(st))
        slot = rd_t.render_depth_window_gather(
            _t(vc), _t(cs), _t(Kw), _t(origin), (side, side), tile,
            slot_tile=_t(st)).numpy()
        np.testing.assert_array_equal(slot, ref)

    def test_vsd_gather_matches_scatter(self):
        from gdm_tpu.data.synthetic import make_object
        from scipy.spatial import ConvexHull

        rng = np.random.RandomState(5)
        mesh = make_object(128, rng, radius=0.05)
        verts = (mesh[:, :3] / 1000.0).astype(np.float32)
        faces = ConvexHull(verts).simplices.astype(np.int32)
        R_gt = np.eye(3, dtype=np.float32)
        t_gt = np.array([0.0, 0.0, 0.8], np.float32)
        dR, _ = np.linalg.qr(np.eye(3) + 0.05 * rng.randn(3, 3))
        R_e = (dR * np.sign(np.linalg.det(dR))).astype(np.float32)
        t_e = t_gt + np.array([0.004, -0.003, 0.006], np.float32)
        depth = np.full((480, 640), 1.1, np.float32)
        args = (R_e, t_e, R_gt, t_gt, depth, K, verts, faces, 0.1)
        # the port renders with its scatter form; JAX with either form
        e_g, e_t = _vsd_pair(*args)
        e_s = vsd_j.vsd_err(*args, renderer="scatter")
        assert np.all((e_t >= 0) & (e_t <= 1)) and e_t.max() > 0
        np.testing.assert_array_equal(e_t, e_g)
        np.testing.assert_array_equal(e_t, e_s)

    def test_empty_candidates(self):
        verts, faces = J.square_mesh(half=0.05, z=1.0)
        cand = rd_t.bin_faces_to_tiles(np.zeros((2, 3, 2), np.float32),
                                       np.zeros(2, bool), faces, 64, 32)
        d = rd_t.render_depth_window_gather(
            _t(verts), _t(cand), _t(K), torch.zeros(2), (64, 64), 32)
        assert d.shape == (64, 64) and float(d.max()) == 0.0


def _gt_depth(verts, faces, hw=(480, 640)):
    return J.render_full(verts, faces, K, hw=hw, max_edge=0.02)


class TestVSD:
    def setup_method(self, _):
        self.verts, self.faces = J.square_mesh(half=0.1, z=0.0)
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.array([0, 0, 2.0], np.float32)
        self.depth_test = _gt_depth(self.verts @ self.R.T + self.t,
                                    self.faces)
        self.diameter = float(0.2 * np.sqrt(2))

    def _args(self, t_est, depth=None):
        return (self.R, t_est, self.R, self.t,
                self.depth_test if depth is None else depth, K,
                self.verts, self.faces, self.diameter)

    def test_perfect_pose_zero_error(self):
        e_j, e_t = _vsd_pair(*self._args(self.t))
        np.testing.assert_array_equal(e_t, e_j)
        assert np.all(e_t < 0.02)

    def test_grossly_wrong_pose_error_one(self):
        e_j, e_t = _vsd_pair(*self._args(self.t + np.array([1.0, 0, 0],
                                                           np.float32)))
        np.testing.assert_array_equal(e_t, e_j)
        assert np.all(e_t > 0.95)

    def test_small_offset_monotone_in_tau(self):
        """tau = 0.2 sits on the 0.2-diameter offset: its error depends
        on the last bit of every distance, and still agrees."""
        t_off = self.t + np.array([0, 0, 0.2 * self.diameter], np.float32)
        e_j, e_t = _vsd_pair(*self._args(t_off), delta=self.diameter)
        np.testing.assert_array_equal(e_t, e_j)
        taus = np.arange(0.05, 0.51, 0.05)
        assert np.all(e_t[taus < 0.19] > 0.9)
        assert np.all(e_t[taus > 0.21] < 0.1)

    def test_occluder_removes_visible_surface(self):
        occ_v, occ_f = J.square_mesh(half=0.025, z=1.0, cx=-0.025)
        occ = _gt_depth(occ_v, occ_f)
        depth = self.depth_test.copy()
        depth[occ > 0] = occ[occ > 0]
        e_j, e_t = _vsd_pair(*self._args(self.t, depth))
        np.testing.assert_array_equal(e_t, e_j)
        assert np.all(e_t < 0.05)

    def test_missing_depth_counts_visible_bop19(self):
        e_j, e_t = _vsd_pair(*self._args(
            self.t, np.zeros_like(self.depth_test)))
        np.testing.assert_array_equal(e_t, e_j)
        assert np.all(e_t < 0.02)

    def test_tlinear_cost(self):
        t_off = self.t + np.array([0, 0, 0.1 * self.diameter], np.float32)
        e_j, e_t = _vsd_pair(*self._args(t_off), delta=self.diameter,
                             cost_type="tlinear")
        np.testing.assert_allclose(e_t, e_j, rtol=0, atol=TLINEAR_TOL)
        assert e_t[-1] == pytest.approx(0.2, abs=0.06)

    def _evaluators(self):
        """(JAX, port) Evaluators with VSD for the square."""
        from gdm_tpu.eval.evaluator import Evaluator as EvJ
        from gdm_tpu_torch.eval.evaluator import Evaluator as EvT

        a = ("synth", ["obj"], {"obj": self.diameter}, {"obj": self.verts})
        mesh = {"obj": (self.verts, self.faces)}
        return (EvJ(*a, vsd_meshes=mesh),
                EvT(*a, vsd_meshes=mesh, device="cpu"))

    def test_evaluator_integration(self):
        res = []
        t_bad = self.t + np.array([1.0, 0, 0], np.float32)
        gt = {"R": self.R, "t": self.t, "K": K, "depth": self.depth_test}
        for ev in self._evaluators():
            ev.add_prediction("obj", "1/0", self.R, self.t)
            ev.add_prediction("obj", "1/1", self.R, t_bad)
            res.append(ev.evaluate({"obj": {"1/0": gt, "1/1": gt,
                                            "1/2": gt}}))
        r_j, r_t = res
        assert r_t["recalls"]["obj"]["vsd"] == [1.0, 0.0, 0.0]
        assert r_t["recalls"]["obj"]["vsd"] == r_j["recalls"]["obj"]["vsd"]
        for a, b in zip(r_t["errors"]["obj"]["vsd"],
                        r_j["errors"]["obj"]["vsd"]):
            np.testing.assert_array_equal(a, b)
        assert np.all(np.isinf(r_t["errors"]["obj"]["vsd"][2]))  # missing
        assert r_t["bop19_ar"]["obj"] == r_j["bop19_ar"]["obj"]
        assert r_t["bop19_ar"]["obj"]["ar_vsd"] == pytest.approx(1 / 3)
        assert r_t["table"] == r_j["table"]
        assert "vsd" in r_t["table"] and "bop19_ar" in r_t["table"]

    def test_evaluator_depth_file_loading(self, tmp_path):
        """A 16-bit PNG at a depth factor, like BOP test frames: the port
        reads it with data/imio, JAX with PIL."""
        from gdm_tpu_torch.data.imio import imwrite_png

        factor = 10000.0
        p = tmp_path / "depth.png"
        imwrite_png(str(p), (self.depth_test * factor).astype(np.uint16))
        gt = {"R": self.R, "t": self.t, "K": K, "depth_file": str(p),
              "depth_factor": factor}
        res = []
        for ev in self._evaluators():
            ev.add_prediction("obj", "1/0", self.R,
                              self.t + np.array([0.002, 0, 0.004]))
            res.append(ev.evaluate({"obj": {"1/0": gt}}))
        np.testing.assert_array_equal(res[1]["errors"]["obj"]["vsd"][0],
                                      res[0]["errors"]["obj"]["vsd"][0])
        assert res[1]["recalls"]["obj"]["vsd"] == [1.0]

    def test_recall(self):
        errs = [np.full(10, 0.1), np.full(10, 0.9)]
        for mod in (vsd_t, vsd_j):
            assert mod.vsd_recall(errs) == pytest.approx(0.5)
            assert mod.vsd_recall(errs, correct_ths=(0.95,)) == 1.0
            assert mod.vsd_recall([]) == 0.0
        assert vsd_t.BOP19_TAUS == vsd_j.BOP19_TAUS
        assert vsd_t.BOP19_DELTA == vsd_j.BOP19_DELTA
        assert vsd_t.BOP19_CORRECT_TH == vsd_j.BOP19_CORRECT_TH


class TestVSDBatch:
    """vsd_err_batch gives JAX's batch errors and its own single-frame
    errors, across window and z buckets."""

    def setup_method(self, _):
        self.verts, self.faces = J.square_mesh(half=0.1, z=0.0)
        self.R = np.eye(3, dtype=np.float32)
        self.diameter = float(0.2 * np.sqrt(2))

    @pytest.mark.parametrize("cost_type", ["step", "tlinear"])
    def test_matches_single_frame_path_and_jax(self, cost_type):
        rng = np.random.RandomState(0)
        poses, depths = [], []
        for z in [2.0, 2.0, 1.0, 4.0, 2.0]:
            t_gt = np.array([0, 0, z], np.float32)
            depths.append(_gt_depth(self.verts @ self.R.T + t_gt,
                                    self.faces))
            t_est = t_gt + rng.randn(3).astype(np.float32) \
                * (0.02 * self.diameter)
            poses.append((self.R, t_est, self.R, t_gt))
        args = (poses, depths, K, self.verts, self.faces, self.diameter)
        batch = vsd_t.vsd_err_batch(*args, cost_type=cost_type,
                                    group_cap=2, device="cpu")
        batch_j = vsd_j.vsd_err_batch(*args, cost_type=cost_type)
        assert batch.shape == (5, 10) and batch.dtype == np.float64
        tol = 0.0 if cost_type == "step" else TLINEAR_TOL
        np.testing.assert_allclose(batch, batch_j, rtol=0, atol=tol)
        for i, (p, d) in enumerate(zip(poses, depths)):
            single = vsd_t.vsd_err(p[0], p[1], p[2], p[3], d, K, self.verts,
                                   self.faces, self.diameter,
                                   cost_type=cost_type, device="cpu")
            np.testing.assert_array_equal(batch[i], single)

    def test_per_frame_intrinsics(self):
        K2 = K.copy()
        K2[0, 0] = K2[1, 1] = 450.0
        t = np.array([0, 0, 2.0], np.float32)
        d1 = _gt_depth(self.verts + t, self.faces)
        d2 = np.asarray(rd_j.render_depth_window(
            _jnp(self.verts + t), _jnp(self.faces), _jnp(K2),
            _jnp(np.zeros(2, np.float32)), window=(480, 640), tile=16))
        args = ([(self.R, t, self.R, t)] * 2, [d1, d2], np.stack([K, K2]),
                self.verts, self.faces, self.diameter)
        batch = vsd_t.vsd_err_batch(*args, device="cpu")
        np.testing.assert_array_equal(batch, vsd_j.vsd_err_batch(*args))
        assert np.all(batch < 0.05)

    def test_pipeline_depth_changes_nothing(self):
        t = np.array([0, 0, 2.0], np.float32)
        rng = np.random.RandomState(1)
        d = _gt_depth(self.verts + t, self.faces)
        poses = [(self.R, t + rng.randn(3).astype(np.float32) * 0.005,
                  self.R, t) for _ in range(3)]
        args = (poses, [d] * 3, K, self.verts, self.faces, self.diameter)
        a = vsd_t.vsd_err_batch(*args, group_cap=1, pipeline_depth=0,
                                device="cpu")
        b = vsd_t.vsd_err_batch(*args, group_cap=1, pipeline_depth=2,
                                device="cpu")
        np.testing.assert_array_equal(a, b)


class TestWindowAndSubdivisionBounds:
    def test_bucket_grows_past_largest(self):
        assert vsd_t._WINDOW_BUCKETS == vsd_j._WINDOW_BUCKETS
        for v in (1, 64, 65, 200, 1024, 1025, 3000):
            assert vsd_t._bucket(v, vsd_t._WINDOW_BUCKETS) == \
                vsd_j._bucket(v, vsd_j._WINDOW_BUCKETS)
        assert vsd_t._bucket(1025, vsd_t._WINDOW_BUCKETS) == 2048

    def test_ray_angle_factor_from_intrinsics(self):
        for f in (500.0, 250.0):
            Kn = np.array([[f, 0, 320], [0, f, 240], [0, 0, 1]])
            assert vsd_t._ray_angle_factor(Kn, (480, 640), 18.0) == \
                vsd_j._ray_angle_factor(Kn, (480, 640), 18.0)

    def test_z_bucket(self):
        for z in (-1.0, 0.05, 0.126, 0.3, 0.45, 0.6, 2.0, 1e3):
            assert vsd_t._z_bucket(z) == vsd_j._z_bucket(z)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_prep_job_windows_and_crops_bit_equal(self, seed):
        """Window origin and size, crop, z bucket of random poses, some
        far out of the frame or behind the camera."""
        from scipy.spatial.transform import Rotation

        rng = np.random.RandomState(seed)
        verts = (rng.randn(300, 3) * 0.04).astype(np.float32)
        depth = (rng.rand(480, 640) * 2).astype(np.float32)
        for i in range(4):
            R = [Rotation.random(random_state=seed * 10 + i + k).as_matrix()
                 for k in (0, 1)]
            t_gt = np.array([0.05, -0.02, 0.5]) + 0.1 * rng.randn(3)
            t_e = t_gt + [(0.01, 0, 0), (0.6, 0, 0), (0, 0, -1000.5),
                          (0, 0.3, 0.2)][i]
            a = (R[0], t_e, R[1], t_gt, depth, K, verts, 32)
            jt, jj = vsd_t._prep_job(*a), vsd_j._prep_job(*a)
            assert jt.keys() == jj.keys()
            for k in jt:
                np.testing.assert_array_equal(jt[k], jj[k], err_msg=k)


class TestBackfaceCull:
    def _sphere(self, n=200):
        return J.TestBackfaceCull()._sphere(n=n)

    def test_winding_orientation(self):
        from gdm_tpu_torch.data.ply import _winding_orientation as wo

        verts, faces = self._sphere()
        bad = faces.copy()
        bad[0] = bad[0][[0, 2, 1]]
        sq_v, sq_f = J.square_mesh()
        for v, f, want in ((verts, faces, 1.0),
                           (verts, faces[:, [0, 2, 1]], -1.0),
                           (verts, bad, None), (sq_v, sq_f, None)):
            assert wo(v, f) == vsd_j._winding_orientation(v, f) == want

    def test_face_bucket_sequence(self):
        for n in (0, 1, 700, 1024, 1025, 2049, 4100, 9569, 20000, 100000):
            assert vsd_t._face_bucket(n) == vsd_j._face_bucket(n)
            assert vsd_t._face_bucket(n, base=64) == \
                vsd_j._face_bucket(n, base=vsd_j._CAND_BUCKET_MIN)
            assert vsd_t._face_bucket(n) % vsd_t._FACE_CHUNK == 0

    @pytest.mark.parametrize("flip_all", [False, True])
    def test_cull_is_exact_on_closed_mesh(self, flip_all):
        from gdm_tpu_torch.data.ply import _winding_orientation

        verts, faces = self._sphere()
        if flip_all:
            faces = faces[:, [0, 2, 1]].copy()
        orient = _winding_orientation(verts, faces)
        v2, f2 = rd_t.subdivide_max_edge(verts, faces, 0.01)
        rng = np.random.RandomState(1)
        R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
        R *= np.sign(np.linalg.det(R))
        t = np.array([0.01, -0.005, 0.5], np.float32)
        origin = np.array([288.0, 208.0], np.float32)
        side, tile = 64, 16
        a = (v2, f2, orient, R, t, K, origin, side, tile)
        idx = vsd_t._visible_face_idx(*a)
        np.testing.assert_array_equal(idx, vsd_j._visible_face_idx(*a))
        assert 0 < len(idx) < len(f2) // 2 + len(f2) // 8
        vc = (v2 @ R.T + t).astype(np.float32)
        fc = np.zeros((vsd_t._face_bucket(len(idx)), 3), np.int32)
        fc[:len(idx)] = f2[idx]
        ref, d_all = _scatter_pair(vc, f2, K, origin, (side, side), tile)
        _, d_cull = _scatter_pair(vc, fc, K, origin, (side, side), tile)
        np.testing.assert_array_equal(d_all, ref)
        assert (d_all > 0).sum() > 100
        np.testing.assert_array_equal(d_all, d_cull)

    def test_batch_equals_single_on_closed_mesh(self):
        verts, faces = self._sphere(n=80)
        rng = np.random.RandomState(2)
        R = np.eye(3, dtype=np.float32)
        poses, depths = [], []
        for z in (0.6, 0.9):
            t_gt = np.array([0, 0, z], np.float32)
            depths.append(_gt_depth(verts @ R.T + t_gt, faces))
            poses.append((R, t_gt + rng.randn(3).astype(np.float32) * 0.002,
                          R, t_gt))
        args = (poses, depths, K, verts, faces, 0.1)
        batch = vsd_t.vsd_err_batch(*args, device="cpu")
        np.testing.assert_array_equal(batch, vsd_j.vsd_err_batch(*args))
        for i, (p, d) in enumerate(zip(poses, depths)):
            np.testing.assert_array_equal(batch[i], vsd_t.vsd_err(
                p[0], p[1], p[2], p[3], d, K, verts, faces, 0.1,
                device="cpu"))


class TestSentinelPose:
    def setup_method(self, _):
        self.verts, self.faces = J.square_mesh(half=0.1, z=0.0)
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.array([0, 0, 2.0], np.float32)
        self.depth_test = _gt_depth(self.verts @ self.R.T + self.t,
                                    self.faces)
        self.diameter = float(0.2 * np.sqrt(2))

    def test_behind_camera_estimate_uses_gt_z_bucket(self):
        t_sent = np.array([0, 0, -1000.0], np.float32)
        job = vsd_t._prep_job(self.R, t_sent, self.R, self.t,
                              self.depth_test, K, self.verts, tile=32)
        assert job["zb"] == vsd_t._z_bucket(float(
            (self.verts @ self.R.T + self.t)[:, 2].min()))
        assert job["zb"] > 1.0

    def test_batch_with_sentinel_frame_completes(self):
        t_sent = np.array([0, 0, -1000.0], np.float32)
        poses = [(self.R, self.t, self.R, self.t),
                 (self.R, t_sent, self.R, self.t)]
        args = (poses, [self.depth_test] * 2, K, self.verts, self.faces,
                self.diameter)
        errs = vsd_t.vsd_err_batch(*args, device="cpu")
        np.testing.assert_array_equal(errs, vsd_j.vsd_err_batch(*args))
        assert np.all(errs[0] < 0.02) and np.all(errs[1] > 0.95)


class TestHardMesh:
    """The concave, closed 20k-face trefoil (data/synthetic
    make_trefoil_mesh), where the JAX tests use it."""

    @pytest.fixture(scope="class")
    def trefoil(self):
        from gdm_tpu.data.synthetic import make_trefoil_mesh as mk_j
        from gdm_tpu_torch.data.synthetic import make_trefoil_mesh

        verts, faces = make_trefoil_mesh()
        vj, fj = mk_j()
        np.testing.assert_array_equal(verts, vj)
        np.testing.assert_array_equal(faces, fj)
        return verts, faces

    def test_manifold_and_scale(self, trefoil):
        from gdm_tpu_torch.data.ply import _winding_orientation

        verts, faces = trefoil
        assert len(faces) >= 20000 and faces.dtype == np.int32
        assert _winding_orientation(verts, faces) == 1.0

    def test_cull_exact_on_concave_mesh(self, trefoil):
        verts, faces = trefoil
        rng = np.random.RandomState(3)
        R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
        R *= np.sign(np.linalg.det(R))
        t = np.array([0.0, 0.0, 0.45], np.float32)
        origin = np.array([320.0 - 96, 240.0 - 96], np.float32)
        side, tile = 192, 16
        a = (verts, faces, 1.0, R, t, K, origin, side, tile)
        idx = vsd_t._visible_face_idx(*a)
        np.testing.assert_array_equal(idx, vsd_j._visible_face_idx(*a))
        assert 0 < len(idx) < int(0.72 * len(faces))
        vc = (verts @ R.T + t).astype(np.float32)
        fc = np.zeros((vsd_t._face_bucket(len(idx)), 3), np.int32)
        fc[:len(idx)] = faces[idx]
        ref, d_all = _scatter_pair(vc, faces, K, origin, (side, side), tile)
        np.testing.assert_array_equal(d_all, ref)
        _, d_cull = _scatter_pair(vc, fc, K, origin, (side, side), tile)
        cov = d_all[d_all > 0]
        assert cov.size > 2000 and cov.max() - cov.min() > 0.02
        np.testing.assert_array_equal(d_all, d_cull)

    def _cluttered(self, verts, faces, t):
        depth = _gt_depth(verts + t, faces).copy()
        occ_v, occ_f = J.square_mesh(half=0.02, z=0.35, cx=-0.03)
        occ = _gt_depth(occ_v, occ_f)
        depth[occ > 0] = occ[occ > 0]
        depth[np.random.RandomState(5).rand(*depth.shape) < 0.05] = 0.0
        return depth

    @pytest.mark.slow
    def test_vsd_concave_cluttered(self, trefoil):
        verts, faces = trefoil
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.0, 0.0, 0.45], np.float32)
        diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        depth = self._cluttered(verts, faces, t)
        for t_e in (t, t + np.array([0.5, 0, 0], np.float32)):
            e_j, e_t = _vsd_pair(R, t_e, R, t, depth, K, verts, faces,
                                 diameter)
            np.testing.assert_array_equal(e_t, e_j)

    @pytest.mark.slow
    def test_slot_gather_matches_scatter(self, trefoil):
        verts, faces = trefoil
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.0, 0.0, 0.45], np.float32)
        diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        depth = _gt_depth(verts + t, faces)
        t_est = t + np.array([0.002, -0.001, 0.003], np.float32)
        a = (R, t_est, R, t, depth, K, verts, faces, diameter)
        e_t = vsd_t.vsd_err(*a, device="cpu")
        np.testing.assert_array_equal(e_t, vsd_j.vsd_err(*a))
        np.testing.assert_array_equal(
            e_t, vsd_j.vsd_err(*a, renderer="scatter"))

    @pytest.mark.slow
    def test_batch_equals_single_on_hard_mesh(self, trefoil):
        verts, faces = trefoil
        diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
        rng = np.random.RandomState(4)
        R = np.eye(3, dtype=np.float32)
        poses, depths = [], []
        for z in (0.45, 0.6):
            t_gt = np.array([0, 0, z], np.float32)
            depths.append(_gt_depth(verts + t_gt, faces))
            poses.append((R, t_gt + rng.randn(3).astype(np.float32) * 0.003,
                          R, t_gt))
        args = (poses, depths, K, verts, faces, diameter)
        batch = vsd_t.vsd_err_batch(*args, device="cpu")
        np.testing.assert_array_equal(batch, vsd_j.vsd_err_batch(*args))


class TestSlotBinning:
    def test_spill_matches_dense_coverage(self):
        rng = np.random.RandomState(0)
        side, tile, k_cap, n = 64, 16, 4, 200
        centers = rng.rand(n, 1, 2) * (side - 6)
        p = (centers + rng.rand(n, 3, 2) * 3).astype(np.float32)
        faces = rng.randint(1, 999, (n, 3)).astype(np.int32)
        valid = rng.rand(n) < 0.8
        dense = rd_t.bin_faces_to_tiles(p, valid, faces, side, tile)
        np.testing.assert_array_equal(
            dense, rd_j.bin_faces_to_tiles(p, valid, faces, side, tile))
        np.testing.assert_array_equal(
            rd_t.bin_faces_to_tiles(p, valid, faces, side, tile, k_pad=80),
            rd_j.bin_faces_to_tiles(p, valid, faces, side, tile, k_pad=80))
        cand, st = rd_t.bin_faces_to_slots(p, valid, faces, side, tile,
                                           k_cap)
        cj, sj = rd_j.bin_faces_to_slots(p, valid, faces, side, tile, k_cap)
        np.testing.assert_array_equal(cand, cj)
        np.testing.assert_array_equal(st, sj)
        assert cand.shape[1] == k_cap and len(st) > len(np.unique(st))

    def test_empty_and_single(self):
        p = np.zeros((3, 3, 2), np.float32)
        faces = np.arange(9, dtype=np.int32).reshape(3, 3) + 1
        for valid in (np.zeros(3, bool), np.array([True, False, False])):
            ct, stt = rd_t.bin_faces_to_slots(p, valid, faces, 32, 16, 8)
            cj, sj = rd_j.bin_faces_to_slots(p, valid, faces, 32, 16, 8)
            np.testing.assert_array_equal(ct, cj)
            np.testing.assert_array_equal(stt, sj)
        assert (ct[0, 0] == faces[0]).all() and stt[0] == 0


def _exact_f32(fr):
    """Fraction -> nearest float32, ties to even (normal range)."""
    if fr == 0:
        return np.float32(0.0)
    sign, x = (-1, -fr) if fr < 0 else (1, fr)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    q = x / Fraction(2) ** (e - 23)
    m, rem = divmod(q.numerator, q.denominator)
    if 2 * rem > q.denominator or (2 * rem == q.denominator and m % 2):
        m += 1
    return np.float32(sign * m * 2.0 ** (e - 23))


class TestWrapper:
    def test_fma32_is_exactly_rounded(self):
        """Against exact rational arithmetic, on random triples and on
        sums that land a hair off an f32 halfway point, where rounding
        through float64 would round twice."""
        rng = np.random.RandomState(0)
        a = rng.randn(3000).astype(np.float32)
        b = rng.randn(3000).astype(np.float32)
        c = (rng.randn(3000) * np.exp(rng.randn(3000) * 3)).astype(
            np.float32)
        x = np.float32(1 + 2 ** -12)        # x*x = 1 + 2^-11 + 2^-24
        a = np.concatenate([a, [x, x, x]]).astype(np.float32)
        b = np.concatenate([b, [x, x, x]]).astype(np.float32)
        c = np.concatenate([c, [2 ** -80, -2 ** -80, 0.0]]).astype(np.float32)
        got = rd_t.fma32(_t(a), _t(b), _t(c)).numpy()
        want = np.array([_exact_f32(Fraction(float(p)) * Fraction(float(q))
                                    + Fraction(float(r)))
                         for p, q, r in zip(a, b, c)], np.float32)
        np.testing.assert_array_equal(got, want)
        assert got[-3] == np.nextafter(np.float32(1 + 2 ** -11),
                                       np.float32(2))

    def test_cpu_tensors_take_plain_versions(self):
        verts, faces = J.square_mesh(half=0.05, z=1.0)
        before = (rd_t.render_depth_window.launches,
                  rd_t.render_depth_window_gather.launches)
        rd_t.render_depth_window(_t(verts), _t(faces), _t(K),
                                 torch.zeros(2), (64, 64), 16)
        cand = rd_t.bin_faces_to_tiles(np.zeros((2, 3, 2), np.float32),
                                       np.zeros(2, bool), faces, 64, 32)
        rd_t.render_depth_window_gather(_t(verts), _t(cand), _t(K),
                                        torch.zeros(2), (64, 64), 32)
        assert before == (rd_t.render_depth_window.launches,
                          rd_t.render_depth_window_gather.launches)

    @pytest.mark.parametrize("case", ["f64_verts", "int64_cand",
                                      "window_not_tile_multiple",
                                      "slot_shape", "dense_rows",
                                      "non_contiguous"])
    def test_kernel_wrapper_rejects_bad_input(self, case):
        """The kernel path validates before it builds or launches."""
        n, v, rows, k = 2, 10, 4, 8
        verts = torch.zeros(n, v, 3)
        cand = torch.zeros(n, rows, k, 3, dtype=torch.int32)
        Kt, origin = torch.eye(3), torch.zeros(n, 2)
        window, slot = (64, 64), None
        if case == "f64_verts":
            verts = verts.double()
        elif case == "int64_cand":
            cand = cand.long()
        elif case == "window_not_tile_multiple":
            window = (64, 48 + 8)
        elif case == "slot_shape":
            slot = torch.zeros(n, rows + 1, dtype=torch.int32)
        elif case == "dense_rows":        # 5 rows for 4 tiles
            cand = torch.zeros(n, rows + 1, k, 3, dtype=torch.int32)
        elif case == "non_contiguous":
            verts = torch.zeros(n, 3, v).transpose(1, 2)
        with pytest.raises((ValueError, TypeError)):
            rd_t._launch_gather(verts, cand, Kt, origin, window, 32, slot)

    def test_scatter_wrapper_rejects_bad_input(self):
        with pytest.raises(ValueError):
            rd_t._launch_scatter(torch.zeros(2, 5, 3),
                                 torch.zeros(3, 4, 3, dtype=torch.int32),
                                 torch.eye(3), torch.zeros(2, 2), (64, 64),
                                 16)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slot", "dense", "scatter"])
def test_kernels_match_plain_on_card(layout):
    """Each CUDA renderer against its plain version on the same card
    tensors, bit for bit, over a batch of two renders of one object at
    two positions (chip_smoke.py covers the VSD chunk shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    side, tile = 128, 32
    vc0, f, Kw = TestGatherRenderer()._object(0, side, tile)
    vc = np.stack([vc0, vc0 + np.float32(0.004)])
    origin = np.array([[0.0, 0.0], [3.0, -2.0]], np.float32)
    if layout == "scatter":
        table, st = np.stack([f, f[::-1]]), None
        fn, ref = rd_t.render_depth_window, \
            rd_t.render_depth_window_reference
    else:
        tables = []
        for i in range(2):
            p, valid = J.TestGatherRenderer()._project_valid(
                vc[i], f, Kw, origin[i], side, tile)
            tables.append(rd_t.bin_faces_to_slots(p, valid, f, side, tile, 8)
                          if layout == "slot" else
                          (rd_t.bin_faces_to_tiles(p, valid, f, side, tile,
                                                   k_pad=96), None))
        rows = max(len(c) for c, _ in tables)
        table = np.zeros((2, rows) + tables[0][0].shape[1:], np.int32)
        slot = np.full((2, rows), (side // tile) ** 2, np.int32)
        for i, (c, s) in enumerate(tables):
            table[i, :len(c)] = c
            if s is not None:
                slot[i, :len(s)] = s
        st = _t(slot).cuda() if layout == "slot" else None
        fn, ref = rd_t.render_depth_window_gather, \
            rd_t.render_depth_window_gather_reference
    args = (_t(vc).cuda(), _t(table).cuda(), _t(Kw).cuda(),
            _t(origin).cuda(), (side, side), tile)
    extra = {} if layout == "scatter" else {"slot_tile": st}
    got = fn(*args, **extra)
    want = torch.stack([ref(
        args[0][i], args[1][i], args[2], args[3][i], (side, side), tile,
        **({} if layout == "scatter" else
           {"slot_tile": None if st is None else st[i]}))
        for i in range(2)])
    torch.cuda.synchronize()
    assert float(want.max()) > 0
    assert torch.equal(got, want)
