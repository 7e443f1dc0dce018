"""The scatter renderer of the port (gdm_tpu_torch.ops.render_depth
render_depth_window, the renderer of the port's VSD), against the JAX
package on the CPU, from the same numpy inputs.

Tolerances:
  * depth images: bit-equal to JAX's render_depth_window_gather over its
    host-binned slot table and to its render_depth_window;
  * VSD errors: equal with the step cost; within 1e-6 with tlinear, whose
    per-tau sums run in another order (tests/test_torch_vsd.py).

On the card both renderers test only the pixels of each face's bbox,
widened by one pixel (csrc/render_depth.cu), where the JAX renderers test
a whole stamp or tile: the coverage test below holds the plain arithmetic
(the kernels' bits) to that on random faces, slivers and faces whose
vertices lie on pixel edges and centres."""

import numpy as np
import pytest
import torch

import _torch_harness as H  # noqa: F401  (JAX on the CPU platform)
import test_vsd as J
import test_torch_vsd as TV
from test_torch_vsd import TLINEAR_TOL, _jnp, _t
from gdm_tpu.eval import vsd as vsd_j
from gdm_tpu.ops import render_depth as rd_j
from gdm_tpu_torch.eval import vsd as vsd_t
from gdm_tpu_torch.ops import render_depth as rd_t

torch.set_num_threads(1)
K = J.K


def _faces(kind, n, rng):
    """[n, 3, 2] f32 window coordinates of n faces of one kind."""
    if kind == "random":               # 0.5-60 px across
        a = rng.uniform(0, 200, (n, 1, 2))
        p = a + rng.uniform(-30, 30, (n, 3, 2)) * rng.uniform(0.02, 1,
                                                              (n, 1, 1))
    elif kind == "slivers":            # 1e-7 to 0.1 px thick
        a = rng.uniform(0, 200, (n, 2))
        th = rng.uniform(0, 2 * np.pi, n)
        d = np.stack([np.cos(th), np.sin(th)], 1)
        nrm = np.stack([-d[:, 1], d[:, 0]], 1)
        length = rng.uniform(1, 30, n)[:, None]
        s = rng.uniform(-0.5, 1.5, n)[:, None]
        thick = (10 ** rng.uniform(-7, -1, n) * rng.choice([-1, 1], n))
        p = np.stack([a, a + length * d, a + s * length * d
                      + thick[:, None] * nrm], 1)
    else:                              # vertices on pixel edges / centres
        p = rng.randint(0, 400, (n, 1, 2)) / 2.0 \
            + rng.randint(-40, 41, (n, 3, 2)) / 2.0
        p[:, 0] = p[:, 0].round()
    return p.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "slivers", "half_pixels"])
def test_no_pixel_beyond_the_bbox_is_covered(kind):
    """No pixel whose column (row) lies outside [floor(min), floor(max)]
    of a face's x (y) is covered, tested over the face's bbox widened by
    4 pixels within a 40 x 40 block: the kernels, which skip pixels a
    pixel beyond the bbox, give the JAX renderers' bits."""
    rng = np.random.RandomState({"random": 0, "slivers": 1,
                                 "half_pixels": 2}[kind])
    p = torch.from_numpy(_faces(kind, 3000, rng))
    fz = torch.ones(p.shape[0], 3)
    ok, inv_a = rd_t._setup(p, fz)
    lo = torch.floor(p.min(dim=1).values)
    hi = torch.floor(p.max(dim=1).values)
    lane = torch.arange(40 * 40)
    ix = lo[:, 0:1] - 4 + lane % 40
    iy = lo[:, 1:2] - 4 + lane // 40
    inside, _ = rd_t._zpix(p, fz, inv_a, ix + 0.5, iy + 0.5)
    covered = inside & ok[:, None]
    beyond = ((ix < lo[:, 0:1]) | (ix > hi[:, 0:1]) | (iy < lo[:, 1:2])
              | (iy > hi[:, 1:2]))
    assert int(ok.sum()) > 2900 and int(covered.sum()) > 100
    assert not bool((covered & beyond).any())


def _jax_gather_slots(vc, f, Kw, origin, side, tile, k_cap=64):
    p, valid = J.TestGatherRenderer()._project_valid(vc, f, Kw, origin,
                                                     side, tile)
    cand, st = rd_j.bin_faces_to_slots(p, valid, f, side, tile, k_cap)
    return np.asarray(rd_j.render_depth_window_gather(
        _jnp(vc), _jnp(cand), _jnp(Kw), _jnp(origin), window=(side, side),
        tile=tile, slot_tile=_jnp(st)))


@pytest.mark.parametrize("seed", [0, 1])
def test_stamp_bit_equal_jax_gather_and_scatter(seed):
    tile, side = 32, 128
    vc, f, Kw = TV.TestGatherRenderer()._object(seed, side, tile)
    origin = np.array([-4.0, 7.0], np.float32)
    want = _jax_gather_slots(vc, f, Kw, origin, side, tile)
    scat = np.asarray(rd_j.render_depth_window(
        _jnp(vc), _jnp(f), _jnp(Kw), _jnp(origin), window=(side, side),
        tile=tile))
    np.testing.assert_array_equal(want, scat)
    assert want.max() > 0
    fp = np.concatenate([f, np.zeros_like(f)])               # padding rows
    for faces in (f, fp):
        got = rd_t.render_depth_window(
            _t(vc), _t(faces), _t(Kw), _t(origin), (side, side), tile)
        np.testing.assert_array_equal(got.numpy(), want)


def test_stamp_empty_and_padding_only_face_lists():
    vc, f, Kw = TV.TestGatherRenderer()._object(0)
    for faces in (np.zeros((0, 3), np.int32), np.zeros((7, 3), np.int32)):
        d = rd_t.render_depth_window(
            _t(vc), _t(faces), _t(Kw), torch.zeros(2), (64, 64), 32)
        assert d.shape == (64, 64) and float(d.abs().max()) == 0.0


def test_stamp_batch_of_renders_with_different_origins():
    """One batched call (one kernel call on the card) renders each of its
    renders as JAX does, each at its own window origin."""
    tile, side = 32, 96
    vc0, f, Kw = TV.TestGatherRenderer()._object(1, 128, tile)
    vcs = np.stack([vc0, vc0 + np.float32(0.003), vc0]).astype(np.float32)
    origins = np.array([[0.0, 0.0], [20.0, 10.0], [37.0, 41.0]], np.float32)
    fl = np.stack([f, f[::-1], np.concatenate([f[:50], 0 * f[50:]])])
    got = rd_t.render_depth_window(_t(vcs), _t(fl), _t(Kw), _t(origins),
                                   (side, side), tile)
    assert got.shape == (3, side, side)
    for i in range(3):
        want = _jax_gather_slots(vcs[i], fl[i], Kw, origins[i], side, tile)
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert want.max() > 0


@pytest.mark.parametrize("case", ["f64_verts", "int64_faces", "faces_rank",
                                  "tile_not_positive", "K_shape", "batch",
                                  "non_contiguous"])
def test_stamp_wrapper_rejects_bad_input(case):
    """The kernel path validates before it builds or launches."""
    n, v, nf = 2, 10, 8
    verts = torch.zeros(n, v, 3)
    faces = torch.zeros(n, nf, 3, dtype=torch.int32)
    Kt, origin = torch.eye(3), torch.zeros(n, 2)
    tile = 32
    if case == "f64_verts":
        verts = verts.double()
    elif case == "int64_faces":
        faces = faces.long()
    elif case == "faces_rank":
        faces = torch.zeros(n, 2, nf, 3, dtype=torch.int32)
    elif case == "tile_not_positive":
        tile = 0
    elif case == "K_shape":
        Kt = torch.eye(4)
    elif case == "batch":
        origin = torch.zeros(n + 1, 2)
    elif case == "non_contiguous":
        verts = torch.zeros(n, 3, v).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        rd_t._launch_scatter(verts, faces, Kt, origin, (64, 64), tile)


@pytest.mark.cuda
def test_table_listing_every_face_in_every_tile_on_card():
    """The gather kernel on a dense table that lists every face in every
    tile (most entries lie outside their tile) equals its plain version
    and the scatter kernel, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tile, side = 32, 96
    vc, f, Kw = TV.TestGatherRenderer()._object(0, 128, tile)
    cand = np.broadcast_to(f, ((side // tile) ** 2,) + f.shape)
    args = (_t(vc).cuda(), _t(cand).cuda(), _t(Kw).cuda(),
            torch.tensor([5.0, -3.0]).cuda(), (side, side), tile)
    got = rd_t.render_depth_window_gather(*args)
    want = rd_t.render_depth_window_gather_reference(*args)
    stamp = rd_t.render_depth_window(args[0], _t(f).cuda(), *args[2:])
    torch.cuda.synchronize()
    assert float(want.max()) > 0
    assert torch.equal(got, want) and torch.equal(stamp, want)


def _vsd_batch_problem():
    """TestVSDBatch's problem (tests/test_torch_vsd.py): the square at
    five distances, estimates 2% of its diameter off."""
    verts, faces = J.square_mesh(half=0.1, z=0.0)
    R = np.eye(3, dtype=np.float32)
    diameter = float(0.2 * np.sqrt(2))
    rng = np.random.RandomState(0)
    poses, depths = [], []
    for z in [2.0, 2.0, 1.0, 4.0, 2.0]:
        t_gt = np.array([0, 0, z], np.float32)
        depths.append(TV._gt_depth(verts @ R.T + t_gt, faces))
        t_est = t_gt + rng.randn(3).astype(np.float32) * (0.02 * diameter)
        poses.append((R, t_est, R, t_gt))
    return poses, depths, K, verts, faces, diameter


def _hard_mesh_problem():
    """TestHardMesh's batch problem: the concave 20k-face trefoil at two
    distances, estimates 3 mm off."""
    from gdm_tpu_torch.data.synthetic import make_trefoil_mesh

    verts, faces = make_trefoil_mesh()
    diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    rng = np.random.RandomState(4)
    R = np.eye(3, dtype=np.float32)
    poses, depths = [], []
    for z in (0.45, 0.6):
        t_gt = np.array([0, 0, z], np.float32)
        depths.append(TV._gt_depth(verts + t_gt, faces))
        poses.append((R, t_gt + rng.randn(3).astype(np.float32) * 0.003,
                      R, t_gt))
    return poses, depths, K, verts, faces, diameter


@pytest.mark.parametrize("cost_type", ["step", "tlinear"])
@pytest.mark.parametrize("problem", ["vsd_batch", "hard_mesh"])
def test_vsd_err_batch_equals_jax(problem, cost_type):
    """vsd_err_batch on the CPU (the scatter renderer's plain version)
    against the JAX package's (host binning, its gather renderer)."""
    args = {"vsd_batch": _vsd_batch_problem,
            "hard_mesh": _hard_mesh_problem}[problem]()
    got = vsd_t.vsd_err_batch(*args, cost_type=cost_type, device="cpu")
    want = vsd_j.vsd_err_batch(*args, cost_type=cost_type)
    tol = 0.0 if cost_type == "step" else TLINEAR_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert 0 < got.max() <= 1
