"""The port's in-memory synthetic training batches (data/synthetic.py
``render_sample`` and ``make_batch``) against gdm_tpu/data/synthetic.py:
bit for bit, every key and dtype, over seeds, crop sizes, point counts
(the wrap-pad branch included) and HPR visibility exponents."""

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU platform)
from gdm_tpu.data import synthetic as synth_j
from gdm_tpu_torch.data import synthetic as synth_t


def _intrinsics(im):
    return np.array([[280.0, 0, im / 2], [0, 280.0, im / 2], [0, 0, 1]],
                    np.float32)


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("seed,im,n_sample,n_mesh,hpr", [
    (0, 64, 256, 64, 2.0),
    (1, 48, 512, 128, np.pi),
    (7, 96, 1024, 256, 2.0),
    (3, 16, 300, 64, 3.0),       # 256 pixels < 300 points: wrap-pad
])
def test_make_batch_is_bit_equal_to_jax(seed, im, n_sample, n_mesh, hpr):
    mesh = synth_t.make_object(n_mesh, np.random.RandomState(seed),
                               radius=0.06)
    np.testing.assert_array_equal(
        mesh, synth_j.make_object(n_mesh, np.random.RandomState(seed),
                                  radius=0.06))
    kw = dict(batch=3, K=_intrinsics(im), im_size=im, n_sample=n_sample,
              seed=seed, hpr_radius_param=hpr)
    got, poses = synth_t.make_batch(mesh, **kw)
    want, poses_j = synth_j.make_batch(mesh, **kw)
    _equal(got, want)
    np.testing.assert_array_equal(poses, poses_j)
    assert "valid" not in got
    assert got["cld_rgb_nrm"].shape == (3, n_sample, 9)
    # some foreground points found their GT vertex
    assert (got["match_idx"] < n_mesh).any()


@pytest.mark.parametrize("splat,nn_dist_th,dense", [
    (2, 0.01, False), (3, 0.005, True)])
def test_render_sample_is_bit_equal_to_jax(splat, nn_dist_th, dense):
    """One frame with the caller's RandomState (its draws advance alike),
    the mesh points or a dense set on the same surface splatted, other
    splat sizes and match radii; ``valid`` kept."""
    from scipy.spatial.transform import Rotation

    mesh = synth_t.make_object(128, np.random.RandomState(2), radius=0.06)
    pose = np.hstack([Rotation.random(random_state=5).as_matrix(),
                      [[0.01], [-0.02], [0.42]]]).astype(np.float32)
    render = synth_t.make_object(2048, np.random.RandomState(9),
                                 radius=0.06) if dense else None
    out = []
    for mod in (synth_t, synth_j):
        rng = np.random.RandomState(11)
        s = mod.render_sample(mesh, pose, _intrinsics(64), 64, 512, rng=rng,
                              nn_dist_th=nn_dist_th, splat=splat,
                              render_pts=render)
        out.append((s, rng.randint(1 << 30)))
    _equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert out[0][0]["valid"]
