"""gdm_tpu_torch/ops/depth_fill.py against gdm_tpu/ops/depth_fill.py on
seeded depth maps: dilation, erosion, closing and the 5x5 median are
bit-equal (max, min and sort of the same f32 values); the bilateral
filter and the two fills agree within 1e-5 relative (measured: <= 4e-6;
the exponentials and XLA's fused multiply-adds round in other places).
The fills run at the JAX module's defaults and at other depth ranges,
with both blur types of fill_in_multiscale, and on a batch-free
[H, W] map as JAX's take."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gdm_tpu.ops import depth_fill as J
from gdm_tpu_torch.ops import depth_fill as T

torch.set_num_threads(1)
RTOL = 1e-5


def scene(h, w, scale, seed, hole_frac=0.35):
    """A smooth depth surface with random dropouts, a square hole and an
    empty band at the top (the fills' column top mask)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    d = (0.6 + 0.3 * np.sin(xx / 9.0) + 0.2 * np.cos(yy / 7.0)) * scale
    d += rng.rand(h, w) * 0.05 * scale
    d[rng.rand(h, w) < hole_frac] = 0
    d[h // 3:h // 2, w // 4:w // 2] = 0
    d[:h // 6] = 0
    return d.astype(np.float32)


def both(fn_name, d, *args, **kw):
    """The JAX fill (a jitted function) and the port's on d."""
    want = np.asarray(getattr(J, fn_name)(jnp.asarray(d), *args, **kw))
    got = getattr(T, fn_name)(torch.from_numpy(d), *args, **kw).numpy()
    assert got.dtype == want.dtype == np.float32
    return got, want


@pytest.mark.parametrize("kernel", ["FULL_KERNEL_9", "CROSS_KERNEL_7",
                                    "DIAMOND_KERNEL_5"])
@pytest.mark.parametrize("op", ["_dilate", "_erode", "_close"])
def test_morphology_bit_equal(op, kernel):
    d = scene(23, 31, 2.0, seed=len(kernel))
    k = getattr(J, kernel)
    np.testing.assert_array_equal(
        getattr(T, op)(torch.from_numpy(d), k).numpy(),
        jitted(getattr(J, op), k)(d))


def jitted(fn, *args):
    return lambda x: np.asarray(jax.jit(lambda y: fn(y, *args))(
        jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(5, 5), (23, 31), (48, 64)])
def test_median5_bit_equal(shape):
    d = scene(*shape, 3.0, seed=shape[0])
    np.testing.assert_array_equal(T._median5(torch.from_numpy(d)).numpy(),
                                  jitted(J._median5)(d))


@pytest.mark.parametrize("sigmas", [(1.5, 2.0), (0.5, 2.0), (1e9, 1.1)])
def test_bilateral5(sigmas):
    d = scene(48, 64, 2.5, seed=1, hole_frac=0.1)
    np.testing.assert_allclose(
        T._bilateral5(torch.from_numpy(d), *sigmas).numpy(),
        jitted(J._bilateral5, *sigmas)(d), rtol=RTOL, atol=0)


FAST_CASES = [((48, 64), md, sc, seed) for md, sc in ((100.0, 50.0),
                                                      (10.0, 2.0))
              for seed in (0, 1, 2)]


@pytest.mark.parametrize("shape,max_depth,scale,seed", FAST_CASES)
def test_fill_in_fast(shape, max_depth, scale, seed):
    d = scene(*shape, scale, seed)
    got, want = both("fill_in_fast", d, max_depth=max_depth)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


MULTI_CASES = [((48, 64), sc, blur, seed) for sc in (0.8, 2.5)
               for blur in ("bilateral", "gaussian") for seed in (0, 1)] + [
    ((96, 128), 2.5, "bilateral", 2)]


@pytest.mark.parametrize("shape,scale,blur_type,seed", MULTI_CASES)
def test_fill_in_multiscale(shape, scale, blur_type, seed):
    """Depths spread over the near, medium and far bins."""
    d = scene(*shape, scale, seed)
    got, want = both("fill_in_multiscale", d, blur_type=blur_type)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_fills_holes_and_refuses_unknown_blur():
    depth = np.full((64, 64), 1.5, np.float32)
    depth[20:28, 20:28] = 0.0
    filled = T.fill_in_multiscale(torch.from_numpy(depth)).numpy()
    assert np.all(filled[22:26, 22:26] > 0.5)
    with pytest.raises(NotImplementedError):
        T.fill_in_fast(torch.from_numpy(depth), blur_type="gaussian")
