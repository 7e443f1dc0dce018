"""The port's affine crop (gdm_tpu_torch/data/crop.py) against the JAX
package's cv2 crop, over seeded centres and scales, windows partly
outside the image included: nearest (uint8, uint16) and linear (uint8
RGB and gray) are bit-equal, and get_affine_transform is bit-equal to
cv2.getAffineTransform (the test allows 1e-12 relative)."""

import cv2
import numpy as np
import pytest

from gdm_tpu.data import crop as crop_j
from gdm_tpu_torch.data import crop as crop_t


def _windows(seed, n=60):
    """(center, scale, out size): random windows, half of them BOP-like
    (integer box corners, scale = 1.5 x box side, so exact .5 source
    coordinates occur), many reaching outside the 480x640 frame."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        if i % 2:
            x1, y1 = rng.randint(-40, 620), rng.randint(-40, 460)
            w, h = rng.randint(2, 300), rng.randint(2, 300)
            c = np.array([x1 + w / 2, y1 + h / 2], np.float32)
            s = float(min(max(w, h) * 1.5, 640))
        else:
            c = np.array([rng.uniform(-80, 720), rng.uniform(-80, 560)],
                         np.float32)
            s = float(rng.uniform(8, 800))
        yield c, s, int(rng.choice([64, 128, 256]))


def _frames(seed):
    rng = np.random.RandomState(seed)
    return {"rgb": rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
            "mask": rng.randint(0, 256, (480, 640)).astype(np.uint8),
            "depth": rng.randint(0, 65536, (480, 640)).astype(np.uint16)}


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_transform_matches_cv2(seed):
    for c, s, size in _windows(seed):
        for inv in (False, True):
            want = crop_j.get_affine_transform(c, s, 0, size, inv=inv)
            got = crop_t.get_affine_transform(c, s, 0, size, inv=inv)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(crop_t.crop_affine_matrix(c, s, size),
                                      crop_j.crop_affine_matrix(c, s, size))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("image,interp", [
    ("depth", "nearest"), ("mask", "nearest"), ("rgb", "nearest"),
    ("rgb", "linear"), ("mask", "linear")])
def test_crop_bit_equal_to_cv2(seed, image, interp):
    img = _frames(seed)[image]
    cv_flag = cv2.INTER_NEAREST if interp == "nearest" else cv2.INTER_LINEAR
    t_flag = (crop_t.INTER_NEAREST if interp == "nearest"
              else crop_t.INTER_LINEAR)
    for c, s, size in _windows(seed + 10, n=40):
        want = crop_j.crop_resize_by_warp_affine(img, c, s, size,
                                                 interpolation=cv_flag)
        got = crop_t.crop_resize_by_warp_affine(img, c, s, size,
                                                interpolation=t_flag)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_linear_16_bit_and_unknown_modes_raise():
    img = np.zeros((8, 8), np.uint16)
    m = crop_t.get_affine_transform(np.array([4, 4], np.float32), 4.0, 0, 4)
    with pytest.raises(TypeError):
        crop_t.warp_affine(img, m, (4, 4), crop_t.INTER_LINEAR)
    with pytest.raises(ValueError):
        crop_t.warp_affine(img, m, (4, 4), 2)
