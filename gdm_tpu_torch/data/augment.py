"""Host augmentation and depth fill of a crop, without cv2 (numpy).

Counterpart of gdm_tpu/data/augment.py, which calls OpenCV: the GPU host
has no cv2.  Each OpenCV call is reproduced as the JAX package's tests
run it (OpenCV 5.0 with its SIMD dispatch and IPP):

  * ``fill_depth_fast`` (ip_basic's fast fill, utils/ip_basic/ip_basic/
    depth_map_utils_ycb.py:67-130): the dilations and the closing take
    maxima and minima over the structuring element, out-of-image pixels
    never winning; the 5x5 median of float32 takes the 13th of the 25
    values, BORDER_REPLICATE.  These are bit-equal.  The bilateral filter
    follows OpenCV's own algorithm (the 13 taps of the 5x5 window with
    r <= 2, a 4096-bin colour table over the image's max - min,
    interpolated linearly, f32 sums, BORDER_REFLECT_101); cv2 runs
    Intel IPP's bilateral filter instead, which this does not reproduce
    bit for bit: the tests hold the fill within 4e-6 m.  The median and
    the bilateral loops, most of the fill's time in numpy, run in a host
    C++ helper (csrc/depth_fill.cpp).
  * ``rgb_add_noise`` (reference datasets/lm/linemod_pbr.py:269-333):
    BGR2HSV in OpenCV's fixed point (hsv_shift 12, its division tables),
    HSV2BGR as OpenCV's vector path computes it (float32, fused
    multiply-adds, truncation), filter2D on uint8 as a float32 sum of
    fused multiply-adds over the kernel's nonzero taps in raster order,
    rounded to even (BORDER_REFLECT_101), cv2.line's 8-connected
    Bresenham walk with its clipping, and GaussianBlur's bit-exact 8-bit
    fixed point (the error-diffused 1/256 kernel, rounded >> 16).  All
    bit-equal, except filter2D with a kernel of >= 130 taps (a motion
    blur of side >= 12), which OpenCV computes by DFT: there the port's
    direct sum differs by one grey level on a few percent of pixels.
  * ``add_real_background`` (datasets/ycbv/ycbv_pbr.py:352-387), numpy
    already, reading the real frame through data/imio.

Every random draw comes from the caller's RandomState, in the JAX
package's order, so that the two packages' train streams stay in step.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from gdm_tpu_torch.data.crop import _fma
from gdm_tpu_torch.data.imio import imread_mask, imread_rgb, imread_u16

_F32 = np.float32


# -- morphology, median and bilateral filter of a float32 plane ------------

def _window_reduce(img, offsets, fill, op):
    """op over the shifted copies of ``img`` by (dy, dx) ``offsets``, the
    outside of the image reading ``fill``."""
    h, w = img.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    p = np.pad(img, r, constant_values=fill)
    out = None
    for dy, dx in offsets:
        v = p[r + dy:r + dy + h, r + dx:r + dx + w]
        out = v.copy() if out is None else op(out, v, out=out)
    return out


def _square(n):
    r = n // 2
    return [(i, j) for i in range(-r, r + 1) for j in range(-r, r + 1)]


def _cross(n):
    return [(i, j) for i, j in _square(n) if i == 0 or j == 0]


def dilate(img, offsets):
    """cv2.dilate with the structuring element of ``offsets``."""
    return _window_reduce(img, offsets, -np.inf, np.maximum)


def erode(img, offsets):
    """cv2.erode with the structuring element of ``offsets``."""
    return _window_reduce(img, offsets, np.inf, np.minimum)


def _lib():
    from gdm_tpu_torch import _build

    lib = _build.load("depth_fill")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdm_median5.argtypes = [p, p, i, i]
    lib.gdm_median5.restype = i
    lib.gdm_bilateral.argtypes = [p, p, i, i, i, p, p, p, i, p, i,
                                  ctypes.c_float]
    lib.gdm_bilateral.restype = i
    return lib


def _plane(img) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2 or img.size == 0:
        raise ValueError(f"want a non-empty [h, w] plane, got {img.shape}")
    return img


def median_blur5(img):
    """cv2.medianBlur(img, 5) of a float32 plane (BORDER_REPLICATE): the
    13th of the 25 window values (csrc/depth_fill.cpp)."""
    img = _plane(img)
    pad = np.pad(img, 2, mode="edge")
    out = np.empty_like(img)
    _lib().gdm_median5(pad.ctypes.data, out.ctypes.data, *img.shape)
    return out


def bilateral_filter(img, d=5, sigma_color=1.5, sigma_space=2.0):
    """OpenCV's bilateralFilter algorithm for a float32 plane: the taps of
    the d x d window within radius d // 2, their space weights, and a
    4096-bin colour table over the image's max - min, interpolated
    linearly (csrc/depth_fill.cpp runs the loop)."""
    img = _plane(img)
    lo, hi = float(img.min()), float(img.max())
    if abs(lo - hi) < np.finfo(np.float32).eps:
        return img.copy()
    radius = max(d // 2, 1)
    n_bins = 1 << 12
    scale_index = _F32(n_bins) / _F32(hi - lo)
    val = (np.arange(n_bins + 2, dtype=_F32) / scale_index).astype(
        np.float64)
    lut = np.exp(val * val * (-0.5 / (sigma_color * sigma_color))).astype(
        _F32)
    taps = [(i, j, math.sqrt(float(i * i + j * j)))
            for i, j in _square(2 * radius + 1)]
    taps = [(i, j, r) for i, j, r in taps if r <= radius]
    dy = np.array([t[0] for t in taps], np.int32)
    dx = np.array([t[1] for t in taps], np.int32)
    space_w = np.array([math.exp(r * r * (-0.5 / (sigma_space
                                                   * sigma_space)))
                        for _, _, r in taps], _F32)
    pad = np.pad(img, radius, mode="reflect")
    out = np.empty_like(img)
    rc = _lib().gdm_bilateral(pad.ctypes.data, out.ctypes.data, *img.shape,
                              radius, dy.ctypes.data, dx.ctypes.data,
                              space_w.ctypes.data, len(taps), lut.ctypes.data,
                              len(lut), float(scale_index))
    if rc:
        raise RuntimeError("bilateral filter: colour index beyond its table")
    return out


def fill_depth_fast(dpt_m: np.ndarray, max_depth: float = 3.0,
                    blur: bool = True) -> np.ndarray:
    """Morphological depth completion of a crop (metres in, metres out),
    as gdm_tpu.data.augment.fill_depth_fast."""
    d = dpt_m.astype(np.float32)
    valid = d > 0.1
    d[valid] = max_depth - d[valid]                       # invert
    d = dilate(d, _cross(5))
    d = erode(dilate(d, _square(5)), _square(5))          # MORPH_CLOSE
    empty = d < 0.1
    d[empty] = dilate(d, _square(7))[empty]
    if blur:
        valid = d > 0.1
        d[valid] = median_blur5(d)[valid]
        d[valid] = bilateral_filter(d)[valid]
    valid = d > 0.1
    d[valid] = max_depth - d[valid]                       # un-invert
    return d


# -- the photometric primitives on uint8 images -----------------------------

_SDIV = np.zeros(256, np.int64)          # cvtColor's hsv_shift-12 tables
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << 12) / np.arange(1.0, 256.0))
_HDIV[1:] = np.rint((180 << 12) / (6.0 * np.arange(1.0, 256.0)))
# per sector, the table entries of b, g, r (OpenCV's sector_data)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of uint8 [h, w, 3] (H in
    [0, 180))."""
    b, g, r = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) of uint8 [h, w, 3], as OpenCV's
    vector path computes it."""
    inv255 = _F32(1.0) / _F32(255.0)
    h = img[..., 0].astype(_F32) * (_F32(6.0) / _F32(180.0))
    s = img[..., 1].astype(_F32) * inv255
    v = img[..., 2].astype(_F32) * inv255
    sector = np.trunc(h)
    h -= sector
    one = np.ones_like(h)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    sector -= np.trunc(sector * _F32(1.0 / 6.0)) * _F32(6.0)
    out = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64)], -1)
    return np.clip(np.trunc(out * _F32(255.0)), 0, 255).astype(np.uint8)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of uint8 [h, w, c]: correlation with
    the anchor at the kernel's centre, BORDER_REFLECT_101."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    p = np.pad(img, ((ay, kh - 1 - ay), (ax, kw - 1 - ax), (0, 0)),
               mode="reflect").astype(_F32)
    k = kernel.astype(_F32)
    acc = np.zeros(img.shape, _F32)
    for i, j in zip(*np.nonzero(k)):
        acc = _fma(p[i:i + h, j:j + w], k[i, j], acc)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's clipLine to [0, w-1] x [0, h-1]: (inside, x1, y1, x2,
    y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def draw_line(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color): thickness 1, 8-connected, both
    ends drawn; the line is walked left to right."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = pt1, pt2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return img
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        diag = err < 0
        err += -2 * dy + (2 * dx if diag else 0)
        if steep:
            y += step_y
            x += diag
        else:
            x += 1
            y += step_y * diag
    return img


def gaussian_kernel_q8(n: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact 8-bit Gaussian kernel of odd size ``n``, in
    units of 1/256: the normalised float64 kernel, error-diffused to
    integers from the ends inwards, the centre taking what sums to
    256."""
    if sigma <= 0 and n in (3, 5):
        k = [0.25, 0.5, 0.25] if n == 3 else [0.0625, 0.25, 0.375, 0.25,
                                               0.0625]
    else:
        sig = sigma if sigma > 0 else n * 0.15 + 0.35
        scale2 = -0.125 / (sig * sig)
        half = [math.exp(float((1 - n + 2 * i) ** 2) * scale2)
                for i in range((n - 1) // 2)]
        mul = 1.0 / (sum(half) * 2.0 + 1.0)
        k = [v * mul for v in half] + [mul]
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(n // 2):
        adj = k[i] * 256.0 + err
        out[i] = out[n - 1 - i] = int(np.rint(adj))
        err = adj - out[i]
    out[n // 2] = 256 - 2 * out[:n // 2].sum()
    return out


def gaussian_blur(img: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (n, n), sigma) of uint8 [h, w, c]: rows,
    then columns, in integers (BORDER_REFLECT_101)."""
    k = gaussian_kernel_q8(n, sigma)
    r = n // 2
    h, w = img.shape[:2]
    p = np.pad(img.astype(np.int64), ((0, 0), (r, r), (0, 0)),
               mode="reflect")
    rows = sum(k[j] * p[:, j:j + w] for j in range(n))
    p = np.pad(rows, ((r, r), (0, 0), (0, 0)), mode="reflect")
    cols = sum(k[i] * p[i:i + h] for i in range(n))
    return np.minimum((cols + (1 << 15)) >> 16, 255).astype(np.uint8)


# -- the reference's augmentation chain --------------------------------------

def _rand_range(rng, lo, hi):
    return rng.rand() * (hi - lo) + lo


def _gaussian_noise(rng, img, sigma):
    return np.clip(
        img + rng.randn(*img.shape) * sigma, 0, 255).astype(np.uint8)


def linear_motion_blur(img, angle_deg, length):
    rad = np.deg2rad(angle_deg)
    dx, dy = np.cos(rad), np.sin(rad)
    a = int(max(abs(dx), abs(dy)) * length * 2)
    if a <= 0:
        return img
    kern = np.zeros((a, a))
    c = a // 2
    draw_line(kern, (c, c), (int(dx * length + c), int(dy * length + c)),
              1.0)
    s = kern.sum()
    if s == 0:
        kern[c, c] = 1.0
    else:
        kern /= s
    return filter2d(img, kern)


def rgb_add_noise(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The reference's photometric chain on a uint8 [h, w, 3] image (fed
    as BGR, as the reference does; probabilities per linemod_pbr.py
    :297-333)."""
    hsv = bgr2hsv(img).astype(np.uint16)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * _rand_range(rng, 1.25, 1.45),
                           0, 255)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] * _rand_range(rng, 1.15, 1.35),
                           0, 255)
    img = hsv2bgr(hsv.astype(np.uint8))

    if rng.rand() > 0.8:  # sharpen
        kernel = -np.ones((3, 3))
        kernel[1, 1] = rng.rand() * 3 + 9
        kernel /= kernel.sum()
        img = filter2d(img, kernel)

    if rng.rand() > 0.8:  # motion blur
        img = linear_motion_blur(
            img, int(rng.rand() * 360), int(rng.rand() * 15) + 1)

    if rng.rand() > 0.8:
        k = 3 if rng.rand() > 0.2 else 5
        img = gaussian_blur(img, k, rng.rand())

    sigma = rng.randint(15) if rng.rand() > 0.2 else rng.randint(25)
    img = _gaussian_noise(rng, img, sigma)

    if rng.rand() > 0.8:
        img = img + rng.normal(0.0, 7.0, img.shape)

    return np.clip(img, 0, 255).astype(np.uint8)


def add_real_background(rgb, labels, dpt, dpt_msk, real_records, rng,
                        in_size, im_hw=(480, 640)):
    """Paste a random real frame's RGB-D window behind the object
    (ycbv_pbr.py:352-387), as gdm_tpu.data.augment.add_real_background:
    the real depth is read as millimetres whatever its record's
    depth_factor.

    Args:
      rgb: [S, S, 3] uint8 synthetic crop.
      labels: [S, S] object mask of the crop (> 0 = foreground).
      dpt: [S, S] float metres.
      dpt_msk: [S, S] valid-depth mask.
      real_records: bop.Record list of real RGB-D frames.

    Returns (rgb, dpt) with the background pixels replaced.
    """
    im_h, im_w = im_hw
    rnd_h = rng.randint(0, im_h - in_size - 1)
    rnd_w = rng.randint(0, im_w - in_size - 1)
    rec = real_records[rng.randint(0, len(real_records))]

    real_dpt = imread_u16(rec.depth_file) / 1000.0
    bk_label = imread_mask(rec.mask_file)
    bk_rgb = imread_rgb(rec.rgb_file)

    sl = np.s_[rnd_h:rnd_h + in_size, rnd_w:rnd_w + in_size]
    bk_clip = (bk_label[sl] < 255).astype(rgb.dtype)
    back = bk_rgb[sl] * bk_clip[:, :, None]
    dpt_back = real_dpt[sl].astype(np.float32) * bk_clip.astype(np.float32)

    msk_back = (labels <= 0).astype(rgb.dtype)[:, :, None]
    rgb = rgb * (msk_back == 0).astype(rgb.dtype) + back * msk_back
    dpt = dpt * (dpt_msk > 0).astype(dpt.dtype) + \
        dpt_back * (dpt_msk <= 0).astype(dpt.dtype)
    return rgb, dpt
