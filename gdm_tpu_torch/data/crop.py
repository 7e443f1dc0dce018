"""CenterNet-style affine crop (host side, numpy).

Counterpart of gdm_tpu/data/crop.py (reference utils/dataset_utils.py
:108-187), which calls cv2.getAffineTransform and cv2.warpAffine; the
GPU host has no cv2.  For rot=0 and a square scale, the only way the
pipeline calls it (linemod_pbr.py:468-473), the transform maps the square
window [center - s/2, center + s/2] onto the output crop.

:func:`warp_affine` reproduces cv2.warpAffine (OpenCV >= 4.11, the
version the JAX package's tests run) for ``INTER_NEAREST`` and
``INTER_LINEAR`` with a constant 0 border.  OpenCV inverts the 2x3
matrix in double, casts it to float32 and walks the destination in
float32; the row term is a product and a sum, the column step a fused
multiply-add:

    sx = fma(x, M0, y*M1 + M2),  sy = fma(x, M3, y*M4 + M5)

Nearest takes the source pixel at (rint(sx), rint(sy)), ties to even.
Linear takes the four neighbours of (floor(sx), floor(sy)), out-of-image
neighbours reading 0, and lerps them in float32 with fused multiply-adds
(x first, then y), rounding to even.  The older fixed-point scheme
(AB_BITS=10, INTER_BITS=5) differs from it on about a third of the
linear pixels, by up to 7 levels.  numpy has no fma: each one is taken in
float64, where the product of two float32 values is exact, and rounded
once to float32.  The tests hold both modes bit-equal to cv2.
"""

from __future__ import annotations

import numpy as np

INTER_NEAREST = 0       # cv2's flag values
INTER_LINEAR = 1

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (exact for float32 inputs
    whose product and sum span fewer than 53 bits)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """The [2, 3] float64 affine map of the crop window onto the output
    (``inv``: the other way), solved from three point pairs as
    cv2.getAffineTransform solves them (bit-equal)."""
    center = np.asarray(center, np.float32)
    if np.isscalar(scale):
        scale = np.array([scale, scale], np.float32)
    else:
        scale = np.asarray(scale, np.float32)
    if np.isscalar(output_size):
        output_size = (output_size, output_size)
    shift = np.asarray(shift, np.float32)

    src_w = scale[0]
    dst_w, dst_h = output_size
    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    src_dir = np.array([0 * cs - (-0.5 * src_w) * sn,
                        0 * sn + (-0.5 * src_w) * cs], np.float32)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = third(src[0], src[1])
    dst[2] = third(dst[0], dst[1])
    if inv:
        src, dst = dst, src
    # the 6x6 system of cv2.getAffineTransform, in float64
    a = np.zeros((6, 6))
    a[0::2, 0:2] = src
    a[0::2, 2] = 1.0
    a[1::2, 3:5] = src
    a[1::2, 5] = 1.0
    return _lu_solve(a, dst.astype(np.float64).ravel()).reshape(2, 3)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x with a @ x = b, by OpenCV's LU (cv::solve, DECOMP_LU): Gaussian
    elimination with partial pivoting, in the same order of float64
    operations, so the result is bit-equal to cv2's.  (LAPACK's solve
    differs in the last bits, and the warp casts the matrix to float32,
    where such a bit can move a pixel.)"""
    a = [[float(v) for v in row] for row in a]
    b = [float(v) for v in b]
    m = len(b)
    for i in range(m):
        k = max(range(i, m), key=lambda j: abs(a[j][i]))
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            raise ValueError("degenerate crop window: singular transform")
        a[i], a[k] = a[k], a[i]
        b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b)


def _inverse_map(m: np.ndarray) -> np.ndarray:
    """Destination->source map of a [2, 3] source->destination affine,
    inverted in float64 as cv2.warpAffine inverts it, then cast to
    float32 as its float kernels read it."""
    m = np.asarray(m, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    a12, a21 = -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([a11, a12, b1, a21, a22, b2]).astype(_F32)


def _pixel_words(img: np.ndarray, p: int):
    """``img`` with a border of ``p`` zero pixels, flattened to one
    unsigned word per pixel (3-byte RGB padded to 4 bytes), and the
    function that turns gathered words back into pixels.  numpy gathers
    a 1-D array of words several times faster than rows of channels."""
    h, w = img.shape[:2]
    nbytes = img[0, 0].nbytes
    wb = next(s for s in (1, 2, 4, 8) if s >= nbytes)
    buf = np.zeros((h + 2 * p, w + 2 * p, wb), np.uint8)
    buf[p:p + h, p:p + w, :nbytes] = np.ascontiguousarray(img).view(
        np.uint8).reshape(h, w, nbytes)
    words = buf.view(f"<u{wb}").reshape(-1)

    def unpack(g):
        b = g[..., None].view(np.uint8)[..., :nbytes]
        return np.ascontiguousarray(b).view(img.dtype).reshape(
            g.shape + img.shape[2:])

    return words, unpack


def warp_affine(img: np.ndarray, m: np.ndarray, dsize,
                interpolation: int = INTER_LINEAR) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, flags=interpolation) with a constant
    0 border.  ``img`` [H, W] or [H, W, C]; ``dsize`` (width, height).
    Nearest takes uint8 or uint16, linear uint8."""
    img = np.asarray(img)
    if interpolation not in (INTER_NEAREST, INTER_LINEAR):
        raise ValueError(f"interpolation {interpolation}: nearest or "
                         "linear only")
    if img.dtype not in (np.uint8, np.uint16) or (
            interpolation == INTER_LINEAR and img.dtype != np.uint8):
        raise TypeError(f"warp_affine: {img.dtype} with interpolation "
                        f"{interpolation} is not supported")
    out_w, out_h = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    mi = _inverse_map(m)
    x = np.arange(out_w, dtype=_F32)[None, :]
    y = np.arange(out_h, dtype=_F32)[:, None]
    sx = _fma(x, mi[0], y * mi[1] + mi[2])
    sy = _fma(x, mi[3], y * mi[4] + mi[5])

    # a border of p zeros around the frame, and every tap index clipped
    # into it: a tap outside the image reads 0 without a mask.  Linear
    # reads (ix + 1, iy + 1) too, so its border is 2 wide.
    p = 1 if interpolation == INTER_NEAREST else 2
    pw = w + 2 * p
    words, unpack = _pixel_words(img, p)

    def base(i, n):
        """Padded index of integer source coordinate ``i``."""
        return np.clip(i + p, 0, n + p).astype(np.intp)

    if interpolation == INTER_NEAREST:
        return unpack(words[base(np.rint(sy), h) * pw + base(np.rint(sx), w)])
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = sx - fx, sy - fy                 # exact in float32
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    i00 = base(fy, h) * pw + base(fx, w)

    def tap(i):
        return unpack(words[i]).astype(np.float64)

    # the x lerps as _fma does them, with the taps widened only once
    p00, p10, ax = tap(i00), tap(i00 + pw), ax.astype(np.float64)
    v0 = (ax * (tap(i00 + 1) - p00) + p00).astype(_F32)
    v1 = (ax * (tap(i00 + pw + 1) - p10) + p10).astype(_F32)
    v = _fma(ay, v1 - v0, v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def crop_resize_by_warp_affine(img, center, scale, output_size, rot=0,
                               interpolation=INTER_LINEAR):
    if np.isscalar(output_size):
        output_size = (output_size, output_size)
    trans = get_affine_transform(center, scale, rot, output_size)
    return warp_affine(img, trans,
                       (int(output_size[0]), int(output_size[1])),
                       interpolation)


def crop_affine_matrix(center, scale, output_size) -> np.ndarray:
    """The rot=0 crop transform as a 3x3 homogeneous matrix, suitable for
    adjusting camera intrinsics: K_crop = crop_affine_matrix(...) @ K."""
    A = np.eye(3, dtype=np.float32)
    A[:2] = get_affine_transform(center, scale, 0, output_size)
    return A
