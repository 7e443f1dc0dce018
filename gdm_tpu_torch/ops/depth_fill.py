"""Morphological depth hole-filling (ip_basic) on tensors.

Counterpart of gdm_tpu/ops/depth_fill.py: ``fill_in_fast`` and
``fill_in_multiscale`` on an [H, W] depth tensor, on the device of their
input.  Dilation and erosion are the max / min of shifted copies of an
infinity-padded map, the median blur a sort of the 25 shifted copies of
a replicate-padded map, and the bilateral filter an explicit 5x5 gated
sum over a reflect-101 padded map, in the JAX module's tap order.  The
thresholds, kernels, step order and depth bins are the JAX module's.

The loader's host fill (``data/augment.fill_depth_fast``, C++) is the
cv2-equal one that YCB-V frames go through; this module is the device
form that ``gdm_tpu.ops`` exports.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FULL_KERNEL_5 = np.ones((5, 5), np.uint8)
FULL_KERNEL_7 = np.ones((7, 7), np.uint8)
FULL_KERNEL_9 = np.ones((9, 9), np.uint8)
CROSS_KERNEL_3 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
CROSS_KERNEL_5 = np.array(
    [[0, 0, 1, 0, 0]] * 2 + [[1] * 5] + [[0, 0, 1, 0, 0]] * 2, np.uint8)
CROSS_KERNEL_7 = np.array(
    [[0, 0, 0, 1, 0, 0, 0]] * 3 + [[1] * 7] + [[0, 0, 0, 1, 0, 0, 0]] * 3,
    np.uint8)
DIAMOND_KERNEL_5 = np.array(
    [[0, 0, 1, 0, 0], [0, 1, 1, 1, 0], [1, 1, 1, 1, 1],
     [0, 1, 1, 1, 0], [0, 0, 1, 0, 0]], np.uint8)


def _taps(img: torch.Tensor, radius: int, mode: str, fill: float = 0.0):
    """Yield (dy, dx, window) for every offset of a (2r+1)^2 square, in
    row-major order: ``window[y, x] = img[y + dy, x + dx]`` with the
    border given by ``mode`` ("constant" at ``fill``, "replicate" or
    "reflect", which is reflect-101)."""
    h, w = img.shape
    kw = {"value": fill} if mode == "constant" else {}
    pad = F.pad(img[None, None], (radius,) * 4, mode=mode, **kw)[0, 0]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yield dy, dx, pad[radius + dy:radius + dy + h,
                              radius + dx:radius + dx + w]


def _morph(img: torch.Tensor, kernel: np.ndarray, dilate: bool):
    r = kernel.shape[0] // 2
    keep = {(int(y) - r, int(x) - r) for y, x in zip(*np.nonzero(kernel))}
    fill = -math.inf if dilate else math.inf
    parts = [win for dy, dx, win in _taps(img, r, "constant", fill)
             if (dy, dx) in keep]
    stack = torch.stack(parts)
    return stack.amax(0) if dilate else stack.amin(0)


def _dilate(img, kernel):
    """Grayscale dilation (cv2.dilate): every kernel holds its centre, so
    the -inf border never reaches the output."""
    return _morph(img, kernel, True)


def _erode(img, kernel):
    return _morph(img, kernel, False)


def _close(img, kernel):
    return _erode(_dilate(img, kernel), kernel)


def _median5(img: torch.Tensor) -> torch.Tensor:
    """5x5 median (cv2.medianBlur(k=5)), border replicated."""
    stack = torch.stack([w for _, _, w in _taps(img, 2, "replicate")], -1)
    return torch.sort(stack, dim=-1).values[..., 12]


def _bilateral5(img: torch.Tensor, sigma_color: float,
                sigma_space: float) -> torch.Tensor:
    """5x5 bilateral filter (cv2.bilateralFilter(d=5)), reflect-101
    border; the weights and sums in the JAX module's order and dtypes."""
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    inv2sc = 1.0 / (2.0 * sigma_color * sigma_color)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    for dy, dx, nb in _taps(img, 2, "reflect"):
        w_space = float(np.float32(np.exp(-(dy * dy + dx * dx) * inv2ss)))
        w = w_space * torch.exp(-torch.square(nb - img) * inv2sc)
        num = num + w * nb
        den = den + w
    return num / torch.clamp_min(den, 1e-12)


def fill_in_fast(depth: torch.Tensor, max_depth: float = 100.0,
                 blur_type: str = "bilateral") -> torch.Tensor:
    """ip_basic fill_in_fast, no extrapolation: [H, W] depth -> filled
    [H, W] float32."""
    if blur_type != "bilateral":
        raise NotImplementedError(blur_type)
    depth = depth.to(torch.float32)
    valid = depth > 0.1
    d = torch.where(valid, max_depth - depth, depth)
    d = torch.clamp_min(_dilate(d, DIAMOND_KERNEL_5), 0.0)
    d = torch.clamp_min(_close(d, FULL_KERNEL_5), 0.0)
    dil = torch.clamp_min(_dilate(d, FULL_KERNEL_7), 0.0)
    d = torch.where(d < 0.1, dil, d)
    d = _median5(d)
    d = _bilateral5(d, 1.5, 2.0)
    return torch.where(d > 0.1, max_depth - d, d)


def _first_valid(mask: torch.Tensor) -> torch.Tensor:
    """[1, W] row of each column's first True (0 for a column with
    none), as jnp.argmax of a bool column."""
    return torch.argmax(mask.to(torch.uint8), dim=0)[None, :]


def fill_in_multiscale(depth: torch.Tensor, max_depth: float = 3.0,
                       blur_type: str = "bilateral") -> torch.Tensor:
    """ip_basic fill_in_multiscale, no extrapolation: depth bins near
    (<= 1 m), medium (1-2 m) and far (> 2 m); ``blur_type`` "bilateral"
    or "gaussian" (any other value skips the blur, as in JAX)."""
    d_in = depth.to(torch.float32)
    near = (d_in > 0.01) & (d_in <= 1.0)
    med = (d_in > 1.0) & (d_in <= 2.0)
    far = d_in > 2.0

    s1 = torch.where(d_in > 0.01, max_depth - d_in, d_in)

    dil_far = torch.clamp_min(_dilate(s1 * far, CROSS_KERNEL_3), 0.0)
    dil_med = torch.clamp_min(_dilate(s1 * med, CROSS_KERNEL_5), 0.0)
    dil_near = torch.clamp_min(_dilate(s1 * near, CROSS_KERNEL_7), 0.0)

    s2 = s1
    s2 = torch.where(dil_far > 0.01, dil_far, s2)
    s2 = torch.where(dil_med > 0.01, dil_med, s2)
    s2 = torch.where(dil_near > 0.01, dil_near, s2)

    s3 = torch.clamp_min(_close(s2, FULL_KERNEL_5), 0.0)
    s4 = torch.where(s3 > 0.01, _median5(s3), s3)

    # pixels above the first valid pixel of their column stay as they are
    row = torch.arange(s4.shape[0], device=s4.device)[:, None]
    top_mask = row >= _first_valid(s4 > 0.01)
    empty = (~(s4 > 0.01)) & top_mask
    s5 = torch.where(empty, torch.clamp_min(_dilate(s4, FULL_KERNEL_9), 0.0),
                     s4)

    top_mask = row >= _first_valid(s5 > 0.01)

    s7 = s5
    for _ in range(6):
        empty = (s7 < 0.01) & top_mask
        s7 = torch.where(empty,
                         torch.clamp_min(_dilate(s7, FULL_KERNEL_5), 0.0), s7)

    valid = (s7 > 0.01) & top_mask
    s7 = torch.where(valid, _median5(s7), s7)
    if blur_type == "bilateral":
        s7 = torch.where(valid, _bilateral5(s7, 0.5, 2.0), s7)
    elif blur_type == "gaussian":
        g = _bilateral5(s7, 1e9, 1.1)   # ~gaussian as colour sigma -> inf
        s7 = torch.where((s7 > 0.01) & top_mask, g, s7)

    return torch.where(s7 > 0.01, max_depth - s7, s7)
