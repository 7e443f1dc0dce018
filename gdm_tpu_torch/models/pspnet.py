"""PSPNet pieces of the FFB6D CNN branch (eval forward), NCHW.

Counterpart of gdm_tpu/models/pspnet.py.  Bilinear resizes use
align_corners=True and adaptive average pooling uses torch's uneven bins;
both run as two small matrix products with the same matrices the JAX
package builds.  ``final`` is a 1x1 conv followed by a channel
log-softmax.

Under a compute dtype (models/layers.py) the convolutions cast to it, the
resize matrices take the map's dtype and PReLU's slope is cast to it, as
in the JAX package; its pooling matrices are f32 there, so a bf16 map is
pooled in f32 and the next conv narrows the result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from gdm_tpu_torch.models.layers import BatchNorm, log_softmax
from gdm_tpu_torch.models.resnet import Conv


@functools.lru_cache(maxsize=None)
def _interp_matrix_ac(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix, align_corners=True."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        m[i, lo] += 1.0 - f
        m[i, hi] += f
    return m


@functools.lru_cache(maxsize=None)
def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] averaging matrix of torch AdaptiveAvgPool bins."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def _apply_hw(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray):
    """[oh, h] and [ow, w] matrices applied to the H and W axes of NCHW."""
    mh = torch.as_tensor(mh, device=x.device, dtype=x.dtype)
    mw = torch.as_tensor(mw, device=x.device, dtype=x.dtype)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def resize_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    h, w = x.shape[2:]
    return _apply_hw(x, _interp_matrix_ac(h, out_hw[0]),
                     _interp_matrix_ac(w, out_hw[1]))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """In f32 at least (gdm_tpu/models/pspnet.py builds f32 matrices)."""
    h, w = x.shape[2:]
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return _apply_hw(x, _adaptive_pool_matrix(h, out_hw[0]),
                     _adaptive_pool_matrix(w, out_hw[1]))


class AdaptivePool(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        return adaptive_avg_pool(x, (self.size, self.size))


class Upsample2x(nn.Module):
    def forward(self, x):
        h, w = x.shape[2:]
        return resize_bilinear_ac(x, (2 * h, 2 * w))


class PReLU(nn.Module):
    """torch nn.PReLU(): one learned slope (``weight`` [1]), init 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return (torch.clamp_min(x, 0)
                + self.weight.to(x.dtype) * torch.clamp_max(x, 0))


class ChannelLogSoftmax(nn.Module):
    def forward(self, x):
        return log_softmax(x, 1)


class PSPModule(nn.Module):
    """Pyramid pooling head: ``stages.{i}`` = (pool, 1x1 conv) for sizes
    (1, 2, 3, 6), then ``bottleneck`` over [priors..., x] and ReLU."""

    def __init__(self, c_in: int = 512, out_features: int = 1024,
                 sizes=(1, 2, 3, 6), dtype: torch.dtype | None = None):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(AdaptivePool(s),
                          Conv(c_in, c_in, 1, bias=False, dtype=dtype))
            for s in sizes)
        self.bottleneck = Conv(c_in * (len(sizes) + 1), out_features, 1,
                               dtype=dtype)

    def forward(self, x):
        h, w = x.shape[2:]
        priors = [resize_bilinear_ac(stage(x), (h, w))
                  for stage in self.stages]
        return torch.relu(self.bottleneck(torch.cat(priors + [x], dim=1)))


class PSPUpsample(nn.Module):
    """x2 bilinear upsample + 3x3 conv + BN + PReLU, held as the
    reference's ``conv`` Sequential (children 0..3)."""

    def __init__(self, c_in: int, c_out: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = nn.Sequential(
            Upsample2x(), Conv(c_in, c_out, 3, 1, 1, dtype=dtype),
            BatchNorm(c_out, channel_dim=1, dtype=dtype), PReLU())

    def forward(self, x):
        return self.conv(x)


def final_layer(dtype: torch.dtype | None = None) -> nn.Sequential:
    """``cnn.final``: Conv2d(64, 64, 1) + channel log-softmax."""
    return nn.Sequential(Conv(64, 64, 1, dtype=dtype), ChannelLogSoftmax())
