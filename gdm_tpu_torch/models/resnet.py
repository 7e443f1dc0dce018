"""ResNet18 trunk (eval forward), NCHW internally.

Counterpart of gdm_tpu/models/resnet.py, which mirrors the reference's
extractors as executed: layers 3 and 4 run stride 1 and dilation 1, so
the feature stride is 8.  Every 3x3 conv pads (1, 1) explicitly, stride 2
included (XLA's SAME would pad (0, 1) there); the stem is a 7x7/2 conv
with pad 3 and a 3x3/2 max pool with pad 1.  ``dtype`` is the compute
dtype of models/layers.py: each conv casts its input and weights to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gdm_tpu_torch.models.layers import BatchNorm


class Conv(nn.Module):
    """A 2-D conv holding the torch names ``weight`` [out, in, k, k] and
    ``bias``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x):
        dt = self.dtype
        if dt is None:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding)
        # the bias is added to the rounded product, as XLA does
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding)
        return y if self.bias is None else \
            y + self.bias.to(dt).view(1, -1, 1, 1)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int,
                 use_downsample: bool, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv(c_in, planes, 3, stride, 1, bias=False,
                          dtype=dtype)
        self.bn1 = BatchNorm(planes, channel_dim=1, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(planes, channel_dim=1, dtype=dtype)
        self.downsample = nn.Sequential(
            Conv(c_in, planes, 1, stride, bias=False, dtype=dtype),
            BatchNorm(planes, channel_dim=1, dtype=dtype)) \
            if use_downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Stem(nn.Sequential):
    """``cnn_pre_stages``: conv7x7/2 (0), BN (1), then ReLU and a 3x3/2
    max pool with pad 1."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__(Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype),
                         BatchNorm(64, channel_dim=1, dtype=dtype))

    def forward(self, x):
        return F.max_pool2d(F.relu(super().forward(x)), 3, 2, 1)


def resnet18_stages(dtype: torch.dtype | None = None
                    ) -> list[nn.Sequential]:
    """layer1..layer4 of the stride-8 ResNet18 trunk (2 blocks each)."""
    stages, c_in = [], 64
    for planes, stride in zip((64, 128, 256, 512), (1, 2, 1, 1)):
        blocks = []
        for bi in range(2):
            s = stride if bi == 0 else 1
            blocks.append(BasicBlock(c_in, planes, s,
                                     bi == 0 and (s != 1 or c_in != planes),
                                     dtype))
            c_in = planes
        stages.append(nn.Sequential(*blocks))
    return stages
