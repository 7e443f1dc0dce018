"""Shared building blocks, channels-last, in eval and training mode.

Counterpart of gdm_tpu/models/layers.py.  Parameter names follow the
reference torch modules that gdm_tpu.train.import_torch.export_state_dict
emits: a point MLP layer is ``conv.weight`` [out, in] (+ ``conv.bias``
without BN) and its batch norm sits at ``normlayer.bn.*`` on the CNN /
fusion side or ``bn.bn.*`` on the RandLA side.

Batch norm is ``(x - mean) * rsqrt(var + eps) * scale + bias``, as in the
JAX package; the default eps is 1e-5 and the RandLA blocks use 1e-6 with
LeakyReLU(0.2).  In training mode (``module.train()``) it normalises with
the batch mean and the *biased* batch variance, E[x^2] - E[x]^2 in f32
(or in the input's dtype when that is wider), and moves the running
statistics by the torch-convention momentum
``new = (1 - m) * old + m * batch`` with that same biased variance (where
``torch.nn.BatchNorm`` would take the unbiased one).  The momentum is an
attribute that the train step sets each step from its schedule
(:func:`set_train_step_state`), as the reference's BNMomentumScheduler
does.

Dropout is element-wise, as ``flax.linen.Dropout``: keep with probability
1 - p, scale the kept values by 1 / (1 - p).  Its masks come from a
``torch.Generator`` that the train step seeds from (seed, step), so a
resumed run draws the same masks.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch norm over one channel axis (default: the last).

    Holds the torch BatchNorm state names (weight, bias, running_mean,
    running_var, num_batches_tracked) so reference state dicts load."""

    def __init__(self, features: int, eps: float = 1e-5,
                 channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        if self.training:
            dims = [d for d in range(x.dim())
                    if d != self.channel_dim % x.dim()]
            xa = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xa.mean(dim=dims)
            var = torch.clamp_min(
                torch.square(xa).mean(dim=dims) - torch.square(mean), 0.0)
            with torch.no_grad():
                m = torch.tensor(self.momentum, dtype=torch.float32,
                                 device=x.device)
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


class Dropout(nn.Module):
    """Element-wise dropout with an explicit generator (flax.linen.Dropout
    semantics); the identity in eval mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator "
                               "(set_train_step_state)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_train_step_state(model: nn.Module, momentum: float,
                         generator: torch.Generator | None) -> None:
    """Set this step's BN momentum and dropout generator on every
    BatchNorm and Dropout of ``model``."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = momentum
        elif isinstance(mod, Dropout):
            mod.generator = generator


class _BNHolder(nn.Module):
    """The reference's BN wrapper: one child named ``bn``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.bn = BatchNorm(features, eps)


class Dense(nn.Module):
    """A 1x1 point convolution: ``weight`` [out, in] (+ ``bias``)."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the RandLA activation."""
    return F.leaky_relu(x, 0.2)


class DenseBNAct(nn.Module):
    """Dense + BN + activation over the last axis (bias dropped with BN).

    ``bn_attr`` names the BN wrapper: ``normlayer`` on the CNN / fusion
    side, ``bn`` on the RandLA side (reference state-dict layout)."""

    def __init__(self, c_in: int, c_out: int, bn: bool = True,
                 act: Callable | None = F.relu, bias: bool = True,
                 bn_eps: float = 1e-5, bn_attr: str = "normlayer"):
        super().__init__()
        self.conv = Dense(c_in, c_out, bias=bias and not bn)
        self.act = act
        self.bn_attr = bn_attr if bn else None
        if bn:
            setattr(self, bn_attr, _BNHolder(c_out, bn_eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn_attr is not None:
            x = getattr(self, self.bn_attr).bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


def randla_dense(c_in: int, c_out: int,
                 act: Callable | None = leaky_relu02) -> DenseBNAct:
    """The RandLA-side DenseBNAct: BN eps 1e-6, LeakyReLU(0.2)."""
    return DenseBNAct(c_in, c_out, act=act, bn_eps=1e-6, bn_attr="bn")


class MLPHead(nn.Sequential):
    """A chain of DenseBNAct layers; the last has no BN and no activation
    (the seg / feature-encoding heads, geoMatch.py:34-47)."""

    def __init__(self, c_in: int, widths, final_bias: bool = True):
        layers = []
        for w in widths[:-1]:
            layers.append(DenseBNAct(c_in, w))
            c_in = w
        layers.append(DenseBNAct(c_in, widths[-1], bn=False, act=None,
                                 bias=final_bias))
        super().__init__(*layers)


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: [B, N, C] by [B, ...] int64 -> [B, ..., C].

    One flat index_select over [B*N, C] with per-batch offsets
    (gdm_tpu.models.randla.gather_neighbours_b forward)."""
    b, n, c = feats.shape
    off = (torch.arange(b, device=idx.device) * n).view(
        (b,) + (1,) * (idx.dim() - 1))
    flat = feats.reshape(b * n, c).index_select(0, (idx + off).reshape(-1))
    return flat.view(idx.shape + (c,))
