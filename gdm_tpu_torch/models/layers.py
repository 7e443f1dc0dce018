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

Compute dtype (``dtype``, Flax's ``dtype=`` of gdm_tpu/models/layers.py):
None computes in the dtype of the parameters and the input, as the f32
model (and the tests' float64 copies) always did.  A dtype (bfloat16)
keeps the parameters and BN buffers in f32 and casts at each call: a
Dense or conv casts its input and its weight (and bias) to it; batch norm
takes its training statistics in f32 from the widened input, casts the
mean, ``rsqrt(var + eps) * scale`` and the bias down to the input's dtype
before it applies them (torch would promote ``bf16 - f32`` to f32), and
returns its dtype.  No ``torch.autocast``: its per-op policy is not
Flax's.  Each bf16 op rounds its result, as XLA does, with three
exceptions that follow XLA's rounding rather than torch's: a Dense or
conv adds its bias after the product is rounded (torch would fuse it);
LeakyReLU's slope is 0.2 rounded to the input's dtype (JAX's weakly
typed constant); and a reduction of a bf16 elementwise result (softmax's
and log-softmax's sums of exp, attentive pooling's weighted sum) sums the
unrounded f32 values, because JAX widens a bf16 reduction's input to
f32 and XLA fuses that widening into the op that produces it
(:func:`softmax`, :func:`log_softmax`, :func:`weighted_sum`).  Batch
norm's training statistics are one such reduction in JAX too, of the
unrounded product; the port takes them from the rounded output.

:func:`gather_rows` carries the JAX package's gather backward
(gdm_tpu/models/randla.py ``_gather_bwd``): from a source of n >= 512
rows each cotangent row is rounded to ``bwd_dtype`` (or kept in its own
dtype when that is None) and the rows are summed in f32; from a smaller
source they are summed in the cotangent's dtype (``segment_sum``).

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
                 channel_dim: int = -1, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.dtype = dtype
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
        dt = x.dtype
        y = ((x - mean.to(dt).view(shape)) * inv.to(dt).view(shape)
             + self.bias.to(dt).view(shape))
        return cast(y, self.dtype)


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

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.bn = BatchNorm(features, eps, dtype=dtype)


def cast(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` in ``dtype``; None leaves it as it is."""
    return x if dtype is None else x.to(dtype)


class Dense(nn.Module):
    """A 1x1 point convolution: ``weight`` [out, in] (+ ``bias``)."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def _narrow(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the RandLA and DGCNN activation; in bf16 its slope
    is bf16(0.2) = 0.2001953125, as JAX's."""
    return F.leaky_relu(x, 0.2001953125 if _narrow(x) else 0.2)


class LeakyReLU02(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu02(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``; in bf16 the normaliser sums the unrounded
    exp (module docstring)."""
    if not _narrow(x):
        return torch.softmax(x, dim)
    e = torch.exp((x - x.amax(dim, keepdim=True)).float())
    return e.to(x.dtype) / e.sum(dim, keepdim=True).to(x.dtype)


def log_softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.log_softmax``; in bf16 the log-sum sums the unrounded exp
    (module docstring)."""
    if not _narrow(x):
        return torch.log_softmax(x, dim)
    shifted = x - x.amax(dim, keepdim=True)
    total = torch.exp(shifted.float()).sum(dim, keepdim=True)
    return shifted - torch.log(total.to(x.dtype))


def weighted_sum(x: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum(x * w, dim)``; in bf16 the products stay unrounded in f32
    (module docstring)."""
    if not _narrow(x):
        return torch.sum(x * w, dim=dim)
    return torch.sum(x.float() * w.float(), dim=dim).to(x.dtype)


class DenseBNAct(nn.Module):
    """Dense + BN + activation over the last axis (bias dropped with BN).

    ``bn_attr`` names the BN wrapper: ``normlayer`` on the CNN / fusion
    side, ``bn`` on the RandLA side (reference state-dict layout)."""

    def __init__(self, c_in: int, c_out: int, bn: bool = True,
                 act: Callable | None = F.relu, bias: bool = True,
                 bn_eps: float = 1e-5, bn_attr: str = "normlayer",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Dense(c_in, c_out, bias=bias and not bn, dtype=dtype)
        self.act = act
        self.bn_attr = bn_attr if bn else None
        if bn:
            setattr(self, bn_attr, _BNHolder(c_out, bn_eps, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn_attr is not None:
            x = getattr(self, self.bn_attr).bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


def randla_dense(c_in: int, c_out: int,
                 act: Callable | None = leaky_relu02,
                 dtype: torch.dtype | None = None) -> DenseBNAct:
    """The RandLA-side DenseBNAct: BN eps 1e-6, LeakyReLU(0.2)."""
    return DenseBNAct(c_in, c_out, act=act, bn_eps=1e-6, bn_attr="bn",
                      dtype=dtype)


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


# from this many source rows the JAX package's gather backward is a
# one-hot contraction summed in f32 (gdm_tpu/models/randla.py
# _ONEHOT_BWD_MIN_N); below it, a segment sum in the cotangent's dtype
ONEHOT_BWD_MIN_N = 512


class _GatherRows(torch.autograd.Function):
    """Flat row gather from B sources of n rows each, whose backward sums
    as the JAX package's does."""

    @staticmethod
    def forward(ctx, flat, flat_idx, n, bwd_dtype):
        ctx.save_for_backward(flat_idx)
        ctx.n_rows, ctx.n, ctx.bwd_dtype = flat.shape[0], n, bwd_dtype
        return flat.index_select(0, flat_idx)

    @staticmethod
    def backward(ctx, ct):
        (flat_idx,) = ctx.saved_tensors
        acc, rows = ct.dtype, ct
        if ctx.n >= ONEHOT_BWD_MIN_N:
            acc = torch.promote_types(ct.dtype, torch.float32)
            rows = ct.to(ctx.bwd_dtype or ct.dtype).to(acc)
        out = torch.zeros(ctx.n_rows, ct.shape[-1], dtype=acc,
                          device=ct.device).index_add_(0, flat_idx, rows)
        return out.to(ct.dtype), None, None, None


def gather_rows(feats: torch.Tensor, idx: torch.Tensor,
                bwd_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Batched row gather: [B, N, C] by [B, ...] int64 -> [B, ..., C].

    One flat index_select over [B*N, C] with per-batch offsets
    (gdm_tpu.models.randla.gather_neighbours_b forward); its backward
    rounds the cotangent rows to ``bwd_dtype`` where N >= 512 (the
    module docstring)."""
    b, n, c = feats.shape
    off = (torch.arange(b, device=idx.device) * n).view(
        (b,) + (1,) * (idx.dim() - 1))
    flat = _GatherRows.apply(feats.reshape(b * n, c),
                             (idx + off).reshape(-1), n, bwd_dtype)
    return flat.view(idx.shape + (c,))
