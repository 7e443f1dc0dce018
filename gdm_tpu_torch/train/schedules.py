"""Learning-rate and batch-norm momentum schedules.

Counterpart of gdm_tpu/train/schedules.py (reference train_lm.py:441-457:
CyclicLR base 1e-6, max 1e-3, triangular, step_size = total_epochs *
len(ds) / batch / 6 / n_gpus; BNMomentumScheduler max(0.9 * 0.5 **
int(it * bs / 2e5), 0.01)).  Both take an integer step (a Python int or
an integer tensor, on any device) and compute in f32 as the JAX package
does, so the values are the same to the bit.
"""

from __future__ import annotations

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cyclic_lr(base_lr: float = 1e-6, max_lr: float = 1e-3,
              step_size: int = 1000):
    """Triangular cyclic LR (torch CyclicLR mode='triangular' parity)."""

    def schedule(step) -> torch.Tensor:
        s = _f32(step)
        cycle = torch.floor(1.0 + s / (2.0 * step_size))
        x = torch.abs(s / step_size - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * torch.clamp_min(1.0 - x, 0.0)

    return schedule


def clr_step_size(total_epochs: int, dataset_len: int, batch_size: int,
                  clr_div: int = 6, n_replicas: int = 1) -> int:
    """step_size_up/down of train_lm.py:441-447."""
    return max(
        total_epochs * dataset_len // batch_size // clr_div // n_replicas, 1)


def bn_momentum_schedule(bn_momentum: float = 0.9, bn_decay: float = 0.5,
                         decay_step: float = 2e5, batch_size: int = 24,
                         clip: float = 0.01):
    """Torch-convention BN momentum as a function of the iteration."""

    def schedule(it) -> torch.Tensor:
        it = torch.as_tensor(it).to(torch.int32)
        k = torch.floor((it * batch_size).to(torch.float32) / decay_step)
        return torch.clamp_min(
            bn_momentum * torch.pow(torch.tensor(bn_decay), k), clip)

    return schedule
