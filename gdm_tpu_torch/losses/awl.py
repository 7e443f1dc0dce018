"""Kendall-style automatic multi-task weighting.

Counterpart of gdm_tpu/losses/awl.py (reference models/loss.py:496-516):
sum_i 0.5 / p_i^2 * L_i + log(1 + p_i^2), p initialised to ones.  The
parameter keeps the reference's name, ``awl.params``; the JAX package
calls it ``weights`` and its importer maps the two.
"""

from __future__ import annotations

import torch
from torch import nn


class AutomaticWeightedLoss(nn.Module):
    def __init__(self, num: int = 2):
        super().__init__()
        self.params = nn.Parameter(torch.ones(num))

    def forward(self, *losses: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, loss in enumerate(losses):
            p2 = torch.square(self.params[i])
            total = total + 0.5 / p2 * loss + torch.log(1.0 + p2)
        return total
