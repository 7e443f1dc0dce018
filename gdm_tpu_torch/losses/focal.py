"""Focal loss for foreground segmentation.

Counterpart of gdm_tpu/losses/focal.py (reference models/loss.py:15-46,
gamma 2, no alpha): a fixed-shape mean, the focusing factor
(1 - p_t)^gamma taken without gradient.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.parallel.mesh import all_reduce_sum


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0,
               weight: torch.Tensor | None = None,
               group=None) -> torch.Tensor:
    """Mean focal loss.

    Args:
      logits: [..., n_cls].
      targets: [...] integer class ids.
      gamma: focusing exponent.
      weight: optional [...] per-element weights (masked mean).
      group: the process group of the data-parallel ranks, whose batches
        make the mean together, or None.
    """
    logp = torch.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    pt = torch.exp(logpt.detach())
    loss = -((1.0 - pt) ** gamma) * logpt
    w = torch.ones_like(loss) if weight is None else weight.to(loss.dtype)
    num_den = all_reduce_sum(torch.stack([(loss * w).sum(), w.sum()]), group)
    return num_den[0] / torch.clamp_min(num_den[1], 1.0)
