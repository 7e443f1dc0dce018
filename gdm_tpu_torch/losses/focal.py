"""Focal loss for foreground segmentation.

Counterpart of gdm_tpu/losses/focal.py (reference models/loss.py:15-46,
gamma 2, no alpha): a fixed-shape mean, the focusing factor
(1 - p_t)^gamma taken without gradient.
"""

from __future__ import annotations

import torch


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean focal loss.

    Args:
      logits: [..., n_cls].
      targets: [...] integer class ids.
      gamma: focusing exponent.
      weight: optional [...] per-element weights (masked mean).
    """
    logp = torch.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    pt = torch.exp(logpt.detach())
    loss = -((1.0 - pt) ** gamma) * logpt
    if weight is None:
        return loss.mean()
    w = weight.to(loss.dtype)
    return (loss * w).sum() / torch.clamp_min(w.sum(), 1.0)
