"""Masked circle loss over the scene x mesh similarity matrix.

Counterpart of gdm_tpu/losses/circle.py (reference models/loss.py:433-494,
gamma 16, margin 0.2).  Per row (one scene point; columns are the mesh
vertices and the padding column):

    ap      = detach(relu(1 + m - sim)) on positive entries
    an      = detach(relu(sim + m))     on negative entries
    logit_p = -ap * (sim - (1 - m)) * gamma
    logit_n =  an * (sim - m) * gamma
    loss    = softplus(mLSE_pos(logit_p) + mLSE_neg(logit_n))
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_logsumexp(logits: torch.Tensor, mask: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """log(sum(exp(logits) * mask)), numerically stable and finite on an
    empty mask (the caller leaves such rows out)."""
    mask = mask.bool()
    masked = torch.where(mask, logits, torch.full_like(logits, -torch.inf))
    mx = masked.amax(dim=dim, keepdim=True)
    mx_safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    s = torch.where(mask, torch.exp(logits - mx_safe),
                    torch.zeros_like(logits)).sum(dim=dim)
    return mx_safe.squeeze(dim) + torch.log(torch.clamp_min(s, 1e-30))


def circle_loss(sim: torch.Tensor, pos_mask: torch.Tensor,
                row_valid: torch.Tensor | None = None, m: float = 0.2,
                gamma: float = 16.0, reduce: bool = True) -> torch.Tensor:
    """Masked circle loss.

    Args:
      sim: [..., n_rows, n_cols] cosine similarities.
      pos_mask: same shape, bool; negatives are the complement.
      row_valid: optional [..., n_rows] weights of the mean.
      m, gamma: margin and scale (reference: 0.2, 16).
      reduce: False returns the per-row [..., n_rows] softplus terms.
    """
    pos = pos_mask.bool()
    neg = ~pos
    ap = torch.clamp_min(1.0 + m - sim, 0.0).detach()
    an = torch.clamp_min(sim + m, 0.0).detach()
    logit_p = -ap * (sim - (1.0 - m)) * gamma
    logit_n = an * (sim - m) * gamma
    per_row = F.softplus(masked_logsumexp(logit_p, pos)
                         + masked_logsumexp(logit_n, neg))
    if not reduce:
        return per_row
    if row_valid is None:
        return per_row.mean()
    w = row_valid.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp_min(w.sum(), 1.0)
