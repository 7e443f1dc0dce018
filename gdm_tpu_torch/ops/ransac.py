"""RANSAC rigid fit, batched over frames.

Counterpart of gdm_tpu/ops/ransac.py: every hypothesis is drawn up front
(Gumbel top-4 over the log-weights, so only weighted rows are sampled),
all of them are fitted in one batched Kabsch and scored in one [h, n]
distance computation, and the best is refitted on its consensus set.
The Gumbel noise comes from ops/prng, JAX's own generator, so each frame
draws the hypotheses the JAX package draws from the same key.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.ops.kabsch import kabsch, weighted_kabsch
from gdm_tpu_torch.ops.prng import gumbel


def ransac_kabsch(A: torch.Tensor, B: torch.Tensor, w: torch.Tensor,
                  key: torch.Tensor, n_hyp: int = 32,
                  inlier_th: float = 0.015) -> torch.Tensor:
    """RANSAC fit A -> B over weighted correspondences, per frame.

    Args:
      A, B: [b, n, 3] corresponding point sets.
      w: [b, n] weights in {0, 1}.
      key: [b, 2] JAX PRNG keys (ops/prng), one per frame.
      n_hyp: 4-point hypotheses per frame.
      inlier_th: inlier distance in metres.

    Returns:
      [b, 3, 4]: the weighted fit of the best hypothesis's inliers when
      they are at least 4, else the best hypothesis.  Hypothesis 0 is the
      weighted fit of all points; ties in the inlier score go to the
      lowest hypothesis.
    """
    b, n, _ = A.shape
    logw = torch.log(torch.clamp_min(w.to(torch.float32), 1e-9))
    g = gumbel(key, (n_hyp, n)) + logw[:, None, :]            # [b, h, n]
    idx = torch.topk(g, 4, dim=-1).indices                    # descending
    rows = torch.arange(b, device=A.device)[:, None, None]
    hyps = kabsch(A[rows, idx].reshape(b * n_hyp, 4, 3),
                  B[rows, idx].reshape(b * n_hyp, 4, 3))
    hyps = torch.cat([weighted_kabsch(A, B, w)[:, None],
                      hyps.reshape(b, n_hyp, 3, 4)], dim=1)   # [b, h+1]
    moved = (A[:, None] @ hyps[..., :3].transpose(-1, -2)
             + hyps[:, :, None, :, 3])                        # [b, h+1, n, 3]
    err = torch.linalg.vector_norm(moved - B[:, None], dim=-1)
    inl = (err <= inlier_th) * w[:, None]
    best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)       # first max
    frames = torch.arange(b, device=A.device)
    inl, best_rt = inl[frames, best], hyps[frames, best]
    refit = weighted_kabsch(A, B, inl)
    ok = torch.sum(inl, dim=-1) >= 4.0
    return torch.where(ok[:, None, None], refit, best_rt)
