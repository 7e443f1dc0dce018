"""Mean-shift mode seeking, batched over frames.

Counterpart of gdm_tpu/ops/meanshift.py: Gaussian-kernel shifts of every
point towards the weighted mean of its neighbourhood until the largest
move of a frame is at most bandwidth * 1e-3 (or 50 shifts), then the
shifted point with the most shifted neighbours inside the bandwidth is
the mode.  Masked points neither pull the others nor win the vote.

Each frame stops on its own condition, as in JAX's vmapped
``while_loop``: a converged frame keeps its state while the others shift
on.  Squared distances are sums of squared differences (not the expanded
form of ops/knn), as in JAX.  A shift of one frame holds [n, n] floats a
few times over (67 MB each at n = 4096), so frames shift in chunks.
"""

from __future__ import annotations

import torch


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[f, n, 3] x [f, m, 3] -> [f, n, m]: ((dx^2 + dy^2) + dz^2)."""
    d2 = None
    for j in range(a.shape[-1]):
        dj = a[..., :, None, j] - b[..., None, :, j]
        d2 = dj * dj if d2 is None else d2 + dj * dj
    return d2


def _shift(A: torch.Tensor, pts: torch.Tensor, m: torch.Tensor,
           inv2b2: float) -> torch.Tensor:
    w = torch.exp(-_sqdist(A, pts) * inv2b2) * m[:, None, :]
    num = w @ pts
    den = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    return num / den


def mean_shift(pts: torch.Tensor, bandwidth: float = 0.05,
               mask: torch.Tensor | None = None, max_iter: int = 50,
               chunk: int = 8):
    """Densest mode of each frame's point set.

    Args:
      pts: [b, n, c] points.
      bandwidth: Gaussian kernel bandwidth.
      mask: optional [b, n] 0/1 validity.
      max_iter: shifts at most.
      chunk: frames shifted together (peak memory).

    Returns:
      (centers [b, c], labels [b, n] bool: the valid points within the
      bandwidth of their frame's centre, iterations [b] int64).
    """
    b, n, _ = pts.shape
    m = (torch.ones(b, n, device=pts.device) if mask is None
         else mask.to(torch.float32))
    stop = bandwidth * 1e-3
    inv2b2 = 0.5 / (bandwidth * bandwidth)
    A = pts.clone()
    moved = torch.full((b,), float("inf"), device=pts.device)
    it = torch.zeros(b, dtype=torch.int64, device=pts.device)
    while True:
        live = torch.nonzero((moved > stop) & (it < max_iter))[:, 0]
        if live.numel() == 0:
            break
        for s in range(0, live.numel(), chunk):
            f = live[s:s + chunk]
            A0 = A[f]
            A2 = _shift(A0, pts[f], m[f], inv2b2)
            moved[f] = torch.amax(torch.linalg.vector_norm(
                (A2 - A0) * m[f][..., None], dim=-1), dim=-1)
            A[f] = A2
            it[f] += 1

    best = torch.empty(b, dtype=torch.int64, device=pts.device)
    for s in range(0, b, chunk):
        a, mf = A[s:s + chunk], m[s:s + chunk]
        inside = torch.sqrt(_sqdist(a, a)) < bandwidth
        num_in = torch.sum(inside * mf[:, None, :], dim=-1) * mf
        best[s:s + chunk] = torch.argmax(num_in, dim=-1)      # first max
    center = A[torch.arange(b, device=pts.device), best]
    labels = (torch.linalg.vector_norm(pts - center[:, None], dim=-1)
              < bandwidth) & (m > 0)
    return center, labels, it
