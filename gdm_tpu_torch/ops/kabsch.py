"""Weighted least-squares rigid fit (Kabsch without scale), batched.

Counterpart of gdm_tpu/ops/kabsch.py.  Zero-weight rows are ignored, so a
fixed-shape masked set fits exactly like the subset.  H is scaled to a
largest entry of 1 before the SVD (the factors do not change; degenerate
correspondence sets give H entries near 1e-19, which batched SVDs handle
badly), and a reflection is corrected so det(R) = +1.  Everything is
batched over a leading frame axis.
"""

from __future__ import annotations

import torch


def weighted_kabsch(A: torch.Tensor, B: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Best-fit [R | t] mapping A -> B: [b, n, 3], [b, n, 3], [b, n]
    nonnegative weights -> [b, 3, 4]."""
    w = w.to(torch.float32)
    wsum = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    wn = (w / wsum)[..., None]                             # [b, n, 1]
    ca = torch.sum(A * wn, dim=1)                          # [b, 3]
    cb = torch.sum(B * wn, dim=1)
    AA = (A - ca[:, None]) * torch.sqrt(wn)
    BB = (B - cb[:, None]) * torch.sqrt(wn)
    H = AA.transpose(1, 2) @ BB                            # [b, 3, 3]
    scale = torch.amax(torch.abs(H), dim=(1, 2), keepdim=True)
    H = H / torch.clamp_min(scale, 1e-30)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(1, 2), U.transpose(1, 2)
    sign = torch.where(torch.linalg.det(V @ Ut) < 0, -1.0, 1.0)
    d = torch.ones_like(ca)
    d[:, 2] = sign
    R = (V * d[:, None, :]) @ Ut
    t = cb - (R @ ca[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=2)


def kabsch(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Unweighted best-fit [R | t]: weighted_kabsch with unit weights."""
    return weighted_kabsch(A, B, torch.ones(A.shape[:2], device=A.device))


def transform_pts(pts: torch.Tensor, RT: torch.Tensor) -> torch.Tensor:
    """[b, n, 3] points (or [n, 3], shared) under [b, 3, 4] -> [b, n, 3]."""
    return pts @ RT[:, :, :3].transpose(1, 2) + RT[:, None, :, 3]
