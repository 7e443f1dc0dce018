"""Depth-map surface normals (batched).

Counterpart of gdm_tpu/ops/normals.py: a gated least-squares tangent fit
over a k x k window (normalSpeed settings: k=5, 2000 mm distance and
20 mm difference thresholds).  Neighbours come from ``torch.roll``; the
rows and columns that wrap around are masked out by ``inside``.  Normals
point toward the camera.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.ops.backproject import depth_to_xyz


K_SIZE = 5                      # window
DISTANCE_THRESHOLD = 2000.0     # mm: deeper pixels get no normal
DIFFERENCE_THRESHOLD = 20.0     # mm: neighbours further off are excluded


def depth_normals(depth_mm: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[B, h, w] depth in millimetres, [B, 3, 3] intrinsics ->
    [B, h, w, 3] unit normals, zero where invalid or unfittable."""
    depth_mm = depth_mm.to(torch.float32)
    xyz = depth_to_xyz(depth_mm, K)                       # mm-scale xyz
    valid = (depth_mm > 1e-3) & (depth_mm < DISTANCE_THRESHOLD)
    r = K_SIZE // 2

    def tangent(axis: int):
        # weighted LS slope along an image axis: sum(w o d_o) / sum(w o^2)
        num = torch.zeros_like(xyz)
        den = torch.zeros_like(depth_mm)
        n_ax = depth_mm.shape[axis]
        pos = torch.arange(n_ax, device=depth_mm.device)
        pos = pos.view((1, -1, 1) if axis == 1 else (1, 1, -1))
        for o in range(-r, r + 1):
            if o == 0:
                continue
            nb_xyz = torch.roll(xyz, -o, dims=axis)
            nb_d = torch.roll(depth_mm, -o, dims=axis)
            nb_valid = torch.roll(valid, -o, dims=axis)
            inside = (pos + o >= 0) & (pos + o < n_ax)
            gate = (nb_valid & inside
                    & (torch.abs(nb_d - depth_mm) < DIFFERENCE_THRESHOLD)
                    ).to(torch.float32)
            num = num + gate[..., None] * o * (nb_xyz - xyz)
            den = den + gate * float(o * o)
        return num / torch.clamp_min(den, 1e-6)[..., None], den > 0

    tu, ok_u = tangent(axis=2)   # along columns (image x)
    tv, ok_v = tangent(axis=1)   # along rows (image y)
    n = torch.linalg.cross(tu, tv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    # orient toward the camera: the viewing ray is +xyz, want n . xyz <= 0
    sign = torch.where(torch.sum(n * xyz, dim=-1, keepdim=True) > 0,
                       -1.0, 1.0)
    n = n * sign
    ok = valid & ok_u & ok_v & (norm[..., 0] > 1e-12)
    return torch.where(ok[..., None], n, 0.0)
