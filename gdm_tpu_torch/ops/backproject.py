"""Depth map -> organised point cloud (batched).

Counterpart of gdm_tpu/ops/backproject.py, with the reference's channel
convention: channel 0 = (u - cx) z / fx and channel 1 = (v - cy) z / fy,
u the column and v the row index.
"""

from __future__ import annotations

import torch


def depth_to_xyz(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[B, h, w] metric depth (0 where invalid), [B, 3, 3] intrinsics ->
    [B, h, w, 3] camera-frame xyz; pixels with depth <= 1e-8 are zero."""
    _, h, w = depth.shape
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    z = depth.to(torch.float32)
    msk = (z > 1e-8).to(torch.float32)
    k = K.to(torch.float32)[:, :, :, None, None]          # [B, 3, 3, 1, 1]
    x = (u - k[:, 0, 2]) * z / k[:, 0, 0]
    y = (v - k[:, 1, 2]) * z / k[:, 1, 1]
    return torch.stack([x, y, z], dim=-1) * msk[..., None]
