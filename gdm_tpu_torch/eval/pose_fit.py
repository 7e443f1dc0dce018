"""Pose recovery from GeoMatch outputs (refine=None), batched.

Counterpart of gdm_tpu/eval/pose_fit.py:

    seg argmax -> fg mask -> L2-normalise features -> similarity argmax
    (the CUDA kernel on the card, ops/similarity) -> weighted Kabsch

A frame with a failed detection or fewer than 5 weighted
correspondences gets the miss sentinel R = I, t = (0, 0, -1000).
The batch axis is written out; the whole batch is one kernel launch.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.ops.kabsch import weighted_kabsch
from gdm_tpu_torch.ops.similarity import cosine_argmax_batched


def miss_pose(b: int, device) -> torch.Tensor:
    rt = torch.eye(3, 4, device=device).repeat(b, 1, 1)
    rt[:, 2, 3] = -1000.0
    return rt


def l2_normalise(x: torch.Tensor) -> torch.Tensor:
    """Rows divided by max(|row|, 1e-12)."""
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def fit_poses_from_outputs(cld: torch.Tensor, end_points: dict,
                           mesh_xyz: torch.Tensor,
                           det: torch.Tensor | None = None):
    """Batched pose fit from GeoMatch outputs (fit_pose_single with the
    batch axis written out).

    Args:
      cld: [B, N, 3]; end_points: {'seg' [B,N,2] logits, 'rgbd' [B,N,C],
      'mesh' [M,C]}; mesh_xyz: [M, 3]; det: [B] 0/1 or None.
    Returns:
      (poses [B, 3, 4], weights [B, N], matched vertex ids [B, N] int64)
    """
    b = cld.shape[0]
    fg = torch.argmax(end_points["seg"], dim=-1) == 1
    idx, _ = cosine_argmax_batched(l2_normalise(end_points["rgbd"]),
                                   l2_normalise(end_points["mesh"]))
    w = fg.to(torch.float32)
    if det is not None:
        w = w * det.to(torch.float32)[:, None]
    rt = weighted_kabsch(mesh_xyz[idx], cld, w)
    ok = torch.sum(w, dim=-1) >= 5.0
    rt = torch.where(ok[:, None, None], rt, miss_pose(b, cld.device))
    return rt, w, idx
