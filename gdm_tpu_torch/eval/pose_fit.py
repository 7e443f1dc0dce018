"""Pose recovery from GeoMatch outputs, batched, with optional refinement.

Counterpart of gdm_tpu/eval/pose_fit.py:

    seg argmax -> fg mask -> L2-normalise features -> similarity argmax
    (the CUDA kernel on the card, ops/similarity) -> weighted Kabsch
    -> refinement: None | 'ransac' | 'icp' | 'meanshift'

A frame with a failed detection or fewer than 5 weighted
correspondences gets the miss sentinel R = I, t = (0, 0, -1000), which
refinement passes through unchanged.  The batch axis is written out; the
whole batch is one kernel launch.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.ops.kabsch import transform_pts, weighted_kabsch
from gdm_tpu_torch.ops.knn import knn_with_dist
from gdm_tpu_torch.ops.meanshift import mean_shift
from gdm_tpu_torch.ops.prng import fold_in, prng_key
from gdm_tpu_torch.ops.ransac import ransac_kabsch
from gdm_tpu_torch.ops.similarity import cosine_argmax_batched

REFINE_MODES = ("ransac", "icp", "meanshift")


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
                           det: torch.Tensor | None = None,
                           refine: str | None = None, icp_iters: int = 10,
                           icp_reject_dist=0.01,
                           pre_idx: torch.Tensor | None = None):
    """Batched pose fit from GeoMatch outputs (fit_pose_single with the
    batch axis written out, then :func:`apply_refine`).

    Args:
      cld: [B, N, 3]; end_points: {'seg' [B,N,2] logits, 'rgbd' [B,N,C],
      'mesh' [M,C]}; mesh_xyz: [M, 3]; det: [B] 0/1 or None.
      refine, icp_iters, icp_reject_dist: see :func:`apply_refine`.
      pre_idx: [B, N] correspondences found elsewhere (the mesh-column
        sharded argmax, parallel/sp.sharded_cosine_argmax), in place of
        the similarity argmax here.
    Returns:
      (poses [B, 3, 4], weights [B, N], matched vertex ids [B, N] int64)
    """
    b = cld.shape[0]
    fg = torch.argmax(end_points["seg"], dim=-1) == 1
    idx = pre_idx
    if idx is None:
        idx, _ = cosine_argmax_batched(l2_normalise(end_points["rgbd"]),
                                       l2_normalise(end_points["mesh"]))
    w = fg.to(torch.float32)
    if det is not None:
        w = w * det.to(torch.float32)[:, None]
    rt = weighted_kabsch(mesh_xyz[idx], cld, w)
    ok = torch.sum(w, dim=-1) >= 5.0
    rt = torch.where(ok[:, None, None], rt, miss_pose(b, cld.device))
    rt = apply_refine(rt, w, idx, cld, mesh_xyz, refine, icp_iters,
                      icp_reject_dist)
    return rt, w, idx


def apply_refine(rt: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                 cld: torch.Tensor, mesh_xyz: torch.Tensor,
                 refine: str | None, icp_iters: int = 10,
                 icp_reject_dist=0.01) -> torch.Tensor:
    """Refine fitted poses [B, 3, 4]; miss-sentinel frames (rt[2, 3] <=
    -999) pass through unrefined.

    refine:
      None: no change.
      'ransac': :func:`ops.ransac.ransac_kabsch` of the correspondences,
        each frame keyed fold_in(PRNGKey(0), sum of its vertex ids), as
        the JAX package keys it.
      'icp': :func:`icp_refine` of the mesh against the weighted scene
        points, ``icp_iters`` iterations gated at ``icp_reject_dist``
        metres (a number, or a [B] tensor of per-frame gates).
      'meanshift': t becomes the mean-shift mode (bandwidth 0.05) of the
        translation votes c_i - R m_idx(i); R stays.
    """
    if refine is None:
        return rt
    A = mesh_xyz[idx]
    if refine == "ransac":
        key = fold_in(prng_key(0, cld.device), torch.sum(idx, dim=-1))
        rt2 = ransac_kabsch(A, cld, w, key)
    elif refine == "icp":
        rt2 = icp_refine(mesh_xyz, cld, w, rt, icp_iters, icp_reject_dist)
    elif refine == "meanshift":
        votes = cld - A @ rt[:, :, :3].transpose(1, 2)
        center, _, _ = mean_shift(votes, bandwidth=0.05, mask=w)
        rt2 = torch.cat([rt[:, :, :3], center[..., None]], dim=2)
    else:
        raise ValueError(f"refine {refine!r}: want None or one of "
                         f"{REFINE_MODES}")
    hit = rt[:, 2, 3] > -999.0
    return torch.where(hit[:, None, None], rt2, rt)


def icp_refine(model_pts: torch.Tensor, scene_pts: torch.Tensor,
               scene_w: torch.Tensor, init_rt: torch.Tensor,
               iters: int = 10, reject_dist=0.01) -> torch.Tensor:
    """Fixed-iteration point-to-point ICP (gdm_tpu/eval/pose_fit.py
    icp_refine), batched.

    Each iteration moves the model points [M, 3] by the current pose,
    matches each to its nearest weighted scene point ([B, N, 3] with
    weights [B, N]; unweighted points sit 1e6 m away), keeps the matches
    closer than ``reject_dist`` (a number or [B] gates, metres) and
    refits; a frame with fewer than 4 kept matches keeps its pose.
    Returns [B, 3, 4]."""
    gate = torch.as_tensor(reject_dist, dtype=torch.float32,
                           device=scene_pts.device).reshape(-1, 1)
    scene_valid = scene_pts + (1.0 - scene_w[..., None]) * 1e6
    rt = init_rt
    rows = torch.arange(scene_pts.shape[0], device=scene_pts.device)[:, None]
    for _ in range(iters):
        moved = transform_pts(model_pts, rt)
        nn_idx, dist = knn_with_dist(scene_valid, moved, 1)
        tgt = scene_pts[rows, nn_idx[..., 0]]
        w = (dist[..., 0] < gate).to(torch.float32)
        new_rt = weighted_kabsch(model_pts.expand_as(tgt), tgt, w)
        ok = torch.sum(w, dim=-1) >= 4.0
        rt = torch.where(ok[:, None, None], new_rt, rt)
    return rt
