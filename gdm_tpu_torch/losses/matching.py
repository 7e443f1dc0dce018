"""Dense correspondence matching loss (circle loss over scene x mesh).

Counterpart of gdm_tpu/losses/matching.py (reference
models/geoMatch.py:55-157).  Every scene row of every element is scored
against every mesh column plus a padding column (the "no match" class),
and rows outside the foreground are masked:

  * the padding column is -1s, and the padded mesh features are
    normalised per column (geoMatch.py:117-119);
  * an element's loss is the mean over its foreground rows; elements
    with fewer than 3 foreground points are left out of the batch mean,
    as the reference's ``len(idxs) < 3: continue``;
  * the symmetric branch takes as positives the matched vertex and its
    symmetric counterpart ``sym_idx[match_idx]``;
  * ``batch_chunk`` elements are scored at a time, bounding the
    [chunk, N, M+1] temporaries.

The DGCNN variant (geoMatch_DGCNN.py:62-65,95-98) takes the padding
column as the one-hot e0 (``pad_onehot``) and a depth-scaled radius: mesh
column j is positive within ``r_mm / 1000 * z_j`` of the GT match, z_j
the camera depth of vertex j under the element's GT pose.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.losses.circle import circle_loss
from gdm_tpu_torch.ops.knn import pairwise_sqdist
from gdm_tpu_torch.parallel.mesh import all_reduce_sum


def matching_positive_mask(match_idx: torch.Tensor, mesh_xyz: torch.Tensor,
                           vis_flag: torch.Tensor,
                           positive_r) -> torch.Tensor:
    """Positive-pair mask (geoMatch.py:55-78), batched.

    Args:
      match_idx: [B, n] matched mesh vertex per scene point, m = none.
      mesh_xyz: [m, 3] mesh vertices (metres).
      vis_flag: [B, m] 0/1 visibility of each vertex under the GT pose.
      positive_r: radius; vertices within it of the GT match are positive.
    Returns:
      [B, n, m + 1] bool; the padding column is positive exactly for the
      unmatched points.
    """
    n_mesh = mesh_xyz.shape[0]
    in_mesh = match_idx != n_mesh
    safe = torch.clamp(match_idx, 0, n_mesh - 1).long()
    gt_pt = mesh_xyz[safe]                                   # [B, n, 3]
    d2 = pairwise_sqdist(gt_pt, mesh_xyz.expand(gt_pt.shape[0], -1, -1))
    r = torch.as_tensor(positive_r, dtype=torch.float32,
                        device=mesh_xyz.device)
    pos = (d2 < torch.square(r)) & (vis_flag > 0)[:, None, :] \
        & in_mesh[..., None]
    return torch.cat([pos, ~in_mesh[..., None]], dim=-1)


def matching_positive_mask_depth_scaled(match_idx: torch.Tensor,
                                        mesh_xyz: torch.Tensor,
                                        vis_flag: torch.Tensor,
                                        rt: torch.Tensor,
                                        r_mm: float) -> torch.Tensor:
    """:func:`matching_positive_mask` with the radius of mesh column j
    ``r_mm / 1000 * z_j``, z_j = R[2] . xyz_j + t_z under the GT pose
    ``rt`` [B, 3, 4] (geoMatch_DGCNN.py:62-65)."""
    n_mesh = mesh_xyz.shape[0]
    in_mesh = match_idx != n_mesh
    safe = torch.clamp(match_idx, 0, n_mesh - 1).long()
    gt_pt = mesh_xyz[safe]                                   # [B, n, 3]
    d2 = pairwise_sqdist(gt_pt, mesh_xyz.expand(gt_pt.shape[0], -1, -1))
    z = torch.matmul(mesh_xyz, rt[:, 2, :3, None])[..., 0] \
        + rt[:, 2, 3:4]                                       # [B, m]
    radius = (r_mm / 1000.0) * z
    pos = (d2 < torch.square(radius)[:, None, :]) \
        & (vis_flag > 0)[:, None, :] & in_mesh[..., None]
    return torch.cat([pos, ~in_mesh[..., None]], dim=-1)


def matching_positive_mask_sym(match_idx: torch.Tensor,
                               sym_idx: torch.Tensor,
                               n_mesh: int) -> torch.Tensor:
    """Symmetry-aware positive mask, batched: the matched vertex and its
    symmetric counterpart; the padding column for unmatched points."""
    in_mesh = match_idx != n_mesh
    safe = torch.clamp(match_idx, 0, n_mesh - 1).long()
    sym = sym_idx.long()[safe]
    cols = torch.arange(n_mesh + 1, device=match_idx.device)
    pos = (cols == safe[..., None]) | (cols == sym[..., None])
    pos = pos & in_mesh[..., None]
    pad = torch.zeros_like(pos)
    pad[..., n_mesh] = ~in_mesh
    return pos | pad


def grid_matching_loss(grid, *args, **kw) -> torch.Tensor:
    """:func:`pointwise_matching_loss` of the global batch of ``grid``
    (parallel/mesh.Grid, or None for this batch alone): with several
    model shards the mesh columns split over the model row
    (parallel/sp.sharded_matching_loss), else the batch mean reduced over
    the data column."""
    if grid is not None and grid.model_shards > 1:
        from gdm_tpu_torch.parallel.sp import sharded_matching_loss

        return sharded_matching_loss(*args, grid, **kw)
    return pointwise_matching_loss(
        *args, group=None if grid is None else grid.data_group, **kw)


def pointwise_matching_loss(
    rgbd_features: torch.Tensor,
    mesh_features: torch.Tensor,
    mesh_xyz: torch.Tensor,
    labels: torch.Tensor,
    match_idx: torch.Tensor,
    visible_flag: torch.Tensor,
    positive_r,
    sym_idx: torch.Tensor | None = None,
    m: float = 0.2,
    gamma: float = 16.0,
    pad_onehot: bool = False,
    rt: torch.Tensor | None = None,
    depth_scaled_r_mm: float | None = None,
    batch_chunk: int | None = None,
    group=None,
) -> torch.Tensor:
    """Batch matching loss (pointwise_feature_matching parity).

    Args:
      rgbd_features: [B, N, C] scene descriptors (before normalisation).
      mesh_features: [M, C] mesh descriptors.
      mesh_xyz: [M, 3].
      labels: [B, N] foreground labels (row validity).
      match_idx: [B, N] GT correspondence (M = unmatched).
      visible_flag: [B, M] per-element vertex visibility.
      positive_r: neighbor_dis_th * diameter_m (geoMatch.py:24).
      sym_idx: optional [M] symmetry table (geoMatch.py:138-141).
      pad_onehot: the padding column e0 instead of -1s.
      rt, depth_scaled_r_mm: [B, 3, 4] GT poses and the radius in mm per
        metre of depth: the depth-scaled mask in place of ``positive_r``.
      batch_chunk: elements scored at once (None = the whole batch).
      group: the process group of the data-parallel ranks, whose batches
        make the mean together (parallel/mesh.Grid.data_group), or None.
    Returns:
      scalar: mean over valid elements of per-element row means.
    """
    n_mesh = mesh_features.shape[0]
    if pad_onehot:
        pad = torch.zeros_like(mesh_features[:1])
        pad[0, 0] = 1.0
    else:
        pad = -torch.ones_like(mesh_features[:1])
    mesh_padded = torch.cat([mesh_features, pad], dim=0)
    mesh_padded = mesh_padded / torch.clamp_min(
        torch.linalg.vector_norm(mesh_padded, dim=1, keepdim=True), 1e-12)

    b = rgbd_features.shape[0]
    chunk = b if batch_chunk is None else min(batch_chunk, b)
    losses, weights = [], []
    for s in range(0, b, chunk):
        feats = rgbd_features[s:s + chunk]
        midx = match_idx[s:s + chunk]
        f = feats / torch.clamp_min(
            torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-12)
        sim = torch.matmul(f, mesh_padded.T)                  # [c, N, M+1]
        if sym_idx is not None:
            pos = matching_positive_mask_sym(midx, sym_idx, n_mesh)
        elif depth_scaled_r_mm is not None:
            pos = matching_positive_mask_depth_scaled(
                midx, mesh_xyz, visible_flag[s:s + chunk], rt[s:s + chunk],
                depth_scaled_r_mm)
        else:
            pos = matching_positive_mask(midx, mesh_xyz,
                                         visible_flag[s:s + chunk],
                                         positive_r)
        row_valid = labels[s:s + chunk] == 1
        per_row = circle_loss(sim, pos, m=m, gamma=gamma, reduce=False)
        n_fg = row_valid.sum(dim=-1)
        losses.append((per_row * row_valid).sum(dim=-1)
                      / torch.clamp_min(n_fg, 1))
        weights.append((n_fg >= 3).to(torch.float32))
    losses, weights = torch.cat(losses), torch.cat(weights)
    num = (losses * weights).sum()
    num_den = all_reduce_sum(torch.stack([num, weights.sum().to(num.dtype)]),
                             group)
    return num_den[0] / torch.clamp_min(num_den[1], 1.0)
