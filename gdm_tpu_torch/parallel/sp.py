"""Mesh-column (model-axis) sharding of the correspondence argmax and of
the matching loss.

Counterpart of gdm_tpu/parallel/sp.py.  The ranks of one model row
(parallel/mesh.Grid) hold the same batch rows, the whole mesh features
and the whole mesh; rank k of the row takes the mesh columns
[k M/S, (k+1) M/S), and only per-row values cross ranks:

  * correspondence search (:func:`sharded_cosine_argmax`): each rank
    runs the similarity argmax (ops/similarity: the CUDA kernel on a
    card, its plain version on the CPU) over its columns and offsets its
    index by k M/S; the row's largest score wins and, among ranks tied on
    it, the lowest global index (JAX's pmax then pmin; the kernel's
    strict ``>`` already gives a tie inside a shard to its lowest
    column).  That is jnp.argmax over all columns;
  * matching loss (:func:`sharded_matching_loss`): the circle loss is
    two masked log-sum-exps per scene row (losses/circle.py).  Each rank
    reduces its columns to a (max, shifted sum of exp) pair, the pairs
    of the row merge with one max and one differentiable sum, and the
    padding column is folded in once, after the merge.  The max is a
    shift without gradient, as JAX's stop_gradient makes it.

Memory per rank is O(B_loc N M / S); the similarity matrix never
crosses ranks.  With one model shard both functions compute what the
dense ones do (pose fit, losses/matching.py), up to f32 reduction order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gdm_tpu_torch.ops.knn import pairwise_sqdist
from gdm_tpu_torch.ops.similarity import cosine_argmax_batched
from gdm_tpu_torch.parallel.mesh import (
    Grid,
    all_reduce_max,
    all_reduce_min,
    all_reduce_sum,
)

_I64_MAX = torch.iinfo(torch.int64).max


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def column_shard(m_total: int, grid: Grid) -> tuple[int, int]:
    """[lo, hi) of this rank's mesh columns."""
    s = grid.model_shards
    if m_total % s:
        raise ValueError(f"{m_total} mesh columns do not split into {s} "
                         "model shards")
    m_loc = m_total // s
    lo = grid.model_rank * m_loc
    return lo, lo + m_loc


def sharded_cosine_argmax(scene_f: torch.Tensor, mesh_f: torch.Tensor,
                          grid: Grid):
    """Per-row argmax of the cosine similarity over the mesh columns,
    split over the model row.

    Args:
      scene_f: [B, N, C] this rank's scene features (normalised here).
      mesh_f: [M, C] the whole mesh features (normalised here); this rank
        takes its columns.  The kernel needs C % 4 == 0: a contiguous
        row slice of them then starts 16-byte aligned.
      grid: parallel/mesh.Grid.
    Returns:
      (idx [B, N] int64 global mesh vertex ids, score [B, N] f32), equal
      on every rank of the model row.
    """
    lo, hi = column_shard(mesh_f.shape[0], grid)
    idx, score = cosine_argmax_batched(_l2norm(scene_f).contiguous(),
                                       _l2norm(mesh_f[lo:hi]).contiguous())
    idx = idx + lo
    best = all_reduce_max(score, grid.model_group)
    cand = torch.where(score == best, idx, torch.full_like(idx, _I64_MAX))
    return all_reduce_min(cand, grid.model_group), best


def _lse_pair(logits: torch.Tensor, mask: torch.Tensor):
    """(max, shifted sum of exp) of a masked LSE over the last axis: the
    pair stands for sum(exp(logits[mask])) = se * exp(mx_safe); an empty
    mask gives (-inf, 0).  The max carries no gradient (the softmax
    weights in ``se`` carry it all)."""
    with torch.no_grad():
        mx = torch.where(mask, logits, torch.full_like(logits, -math.inf)
                         ).amax(dim=-1)
    mx_safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    se = torch.where(mask, torch.exp(logits - mx_safe[..., None]),
                     torch.zeros_like(logits)).sum(dim=-1)
    return mx, se


def _merge_row(mx: torch.Tensor, se: torch.Tensor, group):
    """Merge the pairs of the model row: one max, one rescaled sum."""
    gmx = all_reduce_max(mx, group)
    gmx_safe = torch.where(torch.isfinite(gmx), gmx, torch.zeros_like(gmx))
    mx_safe = torch.where(torch.isfinite(mx), mx, gmx_safe)
    return gmx, all_reduce_sum(se * torch.exp(mx_safe - gmx_safe), group)


def _merge_column(mx, se, logit, mask):
    """Fold one more (replicated) column into a merged pair."""
    with torch.no_grad():
        lmx = torch.where(mask, logit, torch.full_like(logit, -math.inf))
    gmx = torch.maximum(mx, lmx)
    gmx_safe = torch.where(torch.isfinite(gmx), gmx, torch.zeros_like(gmx))
    mx_safe = torch.where(torch.isfinite(mx), mx, gmx_safe)
    se = se * torch.exp(mx_safe - gmx_safe) + torch.where(
        mask, torch.exp(logit - gmx_safe), torch.zeros_like(logit))
    return gmx, se


def _finish_lse(mx, se):
    """masked_logsumexp's finish: mx_safe + log(max(se, 1e-30))."""
    mx_safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    return mx_safe + torch.log(torch.clamp_min(se, 1e-30))


def sharded_matching_loss(
    rgbd_features: torch.Tensor,
    mesh_features: torch.Tensor,
    mesh_xyz: torch.Tensor,
    labels: torch.Tensor,
    match_idx: torch.Tensor,
    visible_flag: torch.Tensor,
    positive_r,
    grid: Grid,
    m: float = 0.2,
    gamma: float = 16.0,
    sym_idx: torch.Tensor | None = None,
    pad_onehot: bool = False,
    rt: torch.Tensor | None = None,
    depth_scaled_r_mm: float | None = None,
) -> torch.Tensor:
    """losses/matching.pointwise_matching_loss of the global batch, with
    the mesh columns split over the model row and the batch over the
    data column.

    Args (this rank's batch rows; the mesh whole):
      rgbd_features: [B, N, C] scene descriptors.
      mesh_features: [M, C] mesh descriptors.
      mesh_xyz: [M, 3] (the GT gather reads any column).
      labels, match_idx: [B, N].
      visible_flag: [B, M].
      positive_r: the radius (neighbor_dis_th * diameter).
      grid: parallel/mesh.Grid.
      sym_idx: optional [M] symmetry table: positives at the match and
        its symmetric counterpart (radius and visibility unused).
      pad_onehot: the padding column is e0 (DGCNN), else -1s.
      rt, depth_scaled_r_mm: DGCNN's radius r_mm / 1000 * z_j of column
        j, z_j its depth under the element's GT pose rt [B, 3, 4].
    Returns:
      the scalar loss, equal on every rank: the mean over the valid
      elements (>= 3 foreground points) of the whole batch of their
      foreground rows' mean.
    """
    m_total, c = mesh_features.shape
    lo, hi = column_shard(m_total, grid)
    b = rgbd_features.shape[0]
    g = _l2norm(mesh_features[lo:hi])                   # [M_loc, C]
    f = _l2norm(rgbd_features)                          # [B, N, C]
    sim = torch.matmul(f, g.T)                          # [B, N, M_loc]
    if pad_onehot:                      # a unit row -> sim with e0
        sim_pad = f[..., 0]
    else:                               # -1s / sqrt(C)
        sim_pad = -torch.sum(f, dim=-1) / math.sqrt(c)

    in_mesh = match_idx != m_total
    safe = torch.clamp(match_idx, 0, m_total - 1).long()
    gcols = torch.arange(lo, hi, device=f.device)
    if sym_idx is not None:
        sidx = sym_idx.long()[safe]                     # [B, N]
        pos = (gcols == safe[..., None]) | (gcols == sidx[..., None])
    else:
        cols = mesh_xyz[lo:hi]
        d2 = pairwise_sqdist(mesh_xyz[safe], cols.expand(b, -1, -1))
        if depth_scaled_r_mm is not None:
            z = torch.matmul(cols, rt[:, 2, :3, None])[..., 0] \
                + rt[:, 2, 3:4]                         # [B, M_loc]
            near = d2 < torch.square((depth_scaled_r_mm / 1000.0) * z
                                     )[:, None, :]
        else:
            r = torch.as_tensor(positive_r, dtype=torch.float32,
                                device=f.device)
            near = d2 < torch.square(r)
        pos = near & (visible_flag[:, lo:hi] > 0)[:, None, :]
    pos = pos & in_mesh[..., None]
    pos_pad = ~in_mesh

    def logits(s):
        ap = torch.clamp_min(1.0 + m - s, 0.0).detach()
        an = torch.clamp_min(s + m, 0.0).detach()
        return -ap * (s - (1.0 - m)) * gamma, an * (s - m) * gamma

    lp, ln = logits(sim)
    lpp, lnp = logits(sim_pad)
    mx_p, se_p = _lse_pair(lp, pos)
    mx_n, se_n = _lse_pair(ln, ~pos)
    # both pairs of every row in one max and one sum over the model row
    mx, se = _merge_row(torch.stack([mx_p, mx_n]), torch.stack([se_p, se_n]),
                        grid.model_group)
    mx_p, se_p = _merge_column(mx[0], se[0], lpp, pos_pad)
    mx_n, se_n = _merge_column(mx[1], se[1], lnp, ~pos_pad)
    per_row = F.softplus(_finish_lse(mx_p, se_p) + _finish_lse(mx_n, se_n))

    row_valid = labels == 1
    n_fg = row_valid.sum(dim=-1)
    elem = (per_row * row_valid).sum(dim=-1) / torch.clamp_min(n_fg, 1)
    w = (n_fg >= 3).to(elem.dtype)
    # per-element values are equal on every rank of the model row; the
    # batch mean is over the data column
    num_den = all_reduce_sum(torch.stack([(elem * w).sum(), w.sum()]),
                             grid.data_group)
    return num_den[0] / torch.clamp_min(num_den[1], 1.0)
