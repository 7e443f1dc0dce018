"""RandLA-Net point branch, channels-last [B, N, C].

Counterpart of gdm_tpu/models/randla.py: neighbour gathers are plain
indexed loads, [B, N, C] by [B, M, K] -> [B, M, K, C], whose backward
rounds to ``gather_bwd_dtype`` as the JAX package's does
(models/layers.gather_rows).  Every block uses BN eps 1e-6 and
LeakyReLU(0.2) (models/RandLA pytorch_utils conventions).

Under a compute dtype (``dtype``, bfloat16) the building block gathers
xyz and the features from one f32 concatenation, casts the neighbour
features back to the features' dtype and builds the relative position
code in f32 before its first layer narrows it: xyz are never rounded to
bf16 (~1 mm deltas on ~0.1 m coordinates would lose ~40%).
"""

from __future__ import annotations

import torch
from torch import nn

from gdm_tpu_torch.models.layers import (
    Dense,
    cast,
    gather_rows,
    leaky_relu02,
    randla_dense,
    softmax,
    weighted_sum,
)


def max_pool_neighbours(feats: torch.Tensor, pool_idx: torch.Tensor,
                        bwd_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """Gather [B, M, K] neighbour features and max over K -> [B, M, C]."""
    return gather_rows(feats, pool_idx, bwd_dtype).amax(dim=2)


def nearest_upsample(feats: torch.Tensor, interp_idx: torch.Tensor,
                     bwd_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, M, 1] or [B, M] nearest-neighbour gather -> [B, M, C]."""
    if interp_idx.dim() == 3:
        interp_idx = interp_idx[..., 0]
    return gather_rows(feats, interp_idx, bwd_dtype)


class AttPooling(nn.Module):
    """Attentive pooling over the K axis: softmax(fc(x)) weights."""

    def __init__(self, d_in: int, d_out: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc = Dense(d_in, d_in, bias=False, dtype=dtype)
        self.mlp = randla_dense(d_in, d_out, dtype=dtype)

    def forward(self, x):                                  # [B, N, K, C]
        scores = softmax(self.fc(x), 2)
        return self.mlp(weighted_sum(x, scores, 2))


class BuildingBlock(nn.Module):
    """Local feature aggregation with the 10-d relative position code
    [dist, xyz - neigh, xyz, neigh]."""

    def __init__(self, d_out: int, dtype: torch.dtype | None = None,
                 gather_bwd_dtype: torch.dtype | None = None):
        super().__init__()
        half = d_out // 2
        self.dtype, self.gather_bwd_dtype = dtype, gather_bwd_dtype
        self.mlp1 = randla_dense(10, half, dtype=dtype)
        self.att_pooling_1 = AttPooling(d_out, half, dtype)
        self.mlp2 = randla_dense(half, half, dtype=dtype)
        self.att_pooling_2 = AttPooling(d_out, d_out, dtype)

    def forward(self, xyz, feats, neigh_idx):
        # xyz and feats share neigh_idx: one gather of the concatenation,
        # in xyz's dtype (f32)
        bwd = self.gather_bwd_dtype
        both = gather_rows(torch.cat([xyz, feats.to(xyz.dtype)], dim=-1),
                           neigh_idx, bwd)
        neigh_xyz, f_neigh = both[..., :3], both[..., 3:].to(feats.dtype)
        xyz_tile = xyz[:, :, None, :].expand_as(neigh_xyz)
        rel = xyz_tile - neigh_xyz
        dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
        f_xyz = cast(torch.cat([dist, rel, xyz_tile, neigh_xyz], dim=-1),
                     self.dtype)

        f_xyz1 = self.mlp1(f_xyz)
        agg1 = self.att_pooling_1(torch.cat([f_neigh, f_xyz1], dim=-1))
        f_xyz2 = self.mlp2(f_xyz1)
        f_neigh2 = gather_rows(agg1, neigh_idx, bwd)
        return self.att_pooling_2(torch.cat([f_neigh2, f_xyz2], dim=-1))


class DilatedResBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int,
                 dtype: torch.dtype | None = None,
                 gather_bwd_dtype: torch.dtype | None = None):
        super().__init__()
        self.mlp1 = randla_dense(d_in, d_out // 2, dtype=dtype)
        self.lfa = BuildingBlock(d_out, dtype, gather_bwd_dtype)
        self.mlp2 = randla_dense(d_out, 2 * d_out, act=None, dtype=dtype)
        self.shortcut = randla_dense(d_in, 2 * d_out, act=None, dtype=dtype)

    def forward(self, feats, xyz, neigh_idx):
        f = self.lfa(xyz, self.mlp1(feats), neigh_idx)
        return leaky_relu02(self.mlp2(f) + self.shortcut(feats))


def decoder_widths(d_out) -> list[int]:
    """Decoder output widths (RandLANet.py:31-39): 2*d_out[-j-2] for the
    first three, then 2*d_out[0]."""
    return [2 * d_out[-j - 2] if j < 3 else 2 * d_out[0]
            for j in range(len(d_out))]
