"""RandLA-Net point branch (eval forward), channels-last [B, N, C].

Counterpart of gdm_tpu/models/randla.py (forward only): neighbour
gathers are plain indexed loads, [B, N, C] by [B, M, K] -> [B, M, K, C].
Every block uses BN eps 1e-6 and LeakyReLU(0.2) (models/RandLA
pytorch_utils conventions).
"""

from __future__ import annotations

import torch
from torch import nn

from gdm_tpu_torch.models.layers import (
    Dense,
    gather_rows,
    leaky_relu02,
    randla_dense,
)


def max_pool_neighbours(feats: torch.Tensor,
                        pool_idx: torch.Tensor) -> torch.Tensor:
    """Gather [B, M, K] neighbour features and max over K -> [B, M, C]."""
    return gather_rows(feats, pool_idx).amax(dim=2)


def nearest_upsample(feats: torch.Tensor,
                     interp_idx: torch.Tensor) -> torch.Tensor:
    """[B, M, 1] or [B, M] nearest-neighbour gather -> [B, M, C]."""
    if interp_idx.dim() == 3:
        interp_idx = interp_idx[..., 0]
    return gather_rows(feats, interp_idx)


class AttPooling(nn.Module):
    """Attentive pooling over the K axis: softmax(fc(x)) weights."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.fc = Dense(d_in, d_in, bias=False)
        self.mlp = randla_dense(d_in, d_out)

    def forward(self, x):                                  # [B, N, K, C]
        scores = torch.softmax(self.fc(x), dim=2)
        return self.mlp(torch.sum(x * scores, dim=2))


class BuildingBlock(nn.Module):
    """Local feature aggregation with the 10-d relative position code
    [dist, xyz - neigh, xyz, neigh]."""

    def __init__(self, d_out: int):
        super().__init__()
        half = d_out // 2
        self.mlp1 = randla_dense(10, half)
        self.att_pooling_1 = AttPooling(d_out, half)
        self.mlp2 = randla_dense(half, half)
        self.att_pooling_2 = AttPooling(d_out, d_out)

    def forward(self, xyz, feats, neigh_idx):
        # xyz and feats share neigh_idx: one gather of the concatenation
        both = gather_rows(torch.cat([xyz, feats], dim=-1), neigh_idx)
        neigh_xyz, f_neigh = both[..., :3], both[..., 3:]
        xyz_tile = xyz[:, :, None, :].expand_as(neigh_xyz)
        rel = xyz_tile - neigh_xyz
        dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
        f_xyz = torch.cat([dist, rel, xyz_tile, neigh_xyz], dim=-1)

        f_xyz1 = self.mlp1(f_xyz)
        agg1 = self.att_pooling_1(torch.cat([f_neigh, f_xyz1], dim=-1))
        f_xyz2 = self.mlp2(f_xyz1)
        f_neigh2 = gather_rows(agg1, neigh_idx)
        return self.att_pooling_2(torch.cat([f_neigh2, f_xyz2], dim=-1))


class DilatedResBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.mlp1 = randla_dense(d_in, d_out // 2)
        self.lfa = BuildingBlock(d_out)
        self.mlp2 = randla_dense(d_out, 2 * d_out, act=None)
        self.shortcut = randla_dense(d_in, 2 * d_out, act=None)

    def forward(self, feats, xyz, neigh_idx):
        f = self.lfa(xyz, self.mlp1(feats), neigh_idx)
        return leaky_relu02(self.mlp2(f) + self.shortcut(feats))


def decoder_widths(d_out) -> list[int]:
    """Decoder output widths (RandLANet.py:31-39): 2*d_out[-j-2] for the
    first three, then 2*d_out[0]."""
    return [2 * d_out[-j - 2] if j < 3 else 2 * d_out[0]
            for j in range(len(d_out))]
