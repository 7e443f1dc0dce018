"""GeoMatch at eval: FFB6D scene branch + SplineCNN mesh branch + heads.

Counterpart of gdm_tpu/models/geomatch.py (the RandLA + SplineCNN
flagship).  The mesh branch does not depend on the batch, so serving
calls :meth:`GeoMatch.encode_mesh` once per object and passes the
features to every forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gdm_tpu_torch.models.ffb6d import FFB6DEmb
from gdm_tpu_torch.models.layers import DenseBNAct, MLPHead
from gdm_tpu_torch.models.spline_mesh import MeshGraph, SplineMeshEncoder


class MeshArrays(NamedTuple):
    """Device-side constants of one object's mesh graph."""

    xyz: torch.Tensor        # [m, 3] f32
    node_x: torch.Tensor     # [m, 9] f32
    neigh_idx: torch.Tensor  # [m, k] int64
    basis: torch.Tensor      # [m, k, 8] f32
    slot: torch.Tensor       # [m, k, 8] int64

    @classmethod
    def from_graph(cls, g: MeshGraph, device) -> "MeshArrays":
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def i64(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        return cls(xyz=f32(g.xyz), node_x=f32(g.node_x),
                   neigh_idx=i64(g.neigh_idx), basis=f32(g.basis),
                   slot=i64(g.slot))


class GeoMatch(nn.Module):
    """Eval-mode GeoMatch.  ``forward`` returns {'seg' [B,N,2],
    'rgbd' [B,N,feat_dim], 'mesh' [M,feat_dim]}."""

    def __init__(self, feat_dim: int = 128, d_out=(32, 64, 128, 256),
                 spline_kernel: int = 5):
        super().__init__()
        self.pcd_emb = FFB6DEmb(d_out)
        self.model_emb = SplineMeshEncoder(9, feat_dim, spline_kernel)
        self.feature_encoding_layer = MLPHead(
            128, (128, 128, 128, feat_dim), final_bias=False)
        self.normalize_feature_layer = DenseBNAct(feat_dim, feat_dim)
        self.seg_layer = MLPHead(128, (128, 128, 128, 2))

    def encode_mesh(self, mesh: MeshArrays) -> torch.Tensor:
        """Mesh branch alone: [M, feat_dim]."""
        return self.model_emb(mesh.node_x, mesh.neigh_idx, mesh.basis,
                              mesh.slot)

    def forward(self, inputs: dict, mesh: MeshArrays,
                mesh_features: torch.Tensor | None = None) -> dict:
        rgbd_emb = self.pcd_emb(inputs)                           # [B,N,128]
        if mesh_features is None:
            mesh_features = self.encode_mesh(mesh)
        rgbd_features = self.feature_encoding_layer(rgbd_emb)
        rgbd_emb = rgbd_emb + self.normalize_feature_layer(rgbd_features)
        return {"seg": self.seg_layer(rgbd_emb), "mesh": mesh_features,
                "rgbd": rgbd_features}
