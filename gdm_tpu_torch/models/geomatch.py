"""GeoMatch: FFB6D scene branch + SplineCNN mesh branch + heads.

Counterpart of gdm_tpu/models/geomatch.py (the RandLA + SplineCNN
flagship).  The mesh branch does not depend on the batch, so serving
calls :meth:`GeoMatch.encode_mesh` once per object and passes the
features to every forward.  ``forward(..., train=True)`` adds the
training losses (geomatch.py:111-131): the circle matching loss, the
focal seg loss and their uncertainty weighting, whose parameter
``awl.params`` exists only in a model built with ``awl=True``, so the
eval model's state dict stays the one inference loads.

``compute_dtype`` (torch.bfloat16, or None for the parameters' dtype) is
the scene encoder's (gdm_tpu/models/geomatch.py ``compute_dtype``): its
output is widened to f32 before the heads, and the heads, the losses and
the SplineCNN mesh branch compute in f32.  ``gather_bwd_dtype`` is the
encoder's gather backward (models/layers.gather_rows).  Parameters stay
f32 either way, so checkpoints do not depend on either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gdm_tpu_torch.losses import (
    AutomaticWeightedLoss,
    focal_loss,
    pointwise_matching_loss,
)
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
    sym_idx: torch.Tensor | None = None   # [m] int64, symmetric objects

    @classmethod
    def from_graph(cls, g: MeshGraph, device) -> "MeshArrays":
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def i64(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        return cls(xyz=f32(g.xyz), node_x=f32(g.node_x),
                   neigh_idx=i64(g.neigh_idx), basis=f32(g.basis),
                   slot=i64(g.slot),
                   sym_idx=None if g.sym_idx is None else i64(g.sym_idx))


class GeoMatch(nn.Module):
    """GeoMatch.  ``forward`` returns {'seg' [B,N,2], 'rgbd'
    [B,N,feat_dim], 'mesh' [M,feat_dim]}, and with ``train=True`` also
    'loss', 'seg_loss' and 'match_loss'.

    Args:
      awl: hold the loss weighting ``awl.params`` (training).
      circle_m, circle_gamma: circle-loss margin and scale.
    """

    def __init__(self, feat_dim: int = 128, d_out=(32, 64, 128, 256),
                 spline_kernel: int = 5, awl: bool = False,
                 circle_m: float = 0.2,
                 circle_gamma: float = 16.0,
                 compute_dtype: torch.dtype | None = None,
                 gather_bwd_dtype: torch.dtype | None = None):
        super().__init__()
        self.circle_m, self.circle_gamma = circle_m, circle_gamma
        self.compute_dtype = compute_dtype
        self.pcd_emb = FFB6DEmb(d_out, compute_dtype, gather_bwd_dtype)
        self.model_emb = SplineMeshEncoder(9, feat_dim, spline_kernel)
        self.awl = AutomaticWeightedLoss(2) if awl else None
        self.feature_encoding_layer = MLPHead(
            128, (128, 128, 128, feat_dim), final_bias=False)
        self.normalize_feature_layer = DenseBNAct(feat_dim, feat_dim)
        self.seg_layer = MLPHead(128, (128, 128, 128, 2))

    def encode_mesh(self, mesh: MeshArrays) -> torch.Tensor:
        """Mesh branch alone: [M, feat_dim]."""
        return self.model_emb(mesh.node_x, mesh.neigh_idx, mesh.basis,
                              mesh.slot)

    def forward(self, inputs: dict, mesh: MeshArrays,
                mesh_features: torch.Tensor | None = None,
                train: bool = False) -> dict:
        rgbd_emb = self.pcd_emb(inputs)                           # [B,N,128]
        if self.compute_dtype is not None:
            rgbd_emb = rgbd_emb.float()
        if mesh_features is None:
            mesh_features = self.encode_mesh(mesh)
        rgbd_features = self.feature_encoding_layer(rgbd_emb)
        rgbd_emb = rgbd_emb + self.normalize_feature_layer(rgbd_features)
        out = {"seg": self.seg_layer(rgbd_emb), "mesh": mesh_features,
               "rgbd": rgbd_features}
        if train:
            if self.awl is None:
                raise RuntimeError("train=True needs a GeoMatch built with "
                                   "awl=True")
            # positive_r (neighbor_dis_th x diameter) rides in the inputs:
            # it differs per object
            match_loss = pointwise_matching_loss(
                rgbd_features, mesh_features, mesh.xyz, inputs["labels"],
                inputs["match_idx"], inputs["visible_flag"],
                inputs["positive_r"], sym_idx=mesh.sym_idx,
                m=self.circle_m, gamma=self.circle_gamma)
            seg_loss = focal_loss(out["seg"], inputs["labels"], gamma=2.0)
            out["loss"] = self.awl(seg_loss, match_loss)
            out["seg_loss"] = seg_loss
            out["match_loss"] = match_loss
        return out
