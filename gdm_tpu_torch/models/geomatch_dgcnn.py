"""GeoMatchDGCNN: the DGCNN backbone variant of GeoMatch (config 5).

Counterpart of gdm_tpu/models/geomatch_dgcnn.py (reference
models/geoMatch_DGCNN.py).  Both branches are DGCNN edge-conv trunks
(models/dgcnn.py); the heads are GeoMatch's.  It reads no KNN pyramid:
the scene branch takes ``inputs['cld_rgb_nrm']`` alone, and the mesh
branch ``mesh_x`` [M, 9] (xyz in metres | ImageNet-normalised rgb |
normal, :func:`mesh_input`), which does not depend on the batch, so
serving encodes it once per object.

Training (``forward(..., train=True)``, geoMatch_DGCNN.py:92-121) differs
from GeoMatch's: the matching loss takes the one-hot padding column and
the depth-scaled 3 mm radius under the GT pose ``inputs['RT']``, its rows
are valid where ``inputs['origin_labels'] == 1``, and the mesh positions
of the loss are ``mesh_x[:, :3]``.  ``awl.params`` exists only in a model
built with ``awl=True``.
In a multi-process run (``grid``) its losses are those of the global
batch, as GeoMatch's.

``compute_dtype`` (torch.bfloat16, or None for the parameters' dtype)
narrows both trunks, the mesh branch's too (unlike the flagship's), as
gdm_tpu/models/geomatch_dgcnn.py does; the scene embedding and the mesh
features are widened to f32 before the heads and the loss.  The gathers'
backward keeps the cotangent's dtype: the JAX CLI sets its
``gather_bwd_dtype`` switch for the flagship only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gdm_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from gdm_tpu_torch.losses import (
    AutomaticWeightedLoss,
    focal_loss,
    grid_matching_loss,
)
from gdm_tpu_torch.models.dgcnn import DgcnnMeshEmb, DgcnnPointEmb
from gdm_tpu_torch.models.layers import DenseBNAct, MLPHead


def mesh_input(mesh_fps_m: np.ndarray) -> np.ndarray:
    """[m, 9] f32 mesh input of an fps array whose xyz are in metres
    (what data.ply.load_or_build_fps_mesh returns): xyz | (rgb / 255 -
    mean) / std | normal (gdm_tpu/cli.py:146-151)."""
    rgb_n = (mesh_fps_m[:, 3:6] / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return np.concatenate([mesh_fps_m[:, :3], rgb_n, mesh_fps_m[:, 6:9]],
                          axis=1).astype(np.float32)


class GeoMatchDGCNN(nn.Module):
    """``forward`` returns {'seg' [B,N,2], 'rgbd' [B,N,feat_dim], 'mesh'
    [M,feat_dim]}, and with ``train=True`` also 'loss', 'seg_loss' and
    'match_loss'.

    Args:
      k_scene, k_mesh: graph neighbours of the two branches.
      positive_r_mm: the depth-scaled radius, mm per metre of depth.
      awl: hold the loss weighting ``awl.params`` (training).
    """

    def __init__(self, feat_dim: int = 128, k_scene: int = 16,
                 k_mesh: int = 20, positive_r_mm: float = 3.0,
                 awl: bool = False, circle_m: float = 0.2,
                 circle_gamma: float = 16.0,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.positive_r_mm = positive_r_mm
        self.circle_m, self.circle_gamma = circle_m, circle_gamma
        self.compute_dtype = compute_dtype
        self.pcd_emb = DgcnnPointEmb(k_scene, feat_dim=feat_dim,
                                     dtype=compute_dtype)
        self.model_emb = DgcnnMeshEmb(k_mesh, feat_dim=feat_dim,
                                      dtype=compute_dtype)
        self.awl = AutomaticWeightedLoss(2) if awl else None
        self.feature_encoding_layer = MLPHead(
            feat_dim, (128, 128, 128, feat_dim), final_bias=False)
        self.normalize_feature_layer = DenseBNAct(feat_dim, feat_dim)
        self.seg_layer = MLPHead(feat_dim, (128, 128, 128, 2))
        # the ranks of a multi-process run (parallel/mesh.attach), or None
        self.grid = None

    def encode_mesh(self, mesh_x: torch.Tensor,
                    knn_chunk: int = 1024) -> torch.Tensor:
        """Mesh branch alone: [M, feat_dim]."""
        return self._widen(self.model_emb(mesh_x, knn_chunk))

    def _widen(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.float()

    def forward(self, inputs: dict, mesh_x: torch.Tensor,
                mesh_features: torch.Tensor | None = None,
                train: bool = False, knn_chunk: int = 1024) -> dict:
        """``knn_chunk`` queries per distance block of the graphs bound
        peak memory and change no result."""
        rgbd_emb = self._widen(self.pcd_emb(inputs["cld_rgb_nrm"],
                                            knn_chunk))
        if mesh_features is None:
            mesh_features = self.encode_mesh(mesh_x, knn_chunk)
        rgbd_features = self.feature_encoding_layer(rgbd_emb)
        rgbd_emb = rgbd_emb + self.normalize_feature_layer(rgbd_features)
        out = {"seg": self.seg_layer(rgbd_emb), "mesh": mesh_features,
               "rgbd": rgbd_features}
        if train:
            if self.awl is None:
                raise RuntimeError("train=True needs a GeoMatchDGCNN built "
                                   "with awl=True")
            match_loss = grid_matching_loss(
                self.grid, rgbd_features, mesh_features, mesh_x[:, :3],
                inputs["origin_labels"], inputs["match_idx"],
                inputs["visible_flag"], 0.0, m=self.circle_m,
                gamma=self.circle_gamma, pad_onehot=True, rt=inputs["RT"],
                depth_scaled_r_mm=self.positive_r_mm)
            seg_loss = focal_loss(out["seg"], inputs["labels"], gamma=2.0,
                                  group=self.grid and self.grid.data_group)
            out["loss"] = self.awl(seg_loss, match_loss)
            out["seg_loss"] = seg_loss
            out["match_loss"] = match_loss
        return out
