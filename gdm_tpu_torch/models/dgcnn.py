"""DGCNN edge-conv encoders, channels-last.

Counterpart of gdm_tpu/models/dgcnn.py (reference models/dgcnn.py):
KNN graphs built on the fly by an exact dense top-k, edge features
[x_j - x_i, x_i], five edge convs with max-pools over the neighbours, a
1024-d global max embedding and the 1216-d fused head.
:class:`DgcnnPointEmb` is the scene branch (its first graph over xyz
only), :class:`DgcnnMeshEmb` the mesh branch over the object's fps
vertices.

Parameter names are the reference's: ``convN`` (N <= 8) is
``Sequential(conv, bn, LeakyReLU(0.2))``, so its tensors are
``convN.0.weight`` and ``convN.1.*``, and ``conv9`` is a bare conv.  The
reference also registers each BN as ``bnN``; gdm_tpu_torch.weights folds
that second name.  BN eps is 1e-5 (not the RandLA blocks' 1e-6), and
batch norm reduces over batch, points and neighbours, as the reference's
BatchNorm2d does.

The graphs are exact: the JAX package's default ``approx_max_k`` graphs
(recall 0.85) have no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from gdm_tpu_torch.models.layers import BatchNorm, Dense, Dropout, \
    gather_rows
from gdm_tpu_torch.ops.knn import knn


def graph_feature_b(x: torch.Tensor, k: int, pos: torch.Tensor | None = None,
                    knn_chunk: int = 1024):
    """Batched edge features [B, n, k, 2c] = [x_j - x_i, x_i], and the
    graph [B, n, k] int64.

    ``pos`` is the KNN coordinate space (the scene's first graph uses
    xyz only); it defaults to ``x``.  Neighbours come in ascending
    distance (the expanded |a|^2 - 2ab + |b|^2 in f32), ties to the lowest
    index, so the point itself is neighbour 0 and its edge is (0, x_i).
    ``knn_chunk`` queries per distance block bound peak memory and change
    no result.  No gradient flows through the graph, so it is built
    without autograd."""
    with torch.no_grad():
        coords = (x if pos is None else pos).to(torch.float32)
        idx = knn(coords, coords, k, knn_chunk)
    xj = gather_rows(x, idx)
    xi = x[:, :, None, :].expand_as(xj)
    return torch.cat([xj - xi, xi], dim=-1), idx


def _conv_bn_lrelu(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(Dense(c_in, c_out, bias=False),
                         BatchNorm(c_out, eps=1e-5), nn.LeakyReLU(0.2))


class DgcnnTrunk(nn.Module):
    """The EdgeConv trunk of both branches (reference dgcnn.py:103-137):
    [B, n, 9] xyz | rgb | normal -> [B, n, feat_dim]."""

    def __init__(self, k: int = 16, embed_dim: int = 1024,
                 feat_dim: int = 128, dropout: float = 0.1):
        super().__init__()
        self.k = k
        self.conv1 = _conv_bn_lrelu(18, 64)
        self.conv2 = _conv_bn_lrelu(64, 64)
        self.conv3 = _conv_bn_lrelu(128, 64)
        self.conv4 = _conv_bn_lrelu(64, 64)
        self.conv5 = _conv_bn_lrelu(128, 64)
        self.conv6 = _conv_bn_lrelu(192, embed_dim)
        self.conv7 = _conv_bn_lrelu(embed_dim + 192, 512)
        self.conv8 = _conv_bn_lrelu(512, 256)
        self.dp1 = Dropout(dropout)
        self.conv9 = Dense(256, feat_dim, bias=False)

    def forward(self, cloud: torch.Tensor,
                knn_chunk: int = 1024) -> torch.Tensor:
        def edges(x, pos=None):
            return graph_feature_b(x, self.k, pos, knn_chunk)[0]

        e = edges(cloud, cloud[..., :3])                    # [B, n, k, 18]
        x1 = self.conv2(self.conv1(e)).amax(dim=2)
        x2 = self.conv4(self.conv3(edges(x1))).amax(dim=2)
        x3 = self.conv5(edges(x2)).amax(dim=2)
        cat = torch.cat([x1, x2, x3], dim=-1)               # [B, n, 192]
        g = self.conv6(cat).amax(dim=1, keepdim=True)       # global embed
        h = torch.cat([g.expand(-1, cat.shape[1], -1), cat], dim=-1)
        h = self.conv8(self.conv7(h))                       # [B, n, 256]
        return self.conv9(self.dp1(h))


class DgcnnPointEmb(DgcnnTrunk):
    """Scene branch (k 16): [B, n, 9] -> [B, n, feat_dim]."""


class DgcnnMeshEmb(DgcnnTrunk):
    """Mesh branch (k 20): mesh_x [M, 9] (xyz m | ImageNet-normalised rgb
    | normal) -> [M, feat_dim], the trunk on a batch of one."""

    def __init__(self, k: int = 20, embed_dim: int = 1024,
                 feat_dim: int = 128, dropout: float = 0.1):
        super().__init__(k, embed_dim, feat_dim, dropout)

    def forward(self, mesh_x: torch.Tensor,
                knn_chunk: int = 1024) -> torch.Tensor:
        return super().forward(mesh_x[None], knn_chunk)[0]
