"""SplineCNN mesh encoder over a static KNN-4 object-mesh graph.

Counterpart of gdm_tpu/models/spline_mesh.py.  ``build_mesh_graph`` is a
numpy copy of the JAX package's host build (which cannot be imported
without jax); its exact KNN is a brute-force numpy search, and the tests
hold the two builds bit-equal.  Node features are
[imagenet-normalised rgb, xyz in metres, normal] (9-d).  With a symmetry
transform the graph also holds ``sym_idx``, each vertex's nearest
vertex under the symmetry, which the symmetric matching loss reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gdm_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from gdm_tpu_torch.models.layers import Dense, Dropout
from gdm_tpu_torch.ops.spline_basis import (
    cartesian_pseudo,
    spline_basis_np,
    spline_conv_dense,
)


@dataclasses.dataclass(frozen=True)
class MeshGraph:
    """Static per-object mesh graph (host numpy arrays)."""

    xyz: np.ndarray          # [n, 3] metres
    node_x: np.ndarray       # [n, 9] rgb_norm | xyz | normal
    neigh_idx: np.ndarray    # [n, k] KNN sources
    basis: np.ndarray        # [n, k, 8]
    slot: np.ndarray         # [n, k, 8]
    sym_idx: np.ndarray | None = None   # [n] symmetry correspondence


def knn_np(pts: np.ndarray, k: int, chunk: int = 256,
           query: np.ndarray | None = None) -> np.ndarray:
    """Exact KNN on the host: support [n, 3], queries (default: the
    support itself) -> idx [m, k] by ascending squared distance, ties to
    the lower index (a stable sort of each distance row); rows of
    ``chunk`` queries bound the scratch memory.  With k > n the last
    neighbour repeats, as in gdm_tpu.native.knn."""
    pts = np.ascontiguousarray(pts, np.float32)
    query = pts if query is None else np.ascontiguousarray(query, np.float32)
    k_eff = min(k, len(pts))
    out = []
    for i in range(0, len(query), chunk):
        d2 = None
        for j in range(pts.shape[1]):               # ((dx^2 + dy^2) + dz^2)
            dj = query[i:i + chunk, None, j] - pts[None, :, j]
            d2 = dj * dj if d2 is None else d2 + dj * dj
        # every entry at or below a row's k-th smallest distance (ties
        # included) is a candidate; sorted by (row, distance, index), the
        # first k of each row are those of a stable sort of the whole row
        kth = np.partition(d2, k_eff - 1, axis=1)[:, k_eff - 1:k_eff]
        rows, cols = np.nonzero(d2 <= kth)
        order = np.lexsort((cols, d2[rows, cols], rows))
        start = np.searchsorted(rows[order], np.arange(len(d2)))
        out.append(cols[order][start[:, None] + np.arange(k_eff)])
    idx = np.concatenate(out).astype(np.int32)
    if idx.shape[1] < k:
        idx = np.concatenate(
            [idx, np.repeat(idx[:, -1:], k - idx.shape[1], 1)], axis=1)
    return idx


def build_mesh_graph(fps_data: np.ndarray, n_nodes: int,
                     kernel_size: int = 5, k: int = 4,
                     sym_transform: tuple | None = None) -> MeshGraph:
    """The static graph of an ``obj_XXXXXX_fps.npy`` array.

    Args:
      fps_data: [m, 9]: xyz in mm, rgb 0..255, normals.
      n_nodes: vertices to keep (config ``model.n_mesh_node``).
      sym_transform: optional (R [3, 3], t_mm [3]) discrete symmetry;
        builds the sys_corr_idx table (SplineCNN.py:163-169).
    """
    pts = fps_data[:n_nodes, :3].astype(np.float32) / 1000.0
    rgb = fps_data[:n_nodes, 3:6].astype(np.float32)
    nrm = fps_data[:n_nodes, 6:9].astype(np.float32)
    rgb_n = (rgb / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    node_x = np.concatenate([rgb_n, pts, nrm], axis=1).astype(np.float32)

    neigh = knn_np(pts, k + 1)[:, 1:]
    basis, slot = spline_basis_np(cartesian_pseudo(pts, neigh),
                                  kernel_size=kernel_size)
    sym_idx = None
    if sym_transform is not None:
        R, t_mm = sym_transform
        sym_pts = pts @ np.asarray(R).T \
            + np.asarray(t_mm).reshape(1, 3) / 1000.0
        sym_idx = knn_np(pts, 1, query=sym_pts)[:, 0].astype(np.int32)
    return MeshGraph(xyz=pts, node_x=node_x, neigh_idx=neigh, basis=basis,
                     slot=slot, sym_idx=sym_idx)


class SplineConv(nn.Module):
    """One SplineConv layer: ``weight`` [K**3, in, out], ``root``
    [in, out], ``bias`` [out] (torch_geometric names)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_size ** 3, c_in,
                                               c_out))
        self.root = nn.Parameter(torch.empty(c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x, neigh_idx, basis, slot):
        return spline_conv_dense(x, neigh_idx, basis, slot, self.weight,
                                 self.root, self.bias)


class SplineMeshEncoder(nn.Module):
    """3 SplineConv + ReLU layers, concat skip [x, h1, h2, h3], dropout
    (training mode only), Linear -> [n, feat_dim]."""

    def __init__(self, c_in: int = 9, feat_dim: int = 128,
                 kernel_size: int = 5):
        super().__init__()
        widths = [c_in] + [feat_dim] * 3
        self.mesh_convs = nn.ModuleList(
            SplineConv(i, o, kernel_size) for i, o in zip(widths, widths[1:]))
        self.drop = Dropout(0.1)   # gdm_tpu/models/spline_mesh.py:140
        self.mesh_final = Dense(sum(widths), feat_dim)

    def forward(self, node_x, neigh_idx, basis, slot):
        feats = [node_x]
        x = node_x
        for conv in self.mesh_convs:
            x = F.relu(conv(x, neigh_idx, basis, slot))
            feats.append(x)
        return self.mesh_final(self.drop(torch.cat(feats, dim=-1)))
