"""The model of a configuration and its mesh input.

Counterpart of gdm_tpu/cli.py ``_make_model``: ``config.model.backbone``
picks GeoMatch (``randla_spline``: the mesh goes in as its SplineCNN
graph, the scene through the KNN pyramid) or GeoMatchDGCNN (``dgcnn``:
the mesh goes in as the [M, 9] node features in metres, the scene as
``cld_rgb_nrm`` alone).  The engine and ``cli train`` build through it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN, mesh_input
from gdm_tpu_torch.models.spline_mesh import build_mesh_graph


class ModelSetup(NamedTuple):
    model: nn.Module              # on the CPU; the caller moves it
    mesh: MeshArrays | torch.Tensor   # the model's mesh input, on device
    mesh_xyz: torch.Tensor        # [M, 3] metres: the fit's mesh points
    needs_pyramid: bool           # the scene input holds the KNN pyramid


def build_model(config, mesh_fps_mm: np.ndarray, device, awl: bool = False,
                sym_transform: tuple | None = None) -> ModelSetup:
    """The configured model and its mesh input on ``device``.

    Args:
      config: gdm_tpu_torch.configs.Config (model widths, backbone).
      mesh_fps_mm: [m, 9] object array in the obj_XXXXXX_fps.npy layout:
        xyz in **millimetres** | rgb 0..255 | normal.  An object less
        than 1 mm across is refused: its xyz are in metres.
      awl: build the loss weighting (a training model).
      sym_transform: the flagship's discrete symmetry (R, t_mm), or None.
    """
    m = config.model
    fps = np.asarray(mesh_fps_mm)[:m.n_mesh_node]
    if np.abs(fps[:, :3]).max() < 1.0:
        raise ValueError("mesh_fps_mm: xyz must be in millimetres (the "
                         "fps.npy layout); this object is under 1 mm "
                         "across, so its xyz look like metres")
    if m.backbone == "dgcnn":
        fps_m = np.concatenate([fps[:, :3] / 1000.0, fps[:, 3:]], axis=1)
        mesh_x = torch.as_tensor(mesh_input(fps_m), device=device)
        return ModelSetup(GeoMatchDGCNN(m.feat_dim, awl=awl), mesh_x,
                          mesh_x[:, :3], False)
    mesh = MeshArrays.from_graph(build_mesh_graph(
        fps, m.n_mesh_node, kernel_size=m.spline_kernel, k=m.mesh_knn_k,
        sym_transform=sym_transform), device)
    model = GeoMatch(m.feat_dim, tuple(m.randla_d_out),
                     spline_kernel=m.spline_kernel, awl=awl)
    return ModelSetup(model, mesh, mesh.xyz, True)
