"""Inference body: index pyramid + GeoMatch forward + pose fit.

Counterpart of gdm_tpu/eval/infer.py (exact KNN, refine=None).
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.data.pipeline import assemble_inputs
from gdm_tpu_torch.eval.pose_fit import fit_poses_from_outputs
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays


@torch.no_grad()
def run_inference(model: GeoMatch, fin: dict, mesh: MeshArrays,
                  mesh_feats: torch.Tensor, knn_chunk: int = 1024):
    """Finalized batch -> (poses [B, 3, 4], fit).

    ``knn_chunk`` queries per distance block of the KNN pyramid bounds
    its peak memory and changes no result.

    ``fit`` holds what the pose fit used: 'rgbd' [B,N,C] and 'mesh' [M,C]
    features, 'w' [B,N] correspondence weights and 'idx' [B,N] matched
    mesh vertices."""
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], knn_chunk)
    out = model(inputs, mesh, mesh_features=mesh_feats)
    poses, w, idx = fit_poses_from_outputs(
        fin["cld_rgb_nrm"][..., :3], out, mesh.xyz, det=fin.get("det"))
    return poses, {"rgbd": out["rgbd"], "mesh": out["mesh"], "w": w,
                   "idx": idx}
