"""Inference body: index pyramid + GeoMatch forward + pose fit.

Counterpart of gdm_tpu/eval/infer.py (exact KNN).
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.data.pipeline import assemble_inputs
from gdm_tpu_torch.eval.pose_fit import fit_poses_from_outputs
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays


@torch.no_grad()
def forward_fit(model: GeoMatch, inputs: dict, cld: torch.Tensor,
                det: torch.Tensor | None, mesh: MeshArrays,
                mesh_feats: torch.Tensor, refine: str | None = None,
                icp_reject=0.01):
    """Model inputs (pyramid included) -> (poses [B, 3, 4], fit).

    ``fit`` holds what the pose fit used: 'rgbd' [B,N,C] and 'mesh' [M,C]
    features, 'w' [B,N] correspondence weights and 'idx' [B,N] matched
    mesh vertices.  ``refine`` and ``icp_reject`` (the ICP gate in
    metres) go to eval/pose_fit.apply_refine."""
    out = model(inputs, mesh, mesh_features=mesh_feats)
    poses, w, idx = fit_poses_from_outputs(
        cld, out, mesh.xyz, det=det, refine=refine,
        icp_reject_dist=icp_reject)
    return poses, {"rgbd": out["rgbd"], "mesh": out["mesh"], "w": w,
                   "idx": idx}


@torch.no_grad()
def run_inference(model: GeoMatch, fin: dict, mesh: MeshArrays,
                  mesh_feats: torch.Tensor, knn_chunk: int = 1024,
                  refine: str | None = None, icp_reject=0.01):
    """Finalized batch -> (poses [B, 3, 4], fit): :func:`forward_fit` of
    the batch's inputs.  ``knn_chunk`` queries per distance block of the
    KNN pyramid bounds its peak memory and changes no result."""
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], knn_chunk)
    return forward_fit(model, inputs, fin["cld_rgb_nrm"][..., :3],
                       fin.get("det"), mesh, mesh_feats, refine, icp_reject)
