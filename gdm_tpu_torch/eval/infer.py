"""Inference body: model inputs + forward + pose fit.

Counterpart of gdm_tpu/eval/infer.py (exact KNN): the flagship's inputs
carry the KNN index pyramid, DGCNN's only ``cld_rgb_nrm``
(``needs_pyramid`` False).  The fit is the same for both.
"""

from __future__ import annotations

import torch

from gdm_tpu_torch.data.pipeline import assemble_inputs
from gdm_tpu_torch.eval.pose_fit import fit_poses_from_outputs
from gdm_tpu_torch.models.geomatch import GeoMatch, MeshArrays
from gdm_tpu_torch.parallel.mesh import Grid
from gdm_tpu_torch.parallel.sp import sharded_cosine_argmax


@torch.no_grad()
def fit_outputs(out: dict, cld: torch.Tensor, det: torch.Tensor | None,
                mesh_xyz: torch.Tensor, refine: str | None = None,
                icp_reject=0.01, grid: Grid | None = None):
    """Model outputs -> (poses [B, 3, 4], fit).

    ``fit`` holds what the pose fit used: 'rgbd' [B,N,C] and 'mesh' [M,C]
    features, 'w' [B,N] correspondence weights and 'idx' [B,N] matched
    mesh vertices.  ``refine`` and ``icp_reject`` (the ICP gate in
    metres) go to eval/pose_fit.apply_refine.  With model shards in
    ``grid`` the correspondences come from the argmax split over the
    model row (parallel/sp.sharded_cosine_argmax), as the JAX infer
    step's ``sp_mesh`` route."""
    pre_idx = None
    if grid is not None and grid.model_shards > 1:
        pre_idx, _ = sharded_cosine_argmax(out["rgbd"], out["mesh"], grid)
    poses, w, idx = fit_poses_from_outputs(
        cld, out, mesh_xyz, det=det, refine=refine,
        icp_reject_dist=icp_reject, pre_idx=pre_idx)
    return poses, {"rgbd": out["rgbd"], "mesh": out["mesh"], "w": w,
                   "idx": idx}


@torch.no_grad()
def forward_fit(model: GeoMatch, inputs: dict, cld: torch.Tensor,
                det: torch.Tensor | None, mesh: MeshArrays,
                mesh_feats: torch.Tensor, refine: str | None = None,
                icp_reject=0.01):
    """GeoMatch inputs (pyramid included) -> :func:`fit_outputs` of its
    forward."""
    out = model(inputs, mesh, mesh_features=mesh_feats)
    return fit_outputs(out, cld, det, mesh.xyz, refine, icp_reject)


@torch.no_grad()
def run_inference(model, fin: dict, mesh, mesh_xyz: torch.Tensor,
                  mesh_feats: torch.Tensor, needs_pyramid: bool = True,
                  knn_chunk: int = 1024, refine: str | None = None,
                  icp_reject=0.01, grid: Grid | None = None):
    """Finalized batch -> (poses [B, 3, 4], fit) of GeoMatch (the
    batch's pyramid built here) or, without ``needs_pyramid``,
    GeoMatchDGCNN.  ``knn_chunk`` queries per distance block of the KNN
    pyramid or the DGCNN graphs bound peak memory and change no
    result.  ``grid``: see :func:`fit_outputs`."""
    cld = fin["cld_rgb_nrm"][..., :3]
    if needs_pyramid:
        inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"],
                                 fin["choose"], fin["xyz_img"], knn_chunk)
        out = model(inputs, mesh, mesh_features=mesh_feats)
    else:
        out = model({"cld_rgb_nrm": fin["cld_rgb_nrm"]}, mesh,
                    mesh_features=mesh_feats, knn_chunk=knn_chunk)
    return fit_outputs(out, cld, fin.get("det"), mesh_xyz, refine,
                       icp_reject, grid)
