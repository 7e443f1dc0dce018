"""Device preprocessing: finalize a loader batch, build the index pyramid.

Counterpart of gdm_tpu/data/pipeline.py (exact KNN only), batched over
the leading axis instead of vmapped.  Subsampling keeps the first N/4
points of the pre-shuffled cloud at every level, so deeper point sets are
index prefixes of the ones above and the CNN grids repeat across stages
(strides 4, 8, 8, 8 down and 4, 2, 2 up); the 22 searches of the naive
formulation share 8 distance computations, as in the JAX package.

Indices are int64 from here on; :func:`to_device` is the host boundary
where the loader's narrow types (uint16 depth, int32 indices) widen.
"""

from __future__ import annotations

import numpy as np
import torch

from gdm_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from gdm_tpu_torch.models.layers import gather_rows
from gdm_tpu_torch.ops.backproject import depth_to_xyz
from gdm_tpu_torch.ops.knn import (
    argmin_prefixes,
    knn,
    pairwise_sqdist,
    topk_block,
)
from gdm_tpu_torch.ops.normals import depth_normals

RGB_DS_SR = (4, 8, 8, 8)       # CNN stride per DS stage (ffb6d.py:38)
RGB_UP_SR = (4, 2, 2)          # CNN stride per UP stage
K_NEI = 16


def to_device(raw: dict, device) -> dict:
    """Host loader arrays (numpy) -> tensors on ``device``.

    uint16 depth widens to int32 on the host (torch's uint16 support is
    partial); ``choose`` becomes int64; everything else keeps its type."""
    out = {}
    for k, v in raw.items():
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = a.astype(np.int32)
        elif k == "choose":
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def finalize_batch(batch: dict, fill_depth: bool = False) -> dict:
    """Colour normalisation, backprojection, normals and point gather.

    Args:
      batch: tensors from :func:`to_device`: rgb_u8 [B,S,S,3] uint8,
        dpt_u16 [B,S,S] integer depth counts + dpt_scale [B] counts per
        metre, K_crop [B,3,3], choose [B,N] int64, optionally det [B],
        and with ``fill_depth`` dpt_filled [B,S,S] f32 metres.
      fill_depth: take the normals from dpt_filled (YCB-V,
        ycbv_pbr.py:477-486); the points' xyz still come from the raw
        counts.
    Returns:
      rgb [B,S,S,3] f32, cld_rgb_nrm [B,N,9], xyz_img [B,S,S,3], choose,
      and det when present.
    """
    dev = batch["rgb_u8"].device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    rgb = (batch["rgb_u8"].to(torch.float32) / 255.0 - mean) / std
    dpt = batch["dpt_u16"].to(torch.float32) \
        / batch["dpt_scale"][:, None, None]
    xyz_img = torch.nan_to_num(depth_to_xyz(dpt, batch["K_crop"]),
                               nan=0.0, posinf=0.0, neginf=0.0)
    dpt_n = batch["dpt_filled"] if fill_depth else dpt
    nrm_img = depth_normals(dpt_n * 1000.0, batch["K_crop"])

    b, s = rgb.shape[:2]
    choose = batch["choose"]

    def gather(img):
        return gather_rows(img.reshape(b, s * s, img.shape[-1]), choose)

    out = {
        "rgb": rgb,
        "cld_rgb_nrm": torch.cat(
            [gather(xyz_img), gather(rgb), gather(nrm_img)], dim=-1),
        "xyz_img": xyz_img,
        "choose": choose,
    }
    for k in ("labels", "origin_labels", "match_idx", "visible_flag",
              "RT", "det"):
        if k in batch:
            out[k] = batch[k].to(torch.int64) \
                if k in ("labels", "origin_labels", "match_idx") \
                else batch[k]
    return out


def _grid_xyz(xyz_img: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided CNN-grid xyz [B, (S/stride)^2, 3]."""
    g = xyz_img[:, ::stride, ::stride, :]
    return g.reshape(g.shape[0], -1, 3)


def build_pyramid(cld: torch.Tensor, xyz_img: torch.Tensor,
                  knn_chunk: int = 1024) -> dict:
    """The FFB6D KNN / fusion index pyramid, exact.

    Args:
      cld: [B, N, 3] sampled (pre-shuffled) scene points.
      xyz_img: [B, S, S, 3] backprojected crop.
    Returns:
      dict of int64 index tensors under the reference's key names, plus
      the cld_xyz{0..3} point levels.
    """
    n = cld.shape[1]
    n1, n2, n3, n4 = n // 4, n // 16, n // 64, n // 256
    sub1, sub2, sub3 = cld[:, :n1], cld[:, :n2], cld[:, :n3]
    grid0 = _grid_xyz(xyz_img, RGB_DS_SR[0])   # stride 4: DS0 + UP0
    grid1 = _grid_xyz(xyz_img, RGB_DS_SR[1])   # stride 8: DS1-3
    grid2 = _grid_xyz(xyz_img, RGB_UP_SR[1])   # stride 2: UP1-2

    out = {"cld_xyz0": cld, "cld_xyz1": sub1, "cld_xyz2": sub2,
           "cld_xyz3": sub3}

    # self-KNN + interpolation cascade
    nei0 = knn(cld, cld, K_NEI, chunk=knn_chunk)
    out["cld_nei_idx0"], out["cld_sub_idx0"] = nei0, nei0[:, :n1]
    out["cld_interp_idx0"] = knn(sub1, cld, 1, chunk=knn_chunk)
    # one [n/4, n/4] block serves every deeper self-KNN and interp argmin
    head = pairwise_sqdist(sub1, sub1)
    nei1 = topk_block(head, K_NEI)
    nei2 = topk_block(head[:, :n2, :n2], K_NEI)
    nei3 = topk_block(head[:, :n3, :n3], K_NEI)
    out["cld_nei_idx1"], out["cld_sub_idx1"] = nei1, nei1[:, :n2]
    out["cld_nei_idx2"], out["cld_sub_idx2"] = nei2, nei2[:, :n3]
    out["cld_nei_idx3"], out["cld_sub_idx3"] = nei3, nei3[:, :n4]
    for i, rows, p in ((1, n1, n2), (2, n2, n3), (3, n3, n4)):
        out[f"cld_interp_idx{i}"] = torch.argmin(
            head[:, :rows, :p], dim=-1, keepdim=True)

    # r2p: CNN grid -> point neighbours
    r2p0 = knn(grid0, sub1, K_NEI, chunk=knn_chunk)
    r2p1 = knn(grid1, sub2, K_NEI, chunk=knn_chunk)
    r2pu = knn(grid2, sub1, K_NEI, chunk=knn_chunk)
    out["r2p_ds_nei_idx0"] = r2p0
    out["r2p_ds_nei_idx1"] = r2p1
    out["r2p_ds_nei_idx2"] = r2p1[:, :n3]
    out["r2p_ds_nei_idx3"] = r2p1[:, :n4]
    out["r2p_up_nei_idx0"] = r2p0[:, :n3]      # UP0 target = cld_xyz3
    out["r2p_up_nei_idx1"] = r2pu[:, :n2]      # UP1 target = cld_xyz2
    out["r2p_up_nei_idx2"] = r2pu              # UP2 target = cld_xyz1

    # p2r: point -> CNN grid argmins
    p2r0, p2r_u0 = argmin_prefixes(sub1, grid0, (n1, n3), chunk=knn_chunk)
    p2r1, p2r2, p2r3 = argmin_prefixes(sub2, grid1, (n2, n3, n4),
                                       chunk=knn_chunk)
    p2r_u2, p2r_u1 = argmin_prefixes(sub1, grid2, (n1, n2), chunk=knn_chunk)
    out["p2r_ds_nei_idx0"] = p2r0
    out["p2r_ds_nei_idx1"] = p2r1
    out["p2r_ds_nei_idx2"] = p2r2
    out["p2r_ds_nei_idx3"] = p2r3
    out["p2r_up_nei_idx0"] = p2r_u0
    out["p2r_up_nei_idx1"] = p2r_u1
    out["p2r_up_nei_idx2"] = p2r_u2
    return out


def assemble_inputs(rgb: torch.Tensor, cld_rgb_nrm: torch.Tensor,
                    choose: torch.Tensor, xyz_img: torch.Tensor,
                    knn_chunk: int = 1024) -> dict:
    """Model-input dict: finalized tensors + the exact index pyramid."""
    return {"rgb": rgb, "cld_rgb_nrm": cld_rgb_nrm, "choose": choose,
            **build_pyramid(cld_rgb_nrm[..., :3], xyz_img, knn_chunk)}
