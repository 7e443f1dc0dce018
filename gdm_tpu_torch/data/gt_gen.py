"""Ground-truth correspondence generation (host side).

Counterpart of gdm_tpu/data/gt_gen.py (reference
datasets/lm/linemod_pbr.py:602-655, get_pose_gt_info): hidden-point
removal gives the mesh vertices visible under the GT pose, each
foreground scene point is matched to its nearest visible transformed
vertex within ``nn_dist_th``, and unmatched foreground points lose their
label.  The radius search is the C++ voxel grid of
``csrc/radius_nn.cpp`` (a copy of the JAX package's native one).
"""

from __future__ import annotations

import ctypes

import numpy as np

from gdm_tpu_torch.ops.visibility import visible_points


def _radius_lib():
    from gdm_tpu_torch import _build

    lib = _build.load("radius_nn")
    p = ctypes.c_void_p
    lib.gdm_radius_nn1.argtypes = [p, ctypes.c_int32, p, ctypes.c_int32,
                                   ctypes.c_float, p, p]
    lib.gdm_radius_nn1.restype = None
    return lib


def radius_nn(support: np.ndarray, query: np.ndarray,
              radius: float) -> np.ndarray:
    """Radius-bounded exact 1-NN: [n, 3] support, [m, 3] query -> idx [m]
    int32, -1 where no support point lies within ``radius`` (inclusive);
    gdm_tpu.native.radius_nn's contract."""
    support = np.ascontiguousarray(support, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    if len(support) == 0:
        raise ValueError(f"radius_nn: empty support (radius {radius})")
    if support.ndim != 2 or support.shape[1] != 3 or query.ndim != 2 \
            or query.shape[1] != 3:
        raise ValueError(f"radius_nn: want [n, 3] and [m, 3], got "
                         f"{support.shape} and {query.shape}")
    idx = np.empty(len(query), np.int32)
    _radius_lib().gdm_radius_nn1(
        support.ctypes.data, len(support), query.ctypes.data, len(query),
        ctypes.c_float(radius), idx.ctypes.data, None)
    return idx


def pose_visibility(pose: np.ndarray, mesh_pts: np.ndarray,
                    radius_param: float = 2.0) -> np.ndarray:
    """Visible-vertex flag [m] uint8 under a GT pose (HPR hull).  It
    depends on (pose, mesh_pts, radius_param) alone, so a dataset caches
    it per annotation."""
    R, t = pose[:, :3], pose[:, 3:4]
    cam_center_model = -R.T @ t                       # inverse-pose origin
    vis_idx = visible_points(mesh_pts, cam_center_model.ravel(),
                             radius_param=radius_param)
    visible_flag = np.zeros(len(mesh_pts), np.uint8)
    visible_flag[vis_idx] = 1
    return visible_flag


def pose_gt_info(cld: np.ndarray, pt_labels: np.ndarray, pose: np.ndarray,
                 mesh_pts: np.ndarray, nn_dist_th: float = 0.01,
                 visible_flag=None):
    """Correspondence GT of one sample.

    Args:
      cld: [n, 3] sampled scene points (camera frame, metres).
      pt_labels: [n] raw foreground labels.
      pose: [3, 4] GT object pose.
      mesh_pts: [m, 3] object vertices (metres).
      nn_dist_th: match rejection distance (0.01 for LM, hardcoded at
        linemod_pbr.py:641).
      visible_flag: optional precomputed pose_visibility array, or a
        zero-argument callable giving one (a cache lookup); resolved only
        after the empty-foreground check, so invalid samples never pay
        for the hull.

    Returns:
      (labels [n], match_idx [n] int32 with m = no match, visible_flag
      [m] uint8 (zeros on the empty-foreground path), valid bool).
    """
    n, m = len(cld), len(mesh_pts)
    match_idx = np.full(n, m, np.int32)
    labels = pt_labels.copy()

    fg = pt_labels > 0
    obj_cld = cld[fg]
    if obj_cld.shape[0] == 0:
        return labels, match_idx, np.zeros(m, np.uint8), False

    if visible_flag is None:
        visible_flag = pose_visibility(pose, mesh_pts)
    elif callable(visible_flag):
        visible_flag = visible_flag()

    R, t = pose[:, :3], pose[:, 3:4]
    vis_idx = np.nonzero(visible_flag)[0]
    vis_proj = mesh_pts[vis_idx] @ R.T + t.T

    nn = radius_nn(vis_proj, obj_cld, nn_dist_th)
    bad = nn < 0
    if bad.all():
        return labels, match_idx, visible_flag, False
    matched = vis_idx[np.where(bad, 0, nn)].astype(np.int32)
    matched[bad] = m
    fg_idx = np.where(fg)[0]
    labels[fg_idx[bad]] = 0
    match_idx[fg] = matched
    return labels, match_idx, visible_flag, True
