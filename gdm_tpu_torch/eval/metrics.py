"""6D pose error metrics (host-side numpy).

Reference: lib/pysixd/pose_error.py (add :297, adi :315, re :400, te :425,
arp_2d :440, mssd :131, mspd :156), utils/pose_utils.py get_closest_rot
(:430-454), and the VOC-style AUC of utils/basic_utils.py:813-820
(cal_auc + VOCap).  The VSD error, which renders on the device, lives in
eval/vsd.py.

A copy of gdm_tpu/eval/metrics.py (numpy + scipy; its package imports
jax); the tests hold every function bit-equal in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def transform_pts(pts: np.ndarray, R: np.ndarray, t: np.ndarray):
    return pts @ R.T + t.reshape(1, 3)


def add_err(R_est, t_est, R_gt, t_gt, pts) -> float:
    """ADD: mean distance between correspondingly transformed points."""
    pe = transform_pts(pts, R_est, t_est)
    pg = transform_pts(pts, R_gt, t_gt)
    return float(np.linalg.norm(pe - pg, axis=1).mean())


def adi_err(R_est, t_est, R_gt, t_gt, pts) -> float:
    """ADD-S: mean nearest-neighbour distance (symmetric objects)."""
    pe = transform_pts(pts, R_est, t_est)
    pg = transform_pts(pts, R_gt, t_gt)
    nn_dists, _ = cKDTree(pe).query(pg, k=1)
    return float(nn_dists.mean())


def re_err(R_est, R_gt) -> float:
    """Rotation error in degrees."""
    trace = float(np.trace(R_est @ R_gt.T))
    trace = min(trace, 3.0)
    cos = min(1.0, max(-1.0, 0.5 * (trace - 1.0)))
    return float(np.rad2deg(np.arccos(cos)))


def te_err(t_est, t_gt) -> float:
    """Translation error (same unit as inputs)."""
    return float(np.linalg.norm(np.ravel(t_gt) - np.ravel(t_est)))


def _project(pts, R, t, K):
    pc = transform_pts(pts, R, t) @ K.T
    return pc[:, :2] / pc[:, 2:3]


def proj_err(R_est, t_est, R_gt, t_gt, pts, K) -> float:
    """arp_2d: mean 2-D reprojection distance in pixels."""
    return float(np.linalg.norm(
        _project(pts, R_est, t_est, K) - _project(pts, R_gt, t_gt, K),
        axis=1).mean())


def _sym_pose_stack(R_gt, t_gt, syms):
    """Stacked ([S,3,3], [S,3]) symmetric equivalents of a GT pose.

    syms: None, or a sequence of (S_R [3,3], S_t [3]) pairs / dicts with
    'R'/'t' (BOP models_info convention, pose_error.py:146-152).  The
    reference's per-sym Python loop is replaced by one stacked einsum per
    metric call — with ~315 discretised continuous symmetries the loop
    would dominate host eval time.
    """
    if not syms:
        return np.asarray(R_gt)[None], np.ravel(t_gt)[None]
    Rs, ts = [], []
    for sym in syms:
        if isinstance(sym, dict):
            S_R, S_t = sym["R"], np.ravel(sym.get("t", np.zeros(3)))
        else:
            S_R, S_t = sym[0], np.ravel(sym[1])
        Rs.append(R_gt @ S_R)
        ts.append(R_gt @ S_t + np.ravel(t_gt))
    return np.stack(Rs), np.stack(ts)


def mssd_err(R_est, t_est, R_gt, t_gt, pts, syms=None) -> float:
    """Maximum Symmetry-aware Surface Distance (pose_error.py:131-154).

    syms should include the identity transform (BOP convention)."""
    pe = transform_pts(pts, R_est, np.ravel(t_est))
    Rs, ts = _sym_pose_stack(R_gt, t_gt, syms)
    pg = np.einsum("sij,nj->sni", Rs, pts) + ts[:, None, :]
    d = np.linalg.norm(pe[None] - pg, axis=2)          # [S, n]
    return float(d.max(axis=1).min())


def mspd_err(R_est, t_est, R_gt, t_gt, pts, K, syms=None) -> float:
    """Maximum Symmetry-aware Projection Distance (pose_error.py:156-180)."""
    pr = _project(pts, R_est, np.ravel(t_est), K)
    Rs, ts = _sym_pose_stack(R_gt, t_gt, syms)
    pc = np.einsum("sij,nj->sni", Rs, pts) + ts[:, None, :]
    pc = pc @ np.asarray(K).T
    pg = pc[..., :2] / pc[..., 2:3]                    # [S, n, 2]
    d = np.linalg.norm(pr[None] - pg, axis=2)
    return float(d.max(axis=1).min())


def re_sym_err(R_est, R_gt, syms=None) -> float:
    """Symmetry-aware rotation error in degrees (pose_error.py:184-204,
    the offline scorer's 'reS' type): min over the GT pose's symmetric
    equivalents.  One stacked trace instead of the reference's loop."""
    Rs, _ = _sym_pose_stack(R_gt, np.zeros(3), syms)
    tr = np.einsum("ij,sij->s", np.asarray(R_est), Rs)
    cos = np.clip(0.5 * (np.minimum(tr, 3.0) - 1.0), -1.0, 1.0)
    return float(np.rad2deg(np.arccos(cos)).min())


def te_sym_err(t_est, t_gt, R_gt, syms=None) -> float:
    """Symmetry-aware translation error (pose_error.py:206-221, 'teS'):
    min distance to the symmetric equivalents' translations."""
    _, ts = _sym_pose_stack(R_gt, t_gt, syms)
    return float(np.linalg.norm(ts - np.ravel(t_est)[None], axis=1).min())


def proj_sym_err(R_est, t_est, R_gt, t_gt, pts, K, syms=None) -> float:
    """Symmetry-aware mean reprojection error in px (pose_error.py:224-259,
    'projS'/arp_2d_sym): min over symmetric equivalents of the mean 2-D
    distance."""
    pr = _project(pts, R_est, np.ravel(t_est), K)
    Rs, ts = _sym_pose_stack(R_gt, t_gt, syms)
    pc = np.einsum("sij,nj->sni", Rs, pts) + ts[:, None, :]
    pc = pc @ np.asarray(K).T
    pg = pc[..., :2] / pc[..., 2:3]
    return float(np.linalg.norm(pr[None] - pg, axis=2).mean(axis=1).min())


def get_closest_rot(R_est, R_gt, sym_rots):
    """Closest symmetric equivalent of R_gt under model-frame symmetries.

    sym_rots: None or [K, 3, 3] (pose_utils.py:430-454).
    """
    if sym_rots is None:
        return R_gt
    sym_rots = np.asarray(sym_rots)
    if sym_rots.ndim == 2:
        sym_rots = sym_rots[None]
    best, best_err = R_gt, re_err(R_est, R_gt)
    for S in sym_rots:
        cand = R_gt @ S
        e = re_err(R_est, cand)
        if e < best_err:
            best, best_err = cand, e
    return best


def voc_auc(distances, max_dis: float = 0.1) -> float:
    """ADD(-S) AUC, percent (basic_utils.py:813-820 cal_auc/VOCap).

    Distances above max_dis count as failures; the area under the
    accuracy-vs-threshold curve is normalised by max_dis.
    """
    D = np.array(distances, dtype=np.float64)
    if len(D) == 0:
        return 0.0
    D[D > max_dis] = np.inf
    D = np.sort(D)
    acc = np.arange(1, len(D) + 1, dtype=np.float64) / len(D)
    finite = np.isfinite(D)
    rec, prec = D[finite], acc[finite]
    if len(rec) == 0:
        return 0.0
    # VOCap step integral (basic_utils.py:62-74), generalised from the
    # hardcoded 0.1 / x10 pair to max_dis
    mrec = np.concatenate([[0.0], rec, [max_dis]])
    mpre = np.concatenate([[0.0], prec, [prec[-1]]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    ap = np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]) / max_dis
    return float(ap * 100.0)
