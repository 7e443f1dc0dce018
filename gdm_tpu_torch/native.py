"""Host-side k-NN and voxel subsampling in C++ (``gdm_tpu.native``'s API).

Counterpart of gdm_tpu/native/__init__.py: ``available``, ``knn``,
``knn_batch``, ``radius_nn`` and ``grid_subsample`` with the same
contracts, over ``csrc/native.cpp`` (the port's copy of the JAX
package's KD-tree k-NN and voxel grid) and ``csrc/radius_nn.cpp``
(``radius_nn``, the one GT generation uses).  The libraries are built at
first use by ``_build``; a build failure raises (the JAX package falls
back to scipy and numpy).
The ``*_plain`` functions are numpy versions of the same contracts that
the tests hold the C++ against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gdm_tpu_torch.data.gt_gen import radius_nn

__all__ = ["available", "knn", "knn_batch", "radius_nn", "grid_subsample",
           "knn_plain", "grid_subsample_plain"]


def _lib():
    from gdm_tpu_torch import _build

    lib = _build.load("native")
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.gdm_knn.argtypes = [p, i32, p, i32, i32, p, p]
    lib.gdm_knn.restype = None
    lib.gdm_knn_batch.argtypes = [p, i32, i32, p, i32, i32, p]
    lib.gdm_knn_batch.restype = None
    lib.gdm_grid_subsample.argtypes = [p, i32, p, i32, ctypes.c_float, p, p]
    lib.gdm_grid_subsample.restype = i32
    return lib


def available() -> bool:
    """Whether the C++ library builds and loads here (gdm_tpu.native's
    ``available``); the functions below raise where it does not."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _points(name: str, *arrays, ndim: int = 2):
    """The arrays as contiguous float32 [..., 3] of ``ndim`` dimensions;
    ValueError otherwise (the C++ reads them as flat xyz triples)."""
    out = [_f32(a) for a in arrays]
    if any(a.ndim != ndim or a.shape[-1] != 3 for a in out):
        raise ValueError(f"{name}: want {ndim}-d [..., 3] points, got "
                         f"{[a.shape for a in out]}")
    return out


def knn(support: np.ndarray, query: np.ndarray, k: int,
        return_dist: bool = False):
    """Exact k-NN: [n, 3] support, [m, 3] query -> idx [m, k] int32 in
    ascending distance (and the distances [m, k] f32 with
    ``return_dist``); with k > n the last neighbour repeats."""
    support, query = _points("knn", support, query)
    k, m = int(k), query.shape[0]
    if len(support) == 0 or k <= 0:
        raise ValueError(
            f"knn: empty support or k={k} (support {support.shape})")
    idx = np.empty((m, k), np.int32)
    dist = np.empty((m, k), np.float32) if return_dist else None
    _lib().gdm_knn(support.ctypes.data, len(support), query.ctypes.data, m,
                   k, idx.ctypes.data,
                   dist.ctypes.data if return_dist else None)
    return (idx, dist) if return_dist else idx


def knn_batch(support: np.ndarray, query: np.ndarray, k: int) -> np.ndarray:
    """[b, n, 3], [b, m, 3] -> [b, m, k] int32 (the reference's knn_batch
    contract)."""
    support, query = _points("knn_batch", support, query, ndim=3)
    b, n, _ = support.shape
    m = query.shape[1]
    if len(query) != b:
        raise ValueError(f"knn_batch: {b} supports, {len(query)} queries")
    if n == 0 or k <= 0:
        raise ValueError(f"knn_batch: empty support or k={k}")
    idx = np.empty((b, m, int(k)), np.int32)
    _lib().gdm_knn_batch(support.ctypes.data, b, n, query.ctypes.data, m,
                         int(k), idx.ctypes.data)
    return idx


def grid_subsample(pts: np.ndarray, dl: float,
                   features: np.ndarray | None = None):
    """Voxel-grid barycentre subsampling (DP.grid_sub_sampling parity):
    sub_pts [v, 3] f32 (and sub_feat [v, c] f32), one per occupied voxel
    of edge ``dl`` in first-occurrence order."""
    pts, = _points("grid_subsample", pts)
    feats = None if features is None else _f32(features)
    if feats is not None and (feats.ndim != 2 or len(feats) != len(pts)):
        raise ValueError(f"grid_subsample: features {feats.shape} for "
                         f"{len(pts)} points")
    fdim = 0 if feats is None else feats.shape[1]
    fptr = None if feats is None else feats.ctypes.data
    lib = _lib()
    n_out = lib.gdm_grid_subsample(pts.ctypes.data, len(pts), fptr, fdim,
                                   ctypes.c_float(dl), None, None)
    out_pts = np.empty((n_out, 3), np.float32)
    out_f = None if feats is None else np.empty((n_out, fdim), np.float32)
    lib.gdm_grid_subsample(pts.ctypes.data, len(pts), fptr, fdim,
                           ctypes.c_float(dl), out_pts.ctypes.data,
                           None if out_f is None else out_f.ctypes.data)
    return out_pts if features is None else (out_pts, out_f)


def knn_plain(support: np.ndarray, query: np.ndarray, k: int,
              return_dist: bool = False):
    """:func:`knn` in numpy and torch: the f32 distances the C++ forms
    (fma(dz, dz, fma(dx, dx, dy * dy)), exactly rounded), a stable sort
    (ties to the lowest index, where the KD-tree breaks them by traversal
    order)."""
    import torch

    from gdm_tpu_torch.ops.render_depth import fma32

    support, query, k = _f32(support), _f32(query), int(k)
    diff = torch.from_numpy(query[:, None, :] - support[None, :, :])
    dx, dy, dz = diff.unbind(-1)
    d2 = fma32(dz, dz, fma32(dx, dx, dy * dy)).numpy()
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    if order.shape[1] < k:
        order = np.concatenate([order, np.repeat(
            order[:, -1:], k - order.shape[1], axis=1)], axis=1)
    idx = order.astype(np.int32)
    if not return_dist:
        return idx
    return idx, np.sqrt(np.take_along_axis(d2, order, axis=1))


def grid_subsample_plain(pts: np.ndarray, dl: float,
                         features: np.ndarray | None = None):
    """:func:`grid_subsample` in numpy: the same f32 voxel indices and
    packed key, the voxels in first-occurrence order, float64 sums in
    point order."""
    pts = _f32(pts)
    g = np.floor((pts - pts.min(0)) / np.float32(dl)).astype(np.int64)
    key = (g[:, 0] << 42) | (g[:, 1] << 21) | g[:, 2]
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    inv = rank[inv.ravel()]
    counts = np.bincount(inv, minlength=len(first))[:, None]
    sub = np.zeros((len(first), 3), np.float64)
    np.add.at(sub, inv, pts.astype(np.float64))
    sub = (sub / counts).astype(np.float32)
    if features is None:
        return sub
    f = np.zeros((len(first), features.shape[1]), np.float64)
    np.add.at(f, inv, _f32(features).astype(np.float64))
    return sub, (f / counts).astype(np.float32)
