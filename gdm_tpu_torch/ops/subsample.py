"""Voxel-grid (barycentre) point-cloud subsampling on the host.

A copy of gdm_tpu/ops/subsample.py ``voxel_grid_subsample_np`` (numpy,
host-side data preparation, the counterpart of the reference's
``DP.grid_sub_sampling``); ``gdm_tpu_torch.native.grid_subsample`` is the
C++ form with a collision-free key and first-occurrence order.
"""

from __future__ import annotations

import numpy as np


def voxel_grid_subsample_np(
    points: np.ndarray,
    sample_dl: float,
    features: np.ndarray | None = None,
):
    """Barycentre subsampling on a regular voxel grid.

    Args:
      points: [n, 3] float array.
      sample_dl: voxel edge length.
      features: optional [n, c] to average per voxel.

    Returns:
      sub_points [m, 3] (and sub_features [m, c] if features given), one
      barycentre per occupied voxel, in the order of ``np.unique`` over
      the voxel keys (an XOR-packed key, as the JAX package's); callers
      must not rely on the order.
    """
    mins = points.min(axis=0)
    cells = np.floor((points - mins) / sample_dl).astype(np.int64)
    key = (cells[:, 0] << 42) ^ (cells[:, 1] << 21) ^ cells[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    m = uniq.shape[0]
    sums = np.zeros((m, 3), np.float64)
    np.add.at(sums, inv, points)
    sub_points = (sums / counts[:, None]).astype(points.dtype)
    if features is None:
        return sub_points
    fsum = np.zeros((m, features.shape[1]), np.float64)
    np.add.at(fsum, inv, features)
    return sub_points, (fsum / counts[:, None]).astype(features.dtype)
